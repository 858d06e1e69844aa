"""Model zoo of the port (GPT so far)."""

from .gpt import (GPT, GPTConfig, GPTForCausalLM, gpt3_1p3b,  # noqa: F401
                  gpt_tiny)

__all__ = ["GPT", "GPTConfig", "GPTForCausalLM", "gpt3_1p3b", "gpt_tiny"]
