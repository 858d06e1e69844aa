"""Model zoo of the port (GPT, BERT and ERNIE so far)."""

from .bert import (Bert, BertConfig, BertForPretraining,  # noqa: F401
                   bert_base, bert_tiny)
from .ernie import (Ernie, ErnieConfig,  # noqa: F401
                    ErnieForPretraining, ernie_base, ernie_pipeline_descs,
                    ernie_tiny)
from .gpt import (GPT, GPTConfig, GPTForCausalLM, gpt3_1p3b,  # noqa: F401
                  gpt_tiny)

__all__ = ["Bert", "BertConfig", "BertForPretraining", "bert_base",
           "bert_tiny", "Ernie", "ErnieConfig", "ErnieForPretraining",
           "ernie_base", "ernie_pipeline_descs", "ernie_tiny", "GPT",
           "GPTConfig", "GPTForCausalLM", "gpt3_1p3b", "gpt_tiny"]
