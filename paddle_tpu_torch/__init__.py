"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

The JAX package ``paddle_tpu`` is the reference; this package grows beside
it, one slice at a time, with the same module paths (``paddle_tpu/<path>``
maps to ``paddle_tpu_torch/<path>``). It imports ``torch`` and numpy and
never ``jax`` or anything of ``paddle_tpu``.

Every TPU kernel of a ported path is a hand-written Hopper kernel under
``ops/_hopper/`` (CUDA C++ built by ``nvcc`` at first use), with its plain
PyTorch version beside it. Entry points run on the GPU unless the caller
asks for the CPU (``device="cpu"``), where the plain versions run.

Ported so far: the serving path — ``serving.ServingEngine`` over
``text.models.gpt.GPTForCausalLM``, whose prefill runs the flash-attention
forward kernel (``ops/_hopper/csrc/flash_fwd.cu``) — and the training
path — ``framework.TrainStep`` with ``optimizer`` (AdamW and others),
``amp.decorate`` O2 and the GPT loss, whose attention backward runs the
dq and dk/dv kernels (``ops/_hopper/csrc/flash_bwd.cu``); BERT pretraining
(``text.models.bert``, attention at head dim 64 on
``ops/_hopper/csrc/flash_packed.cu``); and ResNet training
(``vision.models.resnet``), whose convs, with the flags
``fused_conv_bn`` and ``pallas_conv`` of :mod:`.core.flags` on, run the
conv kernels with the BN prologue and stat epilogue
(``ops/_hopper/csrc/conv.cu``); ERNIE pretraining (``text.models.ernie``);
``ops/_hopper/fused_matmul_bn.py`` (the fused 1x1 matmul + BN + ReLU +
stats, on ``conv.cu``); and dropout: the attention kernels' in-kernel mask
and hidden dropout, keyed by :mod:`.core.random` as the JAX package keys
its randomness by ``(seed, step)``; activation recompute
(``distributed.fleet.utils.recompute``, GPT's ``recompute=True``), AMP O1
(``amp.auto_cast``, ``amp.GradScaler``) and the imperative optimizers
(``optimizer.AdamW(parameters=...)``, ``step()``, ``clear_grad()``, the
regularizers of :mod:`.regularizer`); the high-level API (``Model`` with
``fit``, ``evaluate``, ``predict``, ``save`` and ``load``; ``summary``;
``metric``), the data pipeline (``io``: datasets, samplers, the
DataLoader with thread and shared-memory process workers, device
prefetch), ``save``/``load``, LeNet on MNIST (BASELINE config 1, library
convolutions), LBFGS, and the two attention entry points
``ops.flash_attn_unpadded`` and
``ops._hopper.flash_attention.flash_attention_with_lse``, which run the
flash-attention kernels on packed varlen batches and with a
differentiable lse.
"""

from . import amp, io, metric, nn, optimizer, regularizer, vision  # noqa: F401
from .core.device import resolve_device  # noqa: F401
from .core.random import seed  # noqa: F401
from .framework.io import load, save  # noqa: F401
from .hapi.model import Model  # noqa: F401
from .hapi.summary import summary  # noqa: F401

__all__ = ["amp", "io", "metric", "nn", "optimizer", "regularizer",
           "vision", "resolve_device", "seed", "save", "load", "Model",
           "summary"]
