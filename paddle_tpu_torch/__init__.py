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
differentiable lse; ``nn.Transformer`` (the encoder-decoder, its attention
on K4 at head dim 64), decoding with ``MultiHeadAttention``'s caches and
by beam search (``nn.BeamSearchDecoder``, ``nn.dynamic_decode``),
``ParamAttr`` and ``nn.initializer``; the flag registry with JAX's
environment reading and coercion (``core.flags``), and the runtime
telemetry (``observability``: metrics, spans, request and step timelines,
the recompile sentinel, HBM watermarks, the flight recorder;
``profiler.monitor``; ``analysis.diagnostics``) wired through serving and
training; the single-device surface a Paddle script calls first: the
root's ``core``, device, flag and dtype names (every flag of the JAX
package; ``use_pallas_kernels`` routes attention), ``tensor`` (302 names
over torch tensors) and ``autograd`` (``grad``, ``no_grad``, ``PyLayer``,
...), and ``ops._hopper.conv.tune_conv_shapes``, whose winners K5's and
K7's plans read; the ``Layer`` API, all of ``nn/`` and the vision zoo;
the input pipeline of ``vision`` (``transforms``, ``datasets``, the image
backend) and its detection ``ops``, ``text``'s sequence ops and datasets,
``fft``, ``signal`` and ``audio``. Layers build on ``cuda:0`` unless given
``device="cpu"`` (or ``set_device("cpu")``), as the models do.
"""

from . import core  # noqa: F401
from .core import (seed, set_device, get_device, device_count,  # noqa: F401
                   get_flags, set_flags, is_compiled_with_tpu, synchronize,
                   get_rng_state, set_rng_state)
from .core.device import resolve_device  # noqa: F401
from .core.dtype import (bool_, uint8, int8, int16, int32, int64,  # noqa: F401
                         float16, bfloat16, float32, float64, complex64,
                         complex128, get_default_dtype, set_default_dtype)
from .tensor import *  # noqa: F401,F403
from .tensor.logic import is_tensor  # noqa: F401

from . import amp, autograd, io, metric, nn, optimizer, regularizer  # noqa: F401
from . import vision  # noqa: F401
from . import audio, fft, signal, text  # noqa: F401
from .text.ops import shard_index  # noqa: F401
from .autograd import (no_grad, grad, enable_grad,  # noqa: F401
                       set_grad_enabled, is_grad_enabled)
from .framework.io import load, save  # noqa: F401
from .hapi.model import Model  # noqa: F401
from .hapi.summary import summary  # noqa: F401
from .nn.layer import ParamAttr  # noqa: F401

bool = bool_  # noqa: A001  (Paddle exports paddle.bool, as JAX's root does)
