"""Flags of the port (``paddle_tpu/core/flags.py`` counterpart, with every
flag the JAX package defines).

A typed registry seeded from ``FLAGS_<name>`` environment variables when a
flag is defined, and changed at run time by ``set_flags``, as in the JAX
package: ``set_flags({"FLAGS_pallas_conv": 1})`` and
``get_flags(["pallas_conv"])`` work under the same names, so a caller's
settings carry over. A value is coerced to its default's type (for a
boolean flag the strings ``1``/``true``/``yes``/``on``, in any case, are
true and every other string false), checked against the flag's ``choices``
and handed to its ``on_change``. These flags are defined, with JAX's
defaults:

- ``fused_conv_bn``: ResNet blocks in training take the deferred-BN units of
  :mod:`paddle_tpu_torch.nn.fused_conv_bn`;
- ``pallas_conv``: inside those units, a supported convolution runs on the
  hand-written conv kernels (``ops/_hopper/conv.py``, K5-K8). The name is
  the JAX package's; on the GPU it means the CUDA kernels;
- ``flash_head_pack`` (on): d=64 attention whose heads match takes K4, the
  head-dim-64 kernels (``ops/_hopper/flash_attention_packed.py``); at 0 it
  takes K1-K3, as in JAX;
- ``amp_dtype`` (``"bfloat16"``): the dtype :func:`paddle_tpu_torch.amp.
  decorate` casts to when it is given none;
- ``serve_prefix_cache``, ``serve_chunked_prefill``, ``serve_speculative``:
  the serving engine's three throughput tiers, read when the engine's own
  argument is ``None`` (all off);
- ``kernel_autotune`` (on) and ``kernel_autotune_cache_path`` (``""``: the
  default file): the autotune cache of :mod:`paddle_tpu_torch.ops._hopper.
  autotune`, which ``serve_speculative=-1`` reads;
- ``telemetry`` (``"metrics"``: off, metrics or trace), ``flight_recorder``
  (``"off"``: off or on) and ``flight_recorder_mb`` (4): the runtime
  telemetry of :mod:`paddle_tpu_torch.observability`;
- ``static_analysis`` (``"off"``: off, warn or error): how
  :func:`paddle_tpu_torch.analysis.diagnostics.emit` routes a finding;
- ``use_pallas_kernels`` (on): attention takes the hand-written kernels
  (K1-K4) where they take the input; off, ``ops.flash_attention``,
  ``ops.flash_attn_unpadded`` and ``nn.functional.
  scaled_dot_product_attention`` take the dense path, as JAX's do. The
  name is the JAX package's; on the GPU it means the CUDA kernels;
- ``default_dtype`` (``"float32"``): :func:`.dtype.get_default_dtype`;
- ``flash_block_q``/``flash_block_k`` (0): validated as JAX validates
  them when attention runs; a valid value changes no kernel body;
- ``jit_cache_size``, ``log_level``, ``allocator_strategy``,
  ``embedding_deterministic``, ``flash_attn_version`` and
  ``closed_form_norm_grad``: defined as in JAX, which reads none of the
  first five, and the port's norms take forward-mode AD either way.

The flags of modules the port has not reached yet (``check_nan_inf``,
``offload_optimizer``, ``comm_overlap`` and the rest, each with the ROADMAP
item that brings it) are defined with JAX's defaults, and any other value
raises ``NotImplementedError``: none is taken and ignored.
"""

from __future__ import annotations

import difflib
import os
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional, Union

__all__ = ["define_flag", "flag", "get_flags", "set_flags", "list_flags",
           "unknown_env_flags"]


@dataclass
class _FlagSpec:
    name: str
    default: Any
    type: type
    help: str
    on_change: Optional[Callable[[Any], None]] = None
    choices: Optional[tuple] = None
    later: Optional[str] = None


_registry: Dict[str, _FlagSpec] = {}
_values: Dict[str, Any] = {}
_lock = threading.RLock()


def _coerce(spec: _FlagSpec, value: Any) -> Any:
    if spec.type is bool and isinstance(value, str):
        value = value.lower() in ("1", "true", "yes", "on")
    value = spec.type(value)
    if spec.choices is not None and value not in spec.choices:
        raise ValueError(
            f"FLAGS_{spec.name}={value!r} is not a valid value; "
            f"choices: {list(spec.choices)}")
    if spec.later is not None and value != spec.default:
        raise NotImplementedError(
            f"FLAGS_{spec.name}={value!r}: what this flag switches is not "
            f"ported yet ({spec.later}); only its default "
            f"{spec.default!r} is accepted")
    return value


def _unknown(name: str) -> KeyError:
    close = difflib.get_close_matches(name, _registry, n=1)
    hint = f" (did you mean {close[0]!r}?)" if close else ""
    return KeyError(f"Unknown flag {name!r}{hint}; valid flags: "
                    f"{sorted(_registry)}")


def define_flag(name: str, default: Any, help: str = "",
                on_change: Optional[Callable[[Any], None]] = None,
                choices: Optional[Iterable[Any]] = None,
                later: Optional[str] = None) -> None:
    """Register ``name``. The environment variable ``FLAGS_<name>``, when
    set, overrides ``default`` (coerced to its type and checked against
    ``choices``). ``later`` names the ROADMAP item that ports what the
    flag switches: until then any value but the default raises
    ``NotImplementedError``, from ``set_flags`` and from the environment
    alike."""
    with _lock:
        spec = _FlagSpec(name=name, default=default, type=type(default),
                         help=help, on_change=on_change,
                         choices=tuple(choices) if choices else None,
                         later=later)
        _registry[name] = spec
        env = os.environ.get("FLAGS_" + name)
        _values[name] = _coerce(spec, env) if env is not None else default


def flag(name: str) -> Any:
    try:
        return _values[name]
    except KeyError:
        raise _unknown(name) from None


def get_flags(names: Union[str, Iterable[str], None] = None
              ) -> Dict[str, Any]:
    """``{name: value}`` for ``names`` (one name, several, or all)."""
    with _lock:
        if names is None:
            return dict(_values)
        if isinstance(names, str):
            names = [names]
        return {n: flag(n) for n in names}


def set_flags(flags_map: Dict[str, Any]) -> None:
    """Set flags by name, with or without the ``FLAGS_`` prefix: each
    value is coerced, checked and handed to the flag's ``on_change``. An
    unknown name raises ``KeyError``, a value outside ``choices``
    ``ValueError``."""
    with _lock:
        for name, value in flags_map.items():
            if name.startswith("FLAGS_"):
                name = name[len("FLAGS_"):]
            if name not in _registry:
                raise _unknown(name)
            spec = _registry[name]
            _values[name] = _coerce(spec, value)
            if spec.on_change is not None:
                spec.on_change(_values[name])


def list_flags() -> List[_FlagSpec]:
    with _lock:
        return list(_registry.values())


def unknown_env_flags() -> List[str]:
    """``FLAGS_*`` environment variables that name no defined flag."""
    with _lock:
        return sorted(k for k in os.environ
                      if k.startswith("FLAGS_")
                      and k[len("FLAGS_"):] not in _registry)


define_flag("fused_conv_bn", 0,
            "use the deferred-BN fused conv units in ResNet-class models "
            "in training (default off, as in the JAX package)")
define_flag("pallas_conv", 0,
            "route supported convs (1x1 as a matmul, NHWC 3x3 at stride 1 "
            "or 2) inside the fused units through the hand-written conv "
            "kernels with in-kernel BN prologue and stat epilogue (default "
            "off, as in the JAX package)")
define_flag("flash_head_pack", 1,
            "route d=64 dense-head attention to the head-packed kernel")
define_flag("amp_dtype", "bfloat16",
            "Preferred mixed-precision compute dtype.")
define_flag("serve_prefix_cache", False,
            "Radix prefix-sharing KV cache (serving/prefix_tree.py): "
            "requests whose prompts share a full-block prefix attach to "
            "the same immutable pages copy-on-write (refcounted "
            "BlockAllocator; only the partial tail block is private), "
            "eviction is LRU over refcount-0 trie leaves with a one-copy "
            "host spill tier. Off (default) keeps the engine "
            "byte-identical to the private-KV path.")
define_flag("serve_chunked_prefill", 0,
            "Chunked-prefill token budget for the serving engine: 0 "
            "(default) prefills every prompt in one bucketed dispatch "
            "(byte-identical to the pre-chunking engine); N > 0 splits "
            "prompts longer than N tokens into N-token chunks "
            "interleaved with the decode iterations so a long prompt "
            "no longer stalls resident decodes (N is rounded down to a "
            "multiple of the engine block size).")
define_flag("serve_speculative", 0,
            "Speculative-decoding draft depth (gamma) for the serving "
            "engine: 0 (default) decodes one token per iteration "
            "(byte-identical); N > 0 proposes N tokens per iteration "
            "from the drafter (NGramDrafter by default, or a "
            "ModelDrafter over a mirrored paged pool) and verifies them "
            "in ONE bucketed decode-gamma dispatch with the greedy "
            "accept-prefix rule; -1 consults the persistent autotune "
            "cache's accepted-length-derived gamma (falls back to 4).")
define_flag("kernel_autotune", 1,
            "consult the persistent kernel-autotune cache")
define_flag("kernel_autotune_cache_path", "",
            "override the autotune cache file location")
define_flag("telemetry", "metrics",
            "Runtime telemetry level (paddle_tpu_torch.observability): "
            "'off' disables every host-side signal (bitwise non-intrusive "
            "on step outputs), 'metrics' (default) keeps the always-on "
            "counters/gauges/histograms + step timeline + recompile "
            "sentinel + HBM watermarks, 'trace' additionally records "
            "span trees into the in-memory ring for chrome-trace/JSONL "
            "export.",
            choices=("off", "metrics", "trace"))
define_flag("flight_recorder", "off",
            "Crash-persistent per-process flight recorder "
            "(paddle_tpu_torch.observability.flight_recorder): 'off' "
            "(default) keeps every emit seam a no-op (byte-identical on "
            "step outputs, the FLAGS_telemetry contract); 'on' appends "
            "CRC-framed records (step phase commits, metric-snapshot "
            "deltas, O-rule diagnostics, serving request outcomes) into "
            "an mmap-backed ring that survives SIGKILL / os._exit with no "
            "flush.",
            choices=("off", "on"))
define_flag("flight_recorder_mb", 4,
            "Flight-recorder ring capacity per process incarnation in "
            "MiB (the ring wraps — oldest records are overwritten).")
define_flag("static_analysis", "off",
            "Static analysis mode (paddle_tpu_torch.analysis): 'off' "
            "skips, 'warn' prints diagnostics to stderr, 'error' raises "
            "GraphLintError on error-severity findings.",
            choices=("off", "warn", "error"))

# JAX's core/flags.py, the rest of it, with its defaults and help.
define_flag("default_dtype", "float32", "Default floating point dtype.")
define_flag("jit_cache_size", 4096, "Max entries in the compiled-step cache.")
define_flag("log_level", 0, "Framework VLOG-style verbosity (0=off).")
define_flag("allocator_strategy", "xla",
            "Parity stub: memory is managed by XLA/PJRT on TPU.")
define_flag("embedding_deterministic", False,
            "Use deterministic (slower) embedding gradient scatter.")
define_flag("flash_attn_version", 2, "Pallas flash-attention kernel version.")
define_flag("use_pallas_kernels", True,
            "Use Pallas TPU kernels where available (else jnp reference).")
define_flag("flash_block_q", 0,
            "flash-attention block override (0=auto). Validated as in the "
            "JAX package (both set or neither, multiples of 128); a valid "
            "value changes no kernel body: K1 keeps its 128-key stages")
define_flag("flash_block_k", 0,
            "flash-attention block override (0=auto). Validated as in the "
            "JAX package (both set or neither, multiples of 128); a valid "
            "value changes no kernel body: K1 keeps its 128-key stages")
define_flag("closed_form_norm_grad", 1,
            "use custom_vjp closed-form norm backward (faster; disables "
            "forward-mode AD through layer_norm/batch_norm)")

_ITEM5 = "ROADMAP Queue 1 item 5, the observability fleet exporter"
_ITEM8 = "ROADMAP Queue 1 item 8, distributed on torch.distributed"
_ITEM9 = "ROADMAP Queue 1 item 9, the training and service tiers"
_ITEM10 = "ROADMAP Queue 1 item 10, the analysis family"
define_flag("check_nan_inf", False,
            "Scan op outputs for NaN/Inf during training steps "
            "(ref: FLAGS_check_nan_inf, phi/core/flags.cc).", later=_ITEM9)
define_flag("check_nan_inf_level", 0,
            "0: error on NaN/Inf; higher levels only warn/log.",
            later=_ITEM9)
define_flag("use_deterministic_reductions", False,
            "Force deterministic XLA reductions (bitwise reproducibility).",
            later=_ITEM10)
define_flag("lockcheck", False,
            "Hand out instrumented locks (analysis.concurrency_check."
            "TrackedLock) that record real per-thread acquisition order "
            "for the T002 runtime cross-check. Off: plain threading "
            "locks, zero overhead.", later=_ITEM10)
define_flag("offload_optimizer", "off",
            "Optimizer-state memory tier (framework/offload.py): 'off' "
            "keeps all state in HBM (byte-identical to the pre-offload "
            "path); 'moments' parks first/second moments in pinned host "
            "memory and streams them through HBM per block during the "
            "update (ZeRO-Offload-style).",
            choices=("off", "moments"), later=_ITEM9)
define_flag("fleet_telemetry", "off",
            "Live fleet telemetry exporter (paddle_tpu.observability."
            "live): 'off' (default) keeps every export seam a no-op "
            "(byte-identical on step outputs, the FLAGS_telemetry "
            "contract); 'on' runs a per-process daemon thread that "
            "every FLAGS_fleet_export_interval seconds publishes a "
            "CRC-framed, atomically-replaced snapshot of the metrics "
            "registry (plus step index / heartbeat / role.replica."
            "incarnation identity) under <run>/fleet/ — the input to "
            "the fleet aggregator, the SLO/alert rule engine "
            "(observability/alerts.py) and tools/fleet_top.py.",
            choices=("off", "on"), later=_ITEM5)
define_flag("fleet_export_interval", 1.0,
            "Seconds between live fleet snapshot publications per "
            "worker (observability/live.py). Staleness classification "
            "keys off this: a worker whose latest snapshot is older "
            "than 2x its own advertised interval is 'dead'.",
            later=_ITEM5)
define_flag("comm_overlap", "off",
            "Communication-overlap tier (distributed/overlap.py): 'off' "
            "keeps every collective GSPMD-scheduled (byte-identical to "
            "the pre-overlap step); 'tp' decomposes the TP/SP "
            "all-gather->matmul and matmul->reduce-scatter into "
            "bidirectional ppermute pipelines; 'tp_zero' adds the ZeRO-3 "
            "param-gather-ahead prefetch; 'all' adds DP gradient-bucket "
            "overlap on the manual-sharding path.",
            choices=("off", "tp", "tp_zero", "all"), later=_ITEM8)
define_flag("comm_overlap_chunks", 0,
            "Sub-chunk count per decomposed-matmul hop (scheduler "
            "interleave granularity); 0 consults the persistent "
            "autotune cache, else 1.", later=_ITEM8)
define_flag("comm_overlap_bucket_mb", 25,
            "DP gradient bucket size in MiB for "
            "overlap.BucketedGradReducer (ref DataParallel "
            "comm_buffer_size default).", later=_ITEM8)
define_flag("multislice", "off",
            "Multi-slice (cross-DCN) gradient-reduction tier "
            "(distributed/multislice): 'off' keeps the step on the "
            "single-mesh GSPMD path (byte-identical — also the behavior "
            "on meshes without a 'slice' axis); 'hierarchical' reduces "
            "dp grads intra-slice (ICI reduce-scatter) -> inter-slice "
            "(DCN allreduce on the 1/ici_size shard) -> intra-slice "
            "(ICI all-gather); 'flat' is the naive per-axis flat-psum "
            "baseline that moves the full bucket over DCN (bitwise "
            "identical values; comm_check C004 flags its plan) — kept "
            "as the measured A/B arm.",
            choices=("off", "flat", "hierarchical"), later=_ITEM8)
define_flag("multislice_dcn_bucket_mb", 100,
            "DCN gradient bucket size in MiB for "
            "distributed/multislice.HierarchicalGradReducer — larger "
            "than FLAGS_comm_overlap_bucket_mb because the cross-slice "
            "latency floor (comm_check C005) is orders of magnitude "
            "above ICI's.", later=_ITEM8)
define_flag("health_sentinel", "off",
            "Training-health step sentinel (fault/health.py): 'off' "
            "keeps the train step byte-identical; 'on' fuses one "
            "[loss, grad-global-norm] anomaly check into the compiled "
            "step (no host callbacks, no clean-path sync) and gates the "
            "optimizer update in-graph on finiteness + rolling-median "
            "spike/explosion thresholds, returning the stats vector for "
            "the host-side verdict (fault/guardian.py drives recovery).",
            choices=("off", "on"), later=_ITEM9)
define_flag("cp_nested_ring", False,
            "Run the manual ring-attention CP path even when nested "
            "inside an enclosing manual shard_map (the pipeline "
            "runtime's pp axis) instead of falling back to "
            "GSPMD-scheduled attention. Exercised by the multichip "
            "dryrun's 4-axis scenario with loss parity against the "
            "fallback.", later=_ITEM8)
define_flag("deterministic", 0,
            "fixed-order reductions + pinned matmul precision",
            later=_ITEM9)
for _name, _default in (("autotune_kernel", True),
                        ("autotune_layout", True),
                        ("autotune_dataloader", False)):
    define_flag(_name, _default, f"incubate.autotune switch: {_name}",
                later=_ITEM9)
