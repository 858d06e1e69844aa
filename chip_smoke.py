#!/usr/bin/env python3
"""Drive paddle_tpu_torch on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout (nvcc, at
first use), holds each kernel against its plain PyTorch version on the card,
and serves GPT-3 1.3B (``gpt3_1p3b``: 24 layers, hidden 2048, 16 heads,
vocab 50304; random weights from a seed) through ``ServingEngine``:

1. env     torch, CUDA, nvcc and the card as nvidia-smi names it;
2. build   the kernels, timed, with ptxas's register and spill report;
3. kernel  K1 (flash_fwd) against flash_fwd_reference at the serving
           path's shapes and the edge cases, and timed at S=2048;
4. serve_f32   3 requests x 16 tokens, token-exact against the model's
           dense-cache ``generate`` (no kernel there);
5. serve_bf16  8 requests of 64..1536 prompt tokens x 32 tokens through a
           pool of about half the trace's blocks, shrunk until a CPU dry
           run of the trace preempts (spill to pinned host memory and
           restore); every prefill runs K1 once per layer.

``--profile`` adds a phase that serves the bf16 trace again under
torch.profiler and prints the device busy share and the kernels that take
the device's time. Each phase prints one JSON line. Then come the ``{"kernels": [...]}`` line,
the card's name and power limit, and the last line
``{"ok": true, "device": {...}}``. Any failed check raises: the script exits
non-zero without that last line, as it does when CUDA is absent or the
package is not beside it.
"""

from __future__ import annotations

import importlib.metadata
import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))


class SmokeFailure(RuntimeError):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_peaks(name: str) -> dict:
    """Dense peak rates from NVIDIA's data sheet of the card nvidia-smi
    names: bf16 tensor-core FLOP/s, f32 (CUDA-core) FLOP/s, memory B/s."""
    n = name.lower()
    if "h200" in n:
        return {"bf16": 989e12, "f32": 67e12, "bytes": 4.8e12,
                "sheet": "H200 SXM"}
    if "h100" in n and "pcie" in n:
        return {"bf16": 756e12, "f32": 51e12, "bytes": 2.0e12,
                "sheet": "H100 PCIe"}
    if "h100" in n and "nvl" in n:
        return {"bf16": 835e12, "f32": 60e12, "bytes": 3.9e12,
                "sheet": "H100 NVL"}
    return {"bf16": 989e12, "f32": 67e12, "bytes": 3.35e12,
            "sheet": "H100 SXM"}


def attention_pairs(sq: int, sk: int, causal: bool) -> int:
    """(query, key) pairs the inputs need: bottom-right causal keeps key j
    for query i when j <= i + sk - sq."""
    if not causal:
        return sq * sk
    off = sk - sq
    return sum(min(sk, max(0, i + off + 1)) for i in range(sq))


def median_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def percentile(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, max(0, math.ceil(q / 100 * len(xs)) - 1))]


# -- phase 1 -----------------------------------------------------------------

def phase_env(torch, build):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    smi_line = smi.stdout.strip().splitlines()[0]
    nvcc = subprocess.run([build.nvcc_path(), "--version"],
                          capture_output=True, text=True, timeout=60)
    check(nvcc.returncode == 0, f"nvcc --version failed: {nvcc.stderr}")
    try:
        triton = importlib.metadata.version("triton")
    except importlib.metadata.PackageNotFoundError:
        triton = None
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "torch_cuda": torch.version.cuda,
          "nvcc": nvcc.stdout.strip().splitlines()[-1], "triton": triton,
          "cutlass_headers": os.path.isdir("/usr/local/cutlass/include"),
          "nvidia_smi": smi_line,
          "device": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count()})
    return smi_line


# -- phase 2 -----------------------------------------------------------------

def phase_build(build):
    t0 = time.perf_counter()
    paths = build.build_all()
    for stem in paths:
        build.library(stem)
    seconds = time.perf_counter() - t0
    ptxas = {}
    for stem in paths:
        log = build.BUILD_DIR / f"{stem}.log"
        lines = log.read_text().splitlines() if log.exists() else []
        ptxas[stem] = [ln.replace("ptxas info    : ", "").strip()
                       for ln in lines if "Compiling entry" in ln
                       or "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": seconds,
          "libraries": {k: os.path.relpath(v, REPO)
                        for k, v in paths.items()},
          "ptxas": ptxas})


# -- phase 3 -----------------------------------------------------------------

# name, B, Sq, Sk, H, HK, D, causal, dtype
K1_CASES = [
    ("1p3b_s512", 1, 512, 512, 16, 16, 128, True, "bf16"),
    ("1p3b_s1024", 1, 1024, 1024, 16, 16, 128, True, "bf16"),
    ("1p3b_s2048", 1, 2048, 2048, 16, 16, 128, True, "bf16"),
    ("ragged_s300", 1, 300, 300, 16, 16, 128, True, "bf16"),
    ("gqa_hk4", 1, 1024, 1024, 16, 4, 128, True, "bf16"),
    ("sq128_sk384", 1, 128, 384, 16, 16, 128, True, "bf16"),
    ("masked_rows_sq300_sk200", 1, 300, 200, 16, 16, 128, True, "bf16"),
    ("noncausal_s1024", 1, 1024, 1024, 16, 16, 128, False, "bf16"),
    ("f32_s1024", 1, 1024, 1024, 16, 16, 128, True, "f32"),
    ("f32_ragged_s200_noncausal", 2, 200, 200, 16, 16, 128, False, "f32"),
    ("d64_s512", 2, 512, 512, 16, 16, 64, True, "bf16"),
    ("d64_f32_s333", 1, 333, 333, 8, 2, 64, True, "f32"),
    ("d256_s512", 1, 512, 512, 8, 8, 256, True, "bf16"),
    ("d256_f32_s256_noncausal", 1, 256, 256, 4, 4, 256, False, "f32"),
]


def k1_inputs(torch, b, sq, sk, h, hk, d, dtype, seed):
    """q, k, v as the serving path hands them over: strided views of one
    fused projection when sq == sk (q/k/v from qkv, or q plus kv under
    GQA), separate tensors otherwise."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda",
                           dtype=torch.float32).to(dtype)

    if sq == sk and h == hk:
        qkv = randn(b, sq, 3, h, d)
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    if sq == sk:
        kv = randn(b, sk, 2, hk, d)
        return randn(b, sq, h, d), kv[:, :, 0], kv[:, :, 1]
    return randn(b, sq, h, d), randn(b, sk, hk, d), randn(b, sk, hk, d)


def phase_kernel(torch, hfa, peaks):
    """Every case through the kernel and the plain version on the same
    inputs, then the kernel, the plain version and the library call timed
    at the main path's largest prefill shape."""
    import torch.nn.functional as F
    results = []
    worst = 0.0
    for i, (name, b, sq, sk, h, hk, d, causal, dt) in enumerate(K1_CASES):
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        q, k, v = k1_inputs(torch, b, sq, sk, h, hk, d, dtype, seed=100 + i)
        o, lse = hfa.flash_fwd(q, k, v, causal=causal)
        torch.cuda.synchronize()
        ro, rlse = hfa.flash_fwd_reference(q, k, v, causal=causal)
        torch.cuda.synchronize()
        check(o.shape == (b, sq, h, d) and o.dtype == dtype,
              f"{name}: o {tuple(o.shape)} {o.dtype}")
        check(lse.shape == (b, h, sq) and lse.dtype == torch.float32,
              f"{name}: lse {tuple(lse.shape)} {lse.dtype}")
        check(bool(torch.isfinite(o).all()) and
              bool(torch.isfinite(lse).all()), f"{name}: non-finite output")
        err_o = (o.float() - ro.float()).abs()
        err_lse = (lse - rlse).abs()
        if dt == "bf16":
            # bf16 rounding of o, and sums over up to 2048 keys in another
            # order than the plain version's
            ok = bool((err_o <= 2e-2 + 2e-2 * ro.float().abs()).all()) and \
                float(err_lse.max()) <= 1e-2
        else:
            # f32 sums over up to 1024 keys in another order
            ok = float(err_o.max()) <= 1e-4 and float(err_lse.max()) <= 1e-4
        row = {"case": name, "shape": [b, sq, sk, h, hk, d], "causal": causal,
               "dtype": dt, "max_abs_err_o": float(err_o.max()),
               "max_abs_err_lse": float(err_lse.max()), "ok": ok}
        results.append(row)
        check(ok, f"K1 disagrees with its plain version: {row}")
        worst = max(worst, float(err_o.max()))

    b, s, h, d = 1, 2048, 16, 128
    q, k, v = k1_inputs(torch, b, s, s, h, h, d, torch.bfloat16, seed=7)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    kernel_ms = median_ms(lambda: hfa.flash_fwd(q, k, v, causal=True))
    plain_ms = median_ms(
        lambda: hfa.flash_fwd_reference(q, k, v, causal=True))
    library_ms = median_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    flops = 4 * b * h * d * attention_pairs(s, s, True)
    nbytes = 4 * b * s * h * d * 2 + b * h * s * 4    # q, k, v, o + lse
    t_ops = flops / peaks["bf16"] * 1e3
    t_bytes = nbytes / peaks["bytes"] * 1e3
    timing = {"shape": [b, s, s, h, h, d], "dtype": "bf16", "causal": True,
              "kernel_ms": kernel_ms, "plain_ms": plain_ms,
              "library_ms": library_ms, "flops": flops, "bytes": nbytes,
              "bound_ms": max(t_ops, t_bytes),
              "bound_by": "operations" if t_ops >= t_bytes else "bytes",
              "peak_sheet": peaks["sheet"],
              "tflops": flops / kernel_ms / 1e9}
    emit({"phase": "kernel", "kernel": "flash_fwd", "cases": results,
          "timing": timing})
    return worst, timing


# -- phases 4 and 5 ----------------------------------------------------------

def top2_gap(torch, model, prefix):
    """generate's top-2 logit gap after ``prefix`` (dense decode, as
    generate computes it)."""
    with torch.no_grad():
        ids = torch.as_tensor(prefix, device=model.device)[None].long()
        caches = model.gpt.init_cache(1, ids.shape[1])
        hidden, _ = model.gpt.decode(ids, caches, 0)
        top = torch.topk(model.logits(hidden[:, -1])[0].float(), 2).values
    return float(top[0] - top[1])


def phase_serve_f32(torch, np, hfa, model, Request, ServingEngine):
    rng = np.random.default_rng(1)
    vocab, n_layers = model.cfg.vocab_size, model.cfg.num_layers
    lens = [int(n) for n in rng.integers(64, 480, 3)]
    reqs = [Request(rid=f"f{i}", prompt_ids=rng.integers(0, vocab, n),
                    max_new_tokens=16) for i, n in enumerate(lens)]
    engine = ServingEngine(model, block_size=16, num_blocks=160, max_batch=4,
                           max_seq_len=512, device="cuda")
    hfa.flash_fwd.launches = 0
    res = engine.serve(reqs)
    torch.cuda.synchronize()
    launches = hfa.flash_fwd.launches
    check(launches == engine.n_prefills * n_layers,
          f"f32 serve: {launches} K1 launches for {engine.n_prefills} "
          f"prefills")
    rows = []
    for r in reqs:
        got = res[r.rid].output
        want = model.generate(
            torch.as_tensor(r.prompt_ids, device="cuda")[None].long(),
            max_new_tokens=16)[0].cpu().numpy()
        check(got.shape == want.shape, f"{r.rid}: shape {got.shape}")
        diff = np.nonzero(got != want)[0]
        row = {"rid": r.rid, "prompt": int(r.prompt_ids.size),
               "exact": diff.size == 0}
        if diff.size:
            pos = int(diff[0])
            gap = top2_gap(torch, model, want[:pos])
            row.update(first_mismatch=pos - int(r.prompt_ids.size),
                       engine_token=int(got[pos]),
                       generate_token=int(want[pos]), top2_gap=gap)
            check(gap < 1e-3, f"f32 serve differs from generate beyond a "
                              f"near-tie: {row}")
        rows.append(row)
    emit({"phase": "serve_f32", "model": "gpt3_1p3b", "layers": n_layers,
          "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "prefills": engine.n_prefills, "k1_launches": launches,
          "requests": rows})


def pick_pool(np, Request, ServingEngine, GPTForCausalLM, gpt_tiny, reqs,
              bs, max_seq, start):
    """The largest pool at or below ``start`` blocks under which the trace
    preempts. With no eos, scheduling depends only on the lengths, so a dry
    run of the same trace through the engine with a one-layer CPU model
    decides it; the GPU run then preempts the same way."""
    tiny = GPTForCausalLM(gpt_tiny(vocab_size=64, hidden_size=16,
                                   num_layers=1, num_heads=2,
                                   max_position_embeddings=max_seq),
                          device="cpu")
    dry = [Request(rid=r.rid, prompt_ids=np.zeros(r.prompt_ids.size),
                   max_new_tokens=r.max_new_tokens) for r in reqs]
    min_blocks = -(-max_seq // bs) + 1
    for num_blocks in range(start, min_blocks - 1, -1):
        engine = ServingEngine(tiny, block_size=bs, num_blocks=num_blocks,
                               max_batch=8, max_seq_len=max_seq,
                               device="cpu")
        engine.serve(dry)
        if engine.n_preemptions:
            return num_blocks
    raise SmokeFailure(f"no pool of {min_blocks}..{start} blocks preempts")


def bf16_trace(np, Request, vocab, new=32):
    """8 requests, prompt lengths drawn from 64..1536 (seed 2)."""
    rng = np.random.default_rng(2)
    sizes = [int(n) for n in rng.integers(64, 1537, 8)]
    return [Request(rid=f"b{i}", prompt_ids=rng.integers(0, vocab, n),
                    max_new_tokens=new) for i, n in enumerate(sizes)]


def phase_serve_bf16(torch, np, hfa, model, Request, ServingEngine,
                     GPTForCausalLM, gpt_tiny):
    n_layers = model.cfg.num_layers
    bs, new = 16, 32
    reqs = bf16_trace(np, Request, model.cfg.vocab_size, new)
    lens = [int(r.prompt_ids.size) for r in reqs]
    max_seq = max(lens) + new
    need = [-(-(n + new) // bs) for n in lens]
    num_blocks = pick_pool(np, Request, ServingEngine, GPTForCausalLM,
                           gpt_tiny, reqs, bs, max_seq, sum(need) // 2)
    engine = ServingEngine(model, block_size=bs, num_blocks=num_blocks,
                           max_batch=8, max_seq_len=max_seq, device="cuda")
    # the main path: counts are set to 0 just before it and read after
    hfa.flash_fwd.launches = 0
    t0 = time.perf_counter()
    res = engine.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = hfa.flash_fwd.launches
    for r in reqs:
        seq = res[r.rid]
        check(seq.status.value == "finished", f"{r.rid}: {seq.status}")
        check(seq.n_generated == new, f"{r.rid}: {seq.n_generated} tokens")
        out = seq.output[r.prompt_ids.size:]
        check(bool(((out >= 0) & (out < model.cfg.vocab_size)).all()),
              f"{r.rid}: token ids out of range")
    check(engine.n_preemptions >= 1, "no preemption")
    check(launches == engine.n_prefills * n_layers,
          f"bf16 serve: {launches} K1 launches for {engine.n_prefills} "
          f"prefills")
    decode_s = sum(engine.decode_ms) / 1e3
    emit({"phase": "serve_bf16", "model": "gpt3_1p3b", "layers": n_layers,
          "prompt_lens": lens, "new_tokens": new, "block_size": bs,
          "pool_blocks": num_blocks, "trace_blocks": sum(need),
          "prefills": engine.n_prefills,
          "preemptions": engine.n_preemptions, "k1_launches": launches,
          "wall_s": wall,
          "prefill_tokens_per_s": engine.prefill_tokens / engine.prefill_s,
          "decode_tokens_per_s": engine.decode_tokens / decode_s,
          "decode_iterations": len(engine.decode_ms),
          "decode_step_p50_ms": percentile(engine.decode_ms, 50),
          "decode_step_p99_ms": percentile(engine.decode_ms, 99)})
    return launches, num_blocks


def phase_profile(torch, np, model, Request, ServingEngine, num_blocks):
    """``--profile``: the bf16 trace once more under torch.profiler. Device
    busy time is the union of the GPU events' intervals; the window is the
    host wall clock around ``serve``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    reqs = bf16_trace(np, Request, model.cfg.vocab_size)
    max_seq = max(r.prompt_ids.size for r in reqs) + 32
    engine = ServingEngine(model, block_size=16, num_blocks=num_blocks,
                           max_batch=8, max_seq_len=max_seq, device="cuda")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.serve(reqs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, by_name = [], {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        a, b = ev.time_range.start, ev.time_range.end
        spans.append((a, b))
        by_name[ev.name] = by_name.get(ev.name, 0.0) + (b - a) / 1e3
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    emit({"phase": "profile", "wall_ms": wall_ms, "device_events": len(spans),
          "device_busy_ms": busy_us / 1e3,
          "device_busy_share": busy_us / 1e3 / wall_ms,
          "prefill_s": engine.prefill_s,
          "decode_s": sum(engine.decode_ms) / 1e3,
          "top_device_ms": [[name[:90], ms] for name, ms in top]})


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs one NVIDIA GPU", file=sys.stderr)
        return 2
    try:
        import numpy as np
        from paddle_tpu_torch.ops._hopper import build
        from paddle_tpu_torch.ops._hopper import flash_attention as hfa
        from paddle_tpu_torch.serving import Request, ServingEngine
        from paddle_tpu_torch.text.models.gpt import (GPTForCausalLM,
                                                      gpt3_1p3b, gpt_tiny)
    except ImportError as e:
        print(f"chip_smoke: the paddle_tpu_torch package must sit beside "
              f"this script ({e})", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    # full f32 products for the f32 reference comparison (TF32 keeps about
    # three decimal digits)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi_line = phase_env(torch, build)
    phase_build(build)
    peaks = card_peaks(torch.cuda.get_device_name(0))
    worst, timing = phase_kernel(torch, hfa, peaks)

    model = GPTForCausalLM(gpt3_1p3b(), device="cuda", dtype=torch.float32,
                           seed=0)
    phase_serve_f32(torch, np, hfa, model, Request, ServingEngine)
    model = model.to(torch.bfloat16)
    torch.cuda.empty_cache()
    launches, num_blocks = phase_serve_bf16(
        torch, np, hfa, model, Request, ServingEngine, GPTForCausalLM,
        gpt_tiny)
    if "--profile" in sys.argv[1:]:
        phase_profile(torch, np, model, Request, ServingEngine, num_blocks)

    emit({"kernels": [{
        "name": "flash_fwd", "route": "cuda",
        "source": "paddle_tpu_torch/ops/_hopper/csrc/flash_fwd.cu",
        "replaces": "paddle_tpu/ops/_pallas/flash_attention.py:224 "
                    "(_fwd_kernel, launched by _fwd at :404)",
        "launches": launches, "max_abs_err": worst, "max_err": worst,
        "ms": timing["kernel_ms"], "kernel_ms": timing["kernel_ms"],
        "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"], "library_ms": timing["library_ms"],
    }]})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
