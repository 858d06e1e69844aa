#!/usr/bin/env python3
"""GPT-3 Medium's training step under activation recompute, for an A/B of
two checkouts of the port on one NVIDIA GPU.

    python3 tools/recompute_k4_ab.py --root DIR --label NAME [--timed N]

Imports ``paddle_tpu_torch`` from the checkout at ``DIR`` (so a parent
commit unpacked beside the repo can be timed in the same call as the
change, one process each) and trains GPT-3 Medium (Brown et al. 2020,
Table 2.1: 24 layers, d_model 1024, 16 heads of 64; vocab 50304) at B=4 x
2048, AMP-O2 AdamW with f32 masters, 2 warm-up and ``--timed`` timed
steps (CUDA events), in three modes: no recompute, ``recompute=True``
under the default policy (``dots_and_flash_saveable``) and under ``None``
(full recompute). Attention runs K4's streamed forward, dq and dk/dv
(their tensor-core bodies). With ``--profile``, 2 more steps of each
mode under ``torch.profiler``: the device's busy time a step against the
host's wall clock, and the kernels that take it
(``chip_smoke.device_profile``). The profiler slows the steps that follow
it, so timings are quoted from runs without it.

Prints one JSON line a mode: step p50/p99 ms, tokens/s, peak memory, the
K4 launches a step (``launches`` of each wrapper), the profiled busy
share, and the card's name and power limit as nvidia-smi prints them.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--label", required=True)
    ap.add_argument("--timed", type=int, default=6)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("recompute_k4_ab: needs one NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.framework import make_sharded_train_step
    from paddle_tpu_torch.ops._hopper import flash_attention_packed as hfp
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM
    from torch.profiler import ProfilerActivity, profile
    import paddle_tpu_torch
    if os.path.dirname(os.path.dirname(paddle_tpu_torch.__file__)) != root:
        raise RuntimeError(f"paddle_tpu_torch came from "
                           f"{paddle_tpu_torch.__file__}, not {root}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    torch.cuda.set_device(0)
    b, s, warmup = 4, 2048, 2
    forms = ("flash_packed_fwd_stream_tc", "flash_packed_bwd_dq_tc",
             "flash_packed_bwd_dkv_tc")
    for mode in ("off", "dots_and_flash_saveable", None):
        cfg = GPTConfig(hidden_size=1024, num_layers=24, num_heads=16,
                        recompute=mode != "off",
                        recompute_policy=None if mode == "off" else mode)
        model = GPTForCausalLM(cfg, device="cuda", dtype=torch.float32,
                               seed=0)
        opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                    multi_precision=True)
        model, opt = amp.decorate(model, opt, level="O2")
        step = make_sharded_train_step(model, opt, cs.gpt_loss)
        batches = cs.bench_batches(np, warmup + args.timed + 2, b, s,
                                   cfg.vocab_size)
        it = iter(batches)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for name in forms:
            getattr(hfp, name).launches = 0
        losses, times = cs.timed_steps(torch, lambda: step.step(next(it)),
                                       warmup, args.timed)
        launches = {n: getattr(hfp, n).launches / len(losses)
                    for n in forms}
        peak = torch.cuda.max_memory_allocated() / 1e9
        dev = None
        if args.profile:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(2):
                    step.step(next(it))
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            dev = cs.device_profile(prof, wall_ms)
        print(json.dumps({
            "tool": "recompute_k4_ab", "label": args.label,
            "mode": mode, "model": "gpt3_medium", "batch": [b, s],
            "step_ms": times, "step_p50_ms": cs.percentile(times, 50),
            "step_p99_ms": cs.percentile(times, 99),
            "tokens_per_s": len(times) * b * s / (sum(times) / 1e3),
            "max_memory_allocated_gb": peak,
            "launches_per_step": launches, "losses": losses,
            "profiled_steps": 2 if dev else 0, "profile": dev,
            "card": smi}),
            flush=True)
        del model, opt, step
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
