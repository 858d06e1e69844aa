#!/usr/bin/env python3
"""Where a Transformer-base training step spends the card's time.

    python3 tools/profile_transformer.py [--dropout P]

Builds ``chip_smoke.py``'s seq2seq wrapper around the port's
``nn.Transformer`` at Transformer-base width (6 + 6 layers, d_model 512, 8
heads of 64, FFN 2048, vocab 37,000, label smoothing 0.1) and trains it as
``train_transformer_bf16`` does (B=64 x 256 a side, AMP-O2,
``AdamW(beta2=0.98, epsilon=1e-9)`` on ``NoamDecay(512, 4000)``): 2
warm-up steps, then 3 steps under ``torch.profiler``. Prints one JSON line:
the device's busy time over the host's wall clock
(``chip_smoke.device_profile``), the kernels that took most of it, and the
device time summed by kind (K4's kernels, the matmuls, the softmax and
cross-entropy, the optimizer, other elementwise work), with the card's name
and power limit as nvidia-smi prints them.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def kind(name: str) -> str:
    n = name.lower()
    if "flash" in n:
        return "k4"
    if "gemm" in n or "sm90_xmma" in n or "cutlass" in n or "nvjet" in n:
        return "matmul"
    if "softmax" in n or "nll" in n or "log_soft" in n:
        return "softmax_loss"
    if "multi_tensor" in n or "adam" in n or "foreach" in n:
        return "optimizer"
    if "reduce" in n:
        return "reduction"
    if "copy" in n or "memcpy" in n or "memset" in n or "cat" in n:
        return "copy"
    return "elementwise_other"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dropout", type=float, default=0.1)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("profile_transformer: needs one NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import paddle_tpu_torch as P
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.framework import make_sharded_train_step
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer.lr import NoamDecay
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    torch.cuda.set_device(0)
    b, s = 64, cs.T_LEN
    model = cs.seq2seq(torch, P, "cuda", 0, dropout=args.dropout)
    opt = AdamW(learning_rate=NoamDecay(512, 4000), beta2=0.98,
                epsilon=1e-9, multi_precision=True)
    model, opt = amp.decorate(model, opt, level="O2")
    step = make_sharded_train_step(model, opt, lambda m, bt: m(*bt))
    rng = np.random.default_rng(0)
    batches = [cs.t_batch(torch, np, rng, b, s, s, "cuda") for _ in range(5)]
    for bt in batches[:2]:
        step.step(bt)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for bt in batches[2:]:
            step.step(bt)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kind = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            k = kind(ev.name)
            by_kind[k] = by_kind.get(k, 0.0) + \
                (ev.time_range.end - ev.time_range.start) / 1e3 / 3
    print(json.dumps({"tool": "profile_transformer",
                      "dropout": args.dropout, "batch": [b, s, s],
                      "profiled_steps": 3,
                      "device_ms_per_step_by_kind": by_kind,
                      **cs.device_profile(prof, wall_ms), "card": smi}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
