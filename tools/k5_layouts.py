#!/usr/bin/env python3
"""K5's 16-bit body at every warp layout and ring depth (port, one GPU).

    python3 tools/k5_layouts.py [OUT.jsonl]

Times ``conv.mm`` (``conv1x1_tc_kernel``) at each of ResNet-50's 1x1
shapes (``RESNET50_K5_SHAPES``, B = 256, bf16): the forward with the ReLU
prologue and the stats at its stride, and the 1x1 input gradient (``dy @
wᵀ``), once with the tile ``conv.k5_plan`` picks and once with every
layout of up to 8 warps (64 warps_m rows x 32 warps_n output channels) and
a ring of three or four stages, each held against ``mm_reference`` (its
largest error beside its time). The rows also carry the earlier body
(``mm_tiles64``) and, at the two 56² bottleneck shapes, the forward
without the prologue, without the stats and without both. A sample is five
calls back to back (``chip_smoke.median_ms``), so the wrapper's host time
stays out of it; ``*_reps1`` columns take one call a sample. One JSON line
a shape and part, to stdout and, if given, ``OUT.jsonl``; the card's name
and power limit last.
These numbers chose ``k5_plan``'s rule (blocks of 8 warps, two an SM).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

LAYOUTS = [(wm, wn) for wm in (1, 2, 4) for wn in (2, 4, 8) if wm * wn <= 8]
RINGS = (3, 4)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k5_layouts: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from paddle_tpu_torch.ops._hopper import conv as hc

    out = open(sys.argv[1], "w") if len(sys.argv) > 1 else None
    g = torch.Generator(device="cuda")
    g.manual_seed(5)
    plan = hc.k5_plan
    for n, h, w, cin, cout, s, per_step in hc.RESNET50_K5_SHAPES:
        ho = (h - 1) // s + 1
        m = n * ho * ho
        x = torch.randn(n, h, w, cin, generator=g, device="cuda").bfloat16()
        w2 = (torch.randn(cin, cout, generator=g, device="cuda") *
              cin ** -0.5).bfloat16()
        sc = torch.randn(cin, generator=g, device="cuda")
        sh = torch.randn(cin, generator=g, device="cuda")
        dy = torch.randn(n, ho, ho, cout, generator=g,
                         device="cuda").bfloat16()
        wt = w2.t().contiguous()
        for part, args, c, k in (
                ("fwd", (x, w2, sc, sh, "relu", True, s), cin, cout),
                ("dgrad", (dy, wt, None, None, "none", False, 1), cout,
                 cin)):
            ref = hc.mm_reference(*args)[0].float()
            row = {"shape": [n, h, w, cin, cout, s], "part": part,
                   "per_step": per_step, "chosen": list(plan(m, c, k)),
                   "chosen_ms_reps1": cs.median_ms(lambda: hc.mm(*args)),
                   "chosen_ms_reps5": cs.median_ms(lambda: hc.mm(*args),
                                                   reps=5),
                   "tiles64_ms_reps5": cs.median_ms(
                       lambda: hc.mm_tiles64(*args), reps=5)}
            try:
                for wm, wn in LAYOUTS:
                    for stages in RINGS:
                        if hc.k5_smem_bytes(wm, wn, c, part == "fwd",
                                            stages) > hc._BLOCK_SMEM:
                            continue
                        pinned = hc.K5Plan(wm, wn, 64 * wm, -(-m // (64 * wm)),
                                           -(-k // (32 * wn)), stages)
                        hc.k5_plan = lambda *a, p=pinned: p
                        y = hc.mm(*args)[0]
                        row[f"{wm}x{wn}s{stages}"] = [
                            cs.median_ms(lambda: hc.mm(*args), reps=5),
                            float((y.float() - ref).abs().max())]
                        del y
            finally:
                hc.k5_plan = plan
            if part == "fwd" and h == 56 and (cin, cout, s) in (
                    (256, 64, 1), (64, 256, 1)):
                for name, a in (
                        ("no_prologue", (x, w2, None, None, "none", True, s)),
                        ("no_stats", (x, w2, sc, sh, "relu", False, s)),
                        ("neither", (x, w2, None, None, "none", False, s))):
                    row[name] = cs.median_ms(lambda: hc.mm(*a), reps=5)
            line = json.dumps(row)
            if out is not None:
                out.write(line + "\n")
                out.flush()
            print(line, flush=True)
            del ref
        del x, w2, dy, wt
        torch.cuda.empty_cache()
    if out is not None:
        out.close()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
