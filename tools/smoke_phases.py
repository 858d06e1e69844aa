#!/usr/bin/env python3
"""Run the input-pipeline, detection and audio/text phases of
``chip_smoke.py`` alone on the card.

    python3 tools/smoke_phases.py [folder] [vision_ops] [audio_text]

Builds the kernels as ``chip_smoke.py`` does, then runs each named phase
(all three by default) to its end or its fault: ``folder`` is
``train_resnet_bf16`` (for its images/s) then ``train_resnet_folder_bf16``
with both conv flags on; ``vision_ops`` and ``audio_text`` are the phases
of the same names. Each phase prints its rows as ``chip_smoke.py`` does,
then one line with its seconds. Prints the card's name and power limit as
nvidia-smi gives them; exits 1 if a phase failed.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402

PHASES = ("folder", "vision_ops", "audio_text")


def main(argv) -> int:
    import numpy as np
    import torch

    import paddle_tpu_torch as P
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.framework import make_sharded_train_step
    from paddle_tpu_torch.ops._hopper import build
    from paddle_tpu_torch.ops._hopper import conv as hc
    from paddle_tpu_torch.ops._hopper import flash_attention as hfa
    from paddle_tpu_torch.ops._hopper import flash_attention_packed as hfp
    from paddle_tpu_torch.ops._hopper import fused_matmul_bn as fmb
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet50
    which = argv or list(PHASES)
    unknown = set(which) - set(PHASES)
    if unknown:
        print(f"unknown phases {sorted(unknown)}; choose from {PHASES}",
              file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
        .strip(), flush=True)
    t0 = time.perf_counter()
    cs.phase_env(torch, build)
    cs.phase_build(build)
    peaks = cs.card_peaks(torch.cuda.get_device_name(0))
    ok = True
    for name in which:
        t1 = time.perf_counter()
        try:
            if name == "folder":
                flags.set_flags({"fused_conv_bn": 1, "pallas_conv": 1})
                _, row = cs.phase_train_resnet_bf16(
                    torch, np, hc, hfa, hfp, peaks, resnet50, Momentum,
                    make_sharded_train_step)
                torch.cuda.empty_cache()
                cs.phase_train_resnet_folder_bf16(
                    torch, np, P, hc, hfa, hfp, fmb, peaks, resnet50,
                    Momentum, make_sharded_train_step, row)
                flags.set_flags({"fused_conv_bn": 0, "pallas_conv": 0})
            elif name == "vision_ops":
                cs.phase_vision_ops(torch, np, P, hfa, hfp, hc, fmb)
            else:
                cs.phase_audio_text(torch, np, P, hfa, hfp, hc, fmb)
        except Exception:
            traceback.print_exc()
            ok = False
        torch.cuda.empty_cache()
        print({"phase": name, "s": time.perf_counter() - t1}, flush=True)
    print({"smoke_phases_s": time.perf_counter() - t0, "ok": ok}, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
