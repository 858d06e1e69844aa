#!/usr/bin/env python3
"""How far rounding moves a random-init ResNet's training numbers (port, CPU).

    python3 tools/resnet_grad_sensitivity.py

Runs one forward and backward of a ResNet in float32 on the CPU through
the port's library route (both conv flags off, no kernel involved) on an
input ``x`` and again on ``x · (1 + 1e-7·z)`` (z standard normal), and
prints how much the loss, the logits, the BN running stats and the
gradients move: per gradient tensor, the change over its 2-norm and over
its largest |value|, worst tensor first. Two models:

- ResNet-50 (1000 classes, NHWC, space-to-depth stem, seed 0) at B=2 x
  224² from ``default_rng(7)``: ``chip_smoke.py``'s f32 card-vs-CPU check;
- ``ResNet(BottleneckBlock, 18, num_classes=10)`` at 32² and 64², B=4 from
  ``default_rng(0)``: ``tests/test_torch_resnet.py``'s model.

Then three Momentum(0.01, 0.9) steps of the toy at 32² on the kernel route
(plain versions here) and on the library route, whose losses differ only
by rounding. The numbers set the tolerances of those comparisons.
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def forward_backward(torch, make, x, y):
    from paddle_tpu_torch.nn.functional import cross_entropy
    model = make().train()
    logits = model(torch.from_numpy(x))
    loss = cross_entropy(logits.float(), torch.from_numpy(y))
    loss.backward()
    return (float(loss.detach()), logits.detach(),
            {n: b.clone() for n, b in model.named_buffers()},
            {n: p.grad.clone() for n, p in model.named_parameters()})


def sensitivity(torch, name, make, x, y):
    rng = np.random.default_rng(11)
    xp = (x * (1 + 1e-7 * rng.standard_normal(x.shape))).astype(np.float32)
    a = forward_backward(torch, make, x, y)
    b = forward_backward(torch, make, xp, y)
    norm = sorted(((float((b[3][n] - g).norm() / g.norm()), n)
                   for n, g in a[3].items()), reverse=True)
    peak = sorted(((float((b[3][n] - g).abs().max() / g.abs().max()), n)
                   for n, g in a[3].items()), reverse=True)
    buf = max(float((b[2][n] - v).abs().max() / (1 + v.abs().max()))
              for n, v in a[2].items())
    print(f"{name}: loss {a[0]:.6f}, moved {abs(a[0] - b[0]):.3g}; logits "
          f"{float((a[1] - b[1]).abs().max()):.3g}; buffers {buf:.3g} "
          f"(relative); gradients over their 2-norm {norm[0][0]:.3g} "
          f"({norm[0][1]}), over their largest {peak[0][0]:.3g} "
          f"({peak[0][1]})", flush=True)


def main() -> int:
    import torch
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.framework import make_sharded_train_step
    from paddle_tpu_torch.nn.functional import cross_entropy
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet50
    from paddle_tpu_torch.vision.models.resnet import BottleneckBlock, ResNet

    def toy():
        return ResNet(BottleneckBlock, 18, num_classes=10, data_format="NHWC",
                      stem_mode="space_to_depth", device="cpu", seed=0)

    flags.set_flags({"fused_conv_bn": 0, "pallas_conv": 0})
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 224, 224, 3)).astype(np.float32)
    y = rng.integers(0, 1000, (2,))
    sensitivity(torch, "resnet50 B=2 224", lambda: resnet50(
        data_format="NHWC", stem_mode="space_to_depth", device="cpu",
        seed=0), x, y)
    for img in (32, 64):
        rng = np.random.default_rng(0)
        x = rng.standard_normal((4, img, img, 3)).astype(np.float32)
        y = rng.integers(0, 10, (4,))
        sensitivity(torch, f"toy B=4 {img}", toy, x, y)

    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, (4,)).astype(np.int32)
    for route, on in (("kernel route", 1), ("library route", 0)):
        flags.set_flags({"fused_conv_bn": on, "pallas_conv": on})
        step = make_sharded_train_step(
            toy(), Momentum(learning_rate=0.01, momentum=0.9),
            lambda m, b: cross_entropy(m(b[0]).float(), b[1]))
        losses = [float(step.step((x, y))) for _ in range(3)]
        print(f"toy 3 Momentum steps, {route}: losses "
              f"{', '.join(f'{v:.6f}' for v in losses)}", flush=True)
    flags.set_flags({"fused_conv_bn": 0, "pallas_conv": 0})
    return 0


if __name__ == "__main__":
    sys.exit(main())
