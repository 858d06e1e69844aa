#!/usr/bin/env python3
"""How far two AdamW steps part when only rounding differs (port, CPU).

    python3 tools/adamw_rounding_probe.py

Two float32 comparisons of the port's tests hold AdamW's numbers after two
steps tightly: ``tests/test_torch_optimizer_imperative.py::
test_imperative_adamw_loop_matches_jax`` (moments within rtol 1e-5, atol
1e-7) and ``tests/test_torch_recompute.py::test_ernie_pipeline_with_
recompute_interval_matches_jax`` (parameters within 1e-5). Each model here
is that test's model and batch, with the port's own seeded weights; its two
steps run three times on the same weights: float32 on one torch thread,
float32 on eight, and float64. Nothing changes between the float32 runs
but the order of the CPU's sums. Printed per model:

- the first step's gradients, float32 against float64, over each
  tensor's largest |value| (worst tensor; not the key bias, whose true
  gradient is 0 and whose float32 gradient is rounding noise);
- after two steps, the elements of the tested quantity (moments, or
  parameters but the key bias) that part past the test's own limit:
  one thread against eight, and each against float64.

Where one thread and eight part past the limit, the limit is tighter than
the float32 rounding of the same code, whatever the other framework does.
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def gpt_case(torch):
    """The imperative loop: a 1-layer tiny GPT, ``AdamW(1e-3,
    weight_decay=0.01)``, ``loss.backward(); minimize``; returns the first
    step's gradients and the optimizer's moments after two steps."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.text.models import gpt as tgpt
    torch.manual_seed(2)
    sd = tgpt.GPTForCausalLM(tgpt.gpt_tiny(num_layers=1),
                             device="cpu").state_dict()
    ids = np.random.default_rng(0).integers(0, 1024, (2, 16))
    labels = np.roll(ids, -1, axis=1)

    def run(dtype):
        tm = tgpt.GPTForCausalLM(tgpt.gpt_tiny(num_layers=1), device="cpu")
        tm.load_state_dict(sd)
        tm.to(dtype)
        opt = topt.AdamW(1e-3, weight_decay=0.01,
                         parameters=tm.named_parameters())
        first = None
        for _ in range(2):
            loss = tm(torch.from_numpy(ids), torch.from_numpy(labels))
            loss.backward()
            if first is None:
                first = {n: p.grad.double().numpy().copy()
                         for n, p in tm.named_parameters()}
            opt.minimize(loss)
            opt.clear_gradients()
        tested = {k: v.double().numpy() for k, v in opt.state_dict().items()
                  if k.endswith("@moment1") or k.endswith("@moment2")}
        return first, tested
    return run, (1e-5, 1e-7)         # the test's rtol, atol


def ernie_case(torch):
    """The one-stage ERNIE pipeline with ``recompute_interval=1``:
    ``make_pipeline_train_step(n_microbatch=2)``, ``AdamW(1e-3)``; returns
    the first step's gradients and the parameters after two steps."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.distributed import make_pipeline_train_step
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        PipelineLayer
    from paddle_tpu_torch.nn.functional import cross_entropy
    from paddle_tpu_torch.text.models import ernie as ternie
    tiny = dict(num_heads=2, hidden_dropout=0.0, attention_dropout=0.0)

    def loss_fn(logits, labels):
        return cross_entropy(logits.float(), labels, reduction="none").mean()

    def build():
        return PipelineLayer(ternie.ernie_pipeline_descs(
            ternie.ernie_tiny(**tiny), device="cpu"), num_stages=1,
            loss_fn=loss_fn, recompute_interval=1)
    torch.manual_seed(13)
    sd = build().state_dict()
    rng = np.random.default_rng(4)          # test_torch_ernie.py's batch
    ids = rng.integers(0, 1024, (2, 128))
    labels = rng.integers(0, 1024, (2, 128))
    labels[rng.random((2, 128)) < 0.5] = -100
    labels = np.where(labels < 0, 0, labels)

    def run(dtype):
        tp = build()
        tp.load_state_dict(sd)
        tp.to(dtype)
        opt = topt.AdamW(learning_rate=1e-3)
        step = make_pipeline_train_step(tp, opt, n_microbatch=2)
        params = dict(tp.named_parameters())
        state = opt.init(params)
        grads = torch.autograd.grad(
            loss_fn(tp(torch.from_numpy(ids)), torch.from_numpy(labels)),
            list(params.values()), allow_unused=True)
        first = {n: g.double().numpy() for n, g in zip(params, grads)
                 if g is not None}
        for _ in range(2):
            params, state, _ = step(params, state, torch.from_numpy(ids),
                                    torch.from_numpy(labels), 1e-3)
        tested = {n: p.detach().double().numpy() for n, p in params.items()
                  if not n.endswith("k_proj.bias")}
        return first, tested
    return run, (0.0, 1e-5)


def past(a, b, rtol, atol):
    """Elements of ``a`` past ``b``'s limit, and the worst excess."""
    n, worst = 0, 0.0
    for k in b:
        d = np.abs(a[k] - b[k])
        lim = atol + rtol * np.abs(b[k])
        n += int((d > lim).sum())
        worst = max(worst, float(d.max()))
    return n, worst


def main():
    import torch
    for name, case in (("gpt_imperative_adamw", gpt_case),
                       ("ernie_pipeline_recompute", ernie_case)):
        run, (rtol, atol) = case(torch)
        out = {}
        for label, threads, dtype in (("f32_1t", 1, torch.float32),
                                      ("f32_8t", 8, torch.float32),
                                      ("f64", 1, torch.float64)):
            torch.set_num_threads(threads)
            out[label] = run(dtype)
        g64 = out["f64"][0]
        for label in ("f32_1t", "f32_8t"):
            g = out[label][0]
            worst = max(((float(np.abs(g[n] - g64[n]).max()
                                / max(np.abs(g64[n]).max(), 1e-30)), n)
                         for n in g64 if not n.endswith("k_proj.bias")))
            print(f"{name}: first-step gradients {label} vs f64: worst "
                  f"{worst[0]:.3g} of the tensor's largest ({worst[1]})")
        for a, b in (("f32_1t", "f32_8t"), ("f32_1t", "f64"),
                     ("f32_8t", "f64")):
            n, worst = past(out[a][1], out[b][1], rtol, atol)
            print(f"{name}: after two steps {a} vs {b}: {n} element(s) "
                  f"past rtol {rtol:g} atol {atol:g}; largest |diff| "
                  f"{worst:.3g}", flush=True)


if __name__ == "__main__":
    main()
