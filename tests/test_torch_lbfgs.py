"""Port parity: LBFGS (``paddle_tpu_torch.optimizer.LBFGS``) against the
JAX package's ``paddle_tpu.optimizer.LBFGS``.

Both sides take 10 steps on a quadratic, each computing its gradient from
its own parameters (``g = A p - b`` per parameter, float32, A symmetric
positive definite), with a history of 3 pairs, so the history fills, rolls
and feeds gamma. Every state key is compared after every step. The two
loops sum in the same order on both sides; the dot products' own
summation order is XLA's or torch's, and ten steps of a recursion carry
that: rtol 1e-4 on float32 state and parameters, with an absolute 1e-5
since ``s`` and ``y`` are differences of parameters and gradients of size
1-10 whose few-ulp errors do not shrink with the difference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import optimizer as jopt
from paddle_tpu_torch import optimizer as topt

SHAPES = {"w": (6, 4), "b": (4,)}
KEYS = {"s_hist", "y_hist", "rho_hist", "prev_flat_p", "prev_flat_g",
        "n_hist"}


def _problem(seed=0):
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in SHAPES.items():
        n = int(np.prod(shape))
        m = rng.standard_normal((n, n)).astype(np.float32)
        a = (m @ m.T / n + np.eye(n, dtype=np.float32)).astype(np.float32)
        out[name] = (a, rng.standard_normal(n).astype(np.float32),
                     rng.standard_normal(shape).astype(np.float32))
    return out


def _run(dtype, weight_decay, steps=10):
    """With ``dtype="bf16"`` the port's parameters are bf16 with float32
    masters, and JAX's LBFGS runs in float32 from the same bf16 values on
    the port's gradients: JAX's LBFGS returns a state without the master
    after its first update (its ``_update`` builds a new dict), so its bf16
    parameters go on from their bf16 values, while the port keeps the
    master, as its other optimizers do. The port's masters are held
    against JAX's float32 parameters."""
    prob = _problem()
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    kw = dict(learning_rate=0.5, history_size=3, weight_decay=weight_decay)
    jo, to = jopt.LBFGS(**kw), topt.LBFGS(**kw)
    tp = {n: torch.from_numpy(p0).to(tdt) for n, (_, _, p0) in prob.items()}
    jp = {n: jnp.asarray(p.float().numpy()) for n, p in tp.items()}
    js, ts = jo.init(jp), to.init(tp)
    japply = jax.jit(jo.apply_gradients)   # eager, each scan would retrace
    history = []
    for _ in range(steps):
        tg = {n: (torch.from_numpy(a) @ tp[n].float().reshape(-1)
                  - torch.from_numpy(b)).reshape(SHAPES[n]).to(tdt)
              for n, (a, b, _) in prob.items()}
        if dtype == "bf16":
            jg = {n: jnp.asarray(g.float().numpy()) for n, g in tg.items()}
        else:
            jg = {n: (jnp.asarray(a) @ jp[n].reshape(-1) - jnp.asarray(b)
                      ).reshape(SHAPES[n]) for n, (a, b, _) in prob.items()}
        jp, js = japply(jp, jg, js)
        to.apply_gradients(tp, tg, ts)
        history.append((jax.tree_util.tree_map(np.asarray, js),
                        {n: np.asarray(p) for n, p in jp.items()},
                        {n: {k: v.clone() for k, v in st.items()}
                         for n, st in ts["param_states"].items()},
                        {n: p.float().clone() for n, p in tp.items()},
                        int(ts["step"])))
    return history


@pytest.mark.parametrize("dtype,weight_decay",
                         [("f32", 0.0), ("f32", 0.01), ("bf16", 0.0)])
def test_lbfgs_matches_jax_every_state_key(dtype, weight_decay):
    """Ten steps, every state key, every parameter, after every step; in
    bf16 the port's float32 masters against JAX's float32 parameters, and
    the bf16 parameters within one bf16 ulp of them."""
    for step, (js, jp, ts, tp, tstep) in enumerate(_run(dtype, weight_decay),
                                                   start=1):
        assert tstep == int(js["step"]) == step
        for name in SHAPES:
            jst = js["param_states"][name]
            assert set(jst) == KEYS
            assert set(ts[name]) == KEYS | (
                {"master"} if dtype == "bf16" else set()), name
            for key in KEYS:
                got, want = ts[name][key], jst[key]
                if key == "n_hist":
                    assert got.dtype == torch.int32
                    assert int(got) == int(want) == min(max(step - 1, 0), 3)
                    continue
                assert got.dtype == torch.float32
                np.testing.assert_allclose(
                    got.numpy(), want, rtol=1e-4, atol=1e-5,
                    err_msg=f"step {step} {name}/{key}")
            if dtype == "bf16":
                np.testing.assert_allclose(
                    ts[name]["master"].numpy(), jp[name], rtol=1e-4,
                    atol=1e-5, err_msg=f"step {step} {name}/master")
                np.testing.assert_allclose(tp[name].numpy(), jp[name],
                                           rtol=2 ** -8, atol=1e-5)
            else:
                np.testing.assert_allclose(
                    tp[name].numpy(), jp[name], rtol=1e-4, atol=1e-5,
                    err_msg=f"step {step} {name}")


def test_lbfgs_history_fills_rolls_and_converges():
    """The newest pair sits in the last slot: after 5 steps of history 3,
    rho_hist holds steps 3-5's pairs, none of them empty; the quadratic's
    gradient norm falls."""
    hist = _run("f32", 0.0)
    ts = hist[4][2]["w"]
    assert torch.all(ts["rho_hist"] > 0)
    prob = _problem()
    a, b, _ = prob["w"]
    gnorm = [np.linalg.norm(a @ h[3]["w"].numpy().reshape(-1) - b)
             for h in hist]
    assert gnorm[-1] < 0.1 * gnorm[0]


def test_lbfgs_refuses_strong_wolfe_and_steps_imperatively():
    with pytest.raises(NotImplementedError):
        topt.LBFGS(line_search_fn="strong_wolfe")
    w = torch.nn.Parameter(torch.ones(3))
    opt = topt.LBFGS(0.1, parameters=[w], history_size=2)
    for _ in range(3):
        (w * w).sum().backward()
        opt.step()
        opt.clear_grad()
    st = opt.state_dict()
    assert set(k.split("@")[1] for k in st if "@" in k) == KEYS
    assert int(st["0@n_hist"]) == 2
    assert torch.all(w < 1)
