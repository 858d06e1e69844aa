"""Port parity: the training slice — loss, gradients, optimizers, clipping,
schedulers, AMP-O2 and the train step — against the JAX package.

Weights go from the JAX model to the port through
``convert.from_jax_state_dict`` (Linear weights transposed), optimizer
state through ``convert.from_jax_optimizer_state``; inputs, labels and
gradients are made with numpy from a seed and handed to both sides.
Each comparison states its tolerance and why.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import optimizer as jopt
from paddle_tpu.framework.functional import functional_call, get_params
from paddle_tpu.nn import functional as JF
from paddle_tpu.nn.clip import ClipGradByGlobalNorm as JaxClip
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu.text.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.text.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch import amp
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.convert import (from_jax_optimizer_state,
                                      from_jax_state_dict, to_jax_state_dict)
from paddle_tpu_torch.framework import TrainStep, make_sharded_train_step
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import lr as tlr
from paddle_tpu_torch.text.models.gpt import GPTForCausalLM, gpt_tiny

VARIANTS = {"mha": {}, "gqa": {"num_kv_heads": 2}}
SEQ = 32


def carried_pair(seed=11, **over):
    """(JAX model, port model with the JAX weights), f32 on the CPU."""
    paddle.seed(seed)
    jm = JaxGPT(jax_gpt_tiny(**over))
    tm = GPTForCausalLM(gpt_tiny(**over), device="cpu")
    jsd = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    tm.load_state_dict(from_jax_state_dict(jsd), strict=True)
    return jm, tm


def ids_labels(b, s, vocab=1024, seed=0, ignore=False):
    """bench.py's batches: random ids, labels = ids shifted by one; with
    ``ignore`` some labels are -100."""
    ids = np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)
    labels = np.roll(ids, -1, axis=1)
    if ignore:
        labels[0, :5] = -100
        labels[-1, -3:] = -100
    return ids, labels


# -- loss --------------------------------------------------------------------

@pytest.mark.parametrize("reduction", ["none", "sum", "mean"])
def test_cross_entropy_matches_jax(reduction):
    """f32 log-softmax on both sides: atol 1e-5."""
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 7, 50)).astype(np.float32) * 3
    labels = rng.integers(0, 50, (3, 7))
    labels[1, 2:5] = -100
    want = JF.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                            reduction=reduction)
    got = TF.cross_entropy(torch.from_numpy(logits),
                           torch.from_numpy(labels), reduction=reduction)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # a trailing label axis of 1 is squeezed, as in the JAX function
    got1 = TF.cross_entropy(torch.from_numpy(logits),
                            torch.from_numpy(labels[..., None]),
                            reduction=reduction)
    np.testing.assert_array_equal(got1.numpy(), got.numpy())
    with pytest.raises(NotImplementedError):
        TF.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                         label_smoothing=0.1)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_gpt_loss_matches_jax_and_counts_ignored_positions(variant):
    """GPT's loss is the plain mean of the per-token losses, ignored
    positions included in the divisor (``gpt.py:351-352``) — not the
    ignore-aware mean of ``cross_entropy(reduction="mean")``. f32, two
    layers: atol 1e-5."""
    jm, tm = carried_pair(**VARIANTS[variant])
    ids, labels = ids_labels(2, SEQ, ignore=True)
    want = float(jm(jnp.asarray(ids), jnp.asarray(labels)))
    tids, tlab = torch.from_numpy(ids).long(), torch.from_numpy(labels).long()
    with torch.no_grad():
        got = float(tm(tids, tlab))
        per_token = TF.cross_entropy(tm(tids), tlab, reduction="none")
        ignore_aware = float(TF.cross_entropy(tm(tids), tlab))
    assert abs(got - want) <= 1e-5
    n_all, n_valid = labels.size, int((labels != -100).sum())
    assert n_valid < n_all
    assert abs(got - float(per_token.sum()) / n_all) <= 1e-6
    assert abs(ignore_aware - float(per_token.sum()) / n_valid) <= 1e-6
    assert abs(got - ignore_aware) > 1e-2


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_gpt_grads_match_jax(variant):
    """Every parameter's gradient (Linear weights compared in the JAX
    ``[in, out]`` layout) against ``jax.grad`` of ``functional_call``.
    f32 sums in another order through two layers: atol 2e-6 on gradients
    of about 1e-3..1e-1."""
    jm, tm = carried_pair(**VARIANTS[variant])
    ids, labels = ids_labels(2, SEQ, seed=1, ignore=True)

    def loss(p):
        return functional_call(jm, p, jnp.asarray(ids), jnp.asarray(labels),
                               training=True)

    want = jax.grad(loss)(get_params(jm))
    tm.train()
    tm(torch.from_numpy(ids).long(), torch.from_numpy(labels).long()
       ).backward()
    got = to_jax_state_dict({n: p.grad for n, p in tm.named_parameters()})
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g, np.asarray(want[name]), atol=2e-6,
                                   err_msg=name)


def test_gpt_training_options_not_ported_raise_in_training_mode():
    """Every training option of the JAX config now trains: hidden and
    attention dropout (the loss moves off the eval loss; eval mode needs
    neither), and recompute, whose loss and gradients are those of the
    same model without it (no dropout here: exactly equal)."""
    ids = torch.arange(8, dtype=torch.long)[None].repeat(2, 1)
    for over in ({"hidden_dropout": 0.1}, {"attention_dropout": 0.1}):
        tm = GPTForCausalLM(gpt_tiny(num_layers=1, **over), device="cpu")
        loss = tm(ids, ids)
        assert torch.isfinite(loss)
        tm.eval()
        assert float(tm(ids, ids)) != float(loss), over
    runs = []
    for recompute in (True, False):
        tm = GPTForCausalLM(gpt_tiny(num_layers=1, recompute=recompute),
                            device="cpu")
        loss = tm(ids, ids)
        loss.backward()
        runs.append((loss.detach(), [p.grad for p in tm.parameters()]))
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    tm.eval()
    assert torch.isfinite(tm(ids, ids))


# -- optimizers ----------------------------------------------------------------

def _opts(name, multi_precision, clip):
    """The same optimizer from both packages."""
    kw = dict(multi_precision=multi_precision)
    if clip:
        kw["grad_clip"] = "clip"
    made = []
    for mod, clip_cls in ((jopt, JaxClip), (topt, ClipGradByGlobalNorm)):
        k = dict(kw)
        if clip:
            k["grad_clip"] = clip_cls(0.5)
        if name == "sgd":
            made.append(mod.SGD(0.1, weight_decay=0.01, **k))
        elif name == "momentum":
            made.append(mod.Momentum(0.05, momentum=0.9, use_nesterov=True,
                                     weight_decay=0.01, **k))
        elif name == "adam":
            made.append(mod.Adam(1e-2, weight_decay=0.01, **k))
        elif name == "adagrad":
            made.append(mod.Adagrad(0.05, weight_decay=0.01,
                                    initial_accumulator_value=0.1, **k))
        elif name == "rmsprop":
            made.append(mod.RMSProp(0.01, momentum=0.9, centered=True,
                                    weight_decay=0.01, **k))
        elif name == "lamb":
            made.append(mod.Lamb(1e-2, lamb_weight_decay=0.01,
                                 exclude_from_weight_decay_fn=lambda n:
                                 n == "ln.bias", **k))
        elif name == "lars":
            made.append(mod.Lars(0.1, momentum=0.9, lars_coeff=0.01,
                                 exclude_from_weight_decay=("bias",), **k))
        elif name == "adamax":
            made.append(mod.Adamax(1e-2, weight_decay=0.01, **k))
        elif name == "adadelta":
            made.append(mod.Adadelta(1.0, weight_decay=0.01, **k))
        else:
            made.append(mod.AdamW(
                1e-2, weight_decay=0.1,
                apply_decay_param_fun=lambda n: n != "ln.bias", **k))
    return made


SHAPES = {"dense.weight": (8, 6), "dense.bias": (6,), "ln.weight": (6,),
          "ln.bias": (6,)}


def _assert_state_close(port_state, jax_state, rtol, skip=()):
    conv = from_jax_optimizer_state(
        jax.tree_util.tree_map(np.asarray, jax_state))
    assert int(port_state["step"]) == int(conv["step"])
    assert set(port_state["param_states"]) == set(conv["param_states"])
    for name, st in conv["param_states"].items():
        assert set(port_state["param_states"][name]) - set(skip) == set(st), \
            name
        for key, want in st.items():
            got = port_state["param_states"][name][key]
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=rtol,
                                       atol=1e-7, err_msg=f"{name}/{key}")


@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("dtype,multi_precision",
                         [("f32", False), ("bf16", True), ("bf16", False)])
@pytest.mark.parametrize("name", ["sgd", "momentum", "adam", "adamw",
                                  "adagrad", "rmsprop", "lamb", "lars",
                                  "adamax", "adadelta"])
def test_optimizer_matches_jax_apply_gradients(name, dtype, multi_precision,
                                               clip):
    """Four steps on numpy-made gradients, state leaf by leaf. f32
    elementwise math on both sides; XLA and torch may round a power or a
    fused multiply-add 1 ulp apart, so rtol 1e-5 on the float32 state.
    bf16 parameters are the float32 result rounded, where 1 ulp of f32
    can flip a bf16 rounding: rtol 1e-2 (bf16 has 8 bits).

    JAX's Adamax and Adadelta return a state without the float32 master
    after their first update, so a bf16 parameter with masters goes on from
    its bf16 value there; the port keeps the master, as its other
    optimizers do. Those two cases hold the port's masters against JAX on
    float32 parameters that start from the bf16 values and take the bf16
    gradients (what the masters see: with the clip, the bf16 gradients
    clipped by JAX's clip in bf16), at the same tolerances."""
    jax_opt, port_opt = _opts(name, multi_precision, clip)
    rng = np.random.default_rng(3)
    init = {n: rng.standard_normal(s).astype(np.float32)
            for n, s in SHAPES.items()}
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    with_master = dtype == "bf16" and multi_precision
    on_masters = with_master and name in ("adamax", "adadelta")
    jax_clip = None
    if on_masters:
        jdt = jnp.float32
        init = {n: torch.from_numpy(a).to(tdt).float().numpy()
                for n, a in init.items()}
        jax_clip, jax_opt.grad_clip = jax_opt.grad_clip, None
    jparams = {n: jnp.asarray(a, jdt) for n, a in init.items()}
    tparams = {n: torch.from_numpy(a).to(tdt) for n, a in init.items()}
    jstate = jax_opt.init(jparams)
    tstate = port_opt.init(tparams)
    assert ("master" in tstate["param_states"]["dense.weight"]) == \
        with_master
    for step in range(4):
        grads = {n: rng.standard_normal(s).astype(np.float32) * 2
                 for n, s in SHAPES.items()}
        tgrads = {n: torch.from_numpy(g).to(tdt) for n, g in grads.items()}
        jgrads = {n: jnp.asarray(g.float().numpy(), jdt)
                  for n, g in tgrads.items()}
        if jax_clip is not None:
            jgrads = {n: g.astype(jnp.float32) for n, g in jax_clip(
                {n: g.astype(jnp.bfloat16) for n, g in jgrads.items()}
            ).items()}
        jparams, jstate = jax_opt.apply_gradients(jparams, jgrads, jstate)
        out, tstate = port_opt.apply_gradients(tparams, tgrads, tstate)
        assert out is tparams
        _assert_state_close(tstate, jstate, rtol=1e-5,
                            skip=("master",) if on_masters else ())
        for n, p in tparams.items():
            assert p.dtype == tdt
            want = np.asarray(jparams[n].astype(jnp.float32))
            if on_masters:
                np.testing.assert_allclose(
                    tstate["param_states"][n]["master"].numpy(), want,
                    rtol=1e-5, atol=1e-7, err_msg=f"step {step} {n}")
            np.testing.assert_allclose(
                p.float().numpy(), want,
                rtol=1e-2 if dtype == "bf16" else 1e-5, atol=1e-6,
                err_msg=f"step {step} {n}")


def test_from_jax_optimizer_state_continues_a_jax_run():
    """AdamW on the GPT's parameters: three steps in JAX, then the params
    and state carried into the port, two more steps on both sides. Moments
    of Linear weights are transposed with the weights. f32: rtol 1e-5."""
    paddle.seed(2)
    jm = JaxGPT(jax_gpt_tiny(num_layers=1, num_kv_heads=2))
    jparams = get_params(jm)
    rng = np.random.default_rng(4)

    def grads():
        return {n: rng.standard_normal(p.shape).astype(np.float32) * 1e-2
                for n, p in jparams.items()}

    jax_opt = jopt.AdamW(1e-3, weight_decay=0.01)
    jstate = jax_opt.init(jparams)
    for _ in range(3):
        jparams, jstate = jax_opt.apply_gradients(
            jparams, {n: jnp.asarray(g) for n, g in grads().items()}, jstate)
    tparams = from_jax_state_dict({n: np.asarray(p)
                                   for n, p in jparams.items()})
    tstate = from_jax_optimizer_state(
        jax.tree_util.tree_map(np.asarray, jstate))
    port_opt = topt.AdamW(1e-3, weight_decay=0.01)
    for _ in range(2):
        g = grads()
        jparams, jstate = jax_opt.apply_gradients(
            jparams, {n: jnp.asarray(a) for n, a in g.items()}, jstate)
        port_opt.apply_gradients(tparams, from_jax_state_dict(g), tstate)
    _assert_state_close(tstate, jstate, rtol=1e-5)
    got = to_jax_state_dict(tparams)
    for n, p in jparams.items():
        np.testing.assert_allclose(got[n], np.asarray(p), rtol=1e-5,
                                   atol=1e-7, err_msg=n)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_clip_grad_by_global_norm_matches_jax(dtype):
    """The norm in f32 over all gradients, each scaled and cast back:
    atol 1e-6 in f32; bf16 results are the same f32 product rounded."""
    rng = np.random.default_rng(6)
    grads = {n: rng.standard_normal(s).astype(np.float32)
             for n, s in SHAPES.items()}
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    want = JaxClip(1.0)({n: jnp.asarray(g, jdt) for n, g in grads.items()})
    got = ClipGradByGlobalNorm(1.0)({n: torch.from_numpy(g).to(tdt)
                                     for n, g in grads.items()})
    for n in grads:
        assert got[n].dtype == tdt
        np.testing.assert_allclose(
            got[n].float().numpy(), np.asarray(want[n].astype(jnp.float32)),
            atol=1e-6 if dtype == "f32" else 1e-2)
    # under the limit nothing changes
    small = ClipGradByGlobalNorm(1e6)({"a": torch.ones(3)})
    assert torch.equal(small["a"], torch.ones(3))


SCHEDULERS = {
    "noam": lambda m: m.NoamDecay(d_model=64, warmup_steps=5),
    "piecewise": lambda m: m.PiecewiseDecay([3, 8], [0.1, 0.05, 0.01]),
    "natural_exp": lambda m: m.NaturalExpDecay(0.1, gamma=0.2),
    "exponential": lambda m: m.ExponentialDecay(0.1, gamma=0.9),
    "inverse_time": lambda m: m.InverseTimeDecay(0.1, gamma=0.5),
    "polynomial": lambda m: m.PolynomialDecay(0.1, decay_steps=10,
                                              end_lr=0.001, power=2.0),
    "polynomial_cycle": lambda m: m.PolynomialDecay(0.1, decay_steps=7,
                                                    cycle=True),
    "linear_warmup": lambda m: m.LinearWarmup(
        m.CosineAnnealingDecay(0.1, T_max=10), warmup_steps=4,
        start_lr=0.0, end_lr=0.1),
    "step": lambda m: m.StepDecay(0.1, step_size=3, gamma=0.5),
    "multistep": lambda m: m.MultiStepDecay(0.1, milestones=[2, 5, 9]),
    "lambda": lambda m: m.LambdaDecay(0.1, lambda s: 0.95 ** s),
    "cosine": lambda m: m.CosineAnnealingDecay(0.1, T_max=7, eta_min=0.01),
    "onecycle": lambda m: m.OneCycleLR(0.1, total_steps=20),
    "onecycle_linear": lambda m: m.OneCycleLR(0.1, total_steps=20,
                                              anneal_strategy="linear"),
}


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_lr_scheduler_matches_jax(name):
    """The port's copy of the schedulers gives the JAX values exactly, as
    a pure function of the step and as a stepped object."""
    js, ts = SCHEDULERS[name](jlr), SCHEDULERS[name](tlr)
    assert [ts.value_at(s) for s in range(30)] == \
        [js.value_at(s) for s in range(30)]
    for _ in range(12):
        assert ts.get_lr() == js.get_lr()
        ts.step()
        js.step()
    assert ts.state_dict() == js.state_dict()


def test_reduce_on_plateau_matches_jax():
    js = jlr.ReduceOnPlateau(0.1, patience=1, cooldown=1)
    ts = tlr.ReduceOnPlateau(0.1, patience=1, cooldown=1)
    for metric in [1.0, 0.9, 0.95, 0.97, 0.99, 0.5, 0.6, 0.7, 0.8]:
        js.step(metric)
        ts.step(metric)
        assert ts.get_lr() == js.get_lr()


def test_amp_decorate_o2_casts_and_sets_master_weights():
    tm = GPTForCausalLM(gpt_tiny(num_layers=1), device="cpu")
    opt = topt.AdamW(1e-3, multi_precision=False)
    out_m, out_o = amp.decorate(tm, opt, level="O2", master_weight=True)
    assert out_m is tm and out_o is opt and opt.multi_precision
    assert {p.dtype for p in tm.parameters()} == {torch.bfloat16}
    # O1 casts no parameter (auto_cast casts per call) and trains
    o1 = GPTForCausalLM(gpt_tiny(num_layers=1), device="cpu")
    assert amp.decorate([o1], level="O1") == [o1]
    assert {p.dtype for p in o1.parameters()} == {torch.float32}
    ids = torch.arange(8, dtype=torch.long)[None].repeat(2, 1)
    with amp.auto_cast(level="O1"):
        loss = o1(ids, ids)
    loss.backward()
    assert torch.isfinite(loss)
    assert all(p.grad.dtype == torch.float32 for p in o1.parameters())


# -- the train step ------------------------------------------------------------

def jax_train_loop(jm, batches, steps, lr):
    """bench.py's GPT step (``:1394-1401``): value_and_grad of the
    functional loss, then AdamW.apply_gradients, one jitted step."""
    opt = jopt.AdamW(learning_rate=lr, weight_decay=0.01,
                     multi_precision=True)
    params = get_params(jm)
    state = opt.init(params)

    def loss_fn(p, ids, labels):
        return functional_call(jm, p, ids, labels, training=True)

    @jax.jit
    def one_step(p, st, ids, labels):
        loss, grads = jax.value_and_grad(loss_fn)(p, ids, labels)
        p, st = opt.apply_gradients(p, grads, st, lr)
        return loss, p, st

    losses = []
    for i in range(steps):
        ids, labels = batches[i % len(batches)]
        loss, params, state = one_step(params, state, jnp.asarray(ids),
                                       jnp.asarray(labels))
        losses.append(float(loss))
    return losses, params


def gpt_loss(model, batch):
    ids, labels = batch
    return model(ids, labels)


@pytest.mark.parametrize("precision", ["f32", "o2"])
def test_train_step_loss_curve_matches_jax_loop(precision):
    """Ten steps of gpt_tiny under AdamW (lr 1e-3, so that the curve moves)
    on four distinct batches cycled, as bench.py feeds them, against the
    JAX loop on the same weights. f32: losses within 1e-4. AMP-O2 (bf16
    weights and activations, f32 masters): the two frameworks round bf16
    products at other points, so within 2e-2 on losses near 6.9."""
    jm, tm = carried_pair(seed=3)
    batches = [ids_labels(2, SEQ, seed=10 + i) for i in range(4)]
    opt = topt.AdamW(learning_rate=1e-3, weight_decay=0.01,
                     multi_precision=True)
    if precision == "o2":
        jm.astype(paddle.bfloat16)
        tm, opt = amp.decorate(tm, opt, level="O2")
    want, jparams = jax_train_loop(jm, batches, 10, 1e-3)
    step = make_sharded_train_step(tm, opt, gpt_loss)
    got = [float(step.step(batches[i % 4])) for i in range(10)]
    tol = 1e-4 if precision == "f32" else 2e-2
    np.testing.assert_allclose(got, want, atol=tol)
    assert got[-1] < got[0] - 0.1
    assert step.step_count == 10 and int(step.opt_state["step"]) == 10
    if precision == "f32":
        # Adam's normalised step turns a rounding difference in a
        # near-zero gradient into a step of another size or sign (at most
        # lr = 1e-3 a step) on that coordinate; the key part of qkv_proj's
        # bias has a gradient of exactly 0 but for rounding noise. So:
        # every coordinate within two steps' worth, and 99.9% of them
        # within 1e-5
        final = to_jax_state_dict(step.params)
        diff = np.concatenate([np.abs(final[n] - np.asarray(p)).ravel()
                               for n, p in jparams.items()])
        assert diff.max() <= 2e-3
        assert np.mean(diff <= 1e-5) >= 0.999


def test_train_step_state_dict_round_trip():
    """Five steps, ``state_dict``, a fresh TrainStep (other weights, fresh
    optimizer and scheduler) loaded from it: steps 6-10 equal the
    uninterrupted run's exactly."""
    batches = [ids_labels(2, 16, vocab=256, seed=20 + i) for i in range(3)]
    cfg = gpt_tiny(vocab_size=256, num_layers=1)

    def make(seed):
        sched = tlr.StepDecay(2e-3, step_size=3, gamma=0.5)
        return TrainStep(GPTForCausalLM(cfg, device="cpu", seed=seed),
                         topt.AdamW(sched, weight_decay=0.01), gpt_loss)

    full = make(0)
    want = [float(full.step(batches[i % 3])) for i in range(10)]
    first = make(0)
    for i in range(5):
        first.step(batches[i % 3])
    sd = first.state_dict()
    resumed = make(1)
    resumed.load_state_dict(sd)
    assert resumed.step_count == 5
    got = [float(resumed.step(batches[i % 3])) for i in range(5, 10)]
    assert got == want[5:]
    for n, p in full.params.items():
        assert torch.equal(p, resumed.params[n]), n
    assert resumed.optimizer.get_lr() == full.optimizer.get_lr()


def test_train_step_refuses_a_mesh_and_pins_the_index():
    tm = GPTForCausalLM(gpt_tiny(num_layers=1), device="cpu")
    with pytest.raises(NotImplementedError, match="one device"):
        make_sharded_train_step(tm, topt.SGD(0.1), gpt_loss, mesh="dp")
    step = make_sharded_train_step(tm, topt.SGD(0.1), gpt_loss)
    step.step(ids_labels(1, 8), index=41)
    step.step(ids_labels(1, 8))
    assert step.step_count == 42
