"""Port parity: the ERNIE pretraining slice — ``ErnieForPretraining``, the
pipeline form ``PipelineLayer(ernie_pipeline_descs(cfg))``, weight
conversion and ``make_pipeline_train_step`` at one stage — against the JAX
package.

The model is ``ernie_tiny(num_heads=2)``: hidden 128 in 2 heads of 64, so
attention takes the K4 route (its plain versions on the CPU); ``ernie_tiny``'s
own 4 heads of 32 never reach K4. At S = 128 K4 runs its direct forms; at
S = 1024 (B = 1, 2 layers, 1024 positions) the JAX package's tiles stream,
and so does the port: the streamed forward, dq and dk/dv, held end to end.
Weights go from the JAX model to the port through
``convert.from_jax_state_dict``; inputs and labels are made with numpy from
a seed and handed to both sides. The JAX side runs on the CPU, where its
attention takes the dense path. Each comparison states its tolerance and
why.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import optimizer as jopt
from paddle_tpu.distributed.fleet.meta_parallel.pp_layers import \
    PipelineLayer as JaxPipelineLayer
from paddle_tpu.distributed.pipeline_schedule import \
    make_pipeline_train_step as jax_make_pipeline_train_step
from paddle_tpu.framework.functional import functional_call, get_params
from paddle_tpu.nn import functional as JF
from paddle_tpu.text.models import ernie as jernie
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.convert import (LINEAR_NAMES, from_jax_state_dict,
                                      to_jax_state_dict)
from paddle_tpu_torch.distributed import make_pipeline_train_step
from paddle_tpu_torch.distributed.fleet.meta_parallel import (
    LayerDesc, PipelineLayer, SharedLayerDesc)
from paddle_tpu_torch.nn.functional import cross_entropy
from paddle_tpu_torch.text.models import ernie as ternie

hfp = importlib.import_module(
    "paddle_tpu_torch.ops._hopper.flash_attention_packed")

B, S, VOCAB = 2, 128, 1024     # B != S: a [B, S] mask is a key mask
TINY = dict(num_heads=2, hidden_dropout=0.0, attention_dropout=0.0)
STREAMED = ["flash_packed_fwd_stream", "flash_packed_bwd_dq",
            "flash_packed_bwd_dkv"]


def carried_pair(seed=7, **over):
    """(JAX ErnieForPretraining, the port's with the JAX weights), f32 on
    the CPU."""
    paddle.seed(seed)
    kw = {**TINY, **over}
    jm = jernie.ErnieForPretraining(jernie.ernie_tiny(**kw))
    tm = ternie.ErnieForPretraining(ternie.ernie_tiny(**kw), device="cpu")
    jsd = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    tm.load_state_dict(from_jax_state_dict(jsd), strict=True)
    return jm, tm


def jax_loss_fn(logits, labels):
    """bench.py's loss (``:779-781``)."""
    return jnp.mean(JF.cross_entropy(logits.astype(jnp.float32), labels,
                                     reduction="none"))


def port_loss_fn(logits, labels):
    return cross_entropy(logits.float(), labels, reduction="none").mean()


def carried_pipelines(seed=11, **over):
    """(JAX PipelineLayer, the port's with the JAX weights), one stage."""
    paddle.seed(seed)
    kw = {**TINY, **over}
    jp = JaxPipelineLayer(jernie.ernie_pipeline_descs(jernie.ernie_tiny(
        **kw)), num_stages=1, loss_fn=jax_loss_fn)
    tp = PipelineLayer(ternie.ernie_pipeline_descs(ternie.ernie_tiny(**kw),
                                                   device="cpu"),
                       num_stages=1, loss_fn=port_loss_fn)
    jsd = {k: np.asarray(v) for k, v in jp.state_dict().items()}
    tp.load_state_dict(from_jax_state_dict(jsd), strict=True)
    return jp, tp


def batch(b=B, s=S, seed=0, masked=False):
    """ids, the attention mask (or None), MLM labels over about half the
    positions (-100 elsewhere and at the pads) and SOP labels."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, VOCAB, (b, s)).astype(np.int32)
    labels = rng.integers(0, VOCAB, (b, s)).astype(np.int32)
    labels[rng.random((b, s)) < 0.5] = -100
    att = None
    if masked:
        lengths = rng.integers(s // 4, s + 1, b)
        att = (np.arange(s)[None, :] < lengths[:, None]).astype(np.int32)
        labels = np.where(att == 1, labels, -100).astype(np.int32)
    sop = rng.integers(0, 2, (b, 1)).astype(np.int32)
    return ids, att, labels, sop


def _j(x):
    return None if x is None else jnp.asarray(x)


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _close_grads(got, want, scale=1e-4):
    """Every gradient within ``scale``·max|ref| (plus 1e-9) of JAX's. The
    key projection's bias has a true gradient of 0 (softmax ignores a
    constant added to all of a row's scores), so both sides hold rounding
    noise there: it is held on the scale of the key weight's gradient."""
    assert set(got) == set(want)
    for name, g in got.items():
        w = np.asarray(want[name])
        ref = np.asarray(want[name[:-4] + "weight"]) \
            if name.endswith("k_proj.bias") else w
        np.testing.assert_allclose(
            g, w, atol=scale * float(np.abs(ref).max()) + 1e-9, rtol=0,
            err_msg=name)


# -- conversion ---------------------------------------------------------------

def test_pretraining_state_dict_keys_match_jax_and_convert():
    """The port's keys are the JAX model's (``mlm_bias`` and the task-type
    table included); a strict load passes; every Linear weight, the SOP
    head's too, is transposed and the embeddings are not; the conversion
    round-trips every JAX array unchanged."""
    jm, tm = carried_pair()
    jsd = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    assert "mlm_bias" in jsd and \
        "ernie.embeddings.task_type_embeddings.weight" in jsd
    assert set(tm.state_dict()) == set(jsd)
    transposed = {k for k in jsd if k.endswith(".weight") and
                  k.split(".")[-2] in LINEAR_NAMES}
    # per layer q/k/v/out/linear1/linear2; pooler, MLM transform, SOP head
    assert len(transposed) == 2 * 6 + 3 and "sop_head.weight" in transposed
    for k, v in jsd.items():
        got = tm.state_dict()[k].numpy()
        np.testing.assert_array_equal(got, v.T if k in transposed else v,
                                      err_msg=k)
    back = to_jax_state_dict(tm.state_dict())
    for k, v in jsd.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_pipeline_state_dict_keys_match_jax_and_convert():
    """The pipeline's keys are JAX's (``0.embeddings.…``, ``{i}.block.…``,
    ``3.transform``/``3.norm``/``3.proj``); the untied projection and the
    head's transform are transposed, the embeddings are not."""
    jp, tp = carried_pipelines()
    jsd = {k: np.asarray(v) for k, v in jp.state_dict().items()}
    assert set(tp.state_dict()) == set(jsd)
    assert "0.embeddings.word_embeddings.weight" in jsd
    assert "2.block.linear1.weight" in jsd and "3.proj.weight" in jsd
    assert jsd["3.proj.weight"].shape == (128, VOCAB)
    assert tuple(tp.state_dict()["3.proj.weight"].shape) == (VOCAB, 128)
    for k in ("3.proj.weight", "3.transform.weight",
              "1.block.self_attn.q_proj.weight"):
        np.testing.assert_array_equal(tp.state_dict()[k].numpy(), jsd[k].T)
    for k in ("0.embeddings.word_embeddings.weight",
              "0.embeddings.task_type_embeddings.weight", "3.proj.bias",
              "3.norm.weight"):
        np.testing.assert_array_equal(tp.state_dict()[k].numpy(), jsd[k])
    assert set(dict(tp.named_parameters())) == set(get_params(jp))


# -- the model ----------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True], ids=["dense", "padded"])
def test_ernie_logits_match_jax(masked):
    """MLM logits and SOP logits on the same weights and batch, with and
    without ``attention_mask``. f32 through two layers: atol 1e-4."""
    jm, tm = carried_pair()
    ids, att, _, _ = batch(masked=masked)
    want = [np.asarray(x) for x in jm(_j(ids), None, _j(att))]
    with torch.no_grad():
        got = [x.numpy() for x in tm(_t(ids), None, _t(att))]
    assert got[0].shape == (B, S, VOCAB) and got[1].shape == (B, 2)
    for g, w, what in zip(got, want, ("logits", "sop_logits")):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0, err_msg=what)


def _loss_and_grads(jm, tm, ids, att, labels, sop):
    def loss(p):
        return functional_call(jm, p, _j(ids), None, _j(att), _j(labels),
                               _j(sop), training=True)

    want_loss, want = jax.value_and_grad(loss)(get_params(jm))
    tm.train()
    got_loss = tm(_t(ids), None, _t(att), _t(labels), _t(sop))
    got_loss.backward()
    got = to_jax_state_dict({n: p.grad for n, p in tm.named_parameters()})
    return float(got_loss.detach()), float(want_loss), got, want


@pytest.mark.parametrize("masked", [False, True], ids=["dense", "padded"])
def test_ernie_loss_with_sop_and_grads_match_jax(masked):
    """The loss (MLM mean over the labels that are not -100, plus SOP)
    within 1e-5, and every parameter's gradient (Linear weights in the JAX
    ``[in, out]`` layout) within 1e-4 of its largest value, against
    ``jax.grad`` of ``functional_call``."""
    jm, tm = carried_pair()
    got_loss, want_loss, got, want = _loss_and_grads(
        jm, tm, *batch(seed=1, masked=masked))
    assert abs(got_loss - want_loss) <= 1e-5
    _close_grads(got, want)


def test_ernie_at_1024_streams_and_matches_jax(monkeypatch):
    """B = 1, S = 1024, 2 layers: the JAX package's tiles span two key
    tiles here, so its kernels would stream, and the port runs the
    streamed forward, dq and dk/dv (their plain versions) in every layer,
    with the padding mask as their key bias. Against JAX on the same
    weights: loss within 1e-5, every gradient within 1e-4 of its largest
    value."""
    jm, tm = carried_pair(max_position_embeddings=1024)
    calls = []
    for name in STREAMED + ["flash_packed_fwd", "flash_packed_bwd",
                            "flash_packed_bwd_dkv_direct"]:
        fn = getattr(hfp, name + "_reference")

        def spy(*a, _fn=fn, _name=name, **kw):
            calls.append(_name)
            return _fn(*a, **kw)

        monkeypatch.setattr(hfp, name + "_reference", spy)
    got_loss, want_loss, got, want = _loss_and_grads(
        jm, tm, *batch(b=1, s=1024, seed=2, masked=True))
    assert calls == STREAMED[:1] * 2 + STREAMED[1:] * 2
    assert abs(got_loss - want_loss) <= 1e-5
    _close_grads(got, want)


def test_pipeline_forward_loss_and_grads_match_jax():
    """The one-stage PipelineLayer: the untied MLM logits within 1e-4, the
    loss within 1e-5, every gradient within 1e-4 of its largest value."""
    jp, tp = carried_pipelines()
    ids, _, labels, _ = batch(seed=3)
    labels = np.where(labels < 0, 0, labels).astype(np.int32)
    want_out = np.asarray(jp(_j(ids)))
    with torch.no_grad():
        got_out = tp(_t(ids).long()).numpy()
    np.testing.assert_allclose(got_out, want_out, atol=1e-4, rtol=0)

    def loss(p):
        return jax_loss_fn(functional_call(jp, p, _j(ids), training=True),
                           _j(labels))

    want_loss, want = jax.value_and_grad(loss)(get_params(jp))
    tp.train()
    got_loss = tp.loss_fn(tp(_t(ids).long()), _t(labels).long())
    got_loss.backward()
    assert abs(float(got_loss.detach()) - float(want_loss)) <= 1e-5
    _close_grads(to_jax_state_dict({n: p.grad for n, p in
                                    tp.named_parameters()}), want)


# -- the train step -----------------------------------------------------------

@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_pipeline_train_step_matches_jax(precision):
    """Six steps of ``make_pipeline_train_step`` (one stage, n_microbatch
    4, AdamW(1e-3, multi_precision=True), bench.py's loss, the same batch
    every step) against JAX's on the same weights. f32: losses within 1e-5
    and the final parameters within 1e-5 (the key projection's bias, whose
    gradient is rounding noise on both sides, moves by at most lr a step
    either way: within 2·6·lr). bf16 (``.to(bf16)`` as bench.py's
    ``astype``, f32 masters): the two frameworks round bf16 products at
    other points, so losses within 2e-2; AdamW moves an element by about
    lr a step whatever its gradient's size, so where rounding decides a
    gradient's sign the two part by up to 2·6·lr: each final parameter
    within that plus one bf16 ulp of its tensor's size, and each tensor's
    mean difference within 1e-4 (the key bias's within 2·6·lr)."""
    jp, tp = carried_pipelines(seed=12)
    ids, _, labels, _ = batch(seed=4)
    labels = np.where(labels < 0, 0, labels).astype(np.int32)
    lr, steps = 1e-3, 6
    if precision == "bf16":
        jp.astype(paddle.bfloat16)
        tp.to(torch.bfloat16)
    jopt_ = jopt.AdamW(learning_rate=lr, multi_precision=True)
    jstep = jax_make_pipeline_train_step(jp, jopt_, n_microbatch=4)
    jparams = get_params(jp)
    jstate = jopt_.init(jparams)
    want = []
    for _ in range(steps):
        jparams, jstate, loss = jstep(jparams, jstate, _j(ids), _j(labels),
                                      jnp.float32(lr))
        want.append(float(loss))
    topt_ = topt.AdamW(learning_rate=lr, multi_precision=True)
    step = make_pipeline_train_step(tp, topt_, n_microbatch=4)
    params = dict(tp.named_parameters())
    state = topt_.init(params)
    got = []
    for _ in range(steps):
        params, state, loss = step(params, state, _t(ids).long(),
                                   _t(labels).long(), lr)
        got.append(float(loss))
    assert got[-1] < got[0] - 0.05
    np.testing.assert_allclose(got, want,
                               atol=1e-5 if precision == "f32" else 2e-2)
    final = to_jax_state_dict(params)
    assert set(final) == set(jparams)
    for name, p in final.items():
        w = np.asarray(jnp.asarray(jparams[name]).astype(jnp.float32))
        noise = 2 * steps * lr
        if precision == "f32":
            atol = noise if name.endswith("k_proj.bias") else 1e-5
        else:
            atol = noise + 2 ** -7 * float(np.abs(w).max())
            mean = noise if name.endswith("k_proj.bias") else 1e-4
            assert float(np.abs(p - w).mean()) <= mean, name
        np.testing.assert_allclose(p, w, atol=atol, rtol=0, err_msg=name)


# -- what is not ported -------------------------------------------------------

def test_ernie_dropout_raises_in_training():
    """ERNIE's default dropout (0.1) is ported now: both forms train, and
    the dropout moves their outputs off eval mode's
    (``tests/test_torch_dropout.py`` holds it against JAX)."""
    cfg = ternie.ernie_tiny(num_heads=2)
    assert cfg.hidden_dropout == 0.1 and cfg.attention_dropout == 0.1
    ids = _t(batch()[0]).long()
    for model in (ternie.ErnieForPretraining(cfg, device="cpu"),
                  PipelineLayer(ternie.ernie_pipeline_descs(cfg,
                                                            device="cpu"),
                                num_stages=1, loss_fn=port_loss_fn)):
        with torch.no_grad():
            out = model(ids)
            out = out[0] if isinstance(out, tuple) else out
            assert torch.isfinite(out).all()
            model.eval()
            ev = model(ids)
            assert not torch.equal(out, ev[0] if isinstance(ev, tuple)
                                   else ev)


def test_pipeline_degree_above_one_raises():
    class Group:
        def get_pipe_parallel_world_size(self):
            return 4

    _, tp = carried_pipelines()
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        make_pipeline_train_step(tp, topt.AdamW(1e-4), hcg=Group(),
                                 n_microbatch=4)


def test_pipeline_layer_partitions_and_shares_as_in_jax():
    """Stage boundaries by count and at a class, and a SharedLayerDesc
    built once, registered once under its first position and called
    through its ``forward_func`` at each."""
    from paddle_tpu.distributed.fleet.meta_parallel import pp_layers as jpp
    for n_stages in (1, 2, 3):
        tp = PipelineLayer([LayerDesc(torch.nn.Identity) for _ in range(7)],
                           num_stages=n_stages)
        jl = jpp.PipelineLayer([jpp.LayerDesc(lambda: (lambda x: x))
                                for _ in range(7)], num_stages=n_stages)
        assert tp._segments == jl._segments
    lin = SharedLayerDesc("tied", torch.nn.Linear, None, "weight", 4, 4)
    twice = SharedLayerDesc("tied", torch.nn.Linear,
                            lambda layer, x: x @ layer.weight, "weight", 4, 4)
    tp = PipelineLayer([lin, LayerDesc(torch.nn.ReLU), twice],
                       num_stages=2, seg_method="layer:Linear")
    assert [n for n, _ in tp.named_children()] == ["0", "1"]
    assert tp.shared_layers()["tied"] is tp._built[2][0]
    x = torch.randn(3, 4)
    w = tp.shared_layers()["tied"]
    torch.testing.assert_close(tp(x), torch.relu(w(x)) @ w.weight)


def test_ernie_runs_on_cuda_by_default():
    """``device=None`` means cuda:0: without CUDA it raises instead of
    quietly building on the CPU, for the model and the pipeline layers."""
    if torch.cuda.is_available():
        assert ternie.ErnieForPretraining(
            ternie.ernie_tiny(**TINY)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ternie.ErnieForPretraining(ternie.ernie_tiny(**TINY))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ternie.ernie_pipeline_descs(ternie.ernie_tiny(**TINY))
