"""Port parity: the BERT pretraining slice — the encoder layers, BERT's
logits, loss and gradients, weight conversion and the train step — against
the JAX package.

The model is ``bert_tiny(num_heads=2)``: hidden 128 in 2 heads of 64, so
attention takes the K4 route (its plain versions on the CPU); ``bert_tiny``'s
own 4 heads of 32 never reach K4. Weights go from the JAX model to the port
through ``convert.from_jax_state_dict``; inputs and labels are made with
numpy from a seed and handed to both sides, in bench.py's three batch forms:
dense (token types and NSP labels), padded (``attention_mask``, labels -100
at the pads) and packed (``packed_segment_ids``, pads in segment 0). The
JAX side runs on the CPU, where its attention takes the dense path. Each
comparison states its tolerance and why.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.framework.functional import functional_call, get_params
from paddle_tpu.text.models.bert import BertForPretraining as JaxBert
from paddle_tpu.text.models.bert import bert_tiny as jax_bert_tiny
from paddle_tpu_torch import amp
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.convert import (LINEAR_NAMES, from_jax_state_dict,
                                      to_jax_state_dict)
from paddle_tpu_torch.framework import make_sharded_train_step
from paddle_tpu_torch.nn import (MultiHeadAttention, TransformerEncoder,
                                 TransformerEncoderLayer)
from paddle_tpu_torch.text.models.bert import BertForPretraining, bert_tiny
from _torch_threads import one_torch_thread  # noqa: F401

B, S, VOCAB = 2, 128, 1024    # B != S: a [B, S] mask is a key mask
TINY = dict(num_heads=2, hidden_dropout=0.0, attention_dropout=0.0)
FORMS = ["dense", "padded", "packed"]


def carried_pair(seed=7, **over):
    """(JAX model, port model with the JAX weights), f32 on the CPU."""
    paddle.seed(seed)
    kw = {**TINY, **over}
    jm = JaxBert(jax_bert_tiny(**kw))
    tm = BertForPretraining(bert_tiny(**kw), device="cpu")
    jsd = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    tm.load_state_dict(from_jax_state_dict(jsd), strict=True)
    return jm, tm


def bert_batch(form, seed=0):
    """Positional arguments ``(input_ids, token_type_ids, attention_mask,
    masked_lm_labels, next_sentence_labels)`` and the keyword
    ``packed_segment_ids`` of one form, as numpy arrays or None. MLM labels
    cover about half the positions (the rest -100)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, VOCAB, (B, S)).astype(np.int32)
    labels = rng.integers(0, VOCAB, (B, S)).astype(np.int32)
    labels[rng.random((B, S)) < 0.5] = -100
    if form == "dense":
        tt = (np.arange(S)[None, :] >= np.array([64, 90])[:, None]).astype(
            np.int32)
        sop = rng.integers(0, 2, (B, 1)).astype(np.int32)
        return (ids, tt, None, labels, sop), None
    if form == "padded":
        att = (np.arange(S)[None, :] < np.array([100, 128])[:, None])
        labels = np.where(att, labels, -100).astype(np.int32)
        return (ids, None, att.astype(np.int32), labels, None), None
    seg = np.zeros((B, S), np.int32)
    seg[0, :60], seg[0, 60:110] = 1, 2            # two sequences, 18 pads
    seg[1, :40], seg[1, 40:128] = 1, 2
    labels = np.where(seg > 0, labels, -100).astype(np.int32)
    return (ids, None, None, labels, None), seg


def _jax_args(args, seg):
    return ([None if a is None else jnp.asarray(a) for a in args],
            {} if seg is None else {"packed_segment_ids": jnp.asarray(seg)})


def _torch_args(args, seg):
    return ([None if a is None else torch.from_numpy(a) for a in args],
            {} if seg is None else {"packed_segment_ids":
                                    torch.from_numpy(seg)})


# -- layers ------------------------------------------------------------------

def _carry_layer(jlayer, tlayer):
    jsd = {k: np.asarray(v) for k, v in jlayer.state_dict().items()}
    tlayer.load_state_dict(from_jax_state_dict(jsd), strict=True)


@pytest.mark.parametrize("normalize_before", [False, True])
@pytest.mark.parametrize("mask", ["none", "key_bias", "segments"])
def test_encoder_layer_matches_jax(normalize_before, mask):
    """TransformerEncoderLayer (GELU, hidden 128, 2 heads of 64) on the
    same weights and input, with a float key mask or segment ids. f32, the
    port through K4's plain versions, JAX through its dense path:
    atol 1e-5 on outputs of about 1."""
    paddle.seed(3)
    jl = jnn.TransformerEncoderLayer(128, 2, 256, dropout=0.0,
                                     activation="gelu",
                                     normalize_before=normalize_before)
    tl = TransformerEncoderLayer(128, 2, 256, dropout=0.0, activation="gelu",
                                 normalize_before=normalize_before,
                                 device="cpu")
    _carry_layer(jl, tl)
    x = np.random.default_rng(1).standard_normal((B, S, 128)).astype(
        np.float32)
    jkw, tkw = {}, {}
    if mask == "key_bias":
        att = (np.arange(S)[None, :] < np.array([77, 128])[:, None])
        m = ((1.0 - att[:, None, None, :].astype(np.float32)) * -1e9)
        jkw, tkw = ({"src_mask": jnp.asarray(m)},
                    {"src_mask": torch.from_numpy(m)})
    elif mask == "segments":
        seg = np.where(np.arange(S)[None, :] < np.array([[50], [90]]), 1,
                       2).astype(np.int32)
        jkw, tkw = ({"segment_ids": jnp.asarray(seg)},
                    {"segment_ids": torch.from_numpy(seg)})
    want = np.asarray(jl(jnp.asarray(x), **jkw))
    with torch.no_grad():
        got = tl(torch.from_numpy(x), **tkw).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_multi_head_attention_cross_attention_and_refusals():
    """Cross-attention (keys from another sequence of 256) against JAX;
    decoder caches are not ported and raise."""
    paddle.seed(4)
    jl = jnn.MultiHeadAttention(128, 2)
    tl = MultiHeadAttention(128, 2, device="cpu")
    _carry_layer(jl, tl)
    rng = np.random.default_rng(2)
    q = rng.standard_normal((B, S, 128)).astype(np.float32)
    kv = rng.standard_normal((B, 256, 128)).astype(np.float32)
    want = np.asarray(jl(jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv)))
    with torch.no_grad():
        got = tl(torch.from_numpy(q), torch.from_numpy(kv),
                 torch.from_numpy(kv)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    with pytest.raises(NotImplementedError, match="caches"):
        tl.gen_cache(torch.from_numpy(q))
    with pytest.raises(NotImplementedError, match="caches"):
        tl(torch.from_numpy(q), cache=(None, None))


def test_transformer_encoder_stacks_layers_with_a_final_norm():
    paddle.seed(5)
    jenc = jnn.TransformerEncoder(
        lambda: jnn.TransformerEncoderLayer(128, 2, 256, dropout=0.0), 2,
        norm=jnn.LayerNorm(128))
    tenc = TransformerEncoder(
        lambda: TransformerEncoderLayer(128, 2, 256, dropout=0.0,
                                        device="cpu"), 2,
        norm=torch.nn.LayerNorm(128, eps=1e-5))
    _carry_layer(jenc, tenc)
    x = np.random.default_rng(3).standard_normal((B, S, 128)).astype(
        np.float32)
    want = np.asarray(jenc(jnp.asarray(x)))
    with torch.no_grad():
        got = tenc(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


# -- the model ---------------------------------------------------------------

def test_state_dict_keys_match_jax_and_load_strictly():
    """The port's keys are the JAX model's 46 (mlm_bias included); a strict
    load passes; the conversion round-trips every JAX array unchanged; the
    GPT Linear names still transpose as before."""
    jm, tm = carried_pair()
    jsd = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    assert len(jsd) == 46 and "mlm_bias" in jsd
    assert set(tm.state_dict()) == set(jsd)
    back = to_jax_state_dict(tm.state_dict())
    for k, v in jsd.items():
        assert back[k].shape == v.shape, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    transposed = {k for k in jsd if k.endswith(".weight") and
                  k.split(".")[-2] in LINEAR_NAMES}
    assert len(transposed) == 2 * 6 + 3      # per layer q/k/v/out/1/2; heads
    for k in transposed:
        assert tuple(tm.state_dict()[k].shape) == jsd[k].shape[::-1], k
    gpt_names = {"qkv_proj", "q_proj", "kv_proj", "out_proj", "up", "down",
                 "lm_head"}
    assert gpt_names <= LINEAR_NAMES
    assert from_jax_state_dict(
        {"gpt.h.0.mlp.up.weight": np.zeros((3, 5), np.float32)}
    )["gpt.h.0.mlp.up.weight"].shape == (5, 3)


@pytest.mark.parametrize("form", FORMS)
def test_bert_logits_match_jax(form):
    """MLM logits and NSP logits on the same weights and batch. f32 through
    two layers: atol 1e-4."""
    jm, tm = carried_pair()
    (ids, tt, att, _, _), seg = bert_batch(form)
    jargs, jkw = _jax_args((ids, tt, att), seg)
    targs, tkw = _torch_args((ids, tt, att), seg)
    want = [np.asarray(x) for x in jm(*jargs, **jkw)]
    with torch.no_grad():
        got = [x.numpy() for x in tm(*targs, **tkw)]
    assert got[0].shape == (B, S, VOCAB) and got[1].shape == (B, 2)
    for g, w, what in zip(got, want, ("logits", "nsp_logits")):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0, err_msg=what)


@pytest.mark.parametrize("form", FORMS)
def test_bert_loss_and_grads_match_jax(form):
    """The loss (MLM mean over the labels that are not -100, plus NSP in
    the dense form) within 1e-5, and every parameter's gradient (Linear
    weights in the JAX ``[in, out]`` layout) within 1e-4 of its largest
    value, against ``jax.grad`` of ``functional_call``. The key projection's
    bias has a true gradient of 0 (softmax ignores a constant added to every
    key score), so both sides hold rounding noise of about 1e-11 there: an
    absolute floor of 1e-9 covers it."""
    jm, tm = carried_pair()
    args, seg = bert_batch(form, seed=1)
    jargs, jkw = _jax_args(args, seg)

    def loss(p):
        return functional_call(jm, p, *jargs, training=True, **jkw)

    want_loss, want = jax.value_and_grad(loss)(get_params(jm))
    targs, tkw = _torch_args(args, seg)
    tm.train()
    got_loss = tm(*targs, **tkw)
    got_loss.backward()
    assert abs(float(got_loss.detach()) - float(want_loss)) <= 1e-5
    # a parameter the loss does not reach (the pooler and NSP head without
    # NSP labels) has no gradient in torch and a zero one in JAX
    unreached = {n for n, p in tm.named_parameters() if p.grad is None}
    assert unreached == (set() if form == "dense" else
                         {"bert.pooler.weight", "bert.pooler.bias",
                          "nsp_head.weight", "nsp_head.bias"})
    got = to_jax_state_dict({n: torch.zeros_like(p) if p.grad is None
                             else p.grad for n, p in tm.named_parameters()})
    assert set(got) == set(want)
    for name, g in got.items():
        w = np.asarray(want[name])
        np.testing.assert_allclose(
            g, w, atol=1e-4 * float(np.abs(w).max()) + 1e-9, rtol=0,
            err_msg=name)


def test_mlm_bias_is_a_trained_parameter_as_in_jax():
    """``mlm_bias`` is a parameter of the JAX model (in its state_dict and
    ``get_params``, zero at init), so it has a gradient and AdamW moves it;
    the port keeps it as a parameter and matches both. f32: the gradient
    within 1e-4 of its max, the stepped bias within 1e-6."""
    jm, tm = carried_pair()
    assert "mlm_bias" in get_params(jm)
    assert "mlm_bias" in dict(tm.named_parameters())
    assert float(jnp.abs(jm.mlm_bias).max()) == 0.0
    args, _ = bert_batch("dense", seed=2)
    jargs, _ = _jax_args(args, None)
    params = get_params(jm)
    grads = jax.grad(lambda p: functional_call(jm, p, *jargs,
                                               training=True))(params)
    want = np.asarray(grads["mlm_bias"])
    assert np.abs(want).max() > 1e-3
    targs, _ = _torch_args(args, None)
    tm(*targs).backward()
    got = tm.mlm_bias.grad.numpy()
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())
    jparams, _ = jopt.AdamW(1e-3, weight_decay=0.01).apply_gradients(
        params, grads, jopt.AdamW(1e-3, weight_decay=0.01).init(params))
    tp = {n: p.detach().clone() for n, p in tm.named_parameters()}
    topt.AdamW(1e-3, weight_decay=0.01).apply_gradients(
        tp, {n: p.grad for n, p in tm.named_parameters()},
        topt.AdamW(1e-3, weight_decay=0.01).init(tp))
    assert float(tp["mlm_bias"].abs().max()) > 5e-4
    np.testing.assert_allclose(tp["mlm_bias"].numpy(),
                               np.asarray(jparams["mlm_bias"]), atol=1e-6)


def test_bert_dropout_raises_in_training_and_is_a_no_op_in_eval():
    """BERT's default dropout (0.1) is ported now: training runs and moves
    the logits (``tests/test_torch_dropout.py`` holds it against JAX), eval
    mode gives the dropout-free model's logits exactly."""
    paddle.seed(8)
    cfg = bert_tiny(num_heads=2)
    assert cfg.hidden_dropout == 0.1 and cfg.attention_dropout == 0.1
    tm = BertForPretraining(cfg, device="cpu")
    ids = torch.from_numpy(bert_batch("dense")[0][0])
    with torch.no_grad():
        trained = tm(ids)[0]
    assert torch.isfinite(trained).all()
    tm.eval()
    with torch.no_grad():
        assert not torch.equal(trained, tm(ids)[0])
    plain = BertForPretraining(bert_tiny(**TINY), device="cpu")
    plain.load_state_dict(tm.state_dict(), strict=True)
    with torch.no_grad():
        assert torch.equal(tm(ids)[0], plain(ids)[0])


def test_bert_runs_on_cuda_by_default():
    """``device=None`` means cuda:0: without CUDA it raises instead of
    quietly building on the CPU."""
    if torch.cuda.is_available():
        m = BertForPretraining(bert_tiny(**TINY))
        assert m.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            BertForPretraining(bert_tiny(**TINY))


# -- the train step ----------------------------------------------------------

def jax_train_loop(jm, args, seg, steps, lr):
    """bench.py's BERT step (``:568-577``): value_and_grad of the
    functional loss, then AdamW.apply_gradients, one jitted step, on the
    same batch every step."""
    opt = jopt.AdamW(learning_rate=lr, weight_decay=0.01,
                     multi_precision=True)
    params = get_params(jm)
    state = opt.init(params)
    jargs, jkw = _jax_args(args, seg)

    @jax.jit
    def one_step(p, st):
        loss, grads = jax.value_and_grad(lambda p_: functional_call(
            jm, p_, *jargs, training=True, **jkw))(p)
        p, st = opt.apply_gradients(p, grads, st, lr)
        return loss, p, st

    losses = []
    for _ in range(steps):
        loss, params, state = one_step(params, state)
        losses.append(float(loss))
    return losses, params


@pytest.mark.parametrize("form,precision", [
    ("dense", "f32"), ("padded", "f32"), ("packed", "f32"), ("dense", "o2")])
def test_train_step_loss_curve_matches_jax_loop(form, precision):
    """Ten TrainStep steps of the d=64 tiny BERT under AdamW (lr 1e-3, so
    that the curve moves) against the JAX loop on the same weights and
    batch. f32: losses within 1e-4. AMP-O2 (bf16 weights and activations,
    f32 masters): the two frameworks round bf16 products at other points,
    so within 2e-2 on losses near 7. Without NSP labels the pooler and
    NSP head get no gradient: JAX steps them with a zero one (AdamW decays
    them), and so does the port's TrainStep: within 1e-7 in f32."""
    jm, tm = carried_pair(seed=9)
    args, seg = bert_batch(form, seed=3)
    opt = topt.AdamW(learning_rate=1e-3, weight_decay=0.01,
                     multi_precision=True)
    if precision == "o2":
        jm.astype(paddle.bfloat16)
        tm, opt = amp.decorate(tm, opt, level="O2")
    want, want_params = jax_train_loop(jm, args, seg, 10, 1e-3)
    targs, tkw = _torch_args(args, seg)
    step = make_sharded_train_step(tm, opt,
                                   lambda m, bt: m(*bt[0], **bt[1]))
    got = [float(step.step((targs, tkw))) for _ in range(10)]
    np.testing.assert_allclose(got, want,
                               atol=1e-4 if precision == "f32" else 2e-2)
    assert got[-1] < got[0] - 0.1
    if form != "dense":
        got_params = to_jax_state_dict(dict(tm.named_parameters()))
        for name in ("bert.pooler.weight", "bert.pooler.bias",
                     "nsp_head.weight"):
            w = np.asarray(want_params[name])
            assert not np.array_equal(w, np.asarray(get_params(jm)[name])) \
                or not w.any(), name
            np.testing.assert_allclose(got_params[name], w, atol=1e-7,
                                       rtol=0, err_msg=name)
