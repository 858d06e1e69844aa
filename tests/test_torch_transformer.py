"""Port parity: ``nn.Transformer`` and what it needs — the decoder layers,
``MultiHeadAttention``'s caches, ``ParamAttr`` on the layers, beam search —
against the JAX package.

Widths are d_model 128 in 2 heads of 64 at lengths 128 and 256, so the
port's encoder self-attention and cross-attention take K4's route (its
plain versions on the CPU) while JAX takes its dense path; the causal
decoder self-attention (a per-query ``[L, L]`` mask) and one-token decode
steps are dense on both sides; one case at lengths off 128 is dense on
both. Weights go from the JAX layers to the port through
``convert.from_jax_state_dict``; inputs are made with numpy from a seed.
Everything is f32 on the CPU:

- layer outputs and decoding steps within atol 1e-5 on values of about 1
  (the same sums in other orders);
- the seq2seq loss within 1e-5 and each gradient within 1e-4 of its
  largest element (``k_proj.bias``, whose true gradient is 0 since softmax
  ignores a constant added to a row's scores, on the scale of its
  weight's gradient);
- three ``TrainStep`` steps of AdamW under label smoothing 0.1 within 1e-4
  of the JAX loop's losses;
- beam search: the same tokens, scores within 1e-4.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.framework.functional import functional_call, get_params
from paddle_tpu.nn import functional as JF
from paddle_tpu.nn import initializer as JI
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.convert import from_jax_state_dict, to_jax_state_dict
from paddle_tpu_torch.framework import make_sharded_train_step
from paddle_tpu_torch.nn import functional as TFn
from paddle_tpu_torch.nn import initializer as TI
from _torch_threads import one_torch_thread  # noqa: F401

D, H, FFN, VOCAB, PAD = 128, 2, 256, 96, 0
B = 2


def carry(jlayer, tlayer):
    jsd = {k: np.asarray(v) for k, v in jlayer.state_dict().items()}
    tlayer.load_state_dict(from_jax_state_dict(jsd), strict=True)
    return jlayer, tlayer


def normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def key_bias(lengths, s):
    """``[B, 1, 1, S]`` float bias: 0 at real keys, -1e9 at the pads."""
    valid = np.arange(s)[None, :] < np.asarray(lengths)[:, None]
    return ((1.0 - valid[:, None, None, :].astype(np.float32)) * -1e9)


def both(x):
    return jnp.asarray(x), torch.from_numpy(x)


def close(got, want, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(
        got, torch.Tensor) else got), np.asarray(want), atol=atol, rtol=0)


def causal(length):
    return (jnn.Transformer.generate_square_subsequent_mask(length),
            tnn.Transformer.generate_square_subsequent_mask(length,
                                                            device="cpu"))


# -- MultiHeadAttention's caches ------------------------------------------------

def test_square_subsequent_mask_equals_jax():
    for n in (1, 5, 128):
        j, t = causal(n)
        assert t.dtype == torch.float32 and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_mha_incremental_cache_matches_jax_and_the_causal_pass():
    """A 128-token prefix through the cache under the causal mask (dense on
    both sides), then 6 one-token steps: each step's output and the grown
    cache against JAX's steps, and every row against the port's own full
    causal pass over the 134 tokens."""
    paddle.seed(1)
    jl, tl = carry(jnn.MultiHeadAttention(D, H),
                   tnn.MultiHeadAttention(D, H, device="cpu"))
    jx, tx = both(normal(2, B, 134, D))
    jc, tc = jl.gen_cache(jx), tl.gen_cache(tx)
    assert isinstance(tc, tnn.MultiHeadAttention.Cache)
    assert tuple(tc.k.shape) == (B, 0, H, D // H)
    jm, tm = causal(128)
    jo, jc = jl(jx[:, :128], attn_mask=jm, cache=jc)
    with torch.no_grad():
        to, tc = tl(tx[:, :128], attn_mask=tm, cache=tc)
        full = tl(tx, attn_mask=causal(134)[1])
    close(to, jo)
    close(to, full[:, :128])
    for t in range(128, 134):
        jo, jc = jl(jx[:, t:t + 1], cache=jc)
        with torch.no_grad():
            to, tc = tl(tx[:, t:t + 1], cache=tc)
        close(to, jo)
        close(to, full[:, t:t + 1])
    assert type(tc).__name__ == "Cache" and tc.k.shape[1] == 134
    close(tc.k, jc.k)
    close(tc.v, jc.v)


@pytest.mark.parametrize("sq,sk", [(128, 256), (1, 256), (40, 72)])
def test_mha_static_cache_matches_jax(sq, sk):
    """Cross-attention keys and values projected once (``StaticCache``),
    then used as they are: the kernel route at 128 over 256 (K4's plain
    version), dense at one query and off 128; the cache comes back
    unchanged."""
    paddle.seed(3)
    jl, tl = carry(jnn.MultiHeadAttention(D, H),
                   tnn.MultiHeadAttention(D, H, device="cpu"))
    jq, tq = both(normal(4, B, sq, D))
    jmem, tmem = both(normal(5, B, sk, D))
    jb, tb = both(key_bias([sk, sk - 30], sk))
    jc = jl.gen_cache(jmem, type=jnn.MultiHeadAttention.StaticCache)
    with torch.no_grad():
        tc = tl.gen_cache(tmem, type=tnn.MultiHeadAttention.StaticCache)
        to, tc2 = tl(tq, None, None, attn_mask=tb, cache=tc)
    close(tc.k, jc.k)
    close(tc.v, jc.v)
    jo, _ = jl(jq, None, None, attn_mask=jb, cache=jc)
    close(to, jo)
    assert tc2 is tc
    with torch.no_grad():
        plain = tl(tq, tmem, tmem, attn_mask=tb)
    close(to, plain)


def test_mha_param_attr_and_no_bias_match_jax():
    """``weight_attr=ParamAttr(initializer=Constant(...))`` and
    ``bias_attr=False`` on every projection: the same weights as JAX's
    (transposed), no bias, the same keys and output."""
    jl = jnn.MultiHeadAttention(
        D, H, weight_attr=jnn.ParamAttr(initializer=JI.Constant(0.01)),
        bias_attr=False)
    tl = tnn.MultiHeadAttention(
        D, H, weight_attr=tnn.ParamAttr(initializer=TI.Constant(0.01)),
        bias_attr=False, need_weights=True, device="cpu")
    assert set(tl.state_dict()) == set(jl.state_dict()) == {
        f"{p}.weight" for p in ("q_proj", "k_proj", "v_proj", "out_proj")}
    for name, w in tl.state_dict().items():
        np.testing.assert_array_equal(w.numpy().T, np.asarray(
            jl.state_dict()[name]))
    jx, tx = both(normal(6, B, 128, D))
    with torch.no_grad():
        close(tl(tx), jl(jx))
    jl2 = jnn.MultiHeadAttention(
        D, H, bias_attr=jnn.ParamAttr(initializer=JI.Constant(0.5)))
    tl2 = tnn.MultiHeadAttention(
        D, H, bias_attr=tnn.ParamAttr(initializer=TI.Constant(0.5)),
        dtype="float32", device="cpu")
    assert (tl2.q_proj.bias == 0.5).all() and \
        (np.asarray(jl2.q_proj.bias) == 0.5).all()


# -- the decoder ---------------------------------------------------------------

@pytest.mark.parametrize("normalize_before", [False, True])
@pytest.mark.parametrize("lengths", [(128, 256), (60, 100)])
def test_decoder_layer_matches_jax(normalize_before, lengths):
    """TransformerDecoderLayer (ReLU) in post- and pre-LN on the same
    weights: causal self-attention over the target, cross-attention over a
    padded memory (K4's plain version at 128 over 256 in the port; both
    dense at 60 over 100)."""
    lt, ls = lengths
    paddle.seed(7)
    jl, tl = carry(
        jnn.TransformerDecoderLayer(D, H, FFN, dropout=0.0,
                                    normalize_before=normalize_before),
        tnn.TransformerDecoderLayer(D, H, FFN, dropout=0.0,
                                    normalize_before=normalize_before,
                                    device="cpu"))
    jt, tt = both(normal(8, B, lt, D))
    jmem, tmem = both(normal(9, B, ls, D))
    jb, tb = both(key_bias([ls, ls - 17], ls))
    jm, tm = causal(lt)
    with torch.no_grad():
        got = tl(tt, tmem, tgt_mask=tm, memory_mask=tb)
    close(got, jl(jt, jmem, tgt_mask=jm, memory_mask=jb))


def test_decoder_with_caches_matches_jax_and_the_causal_pass():
    """A 2-layer TransformerDecoder with a final norm: ``gen_cache``, then
    5 one-token steps, against JAX's steps and the port's own causal pass;
    ``do_zip`` as in JAX."""
    paddle.seed(11)

    def make(mod, **kw):
        return mod.TransformerDecoder(
            lambda: mod.TransformerDecoderLayer(D, H, FFN, dropout=0.0,
                                                **kw), 2,
            norm=mod.LayerNorm(D, **kw))

    jd, td = carry(make(jnn), make(tnn, device="cpu"))
    jt, tt = both(normal(12, B, 5, D))
    jmem, tmem = both(normal(13, B, 256, D))
    jb, tb = both(key_bias([256, 200], 256))
    jc, tc = jd.gen_cache(jmem), td.gen_cache(tmem)
    assert len(tc) == 2 and len(td.gen_cache(tmem, do_zip=True)) == 2
    with torch.no_grad():
        full = td(tt, tmem, tgt_mask=causal(5)[1], memory_mask=tb)
    for t in range(5):
        jo, jc = jd(jt[:, t:t + 1], jmem, memory_mask=jb, cache=jc)
        with torch.no_grad():
            to, tc = td(tt[:, t:t + 1], tmem, memory_mask=tb, cache=tc)
        close(to, jo)
        close(to, full[:, t:t + 1])
    for (tk, tv), (jk, jv) in zip(tc, jc):
        close(tk, jk)
        close(tv, jv)


# -- the encoder-decoder ---------------------------------------------------------

def sinusoid(n, d):
    pos = np.arange(n)[:, None]
    rate = 1.0 / np.power(10000.0, np.arange(0, d, 2) / d)
    pe = np.zeros((n, d), np.float32)
    pe[:, 0::2], pe[:, 1::2] = np.sin(pos * rate), np.cos(pos * rate)
    return pe


PE = sinusoid(512, D)


class JSeq2Seq(jnn.Layer):
    """Test wrapper on the JAX layers: a shared embedding scaled by
    sqrt(d), sinusoid positions, the Transformer, the output tied to the
    embedding, label-smoothed cross-entropy with the pads ignored."""

    def __init__(self, layers=2, dropout=0.0):
        super().__init__()
        self.emb = jnn.Embedding(VOCAB, D, padding_idx=PAD)
        self.transformer = jnn.Transformer(D, H, layers, layers, FFN,
                                           dropout=dropout)

    def embed(self, ids, start=0):
        return self.emb(ids) * math.sqrt(D) + \
            jnp.asarray(PE[start:start + ids.shape[1]])

    def logits(self, out):
        return jnp.matmul(out, self.emb.weight.T)

    def forward(self, src, tgt, labels, bias):
        mask = jnn.Transformer.generate_square_subsequent_mask(tgt.shape[1])
        out = self.transformer(self.embed(src), self.embed(tgt),
                               src_mask=bias, tgt_mask=mask,
                               memory_mask=bias)
        return JF.cross_entropy(self.logits(out), labels, ignore_index=PAD,
                                label_smoothing=0.1)


class TSeq2Seq(torch.nn.Module):
    """The same wrapper on the port's layers."""

    def __init__(self, layers=2, dropout=0.0, device="cpu"):
        super().__init__()
        self.emb = tnn.Embedding(VOCAB, D, padding_idx=PAD, device=device)
        self.transformer = tnn.Transformer(D, H, layers, layers, FFN,
                                           dropout=dropout, device=device)
        self.register_buffer("pe", torch.from_numpy(PE).to(device),
                             persistent=False)

    def embed(self, ids, start=0):
        return self.emb(ids) * math.sqrt(D) + \
            self.pe[start:start + ids.shape[1]]

    def logits(self, out):
        return torch.matmul(out, self.emb.weight.T)

    def forward(self, src, tgt, labels, bias):
        mask = tnn.Transformer.generate_square_subsequent_mask(
            tgt.shape[1], device=src.device)
        out = self.transformer(self.embed(src), self.embed(tgt),
                               src_mask=bias, tgt_mask=mask,
                               memory_mask=bias)
        return TFn.cross_entropy(self.logits(out), labels,
                                 ignore_index=PAD, label_smoothing=0.1)


def seq_batch(ls, lt, seed=0):
    """(src, tgt, labels, bias) as numpy: ids in [1, VOCAB), each row's
    source and target padded (id 0) past a length drawn from the seed."""
    rng = np.random.default_rng(seed)
    src = rng.integers(1, VOCAB, (B, ls))
    tgt = rng.integers(1, VOCAB, (B, lt + 1))
    src_len = np.array([ls, ls - rng.integers(5, ls // 3)])
    tgt_len = np.array([lt - rng.integers(1, max(2, lt // 3)), lt + 1])
    src[np.arange(ls)[None] >= src_len[:, None]] = PAD
    tgt[np.arange(lt + 1)[None] >= tgt_len[:, None]] = PAD
    return (src.astype(np.int32), tgt[:, :-1].astype(np.int32),
            tgt[:, 1:].astype(np.int32), key_bias(src_len, ls))


@pytest.fixture(scope="module")
def pair():
    paddle.seed(21)
    return carry(JSeq2Seq(), TSeq2Seq())


def test_state_dict_keys_equal_jax_one_for_one(pair):
    jm, tm = pair
    assert list(tm.state_dict()) == list(jm.state_dict())
    jt = jnn.Transformer(D, H, 1, 1, FFN, normalize_before=True)
    tt = tnn.Transformer(D, H, 1, 1, FFN, normalize_before=True,
                         device="cpu")
    assert list(tt.state_dict()) == list(jt.state_dict())
    assert "encoder.norm.weight" in tt.state_dict() and \
        "decoder.norm.bias" in tt.state_dict()


def _grads_of(jm, tm, batch):
    jargs = [jnp.asarray(a) for a in batch]
    loss, grads = jax.jit(jax.value_and_grad(lambda p: functional_call(
        jm, p, *jargs, training=True)))(get_params(jm))
    targs = [torch.from_numpy(a) for a in batch]
    tm.train()
    tm.zero_grad(set_to_none=True)
    tloss = tm(*targs)
    tloss.backward()
    return (float(loss), {n: np.asarray(g) for n, g in grads.items()},
            float(tloss.detach()), to_jax_state_dict(
                {n: p.grad for n, p in tm.named_parameters()}))


@pytest.mark.parametrize("ls,lt", [(256, 128), (100, 60)])
def test_transformer_loss_and_grads_match_jax(pair, ls, lt):
    """The seq2seq loss and every gradient against ``jax.grad``: source
    256 and target 128 (the port's encoder and cross-attention on K4's
    plain versions, Sq != Sk), and 100/60, dense on both sides."""
    jm, tm = pair
    jl, jg, tl, tg = _grads_of(jm, tm, seq_batch(ls, lt))
    assert abs(tl - jl) <= 1e-5, (tl, jl)
    assert set(tg) == set(jg)
    for name, g in tg.items():
        scale = np.abs(jg[name]).max()
        if name.endswith("k_proj.bias"):
            scale = np.abs(jg[name[:-4] + "weight"]).max()
        np.testing.assert_allclose(g, jg[name], atol=1e-4 * scale + 1e-12,
                                   rtol=0, err_msg=name)


def test_transformer_output_matches_jax(pair):
    jm, tm = pair
    src, tgt, _, bias = seq_batch(256, 128, seed=3)
    jmask, tmask = causal(128)
    with torch.no_grad():
        got = tm.transformer(tm.embed(torch.from_numpy(src)),
                             tm.embed(torch.from_numpy(tgt)),
                             src_mask=torch.from_numpy(bias),
                             tgt_mask=tmask,
                             memory_mask=torch.from_numpy(bias))
    want = jm.transformer(jm.embed(jnp.asarray(src)),
                          jm.embed(jnp.asarray(tgt)),
                          src_mask=jnp.asarray(bias), tgt_mask=jmask,
                          memory_mask=jnp.asarray(bias))
    close(got, want)


def test_three_train_steps_match_the_jax_loop():
    """Three ``TrainStep`` steps of AdamW (lr 1e-3) on one batch against
    the JAX loop (value_and_grad of the functional loss, then
    ``apply_gradients``) from the same weights: losses within 1e-4."""
    paddle.seed(31)
    jm, tm = carry(JSeq2Seq(), TSeq2Seq())
    batch = seq_batch(256, 128, seed=5)
    jargs = [jnp.asarray(a) for a in batch]
    opt = jopt.AdamW(learning_rate=1e-3, weight_decay=0.01)
    params = get_params(jm)
    state = opt.init(params)

    @jax.jit
    def one_step(p, st):
        loss, grads = jax.value_and_grad(lambda p_: functional_call(
            jm, p_, *jargs, training=True))(p)
        p, st = opt.apply_gradients(p, grads, st, 1e-3)
        return loss, p, st

    want = []
    for _ in range(3):
        loss, params, state = one_step(params, state)
        want.append(float(loss))
    step = make_sharded_train_step(
        tm, topt.AdamW(learning_rate=1e-3, weight_decay=0.01),
        lambda m, bt: m(*bt))
    got = [float(step.step(tuple(torch.from_numpy(a) for a in batch)))
           for _ in range(3)]
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert got[-1] < got[0]


# -- beam search ----------------------------------------------------------------

BEAM, END = 3, 5


def _cells(jm, tm, src, bias):
    """One cell a side over the carried model: the memory of one source,
    tiled to the beam, in the state beside the per-layer caches; the
    position read from the cache length."""
    jmem = jnp.tile(jm.transformer.encoder(jm.embed(jnp.asarray(src)),
                                           src_mask=jnp.asarray(bias)),
                    (BEAM, 1, 1))
    tsrc = torch.from_numpy(src)
    with torch.no_grad():
        tmem = tm.transformer.encoder(tm.embed(tsrc),
                                      src_mask=torch.from_numpy(bias))
    tmem = tmem.expand(BEAM, -1, -1).contiguous()
    jb = jnp.tile(jnp.asarray(bias), (BEAM, 1, 1, 1))
    tb = torch.from_numpy(bias).expand(BEAM, -1, -1, -1).contiguous()

    def jcell(ids, states):
        pos = states["caches"][0].k.shape[1]
        x = jm.embed(ids[:, None], pos)
        out, caches = jm.transformer.decoder(
            x, states["memory"], memory_mask=states["bias"],
            cache=states["caches"])
        return jm.logits(out[:, -1]), dict(states, caches=caches)

    @torch.no_grad()
    def tcell(ids, states):
        pos = states["caches"][0].k.shape[1]
        x = tm.embed(ids[:, None], pos)
        out, caches = tm.transformer.decoder(
            x, states["memory"], memory_mask=states["bias"],
            cache=states["caches"])
        return tm.logits(out[:, -1]), dict(states, caches=caches)

    jinit = {"memory": jmem, "bias": jb,
             "caches": jm.transformer.decoder.gen_cache(jmem)}
    tinit = {"memory": tmem, "bias": tb,
             "caches": tm.transformer.decoder.gen_cache(tmem)}
    return (jcell, jinit), (tcell, tinit)


def test_dynamic_decode_beam_search_matches_jax(pair):
    """``dynamic_decode`` with beam 3 over 8 steps on one carried cell:
    the same tokens and scores (within 1e-4) as JAX's."""
    jm, tm = pair
    src, _, _, bias = seq_batch(128, 8, seed=9)
    src, bias = src[1:], bias[1:]        # one padded source
    (jcell, jinit), (tcell, tinit) = _cells(jm, tm, src, bias)
    jids, jscores = jnn.dynamic_decode(
        jnn.BeamSearchDecoder(jcell, 1, END, BEAM), jinit, max_step_num=8)
    tids, tscores = tnn.dynamic_decode(
        tnn.BeamSearchDecoder(tcell, 1, END, BEAM), tinit, max_step_num=8)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    close(tscores, jscores, atol=1e-4)
    assert tscores.dtype == torch.float32


def test_beam_search_keeps_finished_beams_and_breaks_ties_low():
    """A cell whose logits favour ``end_token`` once: finished beams
    extend only with it, at no cost, and the loop stops when all have
    finished; equal totals keep the lower index, as ``lax.top_k`` does
    (the -1e30 rows of the first step tie)."""
    vocab = 8

    def cell(mod, full):
        def step(ids, states):
            n = states["n"]
            logits = full((BEAM, vocab), 0.0)
            logits = logits + (10.0 if int(n[0]) >= 1 else 0.0) * (
                mod.arange(vocab) == END)
            return logits, {"n": n + 1}
        return step

    jids, jsc = jnn.dynamic_decode(jnn.BeamSearchDecoder(
        cell(jnp, jnp.full), 1, END, BEAM), {"n": jnp.zeros((BEAM,))},
        max_step_num=6)
    tids, tsc = tnn.dynamic_decode(tnn.BeamSearchDecoder(
        cell(torch, lambda s, v: torch.full(s, v)), 1, END, BEAM),
        {"n": torch.zeros(BEAM)}, max_step_num=6)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    close(tsc, jsc, atol=1e-5)
    assert tids.shape[1] < 6 and (tids[:, -1] == END).all()


# -- layers on the card by default --------------------------------------------

LAYERS = [
    ("Linear", lambda **kw: tnn.Linear(4, 3, **kw)),
    ("LayerNorm", lambda **kw: tnn.LayerNorm(4, **kw)),
    ("Embedding", lambda **kw: tnn.Embedding(10, 4, **kw)),
    ("MultiHeadAttention", lambda **kw: tnn.MultiHeadAttention(8, 2, **kw)),
    ("TransformerEncoderLayer",
     lambda **kw: tnn.TransformerEncoderLayer(8, 2, 16, **kw)),
    ("TransformerDecoderLayer",
     lambda **kw: tnn.TransformerDecoderLayer(8, 2, 16, **kw)),
    ("Transformer", lambda **kw: tnn.Transformer(8, 2, 1, 1, 16, **kw)),
    ("Conv2D", lambda **kw: tnn.Conv2D(2, 3, 3, **kw)),
    ("BatchNorm2D", lambda **kw: tnn.BatchNorm2D(3, **kw)),
]


@pytest.mark.parametrize("name,make", LAYERS, ids=[n for n, _ in LAYERS])
def test_layers_build_on_the_card_by_default(name, make):
    """No device: ``cuda:0``, or a ``RuntimeError`` without CUDA (never a
    quiet CPU build); ``device="cpu"`` builds every parameter and buffer
    on the CPU."""
    layer = make(device="cpu")
    tensors = list(layer.parameters()) + list(layer.buffers())
    assert tensors and all(t.device.type == "cpu" for t in tensors)
    if torch.cuda.is_available():
        layer = make()
        assert all(t.device.type == "cuda" for t in layer.parameters())
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tnn.Transformer.generate_square_subsequent_mask(4)
