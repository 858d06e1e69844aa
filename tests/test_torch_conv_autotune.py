"""Port parity: the conv autotune (``paddle_tpu/ops/_pallas/conv.py``
``tune_conv_shapes``, ``_mm_key``, ``_c3_key``, ``_pick_block_*``) and the
flash block flags (``ops/_pallas/flash_attention.py`` ``_pick_blocks``,
``tune_flash_blocks``).

- The keys print as JAX's, and each K5/K7 launch (forward, input gradient,
  both strides) hands its plan the key under which JAX's kernels read the
  cache for the same conv: JAX's ``_tuned`` is spied on in interpret mode,
  the port's launches are stubbed (no card here).
- ``tune_conv_shapes(device="cpu")`` times the plain version per
  candidate, stores each winner under the device key ``"cpu"`` and the
  plans read it in the same process (outside ``k5_plan``'s memo); an entry
  that is not a candidate (another layout, a ring or band that overflows
  shared memory, JAX's integer block) is ignored.
- ``flash_block_q``/``flash_block_k`` are checked with JAX's messages; a
  valid value changes no output; ``tune_flash_blocks`` takes 128/128 only.

What a choice computes on the card is held by ``chip_smoke.py``'s
``tune_conv`` phase.
"""

import importlib
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core import flags as jflags
from paddle_tpu.ops._pallas import conv as jconv
from paddle_tpu.ops._pallas import flash_attention as jfa
from paddle_tpu_torch.core import flags as tflags
from _torch_threads import one_torch_thread  # noqa: F401

hc = importlib.import_module("paddle_tpu_torch.ops._hopper.conv")
hfa = importlib.import_module("paddle_tpu_torch.ops._hopper.flash_attention")
at = importlib.import_module("paddle_tpu_torch.ops._hopper.autotune")
tfa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")

DTYPES = [("bfloat16", torch.bfloat16, jnp.bfloat16),
          ("float16", torch.float16, jnp.float16),
          ("float32", torch.float32, jnp.float32)]


@pytest.fixture
def cache_file(tmp_path):
    """The port's autotune cache on a file under ``tmp_path``."""
    old = at._cache
    tflags.set_flags({"kernel_autotune_cache_path":
                      str(tmp_path / "autotune.json")})
    at._cache = None
    yield tmp_path / "autotune.json"
    at._cache = old
    tflags.set_flags({"kernel_autotune_cache_path": ""})


@pytest.mark.parametrize("name,tdt,jdt", DTYPES)
def test_keys_print_as_jax(name, tdt, jdt):
    for kind, n, h, w, cin, cout, s in hc.RESNET50_TOP3_SHAPES:
        m = n * h * w
        assert hc._mm_key(m, cin, cout, tdt) == \
            jconv._mm_key(m, cin, cout, jdt)
        assert hc._c3_key(n, h, w, cin, cout, s, tdt) == \
            jconv._c3_key(n, h, w, cin, cout, s, jdt)
    assert hc._mm_key(802816, 256, 64, tdt) == \
        f"m802816_ci256_co64_{name}"
    assert hc._K5_TUNED == "pallas_conv1x1" and \
        hc._K7_TUNED == "pallas_conv3x3"
    assert hc.RESNET50_TOP3_SHAPES == jconv.RESNET50_TOP3_SHAPES


# -- the keys each launch reads -----------------------------------------------

class _Lib:
    """conv.cu's entries as names: each returns 0 (launched)."""

    def __getattr__(self, name):
        if not name.startswith("paddle_"):
            raise AttributeError(name)
        return lambda *a: 0


KEY_CONVS = [(k, s) for k in (1, 3) for s in (1, 2)]


def _jax_keys(k, s):
    """The (kernel, key) pairs JAX's conv2d_fwd and conv2d_dgrad read from
    the cache for a bf16 conv of 2 x 8 x 8 x 16 -> 32 channels."""
    seen = []
    real = jconv._tuned
    jconv._tuned = lambda kernel, key: seen.append((kernel, key)) or None
    try:
        x = jnp.ones((2, 8, 8, 16), jnp.bfloat16)
        w = jnp.ones((32, 16, k, k), jnp.bfloat16)
        pad = (0, 0) if k == 1 else (1, 1)
        y, _, _ = jconv.conv2d_fwd(x, w, stride=(s, s), padding=pad)
        jconv.conv2d_dgrad(jnp.ones(y.shape, jnp.bfloat16), w, x.shape,
                           (s, s), pad)
    finally:
        jconv._tuned = real
    return seen


@pytest.mark.parametrize("k,s", KEY_CONVS)
def test_launches_read_the_keys_jax_reads(k, s, monkeypatch):
    """The forward and the input gradient of a bf16 1x1 or 3x3 conv at
    stride 1 or 2 hand K5's plan or K7's bands JAX's key of the same conv
    (the stride-2 3x3 input gradient, by phase in the port, keys as JAX's
    dilated dgrad: dx's size at stride 1)."""
    seen = []
    real_k5, real_c3 = hc.k5_plan, hc.c3_bands

    def k5_spy(m, c, kk, key=None):
        seen.append(("pallas_conv1x1", key))
        return real_k5(m, c, kk, key)

    def c3_spy(n, hg, wg, stride, phases=1, key=None):
        seen.append(("pallas_conv3x3", key))
        return real_c3(n, hg, wg, stride, phases, key)

    monkeypatch.setattr(hc, "k5_plan", k5_spy)
    monkeypatch.setattr(hc, "c3_bands", c3_spy)
    monkeypatch.setattr(hc, "_library", lambda: _Lib())
    monkeypatch.setattr(hc, "_device", lambda *ts: torch.device("cuda"))
    monkeypatch.setattr(hc, "_run", lambda *a: None)
    for name in ("mm", "c3"):
        monkeypatch.setattr(getattr(hc, name), "launches", 0)
    x = torch.ones(2, 8, 8, 16, dtype=torch.bfloat16)
    w = torch.ones(32, 16, k, k, dtype=torch.bfloat16)
    pad = (0, 0) if k == 1 else (1, 1)
    y, _, _ = hc.conv2d_fwd(x, w, stride=(s, s), padding=pad)
    hc.conv2d_dgrad(torch.ones(y.shape, dtype=torch.bfloat16), w, x.shape,
                    (s, s), pad)
    assert seen == _jax_keys(k, s)


# -- the sweep and the cache reads -------------------------------------------

SMALL = (("conv1x1", 2, 8, 8, 32, 16, 1), ("conv1x1", 2, 8, 8, 16, 48, 2),
         ("conv3x3", 2, 8, 8, 16, 16, 1), ("conv3x3", 2, 9, 9, 16, 24, 2))


def test_sweep_persists_winners_and_the_plans_read_them(cache_file):
    # the plans' own choices, memoised before the sweep
    own = {}
    for kind, n, h, w, cin, cout, s in SMALL:
        if kind == "conv1x1":
            m = n * ((h - 1) // s + 1) * ((w - 1) // s + 1)
            key = hc._mm_key(m, cin, cout, torch.bfloat16)
            own[key] = hc.k5_plan(m, cin, cout, key)
    won = hc.tune_conv_shapes(SMALL, device="cpu")
    data = json.loads(cache_file.read_text())
    assert len(won) == len(SMALL) == len(data)
    for kind, n, h, w, cin, cout, s in SMALL:
        if kind == "conv1x1":
            ho, wo = (h - 1) // s + 1, (w - 1) // s + 1
            m = n * ho * wo
            kernel, key = "pallas_conv1x1", hc._mm_key(m, cin, cout,
                                                       torch.bfloat16)
            choice = won[(kernel, key)]
            assert choice in hc.k5_candidates(cin)
            assert hc.k5_plan(m, cin, cout, key) == \
                hc._k5_plan_of(m, cout, *choice)
            # a valid entry other than the model's takes effect at once,
            # past the memo of the plan computed before
            other = next(c for c in hc.k5_candidates(cin)
                         if hc._k5_plan_of(m, cout, *c) != own[key])
            at.get_cache().put(kernel, key, list(other), 1.0)
            assert hc.k5_plan(m, cin, cout, key) == \
                hc._k5_plan_of(m, cout, *other)
            assert hc.k5_plan(m, cin, cout) == own[key]
        else:
            ho, wo = (h + 2 - 3) // s + 1, (w + 2 - 3) // s + 1
            kernel, key = "pallas_conv3x3", hc._c3_key(n, h, w, cin, cout,
                                                       s, torch.bfloat16)
            choice = won[(kernel, key)]
            assert choice in hc.c3_candidates(n, ho, wo, s)
            assert hc.c3_bands(n, ho, wo, s, 1, key) == \
                hc._c3_bands_of(n, ho, wo, *choice)
        ent = data[f"{kernel}|cpu|{key}"]
        assert ent["schema"] == at.CACHE_SCHEMA and \
            tuple(ent["config"]) == choice
    # a fresh process reads the file: the cache object made anew
    at._cache = None
    kind, n, h, w, cin, cout, s = SMALL[2]
    key = hc._c3_key(n, h, w, cin, cout, s, torch.bfloat16)
    assert at.get_cache().get("pallas_conv3x3", key) is not None
    # a cached choice short-circuits a second sweep
    assert hc.tune_conv_shapes(SMALL[2:3], device="cpu") == \
        {("pallas_conv3x3", key): won[("pallas_conv3x3", key)]}
    # the cache off: the cost models
    tflags.set_flags({"kernel_autotune": 0})
    try:
        m = 2 * 8 * 8
        assert hc.k5_plan(m, 32, 16, hc._mm_key(m, 32, 16,
                                                torch.bfloat16)) == \
            hc.k5_plan(m, 32, 16)
    finally:
        tflags.set_flags({"kernel_autotune": 1})


def test_sweep_refuses_float32_and_drops_refused_launches(tmp_path):
    with pytest.raises(ValueError, match="16-bit bodies"):
        hc.tune_conv_shapes(SMALL[:1], dtype=torch.float32, device="cpu")
    # a candidate whose launch is refused is dropped from the sweep; any
    # other error stops it
    from paddle_tpu_torch.ops._hopper import KernelLaunchError

    def launch(choice):
        if choice == "refused":
            raise KernelLaunchError("too much shared memory")
        if choice == "broken":
            raise RuntimeError("illegal address")
        return torch.zeros(1)

    cache = at.AutotuneCache(str(tmp_path / "c.json"))
    times = {"refused": 0.1, "slow": 2.0, "fast": 1.0}
    for cands, want in ((["refused", "slow", "fast"], "fast"),
                        (["refused", "slow"], "slow")):
        got = at.autotune("k5", "key" + str(len(cands)), cands,
                          lambda c: hc._refused_as_skip(launch, c),
                          measure=lambda run: (run(), 0)[1] + 1.0,
                          cache=cache, device="cpu")
        assert got in cands and got != "refused"
    assert at.autotune("k5", "one", ["fast"], lambda c: hc._refused_as_skip(
        launch, c), measure=lambda run: (run(), times)[1]["fast"],
        cache=cache, device="cpu") == "fast"
    with pytest.raises(ValueError, match="no candidate ran"):
        at.autotune("k5", "none", ["refused"],
                    lambda c: hc._refused_as_skip(launch, c),
                    measure=lambda run: (run(), 1.0)[1], cache=cache,
                    device="cpu")
    with pytest.raises(RuntimeError, match="illegal address"):
        at.autotune("k5", "broken", ["broken", "fast"],
                    lambda c: hc._refused_as_skip(launch, c),
                    measure=lambda run: (run(), 1.0)[1], cache=cache,
                    device="cpu")


@pytest.mark.parametrize("entry", [[99, 99, 99], [4, 2, 5], 512, "x",
                                   [4, 2]])
def test_k5_ignores_an_entry_that_is_no_candidate(cache_file, entry):
    m, c, k = 512, 64, 256
    key = hc._mm_key(m, c, k, torch.bfloat16)
    at.get_cache().put("pallas_conv1x1", key, entry, 1.0)
    assert hc.k5_plan(m, c, k, key) == hc.k5_plan(m, c, k)


def test_k5_ignores_a_ring_that_overflows_shared_memory(cache_file):
    """At some input width a layout's deeper ring no longer fits a block:
    it is no candidate there, and a cached entry naming it is ignored."""
    c = next(c for c in range(32, 60000, 32)
             if (4, 2, 4) not in hc.k5_candidates(c) and
             (4, 2, 3) in hc.k5_candidates(c))
    assert hc.k5_smem_bytes(4, 2, c, True, 4) > hc._BLOCK_SMEM
    m, k = 1024, 64
    key = hc._mm_key(m, c, k, torch.bfloat16)
    at.get_cache().put("pallas_conv1x1", key, [4, 2, 4], 1.0)
    assert hc.k5_plan(m, c, k, key) == hc.k5_plan(m, c, k)
    at.get_cache().put("pallas_conv1x1", key, [4, 2, 3], 1.0)
    assert hc.k5_plan(m, c, k, key) == hc._k5_plan_of(m, k, 4, 2, 3)


@pytest.mark.parametrize("n,hg,wg,s,phases", [
    (256, 56, 56, 1, 1), (256, 28, 28, 2, 1), (256, 7, 7, 1, 1),
    (4, 14, 14, 2, 4)])
def test_c3_candidates_and_invalid_entries(cache_file, n, hg, wg, s, phases):
    cands = hc.c3_candidates(n, hg, wg, s, phases)
    bd = hc.c3_bands(n, hg, wg, s, phases)
    assert cands[0] == (bd.band_n, bd.band_h, bd.band_w)
    assert len(set(cands)) == len(cands) >= 2
    for c in cands:
        assert hc.k7_smem_bytes(*c, s, phases) <= hc._BLOCK_SMEM
        assert c[0] == 1 or (c[1], c[2]) == (hg, wg)
    key = hc._c3_key(n, hg, wg, 64, 64, s, torch.bfloat16)
    for bad in ([1, hg, 64], [2, 2, 2], [1, 9, 9], 16):
        if isinstance(bad, list) and tuple(bad) in cands:
            continue
        at.get_cache().put("pallas_conv3x3", key, bad, 1.0)
        assert hc.c3_bands(n, hg, wg, s, phases, key) == bd
    at.get_cache().put("pallas_conv3x3", key, list(cands[-1]), 1.0)
    assert hc.c3_bands(n, hg, wg, s, phases, key) == \
        hc._c3_bands_of(n, hg, wg, *cands[-1])


# -- the flash block flags ------------------------------------------------------

@pytest.fixture
def block_flags():
    yield
    for reg in (jflags, tflags):
        reg.set_flags({"flash_block_q": 0, "flash_block_k": 0})


@pytest.mark.parametrize("q,k", [(256, 0), (0, 128), (200, 256),
                                 (256, 100)])
def test_flash_block_flags_validated_as_jax(block_flags, q, k):
    for reg in (jflags, tflags):
        reg.set_flags({"flash_block_q": q, "flash_block_k": k})
    with pytest.raises(ValueError) as jerr:
        jfa._pick_blocks(1024, 1024, 128)
    with pytest.raises(ValueError) as terr:
        hfa._pick_blocks(1024, 1024, 128)
    assert str(terr.value) == str(jerr.value)
    # the attention entry checks them too, as JAX's does on every call
    x = torch.zeros(1, 256, 2, 128)
    with pytest.raises(ValueError):
        tfa.flash_attention(x, x, x)


@pytest.mark.parametrize("q,k", [(256, 512), (128, 128), (1024, 384)])
def test_valid_flash_blocks_change_no_output(block_flags, q, k):
    rng = np.random.default_rng(3)
    qkv = [torch.from_numpy(rng.standard_normal((2, 256, 2, 128)).astype(
        np.float32)) for _ in range(3)]
    before = tfa.flash_attention(*qkv, causal=True)
    for reg in (jflags, tflags):
        reg.set_flags({"flash_block_q": q, "flash_block_k": k})
    assert hfa._pick_blocks(1024, 768, 128) == \
        jfa._pick_blocks(1024, 768, 128)
    after = tfa.flash_attention(*qkv, causal=True)
    assert torch.equal(before, after)


def test_tune_flash_blocks_takes_one_candidate(cache_file):
    rng = np.random.default_rng(4)
    qkv = [torch.from_numpy(rng.standard_normal((1, 256, 2, 64)).astype(
        np.float32)) for _ in range(3)]
    assert hfa._pick_blocks(256, 256, 64) == jfa._pick_blocks(256, 256, 64)
    assert hfa.tune_flash_blocks(*qkv) == (128, 128)
    assert tuple(at.get_cache().get("flash_attention",
                                    "sq256_sk256_d64")) == (128, 128)
    # the tuned entry is what _pick_blocks reads next, as in JAX
    assert hfa._pick_blocks(256, 256, 64) == (128, 128)
    with pytest.raises(ValueError, match="128/128 only"):
        hfa.tune_flash_blocks(*qkv, candidates=[(256, 256), (128, 128)])
