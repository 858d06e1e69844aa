"""K5's tiles and dk/dv-direct's route: the 16-bit 1x1 body's cut, the stats'
scratch it is given, the entries each dtype reaches, and dk/dv-direct's plain
version against dk/dv's.

K5's 16-bit body (``conv1x1_tc_kernel``, which K9 runs too) takes the tile
of ``conv.k5_plan``, a function of the shape only: every row and output
channel falls in one tile, x is read at most ceil(K / 256) times, and the
stats' partials have one row per row tile. dk/dv-direct in 16 bits runs K3's
tensor-core body (``paddle_flash_bwd_dkv_tc``): its plain version is dk/dv's,
bit for bit. The launch tests stub the C entries and check which one a
dtype reaches, with which arguments. No card: what the kernels compute is
held on the card by ``chip_smoke.py``. No JAX either: dk/dv-direct's plain
version is held against JAX's ``_bwd_dkv_kernel_direct`` by
``test_torch_flash_stream.py`` and ``test_torch_dropout.py``.
"""

import importlib

import pytest
import torch

hc = importlib.import_module("paddle_tpu_torch.ops._hopper.conv")
fmb = importlib.import_module(
    "paddle_tpu_torch.ops._hopper.fused_matmul_bn")
hfp = importlib.import_module(
    "paddle_tpu_torch.ops._hopper.flash_attention_packed")
hfa = importlib.import_module("paddle_tpu_torch.ops._hopper.flash_attention")


def _resnet_k5():
    """(m, c, k) of each of ResNet-50's K5 launch shapes: the forward and
    the input gradient of each 1x1 conv."""
    out = []
    for n, h, w, cin, cout, s, _ in hc.RESNET50_K5_SHAPES:
        m = n * ((h - 1) // s + 1) * ((w - 1) // s + 1)
        out += [(m, cin, cout), (m, cout, cin)]
    return out


K5_SHAPES = _resnet_k5() + [
    # K9 at ResNet-50's bottleneck shape and its ragged cases; odd channels
    (802816, 256, 64), (802816, 64, 256), (600, 64, 256), (77, 96, 80),
    (77, 20, 36), (1031, 20, 36)]


@pytest.mark.parametrize("m,c,k", K5_SHAPES)
def test_k5_plan_covers_every_row_and_channel_once(m, c, k):
    """The tiles cover every row and output channel once (none wholly past
    the edge); x is read at most ceil(K / 256) times; the block fits the
    card's shared memory and thread limit; the grid fits CUDA's."""
    pl = hc.k5_plan(m, c, k)
    assert pl == hc.k5_plan(m, c, k)
    bm, bn = 64 * pl.warps_m, 32 * pl.warps_n
    assert pl.rows == bm and pl.warps_m in (1, 2, 4) and \
        pl.warps_n in (2, 4, 8)
    assert pl.tiles_m * bm >= m > (pl.tiles_m - 1) * bm
    assert pl.tiles_n * bn >= k > (pl.tiles_n - 1) * bn
    assert pl.tiles_n <= -(-k // 256)
    assert pl.warps_m * pl.warps_n == 8 and pl.stages in (3, 4)
    for pro in (True, False):
        assert hc.k5_smem_bytes(pl.warps_m, pl.warps_n, c, pro,
                                pl.stages) <= 232448
    assert pl.tiles_m * pl.tiles_n < 2 ** 31


def test_k5_plan_tiles_at_resnet_shapes():
    """256 x 64 at K = 64, 128 x 128 at K = 128, 64 x 256 wherever K >= 256;
    a ring of three stages where four would leave one block an SM; 72
    launches a step; more channels than the prologue's table holds are
    refused."""
    assert hc.k5_plan(802816, 256, 64)[:2] == (4, 2)
    assert hc.k5_plan(802816, 256, 128)[:2] == (2, 4)
    for m, c, k in ((802816, 64, 256), (200704, 128, 512),
                    (12544, 512, 2048)):
        assert hc.k5_plan(m, c, k)[:2] == (1, 8)
    for m, c, k, stages in ((802816, 256, 64, 3), (802816, 64, 256, 3),
                            (802816, 256, 128, 4), (50176, 1024, 128, 3)):
        pl = hc.k5_plan(m, c, k)
        assert pl.stages == stages
        smem = hc.k5_smem_bytes(pl.warps_m, pl.warps_n, c, True, pl.stages)
        assert 2 * (smem + 1024) <= 233472
    assert 2 * sum(s[6] for s in hc.RESNET50_K5_SHAPES) == 72
    with pytest.raises(ValueError, match="input channels"):
        hc.k5_plan(128, 60000, 64)


class _Lib:
    """conv.cu's entries as names: each returns 0 (launched)."""

    def __getattr__(self, name):
        if not name.startswith("paddle_"):
            raise AttributeError(name)

        def entry(*a):
            return 0
        entry.__name__ = name
        return entry


@pytest.fixture
def launches(monkeypatch):
    """Route the wrappers to the stubbed entries as if their tensors lay on
    the card; returns the list of (entry, arguments) calls."""
    calls = []
    monkeypatch.setattr(hc, "_library", lambda: _Lib())
    monkeypatch.setattr(fmb, "_library", lambda: _Lib())
    for mod in (hc, fmb):
        monkeypatch.setattr(mod, "_device", lambda *ts: torch.device("cuda"))
        monkeypatch.setattr(mod, "_run", lambda lib, fn, what, x, *a:
                            calls.append((fn.__name__, a)))
    monkeypatch.setattr(hc.mm, "launches", 0)
    monkeypatch.setattr(fmb.fused_matmul_bn_fwd, "launches", 0)
    return calls


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("stride", [1, 2])
def test_k5_in_16_bits_reaches_the_tile_body_with_its_plan(dtype, stride,
                                                           launches):
    """mm in 16 bits launches ``paddle_conv1x1_tc`` with the plan's
    layout; the stats' partials have the plan's row tiles (not 128-row
    blocks); the 1x1 input gradient takes the same entry with no prologue
    and no stats; the parent's body stays a yardstick, uncounted."""
    n, h, c, k = 3, 9, 40, 72
    ho = (h - 1) // stride + 1
    x = torch.zeros(n, h, h, c, dtype=dtype)
    w2 = torch.zeros(c, k, dtype=dtype)
    sc = torch.ones(c)
    hc.mm(x, w2, sc, sc, "relu", True, stride)
    pl = hc.k5_plan(n * ho * ho, c, k)
    (name, a), = launches
    assert name == "paddle_conv1x1_tc" and hc.mm.launches == 1
    assert a[8:] == (n, h, h, c, ho, ho, k, stride, 1, 1, pl.warps_m,
                     pl.warps_n, pl.stages, hc._DTYPE_CODE[dtype])
    # a[5] is the stats' partial buffer; its rows are the plan's row tiles
    assert None not in a[4:8]
    dx = hc.conv2d_dgrad(torch.zeros(n, ho, ho, k, dtype=dtype),
                         torch.zeros(k, c, 1, 1, dtype=dtype), (n, h, h, c),
                         (stride, stride))
    assert dx.shape == (n, h, h, c) and hc.mm.launches == 2
    name, a = launches[1]
    dpl = hc.k5_plan(n * ho * ho, k, c)
    assert name == "paddle_conv1x1_tc"
    assert a[2:4] == (None, None) and a[5:8] == (None, None, None)
    assert a[8:] == (n, ho, ho, k, ho, ho, c, 1, 0, 0, dpl.warps_m,
                     dpl.warps_n, dpl.stages, hc._DTYPE_CODE[dtype])
    hc.mm_tiles64(x, w2, sc, sc, "relu", True, stride)
    assert launches[2][0] == "paddle_conv_fwd" and hc.mm.launches == 2


def test_stat_scratch_has_a_row_for_each_row_tile(monkeypatch, launches):
    """The stats' partials: K5's plan's row tiles in 16 bits, 128-row
    blocks in float32 (the CUDA-core body), for mm and for K9."""
    seen = []
    real = hc._stat_scratch

    def spy(blocks, k, device):
        seen.append((blocks, k))
        return real(blocks, k, device)

    monkeypatch.setattr(hc, "_stat_scratch", spy)
    monkeypatch.setattr(fmb, "_stat_scratch", spy)
    m, c, k = 1024, 256, 64
    pl = hc.k5_plan(m, c, k)
    for dtype in (torch.bfloat16, torch.float32):
        hc.mm(torch.zeros(1, 1, m, c, dtype=dtype),
              torch.zeros(c, k, dtype=dtype))
        fmb.fused_matmul_bn_fwd(torch.zeros(m, c, dtype=dtype),
                                torch.zeros(c, k, dtype=dtype),
                                torch.ones(c), torch.zeros(c))
    assert seen == [(pl.tiles_m, k)] * 2 + [(-(-m // 128), k)] * 2
    assert pl.tiles_m != -(-m // 128)
    blocks, _ = seen[0]
    partial, tmp, st = real(blocks, k, "cpu")
    assert partial.shape == (pl.tiles_m, 2 * k) and st.shape == (2 * k,)
    assert tmp.shape == (1, 2 * k)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_k9_reaches_the_body_of_its_dtype(dtype, launches):
    """K9's entry carries K5's plan in 16 bits (its layout and ring; 0s,
    unread, in float32), each launch counted once."""
    m, c, k = 77, 96, 80
    y, s, ss = fmb.fused_matmul_bn_fwd(
        torch.zeros(m, c, dtype=dtype), torch.zeros(c, k, dtype=dtype),
        torch.ones(c), torch.zeros(c))
    assert y.shape == (m, k) and fmb.fused_matmul_bn_fwd.launches == 1
    (name, a), = launches
    assert name == "paddle_fused_matmul_bn_fwd"
    pl = hc.k5_plan(m, c, k)
    want = (0, 0, 0) if dtype == torch.float32 else \
        (pl.warps_m, pl.warps_n, pl.stages)
    assert a[8:] == (m, c, k, 1, 1, *want, hc._DTYPE_CODE[dtype])


# -- dk/dv-direct -------------------------------------------------------------

H = 2


def _inputs(dtype, sq=96, sk=200, b=2):
    g = torch.Generator().manual_seed(3)
    q, do = (torch.randn(b, sq, H, 64, generator=g).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(b, sk, H, 64, generator=g).to(dtype)
            for _ in range(2))
    seg_q = torch.sort(torch.randint(1, 4, (b, sq), generator=g),
                       dim=1).values.int()
    seg_k = torch.sort(torch.randint(1, 4, (b, sk), generator=g),
                       dim=1).values.int()
    lengths = torch.randint(sk // 4, sk + 1, (b,), generator=g)
    bias = torch.where(torch.arange(sk)[None, :] >= lengths[:, None],
                       -1e9, 0.0) + torch.randn(b, sk, generator=g)
    masks = (seg_q, seg_k, bias.float())
    o, lse = hfp.flash_packed_fwd_stream(q, k, v, True, None, masks)
    return q, k, v, do, lse, hfp._delta(o, do), masks


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_dkv_direct_plain_version_is_dkv_s_bit_for_bit(dtype):
    """``flash_packed_bwd_dkv_direct_reference(mma_sums=True)`` equals
    ``flash_packed_bwd_dkv_reference(mma_sums=True)`` bit for bit (causal
    with Sq != Sk, segments, the key bias, dropout 0.1): the tensor-core
    body that runs dk/dv runs dk/dv-direct, so the card holds both to one
    plain version."""
    q, k, v, do, lse, delta, masks = _inputs(dtype)
    drop = hfa.AttnDropout(0.1, 77)
    args = (q, k, v, do, lse, delta, True, None, masks, drop)
    direct = hfp.flash_packed_bwd_dkv_direct_reference(*args, mma_sums=True)
    streamed = hfp.flash_packed_bwd_dkv_reference(*args, mma_sums=True)
    for a, b in zip(direct, streamed):
        assert a.dtype == dtype and torch.equal(a, b)
    # and mma_sums reaches the sums (it changes dp's order only)
    plain = hfp.flash_packed_bwd_dkv_direct_reference(*args)
    assert any(not torch.equal(a, b) for a, b in zip(direct, plain))


class _Stub:
    """``_kernel``/``_call`` stand-ins that record the entry each launch
    would reach and the dtype code it would pass."""

    def __init__(self):
        self.entries = []

    def kernel(self, stem, name, n_ptrs, n_strides):
        return stem, name

    def call(self, lib, fn, what, q, k, *args):
        self.entries.append((lib, fn, what, args[-5]))


@pytest.fixture
def stub(monkeypatch):
    s = _Stub()
    monkeypatch.setattr(hfp, "_kernel", s.kernel)
    monkeypatch.setattr(hfp, "_call", s.call)
    monkeypatch.setattr(hfp, "_require", lambda *a, **kw: None)
    monkeypatch.setattr(hfp, "_bwd_inputs",
                        lambda *a, **kw: torch.device("cuda"))
    for name in ("flash_packed_bwd_dkv_direct",
                 "flash_packed_bwd_dkv_direct_tc"):
        monkeypatch.setattr(getattr(hfp, name), "launches", 0)
    return s


def _small(dtype, sq=128, sk=256):
    g = torch.Generator().manual_seed(0)
    q, do = (torch.randn(1, sq, H, 64, generator=g).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(1, sk, H, 64, generator=g).to(dtype)
            for _ in range(2))
    return q, k, v, do, torch.zeros(1, H, sq), torch.zeros(1, H, sq)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_dkv_direct_reaches_the_body_of_its_dtype(dtype, stub):
    """bf16 and float16 reach K3's tensor-core entry and
    ``flash_packed_bwd_dkv_direct_tc``'s count; float32 the CUDA-core entry
    and ``flash_packed_bwd_dkv_direct``'s; the ``_tc`` wrapper refuses
    float32; ``tc=False`` runs the 16-bit CUDA-core body, the yardstick,
    counted with float32's, and only for dk/dv-direct."""
    args = _small(dtype)
    hfp.flash_packed_bwd_dkv_direct(*args)
    code = hfa._DTYPE_CODE[dtype]
    tc = dtype != torch.float32
    want = ("flash_bwd_tc", "paddle_flash_bwd_dkv_tc",
            "flash_packed_bwd_dkv_direct_tc", code) if tc else \
        ("flash_packed_stream", "paddle_flash_packed_bwd_dkv_direct",
         "flash_packed_bwd_dkv_direct", code)
    assert stub.entries == [want]
    assert (hfp.flash_packed_bwd_dkv_direct_tc.launches,
            hfp.flash_packed_bwd_dkv_direct.launches) == (int(tc),
                                                          int(not tc))
    if not tc:
        with pytest.raises(ValueError, match="takes bfloat16"):
            hfp.flash_packed_bwd_dkv_direct_tc(*args)
        return
    hfp.flash_packed_bwd_dkv_direct_tc(*args)
    q, k, v, do, lse, delta = args
    hfp._launch_bwd_split("dkv_direct", q, k, v, do, lse, delta, False, 0.125,
                          (None, None, None), tc=False)
    assert stub.entries[1:] == [
        want, ("flash_packed_stream", "paddle_flash_packed_bwd_dkv_direct",
               "flash_packed_bwd_dkv_direct", code)]
    with pytest.raises(ValueError, match="no 16-bit CUDA-core"):
        hfp._launch_bwd_split("dkv", q, k, v, do, lse, delta, False, 0.125,
                              (None, None, None), tc=False)


def test_dkv_direct_refuses_unaligned_rows_before_any_launch(stub):
    """No fallback: a 16-bit input whose rows are not 16-byte aligned is
    refused, as dk/dv's tensor-core body refuses it."""
    q, k, v, do, lse, delta = _small(torch.bfloat16)
    wide = torch.zeros(1, 128, 2 * H + 1, 64, dtype=torch.bfloat16)
    odd = wide.view(1, 128, -1)[..., 4:4 + H * 64].view(1, 128, H, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        hfp.flash_packed_bwd_dkv_direct(odd, k, v, do, lse, delta)
    assert stub.entries == []
