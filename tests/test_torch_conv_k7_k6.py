"""K7's band-and-window body, its stride-2 input gradient by phases, and K6's
tiles: their cuts, the phase form's plain version, and the entries each
dtype reaches.

K7's 16-bit body (``conv3x3_tc_kernel``) walks items (phase, band, channel
tile) in the order of ``conv.c3_item_box``, over bands from ``conv.c3_bands``,
a function of the shape only: every output pixel of every phase falls in
one item of each channel tile, the bands go image by image and row by row.
The stride-2 input gradient runs as four phases of one launch
(``conv.c3_dgrad_phases``); its plain version is held here against JAX's
``conv2d_dgrad`` (the stride-1 conv of the zero-dilated dy, Pallas
interpret mode) and against ``c3_reference`` on the port's dilated operand.
K6's 16-bit body (``conv1x1_wgrad_tc_kernel``) takes the tile and split of
``conv.k6_plan``. The launch tests stub the C entries and check which one a
dtype reaches, with which arguments. No card: what the kernels compute is
held on the card by ``chip_smoke.py``.

Tolerances: float32 within 1e-5 of the result's scale (sums of up to 36
products a pixel, in another order), bf16 within 2e-2 (one bf16 rounding of
the output), as ``test_torch_conv.py``.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops._pallas import conv as pconv

from tests.test_torch_conv_wgrad_fused import RAGGED

hc = importlib.import_module("paddle_tpu_torch.ops._hopper.conv")

# (n, h, w, cin, cout, stride): ResNet-50's 16 K7 launches at B = 256 (7
# shapes), then K8's ragged list (ragged channels, odd sizes, images wider
# than a band)
K7_SHAPES = [s[:6] for s in hc.RESNET50_K7_SHAPES] + RAGGED


def _walk(n, hy, wy, k, phases, stride):
    """Each item's pixels of y (dx by phase) and channel tile, marked once;
    the bands of each (phase, tile) in order."""
    hg, wg = ((hy + 1) // 2, (wy + 1) // 2) if phases == 4 else (hy, wy)
    bd = hc.c3_bands(n, hg, wg, stride, phases)
    assert bd == hc.c3_bands(n, hg, wg, stride, phases)
    assert bd.band_n * bd.band_h * bd.band_w <= 256 and bd.band_w <= 64
    assert bd.band_n == 1 or (bd.band_h, bd.band_w) == (hg, wg)
    assert hc.k7_smem_bytes(bd.band_n, bd.band_h, bd.band_w, stride,
                            phases) <= 232448
    assert bd.bands == bd.n_bn * bd.n_bh * bd.n_bw
    tiles = -(-k // 64)
    seen = np.zeros((n, hy, wy, tiles), np.int32)
    last = {}
    os_ = 2 if phases == 4 else 1
    for item in range(phases * bd.bands * tiles):
        box = hc.c3_item_box(bd, n, hy, wy, k, phases, item)
        if box is None:
            continue
        ph, pw, k0, n0, imgs, h0, rows, w0, cols = box
        assert 1 <= imgs <= bd.band_n and 1 <= rows <= bd.band_h and \
            1 <= cols <= bd.band_w
        key = (ph, pw, k0)
        assert (n0, h0, w0) > last.get(key, (-1, -1, -1))
        last[key] = (n0, h0, w0)
        seen[n0:n0 + imgs, ph + os_ * h0:ph + os_ * (h0 + rows):os_,
             pw + os_ * w0:pw + os_ * (w0 + cols):os_, k0 // 64] += 1
    assert (seen == 1).all()
    return bd


@pytest.mark.parametrize("n,h,w,cin,cout,stride", K7_SHAPES)
def test_k7_items_cover_every_output_pixel_once_in_order(n, h, w, cin, cout,
                                                         stride):
    """The forward's output, the stride-1 input gradient's dx (the same
    walk on the input's grid) and, at stride 2, dx by its four phases."""
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    _walk(n, ho, wo, cout, 1, stride)
    if stride == 1:
        _walk(n, h, w, cin, 1, 1)
    else:
        _walk(n, h, w, cin, 4, 2)


def test_k7_bands_fill_the_card_at_resnet_shapes():
    """Four output rows a band at 56² (224 pixels), nine at 28², one 14²
    image, five 7² images; every shape has more items than the 132 SMs'
    persistent blocks, the 7² × 512 one three rounds of them."""
    want = {(56, 1): (1, 4, 56), (28, 1): (1, 9, 28), (14, 1): (1, 14, 14),
            (7, 1): (5, 7, 7), (56, 2): (1, 7, 28), (28, 2): (1, 14, 14),
            (14, 2): (4, 7, 7)}
    for n, h, w, cin, cout, s, _ in hc.RESNET50_K7_SHAPES:
        ho = (h - 1) // s + 1
        bd = hc.c3_bands(n, ho, ho, s)
        assert tuple(bd[:3]) == want[(h, s)]
        assert bd.bands * -(-cout // 64) > 132
        if s == 2:   # the input gradient's phases walk dy's grid
            ph = hc.c3_bands(n, ho, ho, 2, 4)
            assert ph.band_n * ph.band_h * ph.band_w >= 196
    assert hc.c3_bands(256, 7, 7, 1).bands * 8 > 3 * 132
    assert sum(s[6] for s in hc.RESNET50_K7_SHAPES) == 16


@pytest.mark.parametrize("n,h,w,cin,cout,stride,per_step",
                         hc.RESNET50_K6_SHAPES)
def test_k6_plan_covers_every_row_once(n, h, w, cin, cout, stride,
                                       per_step):
    """Each split a multiple of the 32-row stage, none empty, all rows in
    one; the tile wastes no channel at ResNet-50's shapes; at most one
    round of the blocks the card holds at once, and at least one block an
    SM at the 56² and 28² shapes."""
    ho = (h - 1) // stride + 1
    m = n * ho * ho
    pl = hc.k6_plan(m, cin, cout)
    assert pl == hc.k6_plan(m, cin, cout)
    assert pl.rows_per_split % 32 == 0
    assert pl.splits * pl.rows_per_split >= m > \
        (pl.splits - 1) * pl.rows_per_split
    tc, tk = 64 * pl.warps_c, 32 * pl.warps_k
    assert cin % tc == 0 and cout % tk == 0
    assert pl.tiles == cin // tc * (cout // tk)
    assert pl.warps_c * pl.warps_k <= 8
    assert hc.k6_smem_bytes(pl.warps_c, pl.warps_k) <= 232448
    blocks = pl.tiles * pl.splits
    per_sm = min(16 // (pl.warps_c * pl.warps_k),
                 232448 // (hc.k6_smem_bytes(pl.warps_c, pl.warps_k) + 1024))
    assert blocks <= 132 * per_sm
    if ho >= 28:
        assert blocks >= 132


def test_k6_plan_tiles_at_resnet_shapes():
    """256 x 64 at 256 -> 64 (x and dy each read once), 64 x 256 at
    64 -> 256, 128 x 128 at the wider shapes; 36 launches a step; ragged
    channels keep a tile that covers them."""
    assert hc.k6_plan(802816, 256, 64)[:2] == (4, 2)
    assert hc.k6_plan(802816, 64, 256)[:2] == (1, 8)
    assert hc.k6_plan(802816, 64, 64)[:2] == (1, 2)
    assert hc.k6_plan(200704, 512, 128)[:2] == (2, 4)
    assert sum(s[6] for s in hc.RESNET50_K6_SHAPES) == 36
    for m, c, k in ((98, 20, 36), (1, 8, 8), (2147, 40, 72)):
        pl = hc.k6_plan(m, c, k)
        assert pl.splits * pl.rows_per_split >= m > \
            (pl.splits - 1) * pl.rows_per_split


def _dgrad_inputs(n, h, w, k, c, key):
    rng = np.random.default_rng(key)
    ho, wo = (h + 1) // 2, (w + 1) // 2
    dy = rng.standard_normal((n, ho, wo, k)).astype(np.float32)
    wgt = (rng.standard_normal((k, c, 3, 3)) * 0.2).astype(np.float32)
    return dy, wgt


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("n,h,w,k,c", [(2, 7, 7, 8, 8), (1, 9, 5, 16, 8)])
def test_dgrad_phases_plain_version_matches_jax(n, h, w, k, c, dt):
    """The phase form's plain version against JAX's conv2d_dgrad at stride
    2 (the dilated dy, Pallas interpret mode) on odd sizes (a 7-row input's
    dy has 4 rows; its odd phase 3), and bit for bit against c3_reference
    on the port's dilated operand."""
    dy, wgt = _dgrad_inputs(n, h, w, k, c, key=h * 10 + w)
    jdt = jnp.float32 if dt == "f32" else jnp.bfloat16
    tdt = torch.float32 if dt == "f32" else torch.bfloat16
    want = np.asarray(jnp.asarray(pconv.conv2d_dgrad(
        jnp.asarray(dy, jdt), jnp.asarray(wgt, jdt), (n, h, w, c), (2, 2),
        (1, 1)), jnp.float32))
    tdy, tw = torch.from_numpy(dy).to(tdt), torch.from_numpy(wgt).to(tdt)
    got = hc.c3_dgrad_phases_reference(tdy, hc.dgrad_taps(tw, tdt), (h, w))
    assert got.dtype == tdt and got.shape == (n, h, w, c)
    tol = 1e-5 if dt == "f32" else 2e-2
    ref = float(np.abs(want).max())
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol * ref)
    op, wt = hc.dgrad_operands(tdy, tw, 2)
    dilated, _, _ = hc.c3_reference(op, wt, None, None, "none", False, 1,
                                    (h, w))
    assert torch.equal(got, dilated)
    # conv2d_dgrad's CPU route in 16 bits is the phase form
    assert torch.equal(hc.conv2d_dgrad(tdy, tw, (n, h, w, c), (2, 2),
                                       (1, 1)), got)


def test_dgrad_phases_take_a_one_row_input():
    """A 1 x 1 input: dy 1 x 1, dx's odd phases empty."""
    dy, wgt = _dgrad_inputs(1, 1, 1, 4, 4, key=3)
    tdy, tw = torch.from_numpy(dy), torch.from_numpy(wgt)
    got = hc.c3_dgrad_phases_reference(tdy, hc.dgrad_taps(tw, tdy.dtype),
                                       (1, 1))
    torch.testing.assert_close(got[0, 0, 0], tdy[0, 0, 0] @ tw[:, :, 1, 1],
                               rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="stride-2 output"):
        hc.c3_dgrad_phases_reference(tdy, hc.dgrad_taps(tw, tdy.dtype),
                                     (3, 3))


class _Lib:
    """The C entries, stubbed: each returns 0 (no error)."""

    def paddle_conv3x3_tc(self, *a):
        return 0

    def paddle_conv_fwd(self, *a):
        return 0

    def paddle_conv1x1_wgrad_tc(self, *a):
        return 0

    def paddle_conv_wgrad(self, *a):
        return 0


@pytest.fixture
def launches(monkeypatch):
    """Route every wrapper to the stubbed entries as if its tensors lay on
    the card; returns the list of (entry, arguments) calls."""
    calls = []
    monkeypatch.setattr(hc, "_library", lambda: _Lib())
    monkeypatch.setattr(hc, "_device", lambda *ts: torch.device("cuda"))
    monkeypatch.setattr(hc, "_run", lambda lib, fn, what, x, *a:
                        calls.append((fn.__name__, a)))
    for name in ("mm", "mm_wgrad", "c3", "c3_wgrad"):
        monkeypatch.setattr(getattr(hc, name), "launches", 0)
    return calls


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_k7_forward_in_16_bits_reaches_the_band_body(dtype, launches):
    n, h, c, k = 3, 7, 24, 72
    x = torch.zeros(n, h, h, c, dtype=dtype)
    wt = torch.zeros(9, c, k, dtype=dtype)
    sc = torch.ones(c)
    hc.c3(x, wt, sc, sc, "relu", True, 2)
    bd = hc.c3_bands(n, 4, 4, 2)
    (name, a), = launches
    assert name == "paddle_conv3x3_tc" and hc.c3.launches == 1
    assert a[8:] == (n, h, h, c, 4, 4, k, 2, 1, 1, 1, bd.band_n, bd.band_h,
                     bd.band_w, hc._DTYPE_CODE[dtype])
    assert None not in a[4:8]   # the stats' scratch
    # the parent's body stays a yardstick on the old entry, uncounted
    hc.c3_tap_gather(x, wt, sc, sc, "relu", True, 2)
    assert launches[1][0] == "paddle_conv_fwd" and hc.c3.launches == 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_k7_stride2_dgrad_in_16_bits_is_one_launch_of_four_phases(
        dtype, launches):
    n, h, w, c, k = 2, 9, 7, 24, 40
    dy = torch.zeros(n, 5, 4, k, dtype=dtype)
    wgt = torch.zeros(k, c, 3, 3, dtype=dtype)
    dx = hc.conv2d_dgrad(dy, wgt, (n, h, w, c), (2, 2), (1, 1))
    bd = hc.c3_bands(n, 5, 4, 2, 4)
    (name, a), = launches
    assert name == "paddle_conv3x3_tc" and hc.c3.launches == 1
    assert dx.shape == (n, h, w, c) and dx.dtype == dtype
    assert a[8:] == (n, 5, 4, k, h, w, c, 2, 4, 0, 0, bd.band_n, bd.band_h,
                     bd.band_w, hc._DTYPE_CODE[dtype])
    assert a[2:4] == (None, None) and a[5:8] == (None, None, None)


def test_f32_conv3x3_keeps_the_cuda_core_entry_and_dilated_dgrad(launches):
    n, h, c, k = 2, 7, 8, 16
    x = torch.zeros(n, h, h, c)
    hc.c3(x, torch.zeros(9, c, k), None, None, "none", True, 1)
    hc.conv2d_dgrad(torch.zeros(n, 4, 4, k), torch.zeros(k, c, 3, 3),
                    (n, h, h, c), (2, 2), (1, 1))
    names = [name for name, _ in launches]
    assert names == ["paddle_conv_fwd", "paddle_conv_fwd"]
    # the dgrad: the stride-1 conv of the dilated dy (7 x 7), nine taps
    a = launches[1][1]
    assert a[8:15] == (n, 7, 7, k, h, h, c) and a[15:18] == (9, 1, 1)
    with pytest.raises(ValueError, match="bfloat16 or float16"):
        hc.c3_dgrad_phases(torch.zeros(n, 4, 4, k), torch.zeros(9, k, c),
                           (h, h))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_k6_reaches_the_body_of_its_dtype(dtype, launches):
    n, h, c, k = 4, 14, 256, 64
    x = torch.zeros(n, h, h, c, dtype=dtype)
    dy = torch.zeros(n, 7, 7, k, dtype=dtype)
    dw = hc.mm_wgrad(x, dy, None, None, "none", 2)
    assert dw.shape == (c, k) and dw.dtype == torch.float32
    assert hc.mm_wgrad.launches == 1
    (name, a), = launches
    if dtype == torch.float32:
        assert name == "paddle_conv_wgrad"
        return
    pl = hc.k6_plan(n * 49, c, k)
    assert name == "paddle_conv1x1_wgrad_tc"
    assert a[7:] == (n, h, h, c, 7, 7, k, 2, 0, pl.warps_c, pl.warps_k,
                     pl.splits, pl.rows_per_split, hc._DTYPE_CODE[dtype])
    assert (a[5] is None) == (pl.splits == 1)
    hc.mm_wgrad_tiles64(x, dy, None, None, "none", 2)
    assert launches[1][0] == "paddle_conv_wgrad" and \
        hc.mm_wgrad.launches == 1


def test_cpu_tensors_reach_the_plain_versions_only():
    """No launch is counted, and the yardsticks refuse the CPU."""
    before = (hc.c3.launches, hc.mm_wgrad.launches)
    x = torch.randn(1, 5, 5, 8, dtype=torch.bfloat16)
    hc.c3(x, torch.randn(9, 8, 4, dtype=torch.bfloat16))
    hc.mm_wgrad(x, torch.randn(1, 5, 5, 4, dtype=torch.bfloat16))
    hc.c3_dgrad_phases(torch.randn(1, 3, 3, 4, dtype=torch.bfloat16),
                       torch.randn(9, 4, 8, dtype=torch.bfloat16), (5, 5))
    assert (hc.c3.launches, hc.mm_wgrad.launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        hc.c3_tap_gather(x, torch.randn(9, 8, 4, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="CUDA"):
        hc.mm_wgrad_tiles64(x, torch.randn(1, 5, 5, 4, dtype=torch.bfloat16))
