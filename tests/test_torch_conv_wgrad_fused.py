"""The cuts of the redesigned kernels, and the bodies 16-bit inputs reach.

K8's 16-bit body (``conv3x3_wgrad_tc_kernel``) walks bands of whole output
rows (or of whole small images), each block all nine taps of its channel
tile, and splits the bands across blocks by ``conv.wgrad_bands``, a
function of the shape only: every output pixel falls in one band, the
bands go image by image and row by row, and each split takes the same
number of consecutive bands, so the
fixed-order sum of the splits' partials repeats bit for bit. K4b-fused's
tensor-core body runs one thread-block cluster of ``ceil(Sk / 64)`` blocks
a head, which must stay within the portable cluster size (8) for every Sk
that ``plan`` sends to the fused form. The launch tests stub the C entries
and check which one a dtype reaches, with which arguments. No card: what
the kernels compute is held on the card by ``chip_smoke.py``.
"""

import importlib

import numpy as np
import pytest
import torch

hc = importlib.import_module("paddle_tpu_torch.ops._hopper.conv")
hfp = importlib.import_module(
    "paddle_tpu_torch.ops._hopper.flash_attention_packed")

# (n, h, w, cin, cout, stride): ResNet-50's 16 K8 launches at B = 256 (7
# shapes), then ragged channels, odd sizes and images wider than a band
RAGGED = [(3, 7, 5, 20, 36, 2), (2, 9, 9, 40, 72, 2), (1, 1, 1, 8, 8, 1),
          (5, 14, 14, 256, 256, 2), (2, 3, 150, 16, 24, 1),
          (1, 224, 224, 3, 64, 2), (3, 7, 7, 512, 512, 1)]
SHAPES = [s[:6] for s in hc.RESNET50_K8_SHAPES] + RAGGED


@pytest.mark.parametrize("n,h,w,cin,cout,stride", SHAPES)
def test_k8_bands_cover_every_output_pixel_once_in_order(n, h, w, cin, cout,
                                                         stride):
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    bd = hc.wgrad_bands(n, ho, wo, cin, cout, stride)
    assert bd == hc.wgrad_bands(n, ho, wo, cin, cout, stride)
    assert bd.band_n * bd.band_h * bd.band_w <= 256 and bd.band_w <= 64
    assert bd.band_n == 1 or (bd.band_h, bd.band_w) == (ho, wo)
    assert hc.k8_smem_bytes(bd.band_n, bd.band_h, bd.band_w, stride) <= \
        200 * 1024
    assert bd.bands == bd.n_bn * bd.n_bh * bd.n_bw
    # the splits: consecutive bands, all but the last full, none empty
    assert bd.splits * bd.per_split >= bd.bands > \
        (bd.splits - 1) * bd.per_split
    seen = np.zeros((n, ho, wo), np.int32)
    last = (-1, -1, -1)
    for band in range(bd.bands):
        n0, imgs, h0, rows, w0, cols = hc.band_box(bd, n, ho, wo, band)
        assert 1 <= imgs <= bd.band_n and 1 <= rows <= bd.band_h and \
            1 <= cols <= bd.band_w
        assert (n0, h0, w0) > last
        last = (n0, h0, w0)
        seen[n0:n0 + imgs, h0:h0 + rows, w0:w0 + cols] += 1
    assert (seen == 1).all()


def test_k8_split_gives_about_two_waves_at_resnet_shapes():
    """About two waves of the 132 SMs' blocks (one a SM) at every
    ResNet-50 shape; at the 64 -> 64 conv at 56^2 four output rows a band
    (224 pixels: fourteen 16-pixel steps, none ragged), at 7^2 five whole
    images."""
    for n, h, w, cin, cout, stride, _ in hc.RESNET50_K8_SHAPES:
        ho = (h - 1) // stride + 1
        bd = hc.wgrad_bands(n, ho, ho, cin, cout, stride)
        blocks = bd.splits * -(-cin // 64) * -(-cout // 64)
        assert 132 < blocks <= 2 * 264, (h, cin, stride, bd)
    bd = hc.wgrad_bands(256, 56, 56, 64, 64, 1)
    assert (bd.band_n, bd.band_h, bd.band_w, bd.n_bw) == (1, 4, 56, 1)
    assert hc.wgrad_bands(256, 7, 7, 512, 512, 1)[:3] == (5, 7, 7)
    assert sum(s[6] for s in hc.RESNET50_K8_SHAPES) == 16


def test_k4b_cluster_fits_every_sk_plan_sends_to_the_fused_form():
    for heads in (2, 4, 6, 12, 16, 24):
        for sk in range(128, 2049, 128):
            for sq in (128, 256, 384, 512, 1024, 2048):
                try:
                    forms = hfp.plan(sq, sk, heads)
                except ValueError:
                    continue
                if forms.bwd != "fused":
                    continue
                nk = hfp.fused_cluster_size(sk)
                assert nk == -(-sk // 64) and 1 <= nk <= 8, (heads, sq, sk)
    assert hfp.fused_cluster_size(512) == 8
    assert hfp.fused_cluster_size(200) == 4
    assert hfp.fused_cluster_size(513) == 0


class _Stub:
    def __init__(self):
        self.entries = []

    def kernel(self, stem, name, n_ptrs, n_strides):
        return stem, name

    def call(self, lib, fn, what, q, k, *args):
        self.entries.append((lib, fn, what, args[-5]))


@pytest.mark.parametrize("dtype,tc,entry", [
    (torch.float16, True, ("flash_bwd_tc",
                           "paddle_flash_packed_bwd_fused_tc")),
    (torch.bfloat16, True, ("flash_bwd_tc",
                            "paddle_flash_packed_bwd_fused_tc")),
    (torch.bfloat16, False, ("flash_packed", "paddle_flash_packed_bwd")),
    (torch.float32, False, ("flash_packed", "paddle_flash_packed_bwd"))])
def test_k4b_fused_launch_reaches_the_body_of_its_dtype(dtype, tc, entry,
                                                        monkeypatch):
    """16-bit K4b-fused reaches the tensor-core entry and its count,
    float32 (and the bf16 yardstick) the CUDA-core one; float16 has no
    CUDA-core body."""
    stub = _Stub()
    monkeypatch.setattr(hfp, "_kernel", stub.kernel)
    monkeypatch.setattr(hfp, "_call", stub.call)
    monkeypatch.setattr(hfp, "_require", lambda *a, **kw: None)
    for name in ("flash_packed_bwd", "flash_packed_bwd_tc"):
        monkeypatch.setattr(getattr(hfp, name), "launches", 0)
    q = torch.zeros(1, 128, 2, 64, dtype=dtype)
    stats = torch.zeros(1, 2, 128)
    hfp._launch_bwd(q, q, q, q, stats, stats, False, 0.125,
                    (None, None, None), tc=tc if dtype != torch.float32
                    else None)
    code = hfp._DTYPE_CODE[dtype]
    assert stub.entries == [(*entry, "flash_packed_bwd_tc" if tc else
                             "flash_packed_bwd", code)]
    assert (hfp.flash_packed_bwd_tc.launches,
            hfp.flash_packed_bwd.launches) == (int(tc), int(not tc))
    if dtype == torch.float16:
        with pytest.raises(ValueError, match="float16 runs the tensor-core"):
            hfp._launch_bwd(q, q, q, q, stats, stats, False, 0.125,
                            (None, None, None), tc=False)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_k8_launch_hands_the_kernel_its_bands(dtype, monkeypatch):
    """K8's 16-bit launch passes ``wgrad_bands``' cut, the dtype's code and
    a partial buffer of one [9, C, K] row a split; float32 keeps its
    CUDA-core entry."""
    calls = []

    class Lib:
        def paddle_conv3x3_wgrad_tc(self, *a):
            return 0

        def paddle_conv_wgrad(self, *a):
            return 0

    monkeypatch.setattr(hc, "_run", lambda lib, fn, what, x, *a:
                        calls.append((fn.__name__, a)))
    n, h, c, k = 4, 14, 24, 40
    x = torch.zeros(n, h, h, c, dtype=dtype)
    dy = torch.zeros(n, 7, 7, k, dtype=dtype)
    dw = hc._wgrad_tc_launch(Lib(), "K8", x, dy, None, None, "none", 2)
    bd = hc.wgrad_bands(n, 7, 7, c, k, 2)
    name, args = calls[0]
    assert name == "paddle_conv3x3_wgrad_tc" and dw.shape == (9, c, k)
    assert args[7:] == (n, h, h, c, 7, 7, k, 2, 0, bd.band_n, bd.band_h,
                        bd.band_w, bd.per_split, bd.splits,
                        hc._DTYPE_CODE[dtype])
    assert (args[5] is None) == (bd.splits == 1)
    hc._wgrad_launch(Lib(), "K8", x.float(), dy.float(), None, None, "none",
                     2, 1, 9)
    assert calls[1][0] == "paddle_conv_wgrad"
