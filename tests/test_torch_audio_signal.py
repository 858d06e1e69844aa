"""Port parity: ``fft.py``, ``signal.py`` and ``audio/`` against the JAX
package on the CPU, and the root's re-exports of this slice.

- The 22 ``fft`` names on real and complex float32 inputs, with each
  ``norm``, lengths ``n``/``s`` and axes: the same dtype (complex64 from
  float32) and values within 1e-5 of the output's largest magnitude;
  ``hfft2``/``ihfft2``/``hfftn``/``ihfftn`` against JAX's own definitions;
  a float64 input keeps 64 bits in the port (a deliberate difference);
  where JAX raises (complex input to ``rfft2``/``ihfftn``) the port
  raises too.
- ``frame`` and ``overlap_add`` in both ``axis`` forms, exactly;
  ``stft`` (centred window, every padding mode, ``normalized``,
  two-sided, complex input) and ``istft`` (``length``, two-sided, and a
  window that fails NOLA, where ``torch.istft`` raises and JAX's formula
  gives a value) within 1e-5 of the largest magnitude.
- ``audio.functional`` (both mel scales, the filter bank with each norm,
  ``power_to_db``, the DCT, every window), the four feature layers, the
  WAV backend and the synthetic datasets: float32 within 1e-5 of the
  largest magnitude (decibels within 1e-3 dB, since ``log10`` of float32
  values rounded apart by an ulp moves them by up to 4e-6 dB a unit), the
  files and the integer samples exactly.
- Every public name of JAX's ``fft.py``, ``signal.py`` and ``audio/``,
  and the root's ``text``, ``audio``, ``fft``, ``signal`` and
  ``shard_index``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jroot
import paddle_tpu.audio as JA
import paddle_tpu.fft as JFFT
import paddle_tpu.signal as JS
import paddle_tpu_torch as troot
import paddle_tpu_torch.audio as TA
import paddle_tpu_torch.fft as TFFT
import paddle_tpu_torch.signal as TS
from paddle_tpu_torch.core.device import device_guard
from _torch_threads import one_torch_thread  # noqa: F401

T = torch.as_tensor
RNG = np.random.default_rng(0)
REAL = RNG.standard_normal((6, 10)).astype(np.float32)
CPLX = (RNG.standard_normal((6, 10))
        + 1j * RNG.standard_normal((6, 10))).astype(np.complex64)


@pytest.fixture(scope="module", autouse=True)
def cpu_device():
    with device_guard("cpu"):
        yield


def close(ref, got, tol=1e-5):
    ref = np.asarray(ref)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    assert str(ref.dtype) == str(got.dtype), (ref.dtype, got.dtype)
    nan = np.isnan(ref)
    assert np.array_equal(nan, np.isnan(got))    # 0/0 in both (a 1-point
    ref, got = ref[~nan], got[~nan]              # symmetric window)
    scale = max(float(np.abs(ref).max()) if ref.size else 0.0, 1.0)
    assert float(np.abs(got - ref).max() if ref.size else 0.0) \
        <= tol * scale


def outcome(fn, *args, **kw):
    try:
        return fn(*args, **kw)
    except Exception as e:  # compare the exception kinds, not messages
        return e


ONE_D = ["fft", "ifft", "rfft", "irfft", "hfft", "ihfft"]
N_D = ["fft2", "ifft2", "rfft2", "irfft2", "fftn", "ifftn", "rfftn",
       "irfftn", "hfft2", "ihfft2", "hfftn", "ihfftn"]


@pytest.mark.parametrize("norm", ["backward", "ortho", "forward"])
@pytest.mark.parametrize("name", ONE_D + N_D)
def test_fft_names(name, norm):
    for x in (REAL, CPLX):
        kws = [{}]
        if name in ONE_D:
            kws += [{"n": 7, "axis": 0}, {"n": 14}]
        else:
            kws += [{"s": (4, 12)}, {"axes": (0,) if name.endswith("n")
                                     else (1, 0)}]
        for kw in kws:
            want = outcome(getattr(JFFT, name), x, norm=norm, **kw)
            got = outcome(getattr(TFFT, name), T(x), norm=norm, **kw)
            if isinstance(want, Exception):
                assert isinstance(got, Exception), (name, kw)
                continue
            close(want, got)


def test_fft_helpers_and_float64():
    for name in ("fftfreq", "rfftfreq"):
        for n, d in ((10, 1.0), (7, 0.25)):
            close(getattr(JFFT, name)(n, d), getattr(TFFT, name)(n, d))
        close(getattr(JFFT, name)(8, 0.5, "float32"),
              getattr(TFFT, name)(8, 0.5, "float32"))
    for name in ("fftshift", "ifftshift"):
        for axes in (None, (1,), (0, 1)):
            close(getattr(JFFT, name)(REAL, axes),
                  getattr(TFFT, name)(T(REAL), axes), 0)
    got = TFFT.fft(T(REAL.astype(np.float64)))
    assert got.dtype == torch.complex128
    close(JFFT.fft(REAL), got.to(torch.complex64))


def test_frame_and_overlap_add():
    x = RNG.standard_normal((3, 200)).astype(np.float32)
    for fl, hop in ((32, 10), (50, 50), (200, 7)):
        close(JS.frame(x, fl, hop), TS.frame(T(x), fl, hop), 0)
        close(JS.frame(x.T, fl, hop, axis=0),
              TS.frame(T(x.T.copy()), fl, hop, axis=0), 0)
    fr = RNG.standard_normal((3, 32, 9)).astype(np.float32)
    close(jax.jit(lambda v: JS.overlap_add(v, 10))(fr),
          TS.overlap_add(T(fr), 10))
    fr0 = RNG.standard_normal((9, 32, 2, 3)).astype(np.float32)
    close(jax.jit(lambda v: JS.overlap_add(v, 10, axis=0))(fr0),
          TS.overlap_add(T(fr0), 10, axis=0))
    for M in (JS, TS):
        for bad in (dict(hop_length=0), dict(hop_length=4, axis=1)):
            with pytest.raises(ValueError):
                M.frame(x, 8, **bad)
        with pytest.raises(ValueError):
            M.frame(x, 300, 4)


WIN = np.hanning(48).astype(np.float32)
STFT = [dict(n_fft=64, hop_length=16, win_length=48, window=WIN),
        dict(n_fft=64, normalized=True, pad_mode="constant"),
        dict(n_fft=64, onesided=False, center=False, hop_length=20),
        dict(n_fft=32, pad_mode="edge"), dict(n_fft=32, pad_mode="symmetric"),
        dict(n_fft=50, hop_length=7, window=np.hamming(50).astype(np.float32),
             normalized=True)]


def _t(kw):
    return {k: T(v) if isinstance(v, np.ndarray) else v
            for k, v in kw.items()}


@pytest.mark.parametrize("kw", STFT, ids=[str(i) for i in range(len(STFT))])
def test_stft_istft(kw):
    x = RNG.standard_normal((3, 200)).astype(np.float32)
    want = jax.jit(lambda v: JS.stft(v, **kw))(x)
    got = TS.stft(T(x), **_t(kw))
    close(want, got)
    inv = {k: v for k, v in kw.items() if k != "pad_mode"}
    for length in (None, 150, 230):
        close(jax.jit(lambda v: JS.istft(v, length=length, **inv))(want),
              TS.istft(got, length=length, **_t(inv)))


def test_stft_complex_and_nola():
    xc = (RNG.standard_normal((2, 100))
          + 1j * RNG.standard_normal((2, 100))).astype(np.complex64)
    close(JS.stft(xc, 32, onesided=False), TS.stft(T(xc), 32, onesided=False))
    x = RNG.standard_normal((2, 200)).astype(np.float32)
    w = np.zeros(64, np.float32)
    w[:8] = 1.0           # the squared window's sum is 0 between frames
    spec = JS.stft(x, 64, hop_length=32, window=w)
    tspec = TS.stft(T(x), 64, hop_length=32, window=T(w))
    close(JS.istft(spec, 64, hop_length=32, window=w),
          TS.istft(tspec, 64, hop_length=32, window=T(w)))
    with pytest.raises(RuntimeError):
        torch.istft(tspec, 64, hop_length=32, window=T(w))
    for M, arg in ((JS, xc), (TS, T(xc))):
        with pytest.raises(ValueError):
            M.stft(arg, 32)
    with pytest.raises(ValueError):
        TS.istft(tspec[:, :10], 64)


@pytest.mark.parametrize("htk", [False, True])
def test_mel_scales_and_frequencies(htk):
    f = np.array([0.0, 50.0, 700.0, 999.0, 1000.0, 4000.0, 11025.0],
                 np.float32)
    close(JA.functional.hz_to_mel(f, htk), TA.functional.hz_to_mel(T(f), htk))
    close(JA.functional.hz_to_mel(440.0, htk),
          TA.functional.hz_to_mel(440.0, htk))
    m = np.linspace(0, 40, 9).astype(np.float32)
    close(JA.functional.mel_to_hz(m, htk), TA.functional.mel_to_hz(T(m), htk))
    close(JA.functional.mel_frequencies(40, 20.0, 8000.0, htk),
          TA.functional.mel_frequencies(40, 20.0, 8000.0, htk))
    close(JA.functional.fft_frequencies(16000, 512),
          TA.functional.fft_frequencies(16000, 512))


@pytest.mark.parametrize("norm", ["slaney", 1, 2.0, None])
@pytest.mark.parametrize("htk", [False, True])
def test_fbank(norm, htk):
    close(JA.functional.compute_fbank_matrix(16000, 512, 40, 30.0, None,
                                             htk, norm),
          TA.functional.compute_fbank_matrix(16000, 512, 40, 30.0, None,
                                             htk, norm))


def test_power_to_db_and_dct():
    s = (RNG.random((3, 20, 7)) ** 6).astype(np.float32)
    s[0, 0, 0] = 0.0
    for kw in (dict(), dict(ref_value=2.0, amin=1e-6, top_db=None),
               dict(top_db=30.0)):
        close(JA.functional.power_to_db(s, **kw),
              TA.functional.power_to_db(T(s), **kw), 1e-3 / 80)
    for M in (JA, TA):
        with pytest.raises(ValueError):
            M.functional.power_to_db(s if M is JA else T(s), top_db=-1.0)
    for norm in ("ortho", None):
        close(JA.functional.create_dct(13, 40, norm),
              TA.functional.create_dct(13, 40, norm))
    for M in (JA, TA):
        with pytest.raises(ValueError):
            M.functional.create_dct(13, 40, "backward")


WINDOWS = ["hann", "hamming", "blackman", "bartlett", "cosine", "gaussian",
           ("gaussian", 3.0)]


@pytest.mark.parametrize("window", WINDOWS, ids=[str(w) for w in WINDOWS])
@pytest.mark.parametrize("fftbins", [True, False])
def test_windows(window, fftbins):
    for n in (1, 8, 51):
        want = outcome(JA.functional.get_window, window, n, fftbins)
        got = outcome(TA.functional.get_window, window, n, fftbins)
        if isinstance(want, Exception):   # bartlett's 1-point 2 / 0
            assert type(got) is type(want)
            continue
        close(want, got)
    for M in (JA, TA):
        with pytest.raises(ValueError):
            M.functional.get_window("kaiser", 8)


FEATURES = [("Spectrogram", dict(n_fft=128, hop_length=40, power=1.0)),
            ("Spectrogram", dict(n_fft=100, win_length=80,
                                 window="hamming")),
            ("MelSpectrogram", dict(sr=16000, n_fft=256, n_mels=32)),
            ("MelSpectrogram", dict(sr=8000, n_fft=128, n_mels=20, htk=True,
                                    norm=None, f_min=0.0, center=False)),
            ("LogMelSpectrogram", dict(sr=16000, n_fft=256, n_mels=32,
                                       top_db=60.0)),
            ("MFCC", dict(sr=16000, n_mfcc=13, n_fft=256, n_mels=32)),
            ("MFCC", dict(sr=16000, n_mfcc=20, n_fft=200, n_mels=40,
                          pad_mode="constant"))]


@pytest.mark.parametrize("name,kw", FEATURES,
                         ids=[f"{n}{i}" for i, (n, _) in enumerate(FEATURES)])
def test_feature_layers(name, kw):
    x = (0.3 * RNG.standard_normal((2, 3000))).astype(np.float32)
    jl = getattr(JA.features, name)(**kw)
    tl = getattr(TA.features, name)(**kw, device="cpu")
    want = jax.jit(jl.__call__)(x)
    got = tl(T(x))
    tol = 1e-3 / float(np.abs(np.asarray(want)).max()) \
        if name in ("LogMelSpectrogram", "MFCC") else 1e-5
    close(want, got, tol)
    bufs = {n for n, _ in tl.named_buffers()}
    assert bufs and all(b.device.type == "cpu" for b in tl.buffers())


@pytest.mark.parametrize("bits,channels_first", [(16, True), (8, False),
                                                 (32, True)])
def test_wav_backend(tmp_path, bits, channels_first):
    wav = (0.8 * np.sin(np.linspace(0, 40, 400))).astype(np.float32)
    data = np.stack([wav, -wav]) if channels_first else \
        np.stack([wav, -wav], 1)
    pj, pt = str(tmp_path / "j.wav"), str(tmp_path / "t.wav")
    JA.save(pj, data, 8000, channels_first, bits_per_sample=bits)
    TA.save(pt, T(data), 8000, channels_first, bits_per_sample=bits)
    assert open(pj, "rb").read() == open(pt, "rb").read()
    for norm in (True, False):
        a, sa = JA.load(pj, 10, 200, norm, channels_first)
        b, sb = TA.load(pj, 10, 200, norm, channels_first)
        assert sa == sb == 8000 and isinstance(b, torch.Tensor)
        assert np.array_equal(np.asarray(a), b.numpy())
    assert vars(TA.info(pt)) == vars(JA.info(pj))
    assert TA.backends.list_available_backends() == \
        JA.backends.list_available_backends()
    assert TA.backends.get_current_backend() == \
        JA.backends.get_current_backend()
    for M in (JA, TA):
        with pytest.raises(ValueError):
            M.save(pt, data.astype(np.int16), 8000, bits_per_sample=8)
        with pytest.raises(ValueError):
            M.backends.set_backend("sox")


@pytest.mark.parametrize("cls", ["TESS", "ESC50"])
def test_audio_datasets(cls):
    for mode in ("train", "dev"):
        a = getattr(JA.datasets, cls)(mode=mode, synthetic_size=3)
        b = getattr(TA.datasets, cls)(mode=mode, synthetic_size=3)
        assert len(a) == len(b) == 3
        for i in range(3):
            assert a[i][1] == b[i][1]
            assert np.array_equal(a[i][0], b[i][0])
    a = getattr(JA.datasets, cls)(feat_type="melspectrogram",
                                  synthetic_size=2)
    b = getattr(TA.datasets, cls)(feat_type="melspectrogram",
                                  synthetic_size=2)
    want, got = a[1][0], b[1][0]
    assert isinstance(got, np.ndarray) and got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-3


def _public(mod):
    """The public functions and classes the JAX package defines in
    ``mod``'s namespace, and ``mod``'s own submodules."""
    out = set()
    for name, obj in vars(mod).items():
        if name.startswith("_"):
            continue
        if isinstance(obj, type(np)):
            if obj.__name__.startswith(mod.__name__ + "."):
                out.add(name)
        elif (getattr(obj, "__module__", None) or "").startswith(
                "paddle_tpu"):
            out.add(name)
    return out


@pytest.mark.parametrize("jmod,tmod", [
    (JFFT, TFFT), (JS, TS), (JA, TA), (JA.functional, TA.functional),
    (JA.features, TA.features), (JA.backends, TA.backends),
    (JA.datasets, TA.datasets)],
    ids=["fft", "signal", "audio", "functional", "features", "backends",
         "datasets"])
def test_every_public_name_is_ported(jmod, tmod):
    names = _public(jmod) | set(getattr(jmod, "__all__", ()))
    assert names
    assert sorted(n for n in names if not hasattr(tmod, n)) == []


def test_root_reexports():
    for name in ("text", "audio", "fft", "signal", "shard_index"):
        assert hasattr(jroot, name) and hasattr(troot, name), name
    assert troot.fft is TFFT and troot.signal is TS and troot.audio is TA
    x = np.arange(12).reshape(3, 4)
    assert np.array_equal(np.asarray(jroot.shard_index(jnp.asarray(x), 12,
                                                       2, 1)),
                          troot.shard_index(T(x), 12, 2, 1).numpy())
