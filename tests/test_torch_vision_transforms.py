"""Port parity: ``vision/transforms`` (functional and classes), the
datasets of ``vision/datasets``, ``vision``'s image backend and the input
pipeline's process workers, against the JAX package on the CPU.

- Every functional transform on an HWC uint8, a CHW uint8 and an HWC
  float32 image is bit-equal to JAX's (``resize`` bilinear and nearest,
  ``rotate``, ``affine``, ``perspective``, ``adjust_hue`` among them), and
  raises where JAX's raises.
- Each random transform, given the same seeded ``_rng`` as JAX's, draws
  and returns exactly JAX's; ``RandomAffine`` and ``RandomPerspective``,
  which in JAX draw from a new generator each call, are held with that
  generator replaced by the seeded one.
- ``Resize`` is Paddle's (a deliberate difference): ``Resize(int)`` equals
  JAX's ``functional.resize`` (shorter edge, bilinear), not JAX's class
  (square, top-left nearest).
- Two process workers draw different flips, from
  ``default_rng([base_seed + worker, k])``; a fixed base seed repeats
  them; JAX's transform, through the same workers, repeats one worker's
  flips in the other (the fault not copied).
- A batch larger than the ring crosses it in pieces.
- The synthetic CIFAR, Flowers and VOC sets are JAX's bit for bit; the
  CIFAR reader takes a tarball and a batch file; ``DatasetFolder`` and
  ``ImageFolder`` read ``.npy`` and PNG files as JAX's do.
- Every public name of JAX's ``vision/transforms``, ``vision/datasets``
  and ``vision/__init__.py`` exists in the port.

Everything here is compared exactly (numpy on both sides).
"""

import io
import os
import pickle
import tarfile
import types
import unittest.mock as mock

import numpy as np
import pytest

import paddle_tpu.vision as jvision
import paddle_tpu.vision.datasets as JD
import paddle_tpu.vision.transforms as JT
import paddle_tpu.vision.transforms.functional as JF
import paddle_tpu_torch.io as tio
import paddle_tpu_torch.vision as tvision
import paddle_tpu_torch.vision.datasets as TD
import paddle_tpu_torch.vision.transforms as TT
import paddle_tpu_torch.vision.transforms.functional as TF
from paddle_tpu_torch.native import ShmQueue
from _torch_threads import one_torch_thread  # noqa: F401

RNG = np.random.default_rng(0)
IMAGES = {
    "hwc_u8": RNG.integers(0, 256, (37, 45, 3)).astype(np.uint8),
    "chw_u8": RNG.integers(0, 256, (3, 29, 41)).astype(np.uint8),
    "hwc_f32": RNG.random((33, 26, 3)).astype(np.float32),
}


def same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)


def outcome(fn, *args):
    try:
        return fn(*args)
    except Exception as e:  # compare the exception's type
        return type(e)


FUNCTIONAL = [
    ("resize", (20,)), ("resize", (25, "bilinear")),
    ("resize", ((16, 30), "nearest")), ("resize", ((50, 60),)),
    ("rotate", (33.0,)), ("rotate", (-71.0, "bilinear")),
    ("rotate", (33.0, "bilinear", True)), ("rotate", (15.0, "nearest", True,
                                                      (4, 7), 9)),
    ("affine", (20, (3, -2), 1.2, (10, 5))),
    ("affine", (-35, (0, 4), 0.8, 7, "nearest", 3, (5, 6))),
    ("perspective", ([(0, 0), (25, 0), (25, 28), (0, 28)],
                     [(3, 2), (22, 1), (24, 25), (1, 27)])),
    ("adjust_hue", (0.3,)), ("adjust_hue", (-0.45,)),
    ("adjust_brightness", (1.3,)), ("adjust_contrast", (1.5,)),
    ("adjust_saturation", (0.4,)), ("to_grayscale", (1,)),
    ("to_grayscale", (3,)), ("pad", ((1, 2, 3, 4), 7, "constant")),
    ("pad", (3, 0, "reflect")), ("pad", ((2, 1), 0, "edge")),
    ("pad", (2, 0, "symmetric")), ("center_crop", (20,)),
    ("crop", (2, 3, 10, 11)), ("hflip", ()), ("vflip", ()),
    ("erase", (1, 2, 5, 6, 9)), ("to_tensor", ()), ("to_tensor", ("HWC",)),
    ("normalize", ([0.5, 0.4, 0.3], [0.2, 0.2, 0.3])),
    ("normalize", ([0.5, 0.4, 0.3], [0.2, 0.2, 0.3], "HWC")),
]


@pytest.mark.parametrize("kind", sorted(IMAGES))
@pytest.mark.parametrize("name,args", FUNCTIONAL,
                         ids=[f"{n}{i}" for i, (n, _) in enumerate(FUNCTIONAL)])
def test_functional_bit_equal(name, args, kind):
    img = IMAGES[kind]
    want = outcome(getattr(JF, name), img, *args)
    got = outcome(getattr(TF, name), img, *args)
    if isinstance(want, type):
        assert got is want
    else:
        assert same(want, got), (name, args, kind)


def test_is_chw_and_2d_images():
    for shape in [(1, 5, 6), (3, 5, 6), (4, 5, 6), (5, 6, 3), (2, 5, 6),
                  (5, 6)]:
        assert TF._is_chw(np.zeros(shape)) == JF._is_chw(np.zeros(shape))
    gray = RNG.integers(0, 256, (13, 17)).astype(np.uint8)
    for name, args in [("resize", (9,)), ("rotate", (20.0,)),
                       ("affine", (10, (1, 1), 1.1, 3)), ("hflip", ()),
                       ("to_tensor", ())]:
        assert same(getattr(JF, name)(gray, *args),
                    getattr(TF, name)(gray, *args)), name


RANDOM = {
    "hflip": lambda M: M.RandomHorizontalFlip(0.5),
    "vflip": lambda M: M.RandomVerticalFlip(0.5),
    "crop": lambda M: M.RandomCrop(20, 2),
    "crop_chw_pad": lambda M: M.RandomCrop((11, 17), 3),
    "resized_crop": lambda M: M.RandomResizedCrop(24),
    "resized_crop_narrow": lambda M: M.RandomResizedCrop(
        (12, 18), scale=(0.9, 1.0), ratio=(5.0, 6.0), interpolation="nearest"),
    "rotation": lambda M: M.RandomRotation(30),
    "rotation_expand": lambda M: M.RandomRotation((10, 80), "bilinear", True,
                                                  None, 5),
    "jitter": lambda M: M.ColorJitter(0.4, 0.4, 0.4, 0.1),
    "brightness": lambda M: M.BrightnessTransform(0.4),
    "contrast": lambda M: M.ContrastTransform(0.4),
    "saturation": lambda M: M.SaturationTransform(0.4),
    "hue": lambda M: M.HueTransform(0.2),
    "erasing": lambda M: M.RandomErasing(0.9, value=7),
}


def seed_both(a, b, seed):
    a._rng, b._rng = (np.random.default_rng(seed),
                      np.random.default_rng(seed))
    for i, (x, y) in enumerate(zip(getattr(a, "transforms", []),
                                   getattr(b, "transforms", []))):
        seed_both(x, y, seed + 1 + i)


@pytest.mark.parametrize("case", sorted(RANDOM))
def test_random_transform_draws_as_jax(case):
    a, b = RANDOM[case](JT), RANDOM[case](TT)
    seed_both(a, b, 5)
    for _ in range(5):
        for kind in ("hwc_u8", "chw_u8"):
            img = IMAGES[kind]
            assert same(a(img), b(img)), (case, kind)


@pytest.mark.parametrize("case", ["affine", "perspective"])
def test_fresh_generator_transforms_draw_from_rng(case):
    # JAX's RandomAffine/RandomPerspective call np.random.default_rng() on
    # every image; the port draws from _rng in the same order
    make = {"affine": lambda M: M.RandomAffine(20, (0.1, 0.2), (0.8, 1.2),
                                               (-5, 5)),
            "perspective": lambda M: M.RandomPerspective(0.7, 0.5)}[case]
    a, b = make(JT), make(TT)
    gen = np.random.default_rng(7)
    b._rng = np.random.default_rng(7)
    imgs = [IMAGES["hwc_u8"], IMAGES["chw_u8"]] * 4
    with mock.patch.object(np.random, "default_rng", lambda *s: gen):
        want = [a(img) for img in imgs]
    got = [b(img) for img in imgs]
    assert all(same(x, y) for x, y in zip(want, got))
    # keys: in a tuple only "image" goes through _apply_image, as in JAX
    b.keys = a.keys = ("image", "label")
    b._rng = np.random.default_rng(9)
    gen = np.random.default_rng(9)
    with mock.patch.object(np.random, "default_rng", lambda *s: gen):
        want = a((IMAGES["hwc_u8"], 3))
    got = b((IMAGES["hwc_u8"], 3))
    assert got[1] == want[1] == 3 and same(got[0], want[0])


def test_plain_classes_equal_jax():
    img = IMAGES["hwc_u8"]
    pairs = [
        (lambda M: M.Compose([M.CenterCrop(20), M.ToTensor(),
                              M.Normalize([0.5] * 3, [0.25] * 3)]), img),
        (lambda M: M.ToTensor("HWC"), img),
        (lambda M: M.CenterCrop((11, 13)), IMAGES["chw_u8"]),
        (lambda M: M.Transpose(), img),
        (lambda M: M.Grayscale(3), img),
        (lambda M: M.Pad((1, 2), 4, "constant"), IMAGES["chw_u8"]),
        (lambda M: M.Normalize(0.5, 2.0, "HWC"), IMAGES["hwc_f32"]),
    ]
    for make, x in pairs:
        assert same(make(JT)(x), make(TT)(x))
    with pytest.raises(NotImplementedError):
        TT.BaseTransform()(img)


@pytest.mark.parametrize("size,interp", [(20, "bilinear"), (31, "nearest"),
                                         ((16, 30), "bilinear"),
                                         ((50, 44), "nearest")])
def test_resize_is_paddles(size, interp):
    # a deliberate difference: JAX's Resize makes an int size square and
    # picks top-left nearest pixels whatever `interpolation` says
    for img in IMAGES.values():
        got = TT.Resize(size, interp)(img)
        assert same(got, JF.resize(img, size, interp))
    if isinstance(size, int):
        h, w = IMAGES["hwc_u8"].shape[:2]
        got = TT.Resize(size, interp)(IMAGES["hwc_u8"])
        assert min(got.shape[:2]) == size and got.shape[:2] != (size, size)
        assert JT.Resize(size, interp)(IMAGES["hwc_u8"]).shape[:2] == \
            (size, size)


class _Flips(tio.Dataset):
    """Item i: 1 if the transform flipped ``[[0, 1, 2, 3]]``, else 0."""

    def __init__(self, flip, n=32):
        self.flip, self.n = flip, n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.int64(self.flip(np.arange(4)[None, :])[0, 0] == 3)


def _flip_batches(flip, seed):
    np.random.seed(seed)
    loader = tio.DataLoader(_Flips(flip), batch_size=8, num_workers=2,
                            use_shared_memory=True)
    return [b.tolist() for b in loader]


def test_process_workers_draw_streams_of_their_own():
    flip = TT.RandomHorizontalFlip(0.5)
    run = _flip_batches(flip, 1234)
    assert run == _flip_batches(flip, 1234)       # a fixed base seed repeats
    assert run[0] != run[1] and run[2] != run[3]  # worker 0 against 1
    # each worker's stream is default_rng([base_seed + worker, 0])
    np.random.seed(1234)
    base = int(np.random.randint(0, 2**31 - 1))
    for w in (0, 1):
        want = (np.random.default_rng([base + w, 0]).random(16) < 0.5)
        assert run[w] + run[w + 2] == want.astype(int).tolist()
    # the trainer's own seeded generator is untouched by the workers
    flip._rng = np.random.default_rng(3)
    ref = np.random.default_rng(3).random(4) < 0.5
    assert [flip(np.arange(4)[None, :])[0, 0] == 3 for _ in range(4)] == \
        ref.tolist()
    # JAX's transform: both forked workers hold one state (the fault)
    jflip = JT.RandomHorizontalFlip(0.5)
    jrun = _flip_batches(jflip, 1234)
    assert jrun[0] == jrun[1] and jrun[2] == jrun[3]


class _Big(tio.Dataset):
    def __len__(self):
        return 8

    def __getitem__(self, i):
        return np.full((640, 1024), i, np.float32)      # 2.5 MiB


def test_batch_larger_than_the_ring_crosses_in_pieces():
    loader = tio.DataLoader(_Big(), batch_size=8, num_workers=2,
                            use_shared_memory=True)
    # one 20 MiB batch, past a quarter of the 64 MiB ring
    (batch,) = list(loader)
    assert batch.shape == (8, 640, 1024)
    assert np.array_equal(batch[:, 0, 0], np.arange(8, dtype=np.float32))
    q = ShmQueue(capacity=1 << 16)
    pids = []
    try:
        for k in range(2):
            pid = os.fork()
            if pid == 0:
                child = ShmQueue(name=q.name, capacity=1 << 16, owner=False)
                for j in range(2):
                    child.put((k, j, np.full(30000 + j, k, np.int64)),
                              timeout=10)
                    child.put(("small", k, j), timeout=10)
                child.close()
                os._exit(0)
            pids.append(pid)
        got = [q.get(timeout=10) for _ in range(8)]
    finally:
        for pid in pids:
            os.waitpid(pid, 0)
        q.close()
    big = sorted((k, j, a.size, int(a.min()), int(a.max()))
                 for k, j, a in (g for g in got if g[0] != "small"))
    assert big == [(k, j, 30000 + j, k, k) for k in range(2) for j in range(2)]
    assert q._pending == {}


def _items_equal(a, b, n):
    for i in range(n):
        x, y = a[i], b[i]
        assert len(x) == len(y)
        for u, v in zip(x, y):
            assert same(u, v)


@pytest.mark.parametrize("cls,mode", [("Cifar10", "train"),
                                      ("Cifar10", "test"),
                                      ("Cifar100", "train"),
                                      ("Flowers", "test"),
                                      ("VOC2012", "train"),
                                      ("VOC2012", "test")])
def test_synthetic_sets_are_jaxs(cls, mode):
    a = getattr(JD, cls)(mode=mode, synthetic_size=9)
    b = getattr(TD, cls)(mode=mode, synthetic_size=9)
    assert len(a) == len(b) == 9
    _items_equal(a, b, 9)
    t = TT.Compose([TT.CenterCrop(16), TT.ToTensor()]) \
        if cls == "VOC2012" else TT.Normalize(0.5, 0.25)
    tj = JT.Compose([JT.CenterCrop(16), JT.ToTensor()]) \
        if cls == "VOC2012" else JT.Normalize(0.5, 0.25)
    _items_equal(getattr(JD, cls)(mode=mode, synthetic_size=3, transform=tj),
                 getattr(TD, cls)(mode=mode, synthetic_size=3, transform=t), 3)


def _cifar_batch(n, seed, key):
    rng = np.random.default_rng(seed)
    return {b"data": rng.integers(0, 256, (n, 3072)).astype(np.uint8),
            key: rng.integers(0, 10, n).tolist()}


def test_cifar_reads_the_tarball_and_a_batch_file(tmp_path):
    tar = tmp_path / "cifar-10-python.tar.gz"
    with tarfile.open(tar, "w:gz") as tf:
        for name, seed in (("data_batch_1", 1), ("data_batch_2", 2),
                           ("test_batch", 3)):
            raw = pickle.dumps(_cifar_batch(5, seed, b"labels"))
            info = tarfile.TarInfo(f"cifar-10-batches-py/{name}")
            info.size = len(raw)
            tf.addfile(info, io.BytesIO(raw))
    for mode, n in (("train", 10), ("test", 5)):
        a = JD.Cifar10(str(tar), mode=mode)
        b = TD.Cifar10(str(tar), mode=mode)
        assert len(a) == len(b) == n
        _items_equal(a, b, n)
    one = tmp_path / "train"
    one.write_bytes(pickle.dumps(_cifar_batch(4, 4, b"fine_labels")))
    a, b = JD.Cifar100(str(one)), TD.Cifar100(str(one))
    _items_equal(a, b, 4)
    for M in (JD, TD):
        with pytest.raises(NotImplementedError):
            M.Flowers(data_file=str(one))


def _image_tree(root):
    from PIL import Image
    rng = np.random.default_rng(2)
    for c, names in (("b_cls", ["x.npy", "y.png", "skip.txt"]),
                     ("a_cls", ["z.npy", "sub/w.npy"])):
        for name in names:
            path = os.path.join(root, c, name)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            img = rng.integers(0, 256, (9, 11, 3)).astype(np.uint8)
            if name.endswith(".npy"):
                np.save(path, img)
            elif name.endswith(".png"):
                Image.fromarray(img).save(path)
            else:
                open(path, "w").write("not an image")


def test_dataset_folder_and_image_folder(tmp_path):
    _image_tree(str(tmp_path))
    a = JD.DatasetFolder(str(tmp_path))
    b = TD.DatasetFolder(str(tmp_path))
    assert b.classes == a.classes == ["a_cls", "b_cls"]
    assert b.class_to_idx == a.class_to_idx
    assert [s for s in b.samples] == [s for s in a.samples]
    assert len(b) == 4
    _items_equal(a, b, 4)
    pipe = TT.Compose([TT.CenterCrop(8), TT.ToTensor("HWC")])
    jpipe = JT.Compose([JT.CenterCrop(8), JT.ToTensor("HWC")])
    _items_equal(JD.DatasetFolder(str(tmp_path), transform=jpipe),
                 TD.DatasetFolder(str(tmp_path), transform=pipe), 4)
    only = TD.DatasetFolder(str(tmp_path), extensions=(".png",))
    assert len(only) == 1 and only[0][1] == 1
    a, b = JD.ImageFolder(str(tmp_path)), TD.ImageFolder(str(tmp_path))
    assert b.samples == a.samples and len(b) == 4
    _items_equal(a, b, 4)
    assert TD.IMG_EXTENSIONS == JD.IMG_EXTENSIONS
    for M in (JD, TD):
        with pytest.raises(RuntimeError):
            M.DatasetFolder(str(tmp_path / "a_cls" / "sub"))


def test_image_backend(tmp_path):
    from PIL import Image
    path = str(tmp_path / "im.png")
    Image.fromarray(IMAGES["hwc_u8"]).save(path)
    assert tvision.get_image_backend() == jvision.get_image_backend() == "pil"
    assert same(np.asarray(tvision.image_load(path)),
                np.asarray(jvision.image_load(path)))
    for M in (jvision, tvision):
        with pytest.raises(ValueError):
            M.set_image_backend("tensor")
    try:
        tvision.set_image_backend("cv2")
        assert tvision.get_image_backend() == "cv2"
    finally:
        tvision.set_image_backend("pil")


def _public(mod):
    """The public functions and classes the JAX package defines in
    ``mod``'s namespace, and ``mod``'s own submodules."""
    out = set()
    for name, obj in vars(mod).items():
        if name.startswith("_"):
            continue
        if isinstance(obj, types.ModuleType):
            if obj.__name__.startswith(mod.__name__ + "."):
                out.add(name)
        elif (getattr(obj, "__module__", None) or "").startswith(
                "paddle_tpu"):
            out.add(name)
    return out


@pytest.mark.parametrize("jmod,tmod", [
    (JT, TT), (JF, TF), (JD, TD), (jvision, tvision)],
    ids=["transforms", "functional", "datasets", "vision"])
def test_every_public_name_is_ported(jmod, tmod):
    names = _public(jmod) | set(getattr(jmod, "__all__", ()))
    assert names, jmod
    missing = sorted(n for n in names if not hasattr(tmod, n))
    assert missing == []
    if hasattr(jmod, "__all__"):
        assert set(tmod.__all__) >= set(jmod.__all__)
