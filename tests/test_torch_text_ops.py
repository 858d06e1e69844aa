"""Port parity: ``text/ops.py``, ``text/__init__.py`` and
``text/datasets.py`` against the JAX package on the CPU.

- ``viterbi_decode`` (JAX jitted) with and without ``lengths`` (1 to T),
  at T = 1, and on ties between paths (integer emissions, a zero
  transition matrix): the paths exactly equal, the scores within
  1e-6 + 1e-6·|ref|; ``include_bos_eos_tag=True`` raises
  NotImplementedError in both, and so does ``ViterbiDecoder`` with its
  default; ``ViterbiDecoder(include_bos_eos_tag=False)`` equals the
  function.
- ``edit_distance`` on random and degenerate pairs, normalised or not:
  equal to JAX's; mismatched counts raise ValueError in both.
- ``gather_tree`` and ``shard_index`` equal JAX's exactly.
- Each synthetic text dataset equals JAX's in every field, dtype and
  length, for each split.
- Every public name of JAX's ``text/ops.py`` and ``text/__init__.py``
  exists in the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.text as JT
import paddle_tpu.text.datasets as JD
import paddle_tpu.text.ops as JO
import paddle_tpu_torch.text as TT
import paddle_tpu_torch.text.datasets as TD
from paddle_tpu_torch.core.device import device_guard
from _torch_threads import one_torch_thread  # noqa: F401

T = torch.as_tensor
JIT_VITERBI = jax.jit(JO.viterbi_decode)


@pytest.fixture(scope="module", autouse=True)
def cpu_device():
    with device_guard("cpu"):
        yield


def check_viterbi(pot, trans, lengths=None):
    want = JIT_VITERBI(pot, trans, None if lengths is None
                       else jnp.asarray(lengths))
    got = TT.viterbi_decode(T(pot), T(trans),
                            None if lengths is None else T(lengths))
    assert got[1].dtype == torch.int64
    assert np.array_equal(np.asarray(want[1]), got[1].numpy())
    ref = np.asarray(want[0])
    assert np.all(np.abs(got[0].numpy() - ref) <= 1e-6 + 1e-6 * np.abs(ref))
    return got


@pytest.mark.parametrize("b,t,n", [(5, 9, 6), (3, 1, 4), (4, 17, 3),
                                   (2, 6, 1)])
@pytest.mark.parametrize("with_lengths", [False, True])
def test_viterbi_paths_exact(b, t, n, with_lengths):
    rng = np.random.default_rng(b * 100 + t)
    pot = rng.standard_normal((b, t, n)).astype(np.float32)
    trans = rng.standard_normal((n, n)).astype(np.float32)
    lengths = rng.integers(1, t + 1, b) if with_lengths else None
    _, paths = check_viterbi(pot, trans, lengths)
    if with_lengths:     # past its length a path repeats its last tag
        for i, ln in enumerate(lengths):
            assert (paths[i, ln - 1:] == paths[i, ln - 1]).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_viterbi_ties_take_the_first_maximum(seed):
    rng = np.random.default_rng(seed)
    pot = np.round(rng.standard_normal((6, 8, 5))).astype(np.float32)
    trans = np.zeros((5, 5), np.float32)
    check_viterbi(pot, trans)
    check_viterbi(pot, trans, np.array([8, 3, 1, 5, 8, 2]))


def test_viterbi_bos_eos_and_decoder():
    rng = np.random.default_rng(3)
    pot = rng.standard_normal((2, 4, 3)).astype(np.float32)
    trans = rng.standard_normal((3, 3)).astype(np.float32)
    for fn in (JO.viterbi_decode, TT.viterbi_decode):
        with pytest.raises(NotImplementedError):
            fn(pot, trans, include_bos_eos_tag=True)
    for M, p, tr in ((JT, pot, trans), (TT, T(pot), T(trans))):
        with pytest.raises(NotImplementedError):
            M.ViterbiDecoder(tr)(p)
    want = JT.ViterbiDecoder(trans, include_bos_eos_tag=False)(pot)
    got = TT.ViterbiDecoder(T(trans), include_bos_eos_tag=False)(T(pot))
    assert np.array_equal(np.asarray(want[1]), got[1].numpy())


@pytest.mark.parametrize("normalized", [True, False])
@pytest.mark.parametrize("vocab,max_len", [(3, 12), (6, 30), (50, 8)])
def test_edit_distance(normalized, vocab, max_len):
    rng = np.random.default_rng(vocab + max_len)
    hyps = [rng.integers(0, vocab, rng.integers(0, max_len))
            for _ in range(30)]
    refs = [rng.integers(0, vocab, rng.integers(0, max_len))
            for _ in range(30)]
    hyps[0], refs[0] = np.array([], np.int64), np.array([1, 2])
    hyps[1], refs[1] = np.array([4, 1]), np.array([], np.int64)
    hyps[2] = refs[2] = np.array([1, 2, 1])
    want = JO.edit_distance(hyps, refs, normalized)
    got = TT.edit_distance([T(h) for h in hyps], refs, normalized)
    assert got[0].dtype == torch.float32 and tuple(got[0].shape) == (30, 1)
    assert np.array_equal(np.asarray(want[0]), got[0].numpy())
    assert int(got[1]) == int(want[1]) == 30


def test_edit_distance_mismatch_raises():
    for fn in (JO.edit_distance, TT.edit_distance):
        with pytest.raises(ValueError):
            fn([[1, 2]], [[1], [2]])


def test_gather_tree_and_shard_index():
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 20, (5, 3, 4))
    parents = rng.integers(0, 4, (5, 3, 4))
    assert np.array_equal(np.asarray(JO.gather_tree(ids, parents)),
                          TT.gather_tree(T(ids), T(parents)).numpy())
    x = rng.integers(0, 40, (4, 5))
    for nshards, shard, ignore in ((3, 1, -1), (4, 3, 99), (1, 0, -1)):
        want = np.asarray(JO.shard_index(jnp.asarray(x), 40, nshards, shard,
                                         ignore))
        got = TT.shard_index(T(x), 40, nshards, shard, ignore)
        assert np.array_equal(want, got.numpy())


DATASETS = [("Imdb", {}), ("Imikolov", {}), ("Imikolov", {"data_type": "SEQ"}),
            ("UCIHousing", {}), ("Movielens", {"rand_seed": 3}),
            ("Conll05", {}), ("Conll05st", {}), ("WMT14", {}),
            ("WMT16", {"mode": "val"})]


@pytest.mark.parametrize("mode", ["train", "test"])
@pytest.mark.parametrize("cls,kw", DATASETS,
                         ids=[f"{c}{i}" for i, (c, _) in enumerate(DATASETS)])
def test_text_datasets_bit_equal(cls, kw, mode):
    kw = {"mode": mode, **kw}
    a = getattr(JD, cls)(synthetic_size=6, **kw)
    b = getattr(TD, cls)(synthetic_size=6, **kw)
    assert len(a) == len(b) == 6
    for i in range(6):
        x, y = a[i], b[i]
        assert type(x) is type(y) and len(x) == len(y)
        for u, v in zip(x, y):
            u, v = np.asarray(u), np.asarray(v)
            assert u.dtype == v.dtype and np.array_equal(u, v)
    if cls.startswith("WMT"):
        assert a.get_dict("en", reverse=True) == b.get_dict("en",
                                                            reverse=True)


def test_dataset_argument_checks():
    for M in (JD, TD):
        with pytest.raises(ValueError):
            M.Imdb(mode="val")
        with pytest.raises(ValueError):
            M.Imikolov(data_type="BAG")
        with pytest.raises(ValueError):
            M.WMT16(mode="dev")


def test_every_public_name_is_ported():
    assert sorted(set(JO.__all__) - set(TT.ops.__all__)) == []
    assert sorted(set(JD.__all__) - set(TD.__all__)) == []
    names = {n for n in vars(JT) if not n.startswith("_")}
    assert sorted(n for n in names if not hasattr(TT, n)) == []
