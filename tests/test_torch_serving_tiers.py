"""Port parity: the serving engine's throughput tiers.

Radix prefix sharing, chunked prefill through the ``extend`` step and
speculative decoding (the n-gram drafter and a small-LM drafter over a
mirrored paged pool), alone and composed, on the ``tests/test_serving.py``
micro model with its weights carried into the port. Each JAX engine
serves its trace once, in a module-scoped fixture that several tests
read; the port's engine must be token-exact against it and against the
port's ``generate``, report the same prefix hits, proposals and
acceptances, and leave the allocator in the same state. Also here:
``_multi_query_attention`` against JAX's, the prefix tree under one
seeded operation sequence against JAX's tree, the n-gram drafter's
proposals, the gamma autotune round trip, and the engine's knobs.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core import flags as jax_flags
from paddle_tpu.serving import ModelDrafter as JaxModelDrafter
from paddle_tpu.serving import NGramDrafter as JaxNGramDrafter
from paddle_tpu.serving import PagedKVCache as JaxPagedKVCache
from paddle_tpu.serving import PrefixCache as JaxPrefixCache
from paddle_tpu.serving import Request as JaxRequest
from paddle_tpu.serving import ServingEngine as JaxServingEngine
from paddle_tpu.serving import engine as jax_engine_mod
from paddle_tpu.text.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.text.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch.convert import from_jax_state_dict
from paddle_tpu_torch.core import flags as port_flags
from paddle_tpu_torch.serving import (ModelDrafter, NGramDrafter,
                                      PagedKVCache, PrefixCache, Request,
                                      ServingEngine, Status, pick_gamma,
                                      store_gamma, tune_gamma)
from paddle_tpu_torch.serving import engine as port_engine_mod
from paddle_tpu_torch.text.models.gpt import GPTForCausalLM, gpt_tiny
from _torch_threads import one_torch_thread  # noqa: F401

MICRO = dict(vocab_size=128, hidden_size=48, num_layers=2, num_heads=4,
             max_position_embeddings=64)
DRAFTER = dict(vocab_size=128, hidden_size=32, num_layers=1, num_heads=2,
               max_position_embeddings=32)


def carried(cfg, seed):
    """A JAX GPT drawn from ``seed`` and the port's with its weights."""
    paddle.seed(seed)
    jm = JaxGPT(jax_gpt_tiny(**cfg))
    jm.eval()
    tm = GPTForCausalLM(gpt_tiny(**cfg), device="cpu")
    tm.load_state_dict(from_jax_state_dict(
        {k: np.asarray(v) for k, v in jm.state_dict().items()}))
    tm.eval()
    return jm, tm


@pytest.fixture(scope="module")
def pair64():
    return carried(MICRO, 7)


@pytest.fixture(scope="module")
def pair32():
    return carried({**MICRO, "max_position_embeddings": 32}, 7)


@pytest.fixture(scope="module")
def drafter_pair():
    return carried(DRAFTER, 11)


def ragged(n, lo=3, hi=14, max_new=5, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 128, int(rng.integers(lo, hi + 1))), max_new)
            for _ in range(n)]


def shared_prefix(n, shared_len=12, suffix=4, max_new=6, seed=3):
    rng = np.random.default_rng(seed)
    sysp = rng.integers(0, 128, shared_len)
    return [(np.concatenate([sysp, rng.integers(0, 128, suffix)]), max_new)
            for _ in range(n)]


def requests(cls, trace):
    return [cls(rid=f"r{i}", prompt_ids=p, max_new_tokens=n)
            for i, (p, n) in enumerate(trace)]


class Served:
    """One trace through the JAX engine and the port's."""

    def __init__(self, jm, tm, trace, jax_drafter=None, port_drafter=None,
                 **kw):
        self.trace = trace
        self.tm = tm
        self.jax = JaxServingEngine(jm, drafter=jax_drafter, **kw)
        self.jres = self.jax.serve(requests(JaxRequest, trace))
        self.port = ServingEngine(tm, device="cpu", drafter=port_drafter,
                                  **kw)
        self.tres = self.port.serve(requests(Request, trace))
        # read before any test evicts the port's tree
        self.prefix_report = self.port.prefix_report()


def serve_pair(pair, trace, drafters=None, **kw):
    """One bucket a step shape (every prompt here is at most 16 tokens), so
    each JAX engine compiles each of its steps once."""
    jm, tm = pair
    jd, td = (None, None) if drafters is None else (
        JaxModelDrafter(drafters[0]), ModelDrafter(drafters[1]))
    return Served(jm, tm, trace, jd, td, prefill_buckets=[16],
                  decode_buckets=[4], **kw)


@pytest.fixture(scope="module")
def prefix_shared(pair64):
    return serve_pair(pair64, shared_prefix(4), block_size=4,
                      num_blocks=64, max_batch=4, prefix_cache=True)


@pytest.fixture(scope="module")
def prefix_pressure(pair32):
    return serve_pair(pair32, shared_prefix(4, max_new=8), block_size=4,
                      num_blocks=14, max_batch=4, max_seq_len=32,
                      prefix_cache=True)


@pytest.fixture(scope="module")
def chunked(pair64):
    return serve_pair(pair64, ragged(4, lo=9, hi=14, seed=8), block_size=4,
                      num_blocks=32, max_batch=4, chunked_prefill=8)


@pytest.fixture(scope="module")
def ngram(pair64):
    return serve_pair(pair64, ragged(4, max_new=8, seed=9), block_size=4,
                      num_blocks=32, max_batch=4, speculative=3)


@pytest.fixture(scope="module")
def model_drafter(pair32, drafter_pair):
    return serve_pair(pair32, ragged(4, lo=8, hi=14, max_new=8, seed=1),
                      drafters=drafter_pair, block_size=4, num_blocks=10,
                      max_batch=4, max_seq_len=32, speculative=2)


@pytest.fixture(scope="module")
def composed(pair32):
    return serve_pair(pair32, shared_prefix(4, shared_len=8, suffix=6,
                                            max_new=8, seed=2),
                      block_size=4, num_blocks=12, max_batch=4,
                      max_seq_len=32, prefix_cache=True, chunked_prefill=8,
                      speculative=2)


SCENARIOS = ["prefix_shared", "prefix_pressure", "chunked", "ngram",
             "model_drafter", "composed"]


def port_generate(tm, prompt, max_new):
    return tm.generate(torch.from_numpy(np.asarray(prompt))[None].long(),
                       max_new_tokens=max_new)[0].numpy()


def allocator_state(alloc):
    return sorted(alloc._free), dict(sorted(alloc._refs.items()))


def assert_pristine_but_tree(engine):
    """After a drain only the tree's own refs remain; evicting the whole
    tree (drop path) gives back a fresh free list."""
    alloc = engine.cache.allocator
    held = (engine.prefix.device_block_ids()
            if engine.prefix is not None else frozenset())
    assert alloc.n_used == len(held)
    assert all(alloc.refcount(i) == 1 for i in held)
    if engine.prefix is not None:
        engine.prefix.evict(alloc.num_blocks, spill=False)
        engine.prefix.assert_consistent()
    assert alloc.n_used == 0 and alloc.n_free == alloc.num_blocks - 1
    engine.sched.assert_idle()


# ---------------------------------------------------------------------------
# 1. The extend step's attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads", [(4, 4), (4, 2)], ids=["mha", "gqa"])
def test_multi_query_attention_matches_jax(heads, dtype):
    h, kh = heads
    rng = np.random.default_rng(5)
    b, L, sk, d = 3, 5, 12, 16
    q = rng.standard_normal((b, L, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, kh, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, kh, d)).astype(np.float32)
    pos = rng.integers(0, sk, (b, L))
    pos[1, 2] = -1                      # a row with no valid key
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax_engine_mod._multi_query_attention(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        jnp.asarray(pos, jnp.int32))
    want = np.asarray(want.astype(jnp.float32))
    got = port_engine_mod._multi_query_attention(
        torch.from_numpy(q).to(tdt), torch.from_numpy(k).to(tdt),
        torch.from_numpy(v).to(tdt), torch.from_numpy(pos)).float().numpy()
    assert np.all(got[1, 2] == 0) and np.all(want[1, 2] == 0)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    else:
        # one bf16 ulp (2^-7 of the value's binade) of the larger value
        big = np.maximum(np.abs(got), np.abs(want))
        ulp = np.exp2(np.floor(np.log2(np.maximum(big, 1e-30))) - 7)
        assert np.all(np.abs(got - want) <= ulp)


# ---------------------------------------------------------------------------
# 2. The prefix tree against JAX's
# ---------------------------------------------------------------------------

def tree_state(tree):
    """Node paths with their residency and refs, as comparable data."""
    out = []
    stack = [((), tree.root)]
    while stack:
        path, n = stack.pop()
        for key, c in sorted(n.children.items()):
            p = path + (key,)
            out.append((p, c.block_id, c.host_kv is not None, c.seq_refs,
                        c.hits))
            stack.append((p, c))
    return sorted(out)


def test_prefix_tree_matches_jax_under_one_operation_sequence():
    """The seeded attach/insert/release/evict churn of
    ``tests/test_serving.py``'s randomized trie test, driven through both
    trees over the same allocator calls: the same nodes, device blocks,
    host-tier nodes and refcounts after every operation."""
    rng = np.random.default_rng(42)
    caches = [JaxPagedKVCache(n_layers=2, num_blocks=24, block_size=4,
                              kv_heads=2, head_dim=8),
              PagedKVCache(n_layers=2, num_blocks=24, block_size=4,
                           kv_heads=2, head_dim=8)]
    trees = [JaxPrefixCache(caches[0]), PrefixCache(caches[1])]
    prompts = [rng.integers(0, 8, int(rng.integers(5, 17)))
               for _ in range(6)]
    live = [[], []]
    seen_host = False
    for step in range(200):
        op = int(rng.integers(0, 3))
        pick = int(rng.integers(0, 1 << 30))
        n_evict = int(rng.integers(1, 4))
        for side, (cache, tree) in enumerate(zip(caches, trees)):
            alloc = cache.allocator
            if op == 0 and len(live[side]) < 8:
                p = prompts[pick % len(prompts)]
                chain = tree.match(p)
                got = tree.attach("s", chain, alloc.alloc)
                chain = chain[:len(got)]
                ids = alloc.alloc(-(-p.size // 4) - len(got))
                if ids is None:
                    if chain:
                        tree.release(chain)
                    tree.evict(4)
                    continue
                new = tree.insert(p, got + ids, p.size, have=len(chain))
                live[side].append((chain + new,
                                   (got + ids)[len(chain) + len(new):]))
            elif op == 1 and live[side]:
                chain, priv = live[side].pop(pick % len(live[side]))
                if chain:
                    tree.release(chain)
                if priv:
                    alloc.free(priv)
            else:
                tree.evict(n_evict)
            tree.assert_consistent()
        assert tree_state(trees[0]) == tree_state(trees[1]), step
        assert trees[0].device_block_ids() == trees[1].device_block_ids()
        assert trees[0].n_nodes == trees[1].n_nodes
        assert trees[0].n_idle_device_blocks() == \
            trees[1].n_idle_device_blocks()
        assert allocator_state(caches[0].allocator) == \
            allocator_state(caches[1].allocator)
        seen_host |= any(h for _, _, h, _, _ in tree_state(trees[1]))
    assert seen_host, "the sequence never spilled a node to the host tier"
    assert trees[0].drop_host_tier() == trees[1].drop_host_tier()
    assert tree_state(trees[0]) == tree_state(trees[1])


def _tree_cache(num_blocks=8):
    return PagedKVCache(n_layers=2, num_blocks=num_blocks, block_size=4,
                        kv_heads=2, head_dim=8)


def test_shared_spill_restore_bitwise():
    """A shared block evicted to the host tier while both sharers are
    preempted restores bitwise, once, for both."""
    cache = _tree_cache()
    tree = PrefixCache(cache)
    prompt = np.arange(9, dtype=np.int32)
    ids = cache.allocator.alloc(2)
    g = torch.Generator().manual_seed(0)
    k0 = torch.randn(2, 2, 4, 2, 8, generator=g)
    v0 = torch.randn(2, 2, 4, 2, 8, generator=g)
    cache.k[:, ids], cache.v[:, ids] = k0, v0
    inserted = tree.insert(prompt, ids, 8)
    chains = [tree.match(prompt) for _ in range(2)]
    for c in chains:
        assert tree.attach("s", c, cache.allocator.alloc) == ids
    assert cache.allocator.n_shared == 2
    tree.release(inserted)
    for c in chains:
        tree.release(c)
    assert tree.evict(2) == 2 and tree.evictions == 2
    assert cache.allocator.n_used == 0
    cache.k.zero_()
    cache.v.zero_()
    cache.allocator.alloc(1)                     # shift the free list
    a1 = tree.attach("s1", tree.match(prompt), cache.allocator.alloc)
    a2 = tree.attach("s2", tree.match(prompt), cache.allocator.alloc)
    assert a1 == a2 and a1 != ids
    k_back, v_back = cache.read_blocks(a1)
    assert torch.equal(k_back, k0) and torch.equal(v_back, v0)
    tree.assert_consistent()


def test_never_rematched_eviction_drops_not_spills():
    cache = _tree_cache()
    tree = PrefixCache(cache)
    ids = cache.allocator.alloc(2)
    new = tree.insert(np.arange(9, dtype=np.int32), ids, 8)
    assert len(tree.match(np.arange(8, dtype=np.int32))) == 1  # (8-1)//4
    tree.release(new)
    assert tree.evict(2) == 2
    assert tree.n_nodes == 0
    assert tree.match(np.arange(9, dtype=np.int32)) == []


# ---------------------------------------------------------------------------
# 3. The engines, port against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scenario", SCENARIOS)
def test_engine_tier_token_exact_vs_jax_and_generate(scenario, request):
    s = request.getfixturevalue(scenario)
    for i, (prompt, new) in enumerate(s.trace):
        rid = f"r{i}"
        assert s.tres[rid].status is Status.FINISHED
        np.testing.assert_array_equal(s.tres[rid].output,
                                      s.jres[rid].output)
        np.testing.assert_array_equal(s.tres[rid].output,
                                      port_generate(s.tm, prompt, new))
        assert s.tres[rid].preemptions == s.jres[rid].preemptions
        assert s.tres[rid].block_log == s.jres[rid].block_log
    # the same allocator state, grant for grant, and the same reports
    assert allocator_state(s.port.cache.allocator) == \
        allocator_state(s.jax.cache.allocator)
    assert s.prefix_report == s.jax.prefix_report()
    assert s.port.spec_report() == s.jax.spec_report()
    assert_pristine_but_tree(s.port)


def test_prefix_cache_hits_and_cow_assert(prefix_shared, prefix_pressure):
    rep = prefix_shared.prefix_report
    assert rep["hit_rate"] > 0.3 and rep["tree_nodes"] > 0
    assert sum(s.preemptions for s in prefix_pressure.tres.values()) >= 1
    # a fresh engine over the same trace, held before the drain's evict
    eng = ServingEngine(prefix_shared.tm, block_size=4, num_blocks=64,
                        max_batch=2, prefix_cache=True, device="cpu")
    eng.serve(requests(Request, shared_prefix(2)))
    held = eng.prefix.device_block_ids()
    assert held
    with pytest.raises(AssertionError, match="COW write-isolation"):
        eng._assert_cow([next(iter(held))])


def test_chunked_prefill_records_its_phase(chunked):
    assert chunked.port.n_extend_prefills > 0
    assert chunked.port.n_extend_prefills == sum(
        -(-p.size // 8) for p, _ in chunked.trace)
    assert all("chunk_prefill" in s.phase_s for s in chunked.tres.values())


def drive_interleave(engine_cls, req_cls, model, **kw):
    """A resident decodes, then a long prompt arrives and prefills in
    4-token chunks: returns each request's finishing iteration and the
    iterations where the resident committed a token mid-prefill."""
    engine = engine_cls(model, block_size=4, num_blocks=64, max_batch=4,
                        chunked_prefill=4, **kw)
    rng = np.random.default_rng(4)
    res = req_cls(rid="res", prompt_ids=rng.integers(0, 128, 5),
                  max_new_tokens=20)
    long_req = req_cls(rid="long", prompt_ids=rng.integers(0, 128, 24),
                       max_new_tokens=2)
    engine.submit(res)
    it, finished_at, mid = 0, {}, []
    while not engine._seqs["res"].out_tokens:
        engine.step()
        it += 1
    engine.submit(long_req)
    while engine.sched.n_pending:
        n0 = engine._seqs["res"].n_generated
        for seq in engine.step():
            finished_at[seq.rid] = it
        seq = engine._seqs["long"]
        if 0 < seq.prefill_pos < seq.prompt_len and \
                engine._seqs["res"].n_generated > n0:
            mid.append(it)
        it += 1
    return finished_at, mid, {r: engine._seqs[r].output
                              for r in ("res", "long")}


def test_chunked_interleave_finishes_at_jax_iterations(pair64):
    jm, tm = pair64
    j_fin, j_mid, j_out = drive_interleave(JaxServingEngine, JaxRequest, jm)
    t_fin, t_mid, t_out = drive_interleave(ServingEngine, Request, tm,
                                           device="cpu")
    assert t_fin == j_fin and t_mid == j_mid and t_mid
    for rid in ("res", "long"):
        np.testing.assert_array_equal(t_out[rid], j_out[rid])


@pytest.mark.parametrize("drafter", ["ngram", "model"])
def test_speculation_cut_at_the_block_table_end(pair32, drafter_pair,
                                                drafter):
    """Every request ends exactly at ``max_seq_len`` (a block multiple), so
    the last verify dispatches have less room than gamma: the port cuts
    the draft depth there (JAX's engine has no cut). Outputs stay equal to
    ``generate`` and the pool drains clean."""
    _, tm = pair32
    max_seq, gamma = 32, 3
    eng = ServingEngine(tm, block_size=4, num_blocks=40, max_batch=4,
                        max_seq_len=max_seq, speculative=gamma,
                        drafter=(ModelDrafter(drafter_pair[1])
                                 if drafter == "model" else None),
                        device="cpu")
    assert eng.max_blocks_per_seq * eng.block_size == max_seq
    draft = eng._draft_proposals
    cut = []

    def spy(batch, width, tables):
        props = draft(batch, width, tables)
        for s, p in zip(batch, props):
            depth = eng._lookahead(s)
            assert len(p) <= depth
            assert s.ctx_len + depth <= max_seq - 1
            if depth < gamma:
                cut.append((depth, len(p)))
        return props
    eng._draft_proposals = spy
    rng = np.random.default_rng(21)
    trace = []
    for _ in range(4):
        n = int(rng.integers(8, 13))
        trace.append((rng.integers(0, 128, n), max_seq - n))
    res = eng.serve(requests(Request, trace))
    for i, (prompt, new) in enumerate(trace):
        seq = res[f"r{i}"]
        assert seq.status is Status.FINISHED and seq.output.size == max_seq
        np.testing.assert_array_equal(seq.output,
                                      port_generate(tm, prompt, new))
    # the cut ran, and at least once it shortened a row's proposals (its
    # verify dispatch then has pad slots past the end of the table)
    assert any(0 < n_prop == d for d, n_prop in cut)
    assert eng.spec_report()["proposed"] > 0
    assert_pristine_but_tree(eng)


def test_speculative_reports(ngram, model_drafter):
    rep = ngram.port.spec_report()
    assert rep["gamma"] == 3 and rep["iterations"] > 0
    assert rep["proposed"] > 0 and rep["drafter"] == "ngram"
    drep = model_drafter.port.spec_report()
    assert drep["drafter"] == "model" and drep["proposed"] > 0
    assert model_drafter.port.n_preemptions >= 1
    assert model_drafter.port._draft_cache.k.shape[0] == \
        DRAFTER["num_layers"]


def test_model_drafter_checks_vocab_and_device(pair32):
    _, tm = pair32
    other = GPTForCausalLM(gpt_tiny(**{**DRAFTER, "vocab_size": 64}),
                           device="cpu")
    with pytest.raises(ValueError, match="drafter vocab 64 != target"):
        ServingEngine(tm, block_size=4, num_blocks=10, max_seq_len=32,
                      speculative=2, drafter=ModelDrafter(other),
                      device="cpu")
    meta = GPTForCausalLM(gpt_tiny(**DRAFTER), device="cpu").to("meta")
    with pytest.raises(ValueError, match="drafter model is on meta"):
        ServingEngine(tm, block_size=4, num_blocks=10, max_seq_len=32,
                      speculative=2, drafter=ModelDrafter(meta),
                      device="cpu")


# ---------------------------------------------------------------------------
# 4. The n-gram drafter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fallback", [True, False])
def test_ngram_propose_matches_jax(fallback):
    rng = np.random.default_rng(13)
    ours = NGramDrafter(repeat_fallback=fallback)
    theirs = JaxNGramDrafter(repeat_fallback=fallback)
    n_nonempty = 0
    for _ in range(200):
        hist = list(rng.integers(0, 6, int(rng.integers(1, 40))))
        gamma = int(rng.integers(1, 7))
        got = ours.propose(hist, gamma)
        assert got == theirs.propose(hist, gamma)
        n_nonempty += bool(got)
    assert n_nonempty > 100


# ---------------------------------------------------------------------------
# 5. The gamma autotune round trip
# ---------------------------------------------------------------------------

@pytest.fixture
def tune_files(tmp_path):
    """Both packages' autotune caches on files under ``tmp_path``."""
    port_at = importlib.import_module("paddle_tpu_torch.ops._hopper.autotune")
    jax_at = importlib.import_module("paddle_tpu.ops._pallas.autotune")
    old = port_at._cache, jax_at._cache
    port_flags.set_flags({"kernel_autotune_cache_path":
                          str(tmp_path / "port.json")})
    jax_flags.set_flags({"kernel_autotune_cache_path":
                         str(tmp_path / "jax.json")})
    port_at._cache = jax_at._cache = None
    yield port_at, jax_at
    port_at._cache, jax_at._cache = old
    port_flags.set_flags({"kernel_autotune_cache_path": ""})
    jax_flags.set_flags({"kernel_autotune_cache_path": ""})


def test_gamma_autotune_round_trip(tune_files, tmp_path, pair64):
    port_at, _ = tune_files
    from paddle_tpu.serving.speculative import tune_gamma as jax_tune_gamma
    assert pick_gamma("t", "d", default=5) == 5
    rng = np.random.default_rng(3)
    for _ in range(20):
        lens = list(rng.integers(0, 9, int(rng.integers(1, 12))))
        assert tune_gamma("t", "d", lens) == jax_tune_gamma("t", "d", lens)
    assert tune_gamma("t", "d", [2, 3, 3, 4]) == 3     # ceil(mean 3)
    assert pick_gamma("t", "d", default=5) == 3
    store_gamma("t", "d", 6)
    assert pick_gamma("t", "d") == 6
    # the file holds it for a fresh process, keyed by device and schema
    port_at._cache = None
    assert pick_gamma("t", "d") == 6
    key = f"serve_spec_gamma|{port_at.chip_kind()}|t|d"
    assert port_at.get_cache().stats()[key]["schema"] == port_at.CACHE_SCHEMA
    assert (tmp_path / "port.json").exists()
    assert not (tmp_path / "port.json.tmp").exists()
    # speculative=-1 reads the engine's own pair back
    _, tm = pair64
    store_gamma("gpt_l2_h48_v128", "ngram", 2)
    eng = ServingEngine(tm, block_size=4, num_blocks=32, speculative=-1,
                        device="cpu")
    assert eng.spec_gamma == 2
    eng.serve(requests(Request, ragged(2, max_new=6, seed=9)))
    assert eng.record_spec_tuning() == pick_gamma("gpt_l2_h48_v128",
                                                  "ngram")


def test_autotune_sweep_picks_the_fastest(tune_files):
    port_at, _ = tune_files
    cost = {"a": 3.0, "b": 1.0, "c": 2.0}

    def run(cfg):
        if cfg == "bad":
            raise ValueError("unsupported")
        return cfg
    best = port_at.autotune("k", "shape", ["a", "bad", "b", "c"], run,
                            measure=lambda fn: cost[fn()])
    assert best == "b"
    # cached: the sweep does not run again
    assert port_at.autotune("k", "shape", ["a"], None) == "b"
    port_flags.set_flags({"kernel_autotune": 0})
    try:
        assert port_at.get_cache().get("k", "shape") is None
    finally:
        port_flags.set_flags({"kernel_autotune": 1})
    with pytest.raises(ValueError, match="no candidate ran"):
        port_at.autotune("k", "other", ["bad"], run)

    def crash(cfg):
        if cfg == "b":
            raise RuntimeError("CUDA error: an illegal memory access")
        return cfg
    # a build or launch fault is not an unsupported shape: it propagates
    with pytest.raises(RuntimeError, match="illegal memory access"):
        port_at.autotune("k", "third", ["a", "b", "c"], crash,
                         measure=lambda fn: cost[fn()])
    assert port_at.get_cache().get("k", "third") is None


# ---------------------------------------------------------------------------
# 6. The knobs
# ---------------------------------------------------------------------------

def test_bucket_validation_matches_jax(pair64):
    jm, tm = pair64
    for bad in ([6], [512]):
        with pytest.raises(ValueError) as want:
            JaxServingEngine(jm, block_size=4, num_blocks=32,
                             prefill_buckets=bad)
        with pytest.raises(ValueError) as got:
            ServingEngine(tm, block_size=4, num_blocks=32,
                          prefill_buckets=bad, device="cpu")
        assert str(got.value) == str(want.value)


def test_knobs_detokenizer_buckets_and_arrivals(pair64):
    _, tm = pair64
    eng = ServingEngine(tm, block_size=4, num_blocks=32, max_batch=2,
                        prefill_buckets=[16], decode_buckets=[2],
                        detokenizer=lambda ids: "-".join(map(str, ids)),
                        device="cpu")
    assert eng.prefill_buckets.sizes == [16]
    assert eng.decode_buckets.sizes == [2]
    trace = ragged(3, max_new=3, seed=2)
    reqs = requests(Request, trace)
    for r, a in zip(reqs, (0.02, 0.0, 0.01)):
        r.arrival_s = a
    res = eng.serve(reqs, respect_arrivals=True)
    order = [s.rid for s in sorted(eng._seqs.values(),
                                   key=lambda s: s.t_submit)]
    assert order == ["r1", "r2", "r0"]
    for i, (p, n) in enumerate(trace):
        out = res[f"r{i}"].output
        np.testing.assert_array_equal(out, port_generate(tm, p, n))
        assert res[f"r{i}"].text == "-".join(map(str, out))
    assert eng.peak_blocks_used > 0
    eng.reset_peaks()
    assert eng.peak_blocks_used == eng.peak_live_blocks == 0


def test_none_reads_the_serve_flags(pair64):
    _, tm = pair64
    port_flags.set_flags({"serve_prefix_cache": True,
                          "serve_chunked_prefill": 6,
                          "serve_speculative": 3})
    try:
        eng = ServingEngine(tm, block_size=4, num_blocks=32, device="cpu")
    finally:
        port_flags.set_flags({"serve_prefix_cache": False,
                              "serve_chunked_prefill": 0,
                              "serve_speculative": 0})
    assert eng.prefix is not None and eng.chunk_tokens == 4
    assert eng.spec_gamma == 3 and isinstance(eng.drafter, NGramDrafter)
    off = ServingEngine(tm, block_size=4, num_blocks=32, device="cpu")
    assert off.prefix is None and off.chunk_tokens == 0
    assert off.spec_gamma == 0 and off.drafter is None
    assert off._chunk_fn is None and off._verify_fn is None
