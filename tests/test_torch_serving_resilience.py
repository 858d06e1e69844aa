"""Port parity: the serving engine's resilience tier.

The same traces go through JAX's engine and the port's on the
``tests/test_serving.py`` micro model, with JAX's weights carried into the
port: deadlines (certain to pass at once, or certain to hold), bounded
admission (``max_waiting`` and ``max_spilled_bytes``) with typed
``Rejected`` answers, load shedding (by the free-block fraction, and by a
decode p99 that any real step crosses) in shed and degraded modes, failure
isolation (a request that outgrows the pool, one the idle pool can never
admit, a ``SpillError`` injected at the ``serve.mid_spill`` fire point, a
request's own ``ValueError``) and the exactly-once request journal
(``tests/test_serving.py:278-560``, ``tests/test_race_drill.py:128``).
Statuses, outputs, ``Rejected`` reasons, F003 records and journal events
must agree, and every pool must end pristine. The port's one deliberate
difference is held too: a kernel launch error, or an error raised inside a
kernel wrapper, stops ``serve()`` instead of failing a request.
"""

import json
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.fault import injection as jinj
from paddle_tpu.serving import Rejected as JRejected
from paddle_tpu.serving import Request as JRequest
from paddle_tpu.serving import RequestJournal as JJournal
from paddle_tpu.serving import ServingEngine as JEngine
from paddle_tpu.serving import ShedPolicy as JShedPolicy
from paddle_tpu.serving import SpillError as JSpillError
from paddle_tpu.text.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.text.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch.convert import from_jax_state_dict
from paddle_tpu_torch.fault import injection as tinj
from paddle_tpu_torch.ops._hopper import KernelLaunchError
from paddle_tpu_torch.ops._hopper import flash_attention as hfa
from paddle_tpu_torch.serving import (NULL_BLOCK, Rejected, Request,
                                      RequestJournal, ServingEngine,
                                      ShedPolicy, SpillError, Status,
                                      prompt_hash)
from paddle_tpu_torch.text.models.gpt import GPTForCausalLM, gpt_tiny
from _torch_threads import one_torch_thread  # noqa: F401

MICRO = dict(vocab_size=128, hidden_size=48, num_layers=2, num_heads=4,
             max_position_embeddings=64)


def carried(**over):
    cfg = {**MICRO, **over}
    paddle.seed(7)
    jm = JaxGPT(jax_gpt_tiny(**cfg))
    jm.eval()
    tm = GPTForCausalLM(gpt_tiny(**cfg), device="cpu")
    tm.load_state_dict(from_jax_state_dict(
        {k: np.asarray(v) for k, v in jm.state_dict().items()}))
    return jm, tm.eval()


@pytest.fixture(scope="module")
def pair64():
    return carried()


@pytest.fixture(scope="module")
def pair32():
    return carried(max_position_embeddings=32)


def ragged(n, lo=3, hi=14, max_new=5, seed=0):
    """``tests/test_serving.py``'s ``ragged_requests`` as plain specs."""
    rng = np.random.default_rng(seed)
    return [dict(rid=f"r{i}", prompt_ids=rng.integers(
        0, 128, int(rng.integers(lo, hi + 1))), max_new_tokens=max_new)
        for i in range(n)]


def both(specs, **over):
    """The same requests for JAX's engine and the port's."""
    return ([JRequest(**{**s, **over}) for s in specs],
            [Request(**{**s, **over}) for s in specs])


def outcome(res):
    """``rid -> (status or "rejected", reason/error, output list)``;
    deadline errors cut to their first words (they carry elapsed times)."""
    out = {}
    for rid, r in res.items():
        if isinstance(r, (Rejected, JRejected)):
            assert not r
            out[rid] = ("rejected", r.reason, None)
            continue
        err = r.error
        if err is not None and err.startswith("deadline"):
            err = err.split(" exceeded")[0]
        if err is not None and err.startswith("load shed: p99"):
            err = "load shed: p99"
        out[rid] = (r.status.value, err,
                    None if getattr(r, "output", None) is None
                else r.output.tolist())
    return out


def pristine(engine):
    """Zero leaked blocks and an intact min-id free list, as
    ``tests/test_serving.py``'s ``assert_allocator_pristine``."""
    alloc = engine.cache.allocator
    assert alloc.n_used == 0
    n = alloc.num_blocks - 1
    got = alloc.alloc(n)
    assert got == list(range(1, n + 1)), got
    alloc.free(got)
    engine.sched.assert_idle()


class Pair:
    """One trace served by both engines (the same kwargs)."""

    def __init__(self, pair, specs, over=None, jax_kw=None, port_kw=None,
                 **kw):
        jm, self.tm = pair
        jreqs, treqs = both(specs, **(over or {}))
        self.jax = JEngine(jm, **{**kw, **(jax_kw or {})})
        self.jres = self.jax.serve(jreqs)
        self.port = ServingEngine(self.tm, device="cpu",
                                  **{**kw, **(port_kw or {})})
        self.tres = self.port.serve(treqs)
        self.specs = specs

    def check(self):
        """Same outcomes, same mode, same F003 rules and failed rids; every
        FINISHED output equal to the port's ``generate``; both pools
        pristine."""
        assert outcome(self.tres) == outcome(self.jres)
        assert self.port.mode == self.jax.mode
        assert [d.rule for d in self.port.diagnostics] == \
            [d.rule for d in self.jax.diagnostics]
        assert [r.rid for r in self.port.rejections] == \
            [r.rid for r in self.jax.rejections]
        for s in self.specs:
            r = self.tres[s["rid"]]
            if not isinstance(r, Rejected) and r.status is Status.FINISHED:
                want = self.tm.generate(
                    torch.from_numpy(np.asarray(s["prompt_ids"])[None]),
                    max_new_tokens=s["max_new_tokens"])[0].numpy()
                np.testing.assert_array_equal(r.output, want)
        pristine(self.port)
        pristine(self.jax)
        return {rid: o[0] for rid, o in outcome(self.tres).items()}


# -- deadlines ----------------------------------------------------------------

def test_expired_requests_cancelled_clean(pair64):
    """Deadlines of 1 ns expire every request at the first iteration, before
    any device work; each ends EXPIRED with a deadline reason."""
    p = Pair(pair64, ragged(3), over=dict(deadline_s=1e-9), block_size=4,
             num_blocks=32, max_batch=4)
    assert set(p.check().values()) == {"expired"}


def test_generous_deadline_met(pair64):
    p = Pair(pair64, ragged(2), over=dict(deadline_s=300.0), block_size=4,
             num_blocks=32, max_batch=4)
    assert set(p.check().values()) == {"finished"}
    for s in p.tres.values():
        assert s.t_done - s.t_submit <= 300.0


def test_preemption_keeps_true_submit_time(pair32):
    """``_preempt`` restarts the queue clock (``t_requeue``) and never
    rewrites ``t_submit``; the trace preempts in both engines alike."""
    p = Pair(pair32, ragged(4, lo=8, hi=14, max_new=8, seed=1),
             block_size=4, num_blocks=10, max_batch=4, max_seq_len=32)
    p.check()
    pre = [s for s in p.tres.values() if s.preemptions > 0]
    assert pre and [s.rid for s in pre] == [
        s.rid for s in p.jres.values() if s.preemptions > 0]
    for seq in pre:
        assert seq.t_requeue > seq.t_submit
        assert seq.t_first_token > seq.t_submit


# -- bounded admission --------------------------------------------------------

def test_queue_full_returns_typed_rejection(pair64):
    """``max_waiting=2`` with everything submitted up front: four of six
    are refused ``queue_full``, falsy, recorded in ``rejections``."""
    p = Pair(pair64, ragged(6), block_size=4, num_blocks=32, max_batch=2,
             max_waiting=2)
    got = p.check()
    assert sorted(got.values()) == ["finished"] * 2 + ["rejected"] * 4
    assert {r.reason for r in p.port.rejections} == {"queue_full"}


def test_spill_budget_rejects(pair32):
    """``max_spilled_bytes=0``: once a preemption holds host KV, a new
    submission is refused ``spill_budget``; stepping both engines to that
    point by hand takes the same number of iterations."""
    jm, tm = pair32
    specs = ragged(4, lo=8, hi=14, max_new=8, seed=1)
    kw = dict(block_size=4, num_blocks=10, max_batch=4, max_seq_len=32,
              max_spilled_bytes=0)
    late = dict(rid="late", prompt_ids=np.ones(4, np.int32),
                max_new_tokens=2)
    steps = {}
    for name, eng, reqs, req_cls in (
            ("jax", JEngine(jm, **kw), both(specs)[0], JRequest),
            ("port", ServingEngine(tm, device="cpu", **kw), both(specs)[1],
             Request)):
        for r in reqs:
            eng.submit(r)
        n = 0
        while not eng.sched.running or not any(
                s.host_kv is not None for s in eng.sched.waiting):
            assert eng.sched.n_pending, "the trace no longer preempts"
            eng.step()
            n += 1
        rej = eng.submit(req_cls(**late))
        assert not rej and rej.reason == "spill_budget"
        while eng.sched.n_pending:
            eng.step()
        steps[name] = n
        pristine(eng)
    assert steps["port"] == steps["jax"]


def test_preempted_resident_not_counted_against_queue():
    from paddle_tpu_torch.serving import FCFSScheduler, Sequence
    sched = FCFSScheduler(2, max_waiting=1)
    a = Sequence(Request(rid="a", prompt_ids=np.ones(4, np.int32),
                         max_new_tokens=2))
    sched.submit(a)
    sched.admit(a)
    sched.preempt(a)
    assert a.status is Status.PREEMPTED and sched.can_accept()


# -- load shedding ------------------------------------------------------------

def test_sheds_lowest_priority_youngest_first(pair64):
    """A free-fraction threshold above 1 keeps the policy tripped: every
    request is shed, lowest priority first, youngest within the class."""
    rng = np.random.default_rng(0)
    specs = [dict(rid=f"r{i}", prompt_ids=rng.integers(0, 128, 6),
                  max_new_tokens=3, priority=(1 if i == 0 else 0))
             for i in range(4)]
    p = Pair(pair64, specs, block_size=4, num_blocks=32, max_batch=4,
             jax_kw=dict(shed_policy=JShedPolicy(min_free_block_frac=2.0)),
             port_kw=dict(shed_policy=ShedPolicy(min_free_block_frac=2.0)))
    assert set(p.check().values()) == {"shed"}
    order = [s.rid for s in p.port.sched.finished]
    assert order == ["r3", "r2", "r1", "r0"] == [
        s.rid for s in p.jax.sched.finished]
    assert p.port.mode == "shedding"


@pytest.mark.parametrize("trigger", ["p99", "free_frac"])
def test_degraded_mode(pair32, trigger):
    """Degraded mode shrinks the decode bucket a rung (the youngest
    residents preempted through the spill path) and sheds only waiting
    work; survivors are token-exact. ``p99``: a 1 ns decode p99 that any
    real iteration crosses; ``free_frac``: below 75% free blocks of a
    12-block pool."""
    pol = dict(max_p99_decode_ms=1e-6, degrade=True) if trigger == "p99" \
        else dict(min_free_block_frac=0.75, degrade=True)
    p = Pair(pair32, ragged(4, lo=4, hi=8, max_new=6, seed=5),
             block_size=4, num_blocks=32 if trigger == "p99" else 12,
             max_batch=4, max_seq_len=32,
             jax_kw=dict(shed_policy=JShedPolicy(**pol)),
             port_kw=dict(shed_policy=ShedPolicy(**pol)))
    got = p.check()
    assert "finished" in got.values() and "shed" in got.values()
    assert p.port.mode == "degraded"


def test_healthy_policy_changes_nothing(pair64):
    """An armed policy that never trips leaves outputs and block logs as
    the bare engine's (and as JAX's)."""
    _, tm = pair64
    specs = ragged(3)

    def run(policy):
        eng = ServingEngine(tm, block_size=4, num_blocks=32, max_batch=4,
                            shed_policy=policy, device="cpu")
        res = eng.serve(both(specs)[1])
        return {s["rid"]: (res[s["rid"]].output.tolist(),
                           res[s["rid"]].block_log) for s in specs}

    assert run(None) == run(ShedPolicy(min_free_block_frac=0.0))


# -- failure isolation --------------------------------------------------------

def test_pool_exhaustion_fails_request_not_engine(pair64):
    """``validate_capacity=False``: a request that outgrows a 5-block pool
    mid-decode ends FAILED with an F003 record; the other is served."""
    rng = np.random.default_rng(2)
    specs = [dict(rid="grower", prompt_ids=rng.integers(0, 128, 16),
                  max_new_tokens=8),
             dict(rid="small", prompt_ids=rng.integers(0, 128, 4),
                  max_new_tokens=3)]
    p = Pair(pair64, specs, block_size=4, num_blocks=6, max_batch=2,
             validate_capacity=False)
    assert p.check() == {"grower": "failed", "small": "finished"}
    assert "nothing left to preempt" in p.tres["grower"].error
    assert [d.rule for d in p.port.diagnostics] == ["F003"]


def test_impossible_admission_fails_request(pair64):
    """A prompt the idle pool can never grant fails at admission instead
    of stalling the loop."""
    rng = np.random.default_rng(3)
    specs = [dict(rid="big", prompt_ids=rng.integers(0, 128, 20),
                  max_new_tokens=4),
             dict(rid="small", prompt_ids=rng.integers(0, 128, 4),
                  max_new_tokens=2)]
    p = Pair(pair64, specs, block_size=4, num_blocks=4, max_batch=2,
             validate_capacity=False)
    assert p.check() == {"big": "failed", "small": "finished"}


def test_spill_error_isolated_to_victim(pair32):
    """A ``SpillError`` raised at the first ``serve.mid_spill`` (each
    package's own fire point) fails only the spill victim, the same one in
    both engines; the others are served token-exact."""
    counts = {"jax": 0, "port": 0}

    def bomb(name, exc):
        def fire():
            counts[name] += 1
            if counts[name] == 1:
                raise exc("injected host allocation failure")
        return fire

    jinj.register_fire_point("serve.mid_spill", bomb("jax", JSpillError))
    tinj.register_fire_point("serve.mid_spill", bomb("port", SpillError))
    try:
        p = Pair(pair32, ragged(4, lo=8, hi=14, max_new=8, seed=1),
                 block_size=4, num_blocks=10, max_batch=4, max_seq_len=32)
    finally:
        jinj.register_fire_point("serve.mid_spill", None)
        tinj.register_fire_point("serve.mid_spill", None)
    got = p.check()
    assert counts["port"] == counts["jax"] >= 1
    failed = [rid for rid, st in got.items() if st == "failed"]
    assert len(failed) == 1
    assert "KV spill failed" in p.tres[failed[0]].error


def test_a_request_value_error_fails_that_request(pair64):
    """A ``ValueError`` the prefill raises for one request (outside the
    kernel wrappers) fails that request in both engines (JAX fails it for
    any exception); the loop serves the rest."""
    jm, tm = pair64

    def poisoned(eng, n_real_arg):
        real = eng._prefill_fn

        def prefill(*a):
            if int(a[n_real_arg]) == 11:      # r1's prompt length
                raise ValueError("malformed request")
            return real(*a)
        eng._prefill_fn = prefill

    specs = ragged(3, seed=0)
    assert [len(s["prompt_ids"]) for s in specs].count(11) == 1
    jreqs, treqs = both(specs)
    je = JEngine(jm, block_size=4, num_blocks=32, max_batch=4)
    poisoned(je, 4)
    te = ServingEngine(tm, block_size=4, num_blocks=32, max_batch=4,
                       device="cpu")
    poisoned(te, 2)
    jres, tres = je.serve(jreqs), te.serve(treqs)
    assert outcome(tres) == outcome(jres)
    assert [s.status for s in tres.values()].count(Status.FAILED) == 1
    pristine(te)


def test_kernel_errors_stop_serve(pair64):
    """The port's deliberate difference: a kernel launch error
    (``KernelLaunchError``) and an error raised inside a kernel wrapper
    (``flash_fwd``'s argument check, a ``ValueError`` in ``ops/_hopper``)
    propagate out of ``serve()``; JAX would fail the request instead."""
    _, tm = pair64

    def launch_error(*a):
        raise KernelLaunchError("flash_fwd_tc kernel launch failed: "
                                "too many resources requested (stub)")

    def wrapper_error(*a):
        hfa.flash_fwd(torch.zeros(2, 3), torch.zeros(2, 3),
                      torch.zeros(2, 3))

    for stub, exc in ((launch_error, KernelLaunchError),
                      (wrapper_error, ValueError)):
        eng = ServingEngine(tm, block_size=4, num_blocks=32, max_batch=4,
                            device="cpu")
        eng._prefill_fn = stub
        with pytest.raises(exc):
            eng.serve(both(ragged(2))[1])
        assert eng.diagnostics == []


def test_mid_decode_seam_fires_before_commit(pair64):
    """``serve.mid_decode`` fires once a decode iteration, after its
    compute and before its tokens are committed: a callback sees every
    resident's token count unchanged since the iteration began."""
    _, tm = pair64
    eng = ServingEngine(tm, block_size=4, num_blocks=32, max_batch=4,
                        device="cpu")
    seen = []

    def probe():
        seen.append(sum(s.n_generated for s in eng.sched.running))

    tinj.register_fire_point("serve.mid_decode", probe)
    try:
        res = eng.serve(both(ragged(2, max_new=3))[1])
    finally:
        tinj.clear_fire_points()
    assert seen and len(seen) == len(eng.decode_ms)
    assert all(s.status is Status.FINISHED for s in res.values())


def overload_trace(vocab=128):
    """bench.py's overload trace (``bench_serve_resilience``, seed 11): the
    pool hog first (a 120-token prompt, priority 2), then 16 requests of
    16-32 prompt tokens and 16 new ones, every third with a deadline
    already past (1 ns, priority 0), the rest 120 s (priority 1)."""
    rng = np.random.default_rng(11)
    specs = [dict(rid="hog", prompt_ids=rng.integers(0, vocab, 120),
                  max_new_tokens=8, deadline_s=120.0, priority=2)]
    for i in range(16):
        plen = int(rng.integers(16, 33))
        tight = i % 3 == 2
        specs.append(dict(rid=f"ov{i}", prompt_ids=rng.integers(0, vocab,
                                                                  plen),
                          max_new_tokens=16,
                          deadline_s=1e-9 if tight else 120.0,
                          priority=0 if tight else 1))
    return specs


@pytest.fixture(scope="module")
def pair160():
    return carried(max_position_embeddings=160)


def test_overload_trace_matches_jax(pair160):
    """The chip phase's trace on both engines: a 16-block pool of 8-token
    blocks, ``max_batch=4``, ``max_waiting=8``, the degrade-mode policy
    (20% free blocks, a 5 s decode p99), ``validate_capacity=False`` and a
    ``SpillError`` at the first spill. The hog and the one spill victim
    end FAILED and nobody else; the same requests expire, are shed,
    refused ``queue_full`` or finish token-exact in both engines."""
    counts = {"jax": 0, "port": 0}

    def bomb(name, exc):
        def fire():
            counts[name] += 1
            if counts[name] == 1:
                raise exc("injected host allocation failure")
        return fire

    kw = dict(block_size=8, num_blocks=16, max_batch=4, max_waiting=8,
              validate_capacity=False)
    pol = dict(min_free_block_frac=0.2, max_p99_decode_ms=5e3, degrade=True)
    jinj.register_fire_point("serve.mid_spill", bomb("jax", JSpillError))
    tinj.register_fire_point("serve.mid_spill", bomb("port", SpillError))
    try:
        p = Pair(pair160, overload_trace(),
                 jax_kw=dict(shed_policy=JShedPolicy(**pol)),
                 port_kw=dict(shed_policy=ShedPolicy(**pol)), **kw)
    finally:
        jinj.register_fire_point("serve.mid_spill", None)
        tinj.register_fire_point("serve.mid_spill", None)
    got = p.check()
    failed = sorted(rid for rid, st in got.items() if st == "failed")
    assert len(failed) == 2 and "hog" in failed
    assert {"finished", "expired", "shed", "rejected"} <= set(got.values())
    assert counts["port"] == counts["jax"] >= 1


# -- the request journal ------------------------------------------------------

def _events(journal):
    return [{k: v for k, v in e.items()} for e in journal.events()]


def test_journal_round_trip_matches_jax(pair64, tmp_path):
    """A journaled trace: the port's journal holds JAX's events line for
    line (launch, each submission with its prompt hash, each ``done``
    with its tokens); the replay report is exactly-once."""
    jm, tm = pair64
    specs = ragged(3)
    jp, tp = str(tmp_path / "jax.jsonl"), str(tmp_path / "port.jsonl")
    jreqs, treqs = both(specs)
    jres = JEngine(jm, block_size=4, num_blocks=32, max_batch=2,
                   journal=JJournal(jp)).serve(jreqs)
    tres = ServingEngine(tm, block_size=4, num_blocks=32, max_batch=2,
                         journal=RequestJournal(tp), device="cpu"
                         ).serve(treqs)
    assert outcome(tres) == outcome(jres)
    with open(jp) as f, open(tp) as g:
        assert [json.loads(x) for x in g] == [json.loads(x) for x in f]
    replay = RequestJournal(tp)
    rids = [s["rid"] for s in specs]
    report = replay.exactly_once_report(rids)
    assert report["exactly_once"] and report["launches"] == 1
    assert replay.pending_rids(rids) == []
    outs = replay.done_outputs()
    for s in specs:
        assert list(s["prompt_ids"]) + outs[s["rid"]] == \
            tres[s["rid"]].output.tolist()
    assert replay.prompt_hashes() == {s["rid"]: prompt_hash(s["prompt_ids"])
                                      for s in specs}


def test_journal_records_terminal_outcomes(pair64, tmp_path):
    """Rejected, expired and shed requests are acknowledged with their
    reasons, in JAX's order (events compared without the elapsed times)."""
    jm, tm = pair64
    specs = ragged(5)
    over = [dict(), dict(deadline_s=1e-9), dict(), dict(), dict()]
    for name, eng_cls, req_cls, j_cls, pol in (
            ("jax", JEngine, JRequest, JJournal, JShedPolicy),
            ("port", ServingEngine, Request, RequestJournal, ShedPolicy)):
        kw = {} if name == "jax" else {"device": "cpu"}
        eng = eng_cls(jm if name == "jax" else tm, block_size=4,
                      num_blocks=32, max_batch=2, max_waiting=3,
                      shed_policy=pol(min_free_block_frac=0.9),
                      journal=j_cls(str(tmp_path / f"{name}.jsonl")), **kw)
        eng.serve([req_cls(**s, **o) for s, o in zip(specs, over)])
    logs = {}
    for name in ("jax", "port"):
        with open(tmp_path / f"{name}.jsonl") as f:
            logs[name] = [(e["event"], e.get("rid"),
                           e.get("reason", "").split(" (")[0].split(
                               "ms exceeded")[0]) for e in map(json.loads, f)]
    assert logs["port"] == logs["jax"]
    kinds = {e for e, _, _ in logs["port"]}
    assert {"rejected", "expired", "shed"} <= kinds


def test_unacknowledged_requests_replay(tmp_path):
    """Submitted-but-unacknowledged state is the replay set, in both
    packages' journals alike."""
    reports = []
    for j_cls, req_cls in ((JJournal, JRequest), (RequestJournal, Request)):
        path = str(tmp_path / f"{j_cls.__module__}.jsonl")
        j = j_cls(path)
        j.launch()
        for rid in ("a", "b", "c"):
            j.submitted(req_cls(rid=rid, prompt_ids=np.ones(4, np.int32),
                                max_new_tokens=2))
        j.done("a", [5, 6])
        j.terminal("b", "expired", "deadline")
        j.close()
        j2 = j_cls(path)
        reports.append((j2.pending_rids(["a", "b", "c"]),
                        j2.exactly_once_report(["a", "b", "c"]),
                        j2.ack_outcomes(), sorted(j2.submitted_rids())))
    assert reports[1] == reports[0]
    assert reports[1][0] == ["c"] and reports[1][1]["lost"] == ["c"]
    with pytest.raises(ValueError, match="terminal"):
        RequestJournal(str(tmp_path / "x.jsonl")).terminal("a", "finished")


def test_torn_tail_and_duplicate_ack(tmp_path):
    path = str(tmp_path / "journal.jsonl")
    j = RequestJournal(path)
    j.launch()
    j.done("a", [1])
    j.close()
    with open(path, "a") as f:
        f.write('{"event": "done", "rid": "b", "tok')   # torn by a kill
    assert RequestJournal(path).acknowledged_rids() == {"a"}
    j = RequestJournal(str(tmp_path / "d.jsonl"))
    j.done("a", [1])
    j.done("a", [1])
    report = j.exactly_once_report(["a"])
    assert report["duplicated"] == ["a"] and not report["exactly_once"]


def test_request_journal_exactly_once_8_writers(tmp_path):
    """8 threads submit and acknowledge disjoint rids through one journal:
    every line parses and the reloaded journal is exactly-once."""

    class _Req:
        def __init__(self, rid):
            self.rid = rid
            self.prompt_ids = np.asarray([1, 2, 3], np.int32)
            self.max_new_tokens = 2
            self.eos_token_id = None
            self.deadline_s = None
            self.priority = 0

    path = str(tmp_path / "j.jsonl")
    j = RequestJournal(path)
    j.launch()
    n, per = 8, 25
    rids = [[f"w{w}r{i}" for i in range(per)] for w in range(n)]
    errs = []

    def worker(w):
        try:
            for rid in rids[w]:
                j.submitted(_Req(rid))
                j.done(rid, [w])
        except Exception as e:  # surfaced below
            errs.append(e)

    ts = [threading.Thread(target=worker, args=(w,)) for w in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    j.close()
    assert errs == []
    with open(path) as f:
        lines = [ln for ln in f.read().splitlines() if ln]
    assert len([json.loads(ln) for ln in lines]) == 1 + 2 * n * per
    expected = [r for ws in rids for r in ws]
    report = RequestJournal(path).exactly_once_report(expected)
    assert report["exactly_once"] and report["acknowledged"] == n * per


def test_null_block_never_granted_after_failures(pair64):
    """After a failed admission and a failed decode the null block is still
    reserved: no grant ever hands it out."""
    _, tm = pair64
    eng = ServingEngine(tm, block_size=4, num_blocks=6, max_batch=2,
                        validate_capacity=False, device="cpu")
    rng = np.random.default_rng(2)
    eng.serve([Request(rid="g", prompt_ids=rng.integers(0, 128, 16),
                       max_new_tokens=8),
               Request(rid="b", prompt_ids=rng.integers(0, 128, 24),
                       max_new_tokens=2)])
    assert NULL_BLOCK not in eng.cache.allocator.alloc(5)
