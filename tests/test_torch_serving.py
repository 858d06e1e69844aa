"""Port parity: the serving engine, paged cache and allocator.

The ``tests/test_serving.py`` micro model, with its weights carried into the
port, serves the same ragged traces through the JAX ``ServingEngine`` and
the port's; outputs are token-exact against each other and against the
port's ``generate``, including a pool small enough to force preemption
(spill to host and restore). Also here: the import-isolation check (the
port loads neither ``jax`` nor ``paddle_tpu``) and the CPU behaviour of
``chip_smoke.py``.
"""

import ast
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.serving import BlockAllocator as JaxBlockAllocator
from paddle_tpu.serving import Request as JaxRequest
from paddle_tpu.serving import ServingEngine as JaxServingEngine
from paddle_tpu.text.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.text.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch.convert import from_jax_state_dict
from paddle_tpu_torch.serving import (BlockAllocator, NULL_BLOCK,
                                      PagedKVCache, Request, ServingEngine,
                                      Status)
from paddle_tpu_torch.text.models.gpt import GPTForCausalLM, gpt_tiny
from _torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MICRO = dict(vocab_size=128, hidden_size=48, num_layers=2, num_heads=4,
             max_position_embeddings=64)


def micro_pair(**over):
    """The test_serving micro model (JAX) and its port with the same
    weights."""
    cfg = {**MICRO, **over}
    paddle.seed(7)
    jm = JaxGPT(jax_gpt_tiny(**cfg))
    jm.eval()
    tm = GPTForCausalLM(gpt_tiny(**cfg), device="cpu")
    tm.load_state_dict(from_jax_state_dict(
        {k: np.asarray(v) for k, v in jm.state_dict().items()}))
    tm.eval()
    return jm, tm


def ragged_prompts(n, vocab=128, lo=3, hi=14, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(rng.integers(lo, hi + 1)))
            for _ in range(n)]


def serve_both(jm, tm, prompts, max_new, **engine_kw):
    """Serve the same trace through both engines; returns both result
    dicts and the port engine."""
    jreqs = [JaxRequest(rid=f"r{i}", prompt_ids=p, max_new_tokens=max_new)
             for i, p in enumerate(prompts)]
    treqs = [Request(rid=f"r{i}", prompt_ids=p, max_new_tokens=max_new)
             for i, p in enumerate(prompts)]
    jres = JaxServingEngine(jm, **engine_kw).serve(jreqs)
    eng = ServingEngine(tm, device="cpu", **engine_kw)
    tres = eng.serve(treqs)
    return jres, tres, eng


def port_generate(tm, prompt, max_new):
    return tm.generate(torch.from_numpy(np.asarray(prompt))[None].long(),
                       max_new_tokens=max_new)[0].numpy()


@pytest.mark.parametrize("variant", ["mha", "gqa"])
def test_engine_token_exact_vs_jax_engine_and_generate(variant):
    over = {} if variant == "mha" else {"num_kv_heads": 2}
    jm, tm = micro_pair(**over)
    prompts = ragged_prompts(5)
    jres, tres, eng = serve_both(jm, tm, prompts, 5, block_size=4,
                                 num_blocks=32, max_batch=4)
    assert eng.n_prefills == 5 and eng.n_preemptions == 0
    for i, p in enumerate(prompts):
        rid = f"r{i}"
        assert tres[rid].status is Status.FINISHED
        np.testing.assert_array_equal(tres[rid].output, jres[rid].output)
        np.testing.assert_array_equal(tres[rid].output,
                                      port_generate(tm, p, 5))
    assert eng.cache.allocator.n_used == 0
    eng.sched.assert_idle()


def test_preemption_spill_restore_token_exact():
    """A pool that forces preemption (spill to host, restore into other
    blocks): still token-exact, and the block grants — across the
    preemptions — are the JAX engine's, grant for grant."""
    jm, tm = micro_pair(max_position_embeddings=32)
    prompts = ragged_prompts(4, lo=8, hi=14, seed=1)
    kw = dict(block_size=4, num_blocks=10, max_batch=4, max_seq_len=32)
    jres, tres, eng = serve_both(jm, tm, prompts, 8, **kw)
    assert eng.n_preemptions >= 1
    assert any(-1 in tres[f"r{i}"].block_log for i in range(4))
    for i, p in enumerate(prompts):
        rid = f"r{i}"
        np.testing.assert_array_equal(tres[rid].output, jres[rid].output)
        np.testing.assert_array_equal(tres[rid].output,
                                      port_generate(tm, p, 8))
        assert tres[rid].block_log == jres[rid].block_log
        assert tres[rid].preemptions == jres[rid].preemptions
    assert eng.cache.allocator.n_used == 0


def test_prefill_bucket_past_position_table():
    """max_position_embeddings=30 with block_size 4: the 32-token bucket
    pads positions 30 and 31 past the table. The JAX engine's embedding
    gather gives NaN there, which reaches the real rows through 0 * NaN in
    the attention product; the port clamps the pad positions, so its
    engine agrees with both packages' ``generate``."""
    jm, tm = micro_pair(max_position_embeddings=30)
    prompt = np.arange(25) % 128
    eng = ServingEngine(tm, block_size=4, num_blocks=16, max_batch=2,
                        device="cpu")
    got = eng.serve([Request(rid="r", prompt_ids=prompt,
                             max_new_tokens=5)])["r"].output
    want = np.asarray(jm.generate(jnp.asarray(prompt[None]),
                                  max_new_tokens=5))[0]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, port_generate(tm, prompt, 5))


def test_allocator_order_matches_reference():
    ops = [("alloc", 3), ("alloc", 2), ("free", [2, 4]), ("alloc", 3),
           ("ref", [1]), ("free", [1]), ("free", [1, 3]), ("alloc", 4),
           ("alloc", 9), ("free", [5, 6])]
    a, b = BlockAllocator(10), JaxBlockAllocator(10)
    for op, arg in ops:
        assert getattr(a, op)(arg) == getattr(b, op)(arg)
        assert (a.n_free, a.n_used, a.n_shared) == \
            (b.n_free, b.n_used, b.n_shared)
    assert a.alloc(1)[0] != NULL_BLOCK
    with pytest.raises(ValueError, match="reserved"):
        a.free([NULL_BLOCK])
    with pytest.raises(ValueError, match="double-free"):
        a.free([9])


def test_paged_cache_spill_restore_bitwise():
    cache = PagedKVCache(n_layers=2, num_blocks=8, block_size=4, kv_heads=2,
                         head_dim=8)
    ids = cache.allocator.alloc(3)
    g = torch.Generator().manual_seed(0)
    kv = [torch.randn(2, 3, 4, 2, 8, generator=g) for _ in range(2)]
    cache.k[:, ids], cache.v[:, ids] = kv
    host = cache.spill(ids)
    assert cache.allocator.n_used == 0
    other = cache.allocator.alloc(1)               # shift the free list
    new_ids = cache.allocator.alloc(3)
    assert new_ids != ids
    cache.restore(host, new_ids)
    k_back, v_back = cache.read_blocks(new_ids)
    assert torch.equal(k_back, kv[0]) and torch.equal(v_back, kv[1])
    assert cache.bytes_per_block == 2 * 2 * 4 * 2 * 8 * 4
    with pytest.raises(ValueError, match="restore of 3 blocks"):
        cache.restore(host, other)


def test_port_imports_neither_jax_nor_paddle_tpu():
    """Importing every module of paddle_tpu_torch (and chip_smoke.py) in a
    fresh interpreter loads neither jax nor paddle_tpu."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import paddle_tpu_torch\n"
        "for m in pkgutil.walk_packages(paddle_tpu_torch.__path__,\n"
        "                               'paddle_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "       or k == 'paddle_tpu' or k.startswith('paddle_tpu.')]\n"
        "assert not bad, bad\n"
        "print(len([k for k in sys.modules\n"
        "           if k.startswith('paddle_tpu_torch')]))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 15
    # and no source file of the port names them in an import
    for root, _, files in os.walk(os.path.join(REPO, "paddle_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                tree = ast.parse(open(os.path.join(root, f)).read())
                for node in ast.walk(tree):
                    if isinstance(node, ast.Import):
                        names = [a.name for a in node.names]
                    elif isinstance(node, ast.ImportFrom):
                        names = [node.module or ""]
                    else:
                        continue
                    for n in names:
                        assert n.split(".")[0] not in ("jax", "paddle_tpu"), \
                            (f, n)


def test_chip_smoke_refuses_without_a_gpu(tmp_path):
    """Without CUDA (and in a directory holding only the script) the smoke
    run exits non-zero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py would run for real")
    src = os.path.join(REPO, "chip_smoke.py")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(src).read())
    for cwd, script in ((REPO, src), (str(tmp_path), str(alone))):
        out = subprocess.run([sys.executable, script], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
