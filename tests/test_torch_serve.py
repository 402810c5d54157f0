"""The port's continuous-batching engine (``nsa_tpu_torch/serve.py``)
against nsa_tpu's (``nsa_tpu/serve.py``) on the same weights, token for
token.

JAX's engine runs with ``attn_impl="xla"`` (its ragged XLA branches, the
fast way on the CPU); the port's with its ragged fused route (the kernels'
plain versions on the CPU), dense and paged, and on the split route.  The
cases mirror ``tests/test_serve.py``: one request and an exact-bucket
prompt, concurrent requests, continuous admission, ``steps_per_sync`` 1 and
3, the capacity tail, stop bytes, pool exhaustion, the paged pool's
capacity, oversize rejection, and what the port does not take (a paged
pool over a mesh, the full-attention model on the paged pool) raising.  Greedy tokens compare exactly; sampling at
temperature > 0 must repeat under the same seed.  Float32 on the CPU, the
tiny test configuration.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from nsa_tpu.config import tiny_test_config as j_tiny
from nsa_tpu.models.transformer import init_transformer
from nsa_tpu.serve import ContinuousBatchingEngine as JaxEngine
from nsa_tpu_torch import tiny_test_config as t_tiny
from nsa_tpu_torch.parallel.mesh import Mesh
from nsa_tpu_torch.serve import ContinuousBatchingEngine
from nsa_tpu_torch.utils.checkpoint import params_from_numpy

PROMPTS = (tuple(range(1, 10)), tuple(range(40, 52)), tuple(range(90, 98)))
ENGINES = {"dense": {}, "paged": dict(paged_pool_pages=16, page_tokens=8),
           "split": dict(route="split")}


@functools.lru_cache(maxsize=None)
def model_params():
    params = jax.jit(init_transformer, static_argnums=1)(jax.random.PRNGKey(0),
                                                         j_tiny(attn_impl="xla"))
    return params, params_from_numpy(jax.tree_util.tree_map(np.asarray, params), device="cpu")


def run(engine_cls, params, cfg, prompts, gens, stop=None, steps_before_add=None, **kw):
    """Add ``prompts`` (the last one after ``steps_before_add`` engine steps,
    when given) and run the engine; returns each request's tokens."""
    eng = engine_cls(params, cfg, **kw)
    rids = []
    for i, (p, n) in enumerate(zip(prompts, gens)):
        if steps_before_add is not None and i == len(prompts) - 1:
            for _ in range(steps_before_add):
                eng.step()
        rids.append(eng.add_request(np.asarray(p, np.int32), max_new_tokens=n, stop_byte=stop))
    outs = eng.run()
    return [outs[r] for r in rids], eng


@functools.lru_cache(maxsize=None)
def jax_outputs(prompts, gens, stop=None, steps_before_add=None, **kw):
    params, _ = model_params()
    return run(JaxEngine, params, j_tiny(attn_impl="xla"), prompts, gens, stop,
               steps_before_add, **kw)[0]


def port_run(kind, prompts, gens, stop=None, steps_before_add=None, **kw):
    _, port = model_params()
    return run(ContinuousBatchingEngine, port, t_tiny(), prompts, gens, stop, steps_before_add,
               **ENGINES[kind], **kw)


def assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kind", list(ENGINES))
def test_single_request_and_exact_bucket(kind):
    for prompt, buckets in ((PROMPTS[0], (8, 16)), (tuple(range(1, 9)), (8,))):
        kw = dict(max_batch=2, max_len=64, prefill_buckets=buckets)
        assert_same(port_run(kind, (prompt,), (6,), **kw)[0],
                    jax_outputs((prompt,), (6,), **kw))


@pytest.mark.parametrize("sps", [1, 3])
@pytest.mark.parametrize("kind", list(ENGINES))
def test_concurrent_requests(kind, sps):
    """Three requests through two slots: the third is admitted when one
    retires."""
    kw = dict(max_batch=2, max_len=64, prefill_buckets=(8, 16), steps_per_sync=sps)
    assert_same(port_run(kind, PROMPTS, (5, 7, 6), **kw)[0],
                jax_outputs(PROMPTS, (5, 7, 6), **kw))


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_continuous_admission(kind):
    """A request added after three steps joins the running one."""
    kw = dict(max_batch=2, max_len=64, prefill_buckets=(8, 16))
    prompts = (PROMPTS[0], tuple(range(30, 41)))
    assert_same(port_run(kind, prompts, (8, 4), steps_before_add=3, **kw)[0],
                jax_outputs(prompts, (8, 4), steps_before_add=3, **kw))


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_capacity_tail_single_steps(kind):
    """max_len 16, 4 tokens a sync: one window, then single steps until the
    cache is full; the request retires at capacity with JAX's tokens."""
    kw = dict(max_batch=1, max_len=16, prefill_buckets=(16,), steps_per_sync=4)
    got, eng = port_run(kind, (PROMPTS[0],), (16,), **kw)
    assert 1 <= len(got[0]) < 16
    assert_same(got, jax_outputs((PROMPTS[0],), (16,), **kw))
    assert eng.num_active == 0 and not eng.pending


@pytest.mark.parametrize("sps", [1, 3])
def test_stop_byte(sps):
    kw = dict(max_batch=1, max_len=64, prefill_buckets=(8,), steps_per_sync=sps)
    prompt = tuple(range(1, 9))
    full = jax_outputs((prompt,), (8,), **kw)[0]
    stop = int(full[2])
    got = port_run("dense", (prompt,), (8,), stop=stop, **kw)[0]
    assert_same(got, jax_outputs((prompt,), (8,), stop=stop, **kw))
    assert len(got[0]) <= 3


def test_paged_pool_exhaustion_queues():
    """Three pages for three requests of 2-3 pages each: they run (nearly)
    one at a time, come out exact, and every page returns to the free list
    with the table all trash."""
    kw = dict(max_batch=4, max_len=64, prefill_buckets=(8, 16))
    got, eng = run(ContinuousBatchingEngine, model_params()[1], t_tiny(), PROMPTS, (5, 5, 5),
                   paged_pool_pages=3, page_tokens=8, **kw)
    assert_same(got, jax_outputs(PROMPTS, (5, 5, 5), **kw))
    assert sorted(eng._free_pages) == [0, 1, 2]
    assert np.all(eng.page_table == eng.trash_page)


def test_paged_admits_more_than_dense_at_equal_memory():
    """16 pages of 8 rows hold what 2 dense slots of 64 rows do, and admit
    4 short requests at once."""
    prompts = tuple(tuple(range(1 + i, 10 + i)) for i in range(4))
    kw = dict(max_batch=4, max_len=64, prefill_buckets=(8, 16))
    eng = ContinuousBatchingEngine(model_params()[1], t_tiny(), paged_pool_pages=16,
                                   page_tokens=8, **kw)
    rids = [eng.add_request(np.asarray(p, np.int32), max_new_tokens=4) for p in prompts]
    eng._admit()
    assert eng.num_active == 4
    kv_rows = eng.cache_layers[0].kv.shape[0] * eng.cache_layers[0].kv.shape[2]
    assert kv_rows == 17 * 8 < 4 * 64
    outs = eng.run()
    assert_same([outs[r] for r in rids], jax_outputs(prompts, (4,) * 4, **kw))


def test_oversize_requests_rejected():
    _, port = model_params()
    eng = ContinuousBatchingEngine(port, t_tiny(), max_batch=1, max_len=32,
                                   prefill_buckets=(8,))
    with pytest.raises(ValueError):
        eng.add_request(np.zeros(32, np.int32), max_new_tokens=4)
    eng = ContinuousBatchingEngine(port, t_tiny(), max_batch=2, max_len=64, prefill_buckets=(8,),
                                   paged_pool_pages=2, page_tokens=8)
    with pytest.raises(ValueError):
        eng.add_request(np.arange(1, 30, dtype=np.int32), max_new_tokens=20)
    with pytest.raises(ValueError):
        ContinuousBatchingEngine(port, t_tiny(), max_len=64, paged_pool_pages=8, page_tokens=6)


def test_unported_options_raise():
    """A paged pool over a mesh (serving over a mesh takes the dense pool,
    as JAX's; ``tests/test_torch_parallel.py`` runs it), the full-attention
    model on the paged pool and a paged pool on the split route raise
    NotImplementedError."""
    _, port = model_params()
    with pytest.raises(NotImplementedError):
        ContinuousBatchingEngine(port, t_tiny(), max_len=64, paged_pool_pages=8, page_tokens=8,
                                 mesh=Mesh(("data", "heads"), (1, 1), (0, 0)), capture=False)
    with pytest.raises(NotImplementedError):
        ContinuousBatchingEngine(port, t_tiny(use_sparse_attn=False), max_len=64,
                                 paged_pool_pages=8, page_tokens=8)
    with pytest.raises(NotImplementedError):
        ContinuousBatchingEngine(port, t_tiny(), max_len=64, paged_pool_pages=8,
                                 page_tokens=8, route="split")


@pytest.mark.parametrize("sps", [1, 3])
def test_temperature_sampling_repeats_under_a_seed(sps):
    _, port = model_params()

    def sample(seed):
        kw = dict(max_batch=2, max_len=64, prefill_buckets=(8, 16), steps_per_sync=sps,
                  temperature=0.8, filter_thres=0.9, seed=seed)
        return run(ContinuousBatchingEngine, port, t_tiny(), PROMPTS[:2], (8, 8), **kw)[0]

    first, again, other = sample(3), sample(3), sample(4)
    assert_same(first, again)
    for toks in first:
        assert len(toks) == 8 and np.all((toks >= 0) & (toks < 256))
    assert any(not np.array_equal(a, b) for a, b in zip(first, other))


def test_engine_keeps_caches_on_the_params_device():
    _, port = model_params()
    eng = ContinuousBatchingEngine(port, t_tiny(), max_batch=2, max_len=64,
                                   paged_pool_pages=8, page_tokens=8)
    assert all(x.device == torch.device("cpu") for lc in eng.cache_layers for x in lc)
    assert eng._pt_dev.dtype == torch.int32 and eng._pt_dev.shape == (2, 8)
