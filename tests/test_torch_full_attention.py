"""The full-attention baseline through both packages (float32, CPU).

* ``flash_attention`` on CPU tensors (its plain version) against JAX's
  Pallas ``flash_attention`` in interpret mode with 128-row tiles, causal
  and not, at a multiple of the tile and at a ragged length;
* ``full_attention`` (queries at the last keys) and
  ``full_attention_chunked`` (queries at the first keys, here n 300 over
  chunks of 128) against JAX's;
* the full model from a JAX random init: forward logits, the prefill's
  logits and cache, 8 greedy decode steps at a scalar position, and one
  ragged step at mixed per-row positions;
* the port's serving engine against JAX's ``xla`` engine on the full model,
  token for token, and its paged pool raising;
* the committed weights ``ckpt_export/full_attn_seq4096.npz`` at bs 1,
  prompt 256, 16 greedy steps.

Tolerances: attention outputs rtol 2e-4 / atol 2e-5, as
``tests/test_pallas_kernels.py`` holds JAX's flash kernel to its oracle
(float32 sums in another order); logits atol/rtol 2e-4, the repo's
prefill/decode tolerance; cache rows atol/rtol 1e-5 (one projection and a
rotation); tokens exact.  The flash kernel keeps its softmax weights float32
through P.V, while ``attend`` (JAX's and the port's) casts them to the
input dtype first: the same in float32, not bit for bit in bf16.
"""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsa_tpu.config import model_config_from_json
from nsa_tpu.config import tiny_test_config as j_tiny
from nsa_tpu.eval import efficiency as j_eff
from nsa_tpu.models import transformer as jt
from nsa_tpu.ops import attention as j_att
from nsa_tpu.ops.pallas.flash import flash_attention as j_flash
from nsa_tpu.serve import ContinuousBatchingEngine as JaxEngine
from nsa_tpu.utils.checkpoint import import_params_npz
from nsa_tpu_torch import bench as t_bench
from nsa_tpu_torch import tiny_test_config as t_tiny
from nsa_tpu_torch.eval import efficiency as t_eff
from nsa_tpu_torch.models import transformer as tt
from nsa_tpu_torch.ops import attention as t_att
from nsa_tpu_torch.ops.cuda import flash as t_flash
from nsa_tpu_torch.serve import ContinuousBatchingEngine
from nsa_tpu_torch.utils.checkpoint import (
    load_params_npz,
    model_config_from_meta,
    params_from_numpy,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "ckpt_export", "full_attn_seq4096.npz")
ATT_TOL = dict(rtol=2e-4, atol=2e-5)
TOL = dict(rtol=2e-4, atol=2e-4)
CACHE_TOL = dict(rtol=1e-5, atol=1e-5)


def qkv(b, h, kvh, n, d, seed, n_k=None):
    rs = np.random.RandomState(seed)
    n_k = n if n_k is None else n_k
    return (rs.randn(b, h, n, d).astype(np.float32), rs.randn(b, kvh, n_k, d).astype(np.float32),
            rs.randn(b, kvh, n_k, d).astype(np.float32))


def to_t(*xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("n,causal", [(256, True), (300, True), (300, False)])
def test_flash_plain_matches_pallas_interpret(n, causal):
    q, k, v = qkv(2, 4, 2, n, 64, seed=n + causal)
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                   interpret=True, block_q=128, block_k=128)
    got = t_flash.flash_attention(*to_t(q, k, v), causal=causal)     # CPU: the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATT_TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("fn", ["full_attention", "full_attention_chunked"])
def test_full_attention_ops_match_jax(fn, causal):
    n = 300
    q, k, v = qkv(2, 4, 2, n, 16, seed=7)
    kw = dict(chunk=128) if fn == "full_attention_chunked" else {}
    want = getattr(j_att, fn)(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                              **kw)
    got = getattr(t_att, fn)(*to_t(q, k, v), causal=causal, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATT_TOL)


def test_full_attention_aligns_queries_to_the_last_keys():
    """With fewer queries than keys, ``full_attention`` puts them at the
    last positions, the flash kernel at the first."""
    q, k, v = qkv(1, 4, 2, 5, 16, seed=3, n_k=12)
    want = j_att.full_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = t_att.full_attention(*to_t(q, k, v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATT_TOL)
    first = t_flash.flash_attention_plain(*to_t(q, k, v))
    np.testing.assert_allclose(first.numpy(), t_att.full_attention(*to_t(q, k[:, :, :5],
                                                                         v[:, :, :5])).numpy(),
                               **ATT_TOL)


def kernel_numerics(q, k, v, drop=None):
    """Causal attention as the CUDA kernel rounds it (float32 logits and row
    sum, the softmax weights rounded to bf16 for P.V, the output to bf16),
    in one tile; ``drop`` = (key0, key1) leaves those keys out for every
    query row past them, as a kernel that skipped a key tile would."""
    n, g = q.shape[2], q.shape[1] // k.shape[1]
    kf, vf = (x.float().repeat_interleave(g, 1) for x in (k, v))
    s = (q.float() * q.shape[-1] ** -0.5) @ kf.transpose(-1, -2)
    rows, cols = torch.arange(n)[:, None], torch.arange(n)[None, :]
    valid = rows >= cols
    if drop is not None:
        valid &= ~((cols >= drop[0]) & (cols < drop[1]) & (rows >= drop[1]))
    p = torch.exp(s.masked_fill(~valid, -1e30) - s.masked_fill(~valid, -1e30).amax(-1, True))
    p = p.masked_fill(~valid, 0.0)
    o = (p.to(torch.bfloat16).float() @ vf) / p.sum(-1, keepdim=True)
    return o.to(torch.bfloat16)


def test_flash_tolerance_holds_the_kernels_rounding_and_rejects_a_dropped_tile():
    """The elementwise rule that holds the CUDA kernel to its plain version
    (``flash_attention_tolerance``) passes an output rounded as the kernel
    rounds it, and fails one with a middle 64-key tile left out of the late
    query rows."""
    gen = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(s, generator=gen).to(torch.bfloat16)
               for s in ((2, 4, 640, 64), (2, 2, 640, 64), (2, 2, 640, 64)))
    want = t_flash.flash_attention_plain(q, k, v)
    tol = t_flash.flash_attention_tolerance(q, k, v, want)

    def worst(got):
        return ((got.float() - want.float()).abs() / tol).max().item()

    assert worst(kernel_numerics(q, k, v)) <= 1.0
    assert worst(kernel_numerics(q, k, v, drop=(256, 320))) > 1.0


@functools.lru_cache(maxsize=None)
def model_params(seed=0):
    params = jax.jit(jt.init_transformer, static_argnums=1)(
        jax.random.PRNGKey(seed), j_tiny(use_sparse_attn=False))
    return params, params_from_numpy(jax.tree_util.tree_map(np.asarray, params), device="cpu")


def prompt_ids(b, n, seed):
    return np.random.RandomState(seed).randint(0, 256, (b, n)).astype(np.int32)


def test_full_init_layout_matches_jax():
    params, _ = model_params()
    port = tt.init_transformer(t_tiny(use_sparse_attn=False), torch.Generator().manual_seed(0),
                               device="cpu")
    assert (jax.tree_util.tree_map(lambda x: tuple(x.shape), port)
            == jax.tree_util.tree_map(lambda x: x.shape, params))


def test_full_model_prefill_and_greedy_decode_match_jax():
    params, port = model_params()
    j_cfg, t_cfg = j_tiny(use_sparse_attn=False), t_tiny(use_sparse_attn=False)
    prompt, steps, max_len = 13, 8, 32
    ids = prompt_ids(2, prompt, seed=1)
    with torch.no_grad():
        fwd = tt.transformer_forward(port, t_cfg, torch.from_numpy(ids))
        t_logits, t_cache = tt.transformer_prefill(port, t_cfg, torch.from_numpy(ids), max_len)
    j_fwd = jax.jit(lambda p, i: jt.transformer_forward(p, j_cfg, i))
    np.testing.assert_allclose(fwd.numpy(), np.asarray(j_fwd(params, jnp.asarray(ids))), **TOL)
    j_logits, j_cache = jax.jit(lambda p, i: jt.transformer_prefill(p, j_cfg, i, max_len))(
        params, jnp.asarray(ids))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), **TOL)

    def assert_cache(t):
        for lt, lj in zip(t_cache.layers, j_cache.layers):
            assert isinstance(lt, tt.KVDecodeCache)
            np.testing.assert_allclose(lt.kv[:, :, :t].numpy(), np.asarray(lj.kv)[:, :, :t],
                                       **CACHE_TOL)

    assert_cache(prompt)
    j_step = jax.jit(lambda p, tok, c: jt.transformer_decode_step(p, j_cfg, tok, c))
    token = np.asarray(j_logits[:, -1]).argmax(-1)
    for step in range(steps):
        j_logits, j_cache = j_step(params, jnp.asarray(token), j_cache)
        with torch.no_grad():
            t_logits, t_cache = tt.transformer_decode_step(port, t_cfg, torch.from_numpy(token),
                                                           t_cache)
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), err_msg=f"step {step}",
                                   **TOL)
        token = np.asarray(j_logits).argmax(-1)
        assert (t_logits.argmax(-1).numpy() == token).all(), f"step {step}"
    assert t_cache.seq_len == int(j_cache.seq_len) == prompt + steps
    assert_cache(prompt + steps)
    # greedy generation through the public entry point, JAX's tokens
    with torch.no_grad():
        toks = tt.transformer_greedy(port, t_cfg, torch.from_numpy(ids), steps, max_len)
    want = jt.transformer_sample(params, j_cfg, jnp.asarray(ids), steps, max_len=max_len)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(want))


def test_full_model_ragged_step_matches_jax():
    """One ragged step at mixed per-row positions (before, at and past the
    prefilled length) over a prefilled slot pool."""
    params, port = model_params()
    j_cfg, t_cfg = j_tiny(use_sparse_attn=False), t_tiny(use_sparse_attn=False)
    ids = prompt_ids(3, 12, seed=2)
    seq_lens = np.array([12, 5, 20], np.int32)
    tokens = np.array([7, 99, 200], np.int32)
    _, j_cache = jax.jit(lambda p, i: jt.transformer_prefill(p, j_cfg, i, 32))(
        params, jnp.asarray(ids))
    j_logits, j_layers = jax.jit(lambda p, tok, c, t: jt.transformer_decode_step_ragged(
        p, j_cfg, tok, c, t))(params, jnp.asarray(tokens), j_cache.layers, jnp.asarray(seq_lens))
    with torch.no_grad():
        _, t_cache = tt.transformer_prefill(port, t_cfg, torch.from_numpy(ids), 32)
        t_logits, t_layers = tt.transformer_decode_step_ragged(
            port, t_cfg, torch.from_numpy(tokens), t_cache.layers, torch.from_numpy(seq_lens))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), **TOL)
    for lt, lj in zip(t_layers, j_layers):
        for i, t in enumerate(seq_lens):
            np.testing.assert_allclose(lt.kv[i, :, :t + 1].numpy(),
                                       np.asarray(lj.kv)[i, :, :t + 1], **CACHE_TOL)


def test_full_forward_runs_attention_through_flash(monkeypatch):
    """Every layer of the prefill calls ``flash_attention``, and
    ``use_kernels=False`` its plain version instead."""
    _, port = model_params()
    cfg = t_tiny(use_sparse_attn=False)
    calls = []

    def counting(real, label):
        def fn(*a, **k):
            calls.append(label)
            return real(*a, **k)
        return fn

    monkeypatch.setattr(tt, "flash_attention", counting(t_flash.flash_attention, "kernel"))
    monkeypatch.setattr(tt, "flash_attention_plain",
                        counting(t_flash.flash_attention_plain, "plain"))
    ids = torch.from_numpy(prompt_ids(1, 9, seed=4))
    with torch.no_grad():
        tt.transformer_prefill(port, cfg, ids, 32)
        tt.transformer_forward(port, cfg, ids, use_kernels=False)
    assert calls == ["kernel"] * cfg.depth + ["plain"] * cfg.depth


def test_full_model_efficiency_helpers_match_jax():
    t_cfg, j_cfg = t_tiny(use_sparse_attn=False), j_tiny(use_sparse_attn=False)
    for n in (8, 100, 3900):
        assert t_eff.kv_cache_saving_ratio(t_cfg, n) == j_eff.kv_cache_saving_ratio(j_cfg, n)
        assert (t_eff.kv_cache_saving_ratio(t_tiny(), n)
                == pytest.approx(j_eff.kv_cache_saving_ratio(j_tiny(), n)))
    assert tt.default_max_len(t_cfg, 4001) == 4096 and tt.default_max_len(t_cfg, 129) == 256
    port = model_params()[1]
    packed = tt.fuse_decode_params(port, t_cfg)
    assert tt.fuse_decode_params(packed, t_cfg) is packed
    for lp, lo in zip(packed["layers"], port["layers"]):
        a = lo["attn"]
        assert torch.equal(lp["attn"]["w_qkv"], torch.cat([a["w_q"], a["w_k"], a["w_v"]], 1))
    assert not tt.use_mega_decode(t_cfg, 1)
    cache = tt.ModelCache(layers=(tt.init_layer_cache(t_cfg, 2, 128, device="cpu"),), seq_len=3)
    copy = t_eff.clone_cache(cache)
    assert isinstance(copy.layers[0], tt.KVDecodeCache) and copy.seq_len == 3
    assert copy.layers[0].kv.data_ptr() != cache.layers[0].kv.data_ptr()


PROMPTS = (tuple(range(1, 10)), tuple(range(40, 52)), tuple(range(90, 98)))


@functools.lru_cache(maxsize=None)
def jax_engine_tokens(sps):
    params, _ = model_params()
    eng = JaxEngine(params, j_tiny(use_sparse_attn=False, attn_impl="xla"), max_batch=2,
                    max_len=64, prefill_buckets=(8, 16), steps_per_sync=sps)
    rids = [eng.add_request(np.asarray(p, np.int32), max_new_tokens=n)
            for p, n in zip(PROMPTS, (5, 7, 6))]
    outs = eng.run()
    return [outs[r] for r in rids]


@pytest.mark.parametrize("sps", [1, 3])
def test_full_engine_matches_jax(sps):
    """Three requests through two dense slots: the third is admitted when
    one retires."""
    _, port = model_params()
    eng = ContinuousBatchingEngine(port, t_tiny(use_sparse_attn=False), max_batch=2,
                                   max_len=64, prefill_buckets=(8, 16), steps_per_sync=sps)
    rids = [eng.add_request(np.asarray(p, np.int32), max_new_tokens=n)
            for p, n in zip(PROMPTS, (5, 7, 6))]
    outs = eng.run()
    for r, want in zip(rids, jax_engine_tokens(sps)):
        np.testing.assert_array_equal(outs[r], want)
    assert all(isinstance(lc, tt.KVDecodeCache) for lc in eng.cache_layers)


def test_full_engine_paged_pool_raises():
    _, port = model_params()
    with pytest.raises(NotImplementedError):
        ContinuousBatchingEngine(port, t_tiny(use_sparse_attn=False), max_len=64,
                                 paged_pool_pages=8, page_tokens=8)
    with pytest.raises(ValueError):
        tt.transformer_decode_step(port, t_tiny(use_sparse_attn=False),
                                   torch.zeros(1, dtype=torch.long),
                                   tt.ModelCache((tt.init_layer_cache(
                                       t_tiny(use_sparse_attn=False), 1, 32, device="cpu"),) * 2,
                                       0), route="split")


def test_committed_full_weights_match_jax():
    batch, prompt, steps, max_len = 1, 256, 16, 384
    t_params, meta = load_params_npz(WEIGHTS, device="cpu", dtype=torch.float32)
    t_cfg = model_config_from_meta(meta).replace(dtype="float32")
    assert not t_cfg.use_sparse_attn
    j_cfg = dataclasses.replace(model_config_from_json(json.dumps(meta["model_config"])),
                                dtype="float32", attn_impl="xla")
    template = jax.eval_shape(lambda: jt.init_transformer(jax.random.PRNGKey(0), j_cfg))
    j_params, _ = import_params_npz(WEIGHTS, template)
    j_params = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float32), j_params)
    ids = prompt_ids(batch, prompt, seed=0)

    j_logits, j_cache = jax.jit(functools.partial(jt.transformer_prefill, cfg=j_cfg,
                                                  max_len=max_len))(j_params, ids=jnp.asarray(ids))
    with torch.no_grad():
        t_logits, t_cache = tt.transformer_prefill(t_params, t_cfg, torch.from_numpy(ids),
                                                   max_len)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), **TOL)
    j_step = jax.jit(lambda p, tok, c: jt.transformer_decode_step(p, j_cfg, tok, c))
    token = np.asarray(j_logits[:, -1]).argmax(-1)
    for step in range(steps):
        j_logits, j_cache = j_step(j_params, jnp.asarray(token), j_cache)
        with torch.no_grad():
            t_logits, t_cache = tt.transformer_decode_step(t_params, t_cfg,
                                                           torch.from_numpy(token), t_cache)
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                                   err_msg=f"step {step}", **TOL)
        token = np.asarray(j_logits).argmax(-1)
        assert (t_logits.argmax(-1).numpy() == token).all(), f"step {step}"


def test_bench_needs_a_card():
    """``python -m nsa_tpu_torch.bench`` measures the card or raises; it never
    times the CPU."""
    with pytest.raises(RuntimeError, match="CUDA"):
        t_bench.main(["--quick", "--device", "cpu"])
