"""The port's whole-model decode (``decode_step_mega`` and the model API
around it) against nsa_tpu's, on the CPU.

* the port's ``decode_step_mega`` (its plain version, which the wrapper
  runs for CPU tensors) against JAX's ``transformer_decode_step_mega`` with
  the Pallas megakernel in interpret mode, on the same weights and the same
  prefilled cache, over steps that cross two compressed-block emissions;
* the in-kernel greedy argmax and ``steps`` tokens per launch against
  single steps;
* ``pack_mega_params`` and ``use_mega_decode`` against JAX's;
* the sampler (top-k filter, Gumbel-max, greedy and tempered
  ``transformer_sample``) against JAX's on the same logits and noise;
* ``greedy_decode`` taking the megakernel route by default at b <= 8 and
  updating the caller's cache in place.

Inputs from numpy with fixed seeds, float32, tiny configuration.
Tolerance atol/rtol 2e-4, the repo's decode tolerance (float32 sums in
another order through the layers); tokens, selected ids and the sampler's
picks exact; caches equal outside ckv's trash row (the last), which no
emission writes.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsa_tpu.config import tiny_test_config as j_tiny
from nsa_tpu.models import transformer as jt
from nsa_tpu_torch import tiny_test_config as t_tiny
from nsa_tpu_torch.models import transformer as tt
from nsa_tpu_torch.ops import nsa as t_nsa
from nsa_tpu_torch.ops.cuda import nsa_decode_mega as t_mega
from nsa_tpu_torch.utils.checkpoint import params_from_numpy

TOL = dict(rtol=2e-4, atol=2e-4)
MAX_LEN = 32


@functools.lru_cache(maxsize=None)
def model_params(seed):
    params = jax.jit(jt.init_transformer, static_argnums=1)(jax.random.PRNGKey(seed), j_tiny())
    return params, params_from_numpy(jax.tree_util.tree_map(np.asarray, params), device="cpu")


def prompt_ids(b, n, seed):
    return np.random.RandomState(seed).randint(0, 256, (b, n)).astype(np.int32)


def T(x):
    return torch.from_numpy(np.array(x))


def jax_prefill(params, ids):
    logits, cache = jax.jit(lambda p, i: jt.transformer_prefill(p, j_tiny(), i, MAX_LEN))(
        params, jnp.asarray(ids))
    return np.asarray(logits[:, -1]).argmax(-1).astype(np.int32), cache


def assert_caches_equal(t_caches, j_caches, **tol):
    for name, t_c, j_c in zip(("kv", "ckv", "ring"), t_caches, j_caches):
        t_c, j_c = np.asarray(t_c), np.asarray(j_c)
        if name == "ckv":       # the trash row
            t_c, j_c = t_c[..., :-1, :], j_c[..., :-1, :]
        np.testing.assert_allclose(t_c, j_c, err_msg=name, **(tol or TOL))


def test_decode_step_mega_matches_jax_megakernel():
    """b = 2, prompt 9, stride 2: steps at t = 9..12 emit at t = 9 and 11."""
    params, port = model_params(0)
    j_cfg, t_cfg = j_tiny(attn_impl="pallas"), t_tiny()
    token, cache = jax_prefill(params, prompt_ids(2, 9, seed=1))
    t0 = int(cache.seq_len)
    j_mp = jt.pack_mega_params(params, j_cfg)
    t_mp = tt.pack_mega_params(port, t_cfg)
    j_kv, j_ckv, j_ring = jt.stack_decode_caches(cache)
    t_kv, t_ckv, t_ring = (T(x) for x in (j_kv, j_ckv, j_ring))
    tok = token
    for i in range(4):
        j_lg, j_nxt, j_kv, j_ckv, j_ring = jt.transformer_decode_step_mega(
            j_mp, j_cfg, jnp.asarray(tok), j_kv, j_ckv, j_ring, t0 + i, greedy=True)
        t_lg, t_nxt, *_ = tt.transformer_decode_step_mega(
            t_mp, t_cfg, T(tok), t_kv, t_ckv, t_ring, t0 + i, greedy=True)
        np.testing.assert_allclose(t_lg.numpy(), np.asarray(j_lg), err_msg=f"step {i}", **TOL)
        np.testing.assert_array_equal(t_nxt.numpy(), np.asarray(j_nxt), err_msg=f"step {i}")
        assert t_nxt.dtype == torch.int32 and tuple(t_nxt.shape) == (2, 1)
        tok = np.asarray(j_nxt)[:, 0]
    assert_caches_equal((t_kv, t_ckv, t_ring), (j_kv, j_ckv, j_ring))


def test_greedy_multi_step_launch_matches_single_steps():
    """One launch of 4 greedy tokens == 4 launches of one, bit for bit; the
    in-kernel argmax == the argmax of the returned logits; per-layer caches
    in place == stacked copies."""
    _, port = model_params(3)
    cfg = t_tiny()
    mp = tt.pack_mega_params(port, cfg)
    logits, cache = tt.transformer_prefill(port, cfg, T(prompt_ids(2, 11, seed=4)), MAX_LEN)
    first = logits[:, -1].argmax(-1)
    single = tt.stack_decode_caches(cache)
    tok, toks = first, []
    for i in range(4):
        lg, nxt, *_ = tt.transformer_decode_step_mega(mp, cfg, tok, *single, cache.seq_len + i,
                                                      greedy=True)
        assert torch.equal(nxt[:, 0], lg.argmax(-1).int())
        toks.append(nxt)
        tok = nxt[:, 0]
    lg4, toks4, *_ = tt.transformer_decode_step_mega(
        mp, cfg, first, *tt.cache_tensors(cache), cache.seq_len, greedy=True, steps=4)
    assert torch.equal(toks4, torch.cat(toks, 1)) and torch.equal(lg4, lg)
    for name, x, lc_x in zip(("kv", "ckv", "ring"), single, tt.cache_tensors(cache)):
        assert torch.equal(x, torch.stack(lc_x)), name
    with pytest.raises(ValueError, match="steps"):
        tt.transformer_decode_step_mega(mp, cfg, first, *single, cache.seq_len, steps=2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pack_mega_params_matches_jax(dtype):
    params, port = model_params(0)
    j_mp = jt.pack_mega_params(params, j_tiny(dtype=dtype))
    t_mp = tt.pack_mega_params(port, t_tiny(dtype=dtype))
    assert set(t_mp) == set(j_mp) - {"pswap"}
    for k, v in t_mp.items():
        want = np.asarray(j_mp[k])
        assert tuple(v.shape) == want.shape, k
        assert str(v.dtype).split(".")[-1] == str(want.dtype), k
        np.testing.assert_array_equal(v.float().numpy(), want.astype(np.float32), err_msg=k)


@pytest.mark.parametrize("env", [{}, {"NSA_MEGA_DECODE": "0"}, {"NSA_MEGA_MAX_B": "12"},
                                 {"NSA_MEGA_MAX_B": "64"}, {"NSA_MEGA_MAX_B": "1"}])
def test_use_mega_decode_follows_jax(env, monkeypatch):
    for k in ("NSA_MEGA_DECODE", "NSA_MEGA_MAX_B", "NSA_SCOPED_VMEM_KIB"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for compressor in ("mlp", "mean"):
        j_cfg, t_cfg = j_tiny(attn_impl="pallas"), t_tiny()
        j_cfg = dataclasses.replace(j_cfg, nsa=dataclasses.replace(j_cfg.nsa,
                                                                   compressor=compressor))
        t_cfg = t_cfg.replace(nsa=dataclasses.replace(t_cfg.nsa, compressor=compressor))
        for b in (1, 8, 9, 16, 17):
            assert tt.use_mega_decode(t_cfg, b) == jt.use_mega_decode(j_cfg, b), (compressor, b)


@pytest.mark.parametrize("temperature,filter_thres", [(0.0, 0.9), (1.0, 0.9), (0.7, 0.5),
                                                      (1.3, 0.99)])
def test_sampler_matches_jax(temperature, filter_thres):
    rs = np.random.RandomState(5)
    logits = (rs.standard_normal((4, 256)) * 3).astype(np.float32)
    logits[0, 10] = logits[0, 11] = logits[0].max() + 1       # a tie at the top
    rng = jax.random.PRNGKey(7)
    gumbel = np.asarray(-jnp.log(-jnp.log(jax.random.uniform(rng, logits.shape) + 1e-20)
                                 + 1e-20))
    want = np.asarray(jt._sample_from_logits(jnp.asarray(logits), rng, temperature,
                                             filter_thres))
    got = tt._sample_from_logits(T(logits), temperature, filter_thres, T(gumbel))
    np.testing.assert_array_equal(got.numpy(), want)
    # the top-k filter, as _sample_from_logits computes it
    k = max(1, -int(-((1.0 - filter_thres) * 256) // 1))
    kth = jax.lax.top_k(jnp.asarray(logits), k)[0][..., -1:]
    j_filtered = np.asarray(jnp.where(logits >= kth, logits, -jnp.inf))
    np.testing.assert_array_equal(tt.top_k_filter(T(logits), filter_thres).numpy(), j_filtered)


@pytest.mark.parametrize("route", [None, "fused"])
def test_transformer_sample_matches_jax(route):
    """Greedy: the same tokens.  Tempered: the same tokens given JAX's noise
    (the first token from its key, token i from the i-1-th split key).  At
    b = 2 the port's default route is the megakernel, JAX's (XLA) the
    per-layer step."""
    params, port = model_params(2)
    ids = prompt_ids(2, 11, seed=3)
    gen = 8
    want = jt.transformer_sample(params, j_tiny(), jnp.asarray(ids), gen, max_len=MAX_LEN)
    got = tt.transformer_sample(port, t_tiny(), T(ids), gen, max_len=MAX_LEN, route=route)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    rng = jax.random.PRNGKey(11)
    keys = [rng, *jax.random.split(rng, gen)[:gen - 1]]
    gumbel = np.stack([np.asarray(-jnp.log(-jnp.log(jax.random.uniform(k, (2, 256)) + 1e-20)
                                           + 1e-20)) for k in keys])
    want = jt.transformer_sample(params, j_tiny(), jnp.asarray(ids), gen, temperature=0.8,
                                 rng=rng, max_len=MAX_LEN)
    got = tt.transformer_sample(port, t_tiny(), T(ids), gen, temperature=0.8, gumbel=T(gumbel),
                                max_len=MAX_LEN, route=route)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    drawn = tt.transformer_sample(port, t_tiny(), T(ids), gen, temperature=0.8,
                                  generator=torch.Generator().manual_seed(1), max_len=MAX_LEN)
    assert tuple(drawn.shape) == (2, gen) and int(drawn.max()) < 256


def test_greedy_decode_takes_mega_route_in_place(monkeypatch):
    """At b = 2 greedy_decode runs the whole-model decode, no per-layer
    kernel, and leaves the caller's cache tensors advanced; steps per launch
    change nothing; the fused route gives the same tokens."""
    _, port = model_params(4)
    cfg = t_tiny()
    logits, cache = tt.transformer_prefill(port, cfg, T(prompt_ids(2, 9, seed=6)), MAX_LEN)
    first = logits[:, -1].argmax(-1)
    copies = [tt.ModelCache(tuple(t_nsa.NSADecodeCache(*(x.clone() for x in lc))
                                  for lc in cache.layers), cache.seq_len) for _ in range(2)]
    calls = []
    monkeypatch.setattr(t_mega, "decode_step_mega_plain", functools.partial(
        lambda fn, *a, **k: calls.append(k["steps"]) or fn(*a, **k), t_mega.decode_step_mega_plain))
    monkeypatch.setattr(t_nsa, "decode_select_emit", lambda *a, **k: pytest.fail("fused route"))
    monkeypatch.setattr(t_nsa, "decode_select", lambda *a, **k: pytest.fail("split route"))
    got = tt.greedy_decode(port, cfg, first, cache, 6)
    assert calls == [1] * 6
    got3 = tt.greedy_decode(port, cfg, first, copies[0], 6, steps=3)
    assert calls[6:] == [3, 3] and torch.equal(got3, got)
    assert got.dtype == first.dtype and torch.equal(got[:, 0], first)

    ref = copies[1]
    tok = first
    for _ in range(6):
        lg, ref = tt.transformer_decode_step(port, cfg, tok, ref, route="mega")
        tok = lg.argmax(-1)
    for lc, lc3, lr in zip(cache.layers, copies[0].layers, ref.layers):
        for x, x3, xr in zip(lc, lc3, lr):
            assert torch.equal(x, xr) and torch.equal(x3, xr)
    monkeypatch.undo()
    fused = tt.greedy_decode(port, cfg, first, tt.transformer_prefill(
        port, cfg, T(prompt_ids(2, 9, seed=6)), MAX_LEN)[1], 6, route="fused")
    assert torch.equal(fused, got)
    with pytest.raises(ValueError, match="route"):
        tt.greedy_decode(port, cfg, first, cache, 2, route="bogus")
    mean = t_tiny().replace(nsa=dataclasses.replace(t_tiny().nsa, compressor="mean"))
    with pytest.raises(ValueError, match="mega"):
        tt.transformer_decode_step(port, mean, first, cache, route="mega")
