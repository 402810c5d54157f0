"""The port's hybrid decode route and the FF outside the fused kernels.

* ``route="hybrid"`` (JAX's ``NSA_HYBRID_DECODE=1``): ``decode_select``
  (row 2) and then ``decode_attend_fused`` (row 7) on its info rows, which
  writes the kv row itself.  Token for token the split route at b = 16
  across emissions, as ``tests/test_hybrid_decode.py`` holds JAX's, and
  its logits against JAX's with the flag set (its Pallas kernels in
  interpret mode); the flag picks the route where JAX's does.
* ``NSA_NO_FF_FUSE``: the fused routes (one position, ragged, paged) and
  the hybrid route with the FF applied after the attend kernel, against
  the FF inside it and against JAX under the same flag.
* The captured decode loops are keyed on every switch the layer and the
  model read.

float32 on the CPU (the kernels' plain versions), the tiny test
configuration.  Tolerance atol/rtol 2e-4, the repo's decode tolerance:
float32 sums in another order; tokens exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsa_tpu.config import tiny_test_config as j_tiny
from nsa_tpu.models import transformer as jt
from nsa_tpu.ops import nsa as j_nsa
from nsa_tpu_torch import tiny_test_config as t_tiny
from nsa_tpu_torch.models import transformer as tt
from nsa_tpu_torch.ops import nsa as t_nsa
from nsa_tpu_torch.utils.checkpoint import params_from_numpy

TOL = dict(rtol=2e-4, atol=2e-4)


@functools.lru_cache(maxsize=None)
def model_params(seed=0):
    params = jax.jit(jt.init_transformer, static_argnums=1)(jax.random.PRNGKey(seed), j_tiny())
    return params, params_from_numpy(jax.tree_util.tree_map(np.asarray, params), device="cpu")


def T(x):
    return torch.from_numpy(np.array(x))


def prompt_ids(b, n, seed):
    return np.random.RandomState(seed).randint(0, 256, (b, n)).astype(np.int32)


def port_rollout(route, prompt, steps, max_len=64):
    _, port = model_params()
    cfg = t_tiny()
    logits, cache = tt.transformer_prefill(port, cfg, T(prompt).long(), max_len)
    tok, outs, toks = logits[:, -1].argmax(-1), [], []
    for _ in range(steps):
        toks.append(tok)
        lg, cache = tt.transformer_decode_step(port, cfg, tok, cache, route=route)
        outs.append(lg)
        tok = lg.argmax(-1)
    return outs, torch.stack(toks, 1), cache


def test_hybrid_equals_split_token_for_token():
    """b = 16, 9-token prompts, 8 steps: emissions every other step."""
    prompt = prompt_ids(16, 9, 1)
    ref, ref_toks, ref_cache = port_rollout("split", prompt, 8)
    hyb, hyb_toks, hyb_cache = port_rollout("hybrid", prompt, 8)
    assert torch.equal(hyb_toks, ref_toks)
    for i, (a, h) in enumerate(zip(ref, hyb)):
        np.testing.assert_allclose(h.numpy(), a.numpy(), err_msg=f"step {i}", **TOL)
    # layer 0's rows are the same bits (its inputs are); later layers' by
    # the float32 noise of the residual stream the two attends round apart
    assert all(torch.equal(a, b) for a, b in zip(ref_cache.layers[0], hyb_cache.layers[0]))
    for rc, hc in zip(ref_cache.layers, hyb_cache.layers):
        for a, b in zip(rc, hc):
            np.testing.assert_allclose(b.numpy(), a.numpy(), **TOL)


def test_hybrid_flag_picks_the_route_where_jax_does(monkeypatch):
    """``NSA_HYBRID_DECODE`` turns the one-position split route into the
    hybrid one, forced or by default (b > 8), and nothing else; a layer step
    there runs rows 2 and 7 and not row 3."""
    cfg = t_tiny()
    monkeypatch.delenv("NSA_HYBRID_DECODE", raising=False)
    assert [t_nsa.decode_route(cfg, b, False, r) for b, r in
            ((16, None), (2, "split"), (2, "hybrid"))] == ["split", "split", "hybrid"]
    monkeypatch.setenv("NSA_HYBRID_DECODE", "1")
    assert [t_nsa.decode_route(cfg, b, rg, r) for b, rg, r in
            ((16, False, None), (2, False, "split"), (2, False, None), (16, False, "fused"),
             (16, True, None), (16, True, "split"))] == \
        ["hybrid", "hybrid", "fused", "fused", "fused", "xla"]
    with pytest.raises(ValueError, match="one position"):
        t_nsa.decode_route(cfg, 16, True, "hybrid")
    with pytest.raises(ValueError, match="selected blocks"):
        t_nsa.decode_route(cfg.replace(nsa=cfg.nsa.__class__(num_selected_blocks=0)), 16,
                           False, "hybrid")

    calls = []
    for name in ("decode_select", "decode_attend", "decode_attend_fused"):
        real = getattr(t_nsa, name)
        monkeypatch.setattr(t_nsa, name, functools.partial(
            lambda real, name, *a, **kw: calls.append(name) or real(*a, **kw), real, name))
    port_rollout(None, prompt_ids(16, 9, 2), 1)
    assert calls == ["decode_select", "decode_attend_fused"] * cfg.depth


def test_captured_loops_are_keyed_on_every_decode_switch():
    """Every environment switch the layer and the model read is one that a
    captured decode loop is keyed on, so a loop captured under one setting
    is never replayed under another."""
    import inspect
    import re

    from nsa_tpu_torch.models import decode_graph

    read = set()
    for module in (t_nsa, tt):
        read |= set(re.findall(r"os\.environ\.get\(\"(\w+)\"", inspect.getsource(module)))
    assert read == {"NSA_HYBRID_DECODE", "NSA_NO_FF_FUSE", "NSA_ABLATE", "NSA_MEGA_DECODE",
                    "NSA_MEGA_MAX_B"}
    assert read == set(tt.DECODE_ENV) and set(t_nsa.DECODE_ENV) < read
    assert read <= set(decode_graph._STEP_ENV)


@pytest.mark.parametrize("no_ff_fuse", [False, True], ids=["ff-inside", "ff-outside"])
def test_hybrid_matches_jax(no_ff_fuse, monkeypatch):
    """JAX with ``NSA_HYBRID_DECODE=1`` at b = 4 (its split path forced,
    ``attn_impl="pallas"``, the kernels in interpret mode) against the
    port's hybrid route, 4 steps from 9-token prompts (an emission every
    other step), each side on its own argmax."""
    params, port = model_params()
    j_cfg, t_cfg = j_tiny(attn_impl="pallas"), t_tiny()
    prompt = prompt_ids(4, 9, 3)
    monkeypatch.setenv("NSA_HYBRID_DECODE", "1")
    monkeypatch.setenv("NSA_FUSED_DECODE_MAX_B", "0")
    if no_ff_fuse:
        monkeypatch.setenv("NSA_NO_FF_FUSE", "1")
    # the prefill on JAX's XLA path (its kernel's interpreter is slow here)
    logits, cache = jax.jit(functools.partial(jt.transformer_prefill, cfg=j_cfg, max_len=64,
                                              impl="xla"))(params, ids=jnp.asarray(prompt))
    step = jax.jit(lambda tok, c: jt.transformer_decode_step(params, j_cfg, tok, c))
    tok, want = jnp.argmax(logits[:, -1], -1).astype(jnp.int32), []
    for _ in range(4):
        lg, cache = step(tok, cache)
        want.append(np.asarray(lg))
        tok = jnp.argmax(lg, -1).astype(jnp.int32)
    got, _, _ = port_rollout("split", prompt, 4)
    assert t_nsa.decode_route(t_cfg, 4, False, "split") == "hybrid"
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), w, err_msg=f"step {i}", **TOL)


def layer_steps(route, b, ragged=False, paged=False, steps=6, prompt=5, max_len=32):
    """Layer 0 with its FF over ``steps`` decode steps on the port's route;
    returns the outputs [steps, b, 1, dim] and the cache."""
    _, port = model_params()
    cfg = t_tiny()
    layer = port["layers"][0]
    x = T((np.random.RandomState(4).standard_normal((b, prompt + steps, 64)) * 0.5)
          .astype(np.float32))
    _, cache = t_nsa.sparse_attention_forward(layer["attn"], cfg, x[:, :prompt],
                                              return_cache_max_len=max_len)
    table = None
    if paged:       # pages of 8 rows, row i's pages after row i-1's
        page = 8
        table = torch.arange(b * max_len // page, dtype=torch.int32).reshape(b, -1)
        kv = cache.kv.reshape(b, cfg.kv_heads, -1, page, cache.kv.shape[-1]).transpose(1, 2)
        cache = t_nsa.NSADecodeCache(kv.reshape(-1, cfg.kv_heads, page, kv.shape[-1]).contiguous(),
                                     cache.ckv, cache.ring)
    outs = []
    for t in range(prompt, prompt + steps):
        pos = torch.full((b,), t, dtype=torch.int32) if ragged else t
        out, cache = t_nsa.sparse_attention_decode(layer["attn"], cfg, x[:, t:t + 1], cache, pos,
                                                   ff_params=layer["ff"], route=route,
                                                   page_table=table)
        outs.append(out)
    return torch.stack(outs), cache


@pytest.mark.parametrize("route,b,ragged,paged", [
    ("fused", 2, False, False), ("fused", 2, True, False), ("fused", 2, True, True),
    ("hybrid", 9, False, False)], ids=["fused", "ragged", "paged", "hybrid"])
def test_ff_outside_matches_ff_inside(route, b, ragged, paged, monkeypatch):
    """``NSA_NO_FF_FUSE`` hands the attend kernel no FF and applies
    ``ff_apply_gelu`` after it: the same layer output and caches."""
    monkeypatch.delenv("NSA_NO_FF_FUSE", raising=False)
    inside, c_in = layer_steps(route, b, ragged, paged)
    handed = []
    for name in ("decode_attend_fused", "decode_attend_fused_ragged",
                 "decode_attend_fused_paged"):
        real = getattr(t_nsa, name)
        monkeypatch.setattr(t_nsa, name, functools.partial(
            lambda real, *a, **kw: handed.append(a[-1] if len(a) > 9 else None) or
            real(*a, **kw), real))
    monkeypatch.setenv("NSA_NO_FF_FUSE", "1")
    outside, c_out = layer_steps(route, b, ragged, paged)
    assert handed and all(ff == () for ff in handed)
    np.testing.assert_allclose(outside.numpy(), inside.numpy(), **TOL)
    for a, w in zip(c_out, c_in):
        assert torch.equal(a, w)


def test_ff_outside_matches_jax(monkeypatch):
    """Layer 0 at b = 2 on JAX's fused route (``attn_impl="pallas"``, its
    kernels in interpret mode) under ``NSA_NO_FF_FUSE=1`` against the
    port's fused route under the same flag, 6 steps across emissions."""
    params, _ = model_params()
    cfg = j_tiny(attn_impl="pallas")
    layer = params["layers"][0]
    monkeypatch.setenv("NSA_NO_FF_FUSE", "1")
    prompt, steps = 5, 6
    x = (np.random.RandomState(4).standard_normal((2, prompt + steps, 64)) * 0.5) \
        .astype(np.float32)
    _, cache = jax.jit(functools.partial(j_nsa.sparse_attention_forward, cfg=cfg, impl="xla",
                                         return_cache_max_len=32))(
        layer["attn"], x=jnp.asarray(x[:, :prompt]))
    step = jax.jit(lambda x_, c, t_: j_nsa.sparse_attention_decode(
        layer["attn"], cfg, x_, c, t_, ff_params=layer["ff"]))
    want = []
    for t in range(prompt, prompt + steps):
        out, cache = step(jnp.asarray(x[:, t:t + 1]), cache, jnp.int32(t))
        want.append(np.asarray(out))
    got, _ = layer_steps("fused", 2)
    np.testing.assert_allclose(got.numpy(), np.stack(want), **TOL)
