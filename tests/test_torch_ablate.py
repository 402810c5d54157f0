"""``NSA_ABLATE``, JAX's profiling hook on the decode step, in the port.

* Under each of its four values (``no_fine``, ``no_compressed``,
  ``no_emit``, ``attn_only``) the port's decode at b = 16 equals JAX's
  ``transformer_decode_step`` under the same value (``attn_impl="pallas"``,
  its kernels in interpret mode), logits and every cache tensor, over
  steps that emit and steps that do not; and the step takes the route
  JAX's does: the kernels each side calls are recorded.
* The route each value takes at one position (b 2 and 16, default or
  forced) and ragged, against JAX's layer step.
* ``no_emit`` leaves the ckv cache bit for bit as it was.
* A captured decode loop is keyed on the value: no graph captured under one
  value is replayed under another.
* The whole-model decode at b <= 8 ignores the hook, as JAX's does.

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
from nsa_tpu.ops.pallas import nsa_decode as j_dec
from nsa_tpu.ops.pallas import nsa_decode_fused as j_fused
from nsa_tpu_torch import tiny_test_config as t_tiny
from nsa_tpu_torch.models import decode_graph
from nsa_tpu_torch.models import transformer as tt
from nsa_tpu_torch.ops import nsa as t_nsa
from nsa_tpu_torch.utils.checkpoint import params_from_numpy

TOL = dict(rtol=2e-4, atol=2e-4)
VALUES = t_nsa.ABLATIONS
# the kernels a decode step may call, by route, in either package
PORT_KERNELS = ("decode_select_emit", "decode_attend_fused", "decode_select_emit_ragged",
                "decode_attend_fused_ragged", "decode_select", "decode_attend")


@functools.lru_cache(maxsize=None)
def model_params(seed=0):
    params = jax.jit(jt.init_transformer, static_argnums=1)(jax.random.PRNGKey(seed), j_tiny())
    return params, params_from_numpy(jax.tree_util.tree_map(np.asarray, params), device="cpu")


def T(x):
    return torch.from_numpy(np.array(x))


def prompt_ids(b, n, seed):
    return np.random.RandomState(seed).randint(0, 256, (b, n)).astype(np.int32)


def route_of(called):
    """The route a set of called kernel names means."""
    if {"decode_select_emit", "decode_select_emit_ragged"} & called:
        return "fused"
    if "decode_select" in called:
        return "hybrid" if "decode_attend_fused" in called else "split"
    return "xla"


def spy(monkeypatch, module, names, called):
    for name in names:
        if hasattr(module, name):
            real = getattr(module, name)
            monkeypatch.setattr(module, name, functools.partial(
                lambda real, name, *a, **kw: called.add(name) or real(*a, **kw), real, name))


def port_rollout(prompt, steps, max_len=64):
    _, port = model_params()
    cfg = t_tiny()
    logits, cache = tt.transformer_prefill(port, cfg, T(prompt).long(), max_len)
    tok, outs = logits[:, -1].argmax(-1), []
    for _ in range(steps):
        lg, cache = tt.transformer_decode_step(port, cfg, tok, cache)
        outs.append(lg)
        tok = lg.argmax(-1)
    return outs, cache


def jax_rollout(prompt, steps, max_len=64):
    params, _ = model_params()
    cfg = j_tiny(attn_impl="pallas")
    # the prefill on JAX's XLA path (its kernel's interpreter is slow here)
    logits, cache = jax.jit(functools.partial(jt.transformer_prefill, cfg=cfg, max_len=max_len,
                                              impl="xla"))(params, ids=jnp.asarray(prompt))
    step = jax.jit(lambda tok, c: jt.transformer_decode_step(params, cfg, tok, c))
    tok, outs = jnp.argmax(logits[:, -1], -1).astype(jnp.int32), []
    for _ in range(steps):
        lg, cache = step(tok, cache)
        outs.append(np.asarray(lg))
        tok = jnp.argmax(lg, -1).astype(jnp.int32)
    return outs, cache


@pytest.mark.parametrize("value", VALUES)
def test_ablated_decode_matches_jax(value, monkeypatch):
    """b = 16 (the split route without the hook), 9-token prompts, 3 steps:
    an emission at the first and third.  Logits and every cache tensor
    within TOL of JAX's under the same value, on the same route."""
    monkeypatch.setenv("NSA_ABLATE", value)
    prompt = prompt_ids(16, 9, 5)
    j_called, t_called = set(), set()
    spy(monkeypatch, j_dec, ("decode_select", "decode_attend"), j_called)
    spy(monkeypatch, j_fused, ("decode_select_emit", "decode_attend_fused"), j_called)
    spy(monkeypatch, t_nsa, PORT_KERNELS, t_called)
    want, j_cache = jax_rollout(prompt, 3)
    got, t_cache = port_rollout(prompt, 3)
    assert route_of(t_called) == route_of(j_called) == (
        "split" if value == "no_emit" else "xla")
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), w, err_msg=f"step {i}", **TOL)
    for tl, jl in zip(t_cache.layers, j_cache.layers):
        for name in ("kv", "ckv", "ring"):
            np.testing.assert_allclose(getattr(tl, name).numpy(), np.asarray(getattr(jl, name)),
                                       err_msg=name, **TOL)


def layer_route_jax(b, ragged, monkeypatch):
    """The route JAX's layer step takes at ``b`` rows (one position or
    ragged), by the kernels its trace calls."""
    params, _ = model_params()
    cfg = j_tiny(attn_impl="pallas")
    called = set()
    spy(monkeypatch, j_dec, ("decode_select", "decode_attend"), called)
    spy(monkeypatch, j_fused, ("decode_select_emit", "decode_attend_fused",
                               "decode_select_emit_ragged", "decode_attend_fused_ragged"),
        called)
    layer = params["layers"][0]
    cache = j_nsa.init_decode_cache(cfg, b, 32, jnp.float32)
    x = jnp.asarray(np.random.RandomState(1).standard_normal((b, 1, 64)), jnp.float32)
    t = jnp.full((b,), 5, jnp.int32) if ragged else jnp.int32(5)
    jax.eval_shape(lambda x_, c: j_nsa.sparse_attention_decode(
        layer["attn"], cfg, x_, c, t, ff_params=layer["ff"]), x, cache)
    return route_of(called)


@pytest.mark.parametrize("value", ("",) + VALUES)
def test_ablation_routes_match_jax(value, monkeypatch):
    """The layer's route under each value at b 2 (the fused route without
    the hook) and 16 (split), one position and ragged, is JAX's; a forced
    route moves the same way; the hybrid flag turns the split route under
    ``no_emit`` into the hybrid one."""
    monkeypatch.setenv("NSA_ABLATE", value)
    monkeypatch.delenv("NSA_HYBRID_DECODE", raising=False)
    cfg = t_tiny()
    for b, ragged in ((2, False), (16, False), (2, True)):
        assert t_nsa.decode_route(cfg, b, ragged) == layer_route_jax(b, ragged, monkeypatch), \
            (b, ragged)
    kernel_off = value not in ("", "no_emit")
    assert [t_nsa.decode_route(cfg, 2, False, r) for r in ("fused", "split", "hybrid")] == (
        ["xla"] * 3 if kernel_off else ["split" if value else "fused", "split", "hybrid"])
    monkeypatch.setenv("NSA_HYBRID_DECODE", "1")
    assert t_nsa.decode_route(cfg, 16, False) == ("xla" if kernel_off else "hybrid")


def test_unknown_value_drops_nothing(monkeypatch):
    """Any other value, as in JAX, drops nothing and moves no route."""
    monkeypatch.setenv("NSA_ABLATE", "no_such_part")
    assert t_nsa.decode_ablation() == ""
    assert [t_nsa.decode_route(t_tiny(), b, False) for b in (2, 16)] == ["fused", "split"]


@pytest.mark.parametrize("value", ("no_emit", "attn_only"))
def test_no_emit_leaves_ckv_as_it_was(value, monkeypatch):
    """Over 4 steps (two emissions) the ckv cache keeps its bits; the kv
    cache and the ring move as without the hook."""
    monkeypatch.setenv("NSA_ABLATE", value)
    _, port = model_params()
    cfg = t_tiny()
    _, cache = tt.transformer_prefill(port, cfg, T(prompt_ids(16, 9, 6)).long(), 64)
    before = [lc.ckv.clone() for lc in cache.layers]
    ring_before = cache.layers[0].ring.clone()
    tok = torch.zeros(16, dtype=torch.long)
    for _ in range(4):
        _, cache = tt.transformer_decode_step(port, cfg, tok, cache)
    assert all(torch.equal(lc.ckv, b) for lc, b in zip(cache.layers, before))
    assert not torch.equal(cache.layers[0].ring, ring_before)
    assert cache.layers[0].kv[:, :, 9:13].abs().sum() > 0


def test_captured_loops_are_keyed_on_the_ablation(monkeypatch):
    """A loop's graph key holds the hook's value: a graph captured under one
    value (or none) is never the one another value replays."""
    state = {"tok": torch.zeros(4, dtype=torch.int32)}

    def body(s):
        s["tok"].add_(1)

    assert "NSA_ABLATE" in decode_graph._STEP_ENV
    keys = set()
    for value in ("",) + VALUES:
        monkeypatch.setenv("NSA_ABLATE", value)
        keys.add(decode_graph.step_key(state, body))
    monkeypatch.delenv("NSA_ABLATE")
    keys.add(decode_graph.step_key(state, body))
    assert len(keys) == len(VALUES) + 2


def test_whole_model_decode_ignores_the_hook(monkeypatch):
    """b = 4 on the whole-model kernel's route (its plain version here):
    the same logits and caches under every value, bit for bit, and the
    kernel runs each step."""
    _, port = model_params()
    cfg = t_tiny()
    prompt = T(prompt_ids(4, 9, 7)).long()
    assert tt.use_mega_decode(cfg, 4)
    runs = []
    for value in ("",) + VALUES:
        monkeypatch.setenv("NSA_ABLATE", value)
        called = set()
        spy(monkeypatch, tt, ("decode_step_mega",), called)
        logits, cache = tt.transformer_prefill(port, cfg, prompt, 64)
        tok = logits[:, -1].argmax(-1)
        outs = []
        for _ in range(3):
            lg, cache = tt.transformer_decode_step(port, cfg, tok, cache)
            outs.append(lg)
            tok = lg.argmax(-1)
        assert called == {"decode_step_mega"}
        runs.append((outs, cache))
        monkeypatch.undo()
    ref_outs, ref_cache = runs[0]
    for outs, cache in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(outs, ref_outs))
        assert all(torch.equal(x, y) for a, b in zip(cache.layers, ref_cache.layers)
                   for x, y in zip(a, b))
