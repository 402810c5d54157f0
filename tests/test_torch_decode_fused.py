"""The port's fused decode route (b <= 8) against nsa_tpu's.

* ``decode_select_emit_plain`` and ``decode_attend_fused_plain`` against
  the Pallas kernels ``decode_select_emit`` / ``decode_attend_fused`` in
  interpret mode, as nsa_tpu's own tests run them: emission and
  non-emission steps, positions before the first full compression window
  (zeroed window rows) and near ``max_len``, the FF inside and not;
* the layer step and ``transformer_decode_step`` at b in {1, 2} against
  JAX with ``attn_impl="pallas"``, which takes its fused route, over steps
  that cross emissions; and one b = 9 case on the split route on both sides;
* the route each batch size takes, against JAX's choice.

Inputs from numpy with fixed seeds, float32 on the CPU.  Tolerance
atol/rtol 2e-4, the repo's decode tolerance (float32 sums in another order
through the layer's matmuls); selected ids exact; caches equal outside
ckv's trash row, which only the split route writes.
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
from nsa_tpu.ops.pallas import nsa_decode_fused as j_fused
from nsa_tpu_torch import tiny_test_config as t_tiny
from nsa_tpu_torch.models import transformer as tt
from nsa_tpu_torch.ops import nsa as t_nsa
from nsa_tpu_torch.ops.cuda import nsa_decode_fused as t_fused
from nsa_tpu_torch.utils.checkpoint import params_from_numpy

TOL = dict(rtol=2e-4, atol=2e-4)
# the tiny test configuration's geometry
B, KVH, G, D, M = 2, 2, 2, 16, 1
STRIDE, BC, SEL_BLOCK, WINDOW, NUM_SEL = 2, 4, 4, 8, 2
N_SLIDE = -(-WINDOW // SEL_BLOCK) + 1
MAX_LEN, HID, DIM, FF_HID = 64, 64, 64, 256
INFO_USED = 2 * NUM_SEL + N_SLIDE
SELECT_KW = dict(max_blocks=MAX_LEN // SEL_BLOCK, stride=STRIDE, sel_block=SEL_BLOCK,
                 num_sel=NUM_SEL, n_slide=N_SLIDE, scale=0.25)
ATTEND_KW = dict(sel_block=SEL_BLOCK, window=WINDOW, num_sel=NUM_SEL, n_slide=N_SLIDE,
                 scale=0.25)


def rnd(rs, *shape, scale=1.0):
    return (rs.standard_normal(shape) * scale).astype(np.float32)


def T(x):
    return torch.from_numpy(np.array(x))


def select_emit_inputs(seed):
    rs = np.random.RandomState(seed)
    Wc = t_nsa._ckv_width(MAX_LEN, STRIDE, SEL_BLOCK // STRIDE)
    return dict(
        q=rnd(rs, B, KVH, G, D), ckv=rnd(rs, B, KVH, Wc, 2 * D), ring=rnd(rs, B, KVH, BC, 2 * D),
        kv_new=rnd(rs, B, KVH, 1, 2 * D), mem_kv=rnd(rs, 2, KVH, M, D),
        pos_kv=rnd(rs, KVH, BC, 2 * D, scale=0.1),
        w1k=rnd(rs, KVH, BC * D, HID, scale=0.125), b1k=rnd(rs, KVH, HID, scale=0.1),
        w1v=rnd(rs, KVH, BC * D, HID, scale=0.125), b1v=rnd(rs, KVH, HID, scale=0.1),
        w2=rnd(rs, KVH, HID, 2 * D, scale=0.125), b2=rnd(rs, KVH, 2 * D, scale=0.1),
    )


def jax_select_emit(inp, t):
    return j_fused.decode_select_emit(
        *(jnp.asarray(v) for v in inp.values()), jnp.int32(t), jnp.int32(t // STRIDE),
        batch_tile=B, interpret=True, **SELECT_KW)


@pytest.mark.parametrize("t", [0, 1, 2, 13, 61, 62])
def test_decode_select_emit_plain_matches_pallas(t):
    """Odd t emits (stride 2); t = 1 emits a window whose first two rows lie
    before the sequence start."""
    inp = select_emit_inputs(seed=t)
    want_c, want_info, want_ckv, want_ring = jax_select_emit(inp, t)
    port = {k: T(v) for k, v in inp.items()}
    before = t_fused.decode_select_emit.launches
    c_out, info = t_fused.decode_select_emit(*port.values(), t, t // STRIDE, **SELECT_KW)
    assert t_fused.decode_select_emit.launches == before
    np.testing.assert_allclose(c_out.numpy(), np.asarray(want_c), **TOL)
    info, want_info = info.reshape(B, KVH, -1), np.asarray(want_info).reshape(B, KVH, -1)
    np.testing.assert_array_equal(info[..., :INFO_USED].numpy(), want_info[..., :INFO_USED])
    assert not info[..., INFO_USED:].any()
    np.testing.assert_array_equal(port["ring"].numpy(), np.asarray(want_ring))
    np.testing.assert_allclose(port["ckv"][:, :, :-1].numpy(), np.asarray(want_ckv)[:, :, :-1],
                               **TOL)
    emitted = not np.array_equal(port["ckv"].numpy(), inp["ckv"])
    assert emitted == t_fused.emits(t, STRIDE) == ((t + 1) % STRIDE == 0)


def attend_inputs(seed, t):
    rs = np.random.RandomState(seed)
    inp = select_emit_inputs(seed)
    c_out, info, _, _ = jax_select_emit(inp, t)
    return dict(
        rq=rnd(rs, B, KVH, G, D), kv=rnd(rs, B, KVH, MAX_LEN, 2 * D),
        kv_new=rnd(rs, B, KVH, 1, 2 * D), info=np.asarray(info), c_out=np.asarray(c_out),
        gates=(1.0 / (1.0 + np.exp(-rnd(rs, B, KVH, G, 3)))).astype(np.float32),
        x=rnd(rs, B, 1, DIM), w_out=rnd(rs, KVH * G * D, DIM, scale=0.125),
    ), (1.0 + rnd(rs, DIM, scale=0.1), rnd(rs, DIM, FF_HID, scale=0.125),
        rnd(rs, FF_HID, scale=0.1), rnd(rs, FF_HID, DIM, scale=0.0625), rnd(rs, DIM, scale=0.1))


@pytest.mark.parametrize("with_ff", [True, False])
@pytest.mark.parametrize("t", [0, 5, 30, 63])
def test_decode_attend_fused_plain_matches_pallas(t, with_ff):
    inp, ff = attend_inputs(seed=40 + t, t=t)
    ff = ff if with_ff else ()
    want, want_kv = j_fused.decode_attend_fused(
        *(jnp.asarray(v) for v in inp.values()), jnp.int32(t),
        tuple(jnp.asarray(v) for v in ff), batch_tile=B, interpret=True, eps=1e-6,
        **ATTEND_KW)
    port = {k: T(v) for k, v in inp.items()}
    before = t_fused.decode_attend_fused.launches
    got = t_fused.decode_attend_fused(*port.values(), t, tuple(T(v) for v in ff), eps=1e-6,
                                      **ATTEND_KW)
    assert t_fused.decode_attend_fused.launches == before
    assert got.shape == (B, 1, DIM)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(port["kv"].numpy(), np.asarray(want_kv))


@functools.lru_cache(maxsize=None)
def model_params(seed=0):
    params = jax.jit(jt.init_transformer, static_argnums=1)(jax.random.PRNGKey(seed), j_tiny())
    return params, params_from_numpy(jax.tree_util.tree_map(np.asarray, params), device="cpu")


def count_jax_fused_traces(monkeypatch):
    """Count the traces through JAX's fused select kernel (its route)."""
    traces = []
    real = j_fused.decode_select_emit
    monkeypatch.setattr(j_fused, "decode_select_emit",
                        lambda *a, **k: traces.append(1) or real(*a, **k))
    return traces


def assert_caches_equal(t_layers, j_layers):
    for t_lc, j_lc in zip(t_layers, j_layers):
        for name, t_leaf, j_leaf in zip(t_lc._fields, t_lc, j_lc):
            t_leaf, j_leaf = t_leaf.numpy(), np.asarray(j_leaf)
            if name == "ckv":     # the trash row
                t_leaf, j_leaf = t_leaf[:, :, :-1], j_leaf[:, :, :-1]
            np.testing.assert_allclose(t_leaf, j_leaf, err_msg=name, **TOL)


@pytest.mark.parametrize("b,prompt,steps", [(1, 3, 7), (2, 6, 6)])
def test_layer_step_matches_jax_fused_route(b, prompt, steps, monkeypatch):
    """Layer 0 with its FF: JAX's fused kernels in interpret mode against
    the port's fused route, caches included."""
    traces = count_jax_fused_traces(monkeypatch)
    params, port = model_params()
    layer, t_layer = params["layers"][0], port["layers"][0]
    x = (np.random.RandomState(b).standard_normal((b, prompt + steps, DIM)) * 0.5
         ).astype(np.float32)
    j_cfg, t_cfg = j_tiny(attn_impl="pallas"), t_tiny()
    _, j_cache = j_nsa.sparse_attention_forward(
        layer["attn"], j_tiny(), jnp.asarray(x[:, :prompt]), return_cache_max_len=32)
    _, t_cache = t_nsa.sparse_attention_forward(
        t_layer["attn"], t_cfg, T(x[:, :prompt]), return_cache_max_len=32)
    j_step = jax.jit(lambda x_, c, t_: j_nsa.sparse_attention_decode(
        layer["attn"], j_cfg, x_, c, t_, ff_params=layer["ff"]))
    for t in range(prompt, prompt + steps):
        j_out, j_cache = j_step(jnp.asarray(x[:, t:t + 1]), j_cache, jnp.int32(t))
        t_out, t_cache = t_nsa.sparse_attention_decode(
            t_layer["attn"], t_cfg, T(x[:, t:t + 1]), t_cache, t, ff_params=t_layer["ff"])
        np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), err_msg=f"t={t}", **TOL)
        assert_caches_equal([t_cache], [j_cache])
    assert traces


@pytest.mark.parametrize("b,prompt,steps", [(1, 5, 6), (2, 8, 5), (9, 6, 3)])
def test_decode_step_matches_jax_pallas(b, prompt, steps, monkeypatch):
    """The model's decode step on packed params against JAX with
    attn_impl="pallas": fused on both sides at b <= 8, split at b = 9; the
    greedy tokens equal."""
    traces = count_jax_fused_traces(monkeypatch)
    params, port = model_params()
    j_cfg, t_cfg = j_tiny(attn_impl="pallas"), t_tiny()
    ids = np.random.RandomState(b).randint(0, 256, (b, prompt)).astype(np.int32)
    j_logits, j_cache = jax.jit(lambda p, i: jt.transformer_prefill(p, j_tiny(), i, 32))(
        params, jnp.asarray(ids))
    t_logits, t_cache = tt.transformer_prefill(port, t_cfg, T(ids), 32)
    j_step = jax.jit(lambda p, tok, c: jt.transformer_decode_step(p, j_cfg, tok, c))
    packed = tt.fuse_decode_params(port, t_cfg)
    assert tt.fuse_decode_params(packed, t_cfg) is packed
    token = np.asarray(j_logits[:, -1]).argmax(-1)
    for step in range(steps):
        j_logits, j_cache = j_step(params, jnp.asarray(token), j_cache)
        t_logits, t_cache = tt.transformer_decode_step(packed, t_cfg, T(token), t_cache)
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                                   err_msg=f"step {step}", **TOL)
        token = np.asarray(j_logits).argmax(-1)
        assert (t_logits.argmax(-1).numpy() == token).all(), f"step {step}"
    assert_caches_equal(t_cache.layers, j_cache.layers)
    assert bool(traces) == (b <= 8)


@pytest.mark.parametrize("b", [1, 2, 8, 9, 16, 64])
def test_route_follows_jax(b, monkeypatch):
    """The port's default route at batch b is JAX's: the fused pair where
    ``_use_fused_decode(...) and b <= 8``; one step shows which pair ran."""
    j_fused_route = j_nsa._use_fused_decode(j_tiny(attn_impl="pallas"), b, jnp.float32,
                                            MAX_LEN) and b <= 8
    assert t_nsa._use_fused_decode(t_tiny(), b) == j_fused_route
    calls = []
    for name in ("decode_select_emit", "decode_select"):
        fn = getattr(t_nsa, name)
        monkeypatch.setattr(t_nsa, name, functools.partial(
            lambda fn_, name_, *a, **k: calls.append(name_) or fn_(*a, **k), fn, name))
    _, port = model_params()
    cfg = t_tiny()
    x = T(np.random.RandomState(b).standard_normal((b, 5, DIM)).astype(np.float32))
    layer = port["layers"][0]
    _, cache = t_nsa.sparse_attention_forward(layer["attn"], cfg, x[:, :4],
                                              return_cache_max_len=16)
    t_nsa.sparse_attention_decode(layer["attn"], cfg, x[:, 4:], cache, 4,
                                  ff_params=layer["ff"])
    assert calls == ["decode_select_emit" if j_fused_route else "decode_select"]
    with pytest.raises(ValueError, match="route"):
        t_nsa.sparse_attention_decode(layer["attn"], cfg, x[:, 4:], cache, 4, route="mega")
