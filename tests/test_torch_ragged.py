"""The port's ragged decode (one position per row, the serving engine's
step) and true-length prefill against nsa_tpu's.

* ``rotate_at_row_offsets`` against JAX's;
* the prefill with per-row ``true_len``: logits at each row's real
  positions, kv, the live ckv rows and the ring;
* the plain versions of the ragged kernels (rows 8-11 of the kernel table:
  ``decode_select_emit_ragged``, ``decode_attend_fused_ragged``,
  ``decode_attend_fused_paged``, ``paged_gather``) against the Pallas
  kernels in interpret mode, at mixed positions that include emitting rows,
  positions before the first full compression window and t = 0, and for
  the paged kernel a shuffled page table;
* ``transformer_decode_step_ragged`` on the default (fused) and the split
  route against JAX's ragged step (``attn_impl="pallas"``; the split route
  under ``NSA_NO_FUSED_DECODE=1``), at uniform and mixed positions, and the
  paged step against the dense one.

Inputs from numpy with fixed seeds, float32 on the CPU.  Tolerance
atol/rtol 2e-4, the repo's decode tolerance (float32 sums in another order
through the layer's matmuls); selected ids, ring shifts and cache rows that
are copied exactly; caches equal outside ckv's trash row, which only the
split route writes.
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
from nsa_tpu.ops import rotary as j_rotary
from nsa_tpu.ops.pallas import nsa_decode_fused as j_fused
from nsa_tpu.ops.pallas import paged_gather as j_gather
from nsa_tpu_torch import tiny_test_config as t_tiny
from nsa_tpu_torch.models import transformer as tt
from nsa_tpu_torch.ops import nsa as t_nsa
from nsa_tpu_torch.ops import rotary as t_rotary
from nsa_tpu_torch.ops.cuda import nsa_decode_ragged as t_ragged
from nsa_tpu_torch.ops.cuda import paged_gather as t_gather
from nsa_tpu_torch.utils.checkpoint import params_from_numpy

TOL = dict(rtol=2e-4, atol=2e-4)
# the tiny test configuration's geometry
KVH, G, D, M = 2, 2, 16, 1
STRIDE, BC, SEL_BLOCK, WINDOW, NUM_SEL = 2, 4, 4, 8, 2
N_SLIDE = -(-WINDOW // SEL_BLOCK) + 1
N_SLOTS = NUM_SEL + N_SLIDE
MAX_LEN, HID, DIM, FF_HID, PAGE = 64, 64, 64, 256, 8
INFO_USED = 2 * NUM_SEL + N_SLIDE
WC = t_nsa._ckv_width(MAX_LEN, STRIDE, SEL_BLOCK // STRIDE)
SELECT_KW = dict(max_blocks=MAX_LEN // SEL_BLOCK, stride=STRIDE, sel_block=SEL_BLOCK,
                 num_sel=NUM_SEL, n_slide=N_SLIDE, scale=0.25)
ATTEND_KW = dict(sel_block=SEL_BLOCK, window=WINDOW, num_sel=NUM_SEL, n_slide=N_SLIDE,
                 scale=0.25)
# emitting rows (odd t: stride 2), t < Bc (0, 1, 2), t = 0, the last row
POSITIONS = np.array([0, 1, 2, 5, 30, 63], np.int32)
B = len(POSITIONS)


def rnd(rs, *shape, scale=1.0):
    return (rs.standard_normal(shape) * scale).astype(np.float32)


def T(x):
    return torch.from_numpy(np.array(x))


def test_rotate_at_row_offsets_matches_jax():
    rs = np.random.RandomState(0)
    x = rnd(rs, 5, 3, 1, 16)
    offs = np.array([0, 1, 17, 4095, 300], np.int32)
    want = j_rotary.rotate_at_row_offsets(jnp.asarray(x), jnp.asarray(offs), 500.0)
    got = t_rotary.rotate_at_row_offsets(T(x), T(offs), 500.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        t_rotary.rotate_at_row_offsets(T(x), T(offs[:4]))


@functools.lru_cache(maxsize=None)
def model_params(seed=0):
    params = jax.jit(jt.init_transformer, static_argnums=1)(jax.random.PRNGKey(seed), j_tiny())
    return params, params_from_numpy(jax.tree_util.tree_map(np.asarray, params), device="cpu")


@pytest.mark.parametrize("true_len", [[3, 16, 9, 1], 11])
def test_prefill_true_len_matches_jax(true_len):
    """Right-padded prompts at their true lengths: the logits at each row's
    real positions, kv, the live ckv rows and the ring of every layer."""
    params, port = model_params()
    b, n, max_len = 4, 16, 32
    ids = np.random.RandomState(3).randint(0, 256, (b, n)).astype(np.int32)
    tl = np.broadcast_to(np.asarray(true_len, np.int32), (b,))
    j_logits, j_cache = jax.jit(lambda p, i, tl_: jt.transformer_prefill(
        p, j_tiny(), i, max_len, true_len=tl_))(params, jnp.asarray(ids),
                                                jnp.asarray(true_len, jnp.int32))
    t_true = T(np.asarray(true_len, np.int32)) if isinstance(true_len, list) else true_len
    t_logits, t_cache = tt.transformer_prefill(port, t_tiny(), T(ids).long(), max_len,
                                               true_len=t_true)
    assert t_cache.seq_len == int(np.max(tl)) == int(j_cache.seq_len)
    for i, L in enumerate(tl):
        np.testing.assert_allclose(t_logits[i, :L].numpy(), np.asarray(j_logits)[i, :L], **TOL)
        for t_lc, j_lc in zip(t_cache.layers, j_cache.layers):
            np.testing.assert_allclose(t_lc.kv[i, :, :L].numpy(), np.asarray(j_lc.kv)[i, :, :L],
                                       **TOL)
            live = L // STRIDE
            np.testing.assert_allclose(t_lc.ckv[i, :, :live].numpy(),
                                       np.asarray(j_lc.ckv)[i, :, :live], **TOL)
            np.testing.assert_allclose(t_lc.ring[i].numpy(), np.asarray(j_lc.ring)[i], **TOL)


def select_emit_inputs(seed):
    rs = np.random.RandomState(seed)
    return dict(
        q=rnd(rs, B, KVH, G, D), ckv=rnd(rs, B, KVH, WC, 2 * D), ring=rnd(rs, B, KVH, BC, 2 * D),
        kv_new=rnd(rs, B, KVH, 1, 2 * D), mem_kv=rnd(rs, 2, KVH, M, D),
        pos_kv=rnd(rs, KVH, BC, 2 * D, scale=0.1),
        w1k=rnd(rs, KVH, BC * D, HID, scale=0.125), b1k=rnd(rs, KVH, HID, scale=0.1),
        w1v=rnd(rs, KVH, BC * D, HID, scale=0.125), b1v=rnd(rs, KVH, HID, scale=0.1),
        w2=rnd(rs, KVH, HID, 2 * D, scale=0.125), b2=rnd(rs, KVH, 2 * D, scale=0.1),
    )


def jax_select_emit_ragged(inp, t):
    kw = dict(SELECT_KW)
    return j_fused.decode_select_emit_ragged(
        *(jnp.asarray(v) for v in inp.values()), jnp.asarray(t), jnp.asarray(t // STRIDE),
        kw.pop("max_blocks"), batch_tile=B, interpret=True, **kw)


@pytest.mark.parametrize("seed", [0, 1])
def test_decode_select_emit_ragged_plain_matches_pallas(seed):
    inp = select_emit_inputs(seed)
    want_c, want_info, want_ckv, want_ring = jax_select_emit_ragged(inp, POSITIONS)
    port = {k: T(v) for k, v in inp.items()}
    before = t_ragged.decode_select_emit_ragged.launches
    c_out, info = t_ragged.decode_select_emit_ragged(
        *port.values(), T(POSITIONS), T(POSITIONS // STRIDE), **SELECT_KW)
    assert t_ragged.decode_select_emit_ragged.launches == before
    np.testing.assert_allclose(c_out.numpy(), np.asarray(want_c), **TOL)
    info, want_info = info.reshape(B, KVH, -1), np.asarray(want_info).reshape(B, KVH, -1)
    np.testing.assert_array_equal(info[..., :INFO_USED].numpy(), want_info[..., :INFO_USED])
    assert not info[..., INFO_USED:].any()
    np.testing.assert_array_equal(port["ring"].numpy(), np.asarray(want_ring))
    np.testing.assert_allclose(port["ckv"].numpy(), np.asarray(want_ckv), **TOL)
    for i, t in enumerate(POSITIONS):
        slot = t // STRIDE
        others = [r for r in range(WC) if r != slot]
        np.testing.assert_array_equal(port["ckv"][i][:, others].numpy(), inp["ckv"][i][:, others])
        changed = not np.array_equal(port["ckv"][i, :, slot].numpy(), inp["ckv"][i, :, slot])
        assert changed == bool((t + 1) % STRIDE == 0), f"row {i} t={t}"


def attend_inputs(seed):
    rs = np.random.RandomState(seed)
    inp = select_emit_inputs(seed)
    c_out, info, _, _ = jax_select_emit_ragged(inp, POSITIONS)
    return dict(
        rq=rnd(rs, B, KVH, G, D), kv=rnd(rs, B, KVH, MAX_LEN, 2 * D),
        kv_new=rnd(rs, B, KVH, 1, 2 * D), info=np.asarray(info), c_out=np.asarray(c_out),
        gates=(1.0 / (1.0 + np.exp(-rnd(rs, B, KVH, G, 3)))).astype(np.float32),
        x=rnd(rs, B, 1, DIM), w_out=rnd(rs, KVH * G * D, DIM, scale=0.125),
    ), (1.0 + rnd(rs, DIM, scale=0.1), rnd(rs, DIM, FF_HID, scale=0.125),
        rnd(rs, FF_HID, scale=0.1), rnd(rs, FF_HID, DIM, scale=0.0625), rnd(rs, DIM, scale=0.1))


def to_pool(kv, seed):
    """A dense cache [b, kvh, max_len, 2d] as a shuffled page pool [b *
    max_pages + 1, kvh, PAGE, 2d] (the last page is trash) and its table."""
    b, kvh, L, d2 = kv.shape
    n_pg = L // PAGE
    perm = np.random.RandomState(seed).permutation(b * n_pg)
    table = perm.reshape(b, n_pg).astype(np.int32)
    pool = np.random.RandomState(seed + 1).standard_normal((b * n_pg + 1, kvh, PAGE, d2)
                                                           ).astype(np.float32)
    pool[table.reshape(-1)] = kv.reshape(b, kvh, n_pg, PAGE, d2).transpose(0, 2, 1, 3, 4
                                                                           ).reshape(-1, kvh,
                                                                                     PAGE, d2)
    return pool, table


def from_pool(pool, table):
    b, n_pg = table.shape
    _, kvh, page, d2 = pool.shape
    return pool[table].transpose(0, 2, 1, 3, 4).reshape(b, kvh, n_pg * page, d2)


@pytest.mark.parametrize("with_ff", [True, False])
def test_decode_attend_fused_ragged_and_paged_plain_match_pallas(with_ff):
    """The dense and the paged attend at mixed positions against their
    Pallas kernels; the paged one equals the dense one bit for bit on the
    same logical cache, and its pool through the table is the dense cache."""
    inp, ff = attend_inputs(seed=7)
    ff = ff if with_ff else ()
    t = POSITIONS
    j_ff = tuple(jnp.asarray(v) for v in ff)
    want, want_kv = j_fused.decode_attend_fused_ragged(
        *(jnp.asarray(v) for v in inp.values()), jnp.asarray(t), j_ff, batch_tile=B,
        interpret=True, eps=1e-6, **ATTEND_KW)
    port = {k: T(v) for k, v in inp.items()}
    before = t_ragged.decode_attend_fused_ragged.launches
    got = t_ragged.decode_attend_fused_ragged(*port.values(), T(t), tuple(T(v) for v in ff),
                                              eps=1e-6, **ATTEND_KW)
    assert t_ragged.decode_attend_fused_ragged.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(port["kv"].numpy(), np.asarray(want_kv))
    for i, ti in enumerate(t):
        np.testing.assert_array_equal(port["kv"][i, :, ti].numpy(), inp["kv_new"][i, :, 0])

    pool, table = to_pool(inp["kv"], seed=11)
    rest = [inp[k] for k in ("kv_new", "info", "c_out", "gates", "x", "w_out")]
    want_p, want_pool = j_fused.decode_attend_fused_paged(
        jnp.asarray(inp["rq"]), jnp.asarray(pool), jnp.asarray(table),
        *(jnp.asarray(v) for v in rest), jnp.asarray(t), j_ff, batch_tile=B, interpret=True,
        eps=1e-6, **ATTEND_KW)
    t_pool = T(pool)
    before = t_ragged.decode_attend_fused_paged.launches
    got_p = t_ragged.decode_attend_fused_paged(T(inp["rq"]), t_pool, T(table),
                                               *(T(v) for v in rest), T(t),
                                               tuple(T(v) for v in ff), eps=1e-6, **ATTEND_KW)
    assert t_ragged.decode_attend_fused_paged.launches == before
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), **TOL)
    np.testing.assert_array_equal(t_pool.numpy(), np.asarray(want_pool))
    np.testing.assert_array_equal(got_p.numpy(), got.numpy())
    np.testing.assert_array_equal(from_pool(t_pool.numpy(), table), port["kv"].numpy())
    np.testing.assert_array_equal(t_pool[-1].numpy(), pool[-1])      # trash page untouched


@pytest.mark.parametrize("b, kvh, max_len, width, block, slots, strided", [
    (3, KVH, MAX_LEN, 2 * D, SEL_BLOCK, N_SLOTS, False),
    (2, 3, 96, 8, 8, 5, False),
    # the ids as the split route passes them: the first columns of its info rows
    (3, KVH, MAX_LEN, 2 * D, SEL_BLOCK, N_SLOTS, True),
], ids=["tiny", "second-shape", "strided-ids"])
def test_paged_gather_plain_matches_pallas(b, kvh, max_len, width, block, slots, strided):
    rs = np.random.RandomState(5)
    cache = rnd(rs, b, kvh, max_len, width)
    table = rs.randint(0, max_len // block, (b, kvh, slots + 3 * strided)).astype(np.int32)
    idx = table[..., :slots]
    want = j_gather.paged_gather(jnp.asarray(cache), jnp.asarray(idx), block, interpret=True)
    t_idx = T(table)[..., :slots] if strided else T(idx)
    assert t_idx.is_contiguous() != strided
    before = t_gather.paged_gather.launches
    got = t_gather.paged_gather(T(cache), t_idx, block)
    assert t_gather.paged_gather.launches == before
    assert tuple(got.shape) == (b, kvh, slots * block, width)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def assert_caches_equal(t_layers, j_layers, rows=None):
    for t_lc, j_lc in zip(t_layers, j_layers):
        for name, t_leaf, j_leaf in zip(t_lc._fields, t_lc, j_lc):
            t_leaf, j_leaf = t_leaf.numpy(), np.asarray(j_leaf)
            if rows is not None:
                t_leaf, j_leaf = t_leaf[rows], j_leaf[rows]
            if name == "ckv":     # the trash row
                t_leaf, j_leaf = t_leaf[:, :, :-1], j_leaf[:, :, :-1]
            np.testing.assert_allclose(t_leaf, j_leaf, err_msg=name, **TOL)


MAX_LEN_STEP = 32


def prompt_ids(lens):
    return np.random.RandomState(1).randint(0, 256, (len(lens), max(lens))).astype(np.int32)


def port_pool(lens):
    """Each row prefilled alone at its own length by the port, stacked into
    a pool (the prefill is held against JAX's above; both steps below start
    from these caches)."""
    _, port = model_params()
    ids = prompt_ids(lens)
    pool = [tt.transformer_prefill(port, t_tiny(), T(ids[i:i + 1, :L]).long(),
                                   MAX_LEN_STEP)[1].layers for i, L in enumerate(lens)]
    return tuple(t_nsa.NSADecodeCache(*(torch.cat(leaves) for leaves in zip(*per_layer)))
                 for per_layer in zip(*pool))


TRACED = {}       # route -> the JAX kernels its traced step called


@functools.lru_cache(maxsize=None)
def jax_ragged_step(route):
    """JAX's ragged step, jitted once per route (traced where the test has
    set the route's environment)."""
    cfg = j_tiny(attn_impl="pallas")
    return jax.jit(lambda p, tok, layers, seq: jt.transformer_decode_step_ragged(
        p, cfg, tok, layers, seq))


@pytest.mark.parametrize("route", [None, "split"])
@pytest.mark.parametrize("lens", [(13, 13, 13, 13), (13, 9, 17, 6)])
def test_decode_step_ragged_matches_jax(lens, route, monkeypatch):
    """Two ragged steps at uniform and mixed positions: JAX's fused ragged
    kernels (interpret mode) against the port's default route, JAX's XLA
    branches with its Pallas block gather (NSA_NO_FUSED_DECODE=1) against
    the port's split route; the logits and every cache."""
    if route == "split":
        monkeypatch.setenv("NSA_NO_FUSED_DECODE", "1")
    used = TRACED.setdefault(route, set())      # filled where the step is traced
    for mod, name in ((j_fused, "decode_select_emit_ragged"), (j_gather, "paged_gather")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, functools.partial(
            lambda r, n, *a, **k: used.add(n) or r(*a, **k), real, name))
    params, port = model_params()
    packed = tt.fuse_decode_params(port, t_tiny())
    t_layers = port_pool(lens)
    # copies: the port writes its caches in place
    j_layers = tuple(j_nsa.NSADecodeCache(*(jnp.array(x.numpy(), copy=True) for x in lc))
                     for lc in t_layers)
    j_step = jax_ragged_step(route)
    counted = (t_ragged.decode_select_emit_ragged, t_gather.paged_gather)
    tok = np.arange(len(lens), dtype=np.int32)
    seq = np.asarray(lens, np.int32)
    for step in range(2):
        j_logits, j_layers = j_step(params, jnp.asarray(tok), j_layers, jnp.asarray(seq))
        t_logits, t_layers = tt.transformer_decode_step_ragged(
            packed, t_tiny(), T(tok).long(), t_layers, T(seq), route=route)
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                                   err_msg=f"step {step}", **TOL)
        assert_caches_equal(t_layers, j_layers)
        tok, seq = np.asarray(j_logits).argmax(-1).astype(np.int32), seq + 1
    assert used == {"paged_gather" if route else "decode_select_emit_ragged"}
    assert all(fn.launches == 0 for fn in counted)      # CPU: the plain versions


def test_decode_step_paged_equals_dense():
    """The paged ragged step equals the dense one bit for bit on the same
    logical caches under a shuffled table, pool and caches included; paged
    with a scalar position or on the split route raises, as in JAX."""
    _, port = model_params()
    cfg = t_tiny()
    packed = tt.fuse_decode_params(port, cfg)
    lens = (13, 9, 17, 6)
    dense = port_pool(lens)
    table = None
    paged = []
    for lc in dense:
        pool, table = to_pool(lc.kv.numpy(), seed=3)
        paged.append(t_nsa.NSADecodeCache(T(pool), lc.ckv.clone(), lc.ring.clone()))
    tok, seq = T(np.arange(4)).long(), T(np.asarray(lens, np.int32))
    for _ in range(3):
        lg_d, dense = tt.transformer_decode_step_ragged(packed, cfg, tok, dense, seq)
        lg_p, paged = tt.transformer_decode_step_ragged(packed, cfg, tok, paged, seq,
                                                        T(table))
        np.testing.assert_array_equal(lg_p.numpy(), lg_d.numpy())
        tok, seq = lg_d.argmax(-1), seq + 1
    for d_lc, p_lc in zip(dense, paged):
        np.testing.assert_array_equal(from_pool(p_lc.kv.numpy(), table), d_lc.kv.numpy())
        np.testing.assert_array_equal(p_lc.ckv.numpy(), d_lc.ckv.numpy())
        np.testing.assert_array_equal(p_lc.ring.numpy(), d_lc.ring.numpy())
    layer = packed["layers"][0]
    x = torch.zeros(4, 1, DIM)
    with pytest.raises(NotImplementedError):
        t_nsa.sparse_attention_decode(layer["attn"], cfg, x, paged[0], 5, page_table=T(table))
    with pytest.raises(NotImplementedError):
        t_nsa.sparse_attention_decode(layer["attn"], cfg, x, paged[0], seq, route="split",
                                      page_table=T(table))
    with pytest.raises(ValueError, match="route"):
        tt.transformer_decode_step_ragged(packed, cfg, tok, dense, seq, route="mega")
