"""The fused pair at one position (rows 6-7) is the ragged pair (rows 8-9)
at a position every row shares.

The card's kernels for rows 6-7 run the bodies of rows 8-9 with the
position passed by the host, so the port relies on the two pairs computing
the same function there.  On the CPU, through the plain versions:

* ``decode_select_emit`` equals ``decode_select_emit_ragged`` with every
  row at ``t`` and ``num_cb = t // stride``: c_out, info, ckv and ring bit
  for bit, in float32 and bf16, at G 1, 2 and 4, for t before the first
  full compression window (emitting and not), an emitting t and a
  non-emitting t;
* ``decode_attend_fused`` equals ``decode_attend_fused_ragged`` the same
  way, with and without the FF: the output, the kv cache and the rounded
  attention output (``attn_out``) bit for bit;
* both, at one position for every row, against the Pallas kernels of both
  pairs in interpret mode on ``tiny_test_config``'s geometry, as
  ``tests/test_torch_decode_fused.py`` runs them (atol/rtol 2e-4; selected
  ids, the ring and the kv cache exact).

Inputs from numpy with fixed seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsa_tpu.ops.pallas import nsa_decode_fused as j_fused
from nsa_tpu_torch.ops import nsa as t_nsa
from nsa_tpu_torch.ops.cuda import nsa_decode_fused as t_fused
from nsa_tpu_torch.ops.cuda import nsa_decode_ragged as t_ragged

TOL = dict(rtol=2e-4, atol=2e-4)
# the tiny test configuration's geometry
B, KVH, G, D, M = 3, 2, 2, 16, 1
STRIDE, BC, SEL_BLOCK, WINDOW, NUM_SEL = 2, 4, 4, 8, 2
N_SLIDE = -(-WINDOW // SEL_BLOCK) + 1
MAX_LEN, HID, DIM, FF_HID = 64, 64, 64, 256
WC = t_nsa._ckv_width(MAX_LEN, STRIDE, SEL_BLOCK // STRIDE)
INFO_USED = 2 * NUM_SEL + N_SLIDE
SELECT_KW = dict(max_blocks=MAX_LEN // SEL_BLOCK, stride=STRIDE, sel_block=SEL_BLOCK,
                 num_sel=NUM_SEL, n_slide=N_SLIDE, scale=0.25)
ATTEND_KW = dict(sel_block=SEL_BLOCK, window=WINDOW, num_sel=NUM_SEL, n_slide=N_SLIDE,
                 scale=0.25)
# t = 0 and 1 lie before the first full window (Bc 4); odd t emits (stride 2)
SELECT_T = [0, 1, 13, 30]


def rnd(rs, *shape, scale=1.0):
    return (rs.standard_normal(shape) * scale).astype(np.float32)


def select_emit_inputs(seed, g=G):
    rs = np.random.RandomState(seed)
    return dict(
        q=rnd(rs, B, KVH, g, D), ckv=rnd(rs, B, KVH, WC, 2 * D), ring=rnd(rs, B, KVH, BC, 2 * D),
        kv_new=rnd(rs, B, KVH, 1, 2 * D), mem_kv=rnd(rs, 2, KVH, M, D),
        pos_kv=rnd(rs, KVH, BC, 2 * D, scale=0.1),
        w1k=rnd(rs, KVH, BC * D, HID, scale=0.125), b1k=rnd(rs, KVH, HID, scale=0.1),
        w1v=rnd(rs, KVH, BC * D, HID, scale=0.125), b1v=rnd(rs, KVH, HID, scale=0.1),
        w2=rnd(rs, KVH, HID, 2 * D, scale=0.125), b2=rnd(rs, KVH, 2 * D, scale=0.1),
    )


def port(inp, dtype=torch.float32):
    """Copies in ``dtype``; the biases stay float32, as the packed weights
    keep them."""
    return {k: torch.tensor(v, dtype=torch.float32 if k[0] == "b" else dtype)
            for k, v in inp.items()}


def uniform(t):
    return torch.full((B,), t, dtype=torch.int32)


def select_both(inp, t, dtype):
    """(c_out, info, ckv, ring) of the one-position and the ragged plain
    select-emit on copies of the same inputs."""
    runs = []
    for ragged in (False, True):
        p = port(inp, dtype)
        pos = (uniform(t), uniform(t // STRIDE)) if ragged else (t, t // STRIDE)
        fn = t_ragged.decode_select_emit_ragged if ragged else t_fused.decode_select_emit
        runs.append((*fn(*p.values(), *pos, **SELECT_KW), p["ckv"], p["ring"]))
    return runs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("t", SELECT_T)
def test_select_emit_one_position_is_the_ragged_one(t, g, dtype):
    inp = select_emit_inputs(seed=100 + t, g=g)
    (c_s, info_s, ckv_s, ring_s), (c_r, info_r, ckv_r, ring_r) = select_both(inp, t, dtype)
    assert torch.equal(c_s, c_r) and torch.equal(info_s, info_r)
    assert torch.equal(ckv_s, ckv_r) and torch.equal(ring_s, ring_r)
    emitted = not torch.equal(ckv_s, port(inp, dtype)["ckv"])
    assert emitted == t_fused.emits(t, STRIDE) == bool(
        t_ragged.ragged_emits(uniform(t), uniform(t // STRIDE), STRIDE).all())


def attend_inputs(seed, t):
    rs = np.random.RandomState(seed)
    inp = select_emit_inputs(seed)
    c_out, info = t_fused.decode_select_emit_plain(
        *port(inp).values(), t, t // STRIDE, **SELECT_KW)
    return dict(
        rq=rnd(rs, B, KVH, G, D), kv=rnd(rs, B, KVH, MAX_LEN, 2 * D),
        kv_new=rnd(rs, B, KVH, 1, 2 * D), info=info.numpy(), c_out=c_out.numpy(),
        gates=(1.0 / (1.0 + np.exp(-rnd(rs, B, KVH, G, 3)))).astype(np.float32),
        x=rnd(rs, B, 1, DIM), w_out=rnd(rs, KVH * G * D, DIM, scale=0.125),
    ), (1.0 + rnd(rs, DIM, scale=0.1), rnd(rs, DIM, FF_HID, scale=0.125),
        rnd(rs, FF_HID, scale=0.1), rnd(rs, FF_HID, DIM, scale=0.0625), rnd(rs, DIM, scale=0.1))


def attend_port(inp, ff, dtype):
    """Copies in ``dtype`` (info int32; the FF's norm scale and biases stay
    float32, as the packed weights keep them)."""
    p = {k: torch.tensor(v) if k == "info" else torch.tensor(v, dtype=dtype)
         for k, v in inp.items()}
    ff_t = tuple(torch.tensor(v, dtype=dtype if i in (1, 3) else torch.float32)
                 for i, v in enumerate(ff))
    return p, ff_t


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_ff", [True, False])
@pytest.mark.parametrize("t", [0, 5, 63])
def test_attend_fused_one_position_is_the_ragged_one(t, with_ff, dtype):
    inp, ff = attend_inputs(seed=200 + t, t=t)
    ff = ff if with_ff else ()
    runs = []
    for ragged in (False, True):
        p, ff_t = attend_port(inp, ff, dtype)
        attn_out = torch.empty_like(p["rq"])
        fn = t_ragged.decode_attend_fused_ragged if ragged else t_fused.decode_attend_fused
        out = fn(*p.values(), uniform(t) if ragged else t, ff_t, attn_out=attn_out, eps=1e-6,
                 **ATTEND_KW)
        runs.append((out, p["kv"], attn_out))
    (out_s, kv_s, comb_s), (out_r, kv_r, comb_r) = runs
    assert torch.equal(out_s, out_r) and torch.equal(kv_s, kv_r) and torch.equal(comb_s, comb_r)
    assert torch.equal(kv_s[:, :, t], torch.from_numpy(inp["kv_new"][:, :, 0]).to(dtype))
    assert torch.isfinite(comb_s.float()).all() and comb_s.abs().max() > 0


def jnp_all(inp):
    return tuple(jnp.asarray(v) for v in inp.values())


@pytest.mark.parametrize("t", [1, 2, 13])
def test_select_emit_one_position_matches_both_pallas_kernels(t):
    """t = 1 emits a window whose first rows lie before the sequence start,
    t = 2 lies before the first full window and does not emit, t = 13
    emits."""
    inp = select_emit_inputs(seed=300 + t)
    kw = dict(SELECT_KW)
    max_blocks = kw.pop("max_blocks")
    want_s = j_fused.decode_select_emit(*jnp_all(inp), jnp.int32(t), jnp.int32(t // STRIDE),
                                        max_blocks, batch_tile=B, interpret=True, **kw)
    want_r = j_fused.decode_select_emit_ragged(
        *jnp_all(inp), jnp.full((B,), t, jnp.int32), jnp.full((B,), t // STRIDE, jnp.int32),
        max_blocks, batch_tile=B, interpret=True, **kw)
    _, (c_out, info, ckv, ring) = select_both(inp, t, torch.float32)
    info = info.reshape(B, KVH, -1)
    for want_c, want_info, want_ckv, want_ring in (want_s, want_r):
        np.testing.assert_allclose(c_out.numpy(), np.asarray(want_c), **TOL)
        want_info = np.asarray(want_info).reshape(B, KVH, -1)
        np.testing.assert_array_equal(info[..., :INFO_USED].numpy(), want_info[..., :INFO_USED])
        np.testing.assert_array_equal(ring.numpy(), np.asarray(want_ring))
        np.testing.assert_allclose(ckv[:, :, :-1].numpy(), np.asarray(want_ckv)[:, :, :-1],
                                   **TOL)
    assert not info[..., INFO_USED:].any()


@pytest.mark.parametrize("with_ff", [True, False])
@pytest.mark.parametrize("t", [0, 63])
def test_attend_fused_one_position_matches_both_pallas_kernels(t, with_ff):
    inp, ff = attend_inputs(seed=400 + t, t=t)
    ff = ff if with_ff else ()
    j_ff = tuple(jnp.asarray(v) for v in ff)
    want_s = j_fused.decode_attend_fused(*jnp_all(inp), jnp.int32(t), j_ff, batch_tile=B,
                                         interpret=True, eps=1e-6, **ATTEND_KW)
    want_r = j_fused.decode_attend_fused_ragged(*jnp_all(inp), jnp.full((B,), t, jnp.int32),
                                                j_ff, batch_tile=B, interpret=True, eps=1e-6,
                                                **ATTEND_KW)
    p, ff_t = attend_port(inp, ff, torch.float32)
    got = t_ragged.decode_attend_fused_ragged(*p.values(), uniform(t), ff_t, eps=1e-6,
                                              **ATTEND_KW)
    for want, want_kv in (want_s, want_r):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_array_equal(p["kv"].numpy(), np.asarray(want_kv))
