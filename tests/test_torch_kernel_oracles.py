"""The plain versions beside the port's CUDA kernels against nsa_tpu's
Pallas kernels, run in interpret mode on the CPU as nsa_tpu's own tests
run them:

* decode_select_plain  vs nsa_tpu.ops.pallas.nsa_decode.decode_select
  (branch-1 output and the packed info row: selected ids, trailing ids,
  validity);
* decode_attend_plain  vs nsa_tpu.ops.pallas.nsa_decode.decode_attend
  (fed the blocks the info row names, gathered on the JAX side);
* fine_sliding_plain   vs nsa_tpu.ops.pallas.nsa_prefill._forward
  (fine and sliding outputs and both log-sum-exps);
* prefill_bwd_dq_plain + prefill_bwd_dkv_plain vs
  nsa_tpu.ops.pallas.nsa_prefill._backward_kernels (dq, dk, dv, d_gates),
  and both against autograd through fine_sliding_plain with gates and
  through the autograd.Function nsa_fine_sliding_attention.

On CPU tensors each wrapper must run exactly its plain version and count no
launch.  Inputs from numpy with fixed seeds, float32; tolerance 1e-5 (sum
order), ids exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsa_tpu.ops.pallas import nsa_decode as j_dec
from nsa_tpu.ops.pallas import nsa_prefill as j_pre
from nsa_tpu_torch.ops.cuda import nsa_decode as t_dec
from nsa_tpu_torch.ops.cuda import nsa_prefill as t_pre
from nsa_tpu_torch.ops.nsa import _ckv_width

TOL = dict(rtol=1e-5, atol=1e-5)
# the tiny test configuration's NSA geometry
STRIDE, SEL_BLOCK, WINDOW, NUM_SEL = 2, 4, 8, 2
N_SLIDE = -(-WINDOW // SEL_BLOCK) + 1
MAX_LEN = 64


def rnd(rs, *shape):
    return rs.standard_normal(shape).astype(np.float32)


def T(x):
    return torch.from_numpy(np.array(x))


def select_inputs(seed, b=2, kvh=2, g=2, d=16, M=1):
    rs = np.random.RandomState(seed)
    Wc = _ckv_width(MAX_LEN, STRIDE, SEL_BLOCK // STRIDE)
    return rnd(rs, b, kvh, g, d), rnd(rs, b, kvh, Wc, 2 * d), rnd(rs, 2, kvh, M, d)


SELECT_KW = dict(max_blocks=MAX_LEN // SEL_BLOCK, stride=STRIDE, sel_block=SEL_BLOCK,
                 num_sel=NUM_SEL, n_slide=N_SLIDE, scale=0.25)


def jax_select(q, ckv, mem_kv, t):
    c_out, _, info = j_dec.decode_select(
        jnp.asarray(q), jnp.asarray(ckv), jnp.asarray(mem_kv), jnp.int32(t),
        jnp.int32(t // STRIDE), window=WINDOW, batch_tile=2, interpret=True, **SELECT_KW,
    )
    return np.asarray(c_out), np.asarray(info).reshape(q.shape[0], q.shape[1], -1)


@pytest.mark.parametrize("t", [1, 6, 13, 40, 63])
def test_decode_select_plain_matches_pallas(t):
    q, ckv, mem_kv = select_inputs(seed=t)
    want_c, want_info = jax_select(q, ckv, mem_kv, t)
    before = t_dec.decode_select.launches
    c_out, info = t_dec.decode_select(T(q), T(ckv), T(mem_kv), t, t // STRIDE, **SELECT_KW)
    assert t_dec.decode_select.launches == before
    np.testing.assert_allclose(c_out.numpy(), want_c, **TOL)
    used = 2 * NUM_SEL + N_SLIDE
    np.testing.assert_array_equal(info[..., :used].numpy(), want_info[..., :used])
    assert not info[..., used:].any()
    c_p, info_p = t_dec.decode_select_plain(T(q), T(ckv), T(mem_kv), t, t // STRIDE,
                                            **SELECT_KW)
    assert torch.equal(c_p, c_out) and torch.equal(info_p, info)


@pytest.mark.parametrize("t", [0, 6, 13, 40, 63])
def test_decode_attend_plain_matches_pallas(t):
    rs = np.random.RandomState(100 + t)
    b, kvh, g, d = 2, 2, 2, 16
    q, ckv, mem_kv = select_inputs(seed=t)
    c_out, info = jax_select(q, ckv, mem_kv, t)
    rq, kv = rnd(rs, b, kvh, g, d), rnd(rs, b, kvh, MAX_LEN, 2 * d)
    gates = (1.0 / (1.0 + np.exp(-rnd(rs, b, kvh, g, 3)))).astype(np.float32)
    n_slots = NUM_SEL + N_SLIDE
    ids = info[..., :n_slots]
    blocks = kv.reshape(b, kvh, MAX_LEN // SEL_BLOCK, SEL_BLOCK, 2 * d)
    fkv = blocks[np.arange(b)[:, None, None], np.arange(kvh)[None, :, None], ids]
    want = j_dec.decode_attend(
        jnp.asarray(rq), jnp.asarray(fkv.reshape(b, kvh, n_slots * SEL_BLOCK, 2 * d)),
        jnp.asarray(info.reshape(b, -1)), jnp.asarray(c_out), jnp.asarray(gates),
        jnp.int32(t), sel_block=SEL_BLOCK, window=WINDOW, num_sel=NUM_SEL,
        n_slide=N_SLIDE, scale=0.25, batch_tile=2, interpret=True,
    )
    kw = dict(sel_block=SEL_BLOCK, window=WINDOW, num_sel=NUM_SEL, n_slide=N_SLIDE,
              scale=0.25)
    before = t_dec.decode_attend.launches
    got = t_dec.decode_attend(T(rq), T(kv), T(info), T(c_out), T(gates), t, **kw)
    assert t_dec.decode_attend.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("n,sel_block,window,S,G", [
    pytest.param(40, 8, 12, 2, 2, id="40-8-12-2"), pytest.param(70, 16, 20, 3, 2, id="70-16-20-3"),
    pytest.param(9, 4, 8, 1, 2, id="9-4-8-1"),
    pytest.param(70, 8, 12, 16, 8, id="70-8-12-16-G8"),   # the CUDA kernel's widest tile
])
def test_fine_sliding_plain_matches_pallas(n, sel_block, window, S, G):
    """Random selections, including duplicates, the row's own block, future
    blocks and invalid slots: the kernel's masked-union semantics."""
    rs = np.random.RandomState(n)
    b, kvh, d = 2, 2, 16
    h = kvh * G
    rq, rk, v = rnd(rs, b, h, n, d), rnd(rs, b, kvh, n, d), rnd(rs, b, kvh, n, d)
    W = -(-n // sel_block)
    sel_idx = rs.randint(0, W, (b, kvh, n, S)).astype(np.int32)
    sel_mask = rs.rand(b, kvh, n, S) < 0.7
    fo, so, flse, slse = j_pre._forward(
        jnp.asarray(rq), jnp.asarray(rk), jnp.asarray(v), jnp.asarray(sel_idx),
        jnp.asarray(sel_mask), sel_block=sel_block, window=window, scale=0.3,
        block_q=32, block_k=64, interpret=True,
    )
    args = (T(rq), T(rk), T(v), T(sel_idx), T(sel_mask), sel_block, window, 0.3)
    before = t_pre.prefill_fwd.launches
    got = t_pre.prefill_fwd(*args)
    assert t_pre.prefill_fwd.launches == before
    np.testing.assert_allclose(got[0].numpy(), np.asarray(fo), **TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(so), **TOL)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(flse)[..., :n, 0].reshape(b, h, n),
                               **TOL)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(slse)[..., :n, 0].reshape(b, h, n),
                               **TOL)
    plain = t_pre.fine_sliding_plain(*args, chunk=16)   # chunking changes nothing
    for x, y in zip(plain, got):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("n,sel_block,window,S", [(40, 8, 12, 2), (70, 16, 20, 3), (9, 4, 8, 1)])
def test_fine_sliding_backward_plain_matches_pallas(n, sel_block, window, S):
    """The same selections as the forward test (duplicates, the row's own
    block, future blocks, invalid slots): d_gates follows the Pallas slot
    masks, so a duplicate or own-block slot gets its block's gradient."""
    rs = np.random.RandomState(n)
    b, h, kvh, d = 2, 4, 2, 16
    rq, rk, v = rnd(rs, b, h, n, d), rnd(rs, b, kvh, n, d), rnd(rs, b, kvh, n, d)
    W = -(-n // sel_block)
    sel_idx = rs.randint(0, W, (b, kvh, n, S)).astype(np.int32)
    sel_mask = rs.rand(b, kvh, n, S) < 0.7
    dfo, dso = rnd(rs, b, h, n, d), rnd(rs, b, h, n, d)
    kw = dict(sel_block=sel_block, window=window, scale=0.3)
    jin = [jnp.asarray(x) for x in (rq, rk, v, sel_idx, sel_mask)]
    fo, so, flse, slse = j_pre._forward(*jin, block_q=32, block_k=64, interpret=True, **kw)
    want = j_pre._backward_kernels(*jin, fo, so, flse, slse, jnp.asarray(dfo), jnp.asarray(dso),
                                   block_q=32, block_k=64, interpret=True, **kw)

    sel = (T(rq), T(rk), T(v), T(sel_idx), T(sel_mask))
    flse_t = T(np.asarray(flse)[..., :n, 0].reshape(b, h, n))
    slse_t = T(np.asarray(slse)[..., :n, 0].reshape(b, h, n))
    before = (t_pre.prefill_bwd_dq.launches, t_pre.prefill_bwd_dkv.launches)
    dq, dg, fdel, sdel = t_pre.prefill_bwd_dq(*sel, T(fo), T(so), flse_t, slse_t, T(dfo),
                                              T(dso), sel_block, window, 0.3)
    dk, dv = t_pre.prefill_bwd_dkv(*sel, flse_t, slse_t, fdel, sdel, T(dfo), T(dso),
                                   sel_block, window, 0.3)
    assert (t_pre.prefill_bwd_dq.launches, t_pre.prefill_bwd_dkv.launches) == before
    got = (dq, dk, dv, dg)
    for x, y in zip(got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), **TOL)
    assert dg.abs().max() > 0

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in sel[:3]]
        gates = torch.ones(b, kvh, n, S, requires_grad=True)
        fo_, so_ = fn(*leaves, gates)[:2]
        return torch.autograd.grad((fo_ * T(dfo)).sum() + (so_ * T(dso)).sum(),
                                   leaves + [gates])

    for fn in (lambda q, k, v_, g: t_pre.fine_sliding_plain(q, k, v_, *sel[3:], sel_block,
                                                            window, 0.3, gates=g),
               lambda q, k, v_, g: t_pre.nsa_fine_sliding_attention(q, k, v_, *sel[3:], g,
                                                                    sel_block, window, 0.3)):
        for x, y in zip(grads(fn), got):
            np.testing.assert_allclose(x.numpy(), y.numpy(), **TOL)
