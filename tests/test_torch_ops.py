"""The port's plain ops (nsa_tpu_torch.ops.{common,rotary,compress,selection,
attention}) against their nsa_tpu twins.

Inputs come from numpy with a fixed seed and go through both packages in
float32 on the CPU.  Tolerance: atol/rtol 1e-5 (float32 sums taken in
another order by XLA and by PyTorch; everything else is exact).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsa_tpu.config import NSAConfig
from nsa_tpu.ops import attention as ja
from nsa_tpu.ops import common as jc
from nsa_tpu.ops import compress as jcomp
from nsa_tpu.ops import rotary as jr
from nsa_tpu.ops import selection as js
from nsa_tpu_torch.ops import attention as ta
from nsa_tpu_torch.ops import common as tc
from nsa_tpu_torch.ops import compress as tcomp
from nsa_tpu_torch.ops import rotary as tr
from nsa_tpu_torch.ops import selection as ts

TOL = dict(rtol=1e-5, atol=1e-5)


def rnd(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).standard_normal(shape) * scale).astype(np.float32)


def T(x):
    return torch.from_numpy(np.array(x))


def close(t_out, j_out, **tol):
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(j_out), **(tol or TOL))


# ---- common ---------------------------------------------------------------

@pytest.mark.parametrize("fn", ["rms_norm", "split_heads", "merge_heads", "repeat_kv"])
def test_common(fn):
    x3 = rnd(2, 5, 32, seed=1)
    x4 = rnd(2, 3, 5, 8, seed=2)
    if fn == "rms_norm":
        scale = rnd(32, seed=3)
        close(tc.rms_norm(T(x3), T(scale), 1e-6), jc.rms_norm(x3, scale, 1e-6))
    elif fn == "split_heads":
        close(tc.split_heads(T(x3), 8), jc.split_heads(x3, 8))
    elif fn == "merge_heads":
        close(tc.merge_heads(T(x4)), jc.merge_heads(x4))
    else:
        for groups in (1, 2, 3):
            close(tc.repeat_kv(T(x4), groups), jc.repeat_kv(x4, groups))


@pytest.mark.parametrize("n,mult", [(0, 8), (7, 8), (8, 8), (33, 16)])
def test_rounding_and_mask_value(n, mult):
    assert tc.round_up_mult(n, mult) == jc.round_up_mult(n, mult)
    assert tc.round_down_mult(n, mult) == jc.round_down_mult(n, mult)
    assert tc.mask_value(torch.float32) == jc.mask_value(jnp.float32)
    assert tc.mask_value(torch.bfloat16) == jc.mask_value(jnp.bfloat16)


# ---- rotary ---------------------------------------------------------------

@pytest.mark.parametrize("offset", [0, 5, 1000])
def test_rotary(offset):
    q = rnd(2, 4, 6, 16, seed=4)
    k = rnd(2, 2, 6, 16, seed=5)
    close(tr.rope_frequencies(16, 500.0), jr.rope_frequencies(16, 500.0))
    pos = np.arange(6) + offset
    close(tr.apply_rotary(T(q), T(pos)), jr.apply_rotary(q, jnp.asarray(pos)), atol=1e-4)
    close(tr.rotate_at_offset(T(q), offset), jr.rotate_at_offset(q, offset), atol=1e-4)
    for t_out, j_out in zip(tr.rotate_qk(T(q), T(k)), jr.rotate_qk(q, k)):
        close(t_out, j_out)


# ---- compress -------------------------------------------------------------

@pytest.mark.parametrize("n,block,stride", [(16, 4, 2), (24, 8, 4), (12, 4, 4), (8, 16, 8)])
def test_split_compress_windows(n, block, stride):
    kv = rnd(2, 3, n, 5, seed=6)
    close(tcomp.split_compress_windows(T(kv), block, stride),
          jcomp.split_compress_windows(jnp.asarray(kv), block, stride))


def test_mlp_compressor_and_unported_kinds():
    import jax

    nsa = NSAConfig(compress_block_size=4, compress_block_sliding_stride=2)
    params = jcomp.init_compressor(jax.random.PRNGKey(0), nsa, 2, 8)
    kv = rnd(2, 2, 5, 4, 8, seed=7)
    got = tcomp.apply_compressor({k: T(v) for k, v in params.items()}, "mlp", T(kv))
    close(got, jcomp.apply_compressor(params, "mlp", jnp.asarray(kv)), atol=2e-5)
    # every kind of nsa_tpu is ported (tests/test_torch_compressors.py); an
    # unknown one raises
    with pytest.raises(ValueError, match="unknown compressor"):
        tcomp.apply_compressor({}, "bogus", T(kv))


# ---- selection ------------------------------------------------------------

@pytest.mark.parametrize("share,g", [(True, 2), (True, 1), (False, 2)])
def test_group_importance(share, g):
    csim = rnd(2, 4, 3, 9, seed=8)
    close(ts.group_importance(T(csim), 1, g, share), js.group_importance(csim, 1, g, share))


@pytest.mark.parametrize("w,sel_block,stride", [(12, 4, 2), (13, 8, 2), (6, 4, 4), (1, 4, 2)])
def test_fine_block_scores(w, sel_block, stride):
    imp = rnd(2, 2, 5, w, seed=9, scale=3.0)
    pos = np.array([0, 3, 7, 12, 25])
    close(ts.fine_block_scores(T(imp), T(pos), sel_block, stride),
          js.fine_block_scores(jnp.asarray(imp), jnp.asarray(pos), sel_block, stride))


def test_iterative_top_k_ties_lowest_index():
    scores = np.array([[0.1, 0.5, 0.5, 0.0, 0.5, 0.0]], np.float32)
    tv, ti = ts.iterative_top_k(T(scores), 4)
    jv, ji = js.iterative_top_k(jnp.asarray(scores), 4)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ti.numpy(), [[1, 2, 4, 0]])
    close(tv, jv)


@pytest.mark.parametrize("num_sel,diff", [(3, True), (3, False), (0, True), (8, False)])
def test_select_blocks(num_sel, diff):
    scores = np.abs(rnd(2, 2, 4, 6, seed=10)) * 1e-3
    scores[..., 0] = 0.0   # an invalid block (score <= 1e-10)
    t_sel = ts.select_blocks(T(scores), num_sel, diff)
    j_sel = js.select_blocks(jnp.asarray(scores), num_sel, diff)
    assert t_sel.indices.dtype == torch.int32
    np.testing.assert_array_equal(t_sel.indices.numpy(), np.asarray(j_sel.indices))
    np.testing.assert_array_equal(t_sel.mask.numpy(), np.asarray(j_sel.mask))
    close(t_sel.scores, j_sel.scores)
    assert (t_sel.gates is None) == (j_sel.gates is None)
    if diff:
        close(t_sel.gates, j_sel.gates)


# ---- attention ------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_attend(masked):
    q, k, v = rnd(2, 4, 5, 8, seed=11), rnd(2, 2, 7, 8, seed=12), rnd(2, 2, 7, 8, seed=13)
    mask = (np.arange(5)[:, None] + 2 >= np.arange(7)[None, :]) if masked else None
    t_out, t_sim = ta.attend(T(q), T(k), T(v), mask=None if mask is None else T(mask),
                             scale=0.3, return_sim=True)
    j_out, j_sim = ja.attend(q, k, v, mask=mask, scale=0.3, return_sim=True)
    close(t_out, j_out)
    close(t_sim, j_sim)


@pytest.mark.parametrize("n,window,causal", [(5, 8, True), (20, 8, True), (33, 4, True),
                                             (20, 6, False)])
def test_sliding_window_attention(n, window, causal):
    q, k, v = rnd(1, 4, n, 8, seed=14), rnd(1, 2, n, 8, seed=15), rnd(1, 2, n, 8, seed=16)
    close(ta.sliding_window_attention(T(q), T(k), T(v), window, causal=causal),
          ja.sliding_window_attention(q, k, v, window, causal=causal))


@pytest.mark.parametrize("Hs", [2, 4])
def test_blockify_and_gather(Hs):
    k, v = rnd(2, 2, 13, 8, seed=17), rnd(2, 2, 13, 8, seed=18)
    for t_b, j_b in zip(ta.blockify_kv(T(k), T(v), 4, Hs), ja.blockify_kv(k, v, 4, Hs)):
        close(t_b, j_b)
    blocks = rnd(2, Hs, 4, 4, 8, seed=19)
    idx = np.random.RandomState(20).randint(0, 4, (2, Hs, 5, 3)).astype(np.int32)
    close(ta.gather_blocks(T(blocks), T(idx)), ja.gather_blocks(blocks, jnp.asarray(idx)))


@pytest.mark.parametrize("causal,gated", [(True, False), (True, True), (False, False)])
def test_fine_attend_core(causal, gated):
    b, h, Hs, n, d, B, S = 2, 4, 2, 12, 8, 4, 2
    q, k, v = rnd(b, h, n, d, seed=21), rnd(b, Hs, n, d, seed=22), rnd(b, Hs, n, d, seed=23)
    rs = np.random.RandomState(24)
    q_blk = np.arange(n) // B
    idx = (rs.randint(0, 1 << 20, (b, Hs, n, S)) % np.maximum(q_blk, 1)[:, None]).astype(np.int32)
    msk = (rs.rand(b, Hs, n, S) < 0.8) & (q_blk > 0)[:, None]
    gates = (1.0 + rs.rand(b, Hs, n, S) * 0.1).astype(np.float32) if gated else None
    kb, vb = ja.blockify_kv(k, v, B, Hs)
    pos = np.arange(n)
    want = ja.fine_attend_core(q, kb, vb, jnp.asarray(idx), jnp.asarray(msk),
                               None if gates is None else jnp.asarray(gates),
                               jnp.asarray(pos), causal, 0.35)
    got = ta.fine_attend_core(T(q), T(kb), T(vb), T(idx), T(msk),
                              None if gates is None else T(gates), T(pos), causal, 0.35)
    close(got, want)
