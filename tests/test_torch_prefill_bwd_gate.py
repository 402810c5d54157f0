"""The rule that holds the prefill backward kernels (rows 4 and 5) to their
plain versions on the card, ``nsa_prefill.prefill_bwd_tolerance``: dq, dk
and dv element by element within 2^-7 of the plain value plus 2^-8 of the
same sum over absolute values.

A backward computed as the CUDA kernels' tensor-core products would give it
with dS and P rounded to bf16 (the kernels keep dS as a bf16 pair hi + lo,
closer still) must pass it, and the plain backward with a selected block
left out of every row that has one must fail it on dq and on dk or dv.
CPU only, seeded numpy inputs at a small size; the same control runs on the
card in ``chip_smoke.py`` and ``tests/test_torch_cuda_kernels.py``.
"""

import numpy as np
import pytest
import torch

from nsa_tpu_torch.ops.cuda import nsa_prefill as t_pre

CASES = [  # G, n, S, sel_block, window: the reference blocks, then the tiny config's
    pytest.param(2, 200, 4, 16, 64, id="reference"),
    pytest.param(2, 96, 2, 4, 8, id="tiny"),
]
SCALE = 0.125


def inputs(G, n, S, sel_block, window, seed=0):
    """bf16 rq, rk, v; selections of earlier blocks (duplicates allowed),
    90% valid; the plain forward's LSEs and outputs; seeded bf16
    cotangents; the plain deltas."""
    rs = np.random.RandomState(seed)
    b, kvh, d = 2, 2, 64

    def bf16(*shape):
        return torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(torch.bfloat16)

    q_blk = np.arange(n) // sel_block
    sel_idx = rs.randint(0, 1 << 30, (b, kvh, n, S)) % np.maximum(q_blk, 1)[:, None]
    sel_mask = (rs.rand(b, kvh, n, S) < 0.9) & (q_blk > 0)[:, None]
    sel = (bf16(b, kvh * G, n, d), bf16(b, kvh, n, d), bf16(b, kvh, n, d),
           torch.from_numpy(sel_idx.astype(np.int32)), torch.from_numpy(sel_mask))
    fo, so, flse, slse = t_pre.fine_sliding_plain(*sel, sel_block, window, SCALE)
    dfo, dso = bf16(b, kvh * G, n, d), bf16(b, kvh * G, n, d)
    fdel = (fo.float() * dfo.float()).sum(-1)
    sdel = (so.float() * dso.float()).sum(-1)
    return sel, (flse, slse, fdel, sdel, dfo, dso)


def bf16_round(x):
    return x.to(torch.bfloat16).float()


def kernel_numerics(rq, rk, v, sel_idx, sel_mask, flse, slse, fdel, sdel, dfo, dso,
                    sel_block, window, scale):
    """dq, dk, dv with dS and P rounded to bf16 before the products that
    take them (dQ = dS.K, dK = dS^T.Q, dV = P^T.dO), sums in float32, the
    outputs rounded to bf16."""
    b, h, n, d = rq.shape
    kvh = rk.shape[1]
    dk = torch.zeros((b * kvh * n, d))
    dv = torch.zeros_like(dk)
    base = (torch.arange(b * kvh) * n).reshape(b, kvh, 1, 1)
    dqs = []
    for c0, c1, _, qs, dfo_c, dso_c, fine, band in t_pre._bwd_chunks(
            rq, rk, v, sel_idx, sel_mask, flse, slse, fdel, sdel, dfo, dso,
            sel_block, window, scale, 128):
        fpos, pf, dsf, _ = fine
        bpos, ps, dss = band
        dq = torch.einsum("bhgmj,bhmjd->bhgmd", bf16_round(dsf), t_pre._take(rk, fpos).float())
        dq = dq + torch.einsum("bhgmj,bhmjd->bhgmd", bf16_round(dss), rk[:, :, bpos].float())
        dqs.append((dq * scale).reshape(b, h, c1 - c0, d))
        for pos, p, ds, do in ((fpos, pf, dsf, dfo_c), (bpos, ps, dss, dso_c)):
            pos = (base + pos.expand(b, kvh, *pos.shape[-2:])).flatten()
            dk.index_add_(0, pos, torch.einsum("bhgmj,bhgmd->bhmjd", bf16_round(ds),
                                               qs).reshape(-1, d))
            dv.index_add_(0, pos, torch.einsum("bhgmj,bhgmd->bhmjd", bf16_round(p),
                                               do.float()).reshape(-1, d))
    return (torch.cat(dqs, dim=2).to(torch.bfloat16),
            dk.reshape(b, kvh, n, d).to(torch.bfloat16),
            dv.reshape(b, kvh, n, d).to(torch.bfloat16))


def plain(sel, terms, sel_block, window, mask=None):
    rq, rk, v, sel_idx, sel_mask = sel
    flse, slse, fdel, sdel, dfo, dso = terms
    mask = sel_mask if mask is None else mask
    dq = t_pre.prefill_bwd_dq_plain(rq, rk, v, sel_idx, mask, *t_pre.fine_sliding_plain(
        rq, rk, v, sel_idx, sel_mask, sel_block, window, SCALE), dfo, dso, sel_block, window,
        SCALE)[0]
    dk, dv = t_pre.prefill_bwd_dkv_plain(rq, rk, v, sel_idx, mask, flse, slse, fdel, sdel,
                                         dfo, dso, sel_block, window, SCALE)
    return dq, dk, dv


def ratios(got, want, tols):
    return [((x.float() - y.float()).abs() / t).max().item() for x, y, t in zip(got, want, tols)]


@pytest.mark.parametrize("G,n,S,sel_block,window", CASES)
def test_kernel_rounding_passes_the_rule(G, n, S, sel_block, window):
    sel, terms = inputs(G, n, S, sel_block, window)
    want = plain(sel, terms, sel_block, window)
    tols = t_pre.prefill_bwd_tolerance(*sel, *terms, sel_block, window, SCALE, want)
    got = kernel_numerics(*sel, *terms, sel_block, window, SCALE)
    assert all(not torch.equal(x, y) for x, y in zip(got, want))   # the rounding moves each
    assert max(ratios(got, want, tols)) <= 1.0


@pytest.mark.parametrize("G,n,S,sel_block,window", CASES)
def test_a_dropped_block_fails_the_rule(G, n, S, sel_block, window):
    sel, terms = inputs(G, n, S, sel_block, window)
    want = plain(sel, terms, sel_block, window)
    tols = t_pre.prefill_bwd_tolerance(*sel, *terms, sel_block, window, SCALE, want)
    dropped = t_pre.without_first_block(sel[3], sel[4], sel_block)
    assert bool((dropped != sel[4]).any())
    r_dq, r_dk, r_dv = ratios(plain(sel, terms, sel_block, window, dropped), want, tols)
    assert r_dq > 1.0 and max(r_dk, r_dv) > 1.0
