"""The rule that holds the prefill forward kernel (row 1) to its plain
version on the card, ``nsa_prefill.fine_sliding_tolerance``: both outputs
element by element within 2^-7 of the plain output plus 2^-8 of the same
branch's attention over |v|.

An output rounded as the CUDA kernel rounds it (float32 logits, running max
and row sums; the softmax weights rounded to bf16 for P.V; the output to
bf16) must pass it, and one with a selected block left out of every row
that has one must fail it.  CPU only, seeded numpy inputs at a small size;
the same control runs on the card in ``chip_smoke.py``.
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


def inputs(G, n, S, sel_block, seed=0):
    """bf16 rq, rk, v; selections of earlier blocks (duplicates allowed),
    90% valid."""
    rs = np.random.RandomState(seed)
    b, kvh, d = 2, 2, 64

    def bf16(*shape):
        return torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(torch.bfloat16)

    q_blk = np.arange(n) // sel_block
    sel_idx = rs.randint(0, 1 << 30, (b, kvh, n, S)) % np.maximum(q_blk, 1)[:, None]
    sel_mask = (rs.rand(b, kvh, n, S) < 0.9) & (q_blk > 0)[:, None]
    return (bf16(b, kvh * G, n, d), bf16(b, kvh, n, d), bf16(b, kvh, n, d),
            torch.from_numpy(sel_idx.astype(np.int32)), torch.from_numpy(sel_mask))


def attend_like_the_kernel(qg, k, v, ok, scale):
    """qg [b, kvh, G, m, d]; k, v [b, kvh, m, J, d]; ok broadcastable to
    [b, kvh, G, m, J] -> [b, kvh*G, m, d] bf16, with P rounded to bf16."""
    b, kvh, G, m, d = qg.shape
    sim = torch.einsum("bhgmd,bhmjd->bhgmj", qg.float(), k.float()) * scale
    sim = sim.masked_fill(~ok, -1e30)
    p = torch.exp(sim - sim.amax(-1, keepdim=True)).masked_fill(~ok, 0.0)
    out = torch.einsum("bhgmj,bhmjd->bhgmd", p.to(torch.bfloat16).float(), v.float())
    return (out / p.sum(-1, keepdim=True)).to(torch.bfloat16).reshape(b, kvh * G, m, d)


def kernel_numerics(rq, rk, v, sel_idx, sel_mask, sel_block, window, scale):
    """The fine and sliding outputs as the kernel rounds them."""
    b, h, n, d = rq.shape
    kvh = rk.shape[1]
    qg = rq.reshape(b, kvh, h // kvh, n, d)
    _, fpos, fok, bpos, bok = t_pre._row_keys(sel_idx, sel_mask, 0, n, n, sel_block, window)
    fo = attend_like_the_kernel(qg, t_pre._take(rk, fpos), t_pre._take(v, fpos),
                                fok[:, :, None], scale)
    so = attend_like_the_kernel(qg, rk[:, :, bpos], v[:, :, bpos], bok, scale)
    return fo, so


def worst(got, want, tols):
    return max(((x.float() - y.float()).abs() / t).max().item()
               for x, y, t in zip(got, want, tols))


@pytest.mark.parametrize("G,n,S,sel_block,window", CASES)
def test_kernel_rounding_passes_the_rule(G, n, S, sel_block, window):
    rq, rk, v, sel_idx, sel_mask = inputs(G, n, S, sel_block)
    args = (rq, rk, v, sel_idx, sel_mask, sel_block, window, SCALE)
    want = t_pre.fine_sliding_plain(*args)
    tols = t_pre.fine_sliding_tolerance(*args, want)
    got = kernel_numerics(*args)
    assert not torch.equal(got[0], want[0])      # the rounding does move the output
    assert worst(got, want[:2], tols) <= 1.0


@pytest.mark.parametrize("G,n,S,sel_block,window", CASES)
def test_a_dropped_block_fails_the_rule(G, n, S, sel_block, window):
    rq, rk, v, sel_idx, sel_mask = inputs(G, n, S, sel_block)
    args = (rq, rk, v, sel_idx, sel_mask, sel_block, window, SCALE)
    want = t_pre.fine_sliding_plain(*args)
    tols = t_pre.fine_sliding_tolerance(*args, want)
    dropped = t_pre.without_first_block(sel_idx, sel_mask, sel_block)
    assert bool((dropped != sel_mask).any())
    wrong = t_pre.fine_sliding_plain(rq, rk, v, sel_idx, dropped, sel_block, window, SCALE)
    assert worst(wrong[:1], want[:1], tols[:1]) > 1.0
