"""The gates that hold the ragged and paged attend kernels (rows 9 and 10)
to their plain versions on the card, and the control each must reject.

* The combined attention output the kernels hand to the output projection
  (``attn_out``), element by element within ``attend_tolerance``: 2^-7 of
  |plain| plus 2^-15 of the same combine over absolute values.  One
  computed as the kernel computes it (float32 logits, unnormalised softmax
  weights and sums, the row sum's inverse after P.V, the gate combine, one
  rounding to bf16) must pass, and so must one a bf16 ulp off; one with
  each row's first selected block left out (``without_first_selected``)
  must fail.
* The layer output, within 2^-6 of its largest value (``TOL_FUSED`` of
  ``chip_smoke.py``): the same dropped-block control must fail it too.

CPU only, seeded numpy inputs at the tiny test configuration's widths
(dim_head 16, G 2, select 2 blocks of 4, window 8) at mixed positions; the
same controls run on the card in ``chip_smoke.py`` at the engine's cell.
"""

import numpy as np
import pytest
import torch

from nsa_tpu_torch.ops.cuda import nsa_decode
from nsa_tpu_torch.ops.cuda import nsa_decode_ragged as t_ragged
from nsa_tpu_torch.ops.nsa import _ckv_width

KVH, G, D, DIM, FF_HID = 2, 2, 16, 64, 256
STRIDE, SEL_BLOCK, WINDOW, NUM_SEL, MAX_LEN = 2, 4, 8, 2, 64
N_SLIDE = -(-WINDOW // SEL_BLOCK) + 1
WC = _ckv_width(MAX_LEN, STRIDE, SEL_BLOCK // STRIDE)
SCALE = 0.25
ATTEND_KW = dict(sel_block=SEL_BLOCK, window=WINDOW, num_sel=NUM_SEL, n_slide=N_SLIDE,
                 scale=SCALE)
POSITIONS = [0, 3, 17, 30, 41, 52, 62, 63]
TOL_FUSED = 2.0 ** -6


def inputs(seed=0):
    rs = np.random.RandomState(seed)

    def bf16(*shape, scale=1.0):
        return torch.from_numpy((rs.randn(*shape) * scale).astype(np.float32)).to(torch.bfloat16)

    b = len(POSITIONS)
    t = torch.tensor(POSITIONS, dtype=torch.int32)
    q, ckv, mem_kv = bf16(b, KVH, G, D), bf16(b, KVH, WC, 2 * D), bf16(2, KVH, 1, D)
    c_out, info = nsa_decode.decode_select_plain(
        q, ckv, mem_kv, t, t // STRIDE, max_blocks=MAX_LEN // SEL_BLOCK, stride=STRIDE,
        sel_block=SEL_BLOCK, num_sel=NUM_SEL, n_slide=N_SLIDE, scale=SCALE,
        weights_dtype=torch.float32)
    gates = torch.sigmoid(bf16(b, KVH, G, 3).float()).to(torch.bfloat16)
    ff = (1.0 + 0.1 * torch.from_numpy(rs.randn(DIM).astype(np.float32)),
          bf16(DIM, FF_HID, scale=DIM ** -0.5),
          0.1 * torch.from_numpy(rs.randn(FF_HID).astype(np.float32)),
          bf16(FF_HID, DIM, scale=FF_HID ** -0.5),
          0.1 * torch.from_numpy(rs.randn(DIM).astype(np.float32)))
    return dict(rq=bf16(b, KVH, G, D), kv=bf16(b, KVH, MAX_LEN, 2 * D),
                kv_new=bf16(b, KVH, 1, 2 * D), info=info.reshape(b, -1), c_out=c_out,
                gates=gates, x=bf16(b, 1, DIM), w_out=bf16(KVH * G * D, DIM, scale=0.125),
                t=t), ff


def combined_like_the_kernel(rq, kv, info, c_out, gates, t):
    """attend_body's arithmetic in float32: the masks of
    ``attend_combined_plain``, exp(s - max) unnormalised, P.V summed, times
    the inverse row sum, the gate combine; then one rounding to bf16."""
    b = rq.shape[0]
    rows = info.reshape(b, KVH, -1)
    n_slots = NUM_SEL + N_SLIDE
    fkv = nsa_decode.gather_kv_blocks(kv, rows[..., :n_slots], SEL_BLOCK).float()
    fine, slide = [], []
    for i, ti in enumerate(t.tolist()):
        last = ti // SEL_BLOCK
        cols = torch.arange(n_slots * SEL_BLOCK)
        slot, within = cols // SEL_BLOCK, cols % SEL_BLOCK
        trail = last - (N_SLIDE - 1) + (slot - NUM_SEL)
        jg = trail * SEL_BLOCK + within
        trail_ok = (slot >= NUM_SEL) & (trail >= 0)
        sel_ok = (slot < NUM_SEL)[None] & (rows[i, :, n_slots:n_slots + NUM_SEL]
                                            .gather(1, slot.clamp(max=NUM_SEL - 1)[None]
                                                    .expand(KVH, -1)) != 0)
        fine.append(sel_ok | (trail_ok & (slot == n_slots - 1) & (jg <= ti))[None])
        slide.append((trail_ok & (jg >= ti - WINDOW) & (jg <= ti))[None].expand(KVH, -1))
    s = torch.einsum("bhgd,bhjd->bhgj", rq.float(), fkv[..., :D]) * SCALE

    def branch(mask):
        m = mask[:, :, None]
        z = s.masked_fill(~m, -1e30)
        p = torch.exp(z - z.amax(-1, keepdim=True)).masked_fill(~m, 0.0)
        acc = torch.einsum("bhgj,bhjd->bhgd", p, fkv[..., D:])
        return acc * (1.0 / p.sum(-1, keepdim=True).clamp_min(1e-30))

    g = gates.float()
    comb = g[..., 0:1] * c_out.float() + g[..., 1:2] * branch(torch.stack(fine)) \
        + g[..., 2:3] * branch(torch.stack(slide))
    return comb.to(torch.bfloat16)


def worst(got, want, tol):
    return ((got.float() - want.float()).abs() / tol).max().item()


def written(inp):
    """The cache with each row's new kv row at its t, as the kernels leave it."""
    kv = inp["kv"].clone()
    kv[torch.arange(kv.shape[0]), :, inp["t"].long()] = inp["kv_new"][:, :, 0]
    return kv


def test_attention_rounded_as_the_kernel_rounds_passes_the_rule():
    inp, _ = inputs()
    kv = written(inp)
    args = (inp["rq"], kv, inp["info"], inp["c_out"], inp["gates"], inp["t"])
    want, tol = t_ragged.attend_tolerance(*args, **ATTEND_KW)
    got = combined_like_the_kernel(*args)
    assert worst(got, want, tol) <= 1.0
    ulp_off = (want.view(torch.int16) + 1).view(torch.bfloat16)   # one ulp larger in magnitude
    assert worst(ulp_off, want, tol) <= 1.0


@pytest.mark.parametrize("paged", [False, True])
def test_the_wrappers_attention_output_is_the_plain_one(paged):
    """``attn_out`` on the CPU: the plain combined output rounded to bf16,
    also through a page table."""
    inp, ff = inputs()
    kv = written(inp)
    want, _ = t_ragged.attend_tolerance(inp["rq"], kv, inp["info"], inp["c_out"], inp["gates"],
                                        inp["t"], **ATTEND_KW)
    got = torch.empty_like(inp["rq"])
    rest = (inp["kv_new"], inp["info"], inp["c_out"], inp["gates"], inp["x"], inp["w_out"],
            inp["t"], ff)
    if paged:
        b, page = kv.shape[0], 8
        n_pg = MAX_LEN // page
        table = torch.from_numpy(np.random.RandomState(3).permutation(b * n_pg)
                                 .reshape(b, n_pg).astype(np.int32))
        pool = torch.zeros(b * n_pg + 1, KVH, page, 2 * D, dtype=torch.bfloat16)
        pool[table.reshape(-1).long()] = inp["kv"].reshape(b, KVH, n_pg, page, 2 * D) \
            .transpose(1, 2).reshape(-1, KVH, page, 2 * D)
        t_ragged.decode_attend_fused_paged(inp["rq"], pool, table, *rest, attn_out=got,
                                           **ATTEND_KW)
    else:
        t_ragged.decode_attend_fused_ragged(inp["rq"], inp["kv"].clone(), *rest, attn_out=got,
                                            **ATTEND_KW)
    assert torch.equal(got, want)


def test_a_dropped_block_fails_both_gates():
    inp, ff = inputs()
    kv = written(inp)
    dropped = t_ragged.without_first_selected(inp["info"], NUM_SEL, N_SLIDE)
    assert bool((dropped != inp["info"]).any())
    want, tol = t_ragged.attend_tolerance(inp["rq"], kv, inp["info"], inp["c_out"],
                                          inp["gates"], inp["t"], **ATTEND_KW)
    wrong, _ = t_ragged.attend_tolerance(inp["rq"], kv, dropped, inp["c_out"], inp["gates"],
                                         inp["t"], **ATTEND_KW)
    assert worst(wrong, want, tol) > 1.0

    rest = (inp["kv_new"], inp["c_out"], inp["gates"], inp["x"], inp["w_out"], inp["t"], ff)
    out = t_ragged.decode_attend_fused_ragged_plain(
        inp["rq"], inp["kv"].clone(), rest[0], inp["info"], *rest[1:], **ATTEND_KW)
    bad = t_ragged.decode_attend_fused_ragged_plain(
        inp["rq"], inp["kv"].clone(), rest[0], dropped, *rest[1:], **ATTEND_KW)
    top = out.float().abs().max().item()
    assert (bad.float() - out.float()).abs().max().item() > TOL_FUSED * top
