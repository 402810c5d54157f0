"""Decode-step kernels for the NSA branches
(``nsa_tpu/ops/pallas/nsa_decode.py``):

* ``decode_select`` — compressed attention (branch 1) over the packed
  ``ckv`` cache plus the mem slots, and the whole selection pipeline:
  grouped importance, stride -> selection-block regrouping, diagonal mask,
  pad-softmax-strip and iterative top-k.  Returns the branch-1 output and
  the packed ``info`` row (selected ids, trailing window ids, validity).
* ``decode_attend`` — fine and sliding attention over the selected and
  trailing blocks of the packed ``kv`` cache, two masked softmaxes sharing
  one q.K, and the gate combine with the branch-1 output.  The block gather
  that the JAX package leaves to XLA (``ops/nsa.py:830-832``) is part of
  this function: the kernel reads the rows through the info row's ids.

Each wrapper launches its CUDA kernel (``csrc/nsa_decode.cu``) for CUDA
tensors and runs the plain PyTorch version beside it for CPU tensors.  The
plain versions follow the JAX package's XLA decode path
(``_decode_compressed`` / ``_decode_fine_sliding``, ``ops/nsa.py:870-996``).
They also take the position ``t`` (and ``num_cb``) as a [b] tensor, one
position per row, for the ragged decode kernels' plain versions
(``nsa_decode_ragged.py``); the kernels here take one position, an int or
a 0-d int32 tensor on the device, which they read from device memory (so a
captured decode step replays them at each step's position).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from ..attention import gather_blocks
from ..common import mask_value
from ..selection import fine_block_scores, group_importance, select_blocks
from . import runtime

INFO_WIDTH = 128   # packed info row: [0,S) ids | [S,S+ns) trailing | [S+ns,2S+ns) valid


def per_row(t):
    """A position as it broadcasts against a trailing axis: an int or a 0-d
    tensor (one position) itself, a [b, ...] tensor with one more axis."""
    return t[:, None] if isinstance(t, torch.Tensor) and t.dim() >= 1 else t


def write_row(cache: torch.Tensor, t, row: torch.Tensor) -> None:
    """``cache[:, :, t] = row`` in place: cache [b, kvh, L, 2d], row [b, kvh,
    2d], t an int or a 0-d tensor on the cache's device (written without a
    host sync)."""
    if isinstance(t, torch.Tensor):
        cache.index_copy_(2, t.long().reshape(1), row[:, :, None].to(cache.dtype))
    else:
        cache[:, :, t] = row.to(cache.dtype)


def trailing_blocks(t, sel_block: int, n_slide: int, device) -> torch.Tensor:
    """Ids of the n_slide blocks ending at the query's own block, ascending
    and unclipped (negative before the sequence start): [n_slide] for an
    int t, [b, n_slide] for a [b] tensor."""
    return per_row(t) // sel_block - torch.arange(n_slide - 1, -1, -1, device=device)


def gather_kv_blocks(kv, idx, sel_block: int, page_table=None) -> torch.Tensor:
    """The blocks ``idx`` [b, kvh, S] of the packed cache, [b, kvh, S * Bs,
    2d]: from a dense cache kv [b, kvh, max_len, 2d], or, with
    ``page_table`` [b, max_pages], from a page pool kv [P, kvh, PAGE, 2d]
    where logical row r of batch row i lives in page ``page_table[i, r //
    PAGE]`` at row ``r % PAGE`` (block ids clamped to the table's reach, as
    the paged TPU kernel does)."""
    b, kvh, S = idx.shape
    Bs, d2 = sel_block, kv.shape[-1]
    if page_table is None:
        kvb = kv.reshape(b, kvh, kv.shape[2] // Bs, Bs, d2)
        return gather_blocks(kvb, idx[:, :, None])[:, :, 0].reshape(b, kvh, S * Bs, d2)
    page = kv.shape[2]
    start = idx.long().clamp(max=page_table.shape[1] * page // Bs - 1) * Bs   # [b, kvh, S]
    pages = page_table.long().gather(1, (start // page).reshape(b, kvh * S)).reshape(b, kvh, S)
    rows = (start % page)[..., None] + torch.arange(Bs, device=kv.device)     # [b, kvh, S, Bs]
    heads = torch.arange(kvh, device=kv.device)[None, :, None, None]
    return kv[pages[..., None], heads, rows].reshape(b, kvh, S * Bs, d2)


def compressed_attention_plain(q, ckv, mem_kv, num_cb, *, scale: float, weights_dtype=None):
    """Branch 1 at one position per row over the live compressed rows and
    the mem slots (JAX's ``_decode_compressed``, ``nsa_tpu/ops/nsa.py``).

    q [b, kvh, g, d]; ckv [b, kvh, Wc, 2d]; mem_kv [2, kvh, M, d]; num_cb
    the live rows, an int or a 0-d or [b] tensor -> (c_out [b, kvh, g, d],
    csim [b, kvh, g, M + Wc] the masked, scaled float32 logits).  The
    softmax weights are rounded to ``weights_dtype`` before P.V: q's dtype
    by default (the XLA decode path), float32 for the fused kernels.
    ``mem_kv`` is used in its own dtype: the callers cast it to q's, except
    the whole-model decode, which keeps it in float32 as JAX's megakernel
    does."""
    b, kvh, g, d = q.shape
    wd = q.dtype if weights_dtype is None else weights_dtype
    Wc = ckv.shape[2]
    M = mem_kv.shape[2]
    mem_k, mem_v = mem_kv[0], mem_kv[1]
    qf = q.float()
    csim_mem = torch.einsum("bhgd,hmd->bhgm", qf, mem_k.float()) * scale
    csim_blocks = torch.einsum("bhgd,bhjd->bhgj", qf, ckv[..., :d].float()) * scale
    live = torch.arange(Wc, device=q.device) < per_row(num_cb)        # [Wc] | [b, Wc]
    csim_blocks = csim_blocks.masked_fill(~live.reshape(-1, 1, 1, Wc),
                                          mask_value(torch.float32))
    csim = torch.cat([csim_mem, csim_blocks], dim=-1)              # [b,kvh,g,M+Wc]
    cattn = torch.softmax(csim, dim=-1).to(wd)
    cv_all = torch.cat([mem_v[None].expand(b, kvh, M, d).to(wd), ckv[..., d:].to(wd)], dim=2)
    c_out = torch.einsum("bhgj,bhjd->bhgd", cattn, cv_all).to(q.dtype)
    return c_out, csim


def select_scores_plain(q, ckv, mem_kv, num_cb, t, *, stride: int,
                        sel_block: int, scale: float, weights_dtype=None):
    """Branch 1 and the normalized fine-block scores of the KV heads'
    shared selection.

    q [b, kvh, g, d]; ckv [b, kvh, Wc, 2d]; mem_kv [2, kvh, M, d] ->
    (c_out [b, kvh, g, d], scores [b, kvh, Wc // npf] float32);
    ``weights_dtype`` and ``mem_kv`` as in ``compressed_attention_plain``.
    """
    b, kvh, g, _ = q.shape
    c_out, csim = compressed_attention_plain(q, ckv, mem_kv, num_cb, scale=scale,
                                             weights_dtype=weights_dtype)
    importance = group_importance(csim.reshape(b, kvh * g, 1, -1), mem_kv.shape[2], g, True)
    q_pos = torch.as_tensor(t, device=q.device).reshape(-1, 1)        # [1 | b, 1]
    scores = fine_block_scores(importance, q_pos, sel_block, stride)
    return c_out, scores[:, :, 0]


def decode_select_plain(q, ckv, mem_kv, t, num_cb, *, max_blocks: int,
                        stride: int, sel_block: int, num_sel: int, n_slide: int,
                        scale: float, weights_dtype=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of ``decode_select`` (``weights_dtype`` as
    in ``select_scores_plain``)."""
    b, kvh = q.shape[:2]
    c_out, scores = select_scores_plain(
        q, ckv, mem_kv, num_cb, t, stride=stride, sel_block=sel_block, scale=scale,
        weights_dtype=weights_dtype,
    )
    sel = select_blocks(scores, num_sel, use_diff_topk=False)
    S = sel.indices.shape[-1]
    n_slots = num_sel + n_slide
    info = torch.zeros((b, kvh, INFO_WIDTH), dtype=torch.int32, device=q.device)
    info[..., :S] = sel.indices
    trail = trailing_blocks(t, sel_block, n_slide, q.device).clamp(0, max_blocks - 1)
    info[..., num_sel:n_slots] = trail.to(torch.int32).unsqueeze(-2)
    info[..., n_slots:n_slots + S] = sel.mask.to(torch.int32)
    return c_out, info


def selection_faults(info_k, info_p, scores, *, num_sel: int, n_slide: int,
                     tie: float) -> Tuple[list, int]:
    """How a selection's info rows [..., INFO_WIDTH] depart from the plain
    version's on the same scores [..., blocks]: trailing ids unequal, a
    selected id that differs where the two ids' scores are more than ``tie``
    apart, validity unequal on rows whose ids agree.  Returns (the faults
    found, empty when none; the rows whose ids differ only by ties)."""
    n_slots = num_sel + n_slide
    faults = []
    if not torch.equal(info_k[..., num_sel:n_slots], info_p[..., num_sel:n_slots]):
        faults.append("trailing ids disagree")
    ids_k, ids_p = info_k[..., :num_sel].long(), info_p[..., :num_sel].long()
    gap = (scores.gather(-1, ids_k) - scores.gather(-1, ids_p)).abs()
    differ = ids_k != ids_p
    if not bool((gap[differ] <= tie).all()):
        faults.append(f"{int((gap[differ] > tie).sum())} selected ids are not ties")
    same_rows = ~differ.any(-1)
    v0 = n_slots
    if not torch.equal(info_k[..., v0:v0 + num_sel][same_rows],
                       info_p[..., v0:v0 + num_sel][same_rows]):
        faults.append("validity disagrees")
    return faults, int(differ.any(-1).sum())


def with_next_ranked(info, scores, num_sel: int) -> torch.Tensor:
    """info rows [..., INFO_WIDTH] with each row's lowest-scoring selected id
    replaced by the best-scoring block it left out: the selections of a
    kernel one rank short.  The control a selection gate must fail."""
    info = info.clone()
    ids = info[..., :num_sel].long()
    picked = scores.gather(-1, ids)
    left = scores.scatter(-1, ids, float("-inf"))
    worst = picked.argmin(-1, keepdim=True)
    info[..., :num_sel] = ids.scatter(-1, worst, left.argmax(-1, keepdim=True)).to(info.dtype)
    return info


def decode_select(q, ckv, mem_kv, t, num_cb, *, max_blocks: int,
                  stride: int, sel_block: int, num_sel: int, n_slide: int,
                  scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [b, kvh, g, d] UNROTATED queries; ckv [b, kvh, Wc, 2d]; mem_kv
    [2, kvh, M, d]; t the query position (an int, or a 0-d int32 tensor on
    q's device); num_cb = t // stride the live compressed rows (the plain
    version's; the kernel derives it from t).  Returns (c_out [b, kvh, g,
    d], info [b, kvh, INFO_WIDTH] int32)."""
    kw = dict(max_blocks=max_blocks, stride=stride, sel_block=sel_block,
              num_sel=num_sel, n_slide=n_slide, scale=scale)
    if runtime.on_cpu(q, ckv, mem_kv):
        return decode_select_plain(q, ckv, mem_kv, t, num_cb, **kw)
    b, kvh, g, d = q.shape
    Wc = ckv.shape[2]
    M = mem_kv.shape[2]
    npf = sel_block // stride
    if d != 64 or g not in (1, 2, 4, 8) or npf < 2 or Wc % npf \
            or 2 * num_sel + n_slide > INFO_WIDTH:
        raise ValueError(f"decode_select kernel takes dim_head 64, g in 1/2/4/8 "
                         f"and sel_block/stride >= 2 dividing the ckv width; got "
                         f"d={d}, g={g}, npf={npf}, Wc={Wc}")
    bf = torch.bfloat16
    ptrs = [
        runtime.check("q", q, bf, (b, kvh, g, d)),
        runtime.check("ckv", ckv, bf, (b, kvh, Wc, 2 * d)),
        runtime.check("mem_kv", mem_kv, bf, (2, kvh, M, d)),
    ]
    pos = runtime.device_position(t, q)
    c_out = torch.empty_like(q)
    info = torch.empty((b, kvh, INFO_WIDTH), dtype=torch.int32, device=q.device)
    with torch.cuda.device(q.device):
        runtime.library().call(
            "nsa_decode_select", *ptrs, c_out.data_ptr(), info.data_ptr(), pos.data_ptr(),
            b, kvh, g, Wc, M, stride, sel_block, num_sel, n_slide,
            max_blocks, INFO_WIDTH, scale, runtime.stream_of(q),
        )
    decode_select.launches += 1
    return c_out, info


decode_select.launches = 0


def attend_combined_plain(rq, kv, info, c_out, gates, t, *, sel_block: int,
                          window: int, num_sel: int, n_slide: int, scale: float,
                          weights_dtype=None, page_table=None) -> torch.Tensor:
    """The block gather, the fine and sliding masked softmaxes, and the gate
    combine, returned in float32 [b, kvh, g, d].  The softmax weights and
    each branch's P.V are rounded to ``weights_dtype``: rq's dtype by
    default (the XLA decode path), float32 for the fused kernels.  With
    ``page_table`` kv is a page pool (see ``gather_kv_blocks``)."""
    b, kvh, g, d = rq.shape
    wd = rq.dtype if weights_dtype is None else weights_dtype
    Bs = sel_block
    n_slots = num_sel + n_slide
    fkv = gather_kv_blocks(kv, info[..., :n_slots], Bs, page_table)

    trail = trailing_blocks(t, Bs, n_slide, rq.device)                  # [ns] | [b, ns]
    j_trail = trail[..., None] * Bs + torch.arange(Bs, device=rq.device)   # [(b,) ns, Bs]
    trail_ok = (trail >= 0)[..., None]
    tt = per_row(per_row(t))
    diag_only = torch.zeros((n_slide, 1), dtype=torch.bool, device=rq.device)
    diag_only[-1] = True
    fine_trail = diag_only & (j_trail <= tt) & trail_ok
    slide_trail = (j_trail >= tt - window) & (j_trail <= tt) & trail_ok

    def heads(m):       # [(b,) ns, Bs] -> [b, kvh, ns, Bs]
        return m.reshape(-1, 1, n_slide, Bs).expand(b, kvh, n_slide, Bs)

    sel_ok = info[..., n_slots:n_slots + num_sel].bool()[..., None].expand(b, kvh, num_sel, Bs)
    fine_mask = torch.cat([sel_ok, heads(fine_trail)], dim=2).reshape(b, kvh, 1, n_slots * Bs)
    slide_mask = torch.cat([torch.zeros_like(sel_ok), heads(slide_trail)], dim=2
                           ).reshape(b, kvh, 1, n_slots * Bs)

    sim = torch.einsum("bhgd,bhjd->bhgj", rq.float(), fkv[..., :d].float()) * scale
    fv = fkv[..., d:]

    def masked_out(mask):
        s = sim.masked_fill(~mask, mask_value(torch.float32))
        attn = torch.softmax(s, dim=-1).to(wd)
        return torch.einsum("bhgj,bhjd->bhgd", attn, fv.to(wd)).float()

    stacked = torch.stack([c_out.float(), masked_out(fine_mask), masked_out(slide_mask)], dim=-1)
    return torch.einsum("bhgs,bhgds->bhgd", gates.to(rq.dtype).float(), stacked)


def decode_attend_plain(rq, kv, info, c_out, gates, t, *, sel_block: int,
                        window: int, num_sel: int, n_slide: int,
                        scale: float) -> torch.Tensor:
    """The plain PyTorch version of ``decode_attend``: the block gather, the
    fine and sliding masked softmaxes, and the gate combine."""
    return attend_combined_plain(rq, kv, info, c_out, gates, t, sel_block=sel_block,
                                 window=window, num_sel=num_sel, n_slide=n_slide,
                                 scale=scale).to(rq.dtype)


def decode_attend(rq, kv, info, c_out, gates, t, *, sel_block: int,
                  window: int, num_sel: int, n_slide: int, scale: float) -> torch.Tensor:
    """rq [b, kvh, g, d] rotated queries; kv [b, kvh, max_len, 2d] packed
    k||v cache holding the row at position t (an int, or a 0-d int32 tensor
    on rq's device); info [b, kvh, INFO_WIDTH]
    from ``decode_select``; c_out [b, kvh, g, d]; gates [b, kvh, g, 3]
    (compressed, fine, sliding).  Returns the combined output [b, kvh, g, d]."""
    kw = dict(sel_block=sel_block, window=window, num_sel=num_sel,
              n_slide=n_slide, scale=scale)
    if runtime.on_cpu(rq, kv, info, c_out, gates):
        return decode_attend_plain(rq, kv, info, c_out, gates, t, **kw)
    b, kvh, g, d = rq.shape
    max_len = kv.shape[2]
    if d != 64 or g not in (1, 2, 4, 8) or max_len % sel_block:
        raise ValueError(f"decode_attend kernel takes dim_head 64, g in 1/2/4/8 and "
                         f"a cache length divisible by sel_block; got d={d}, g={g}, "
                         f"max_len={max_len}")
    bf = torch.bfloat16
    ptrs = [
        runtime.check("rq", rq, bf, (b, kvh, g, d)),
        runtime.check("kv", kv, bf, (b, kvh, max_len, 2 * d)),
        runtime.check("info", info, torch.int32, (b, kvh, INFO_WIDTH)),
        runtime.check("c_out", c_out, bf, (b, kvh, g, d)),
        runtime.check("gates", gates, bf, (b, kvh, g, 3)),
    ]
    pos = runtime.device_position(t, rq)
    out = torch.empty_like(rq)
    with torch.cuda.device(rq.device):
        runtime.library().call(
            "nsa_decode_attend", *ptrs, out.data_ptr(), pos.data_ptr(), b, kvh, g, max_len,
            sel_block, window, num_sel, n_slide, INFO_WIDTH, scale,
            runtime.stream_of(rq),
        )
    decode_attend.launches += 1
    return out


decode_attend.launches = 0

SPLIT_PLAN_KEYS = ("select_smem_bytes", "select_blocks_per_sm", "attend_smem_bytes",
                   "attend_blocks_per_sm", "smem_optin")


@functools.lru_cache(maxsize=None)
def _split_plan(device: int, g: int, Wc: int, M: int, Wf: int, J: int) -> dict:
    out = (ctypes.c_int * len(SPLIT_PLAN_KEYS))()
    with torch.cuda.device(device):
        runtime.library().call("nsa_decode_split_plan", g, Wc, M, Wf, J, ctypes.addressof(out))
    return dict(zip(SPLIT_PLAN_KEYS, out))


def split_plan(q, ckv, mem_kv, *, stride: int, sel_block: int, num_sel: int,
               n_slide: int) -> dict:
    """The launch geometry of ``decode_select`` and ``decode_attend`` on
    q's card at these operands' widths: each kernel's dynamic shared memory
    a block and blocks that fit an SM, the card's opt-in limit a block, and
    the grid (one block per (batch row, KV head))."""
    b, kvh, g, _ = q.shape
    Wc = ckv.shape[2]
    plan = _split_plan(q.device.index or 0, g, Wc, mem_kv.shape[2], Wc // (sel_block // stride),
                       (num_sel + n_slide) * sel_block)
    return {"grid": b * kvh, **plan}
