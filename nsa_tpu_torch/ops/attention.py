"""Plain PyTorch attention primitives (``nsa_tpu/ops/attention.py``): the
oracles that the port's kernels are checked against, and the dense
attention of the full-attention baseline (``full_attention``, and
``full_attention_chunked``, which trains it, recomputing each query chunk
in the backward).

Logits are computed in float32 from the working-dtype inputs (the JAX
package's ``preferred_element_type=float32``); softmax weights are cast
back to the working dtype before the weighted sum, as there.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .common import mask_value, repeat_kv, round_up_mult


def attend(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    return_sim: bool = False,
):
    """Masked softmax attention with grouped-query support.

    q: [b, h, i, d]; k, v: [b, kvh, j, d]; ``mask`` broadcastable to
    [b, h, i, j] (True = attend).  Returns out [b, h, i, d] and, if asked,
    the masked, scaled float32 logits [b, h, i, j].
    """
    b, h, i, d = q.shape
    kvh = k.shape[1]
    g = h // kvh
    scale = d ** -0.5 if scale is None else scale
    qg = q.reshape(b, kvh, g, i, d)
    sim = torch.einsum("bhgid,bhjd->bhgij", qg.float(), k.float()) * scale
    if mask is not None:
        m = mask if mask.ndim == 2 else mask.reshape(b, kvh, g, i, -1)
        sim = sim.masked_fill(~m, mask_value(torch.float32))
    attn = torch.softmax(sim, dim=-1).to(q.dtype)
    out = torch.einsum("bhgij,bhjd->bhgid", attn, v).reshape(b, h, i, d)
    if not return_sim:
        return out
    return out, sim.reshape(b, h, i, -1)


def full_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Dense attention with GQA. q [b, h, i, d], k/v [b, kvh, j, d]; when
    causal, the queries are the LAST i positions of the j keys."""
    i, j = q.shape[-2], k.shape[-2]
    mask = None
    if causal and i > 1:
        qi = torch.arange(i, device=q.device) + (j - i)
        mask = qi[:, None] >= torch.arange(j, device=q.device)[None, :]
    return attend(q, k, v, mask=mask, scale=scale)


def attention_by_query_chunks(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    scale: Optional[float] = None,
    chunk: int = 256,
) -> torch.Tensor:
    """Dense GQA softmax attention in the flash kernel's numerics, ``chunk``
    query rows at a time (causal: against the keys up to the chunk's last
    row only), so the logits never exceed [b, h, chunk, n_k].  Query row r
    sits at key position r (the FIRST keys).  q is scaled in float32 before
    the dot, logits are float32, masked columns get exactly zero weight, the
    float32 weights are kept through P.V and the row sum is clamped at
    1e-30; the output is in q's dtype."""
    b, h, n, d = q.shape
    kvh, n_k = k.shape[1], k.shape[2]
    g = h // kvh
    scale = d ** -0.5 if scale is None else scale
    out = torch.empty_like(q)
    for c0 in range(0, n, chunk):
        c1 = min(n, c0 + chunk)
        k_end = min(n_k, c1) if causal else n_k
        qc = (q[:, :, c0:c1].float() * scale).reshape(b, kvh, g, c1 - c0, d)
        s = torch.einsum("bhgid,bhjd->bhgij", qc, k[:, :, :k_end].float())
        valid = None
        if causal:
            valid = (torch.arange(c0, c1, device=q.device)[:, None]
                     >= torch.arange(k_end, device=q.device)[None, :])
            s = s.masked_fill(~valid, -1e30)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        if valid is not None:
            p = p.masked_fill(~valid, 0.0)
        o = torch.einsum("bhgij,bhjd->bhgid", p, v[:, :, :k_end].float())
        o = o / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        out[:, :, c0:c1] = o.reshape(b, h, c1 - c0, d).to(q.dtype)
    return out


def _causal_chunk_attend(qc, kc, vc, first_row: int, causal: bool, scale: Optional[float]):
    """``attend`` for query rows at positions ``first_row ..`` of the keys."""
    mask = None
    if causal:
        rows = torch.arange(first_row, first_row + qc.shape[2], device=qc.device)
        mask = rows[:, None] >= torch.arange(kc.shape[2], device=qc.device)[None, :]
    return attend(qc, kc, vc, mask=mask, scale=scale)


def full_attention_chunked(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    scale: Optional[float] = None,
    chunk: int = 256,
) -> torch.Tensor:
    """Dense attention evaluated per query chunk (exact, memory-bounded), the
    full model's training attention, in JAX's numerics: ``full_attention``
    up to ``chunk`` queries; above, ``attend`` on each chunk of ``chunk``
    query rows (softmax weights in the input dtype before P.V), query row r
    at key position r (q and k of one length), against the keys up to the
    chunk's last row when causal: the only ones JAX's mask keeps.

    Each chunk runs under ``torch.utils.checkpoint``, JAX's
    ``jax.checkpoint`` per chunk: autograd keeps no chunk's [chunk, n]
    logits or weights, and the backward recomputes them, one chunk at a
    time, giving the same bits as the chunks kept."""
    if q.shape[2] <= chunk:
        return full_attention(q, k, v, causal=causal, scale=scale)
    outs = []
    for c0, qc in zip(range(0, q.shape[2], chunk), q.split(chunk, dim=2)):
        c1 = c0 + qc.shape[2]
        kc, vc = (k[:, :, :c1], v[:, :, :c1]) if causal else (k, v)
        outs.append(checkpoint(_causal_chunk_attend, qc, kc, vc, c0, causal, scale,
                               use_reentrant=False))
    return torch.cat(outs, dim=2)


def _shift_tiles(x: torch.Tensor, amt: int) -> torch.Tensor:
    """Shift [b, h, W, T, d] along W; amt=+1: tile w sees tile w-1 (zeros
    for w=0); amt=-1: tile w sees tile w+1 (zeros for the last)."""
    z = torch.zeros_like(x[:, :, :1])
    if amt > 0:
        return torch.cat([z, x[:, :, :-1]], dim=2)
    return torch.cat([x[:, :, 1:], z], dim=2)


def sliding_window_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    window_size: int,
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Exact banded local attention: query i attends keys j with
    ``0 <= i - j <= window_size`` (causal) or ``|i - j| <= window_size``,
    computed tile-wise so the cost is O(n * window)."""
    b, h, n, d = q.shape
    kvh = k.shape[1]
    scale = d ** -0.5 if scale is None else scale
    T = max(min(window_size, n), 1)
    N = round_up_mult(n, T)
    W = N // T
    pad = (0, 0, 0, N - n)
    qt = F.pad(q, pad).reshape(b, h, W, T, d)
    kt = F.pad(k, pad).reshape(b, kvh, W, T, d)
    vt = F.pad(v, pad).reshape(b, kvh, W, T, d)

    if causal:
        kctx = torch.cat([_shift_tiles(kt, 1), kt], dim=3)
        vctx = torch.cat([_shift_tiles(vt, 1), vt], dim=3)
    else:
        kctx = torch.cat([_shift_tiles(kt, 1), kt, _shift_tiles(kt, -1)], dim=3)
        vctx = torch.cat([_shift_tiles(vt, 1), vt, _shift_tiles(vt, -1)], dim=3)
    num_ctx = 2 if causal else 3

    g = h // kvh
    qg = qt.reshape(b, kvh, g, W, T, d)
    sim = torch.einsum("bhgwrd,bhwcd->bhgwrc", qg.float(), kctx.float()) * scale

    dev = q.device
    w_ids = torch.arange(W, device=dev)
    qi = w_ids[:, None] * T + torch.arange(T, device=dev)[None, :]                  # [W, T]
    kj = w_ids[:, None] * T - T + torch.arange(num_ctx * T, device=dev)[None, :]    # [W, C]
    delta = qi[:, :, None] - kj[:, None, :]                                         # [W, T, C]
    if causal:
        valid = (delta >= 0) & (delta <= window_size)
    else:
        valid = (delta >= -window_size) & (delta <= window_size)
    valid &= ((kj >= 0) & (kj < n))[:, None, :]

    sim = sim.masked_fill(~valid, mask_value(torch.float32))
    attn = torch.softmax(sim, dim=-1).to(q.dtype)
    out = torch.einsum("bhgwrc,bhwcd->bhgwrd", attn, vctx)
    return out.reshape(b, h, N, d)[:, :, :n]


def gather_blocks(blocks: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """blocks [b, H, W, B, d], idx [b, H, n, S] -> [b, H, n, S, B, d]."""
    b, H = idx.shape[:2]
    bi = torch.arange(b, device=idx.device)[:, None, None, None]
    hi = torch.arange(H, device=idx.device)[None, :, None, None]
    return blocks[bi, hi, idx.long()]


def blockify_kv(k: torch.Tensor, v: torch.Tensor, block_size: int, Hs: int):
    """Pad K/V to a block multiple and reshape to [b, Hs, W, B, d]."""
    b, kvh, n, d = k.shape
    N = round_up_mult(n, block_size)
    W = N // block_size
    kb = F.pad(k, (0, 0, 0, N - n))
    vb = F.pad(v, (0, 0, 0, N - n))
    if Hs != kvh:
        kb = repeat_kv(kb, Hs // kvh)
        vb = repeat_kv(vb, Hs // kvh)
    return kb.reshape(b, Hs, W, block_size, d), vb.reshape(b, Hs, W, block_size, d)


def fine_attend_core(
    q: torch.Tensor,
    kb: torch.Tensor,
    vb: torch.Tensor,
    sel_idx: torch.Tensor,
    sel_mask: torch.Tensor,
    gates: Optional[torch.Tensor],
    positions: torch.Tensor,
    causal: bool,
    scale: float,
) -> torch.Tensor:
    """Fine attention for query rows at global ``positions`` [m].

    q: [b, h, m, d] rotated queries; kb/vb: [b, Hs, W, B, d];
    sel_idx / sel_mask / gates: [b, Hs, m, S].  One softmax over the union
    of the selected blocks and (if causal) the block-causal diagonal.
    """
    b, h, m, d = q.shape
    _, Hs, W, B, _ = kb.shape
    S = sel_idx.shape[-1]
    dev = q.device

    if causal:
        diag_idx = torch.clamp(positions // B, 0, W - 1)
        sel_idx = torch.cat(
            [sel_idx, diag_idx[None, None, :, None].expand(b, Hs, m, 1).to(sel_idx.dtype)],
            dim=-1,
        )
        col = torch.arange(B, device=dev)
        diag_cols = (diag_idx[:, None] * B + col[None, :]) <= positions[:, None]   # [m, B]
        slot_mask = torch.cat(
            [
                sel_mask[..., None].expand(b, Hs, m, S, B),
                diag_cols[None, None, :, None, :].expand(b, Hs, m, 1, B),
            ],
            dim=-2,
        )
        if gates is not None:
            gates = torch.cat([gates, gates.new_ones((b, Hs, m, 1))], dim=-1)
        S_tot = S + 1
    else:
        slot_mask = sel_mask[..., None].expand(b, Hs, m, S, B)
        S_tot = S

    fk = gather_blocks(kb, sel_idx)                                 # [b,Hs,m,S_tot,B,d]
    fv = gather_blocks(vb, sel_idx)
    if gates is not None:
        fk = fk * gates[..., None, None].to(fk.dtype)

    G = h // Hs
    qg = q.reshape(b, Hs, G, m, d)
    fk = fk.reshape(b, Hs, m, S_tot * B, d)
    fv = fv.reshape(b, Hs, m, S_tot * B, d)
    slot_mask = slot_mask.reshape(b, Hs, 1, m, S_tot * B)

    sim = torch.einsum("bhgnd,bhnjd->bhgnj", qg.float(), fk.float()) * scale
    sim = sim.masked_fill(~slot_mask, mask_value(torch.float32))
    attn = torch.softmax(sim, dim=-1).to(q.dtype)
    out = torch.einsum("bhgnj,bhnjd->bhgnd", attn, fv)
    return out.reshape(b, h, m, d)


def fine_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    sel_idx: torch.Tensor,
    sel_mask: torch.Tensor,
    gates: Optional[torch.Tensor],
    selection_block_size: int,
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """The NSA fine branch over all rows at once, the oracle: q [b, h, n, d]
    rotated; k, v [b, kvh, n, d]; sel_idx / sel_mask / gates [b, Hs, n, S],
    Hs = kv_heads when the query heads share their selection, else heads.
    The straight-through gates multiply the gathered keys."""
    n, d = q.shape[2], q.shape[3]
    scale = d ** -0.5 if scale is None else scale
    kb, vb = blockify_kv(k, v, selection_block_size, sel_idx.shape[1])
    return fine_attend_core(q, kb, vb, sel_idx, sel_mask, gates,
                            torch.arange(n, device=q.device), causal, scale)
