"""Fused NSA fine + sliding attention for the prefill and training
(``nsa_tpu/ops/pallas/nsa_prefill.py``): the forward ``_forward`` and the
backward ``_backward_kernels``, under one ``torch.autograd.Function`` as
the JAX package's ``jax.custom_vjp``.

For every query row at position ``i`` and each of its KV head's G query
heads:

* fine output: one softmax over the keys of the valid selected blocks
  united with the block-causal diagonal block, all keys ``<= i``;
* sliding output: one softmax over the keys ``i - window .. i``;

plus the log-sum-exp of each softmax.  Selection is shared by the query
heads of one KV head.  As in the TPU kernels the straight-through top-k
gates are 1.0 in value and the backward is linearised there: ``d_gates``
of a slot is the sum, over the keys of the slot's block that the fine mask
keeps and over the G heads, of ``dS_fine * s`` (``s`` the scaled logit);
an invalid slot gets 0.

Three kernels (``csrc/nsa_prefill.cu``, ``csrc/nsa_prefill_bwd.cu``), each
behind a wrapper that launches it for CUDA tensors, runs its plain PyTorch
version for CPU tensors and counts its launches:

* ``prefill_fwd``      -> fo, so, f_lse, s_lse;
* ``prefill_bwd_dq``   -> dq, d_gates and both ``delta = rowsum(o * do)``;
* ``prefill_bwd_dkv``  -> dk, dv (reads the deltas ``prefill_bwd_dq`` wrote).

``nsa_fine_sliding_attention`` is the differentiable entry point;
``use_kernels=False`` runs the plain versions on any device, to hold the
kernel path against them on the card.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..common import mask_value
from . import runtime
from .flash import TOL_ABS_V_REL, TOL_OUT_REL

KERNEL_MAX_SEL = 16   # selected blocks per row the kernels take (csrc kMaxSel)


def _take(x, pos):
    """x [b, kvh, n, d], pos [b, kvh, m, J] -> [b, kvh, m, J, d]."""
    b, kvh = x.shape[:2]
    bi = torch.arange(b, device=x.device)[:, None, None, None]
    hi = torch.arange(kvh, device=x.device)[None, :, None, None]
    return x[bi, hi, pos]


def _row_keys(sel_idx, sel_mask, c0, c1, n, sel_block, window):
    """The keys of query rows ``c0 .. c1-1``, clamped into ``[0, n)``.

    fine: the valid selected blocks (each once, never the row's own block),
    then the row's own block; ``fine_ok`` keeps the keys ``<= i``.
    Returns blocks [b, kvh, m, S+1], fine_pos / fine_ok [b, kvh, m, (S+1)*B],
    band_pos / band_ok [m, window+1].
    """
    b, kvh, _, S = sel_idx.shape
    dev = sel_idx.device
    m = c1 - c0
    pos = torch.arange(c0, c1, device=dev)
    idx = sel_idx[:, :, c0:c1].long()
    q_blk = (pos // sel_block)[None, None, :, None]
    keep = sel_mask[:, :, c0:c1] & (idx != q_blk)
    earlier = torch.ones(S, S, dtype=torch.bool, device=dev).tril(-1)   # [s, s'<s]
    dup = (idx[..., :, None] == idx[..., None, :]) & keep[..., None, :] & earlier
    keep = keep & ~dup.any(-1)
    blocks = torch.cat([idx, q_blk.expand(b, kvh, m, 1)], dim=-1)
    keep = torch.cat([keep, keep.new_ones((b, kvh, m, 1))], dim=-1)
    kpos = blocks[..., None] * sel_block + torch.arange(sel_block, device=dev)
    ok = keep[..., None] & (kpos >= 0) & (kpos <= pos[:, None, None])
    band = pos[:, None] + torch.arange(window + 1, device=dev) - window
    return (blocks, kpos.clamp(0, n - 1).flatten(-2), ok.flatten(-2),
            band.clamp(min=0), band >= 0)


def _gate_factor(blocks, sel_idx, sel_mask, gates):
    """[b, kvh, m, S+1] multipliers of the gathered key blocks: 1.0 in value,
    with d/d gates[s] = 1 where slot s is valid and names the block.  A
    slot that repeats a block or names the row's own block thus gets that
    block's gradient, as the Pallas backward's slot masks give it."""
    hit = (blocks[..., :, None] == sel_idx.long()[..., None, :]) & sel_mask[..., None, :]
    delta = gates - gates.detach()
    return 1.0 + (hit.to(gates.dtype) * delta[..., None, :]).sum(-1)


def _masked_attend(qg, k, v, ok, scale):
    """qg [b, kvh, G, m, d]; k, v [b, kvh, m, J, d]; ok broadcastable to
    [b, kvh, G, m, J] -> out [b, kvh*G, m, d], lse [b, kvh*G, m].  As in
    the Pallas and CUDA kernels, the softmax weights stay float32 through
    the weighted sum; only the output is rounded to the working dtype."""
    b, kvh, G, m, d = qg.shape
    sim = torch.einsum("bhgmd,bhmjd->bhgmj", qg.float(), k.float()) * scale
    sim = sim.masked_fill(~ok, mask_value(torch.float32))
    lse = torch.logsumexp(sim, dim=-1)
    out = torch.einsum("bhgmj,bhmjd->bhgmd", torch.softmax(sim, dim=-1), v.float())
    return out.to(qg.dtype).reshape(b, kvh * G, m, d), lse.reshape(b, kvh * G, m)


def fine_sliding_plain(
    rq, rk, v, sel_idx, sel_mask, sel_block: int, window: int, scale: float,
    chunk: int = 128, gates: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain forward: gathers each row's keys, chunk by chunk of query
    rows.  Same arguments and results as ``prefill_fwd``.  With ``gates``
    the gathered fine keys are multiplied by ``_gate_factor`` (as
    ``fine_attend_core`` multiplies them by the gates), so that autograd
    through this function gives the kernels' ``d_gates``."""
    b, h, n, d = rq.shape
    kvh = rk.shape[1]
    G = h // kvh
    parts = []
    for c0 in range(0, n, chunk):
        c1 = min(c0 + chunk, n)
        m = c1 - c0
        qg = rq[:, :, c0:c1].reshape(b, kvh, G, m, d)
        blocks, fpos, fok, bpos, bok = _row_keys(sel_idx, sel_mask, c0, c1, n, sel_block, window)
        fk = _take(rk, fpos)
        if gates is not None:
            factor = _gate_factor(blocks, sel_idx[:, :, c0:c1], sel_mask[:, :, c0:c1],
                                  gates[:, :, c0:c1])
            fk = (fk.unflatten(3, (-1, sel_block)) * factor[..., None, None].to(fk.dtype)
                  ).flatten(3, 4)
        fo, flse = _masked_attend(qg, fk, _take(v, fpos), fok[:, :, None], scale)
        so, slse = _masked_attend(qg, rk[:, :, bpos], v[:, :, bpos], bok, scale)
        parts.append((fo, so, flse, slse))
    return tuple(torch.cat(p, dim=2) for p in zip(*parts))


def fine_sliding_tolerance(rq, rk, v, sel_idx, sel_mask, sel_block: int, window: int,
                           scale: float, want) -> Tuple[torch.Tensor, torch.Tensor]:
    """The float32 bounds, element by element, on |``prefill_fwd`` -
    ``fine_sliding_plain``| for the fine and the sliding output on the same
    bf16 inputs, ``want`` being the plain version's outputs: the forward
    kernel rounds its softmax weights to bf16 for P.V as the flash kernel
    does, so the rule is flash's (``flash.TOL_OUT_REL``): ``TOL_OUT_REL``
    |want| + ``TOL_ABS_V_REL`` times the same branch's attention over |v|.
    The log-sum-exps are float32 both ways and are held to 1e-3 apart."""
    abs_v = fine_sliding_plain(rq.float(), rk.float(), v.float().abs(), sel_idx, sel_mask,
                               sel_block, window, scale)
    return tuple(TOL_OUT_REL * w.float().abs() + TOL_ABS_V_REL * a
                 for w, a in zip(want[:2], abs_v[:2]))


def without_first_block(sel_idx, sel_mask, sel_block: int):
    """The selection mask with each row's first valid slot before its own
    block cleared, and every slot naming the same block: the selections of a
    kernel that left one block out of every row that has one.  The control
    each kernel's elementwise rule must fail."""
    n = sel_idx.shape[2]
    q_blk = (torch.arange(n, device=sel_idx.device) // sel_block)[:, None]
    idx = sel_idx.long()
    cand = sel_mask & (idx >= 0) & (idx < q_blk)
    first = idx.gather(-1, cand.int().argmax(-1, keepdim=True))
    return sel_mask & ~(cand.any(-1, keepdim=True) & (idx == first))


def _check_kernel_shapes(rq, rk, sel_idx):
    b, h, n, d = rq.shape
    kvh = rk.shape[1]
    G = h // kvh
    S = sel_idx.shape[-1]
    if d != 64 or G not in (1, 2, 4, 8) or h != kvh * G or S > KERNEL_MAX_SEL:
        raise ValueError(f"prefill kernels take dim_head 64, G in 1/2/4/8 and at "
                         f"most {KERNEL_MAX_SEL} selected blocks; got d={d}, "
                         f"heads={h}, kv_heads={kvh}, S={S}")
    return b, h, kvh, G, n, d, S


def prefill_fwd(rq, rk, v, sel_idx, sel_mask, sel_block: int, window: int, scale: float):
    """rq [b, kvh*G, n, d] rotated queries (heads of one KV head adjacent);
    rk, v [b, kvh, n, d]; sel_idx [b, kvh, n, S] int32; sel_mask
    [b, kvh, n, S] bool.  Returns (fine_out, sliding_out [b, kvh*G, n, d],
    fine_lse, sliding_lse [b, kvh*G, n] float32)."""
    if runtime.on_cpu(rq, rk, v, sel_idx, sel_mask):
        return fine_sliding_plain(rq, rk, v, sel_idx, sel_mask, sel_block, window, scale)
    b, h, kvh, G, n, d, S = _check_kernel_shapes(rq, rk, sel_idx)
    bf = torch.bfloat16
    ptrs = [
        runtime.check("rq", rq, bf, (b, h, n, d)),
        runtime.check("rk", rk, bf, (b, kvh, n, d)),
        runtime.check("v", v, bf, (b, kvh, n, d)),
        runtime.check("sel_idx", sel_idx, torch.int32, (b, kvh, n, S)),
        runtime.check("sel_mask", sel_mask, torch.bool, (b, kvh, n, S)),
    ]
    fo = torch.empty_like(rq)
    so = torch.empty_like(rq)
    flse = torch.empty((b, h, n), dtype=torch.float32, device=rq.device)
    slse = torch.empty_like(flse)
    with torch.cuda.device(rq.device):
        runtime.library().call(
            "nsa_prefill_fwd", *ptrs, fo.data_ptr(), so.data_ptr(),
            flse.data_ptr(), slse.data_ptr(), b, kvh, G, n, S, sel_block,
            window, scale, runtime.stream_of(rq),
        )
    prefill_fwd.launches += 1
    return fo, so, flse, slse


prefill_fwd.launches = 0


def _bwd_terms(qs, do, keys, vals, ok, lse, delta, absolute=False):
    """One branch's backward terms, as the Pallas ``branch_ds``.
    qs [b, kvh, G, m, d] scaled float queries; do [b, kvh, G, m, d]; keys,
    vals [b, kvh, m, J, d] float; ok broadcastable to [b, kvh, G, m, J];
    lse, delta [b, kvh, G, m] -> s, p, dS [b, kvh, G, m, J]; with
    ``absolute`` p (|dP| + |delta|) in place of dS."""
    s = torch.einsum("bhgmd,bhmjd->bhgmj", qs, keys)
    p = torch.where(ok, torch.exp(torch.clamp(s - lse[..., None], max=30.0)), 0.0)
    dp = torch.einsum("bhgmd,bhmjd->bhgmj", do.float(), vals)
    if absolute:
        return s, p, p * (dp.abs() + delta.abs()[..., None])
    return s, p, p * (dp - delta[..., None])


def _bwd_chunks(rq, rk, v, sel_idx, sel_mask, flse, slse, fdel, sdel, dfo, dso,
                sel_block, window, scale, chunk, absolute=False):
    """Per chunk of query rows: (c0, c1, blocks, scaled q, dfo, dso, fine
    (pos, p, dS, s), band (pos, p, dS)) with the terms in float32 (with
    ``absolute``, p (|dP| + |delta|) in place of dS)."""
    b, h, n, d = rq.shape
    kvh = rk.shape[1]
    G = h // kvh

    def rows(x, c0, c1):
        return x[:, :, c0:c1].reshape(b, kvh, G, c1 - c0, *x.shape[3:])

    for c0 in range(0, n, chunk):
        c1 = min(c0 + chunk, n)
        qs = rows(rq, c0, c1).float() * scale
        dfo_c, dso_c = rows(dfo, c0, c1), rows(dso, c0, c1)
        blocks, fpos, fok, bpos, bok = _row_keys(sel_idx, sel_mask, c0, c1, n, sel_block, window)
        s, pf, dsf = _bwd_terms(qs, dfo_c, _take(rk, fpos).float(), _take(v, fpos).float(),
                                fok[:, :, None], rows(flse, c0, c1), rows(fdel, c0, c1),
                                absolute)
        _, ps, dss = _bwd_terms(qs, dso_c, rk[:, :, bpos].float(), v[:, :, bpos].float(),
                                bok, rows(slse, c0, c1), rows(sdel, c0, c1), absolute)
        yield c0, c1, blocks, qs, dfo_c, dso_c, (fpos, pf, dsf, s), (bpos, ps, dss)


def prefill_bwd_dq_plain(rq, rk, v, sel_idx, sel_mask, fo, so, flse, slse, dfo, dso,
                         sel_block: int, window: int, scale: float, chunk: int = 128):
    """The plain version of ``prefill_bwd_dq``, the Pallas ``_dq_kernel``'s
    arithmetic on gathered keys."""
    b, h, n, d = rq.shape
    kvh = rk.shape[1]
    S = sel_idx.shape[-1]
    fdel = (fo.float() * dfo.float()).sum(-1)
    sdel = (so.float() * dso.float()).sum(-1)
    dqs, dgs = [], []
    for c0, c1, blocks, _, _, _, fine, band in _bwd_chunks(
            rq, rk, v, sel_idx, sel_mask, flse, slse, fdel, sdel, dfo, dso,
            sel_block, window, scale, chunk):
        fpos, _, dsf, s = fine
        bpos, _, dss = band
        m = c1 - c0
        dq = torch.einsum("bhgmj,bhmjd->bhgmd", dsf, _take(rk, fpos).float())
        dq = dq + torch.einsum("bhgmj,bhmjd->bhgmd", dss, rk[:, :, bpos].float())
        dqs.append((dq * scale).reshape(b, h, m, d))
        # d gate[slot] = sum over the slot's block's kept keys and the heads of dS * s
        per_block = (dsf * s).sum(2).unflatten(-1, (-1, sel_block)).sum(-1)   # [b,kvh,m,S+1]
        hit = ((blocks[..., :, None] == sel_idx[:, :, c0:c1].long()[..., None, :])
               & sel_mask[:, :, c0:c1][..., None, :])
        dgs.append((hit.float() * per_block[..., None]).sum(-2))
    dg = torch.cat(dgs, dim=2) if S else rq.new_zeros((b, kvh, n, 0), dtype=torch.float32)
    return torch.cat(dqs, dim=2).to(rq.dtype), dg, fdel, sdel


def _dkv_sums(rq, rk, v, sel_idx, sel_mask, flse, slse, fdel, sdel, dfo, dso,
              sel_block, window, scale, chunk, absolute=False):
    """Float32 dk, dv [b, kvh, n, d] scattered chunk by chunk with
    ``index_add_``; with ``absolute`` the same sums over p (|dP| + |delta|)
    |scale q| and p |do|."""
    b, kvh, n, d = rk.shape
    dk = torch.zeros((b * kvh * n, d), dtype=torch.float32, device=rk.device)
    dv = torch.zeros_like(dk)
    base = (torch.arange(b * kvh, device=rk.device) * n).reshape(b, kvh, 1, 1)
    f = torch.abs if absolute else (lambda x: x)
    for c0, c1, _, qs, dfo_c, dso_c, fine, band in _bwd_chunks(
            rq, rk, v, sel_idx, sel_mask, flse, slse, fdel, sdel, dfo, dso,
            sel_block, window, scale, chunk, absolute):
        for pos, p, ds, do in ((fine[0], fine[1], fine[2], dfo_c), (band[0], band[1], band[2], dso_c)):
            pos = (base + pos.expand(b, kvh, *pos.shape[-2:])).flatten()
            dk.index_add_(0, pos, torch.einsum("bhgmj,bhgmd->bhmjd", ds, f(qs)).reshape(-1, d))
            dv.index_add_(0, pos, torch.einsum("bhgmj,bhgmd->bhmjd", p, f(do.float())
                                               ).reshape(-1, d))
    return dk.reshape(b, kvh, n, d), dv.reshape(b, kvh, n, d)


def prefill_bwd_dkv_plain(rq, rk, v, sel_idx, sel_mask, flse, slse, fdel, sdel, dfo, dso,
                          sel_block: int, window: int, scale: float, chunk: int = 128):
    """The plain version of ``prefill_bwd_dkv``: each chunk's key gradients
    scattered into float32 buffers with ``index_add_``."""
    dk, dv = _dkv_sums(rq, rk, v, sel_idx, sel_mask, flse, slse, fdel, sdel, dfo, dso,
                       sel_block, window, scale, chunk)
    return dk.to(rk.dtype), dv.to(v.dtype)


def prefill_bwd_tolerance(rq, rk, v, sel_idx, sel_mask, flse, slse, fdel, sdel, dfo, dso,
                          sel_block: int, window: int, scale: float, want, chunk: int = 128):
    """The float32 bounds, element by element, on |kernel - plain| for dq,
    dk and dv on the same bf16 inputs, ``want`` being the plain versions'
    (dq, dk, dv).  The kernels take their products on the tensor cores with
    bf16 operands where the plain versions keep float32: dS = p (dP - delta)
    in dQ = dS.K and dK = dS^T.Q, and P in dV = P^T.dO.  Row 1's rule in the
    same form: ``TOL_OUT_REL`` |want| for the two bf16 roundings of each
    output, plus ``TOL_ABS_V_REL`` times the same sum over absolute values,
    each term twice its source (an operand's rounding is 2^-9 relative):
    scale sum p (|dP| + |delta|) |k| for dq, scale sum p (|dP| + |delta|)
    |q| for dk, sum p |dO| for dv.  p (|dP| + |delta|) bounds |dS| and also
    covers the float32 sums of dP and delta, which the two sides take in
    another order: where they cancel (a branch of one key) dS is 0 in the
    plain version but only about 2^-23 |dP| in the kernel.  The deltas and
    d_gates stay float32 both ways and are held to 1e-4 of their largest
    value."""
    b, h, n, d = rq.shape
    parts = []
    for c0, c1, _, _, _, _, fine, band in _bwd_chunks(
            rq, rk, v, sel_idx, sel_mask, flse, slse, fdel, sdel, dfo, dso,
            sel_block, window, scale, chunk, absolute=True):
        aq = torch.einsum("bhgmj,bhmjd->bhgmd", fine[2], _take(rk, fine[0]).float().abs())
        aq = aq + torch.einsum("bhgmj,bhmjd->bhgmd", band[2], rk[:, :, band[0]].float().abs())
        parts.append((aq * scale).reshape(b, h, c1 - c0, d))
    sums = (torch.cat(parts, dim=2),
            *_dkv_sums(rq, rk, v, sel_idx, sel_mask, flse, slse, fdel, sdel, dfo, dso,
                       sel_block, window, scale, chunk, absolute=True))
    return tuple(TOL_OUT_REL * w.float().abs() + TOL_ABS_V_REL * a for w, a in zip(want, sums))


def prefill_bwd_dq(rq, rk, v, sel_idx, sel_mask, fo, so, flse, slse, dfo, dso,
                   sel_block: int, window: int, scale: float):
    """Backward, query side (``_dq_kernel``).  fo, so, dfo, dso [b, h, n, d];
    flse, slse [b, h, n] float32; the rest as ``prefill_fwd``.  Returns
    dq [b, h, n, d] (rq's dtype), d_gates [b, kvh, n, S] float32, and the
    fine and sliding ``delta = rowsum(o * do)`` [b, h, n] float32."""
    if runtime.on_cpu(rq, rk, v, sel_idx, sel_mask, fo, so, flse, slse, dfo, dso):
        return prefill_bwd_dq_plain(rq, rk, v, sel_idx, sel_mask, fo, so, flse, slse,
                                    dfo, dso, sel_block, window, scale)
    b, h, kvh, G, n, d, S = _check_kernel_shapes(rq, rk, sel_idx)
    bf, f32 = torch.bfloat16, torch.float32
    ptrs = [
        runtime.check("rq", rq, bf, (b, h, n, d)),
        runtime.check("rk", rk, bf, (b, kvh, n, d)),
        runtime.check("v", v, bf, (b, kvh, n, d)),
        runtime.check("sel_idx", sel_idx, torch.int32, (b, kvh, n, S)),
        runtime.check("sel_mask", sel_mask, torch.bool, (b, kvh, n, S)),
        runtime.check("fo", fo, bf, (b, h, n, d)),
        runtime.check("so", so, bf, (b, h, n, d)),
        runtime.check("flse", flse, f32, (b, h, n)),
        runtime.check("slse", slse, f32, (b, h, n)),
        runtime.check("dfo", dfo, bf, (b, h, n, d)),
        runtime.check("dso", dso, bf, (b, h, n, d)),
    ]
    dq = torch.empty_like(rq)
    dg = torch.empty((b, kvh, n, S), dtype=f32, device=rq.device)
    fdel = torch.empty((b, h, n), dtype=f32, device=rq.device)
    sdel = torch.empty_like(fdel)
    with torch.cuda.device(rq.device):
        runtime.library().call(
            "nsa_prefill_bwd_dq", *ptrs, dq.data_ptr(), dg.data_ptr(), fdel.data_ptr(),
            sdel.data_ptr(), b, kvh, G, n, S, sel_block, window, scale, runtime.stream_of(rq),
        )
    prefill_bwd_dq.launches += 1
    return dq, dg, fdel, sdel


prefill_bwd_dq.launches = 0


def prefill_bwd_dkv(rq, rk, v, sel_idx, sel_mask, flse, slse, fdel, sdel, dfo, dso,
                    sel_block: int, window: int, scale: float):
    """Backward, key side (``_dkv_kernel``): dk, dv [b, kvh, n, d] in rk's
    and v's dtype.  fdel, sdel are ``prefill_bwd_dq``'s deltas."""
    if runtime.on_cpu(rq, rk, v, sel_idx, sel_mask, flse, slse, fdel, sdel, dfo, dso):
        return prefill_bwd_dkv_plain(rq, rk, v, sel_idx, sel_mask, flse, slse, fdel, sdel,
                                     dfo, dso, sel_block, window, scale)
    b, h, kvh, G, n, d, S = _check_kernel_shapes(rq, rk, sel_idx)
    bf, f32 = torch.bfloat16, torch.float32
    ptrs = [
        runtime.check("rq", rq, bf, (b, h, n, d)),
        runtime.check("rk", rk, bf, (b, kvh, n, d)),
        runtime.check("v", v, bf, (b, kvh, n, d)),
        runtime.check("sel_idx", sel_idx, torch.int32, (b, kvh, n, S)),
        runtime.check("sel_mask", sel_mask, torch.bool, (b, kvh, n, S)),
        runtime.check("flse", flse, f32, (b, h, n)),
        runtime.check("slse", slse, f32, (b, h, n)),
        runtime.check("fdel", fdel, f32, (b, h, n)),
        runtime.check("sdel", sdel, f32, (b, h, n)),
        runtime.check("dfo", dfo, bf, (b, h, n, d)),
        runtime.check("dso", dso, bf, (b, h, n, d)),
    ]
    dk = torch.empty_like(rk)
    dv = torch.empty_like(v)
    with torch.cuda.device(rq.device):
        lib = runtime.library()
        size = ctypes.c_longlong()
        lib.call("nsa_prefill_bwd_dkv_workspace", b, kvh, n, S, sel_block, window,
                 ctypes.addressof(size))
        work = torch.empty(size.value, dtype=torch.uint8, device=rq.device)
        lib.call(
            "nsa_prefill_bwd_dkv", *ptrs, dk.data_ptr(), dv.data_ptr(), work.data_ptr(),
            size.value, b, kvh, G, n, S, sel_block, window, scale, runtime.stream_of(rq),
        )
    prefill_bwd_dkv.launches += 1
    return dk, dv


prefill_bwd_dkv.launches = 0


class _FineSliding(torch.autograd.Function):
    """Forward ``prefill_fwd``, backward ``prefill_bwd_dq`` then
    ``prefill_bwd_dkv`` (or their plain versions), as the JAX package's
    custom VJP ``_fwd`` / ``_bwd``."""

    @staticmethod
    def forward(ctx, rq, rk, v, sel_idx, sel_mask, gates, sel_block, window, scale, use_kernels):
        fwd = prefill_fwd if use_kernels else fine_sliding_plain
        fo, so, flse, slse = fwd(rq, rk, v, sel_idx, sel_mask, sel_block, window, scale)
        ctx.save_for_backward(rq, rk, v, sel_idx, sel_mask, fo, so, flse, slse)
        ctx.args = (sel_block, window, scale, use_kernels)
        ctx.gates_dtype = None if gates is None else gates.dtype
        return fo, so

    @staticmethod
    def backward(ctx, dfo, dso):
        rq, rk, v, sel_idx, sel_mask, fo, so, flse, slse = ctx.saved_tensors
        sel_block, window, scale, use_kernels = ctx.args
        dfo = torch.zeros_like(fo) if dfo is None else dfo.contiguous()
        dso = torch.zeros_like(so) if dso is None else dso.contiguous()
        if use_kernels:
            bwd_dq, bwd_dkv = prefill_bwd_dq, prefill_bwd_dkv
        else:
            bwd_dq, bwd_dkv = prefill_bwd_dq_plain, prefill_bwd_dkv_plain
        dq, dg, fdel, sdel = bwd_dq(rq, rk, v, sel_idx, sel_mask, fo, so, flse, slse, dfo, dso,
                                    sel_block, window, scale)
        dk, dv = bwd_dkv(rq, rk, v, sel_idx, sel_mask, flse, slse, fdel, sdel, dfo, dso,
                         sel_block, window, scale)
        dgates = None if ctx.gates_dtype is None else dg.to(ctx.gates_dtype)
        return dq, dk, dv, None, None, dgates, None, None, None, None


def nsa_fine_sliding_attention(
    rq, rk, v, sel_idx, sel_mask, gates: Optional[torch.Tensor],
    sel_block: int, window: int, scale: float, *, use_kernels: bool = True,
):
    """Differentiable fine + sliding attention, ``nsa_tpu``'s function of
    the same name.  rq [b, kvh*G, n, d]; rk, v [b, kvh, n, d]; sel_idx,
    sel_mask, gates [b, kvh, n, S] (gates may be None).  Returns
    (fine_out, sliding_out) [b, kvh*G, n, d]; gradients reach rq, rk, v
    and gates."""
    return _FineSliding.apply(rq, rk, v, sel_idx, sel_mask, gates, sel_block, window,
                              scale, use_kernels)
