"""The fused decode-step kernels of the small-batch route
(``nsa_tpu/ops/pallas/nsa_decode_fused.py``, scalar position): one NSA
layer's decode step as two kernels.

* ``decode_select_emit`` — everything ``decode_select`` does (branch 1
  over the live compressed rows and the mem slots, the selection pipeline,
  the packed info row), plus the in-place ring shift and, on emission steps
  (``(t + 1) % stride == 0``), the GroupedMLP compressor over the shifted
  ring window, written into ``ckv[:, :, num_cb]`` in place.
* ``decode_attend_fused`` — everything ``decode_attend`` does (the block
  gather, fine and sliding attention, the gate combine), plus the in-place
  write of the new token's row into ``kv[:, :, t]``, the output projection
  summed over the KV heads, the residual add and, when handed the gelu FF
  params, the whole FF block: it returns the complete layer output.

Each wrapper launches its CUDA kernel for CUDA tensors, raises on what the
kernel does not take, and runs the plain PyTorch version beside it for CPU
tensors.  The two kernels are the ragged pair's designs (rows 8 and 9,
``nsa_decode_ragged.py``) at one position, which both read from one int32
in device memory (an int ``t`` is written there first), so a captured
decode step replays them at each step's position: ``decode_select_emit``
(``csrc/nsa_decode_fused.cu``) launches the tensor-core emission on every
step, which returns at once unless the step emits, under the ragged
emission's launch plan (``emit_plan``; it raises when that does not fit),
then the ring shift, the emitted row and the selection;
``decode_attend_fused`` is the one-launch attend kernel
(``csrc/nsa_decode_ragged.cu``) at that position, under the same plan
(``attend_plan``; it raises when that does not fit).
At a position every row shares, the pairs give the same bits.  The plain
versions follow the
Pallas kernels' rounding points: softmax weights stay float32; the gates
are cast to the query dtype; the combined attention output is rounded to
the cache dtype before the projection, which is summed over heads and added
to the residual in float32 and rounded once; the FF follows ``_ff_tail``
op for op with the exact erf GELU.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import nsa_decode, runtime
from .nsa_decode import INFO_WIDTH, per_row, write_row

EMIT_COLS = 64      # compressor hidden columns per emission block (the kernel's)


def emits(t, stride: int):
    """Whether the step at position ``t`` completes a compressed block: a
    bool for an int, a bool tensor for a tensor."""
    return (t + 1) % stride == 0


def emission_plain(shifted, t, pos_kv, w1k, b1k, w1v, b1v, w2, b2, dtype,
                   drop_chunk=None) -> torch.Tensor:
    """The GroupedMLP compression of the window [t+1-Bc, t+1) that the
    shifted ring [b, kvh, Bc, 2d] holds, rows before the sequence start
    zeroed, plus the intra-block positions: the candidate row [b, kvh, 2d]
    in ``dtype``, rounded where the Pallas kernels round.  ``t`` is an int
    or a [b] tensor.  ``drop_chunk`` c leaves the hidden columns [64 c, 64 c
    + 64) of both halves out of the second product: a kernel that lost one
    emission item, the control the emitted-row gates must fail."""
    b, kvh, Bc, d2 = shifted.shape
    d = d2 // 2
    row_pos = torch.arange(Bc, device=shifted.device) + (per_row(t) + 1 - Bc)   # [(b,) Bc]
    win = shifted.masked_fill((row_pos < 0).reshape(-1, 1, Bc, 1), 0.0)
    win = win + pos_kv.to(win.dtype)[None]

    def mlp(x, w1, b1, w2_, b2_):
        hid = torch.einsum("bhi,hio->bho", x.reshape(b, kvh, Bc * d).float(), w1.float())
        hid = torch.relu(hid + b1.float()[None]).to(dtype)
        if drop_chunk is not None:
            hid[..., drop_chunk * EMIT_COLS:(drop_chunk + 1) * EMIT_COLS] = 0
        out = torch.einsum("bho,hoe->bhe", hid.float(), w2_.float()) + b2_.float()[None]
        return out.to(dtype)

    ck = mlp(win[..., :d], w1k, b1k, w2[..., :d], b2[:, :d])
    cv = mlp(win[..., d:], w1v, b1v, w2[..., d:], b2[:, d:])
    return torch.cat([ck, cv], dim=-1)


def decode_select_emit_plain(q, ckv, ring, kv_new, mem_kv, pos_kv, w1k, b1k, w1v, b1v,
                             w2, b2, t, num_cb, *, max_blocks: int, stride: int,
                             sel_block: int, num_sel: int, n_slide: int,
                             scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of ``decode_select_emit``; ``t`` and
    ``num_cb`` ints or 0-d tensors (a device position: the emission is then
    decided on the device)."""
    b, kvh = q.shape[:2]
    c_out, info = nsa_decode.decode_select_plain(
        q, ckv, mem_kv, t, num_cb, max_blocks=max_blocks, stride=stride,
        sel_block=sel_block, num_sel=num_sel, n_slide=n_slide, scale=scale,
        weights_dtype=torch.float32,
    )
    shifted = torch.cat([ring[:, :, 1:], kv_new.to(ring.dtype)], dim=2)
    if isinstance(t, torch.Tensor):
        slot = num_cb.clamp(max=ckv.shape[2] - 1)
        cand = emission_plain(shifted, t, pos_kv, w1k, b1k, w1v, b1v, w2, b2, ckv.dtype)
        kept = ckv.index_select(2, slot.long().reshape(1))[:, :, 0]
        write_row(ckv, slot, torch.where(emits(t, stride), cand, kept))
    elif emits(t, stride):
        ckv[:, :, num_cb] = emission_plain(shifted, t, pos_kv, w1k, b1k, w1v, b1v, w2, b2,
                                           ckv.dtype)
    ring.copy_(shifted)
    return c_out, info.reshape(b, kvh * INFO_WIDTH)


def decode_select_emit(q, ckv, ring, kv_new, mem_kv, pos_kv, w1k, b1k, w1v, b1v, w2, b2,
                       t, num_cb, *, max_blocks: int, stride: int, sel_block: int,
                       num_sel: int, n_slide: int,
                       scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [b, kvh, g, d] UNROTATED queries; ckv [b, kvh, Wc, 2d] and ring
    [b, kvh, Bc, 2d] caches (both updated in place); kv_new [b, kvh, 1, 2d]
    the new token's unrotated k||v; mem_kv [2, kvh, M, d]; pos_kv [kvh, Bc,
    2d] packed k_pos||v_pos; w1k, w1v [kvh, Bc*d, hid], b1k, b1v [kvh, hid],
    w2 [kvh, hid, 2d], b2 [kvh, 2d] the packed compressors; t the position
    (an int, or a 0-d int32 tensor on q's device), num_cb = t // stride (the
    plain version's; the kernel derives it, and whether the step emits, from
    t on the device).  Returns (c_out [b, kvh, g, d], info [b, kvh *
    INFO_WIDTH] int32)."""
    args = (q, ckv, ring, kv_new, mem_kv, pos_kv, w1k, b1k, w1v, b1v, w2, b2)
    kw = dict(max_blocks=max_blocks, stride=stride, sel_block=sel_block,
              num_sel=num_sel, n_slide=n_slide, scale=scale)
    if runtime.on_cpu(*args):
        return decode_select_emit_plain(*args, t, num_cb, **kw)
    b, kvh, g, d = q.shape
    Wc, Bc, M, hid = ckv.shape[2], ring.shape[2], mem_kv.shape[2], w1k.shape[2]
    npf = sel_block // stride
    if d != 64 or g not in (1, 2, 4, 8) or npf < 2 or Wc % npf or hid % EMIT_COLS \
            or 2 * num_sel + n_slide > INFO_WIDTH or (isinstance(t, int) and t // stride >= Wc):
        raise ValueError(f"decode_select_emit kernel takes dim_head 64, g in 1/2/4/8, "
                         f"sel_block/stride >= 2 dividing the ckv width and a compressor "
                         f"width divisible by {EMIT_COLS}; got d={d}, g={g}, npf={npf}, "
                         f"Wc={Wc}, hid={hid}, num_cb={num_cb}")
    from . import nsa_decode_ragged     # (it builds on this module's plain versions)

    bf, f32 = torch.bfloat16, torch.float32
    ptrs = [
        runtime.check("q", q, bf, (b, kvh, g, d)),
        runtime.check("ckv", ckv, bf, (b, kvh, Wc, 2 * d)),
        runtime.check("ring", ring, bf, (b, kvh, Bc, 2 * d)),
        runtime.check("kv_new", kv_new, bf, (b, kvh, 1, 2 * d)),
        runtime.check("mem_kv", mem_kv, bf, (2, kvh, M, d)),
        runtime.check("pos_kv", pos_kv, bf, (kvh, Bc, 2 * d)),
        runtime.check("w1k", w1k, bf, (kvh, Bc * d, hid)),
        runtime.check("b1k", b1k, f32, (kvh, hid)),
        runtime.check("w1v", w1v, bf, (kvh, Bc * d, hid)),
        runtime.check("b1v", b1v, f32, (kvh, hid)),
        runtime.check("w2", w2, bf, (kvh, hid, 2 * d)),
        runtime.check("b2", b2, f32, (kvh, 2 * d)),
    ]
    nsa_decode_ragged.check_plan("decode_select_emit",
                                 nsa_decode_ragged.device_emit_plan(q, ring, w1k))
    pos = runtime.device_position(t, q)
    c_out = torch.empty_like(q)
    info = torch.empty((b, kvh * INFO_WIDTH), dtype=torch.int32, device=q.device)
    # per (head, hidden chunk) partial sums of the compressor's second layer
    # (written on emitting steps, which the kernel decides)
    partial = torch.empty((kvh, hid // EMIT_COLS, b, 2 * d), dtype=f32, device=q.device)
    with torch.cuda.device(q.device):
        runtime.library().call(
            "nsa_decode_select_emit", *ptrs, pos.data_ptr(), c_out.data_ptr(), info.data_ptr(),
            partial.data_ptr(), b, kvh, g, Wc, M, Bc, hid, stride, sel_block,
            num_sel, n_slide, max_blocks, INFO_WIDTH, scale, runtime.stream_of(q),
        )
    decode_select_emit.launches += 1
    return c_out, info


decode_select_emit.launches = 0


def ff_tail_plain(y32, dtype, norm_scale, w1, b1, w2, b2, eps: float):
    """``_ff_tail``: the FF over the float32 stream y32 [b, dim], op for op;
    returns ``y + FF(norm(y))`` in float32, with y rounded to ``dtype``."""
    y16 = y32.to(dtype)
    yf = y16.float()
    var = yf.square().mean(dim=-1, keepdim=True)
    normed = (yf * torch.rsqrt(var + eps) * norm_scale.float()).to(dtype)
    h = (normed.float() @ w1.float()).to(dtype) + b1.to(dtype)
    hf = h.float()
    h = (0.5 * hf * (1.0 + torch.erf(hf * 0.7071067811865476))).to(dtype)
    o = (h.float() @ w2.float()).to(dtype) + b2.to(dtype)
    return (y16 + o).float()


def attend_out_plain(rq, kv, info, c_out, gates, x, w_out, t, ff=(), *, sel_block: int,
                     window: int, num_sel: int, n_slide: int, scale: float,
                     eps: float = 1e-6, page_table=None) -> torch.Tensor:
    """``decode_attend_fused``'s plain body after the kv row write: the
    attention over the cache (or page pool), the projection summed over the
    heads in order, the residual and the FF.  ``t`` is an int or a [b]
    tensor."""
    b, kvh, g, d = rq.shape
    comb = nsa_decode.attend_combined_plain(
        rq, kv, info.reshape(b, kvh, INFO_WIDTH), c_out, gates, t, sel_block=sel_block,
        window=window, num_sel=num_sel, n_slide=n_slide, scale=scale,
        weights_dtype=torch.float32, page_table=page_table,
    ).to(kv.dtype).float()
    y = x[:, 0].float()
    for h in range(kvh):     # the heads' projections, summed in order
        y = y + comb[:, h].reshape(b, g * d) @ w_out[h * g * d:(h + 1) * g * d].float()
    if ff:
        y = ff_tail_plain(y, x.dtype, *ff, eps=eps)
    return y.to(x.dtype)[:, None]


def combined_plain(rq, kv, info, c_out, gates, t, page_table, *, sel_block, window, num_sel,
                   n_slide, scale, eps):
    """The plain combined attention output, rounded to the cache dtype: what
    the attend kernels write to ``attn_out``.  ``t`` is an int or a [b]
    tensor."""
    b, kvh = rq.shape[:2]
    return nsa_decode.attend_combined_plain(
        rq, kv, info.reshape(b, kvh, INFO_WIDTH), c_out, gates, t, sel_block=sel_block,
        window=window, num_sel=num_sel, n_slide=n_slide, scale=scale,
        weights_dtype=torch.float32, page_table=page_table).to(kv.dtype)


def decode_attend_fused_plain(rq, kv, kv_new, info, c_out, gates, x, w_out, t,
                              ff=(), *, sel_block: int, window: int, num_sel: int,
                              n_slide: int, scale: float, eps: float = 1e-6) -> torch.Tensor:
    """The plain PyTorch version of ``decode_attend_fused`` (``t`` an int or
    a 0-d tensor)."""
    write_row(kv, t, kv_new[:, :, 0])
    return attend_out_plain(rq, kv, info, c_out, gates, x, w_out, t, ff, sel_block=sel_block,
                            window=window, num_sel=num_sel, n_slide=n_slide, scale=scale,
                            eps=eps)


def decode_attend_fused(rq, kv, kv_new, info, c_out, gates, x, w_out, t, ff=(), *,
                        sel_block: int, window: int, num_sel: int, n_slide: int,
                        scale: float, eps: float = 1e-6, attn_out=None,
                        phase_ns=None) -> torch.Tensor:
    """rq [b, kvh, g, d] rotated queries; kv [b, kvh, max_len, 2d] packed
    k||v cache (row t written in place; t an int or a 0-d int32 tensor on
    rq's device, which the kernel reads there); kv_new [b, kvh, 1, 2d] the new
    token's rotated-k||v; info [b, kvh * INFO_WIDTH] and c_out [b, kvh, g, d]
    from ``decode_select_emit``; gates [b, kvh, g, 3]; x [b, 1, dim] the
    residual stream; w_out [kvh * g * d, dim]; ff () or the gelu FF's
    (norm_scale, w1, b1, w2, b2).  Returns ``x + attn`` [b, 1, dim] in
    x.dtype, with the FF block applied when ``ff`` is given.  For checks and
    measurements, as ``decode_attend_fused_ragged`` takes them: with
    ``attn_out`` ([b, kvh, g, d] bf16) the combined attention output,
    rounded as the projection takes it, is written there too; ``phase_ns``
    (5 int64 on the card, not written on the CPU) receives the card's
    global timer at the kernel's start, after each grid sync, and where the
    block holding the last product's first tile ends."""
    kw = dict(sel_block=sel_block, window=window, num_sel=num_sel, n_slide=n_slide,
              scale=scale, eps=eps)
    ff = tuple(ff)
    if runtime.on_cpu(rq, kv, kv_new, info, c_out, gates, x, w_out, *ff):
        out = decode_attend_fused_plain(rq, kv, kv_new, info, c_out, gates, x, w_out, t, ff,
                                        **kw)
        if attn_out is not None:
            attn_out.copy_(combined_plain(rq, kv, info, c_out, gates, t, None, **kw))
        return out
    from . import nsa_decode_ragged     # (it builds on this module's plain versions)

    out = nsa_decode_ragged.attend_call("nsa_decode_attend_fused", rq, kv, None, kv_new, info,
                                        c_out, gates, x, w_out, t, ff, attn_out, phase_ns, **kw)
    decode_attend_fused.launches += 1
    return out


decode_attend_fused.launches = 0
