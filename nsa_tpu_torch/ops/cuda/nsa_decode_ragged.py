"""The ragged decode-step kernels of the serving engine
(``nsa_tpu/ops/pallas/nsa_decode_fused.py``, one position per row): the
fused pair of ``nsa_decode_fused.py`` with the position ``t`` and the
compressed-row count ``num_cb`` as [b] int32 tensors on the device, so that
every slot of the engine's pool decodes at its own length, and the attend
kernel over a paged kv pool.

* ``decode_select_emit_ragged`` — ``decode_select_emit`` at per-row
  positions: each row emits (into ``ckv[min(num_cb, Wc - 1)]``) exactly
  when its own step completes a compressed block.
* ``decode_attend_fused_ragged`` — ``decode_attend_fused`` writing each
  row's new kv row at its own ``t``.
* ``decode_attend_fused_paged`` — the same over a page pool [P, kvh, PAGE,
  2d] addressed through a page table [b, max_pages]: logical row r of
  batch row i lives in page ``page_table[i, r // PAGE]`` at row ``r % PAGE``.

Each wrapper launches its CUDA kernel (``csrc/nsa_decode_ragged.cu``) for
CUDA tensors, raises on what the kernel does not take, and runs the plain
PyTorch version beside it for CPU tensors.  The select-emit kernel's
emission runs on the tensor cores, one block per (KV head, half, 64
compressor hidden columns) (``emit_plan`` gives its shared memory; the
wrapper raises when it does not fit).  The two attend kernels are one
cooperative launch of one block per SM that holds column tiles of w_out and
the FF's matrices in shared memory (``attend_plan`` gives the sizes; the
wrapper raises when they do not fit).  ``decode_select_emit`` and
``decode_attend_fused`` launch the same designs at one device position, under
the same plans (``attend_call`` checks and launches all three attends).
Neither ragged kernel reads a position back
to the host: the kernels decide per row on the device, and the plain
versions compute every row's candidate and keep it where the row's
position says so, at the scalar plain versions' rounding points.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import nsa_decode, runtime
from .nsa_decode import INFO_WIDTH
from .nsa_decode_fused import EMIT_COLS, attend_out_plain, combined_plain, emission_plain


def ragged_emits(t: torch.Tensor, num_cb: torch.Tensor, stride: int) -> torch.Tensor:
    """[b] bool: whether each row's step completes a compressed block (JAX's
    ``run_fill + 1 == Bc``)."""
    return t - num_cb * stride + 1 == stride


# the tensor-core emission body (csrc/decode_tc_common.cuh): w1 stages in
# its ring, w1 rows a stage holds, batch rows of its mma tile
EMIT_STAGES, EMIT_KTILE, ROW_TILE = 8, 64, 16
EMIT_ALIGN = 1024   # the alignment of its shared memory (the 128-byte swizzle's boxes)
STATIC_SMEM = 256   # a bound on the static shared memory of the kernels with a plan


def emit_tc_smem_bytes(Bc: int, d: int = 64) -> int:
    """Shared memory of the tensor-core emission body at a window of Bc
    rows: its w1 stages, w2's tile, the 16-row window tile [16][Bc d + 8]
    and the hidden tile [16][72], in bf16."""
    K = Bc * d
    return (EMIT_STAGES * EMIT_KTILE * EMIT_COLS * 2 + EMIT_COLS * d * 2
            + ROW_TILE * (K + 8) * 2 + ROW_TILE * (EMIT_COLS + 8) * 2)


EMIT_PLAN_KEYS = ("blocks", "smem_bytes", "smem_optin")


def emit_plan(b: int, kvh: int, Bc: int, hid: int, smem_optin: int) -> dict:
    """The emission launch of ``decode_select_emit_ragged`` (and of
    ``decode_select_emit`` on its emitting steps, which takes less shared
    memory: no row list): one block per
    (KV head, half, 64 compressor hidden columns), each taking 1024 bytes of
    alignment slack (its swizzled TMA boxes start on a 1024-byte boundary),
    the body's shared memory and the list of the b rows; ``fits`` when that
    and the kernel's static shared memory stay within ``smem_optin``, the
    card's limit a block."""
    smem = EMIT_ALIGN + emit_tc_smem_bytes(Bc) + 4 * b
    return {"blocks": kvh * 2 * (hid // EMIT_COLS), "smem_bytes": smem, "smem_optin": smem_optin,
            "fits": smem + STATIC_SMEM <= smem_optin}


def check_plan(name: str, plan: dict) -> dict:
    """Raise when a launch plan does not fit the card (no fallback)."""
    if not plan["fits"]:
        raise ValueError(f"{name} kernel: a block needs {plan['smem_bytes']} bytes of shared "
                         f"memory and {STATIC_SMEM} of static; the card allows "
                         f"{plan['smem_optin']} ({plan})")
    return plan


@functools.lru_cache(maxsize=None)
def _device_emit_plan(device: int, b: int, kvh: int, Bc: int, hid: int) -> dict:
    out = (ctypes.c_int * len(EMIT_PLAN_KEYS))()
    with torch.cuda.device(device):
        runtime.library().call("nsa_decode_emit_plan", b, kvh, Bc, hid, ctypes.addressof(out))
    vals = dict(zip(EMIT_PLAN_KEYS, out))
    return {**vals, "fits": vals["smem_bytes"] + STATIC_SMEM <= vals["smem_optin"]}


def device_emit_plan(q, ring, w1k) -> dict:
    """``emit_plan`` as the kernel's C entry computes it on q's card."""
    return dict(_device_emit_plan(q.device.index, q.shape[0], q.shape[1], ring.shape[2],
                                  w1k.shape[2]))


def decode_select_emit_ragged_plain(q, ckv, ring, kv_new, mem_kv, pos_kv, w1k, b1k, w1v, b1v,
                                    w2, b2, t, num_cb, *, max_blocks: int, stride: int,
                                    sel_block: int, num_sel: int, n_slide: int,
                                    scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of ``decode_select_emit_ragged``."""
    b, kvh = q.shape[:2]
    c_out, info = nsa_decode.decode_select_plain(
        q, ckv, mem_kv, t, num_cb, max_blocks=max_blocks, stride=stride,
        sel_block=sel_block, num_sel=num_sel, n_slide=n_slide, scale=scale,
        weights_dtype=torch.float32,
    )
    shifted = torch.cat([ring[:, :, 1:], kv_new.to(ring.dtype)], dim=2)
    cand = emission_plain(shifted, t, pos_kv, w1k, b1k, w1v, b1v, w2, b2, ckv.dtype)
    rows = torch.arange(b, device=q.device)
    slot = num_cb.long().clamp(0, ckv.shape[2] - 1)
    emit = ragged_emits(t, num_cb, stride)[:, None, None]
    ckv[rows, :, slot] = torch.where(emit, cand, ckv[rows, :, slot])
    ring.copy_(shifted)
    return c_out, info.reshape(b, kvh * INFO_WIDTH)


def decode_select_emit_ragged(q, ckv, ring, kv_new, mem_kv, pos_kv, w1k, b1k, w1v, b1v, w2, b2,
                              t, num_cb, *, max_blocks: int, stride: int, sel_block: int,
                              num_sel: int, n_slide: int,
                              scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """As ``decode_select_emit``, with t and num_cb [b] int32 (one position
    per row).  q [b, kvh, g, d] UNROTATED; ckv and ring updated in place.
    Returns (c_out [b, kvh, g, d], info [b, kvh * INFO_WIDTH] int32)."""
    args = (q, ckv, ring, kv_new, mem_kv, pos_kv, w1k, b1k, w1v, b1v, w2, b2, t, num_cb)
    kw = dict(max_blocks=max_blocks, stride=stride, sel_block=sel_block,
              num_sel=num_sel, n_slide=n_slide, scale=scale)
    if runtime.on_cpu(*args):
        return decode_select_emit_ragged_plain(*args, **kw)
    b, kvh, g, d = q.shape
    Wc, Bc, M, hid = ckv.shape[2], ring.shape[2], mem_kv.shape[2], w1k.shape[2]
    npf = sel_block // stride
    if d != 64 or g not in (1, 2, 4, 8) or npf < 2 or Wc % npf or hid % EMIT_COLS \
            or 2 * num_sel + n_slide > INFO_WIDTH:
        raise ValueError(f"decode_select_emit_ragged kernel takes dim_head 64, g in 1/2/4/8, "
                         f"sel_block/stride >= 2 dividing the ckv width and a compressor "
                         f"width divisible by {EMIT_COLS}; got d={d}, g={g}, npf={npf}, "
                         f"Wc={Wc}, hid={hid}")
    bf, f32, i32 = torch.bfloat16, torch.float32, torch.int32
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
        runtime.check("t", t, i32, (b,)),
        runtime.check("num_cb", num_cb, i32, (b,)),
    ]
    check_plan("decode_select_emit_ragged", device_emit_plan(q, ring, w1k))
    c_out = torch.empty_like(q)
    info = torch.empty((b, kvh * INFO_WIDTH), dtype=i32, device=q.device)
    # per (head, hidden chunk) partial sums of the emitting rows' compressor
    partial = torch.empty((kvh, hid // EMIT_COLS, b, 2 * d), dtype=f32, device=q.device)
    with torch.cuda.device(q.device):
        runtime.library().call(
            "nsa_decode_select_emit_ragged", *ptrs, c_out.data_ptr(), info.data_ptr(),
            partial.data_ptr(), b, kvh, g, Wc, M, Bc, hid, stride, sel_block, num_sel, n_slide,
            max_blocks, INFO_WIDTH, scale, runtime.stream_of(q),
        )
    decode_select_emit_ragged.launches += 1
    return c_out, info


decode_select_emit_ragged.launches = 0


def decode_attend_fused_ragged_plain(rq, kv, kv_new, info, c_out, gates, x, w_out, t, ff=(), *,
                                     sel_block: int, window: int, num_sel: int, n_slide: int,
                                     scale: float, eps: float = 1e-6) -> torch.Tensor:
    """The plain PyTorch version of ``decode_attend_fused_ragged``."""
    rows = torch.arange(rq.shape[0], device=rq.device)
    kv[rows, :, t.long()] = kv_new[:, :, 0].to(kv.dtype)
    return attend_out_plain(rq, kv, info, c_out, gates, x, w_out, t, ff, sel_block=sel_block,
                            window=window, num_sel=num_sel, n_slide=n_slide, scale=scale,
                            eps=eps)


def decode_attend_fused_paged_plain(rq, kv_pool, page_table, kv_new, info, c_out, gates, x,
                                    w_out, t, ff=(), *, sel_block: int, window: int,
                                    num_sel: int, n_slide: int, scale: float,
                                    eps: float = 1e-6) -> torch.Tensor:
    """The plain PyTorch version of ``decode_attend_fused_paged``."""
    page = kv_pool.shape[2]
    tl = t.long()
    pages = page_table.long().gather(1, (tl // page)[:, None])[:, 0]
    kv_pool[pages, :, tl % page] = kv_new[:, :, 0].to(kv_pool.dtype)
    return attend_out_plain(rq, kv_pool, info, c_out, gates, x, w_out, t, ff,
                            sel_block=sel_block, window=window, num_sel=num_sel,
                            n_slide=n_slide, scale=scale, eps=eps, page_table=page_table)


def without_first_selected(info, num_sel: int, n_slide: int) -> torch.Tensor:
    """info [b, kvh * INFO_WIDTH] with each (row, KV head)'s first valid
    selected block marked invalid: the selections of a kernel that left one
    block out of the fine branch of every row that has one.  The control the
    attend kernels' gates must fail."""
    b = info.shape[0]
    rows = info.reshape(b, -1, INFO_WIDTH).clone()
    v0 = num_sel + n_slide
    valid = rows[..., v0:v0 + num_sel] != 0
    first = torch.zeros_like(valid).scatter_(-1, valid.int().argmax(-1, keepdim=True), True)
    rows[..., v0:v0 + num_sel] = (valid & ~first).int()
    return rows.reshape(b, -1)


def attend_tolerance(rq, kv, info, c_out, gates, t, *, sel_block: int, window: int,
                     num_sel: int, n_slide: int, scale: float, page_table=None):
    """The rule that holds the attend kernels' combined attention output
    (``attn_out``) to the plain version's, element by element: returns (the
    plain output rounded to the cache dtype, the bound).  2^-7 of |plain| for
    the two bf16 roundings (2 x 2^-9), plus 2^-15 of the same combine taken
    over absolute values (|g_c c_out| + |g_f| fine(|v|) + |g_s| sliding(|v|))
    for the float32 sums of up to (num_sel + n_slide) * sel_block terms in
    another order (144 x 2^-24 = 2^-16.8 of it at the reference model); each
    term twice its source.  ``kv`` holds each row's new row t."""
    b, kvh, g, d = rq.shape
    kw = dict(sel_block=sel_block, window=window, num_sel=num_sel, n_slide=n_slide, scale=scale,
              weights_dtype=torch.float32, page_table=page_table)
    rows = info.reshape(b, kvh, INFO_WIDTH)
    plain = nsa_decode.attend_combined_plain(rq, kv, rows, c_out, gates, t, **kw).to(kv.dtype)
    abs_v = torch.cat([kv[..., :d], kv[..., d:].abs()], dim=-1)
    mag = nsa_decode.attend_combined_plain(rq, abs_v, rows, c_out.abs(), gates.abs(), t, **kw)
    return plain, 2.0 ** -7 * plain.float().abs() + 2.0 ** -15 * mag


def select_tolerance(q, ckv, mem_kv, t, num_cb, *, stride: int, sel_block: int, scale: float):
    """The rule that holds the select kernels' compressed output (c_out) to
    the plain version's, element by element: returns (the plain c_out with
    float32 softmax weights, rounded to q's dtype as the kernels round it,
    the bound).  2^-7 of |plain| for the two bf16 roundings, plus 2^-15 of
    the same softmax's weighted sum over |v| (mem slots included) for the
    float32 sums of up to num_cb + M terms in another order (512 x 2^-24 =
    2^-15 of it at the reference model's 499 rows); each term twice its
    source.  A c_out whose weights were rounded to bf16 (the XLA path's
    ``decode_select_plain``) departs by up to 2^-9 of that sum and breaks it."""
    d = q.shape[-1]
    kw = dict(stride=stride, sel_block=sel_block, scale=scale, weights_dtype=torch.float32)
    plain, _ = nsa_decode.select_scores_plain(q, ckv, mem_kv, num_cb, t, **kw)
    abs_ckv = torch.cat([ckv[..., :d], ckv[..., d:].abs()], dim=-1)
    abs_mem = torch.stack([mem_kv[0], mem_kv[1].abs()])
    mag, _ = nsa_decode.select_scores_plain(q.float(), abs_ckv, abs_mem, num_cb, t, **kw)
    return plain, 2.0 ** -7 * plain.float().abs() + 2.0 ** -15 * mag


def without_live_chunk(ckv, num_cb: int, chunk: int = 0, rows: int = 64):
    """(ckv [b, kvh, Wc, 2d] with the live rows [chunk * rows, (chunk + 1) *
    rows) moved past the live ones, the live count that leaves): c_out over
    them is the c_out of a kernel that left that chunk out.  The control
    ``select_tolerance`` must fail."""
    lo, hi = chunk * rows, min((chunk + 1) * rows, num_cb)
    moved = torch.cat([ckv[:, :, :lo], ckv[:, :, hi:num_cb], ckv[:, :, lo:hi],
                       ckv[:, :, num_cb:]], dim=2)
    return moved, num_cb - (hi - lo)


PLAN_KEYS = ("grid", "blocks_per_sm", "slice_bytes", "slice_total", "work_bytes",
             "smem_bytes", "smem_optin")


@functools.lru_cache(maxsize=None)
def _attend_plan(device: int, kvh: int, g: int, dim: int, hid4: int, sel_block: int,
                 num_sel: int, n_slide: int, paged: bool) -> dict:
    out = (ctypes.c_int * len(PLAN_KEYS))()
    with torch.cuda.device(device):
        runtime.library().call("nsa_decode_attend_ragged_plan", 0, kvh, g, dim, hid4, sel_block,
                               num_sel, n_slide, int(paged), ctypes.addressof(out))
    return dict(zip(PLAN_KEYS, out))


def attend_plan(rq, dim: int, hid4: int, *, sel_block: int, num_sel: int, n_slide: int,
                paged: bool = False) -> dict:
    """The one-launch attend kernel's launch on rq's card (the ragged one,
    whose plan the one-position one shares, or the paged one): the grid (one
    block per SM), how many such blocks fit on an SM (0: the kernel refuses
    to launch), the largest block's and all blocks' bytes of weight tiles
    (w_out, ff w1, ff w2 in 8-column tiles), the work space and the shared
    memory a block takes, and the card's limit a block."""
    kvh, g = rq.shape[1], rq.shape[2]
    return dict(_attend_plan(rq.device.index, kvh, g, dim, hid4, sel_block, num_sel, n_slide,
                             paged))


PHASE_MARKS = 5     # phase_ns: the start, after each grid sync, the end (see the source)


def attend_call(name, rq, kv, page_table, kv_new, info, c_out, gates, x, w_out, t, ff,
                attn_out, phase_ns, *, sel_block, window, num_sel, n_slide, scale, eps):
    """Check the operands of the one-launch attend kernel and launch it: the
    ragged one (``t`` a [b] tensor), the paged one (``t`` a [b] tensor and
    ``page_table``) or the one-position one (``t`` an int or a 0-d int32
    tensor, read on the device; ``decode_attend_fused``).  Returns the layer
    output."""
    b, kvh, g, d = rq.shape
    dim = x.shape[-1]
    hid4 = ff[1].shape[1] if ff else 0
    d2 = kv.shape[-1]
    one_position = not isinstance(t, torch.Tensor) or t.dim() == 0
    if d != 64 or g not in (1, 2, 4, 8) or kv.shape[2] % sel_block or dim % 64 or hid4 % 64 \
            or (isinstance(t, int) and not 0 <= t < kv.shape[2]):
        raise ValueError(f"{name} kernel takes dim_head 64, g in 1/2/4/8, a cache length or "
                         f"page divisible by sel_block, model and FF widths divisible by 64 "
                         f"and a position in the cache; got d={d}, g={g}, rows={kv.shape[2]}, "
                         f"dim={dim}, ff hidden={hid4}, t={t if one_position else 'per row'}")
    bf, f32, i32 = torch.bfloat16, torch.float32, torch.int32
    ptrs = [runtime.check("rq", rq, bf, (b, kvh, g, d))]
    if page_table is None:
        ptrs.append(runtime.check("kv", kv, bf, (b, kvh, None, 2 * d)))
    else:
        ptrs += [runtime.check("kv_pool", kv, bf, (None, kvh, None, 2 * d)),
                 runtime.check("page_table", page_table, i32, (b, None))]
    ptrs += [
        runtime.check("kv_new", kv_new, bf, (b, kvh, 1, d2)),
        runtime.check("info", info, i32, (b, kvh * INFO_WIDTH)),
        runtime.check("c_out", c_out, bf, (b, kvh, g, d)),
        runtime.check("gates", gates, bf, (b, kvh, g, 3)),
        runtime.check("x", x, bf, (b, 1, dim)),
        runtime.check("w_out", w_out, bf, (kvh * g * d, dim)),
    ]
    if ff:
        norm_scale, w1, b1, w2, b2 = ff
        ptrs += [
            runtime.check("ff norm_scale", norm_scale, f32, (dim,)),
            runtime.check("ff w1", w1, bf, (dim, hid4)),
            runtime.check("ff b1", b1, f32, (hid4,)),
            runtime.check("ff w2", w2, bf, (hid4, dim)),
            runtime.check("ff b2", b2, f32, (dim,)),
        ]
    else:
        ptrs += [0] * 5
    pos = runtime.device_position(t, rq) if one_position else t    # alive until the launch
    ptrs.append(pos.data_ptr() if one_position else runtime.check("t", t, i32, (b,)))
    plan = attend_plan(rq, dim, hid4, sel_block=sel_block, num_sel=num_sel, n_slide=n_slide,
                       paged=page_table is not None)
    if plan["blocks_per_sm"] < 1:
        raise ValueError(
            f"{name} kernel: a block of its {plan['grid']} needs {plan['smem_bytes']} bytes of "
            f"shared memory ({plan['slice_bytes']} of weight tiles, the largest share of "
            f"{plan['slice_total']}, and {plan['work_bytes']} of work space); the card "
            f"allows {plan['smem_optin']}")
    if attn_out is None:        # the rounded attention output, between phases (a) and (b)
        attn_out = torch.empty_like(rq)
    ptrs.append(runtime.check("attn_out", attn_out, bf, (b, kvh, g, d)))
    marks = 0 if phase_ns is None else runtime.check("phase_ns", phase_ns, torch.int64,
                                                     (PHASE_MARKS,))
    y = torch.empty_like(x)                                            # x + attn, rounded
    hbuf = torch.empty((b, max(hid4, 1)), dtype=bf, device=rq.device)  # the FF's hidden rows
    out = torch.empty_like(x)
    rows = ((kv.shape[2],) if page_table is None
            else (kv.shape[2], page_table.shape[1]))       # max_len | page, max_pages
    with torch.cuda.device(rq.device):
        runtime.library().call(
            name, *ptrs, y.data_ptr(), hbuf.data_ptr(), out.data_ptr(), marks, b, kvh, g, *rows,
            dim, hid4, sel_block, window, num_sel, n_slide,
            INFO_WIDTH, scale, eps, runtime.stream_of(rq),
        )
    return out


def decode_attend_fused_ragged(rq, kv, kv_new, info, c_out, gates, x, w_out, t, ff=(), *,
                               sel_block: int, window: int, num_sel: int, n_slide: int,
                               scale: float, eps: float = 1e-6, attn_out=None,
                               phase_ns=None) -> torch.Tensor:
    """As ``decode_attend_fused``, with t [b] int32 (one position per row):
    row t[i] of batch row i of kv [b, kvh, max_len, 2d] is written in place.
    Returns ``x + attn`` [b, 1, dim], with the FF applied when given.  For
    checks and measurements: with ``attn_out`` ([b, kvh, g, d] bf16) the
    combined attention output, rounded as the projection takes it, is
    written there too; ``phase_ns`` (5 int64 on the card, not written on the
    CPU) receives the card's global timer at the kernel's start, after each
    grid sync, and where the block holding the last product's first tile
    ends."""
    kw = dict(sel_block=sel_block, window=window, num_sel=num_sel, n_slide=n_slide,
              scale=scale, eps=eps)
    ff = tuple(ff)
    if runtime.on_cpu(rq, kv, kv_new, info, c_out, gates, x, w_out, t, *ff):
        out = decode_attend_fused_ragged_plain(rq, kv, kv_new, info, c_out, gates, x, w_out, t,
                                               ff, **kw)
        if attn_out is not None:
            attn_out.copy_(combined_plain(rq, kv, info, c_out, gates, t, None, **kw))
        return out
    out = attend_call("nsa_decode_attend_fused_ragged", rq, kv, None, kv_new, info, c_out,
                      gates, x, w_out, t, ff, attn_out, phase_ns, **kw)
    decode_attend_fused_ragged.launches += 1
    return out


decode_attend_fused_ragged.launches = 0


def decode_attend_fused_paged(rq, kv_pool, page_table, kv_new, info, c_out, gates, x, w_out, t,
                              ff=(), *, sel_block: int, window: int, num_sel: int, n_slide: int,
                              scale: float, eps: float = 1e-6, attn_out=None,
                              phase_ns=None) -> torch.Tensor:
    """``decode_attend_fused_ragged`` over a page pool kv_pool [P, kvh, PAGE,
    2d] and page_table [b, max_pages] int32 (PAGE a multiple of sel_block
    and 8): row t[i] goes to page ``page_table[i, t[i] // PAGE]`` in place."""
    kw = dict(sel_block=sel_block, window=window, num_sel=num_sel, n_slide=n_slide,
              scale=scale, eps=eps)
    ff = tuple(ff)
    page = kv_pool.shape[2]
    if page % sel_block or page % 8:
        raise ValueError(f"the page ({page} rows) must be a multiple of sel_block and 8")
    if runtime.on_cpu(rq, kv_pool, page_table, kv_new, info, c_out, gates, x, w_out, t, *ff):
        out = decode_attend_fused_paged_plain(rq, kv_pool, page_table, kv_new, info, c_out,
                                              gates, x, w_out, t, ff, **kw)
        if attn_out is not None:
            attn_out.copy_(combined_plain(rq, kv_pool, info, c_out, gates, t, page_table, **kw))
        return out
    out = attend_call("nsa_decode_attend_fused_paged", rq, kv_pool, page_table, kv_new, info,
                      c_out, gates, x, w_out, t, ff, attn_out, phase_ns, **kw)
    decode_attend_fused_paged.launches += 1
    return out


decode_attend_fused_paged.launches = 0
