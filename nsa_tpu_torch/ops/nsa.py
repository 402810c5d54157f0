"""The Native Sparse Attention layer (``nsa_tpu/ops/nsa.py``): three
branches under a learned sigmoid gate.

* branch 1: compressed attention over GroupedMLP compressions of
  overlapping K/V windows plus one learned mem slot; its logits double as
  block-importance scores;
* branch 2: fine attention over the top-k selected blocks united with the
  block-causal diagonal;
* branch 3: sliding-window attention.

As in the JAX package: compression inputs and the compressed-branch queries
are never rotated; the gate bias starts at ``[-2, -2, 2]``; decode masks the
diagonal block exactly as prefill does, so prefill and incremental decode
agree.

The prefill and training run branches 2 and 3 in one forward kernel and
two backward kernels (``ops/cuda/nsa_prefill.py``).  The decode step takes
one of two routes, as in the JAX package: at b <= 8 the fused pair
``decode_select_emit`` + ``decode_attend_fused`` (``ops/cuda/nsa_decode_fused.py``)
runs the whole layer, the FF included; above that the split pair
``decode_select`` + ``decode_attend`` (``ops/cuda/nsa_decode.py``) with the
cache writes, emission, projection and FF as separate ops.  The ragged
step of the serving engine (one position per row, ``t`` a [b] tensor)
takes the ragged fused pair at every batch size
(``ops/cuda/nsa_decode_ragged.py``; over a paged kv pool with a page
table), or, forced to the split route, JAX's XLA branches with the block
gather as a kernel (``ops/cuda/paged_gather.py``).  The
port covers the configuration those kernels take: causal, query heads
sharing their KV head's selection, ``selection_block_size / stride > 1``,
the ``mlp`` compressor.  Other configurations raise ``NotImplementedError``
(see ``ROADMAP.md``).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..config import ModelConfig
from .attention import attend
from ..utils.checkpoint import tree_to
from .common import merge_heads, rms_norm, round_down_mult, round_up_mult, split_heads
from .compress import apply_compressor, split_compress_windows
from .cuda.nsa_decode import (
    attend_combined_plain,
    decode_attend,
    decode_attend_plain,
    decode_select,
    decode_select_plain,
    per_row,
)
from .cuda.nsa_decode_fused import (
    decode_attend_fused,
    decode_attend_fused_plain,
    decode_select_emit,
    decode_select_emit_plain,
)
from .cuda.nsa_decode_ragged import (
    decode_attend_fused_paged,
    decode_attend_fused_paged_plain,
    decode_attend_fused_ragged,
    decode_attend_fused_ragged_plain,
    decode_select_emit_ragged,
    decode_select_emit_ragged_plain,
    ragged_emits,
)
from .cuda.nsa_prefill import nsa_fine_sliding_attention
from .cuda.paged_gather import paged_gather, paged_gather_plain
from .rotary import rotate_at_offset, rotate_at_row_offsets, rotate_qk
from .selection import fine_block_scores, group_importance, select_blocks


class NSADecodeCache(NamedTuple):
    """Per-layer structured sparse KV cache; K and V packed on the feature
    axis (``[..., :d]`` key, ``[..., d:]`` value).

    Live lengths follow from the model-level position ``t``:
    ``num_cb = t // stride`` compressed rows are live in ``ckv``; ``ring``
    holds the last ``compress_block_size`` UNROTATED tokens (slot j =
    position t - Bc + j), the window the next compressed block is made of.
    The decode step writes ``kv`` and ``ckv`` in place.
    """

    kv: torch.Tensor      # [b, kvh, max_len, 2d]      rotated k ++ v
    ckv: torch.Tensor     # [b, kvh, ckv_width, 2d]    compressed k ++ v
    ring: torch.Tensor    # [b, kvh, Bc, 2d]           last Bc unrotated k ++ v


def _ckv_width(max_len: int, stride: int, npf: int) -> int:
    """Rows of the compressed cache: ``max_len // stride`` data rows plus
    spare rows, the last of which is the trash row that non-emission decode
    steps write their discarded candidate into; a multiple of npf and 8."""
    npf = max(npf, 1)
    unit = npf * 8 // math.gcd(npf, 8)
    return round_up_mult(max_len // stride + npf, unit)


def _check_supported(cfg: ModelConfig) -> None:
    nsa = cfg.nsa
    if not (cfg.causal and nsa.query_heads_share_selected_kv
            and nsa.num_compress_per_fine > 1):
        raise NotImplementedError(
            "the port implements causal NSA with shared selection and "
            "selection_block_size / stride > 1 (see ROADMAP.md)"
        )


def init_sparse_attention(cfg: ModelConfig, generator: torch.Generator,
                          device="cuda") -> dict:
    """Random parameters of one layer, in ``init_sparse_attention``'s layout
    and distributions (the numbers differ from JAX's for the same seed)."""
    nsa = cfg.nsa
    d, h, kvh = cfg.dim_head, cfg.heads, cfg.kv_heads

    def uniform(shape, fan_in):
        bound = 1.0 / fan_in ** 0.5
        return (torch.rand(shape, generator=generator) * 2 - 1) * bound

    def compressor():
        dim_in = d * nsa.compress_block_size
        hidden = int(dim_in * nsa.compress_mlp_expand_factor)
        return {
            "w1": uniform((kvh, dim_in, hidden), dim_in),
            "b1": uniform((kvh, hidden), dim_in),
            "w2": uniform((kvh, hidden, d), hidden),
            "b2": uniform((kvh, d), hidden),
        }

    params = {
        "norm_scale": torch.ones(cfg.dim),
        "w_q": uniform((cfg.dim, cfg.dim_inner), cfg.dim),
        "w_k": uniform((cfg.dim, cfg.dim_kv_inner), cfg.dim),
        "w_v": uniform((cfg.dim, cfg.dim_kv_inner), cfg.dim),
        "mem_kv": torch.zeros(2, kvh, nsa.num_compressed_mem_kv, d),
        "k_pos": torch.zeros(kvh, nsa.compress_block_size, d),
        "v_pos": torch.zeros(kvh, nsa.compress_block_size, d),
        "k_compress": compressor(),
        "v_compress": compressor(),
        "gate_w": torch.zeros(cfg.dim, 3 * h),
        "gate_b": torch.tensor([-2.0, -2.0, 2.0]).repeat(h),
        "w_out": uniform((cfg.dim_inner, cfg.dim), cfg.dim_inner),
    }
    return tree_to(params, device)


def _compress_kv(params, cfg: ModelConfig, k_windows, v_windows):
    """Intra-block positions, then the K and V compressors:
    [b, kvh, w, Bc, d] -> [b, kvh, w, d] each."""
    kin = k_windows + params["k_pos"].to(k_windows.dtype)[None, :, None]
    vin = v_windows + params["v_pos"].to(v_windows.dtype)[None, :, None]
    ck = apply_compressor(params["k_compress"], cfg.nsa.compressor, kin)
    cv = apply_compressor(params["v_compress"], cfg.nsa.compressor, vin)
    return ck, cv


def _gate_combine(params, cfg: ModelConfig, normed, branch_outs):
    """Sigmoid gate over the three branch outputs [b, h, n, d]."""
    b, n, _ = normed.shape
    gates = torch.sigmoid(
        normed @ params["gate_w"].to(normed.dtype) + params["gate_b"].to(normed.dtype)
    )
    gates = gates.reshape(b, n, cfg.heads, 3).permute(0, 2, 1, 3)        # [b,h,n,3]
    stacked = torch.stack(branch_outs, dim=-1)                           # [b,h,n,d,3]
    out = (gates[..., None, :].float() * stacked.float()).sum(-1)
    return out.to(stacked.dtype)


def sparse_attention_forward(
    params, cfg: ModelConfig, x: torch.Tensor, *,
    return_cache_max_len: Optional[int] = None, use_kernels: bool = True,
    true_len=None,
):
    """Prefill / training forward. x: [b, n, dim] -> out [b, n, dim], or
    (out, NSADecodeCache) when ``return_cache_max_len`` is given.

    ``true_len`` (an int, or a [b] int tensor on x's device) marks the real
    prompt length of right-padded rows (the serving engine's bucketed
    prefill): the ring then holds each row's last ``compress_block_size``
    unrotated tokens ending at its own true length.  Nothing else changes:
    the pad rows are computed, and never read by a decode step at the true
    length, which overwrites them as it advances.

    Differentiable: the straight-through top-k gates go into the fine +
    sliding attention, so its ``d_gates`` reaches branch 1's logits, the
    compressors, ``mem_kv`` and the queries through the selection scores,
    as in the JAX package.  ``use_kernels=False`` runs the plain versions
    of the forward and backward kernels on any device (see
    ``sparse_attention_decode``)."""
    _check_supported(cfg)
    nsa = cfg.nsa
    b, n, _ = x.shape
    d, h, kvh = cfg.dim_head, cfg.heads, cfg.kv_heads
    g = cfg.num_grouped_queries
    scale = d ** -0.5
    stride = nsa.compress_block_sliding_stride
    num_mem = nsa.num_compressed_mem_kv
    Bs = nsa.selection_block_size
    dev = x.device

    compress_divisible = round_down_mult(n, stride)
    num_cblocks = compress_divisible // stride

    normed = rms_norm(x, params["norm_scale"], cfg.norm_eps)
    q = split_heads(normed @ params["w_q"].to(normed.dtype), d)     # [b, h, n, d]
    k = split_heads(normed @ params["w_k"].to(normed.dtype), d)     # [b, kvh, n, d]
    v = split_heads(normed @ params["w_v"].to(normed.dtype), d)

    # ---- branch 1 inputs: compressed K/V (unrotated) + mem slots ---------
    if num_cblocks > 0:
        kw = split_compress_windows(k[:, :, :compress_divisible], nsa.compress_block_size, stride)
        vw = split_compress_windows(v[:, :, :compress_divisible], nsa.compress_block_size, stride)
        ck, cv = _compress_kv(params, cfg, kw, vw)
    else:
        ck = k.new_zeros((b, kvh, 0, d))
        cv = v.new_zeros((b, kvh, 0, d))
    mem = params["mem_kv"].to(k.dtype)
    ck_full = torch.cat([mem[0][None].expand(b, kvh, num_mem, d), ck], dim=2)
    cv_full = torch.cat([mem[1][None].expand(b, kvh, num_mem, d), cv], dim=2)
    ck_ends = torch.cat([
        torch.full((num_mem,), -1, device=dev),
        (torch.arange(num_cblocks, device=dev) + 1) * stride - 1,
    ])

    rq, rk = rotate_qk(q, k, cfg.rope_theta)

    # ---- branch 1 + selection, chunked over queries ----------------------
    couts, idxs, msks, gts = [], [], [], []
    for c0 in range(0, n, cfg.attn_chunk_size):
        positions = torch.arange(c0, min(c0 + cfg.attn_chunk_size, n), device=dev)
        cmask = ck_ends[None, :] < positions[:, None]                # [m, mem+w]
        c_out, csim = attend(q[:, :, c0:c0 + len(positions)], ck_full, cv_full,
                             mask=cmask, scale=scale, return_sim=True)
        importance = group_importance(csim, num_mem, g, True)
        scores = fine_block_scores(importance, positions, Bs, stride)
        sel = select_blocks(scores, nsa.num_selected_blocks, nsa.use_diff_topk)
        couts.append(c_out)
        idxs.append(sel.indices)
        msks.append(sel.mask)
        gts.append(sel.gates)
    compressed_out = torch.cat(couts, dim=2)
    sel_idx = torch.cat(idxs, dim=2)
    sel_mask = torch.cat(msks, dim=2)
    gates = torch.cat(gts, dim=2) if nsa.use_diff_topk else None

    # ---- branches 2 + 3: the fused fine + sliding kernel -----------------
    fine_out, sliding_out = nsa_fine_sliding_attention(
        rq.contiguous(), rk.contiguous(), v.contiguous(), sel_idx, sel_mask, gates,
        Bs, nsa.sliding_window_size, scale, use_kernels=use_kernels,
    )

    out = _gate_combine(params, cfg, normed, [compressed_out, fine_out, sliding_out])
    out = merge_heads(out) @ params["w_out"].to(x.dtype)
    if return_cache_max_len is None:
        return out

    # ---- the decode cache -------------------------------------------------
    max_len = return_cache_max_len
    if max_len < n or max_len % stride or max_len % 8:
        raise ValueError(f"max_len {max_len} must be >= {n} and a multiple of "
                         f"{stride} and 8")
    Bc = nsa.compress_block_size

    def pad_to(t, size):
        return F.pad(t, (0, 0, 0, size - t.shape[2]))

    # ring: the last Bc unrotated tokens, right-aligned, zero on the left
    if true_len is None:
        lead = max(Bc - n, 0)
        ring = torch.cat([k[:, :, max(n - Bc, 0):], v[:, :, max(n - Bc, 0):]], dim=-1)
        ring = F.pad(ring, (0, 0, lead, 0))
    else:
        # slot j of row i holds position true_len[i] - Bc + j (+Bc for the
        # left pad)
        kv_unrot = F.pad(torch.cat([k, v], dim=-1), (0, 0, Bc, 0))
        tl = (torch.full((b,), true_len, device=dev) if isinstance(true_len, int)  # no copy
              else torch.as_tensor(true_len, device=dev).long().expand(b))
        pos = tl[:, None] + torch.arange(Bc, device=dev)                 # [b, Bc]
        ring = kv_unrot.gather(2, pos[:, None, :, None].expand(b, kvh, Bc, 2 * d))
    wc = _ckv_width(max_len, stride, nsa.num_compress_per_fine)
    cache = NSADecodeCache(
        kv=torch.cat([pad_to(rk, max_len), pad_to(v, max_len)], dim=-1),
        ckv=torch.cat([pad_to(ck, wc), pad_to(cv, wc)], dim=-1),
        ring=ring,
    )
    return out, cache


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int,
                      dtype=torch.float32, device="cuda") -> NSADecodeCache:
    """Empty per-layer cache for decoding from scratch."""
    nsa = cfg.nsa
    stride = nsa.compress_block_sliding_stride
    if max_len % stride or max_len % 8:
        raise ValueError(f"max_len {max_len} must be a multiple of {stride} and 8")

    def z(s):
        return torch.zeros((batch, cfg.kv_heads, s, 2 * cfg.dim_head), dtype=dtype,
                           device=device)

    return NSADecodeCache(
        kv=z(max_len),
        ckv=z(_ckv_width(max_len, stride, nsa.num_compress_per_fine)),
        ring=z(nsa.compress_block_size),
    )


# JAX's NSA_FUSED_DECODE_MAX_B default: the fused route's largest batch
FUSED_DECODE_MAX_B = 8


def _fused_decode_applies(cfg: ModelConfig) -> bool:
    nsa = cfg.nsa
    return (nsa.query_heads_share_selected_kv and nsa.num_compress_per_fine > 1
            and nsa.num_selected_blocks > 0 and nsa.compressor == "mlp")


def _use_fused_decode(cfg: ModelConfig, b: int) -> bool:
    """Whether the decode step takes the fused route by default: JAX's
    ``_use_fused_decode(...) and b <= NSA_FUSED_DECODE_MAX_B``.  JAX's
    further condition, batch tiles that Mosaic can lay out, holds for every
    b <= 8 and has no counterpart here."""
    return _fused_decode_applies(cfg) and b <= FUSED_DECODE_MAX_B


def _cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.to(dtype).contiguous()


def _pack_attn(attn: dict, dtype: torch.dtype) -> dict:
    kc, vc = attn["k_compress"], attn["v_compress"]
    f32 = torch.float32
    return {
        "w_qkvg": _cast(torch.cat([attn["w_q"], attn["w_k"], attn["w_v"], attn["gate_w"]], 1),
                        dtype),
        "pos_kv": _cast(torch.cat([attn["k_pos"], attn["v_pos"]], -1), dtype),
        "w1k": _cast(kc["w1"], dtype), "b1k": _cast(kc["b1"], f32),
        "w1v": _cast(vc["w1"], dtype), "b1v": _cast(vc["b1"], f32),
        "w2": _cast(torch.cat([kc["w2"], vc["w2"]], -1), dtype),
        "b2": _cast(torch.cat([kc["b2"], vc["b2"]], -1), f32),
        "mem_kv": _cast(attn["mem_kv"], dtype),
        "w_out": _cast(attn["w_out"], dtype),
    }


def _pack_ff(ff: dict, dtype: torch.dtype) -> dict:
    f32 = torch.float32
    return {"norm_scale": _cast(ff["norm_scale"], f32), "w1": _cast(ff["w1"], dtype),
            "b1": _cast(ff["b1"], f32), "w2": _cast(ff["w2"], dtype),
            "b2": _cast(ff["b2"], f32)}


def fuse_decode_layer(layer: dict, dtype: torch.dtype) -> dict:
    """A layer's decode weights packed once for the decode step
    (``fuse_decode_params``): ``attn["decode_fused"]`` holds the fused
    projection ``w_qkvg``, ``pos_kv = k_pos||v_pos``, the compressors'
    ``w1k``, ``w1v`` [kvh, Bc*d, hid] and ``w2 = w2_k||w2_v``, ``mem_kv``
    and ``w_out`` in ``dtype`` and the compressors' biases in float32;
    ``ff["decode_fused"]`` the FF's matrices in ``dtype`` and its norm scale
    and biases in float32.  Returns a new layer dict; the input is unchanged."""
    return {**layer,
            "attn": {**layer["attn"], "decode_fused": _pack_attn(layer["attn"], dtype)},
            "ff": {**layer["ff"], "decode_fused": _pack_ff(layer["ff"], dtype)}}


def ff_apply_gelu(ffp, cfg: ModelConfig, x):
    """The prenorm FF block: RMSNorm, then Linear-GELU(exact erf)-Linear with
    biases; the model's FF in prefill, and the decode step's when it is
    handed the FF params."""
    hid = rms_norm(x, ffp["norm_scale"], cfg.norm_eps)
    hid = F.gelu(hid @ ffp["w1"].to(hid.dtype) + ffp["b1"].to(hid.dtype))
    return hid @ ffp["w2"].to(hid.dtype) + ffp["b2"].to(hid.dtype)


def sparse_attention_decode(
    params, cfg: ModelConfig, x: torch.Tensor, cache: NSADecodeCache, t,
    ff_params=None, *, use_kernels: bool = True, route: Optional[str] = None,
    page_table: Optional[torch.Tensor] = None,
):
    """One decode step at position ``t`` (tokens already cached). x: [b, 1, dim].

    Returns ``(x + attn_out, cache)``: the updated residual stream, with the
    layer's FF block applied too when ``ff_params`` is given.  The caches
    (the ring too) are written in place at their own addresses; the
    returned cache holds the same tensors.

    ``t`` is every row's position, an int or a 0-d int32 tensor on x's
    device (a device position, as a captured decode step advances it), or
    a [b] int tensor there (the ragged step: row i at position t[i], as the
    serving engine's slots decode).  Nothing is read back to the host: an
    int is written to the device once, and the caller of a device position
    keeps it inside the cache.

    ``route``: ``None`` takes the fused pair at b <= 8 and the split pair
    above (JAX's default), and the ragged fused pair at every b for a
    ragged ``t``; ``"fused"`` or ``"split"`` forces one (JAX's
    ``NSA_FUSED_DECODE_MAX_B`` / ``NSA_NO_FUSED_DECODE``).  On the fused
    route the layer owns the FF: ``decode_attend_fused`` runs it.  Packed
    weights from ``fuse_decode_layer`` are used when present
    (``params["decode_fused"]``, ``ff_params["decode_fused"]``), else packed
    here.

    ``page_table`` [b, max_pages] int32 makes ``cache.kv`` a page pool [P,
    kvh, PAGE, 2d] shared by the rows (the paged serving engine): it needs a
    ragged ``t`` and the fused route, as in JAX.

    ``use_kernels=False`` runs the plain PyTorch versions of the route's
    kernels on any device, to hold the kernel path against them on the
    card; otherwise the wrappers choose (kernel on CUDA, plain version on
    the CPU).
    """
    _check_supported(cfg)
    nsa = cfg.nsa
    b = x.shape[0]
    d, h, kvh = cfg.dim_head, cfg.heads, cfg.kv_heads
    g = cfg.num_grouped_queries
    scale = d ** -0.5
    stride = nsa.compress_block_sliding_stride
    Bc = nsa.compress_block_size
    Bs = nsa.selection_block_size
    window = nsa.sliding_window_size
    n_slide = -(-window // Bs) + 1
    ragged = isinstance(t, torch.Tensor) and t.dim() == 1
    paged = page_table is not None
    max_len = page_table.shape[1] * cache.kv.shape[2] if paged else cache.kv.shape[2]
    if isinstance(t, int) and not 0 <= t < max_len:
        raise ValueError(f"position {t} is outside the cache of {max_len}")
    if route not in (None, "fused", "split"):
        raise ValueError(f"route must be None, 'fused' or 'split', got {route!r}")
    if route == "fused" and not _fused_decode_applies(cfg):
        raise ValueError("the fused decode route needs shared selection, selected "
                         "blocks and the mlp compressor")
    if route is None:
        fused = _fused_decode_applies(cfg) if ragged else _use_fused_decode(cfg, b)
    else:
        fused = route == "fused"
    if paged and not (ragged and fused):
        raise NotImplementedError("paged KV decode requires ragged positions and the fused "
                                  "route (mlp compressor, shared-KV selection)")
    if isinstance(t, torch.Tensor):
        t = t.to(device=x.device, dtype=torch.int32)
    else:                       # one device position for the whole step
        t = torch.full((), t, dtype=torch.int32, device=x.device)
    num_cb = t // stride

    fp = params.get("decode_fused")
    if fp is None and fused:
        fp = _pack_attn(params, x.dtype)
    w_fused = (fp["w_qkvg"] if fp is not None else torch.cat(
        [params["w_q"], params["w_k"], params["w_v"], params["gate_w"]], dim=1
    )).to(x.dtype)

    normed = rms_norm(x, params["norm_scale"], cfg.norm_eps)
    proj = (normed @ w_fused)[:, 0]                 # [b, h*d + 2*kvh*d + 3h]
    hd, kd = cfg.dim_inner, cfg.dim_kv_inner
    q = proj[:, :hd].reshape(b, h, d)
    k_new = proj[:, hd:hd + kd].reshape(b, kvh, d)
    v_new = proj[:, hd + kd:hd + 2 * kd].reshape(b, kvh, d)
    gate_logits = proj[:, hd + 2 * kd:]
    kv_new = torch.cat([k_new, v_new], dim=-1)      # [b, kvh, 2d] unrotated

    rotate = rotate_at_row_offsets if ragged else rotate_at_offset
    rq = rotate(q[:, :, None], t, cfg.rope_theta)[:, :, 0]
    rk_new = rotate(k_new[:, :, None], t, cfg.rope_theta)[:, :, 0]
    gates = torch.sigmoid(gate_logits + params["gate_b"].to(gate_logits.dtype))
    skw = dict(max_blocks=max_len // Bs, stride=stride, sel_block=Bs,
               num_sel=nsa.num_selected_blocks, n_slide=n_slide, scale=scale)
    akw = dict(sel_block=Bs, window=window, num_sel=nsa.num_selected_blocks,
               n_slide=n_slide, scale=scale)

    if fused:
        # ---- the fused pair: ring shift, emission, kv row write, attention,
        # projection, residual and FF in two kernels -----------------------
        if not ragged:
            select, attend_fn = (
                (decode_select_emit, decode_attend_fused) if use_kernels
                else (decode_select_emit_plain, decode_attend_fused_plain))
        elif paged:
            select, attend_fn = (
                (decode_select_emit_ragged, decode_attend_fused_paged) if use_kernels
                else (decode_select_emit_ragged_plain, decode_attend_fused_paged_plain))
        else:
            select, attend_fn = (
                (decode_select_emit_ragged, decode_attend_fused_ragged) if use_kernels
                else (decode_select_emit_ragged_plain, decode_attend_fused_ragged_plain))
        kv_operands = (cache.kv, page_table) if paged else (cache.kv,)
        c_out, info = select(
            q.reshape(b, kvh, g, d).contiguous(), cache.ckv, cache.ring,
            kv_new[:, :, None].to(cache.ring.dtype), fp["mem_kv"].to(x.dtype),
            fp["pos_kv"], fp["w1k"], fp["b1k"], fp["w1v"], fp["b1v"], fp["w2"], fp["b2"],
            t, num_cb, **skw,
        )
        kv_new_rot = torch.cat([rk_new, v_new], dim=-1)[:, :, None].to(cache.kv.dtype)
        ff = ()
        if ff_params is not None:
            ffp = ff_params.get("decode_fused") or _pack_ff(ff_params, x.dtype)
            ff = tuple(ffp[k] for k in ("norm_scale", "w1", "b1", "w2", "b2"))
        out_x = attend_fn(
            rq.reshape(b, kvh, g, d), *kv_operands, kv_new_rot, info, c_out,
            gates.reshape(b, kvh, g, 3), x, fp["w_out"], t, ff, eps=cfg.norm_eps, **akw,
        )
        return out_x, cache

    # ---- caches: ring shift, kv row write, in place ----------------------
    ring = cache.ring
    ring[:, :, :-1].copy_(ring[:, :, 1:].clone())    # through a copy: the views overlap
    ring[:, :, -1].copy_(kv_new)
    kv_cache = cache.kv
    rows = torch.arange(b, device=x.device)
    tv = t if ragged else t.expand(b)                 # each row's position
    kv_cache[rows, :, tv.long()] = torch.cat([rk_new, v_new], dim=-1).to(kv_cache.dtype)

    # ---- predicated compressed-block emission ----------------------------
    # when t+1 completes a stride the ring holds the window [t+1-Bc, t+1)
    # (zero before the sequence start) and its compression lands in slot
    # num_cb; otherwise the candidate goes to the never-read trash row
    row_pos = torch.arange(Bc, device=x.device) + (per_row(t) + 1 - Bc)   # [(b,) Bc]
    win = ring.masked_fill((row_pos < 0).reshape(-1, 1, Bc, 1), 0.0)
    new_ck, new_cv = _compress_kv(params, cfg, win[:, :, None, :, :d], win[:, :, None, :, d:])
    cand = torch.cat([new_ck, new_cv], dim=-1)[:, :, 0]
    ckv_cache = cache.ckv
    trash = ckv_cache.shape[2] - 1
    ncb = tv // stride
    slot = torch.where(ragged_emits(tv, ncb, stride), ncb.clamp(0, trash), trash)
    ckv_cache[rows, :, slot.long()] = cand.to(ckv_cache.dtype)

    # ---- branch 1 + selection, then branches 2 + 3 + gate ----------------
    qg, rqg = q.reshape(b, kvh, g, d).contiguous(), rq.reshape(b, kvh, g, d)
    gates4 = gates.reshape(b, kvh, g, 3).contiguous()
    mem_kv = params["mem_kv"].to(x.dtype)
    if ragged:
        # JAX's XLA branches (its ragged rows under NSA_NO_FUSED_DECODE):
        # the plain branch 1 and selection, the block gather as a kernel
        c_out, info = decode_select_plain(qg, ckv_cache, mem_kv, t, num_cb, **skw)
        gather = paged_gather if use_kernels else paged_gather_plain
        fkv = gather(kv_cache, info[..., :nsa.num_selected_blocks + n_slide], Bs)
        out = attend_combined_plain(rqg, fkv, info, c_out, gates4, t, gathered=True,
                                    **akw).to(x.dtype)
    else:
        select, attend_fn = (
            (decode_select, decode_attend) if use_kernels
            else (decode_select_plain, decode_attend_plain)
        )
        c_out, info = select(qg, ckv_cache, mem_kv, t, num_cb, **skw)
        out = attend_fn(rqg, kv_cache, info, c_out, gates4, t, **akw)
    out = out.reshape(b, 1, h * d) @ params["w_out"].to(x.dtype)

    out_x = x + out
    if ff_params is not None:
        out_x = out_x + ff_apply_gelu(ff_params, cfg, out_x)
    return out_x, cache
