"""The Native Sparse Attention layer (``nsa_tpu/ops/nsa.py``): three
branches under a learned sigmoid gate.

* branch 1: compressed attention over the compressions of overlapping K/V
  windows (any kind of ``ops/compress.py``) plus one learned mem slot; its
  logits double as block-importance scores;
* branch 2: fine attention over the top-k selected blocks united with the
  block-causal diagonal;
* branch 3: sliding-window attention.

As in the JAX package: compression inputs and the compressed-branch queries
are never rotated; the gate bias starts at ``[-2, -2, 2]``; decode masks the
diagonal block exactly as prefill does, so prefill and incremental decode
agree.

The prefill and training of the default configuration (causal, query heads
sharing their KV head's selection, ``selection_block_size / stride > 1``)
run branches 2 and 3 in one forward kernel and two backward kernels
(``ops/cuda/nsa_prefill.py``).  Every other configuration, per-head
selection, ``selection_block_size == stride`` or non-causal attention,
runs JAX's XLA path in plain PyTorch, as JAX does: branches 1 and 2 over
query chunks (each recomputed in the backward), then the sliding window.

The decode step takes one of these routes, as in the JAX package: at
b <= 8 the fused pair ``decode_select_emit`` + ``decode_attend_fused``
(``ops/cuda/nsa_decode_fused.py``) runs the whole layer, the FF included;
above that the split pair ``decode_select`` + ``decode_attend``
(``ops/cuda/nsa_decode.py``) with the cache writes, emission, projection
and FF as separate ops; the hybrid route (``NSA_HYBRID_DECODE``) runs the
split route's ``decode_select`` with the fused route's
``decode_attend_fused``.  The ragged step of the serving engine (one
position per row, ``t`` a [b] tensor) takes the ragged fused pair at every
batch size (``ops/cuda/nsa_decode_ragged.py``; over a paged kv pool with a
page table), or, forced to the split route, JAX's XLA branches
(``_decode_compressed``, ``_decode_fine_sliding``) with the block gather
as a kernel (``ops/cuda/paged_gather.py``).  The configurations the
kernels do not take (per-head selection, ``selection_block_size ==
stride``) decode on those XLA branches at every batch size, scalar or
ragged, the block gather a kernel where the selection is the KV heads'.
Every compressor trains and prefills through the same kernels, which take
only the selections; the fused routes take only the ``mlp`` compressor, as
in JAX, so the other kinds decode on the split route.
``NSA_NO_FF_FUSE`` keeps the FF out of the fused and hybrid routes'
attend kernels and applies it after them.  ``NSA_ABLATE``, JAX's
profiling hook (``decode_ablation``), drops a part of the decode step.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..config import ModelConfig
from ..parallel.comm import copy_to_heads, gather_from_heads, reduce_from_heads, scatter_to_heads
from ..parallel.mesh import heads_parallel
from .attention import attend, blockify_kv, fine_attend_core, sliding_window_attention
from ..utils.checkpoint import tree_to
from .common import mask_value, merge_heads, rms_norm, round_down_mult, round_up_mult, split_heads
from .compress import apply_compressor, init_compressor, split_compress_windows
from .cuda.nsa_decode import (
    INFO_WIDTH,
    compressed_attention_plain,
    decode_attend,
    decode_attend_plain,
    decode_select,
    decode_select_plain,
    per_row,
    trailing_blocks,
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


def init_sparse_attention(cfg: ModelConfig, generator: torch.Generator,
                          device="cuda") -> dict:
    """Random parameters of one layer, in ``init_sparse_attention``'s layout
    and distributions (the numbers differ from JAX's for the same seed)."""
    nsa = cfg.nsa
    d, h, kvh = cfg.dim_head, cfg.heads, cfg.kv_heads

    def uniform(shape, fan_in):
        bound = 1.0 / fan_in ** 0.5
        return (torch.rand(shape, generator=generator) * 2 - 1) * bound

    params = {
        "norm_scale": torch.ones(cfg.dim),
        "w_q": uniform((cfg.dim, cfg.dim_inner), cfg.dim),
        "w_k": uniform((cfg.dim, cfg.dim_kv_inner), cfg.dim),
        "w_v": uniform((cfg.dim, cfg.dim_kv_inner), cfg.dim),
        "mem_kv": torch.zeros(2, kvh, nsa.num_compressed_mem_kv, d),
        "k_pos": torch.zeros(kvh, nsa.compress_block_size, d),
        "v_pos": torch.zeros(kvh, nsa.compress_block_size, d),
        "k_compress": init_compressor(nsa, kvh, d, generator),
        "v_compress": init_compressor(nsa, kvh, d, generator),
        "gate_w": torch.zeros(cfg.dim, 3 * h),
        "gate_b": torch.tensor([-2.0, -2.0, 2.0]).repeat(h),
        "w_out": uniform((cfg.dim_inner, cfg.dim), cfg.dim_inner),
    }
    return tree_to(params, device)


def _compress_kv(params, cfg: ModelConfig, k_windows, v_windows):
    """Intra-block positions, then the K and V compressors:
    [b, kvh, w, Bc, d] -> [b, kvh, w, d] each.

    Under a heads axis (``parallel/sharding.py``) the per-head compressors
    run on the rank's own KV heads; a weight shared by the heads is summed
    over them in the backward; the ``transformer`` compressor, which mixes
    the heads, runs on every rank over all of them, gathered, and keeps the
    rank's own."""
    kind = cfg.nsa.compressor
    kin = k_windows + params["k_pos"].to(k_windows.dtype)[None, :, None]
    vin = v_windows + params["v_pos"].to(v_windows.dtype)[None, :, None]
    if kind == "transformer":
        ck, cv = (scatter_to_heads(apply_compressor(params[name], kind,
                                                    gather_from_heads(x, 1)), 1)
                  for name, x in (("k_compress", kin), ("v_compress", vin)))
        return ck, cv
    kc, vc = params["k_compress"], params["v_compress"]
    if kind not in ("mlp", "conv"):
        kc, vc = ({k: copy_to_heads(w) for k, w in c.items()} for c in (kc, vc))
    return apply_compressor(kc, kind, kin), apply_compressor(vc, kind, vin)


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
    as in the JAX package.

    Branches 2 and 3 run in the forward kernel (and train through the two
    backward kernels) exactly where JAX's ``use_fused_kernel`` holds:
    causal, shared selection, ``selection_block_size / stride > 1`` and at
    least one selectable block (a prompt of ``selection_block_size``
    tokens or more).  ``use_kernels=False`` runs their plain versions on
    any device (see ``sparse_attention_decode``).  Everywhere else the
    layer runs JAX's XLA path: ``fine_attend_core`` over the chunk's
    selected blocks (per query head when the heads do not share it), then
    ``sliding_window_attention``, in plain PyTorch."""
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

    # the heads ranks' shared input; their partial outputs are summed after w_out
    normed = copy_to_heads(rms_norm(x, params["norm_scale"], cfg.norm_eps))
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
    share = nsa.query_heads_share_selected_kv

    def compressed_and_select(q_chunk, positions):
        """Branch 1's output and the fine-block selection of one query chunk."""
        cmask = ck_ends[None, :] < positions[:, None] if cfg.causal else None   # [m, mem+w]
        c_out, csim = attend(q_chunk, ck_full, cv_full, mask=cmask, scale=scale,
                             return_sim=True)
        importance = group_importance(csim, num_mem, g, share)
        scores = fine_block_scores(importance, positions, Bs, stride)
        return c_out, select_blocks(scores, nsa.num_selected_blocks, nsa.use_diff_topk)

    def chunk_positions(c0, m):
        return torch.arange(c0, c0 + m, device=dev)

    chunk = cfg.attn_chunk_size
    # the kernel path where JAX's use_fused_kernel holds; JAX's XLA path
    # (branches_12 over query chunks, then the sliding window) elsewhere
    S = min(nsa.num_selected_blocks, max(num_cblocks // nsa.num_compress_per_fine, 0))
    if cfg.causal and share and nsa.num_compress_per_fine > 1 and S > 0:
        # ---- branch 1 + selection, chunked over queries ------------------
        couts, idxs, msks, gts = [], [], [], []
        for c0 in range(0, n, chunk):
            qc = q[:, :, c0:c0 + chunk]
            c_out, sel = compressed_and_select(qc, chunk_positions(c0, qc.shape[2]))
            couts.append(c_out)
            idxs.append(sel.indices)
            msks.append(sel.mask)
            gts.append(sel.gates)
        compressed_out = torch.cat(couts, dim=2)
        sel_idx = torch.cat(idxs, dim=2)
        sel_mask = torch.cat(msks, dim=2)
        gates = torch.cat(gts, dim=2) if nsa.use_diff_topk else None

        # ---- branches 2 + 3: the fused fine + sliding kernel -------------
        fine_out, sliding_out = nsa_fine_sliding_attention(
            rq.contiguous(), rk.contiguous(), v.contiguous(), sel_idx, sel_mask, gates,
            Bs, nsa.sliding_window_size, scale, use_kernels=use_kernels,
        )
    else:
        # ---- branches 1 + 2 over query chunks, then branch 3 -------------
        # each chunk under torch.utils.checkpoint when autograd records, as
        # JAX's jax.checkpoint per chunk: the backward recomputes a chunk's
        # gathered blocks instead of keeping every chunk's
        kb, vb = blockify_kv(rk, v, Bs, kvh if share else h)

        def branches_12(q_chunk, rq_chunk, c0):
            positions = chunk_positions(c0, q_chunk.shape[2])
            c_out, sel = compressed_and_select(q_chunk, positions)
            f_out = fine_attend_core(rq_chunk, kb, vb, sel.indices, sel.mask, sel.gates,
                                     positions, cfg.causal, scale)
            return c_out, f_out

        recompute = torch.is_grad_enabled() and q.requires_grad and n > chunk
        couts, fouts = [], []
        for c0 in range(0, n, chunk):
            args = (q[:, :, c0:c0 + chunk], rq[:, :, c0:c0 + chunk], c0)
            c_out, f_out = (checkpoint(branches_12, *args, use_reentrant=False) if recompute
                            else branches_12(*args))
            couts.append(c_out)
            fouts.append(f_out)
        compressed_out = torch.cat(couts, dim=2)
        fine_out = torch.cat(fouts, dim=2)
        sliding_out = sliding_window_attention(rq, rk, v, nsa.sliding_window_size,
                                               causal=cfg.causal, scale=scale)

    out = _gate_combine(params, cfg, normed, [compressed_out, fine_out, sliding_out])
    out = reduce_from_heads(merge_heads(out) @ params["w_out"].to(x.dtype))
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

DECODE_ROUTES = (None, "fused", "split", "hybrid")

# the environment switches the decode step reads as it runs, as JAX reads
# them as it traces (a captured decode loop is keyed on them)
DECODE_ENV = ("NSA_HYBRID_DECODE", "NSA_NO_FF_FUSE", "NSA_ABLATE")

# NSA_ABLATE's values (JAX's, ``nsa_tpu/ops/nsa.py:540-545``): the part of
# the decode step each one drops
ABLATIONS = ("no_fine", "no_compressed", "no_emit", "attn_only")


def decode_ablation() -> str:
    """``NSA_ABLATE`` as JAX reads it, a profiling hook that no user path
    sets (``python -m nsa_tpu_torch.profile_decode`` does): one of
    ``ABLATIONS`` or "" (any other value, like JAX's, drops nothing).
    ``no_fine`` zeroes the fine and sliding branches, ``no_compressed`` the
    compressed branch and its logits (so the selection reads zeros),
    ``no_emit`` leaves the ``ckv`` cache as it was, ``attn_only`` all
    three.  Any of them turns the fused route off; all but ``no_emit`` the
    split and hybrid routes too, so the step takes JAX's XLA branches
    (``decode_route``).  The whole-model kernel at b <= 8 never reads it."""
    value = os.environ.get("NSA_ABLATE", "")
    return value if value in ABLATIONS else ""


def _split_decode_applies(cfg: ModelConfig) -> bool:
    """The configurations the split pair (rows 2-3) takes, JAX's
    ``use_decode_kernels``: shared selection, ``selection_block_size /
    stride > 1``."""
    nsa = cfg.nsa
    return nsa.query_heads_share_selected_kv and nsa.num_compress_per_fine > 1


def _fused_decode_applies(cfg: ModelConfig) -> bool:
    nsa = cfg.nsa
    return (_split_decode_applies(cfg) and nsa.num_selected_blocks > 0
            and nsa.compressor == "mlp")


def _use_fused_decode(cfg: ModelConfig, b: int) -> bool:
    """Whether the decode step takes the fused route by default: JAX's
    ``_use_fused_decode(...) and b <= NSA_FUSED_DECODE_MAX_B``.  JAX's
    further condition, batch tiles that Mosaic can lay out, holds for every
    b <= 8 and has no counterpart here."""
    return _fused_decode_applies(cfg) and b <= FUSED_DECODE_MAX_B


def decode_route(cfg: ModelConfig, b: int, ragged: bool, route: Optional[str] = None) -> str:
    """The route a decode step of ``b`` rows takes: "fused", "split",
    "hybrid" or "xla" (JAX's XLA branches, ``_decode_compressed`` +
    ``_decode_fine_sliding``).  ``route`` as in ``sparse_attention_decode``;
    a route the configuration does not take raises.

    ``NSA_HYBRID_DECODE`` (any non-empty value, read here as JAX reads it)
    turns the one-position split route into the hybrid route wherever that
    applies, whether the split route was the default or forced, as JAX's
    flag turns its split path (``use_decode_kernels``) into the hybrid one.
    The ragged split route is the XLA branches.

    ``NSA_ABLATE`` (``decode_ablation``) then moves the step off the
    kernels it drops, whether its route was the default or forced: off the
    fused route to the split one (one position) or the XLA branches
    (ragged), and under ``no_fine``, ``no_compressed`` or ``attn_only``
    off the split and hybrid routes to the XLA branches, as JAX's hook
    turns off its ``use_fused`` and ``use_decode_kernels``.

    Under a heads axis above 1 (``parallel/mesh.py``) the default is the
    split route (one position) or the ragged split route, and the fused and
    hybrid routes raise, forced or through ``NSA_HYBRID_DECODE``: their
    attend kernels fold ``w_out``, the residual and the FF in, where a heads
    rank holds only a partial sum of ``out @ w_out``.  A data-only mesh
    keeps every route.  The swiglu FF (``ff_kind``) is held the same way:
    those kernels fold the gelu FF, so a swiglu model decodes on the split
    routes with its FF after the attention."""
    nsa = cfg.nsa
    if route not in DECODE_ROUTES:
        raise ValueError(f"route must be one of {DECODE_ROUTES}, got {route!r}")
    heads_split = heads_parallel()
    if heads_split and route in ("fused", "hybrid"):
        raise ValueError(f"the {route} decode route folds w_out, the residual and the FF "
                         f"into its kernels, which a heads axis above 1 cannot split: each "
                         f"heads rank holds a partial sum of out @ w_out; take the split route")
    gelu = cfg.ff_kind == "gelu"
    if not gelu and route in ("fused", "hybrid"):
        raise ValueError(f"the {route} decode route folds the gelu FF into its attend kernel; "
                         f"the {cfg.ff_kind} FF decodes on the split route")
    folds = gelu and not heads_split      # the fused kernels may run
    if route == "fused" and not _fused_decode_applies(cfg):
        raise ValueError("the fused decode route needs shared selection, selection_block_size "
                         "/ stride > 1, selected blocks and the mlp compressor")
    if route in ("split", "hybrid") and not _split_decode_applies(cfg):
        raise ValueError(f"the {route} decode route needs shared selection and "
                         f"selection_block_size / stride > 1; this configuration decodes on "
                         f"JAX's XLA branches (route None)")
    hybrid_ok = not ragged and _split_decode_applies(cfg) and nsa.num_selected_blocks > 0
    if route == "hybrid" and not hybrid_ok:
        raise ValueError("the hybrid decode route takes one position for every row and "
                         "selected blocks")
    if route is not None:
        chosen = route
    elif ragged:
        chosen = "fused" if _fused_decode_applies(cfg) and folds else "xla"
    elif _use_fused_decode(cfg, b) and folds:
        chosen = "fused"
    else:
        chosen = "split" if _split_decode_applies(cfg) else "xla"
    ablation = decode_ablation()
    if ablation and chosen == "fused":
        chosen = "split" if _split_decode_applies(cfg) else "xla"
    if ablation not in ("", "no_emit") and chosen in ("split", "hybrid"):
        return "xla"
    if chosen == "split" and hybrid_ok and os.environ.get("NSA_HYBRID_DECODE"):
        if not folds:
            raise ValueError("NSA_HYBRID_DECODE: the hybrid route's attend kernel folds w_out "
                             "and the gelu FF in, which a heads axis above 1 and the swiglu "
                             "FF cannot take")
        return "hybrid"
    return "xla" if ragged and chosen == "split" else chosen


def _cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.to(dtype).contiguous()


def _pack_attn(attn: dict, dtype: torch.dtype, compressor: str = "mlp") -> dict:
    """The decode weights of one layer; for a compressor other than ``mlp``
    only the fused projection, all that the split route reads."""
    w_qkvg = _cast(torch.cat([attn["w_q"], attn["w_k"], attn["w_v"], attn["gate_w"]], 1), dtype)
    if compressor != "mlp":
        return {"w_qkvg": w_qkvg}
    kc, vc = attn["k_compress"], attn["v_compress"]
    f32 = torch.float32
    return {
        "w_qkvg": w_qkvg,
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


def fuse_decode_layer(layer: dict, dtype: torch.dtype, compressor: str = "mlp",
                      pack_ff: bool = True) -> dict:
    """A layer's decode weights packed once for the decode step
    (``fuse_decode_params``): ``attn["decode_fused"]`` holds the fused
    projection ``w_qkvg``, ``pos_kv = k_pos||v_pos``, the compressors'
    ``w1k``, ``w1v`` [kvh, Bc*d, hid] and ``w2 = w2_k||w2_v``, ``mem_kv``
    and ``w_out`` in ``dtype`` and the compressors' biases in float32 (for
    another ``compressor``, which decodes on the split route, ``w_qkvg``
    alone); with ``pack_ff`` (the gelu FF, which the fused routes fold in)
    ``ff["decode_fused"]`` the FF's matrices in ``dtype`` and its norm
    scale and biases in float32.  Returns a new layer dict; the input is
    unchanged."""
    attn = {**layer["attn"], "decode_fused": _pack_attn(layer["attn"], dtype, compressor)}
    if not pack_ff:
        return {**layer, "attn": attn}
    return {**layer, "attn": attn,
            "ff": {**layer["ff"], "decode_fused": _pack_ff(layer["ff"], dtype)}}


def ff_apply_gelu(ffp, cfg: ModelConfig, x):
    """The prenorm FF block: RMSNorm, then Linear-GELU(exact erf)-Linear with
    biases; the model's FF in prefill, and the decode step's when it is
    handed the FF params.  Under a heads axis ``w1`` is split by columns and
    ``w2`` by rows: the ranks' partial products are summed, then ``b2`` is
    added once."""
    hid = copy_to_heads(rms_norm(x, ffp["norm_scale"], cfg.norm_eps))
    hid = F.gelu(hid @ ffp["w1"].to(hid.dtype) + ffp["b1"].to(hid.dtype))
    return reduce_from_heads(hid @ ffp["w2"].to(hid.dtype)) + ffp["b2"].to(hid.dtype)


def ff_apply_swiglu(ffp, cfg: ModelConfig, x):
    """Llama's prenorm FF block (``_ff_apply``'s swiglu branch): RMSNorm,
    then ``(silu(h @ w1) * (h @ w3)) @ w2``, no biases.  Under a heads axis
    ``w1`` and ``w3`` are split by columns and ``w2`` by rows."""
    hid = copy_to_heads(rms_norm(x, ffp["norm_scale"], cfg.norm_eps))
    gate = F.silu(hid @ ffp["w1"].to(hid.dtype))
    up = hid @ ffp["w3"].to(hid.dtype)
    return reduce_from_heads((gate * up) @ ffp["w2"].to(hid.dtype))


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

    ``route`` (see ``decode_route``): ``None`` takes the fused pair at
    b <= 8 and the split pair above (JAX's default), and the ragged fused
    pair at every b for a ragged ``t``; ``"fused"`` or ``"split"`` forces
    one (JAX's ``NSA_FUSED_DECODE_MAX_B`` / ``NSA_NO_FUSED_DECODE``);
    ``"hybrid"`` (JAX's ``NSA_HYBRID_DECODE=1``, which also selects it)
    runs the split route's ``decode_select`` and then the fused route's
    ``decode_attend_fused`` on its info rows, which writes the kv row,
    projects, adds the residual and runs the FF: one position, selected
    blocks.  The configurations the kernels do not take (per-head
    selection, ``selection_block_size == stride``) have one route, None:
    JAX's XLA branches at every batch size, scalar or ragged, the block
    gather through ``paged_gather`` where the selection is the KV heads'.
    On the fused and hybrid routes the layer owns the FF:
    ``decode_attend_fused`` runs it, or, with ``NSA_NO_FF_FUSE`` set (read
    here as JAX reads it), ``ff_apply_gelu`` after the kernel.  Packed
    weights from ``fuse_decode_layer`` are used when present
    (``params["decode_fused"]``, ``ff_params["decode_fused"]``), else packed
    here.  ``NSA_ABLATE`` (``decode_ablation``, read here as JAX reads it)
    moves the route (``decode_route``) and drops its part of the step.

    ``page_table`` [b, max_pages] int32 makes ``cache.kv`` a page pool [P,
    kvh, PAGE, 2d] shared by the rows (the paged serving engine): it needs a
    ragged ``t`` and the fused route, as in JAX.

    ``use_kernels=False`` runs the plain PyTorch versions of the route's
    kernels on any device, to hold the kernel path against them on the
    card; otherwise the wrappers choose (kernel on CUDA, plain version on
    the CPU).
    """
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
    chosen = decode_route(cfg, b, ragged, route)
    if paged and not (ragged and chosen == "fused"):
        raise NotImplementedError("paged KV decode requires ragged positions and the fused "
                                  "route (mlp compressor, shared-KV selection)")
    if isinstance(t, torch.Tensor):
        t = t.to(device=x.device, dtype=torch.int32)
    else:                       # one device position for the whole step
        t = torch.full((), t, dtype=torch.int32, device=x.device)
    num_cb = t // stride

    fp = params.get("decode_fused")
    if fp is None and chosen == "fused":
        fp = _pack_attn(params, x.dtype)
    w_fused = (fp["w_qkvg"] if fp is not None else torch.cat(
        [params["w_q"], params["w_k"], params["w_v"], params["gate_w"]], dim=1
    )).to(x.dtype)

    normed = copy_to_heads(rms_norm(x, params["norm_scale"], cfg.norm_eps))
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
    # the FF inside the fused and hybrid routes' attend kernel, unless
    # NSA_NO_FF_FUSE keeps it out; with_ff then applies it after the kernel
    ff = ()
    if ff_params is not None and chosen in ("fused", "hybrid") \
            and not os.environ.get("NSA_NO_FF_FUSE"):
        ffp = ff_params.get("decode_fused") or _pack_ff(ff_params, x.dtype)
        ff = tuple(ffp[k] for k in ("norm_scale", "w1", "b1", "w2", "b2"))

    def with_ff(out_x):
        if ff_params is not None and not ff:
            out_x = out_x + ff_apply_gelu(ff_params, cfg, out_x)
        return out_x

    if chosen == "fused":
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
        out_x = attend_fn(
            rq.reshape(b, kvh, g, d), *kv_operands, kv_new_rot, info, c_out,
            gates.reshape(b, kvh, g, 3), x, fp["w_out"], t, ff, eps=cfg.norm_eps, **akw,
        )
        return with_ff(out_x), cache

    # ---- caches: ring shift, kv row write (in the hybrid route's attend
    # kernel instead), in place --------------------------------------------
    ring = cache.ring
    ring[:, :, :-1].copy_(ring[:, :, 1:].clone())    # through a copy: the views overlap
    ring[:, :, -1].copy_(kv_new)
    kv_cache = cache.kv
    rows = torch.arange(b, device=x.device)
    tv = t if ragged else t.expand(b)                 # each row's position
    kv_row = torch.cat([rk_new, v_new], dim=-1).to(kv_cache.dtype)
    if chosen != "hybrid":
        kv_cache[rows, :, tv.long()] = kv_row

    # ---- predicated compressed-block emission ----------------------------
    # when t+1 completes a stride the ring holds the window [t+1-Bc, t+1)
    # (zero before the sequence start) and its compression lands in slot
    # num_cb; otherwise the candidate goes to the never-read trash row.
    # NSA_ABLATE=no_emit / attn_only leave the ckv cache as it was.
    ablation = decode_ablation()
    ckv_cache = cache.ckv
    if ablation not in ("no_emit", "attn_only"):
        row_pos = torch.arange(Bc, device=x.device) + (per_row(t) + 1 - Bc)   # [(b,) Bc]
        win = ring.masked_fill((row_pos < 0).reshape(-1, 1, Bc, 1), 0.0)
        new_ck, new_cv = _compress_kv(params, cfg, win[:, :, None, :, :d],
                                      win[:, :, None, :, d:])
        cand = torch.cat([new_ck, new_cv], dim=-1)[:, :, 0]
        trash = ckv_cache.shape[2] - 1
        ncb = tv // stride
        slot = torch.where(ragged_emits(tv, ncb, stride), ncb.clamp(0, trash), trash)
        ckv_cache[rows, :, slot.long()] = cand.to(ckv_cache.dtype)

    # ---- branch 1 + selection, then branches 2 + 3 + gate ----------------
    qg, rqg = q.reshape(b, kvh, g, d).contiguous(), rq.reshape(b, kvh, g, d)
    gates4 = gates.reshape(b, kvh, g, 3).contiguous()
    mem_kv = params["mem_kv"].to(x.dtype)
    if chosen == "xla":
        # NSA_ABLATE drops a branch as zeros (no_compressed: its logits too,
        # which the selection then reads)
        if ablation in ("no_compressed", "attn_only"):
            c_out = torch.zeros((b, h, d), dtype=q.dtype, device=x.device)
            csim = torch.zeros((b, kvh, g, nsa.num_compressed_mem_kv + ckv_cache.shape[2]),
                               dtype=torch.float32, device=x.device)
        else:
            c_out, csim = _decode_compressed(qg, ckv_cache, mem_kv, num_cb, scale)
        if ablation in ("no_fine", "attn_only"):
            fine_out = sliding_out = torch.zeros((b, h, d), dtype=q.dtype, device=x.device)
        else:
            fine_out, sliding_out = _decode_fine_sliding(cfg, csim, rq, kv_cache, t,
                                                         use_kernels=use_kernels)
        stacked = torch.stack([c_out, fine_out, sliding_out], dim=-1)     # [b, h, d, 3]
        out = torch.einsum("bhs,bhds->bhd", gates.reshape(b, h, 3).to(stacked.dtype), stacked)
    else:
        select = decode_select if use_kernels else decode_select_plain
        c_out, info = select(qg, ckv_cache, mem_kv, t, num_cb, **skw)
        if chosen == "hybrid":
            # decode_select's info rows are decode_attend_fused's, per batch row
            attend_fn = decode_attend_fused if use_kernels else decode_attend_fused_plain
            w_out = fp["w_out"] if fp is not None and "w_out" in fp else \
                params["w_out"].to(x.dtype)
            out_x = attend_fn(rqg, kv_cache, kv_row[:, :, None], info.reshape(b, kvh * INFO_WIDTH),
                              c_out, gates4, x, w_out, t, ff, eps=cfg.norm_eps, **akw)
            return with_ff(out_x), cache
        attend_fn = decode_attend if use_kernels else decode_attend_plain
        out = attend_fn(rqg, kv_cache, info, c_out, gates4, t, **akw)
    out = reduce_from_heads(out.reshape(b, 1, h * d) @ params["w_out"].to(x.dtype))

    out_x = x + out
    if ff_params is not None:
        out_x = out_x + ff_apply_gelu(ff_params, cfg, out_x)
    return out_x, cache


def _decode_compressed(qg, ckv, mem_kv, num_cb, scale: float):
    """Branch 1 of JAX's XLA decode path (``_decode_compressed``): qg [b,
    kvh, g, d] unrotated queries over the live compressed rows and the mem
    slots -> (c_out [b, h, d], csim [b, kvh, g, M + Wc] float32 logits)."""
    b, kvh, g, d = qg.shape
    c_out, csim = compressed_attention_plain(qg, ckv, mem_kv, num_cb, scale=scale)
    return c_out.reshape(b, kvh * g, d), csim


def _decode_fine_sliding(cfg: ModelConfig, csim, rq, kv_cache, t, *, use_kernels: bool = True):
    """Branches 2 and 3 of JAX's XLA decode path (``_decode_fine_sliding``)
    from one gathered block set: the selection from branch 1's logits csim
    (shared by each KV head's query heads, or per query head), then the S
    selected blocks and the ``n_slide`` blocks ending at the query's own
    block, one q.K and two masked softmaxes.  rq [b, h, d] rotated; kv_cache
    [b, kvh, max_len, 2d] holding row t; t a 0-d or [b] int32 tensor.
    Returns (fine_out, sliding_out), each [b, h, d].

    Block ids are clamped to the cache, as JAX's gathers clamp them (with
    ``selection_block_size == stride`` the unselectable slots past the live
    blocks can name blocks past the cache; their columns are masked).  With
    the KV heads' selection the blocks come through ``paged_gather`` (row
    11; its plain version under ``use_kernels=False``); per query head each
    head's blocks are read from its own KV head's rows, the values JAX
    gathers from its ``repeat_kv`` copy of the cache, without the copy."""
    nsa = cfg.nsa
    Bs, window = nsa.selection_block_size, nsa.sliding_window_size
    b, h, d = rq.shape
    kvh = kv_cache.shape[1]
    n_blocks = kv_cache.shape[2] // Bs
    dev = rq.device
    importance = group_importance(csim.reshape(b, h, 1, -1), nsa.num_compressed_mem_kv,
                                  cfg.num_grouped_queries, nsa.query_heads_share_selected_kv)
    scores = fine_block_scores(importance, t.reshape(-1, 1), Bs,
                               nsa.compress_block_sliding_stride)
    sel = select_blocks(scores, nsa.num_selected_blocks, use_diff_topk=False)
    Hs, S = sel.indices.shape[1], sel.indices.shape[-1]
    n_slide = -(-window // Bs) + 1
    J = S + n_slide

    trail = trailing_blocks(t, Bs, n_slide, dev)                     # [ns] | [b, ns]
    idx_all = torch.cat([
        sel.indices[:, :, 0].clamp(0, n_blocks - 1),
        trail.clamp(0, n_blocks - 1).to(torch.int32).reshape(-1, 1, n_slide).expand(b, Hs, n_slide),
    ], dim=-1)                                                       # [b, Hs, J]
    if Hs == kvh:
        gather = paged_gather if use_kernels else paged_gather_plain
        fkv = gather(kv_cache, idx_all, Bs)                          # [b, kvh, J * Bs, 2d]
    else:
        kvb = kv_cache.reshape(b, kvh, n_blocks, Bs, 2 * d)
        heads = torch.arange(Hs, device=dev) // (Hs // kvh)          # each head's KV head
        fkv = kvb[torch.arange(b, device=dev)[:, None, None], heads[None, :, None],
                  idx_all.long()].reshape(b, Hs, J * Bs, 2 * d)

    # global positions of the trailing columns, from the unclipped ids
    j_trail = trail[..., None] * Bs + torch.arange(Bs, device=dev)   # [(b,) ns, Bs]
    trail_ok = (trail >= 0)[..., None]
    tt = t.reshape(-1, 1, 1)
    diag_only = torch.zeros((n_slide, 1), dtype=torch.bool, device=dev)
    diag_only[-1] = True
    fine_trail = diag_only & (j_trail <= tt) & trail_ok
    slide_trail = (j_trail >= tt - window) & (j_trail <= tt) & trail_ok

    def heads_of(m):    # [(b,) ns, Bs] -> [b, Hs, ns, Bs]
        return m.reshape(-1, 1, n_slide, Bs).expand(b, Hs, n_slide, Bs)

    fine_sel = sel.mask[:, :, 0, :, None].expand(b, Hs, S, Bs)
    fine_mask = torch.cat([fine_sel, heads_of(fine_trail)], dim=2).reshape(b, Hs, 1, J * Bs)
    slide_mask = torch.cat([torch.zeros_like(fine_sel), heads_of(slide_trail)], dim=2
                           ).reshape(b, Hs, 1, J * Bs)

    sim = torch.einsum("bhgd,bhjd->bhgj", rq.reshape(b, Hs, h // Hs, d).float(),
                       fkv[..., :d].float()) * d ** -0.5
    fv = fkv[..., d:].to(rq.dtype)

    def masked_out(mask):
        s = sim.masked_fill(~mask, mask_value(torch.float32))
        attn = torch.softmax(s, dim=-1).to(rq.dtype)
        return torch.einsum("bhgj,bhjd->bhgd", attn, fv).reshape(b, h, d)

    return masked_out(fine_mask), masked_out(slide_mask)
