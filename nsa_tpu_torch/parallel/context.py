"""Context (sequence) parallelism (``nsa_tpu/parallel/context.py``).

The sequence axis of the activations is split over the ranks of a 1-D
``seq`` mesh (``mesh.make_seq_mesh``); the weights are replicated.  Per
layer every rank

* computes Q/K/V for its local slab of positions and rotates q and k at
  their GLOBAL positions ``offset + arange(n_loc)``,
* all-gathers K, V and the rotated K (``comm.gather_from_seq``: its
  backward sums the gradient over the ranks and keeps the local slice),
* computes the compressed K/V from the gathered UNROTATED rows (the same
  compute on every rank: ``n / stride`` small matmuls),
* runs all three NSA branches for its LOCAL query rows at their global
  positions, and
* applies the gate, the output projection and the FF position-locally.

The loss is Σ NLL / Σ count over the ranks; each rank's backward starts
from its own NLL sum over the global count, and the replicated weights'
gradients are then summed over the ranks (``comm.sum_grads_over_seq``),
which is what JAX's transpose of the replicated ``in_specs=P()`` gives.

As in JAX the branches are the plain ops (JAX's XLA-path helpers
``attend``, ``fine_attend_core``, ``_compress_kv``, ``select_blocks``,
``apply_rotary``); on the card they run as PyTorch ops on CUDA tensors,
with no kernel of ``ops/cuda``.  JAX's ``scan_layers`` branch (a remat'd
scan over the layers) has no counterpart: the port has no layer scan.
Labels are shifted before the sequence is split, and the (shifted) length
must divide by the number of ranks.  Every rank passes the whole ids and
takes its own slab; ``context_parallel_forward`` returns the whole logits
on every rank.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..models.transformer import _compute_dtype, _ff_apply
from ..ops.attention import attend, blockify_kv, fine_attend_core
from ..ops.common import merge_heads, rms_norm, split_heads
from ..ops.compress import split_compress_windows
from ..ops.nsa import _compress_kv, _gate_combine
from ..ops.rotary import apply_rotary
from ..ops.selection import fine_block_scores, group_importance, select_blocks
from ..utils.checkpoint import tree_leaves
from .comm import gather_from_seq, sum_grads_over_seq, sum_over_seq
from .mesh import AXIS_SEQ, Mesh, make_seq_mesh

__all__ = ["AXIS_SEQ", "make_seq_mesh", "cp_sparse_attention", "cp_full_attention",
           "context_parallel_forward", "context_parallel_loss",
           "context_parallel_value_and_grad"]


def _local(ids: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's slab of ids [b, n] along the sequence."""
    ranks, n = mesh.size(AXIS_SEQ), ids.shape[1]
    if n % ranks:
        raise ValueError(f"sequence length {n} must divide by the {ranks} seq ranks")
    n_loc = n // ranks
    return ids[:, mesh.coord(AXIS_SEQ) * n_loc:(mesh.coord(AXIS_SEQ) + 1) * n_loc]


def _sliding_local(rq, rk_full, v_full, offset: int, n_loc: int, window: int, scale: float):
    """Banded attention for local query rows at global positions ``offset +
    [0, n_loc)`` over the whole sequence's keys: query i attends keys j with
    ``0 <= i - j <= window``.  Only the ``n_loc + window`` keys that can
    fall in a local row's band are sliced, after a left pad of ``window``
    rows, so the slice starts at ``offset`` (a band may reach back across
    more than one rank's slab)."""
    dev = rq.device
    ks = F.pad(rk_full, (0, 0, window, 0))[:, :, offset:offset + n_loc + window]
    vs = F.pad(v_full, (0, 0, window, 0))[:, :, offset:offset + n_loc + window]
    qi = offset + torch.arange(n_loc, device=dev)                     # global q positions
    kj = offset - window + torch.arange(n_loc + window, device=dev)   # global key positions
    delta = qi[:, None] - kj[None, :]
    mask = (delta >= 0) & (delta <= window) & (kj >= 0)[None, :]
    return attend(rq, ks, vs, mask=mask, scale=scale)


def cp_sparse_attention(params, cfg: ModelConfig, x_local: torch.Tensor, mesh: Mesh):
    """One NSA layer on this rank's slab x_local [b, n_loc, dim]: the math
    of ``sparse_attention_forward``'s XLA path, with K/V gathered over the
    ``seq`` ranks and every branch at global positions."""
    nsa = cfg.nsa
    b, n_loc, _ = x_local.shape
    d, h, kvh = cfg.dim_head, cfg.heads, cfg.kv_heads
    g = cfg.num_grouped_queries
    scale = d ** -0.5
    stride = nsa.compress_block_sliding_stride
    num_mem = nsa.num_compressed_mem_kv
    dev = x_local.device

    offset = mesh.coord(AXIS_SEQ) * n_loc
    n = n_loc * mesh.size(AXIS_SEQ)                           # global length
    positions = offset + torch.arange(n_loc, device=dev)

    normed = rms_norm(x_local, params["norm_scale"], cfg.norm_eps)
    q = split_heads(normed @ params["w_q"].to(normed.dtype), d)
    k = split_heads(normed @ params["w_k"].to(normed.dtype), d)
    v = split_heads(normed @ params["w_v"].to(normed.dtype), d)

    # the local rows rotated at their global positions, then gathered:
    # rotary is position-wise, so this is the whole sequence rotated
    rq = apply_rotary(q, positions, cfg.rope_theta)
    rk = apply_rotary(k, positions, cfg.rope_theta)
    k_full = gather_from_seq(k, 2, mesh)
    v_full = gather_from_seq(v, 2, mesh)
    rk_full = gather_from_seq(rk, 2, mesh)

    # ---- branch 1: compressed attention over the gathered UNROTATED rows
    compress_divisible = (n // stride) * stride
    num_cblocks = compress_divisible // stride
    if num_cblocks > 0:
        kw = split_compress_windows(k_full[:, :, :compress_divisible],
                                    nsa.compress_block_size, stride)
        vw = split_compress_windows(v_full[:, :, :compress_divisible],
                                    nsa.compress_block_size, stride)
        ck, cv = _compress_kv(params, cfg, kw, vw)
    else:
        ck = k.new_zeros((b, kvh, 0, d))
        cv = v.new_zeros((b, kvh, 0, d))
    mem = params["mem_kv"].to(k.dtype)
    ck_full = torch.cat([mem[0][None].expand(b, kvh, num_mem, d), ck], dim=2)
    cv_full = torch.cat([mem[1][None].expand(b, kvh, num_mem, d), cv], dim=2)
    ck_ends = torch.cat([torch.full((num_mem,), -1, device=dev),
                         (torch.arange(num_cblocks, device=dev) + 1) * stride - 1])
    cmask = ck_ends[None, :] < positions[:, None] if cfg.causal else None
    c_out, csim = attend(q, ck_full, cv_full, mask=cmask, scale=scale, return_sim=True)

    # ---- branch 2: selection and fine attention at global positions ----
    share = nsa.query_heads_share_selected_kv
    importance = group_importance(csim, num_mem, g, share)
    scores = fine_block_scores(importance, positions, nsa.selection_block_size, stride)
    sel = select_blocks(scores, nsa.num_selected_blocks, nsa.use_diff_topk)
    kb, vb = blockify_kv(rk_full, v_full, nsa.selection_block_size, kvh if share else h)
    f_out = fine_attend_core(rq, kb, vb, sel.indices, sel.mask, sel.gates, positions,
                             cfg.causal, scale)

    # ---- branch 3: the sliding window over the gathered rows -----------
    s_out = _sliding_local(rq, rk_full, v_full, offset, n_loc, nsa.sliding_window_size, scale)

    out = _gate_combine(params, cfg, normed, [c_out, f_out, s_out])
    return merge_heads(out) @ params["w_out"].to(x_local.dtype)


def cp_full_attention(params, cfg: ModelConfig, x_local: torch.Tensor, mesh: Mesh):
    """The full-attention layer on this rank's slab: local queries at global
    positions over the gathered K/V, under an explicit causal mask."""
    n_loc = x_local.shape[1]
    d = cfg.dim_head
    offset = mesh.coord(AXIS_SEQ) * n_loc
    positions = offset + torch.arange(n_loc, device=x_local.device)

    normed = rms_norm(x_local, params["norm_scale"], cfg.norm_eps)
    q = split_heads(normed @ params["w_q"].to(x_local.dtype), d)
    k = split_heads(normed @ params["w_k"].to(x_local.dtype), d)
    v = split_heads(normed @ params["w_v"].to(x_local.dtype), d)
    rq = apply_rotary(q, positions, cfg.rope_theta)
    rk = apply_rotary(k, positions, cfg.rope_theta)
    rk_full = gather_from_seq(rk, 2, mesh)
    v_full = gather_from_seq(v, 2, mesh)

    mask = None
    if cfg.causal:
        kj = torch.arange(rk_full.shape[2], device=x_local.device)
        mask = positions[:, None] >= kj[None, :]
    out = attend(rq, rk_full, v_full, mask=mask, scale=d ** -0.5)
    return merge_heads(out) @ params["w_out"].to(x_local.dtype)


def _cp_forward_local(params, cfg: ModelConfig, ids_local: torch.Tensor, mesh: Mesh):
    """The model on this rank's slab of ids [b, n_loc] -> float32 logits
    [b, n_loc, vocab].  The seq mesh is the current mesh inside, so the
    heads helpers of ``comm.py`` are the identity."""
    x = params["token_emb"][ids_local].to(_compute_dtype(cfg))
    attn_fn = cp_sparse_attention if cfg.use_sparse_attn else cp_full_attention
    with mesh:
        for layer in params["layers"]:
            x = x + attn_fn(layer["attn"], cfg, x, mesh)
            x = x + _ff_apply(layer["ff"], cfg, x)
    x = rms_norm(x, params["norm_scale"], cfg.norm_eps)
    return (x @ params["to_logits"].to(x.dtype)).float()


def context_parallel_forward(params, cfg: ModelConfig, ids: torch.Tensor, mesh: Mesh):
    """Logits [b, n, vocab] of ids [b, n] (the same on every rank), the
    sequence split over the ``seq`` ranks; every rank returns the whole
    logits.  ``n`` must divide by the number of ranks."""
    return gather_from_seq(_cp_forward_local(params, cfg, _local(ids, mesh), mesh), 1, mesh)


def context_parallel_loss(params, cfg: ModelConfig, ids: torch.Tensor, mesh: Mesh):
    """The mean next-token cross-entropy of ids [b, n + 1] (``transformer_
    loss``'s), sequence-split: the labels are shifted before the split, so
    they cross the ranks' boundaries.  Its value is Σ NLL / Σ count over the
    ranks on every rank; its gradient is this rank's NLL sum over the
    global count (sum the weights' gradients over the ranks after the
    backward: ``context_parallel_value_and_grad``)."""
    inp, labels = ids[:, :-1], ids[:, 1:]
    logits = _cp_forward_local(params, cfg, _local(inp, mesh), mesh)
    nll = F.cross_entropy(logits.flatten(0, 1), _local(labels, mesh).flatten().long(),
                          reduction="none")
    local = nll.sum()
    total = sum_over_seq(local, mesh)
    # the value is the global mean; the gradient the local sum's
    return (total + (local - local.detach())) / labels.numel()


def context_parallel_value_and_grad(params, cfg: ModelConfig, ids: torch.Tensor,
                                    mesh: Mesh) -> torch.Tensor:
    """``context_parallel_loss``, its backward, and the gradients of
    ``params`` (leaves that require grad, their ``.grad`` None or zero
    before) summed over the ``seq`` ranks.  Returns the loss, detached."""
    loss = context_parallel_loss(params, cfg, ids, mesh)
    loss.backward()
    sum_grads_over_seq(tree_leaves(params), mesh)
    return loss.detach()
