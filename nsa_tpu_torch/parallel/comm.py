"""The collectives of the (data, heads) mesh, written out.

JAX writes none: GSPMD inserts the gradient psum over ``data`` and the
activation psum after the row-parallel projections.  The port places them
itself, at the points the model calls these helpers (Megatron's pattern):

* ``copy_to_heads``      - before a column-parallel projection: identity
  forward, sum over heads backward (the replicated input's gradient is the
  sum of every heads rank's part);
* ``reduce_from_heads``  - after a row-parallel projection: sum over heads
  forward, identity backward;
* ``gather_from_heads`` / ``scatter_to_heads`` - around a computation that
  mixes the KV heads (the ``transformer`` compressor): all-gather forward,
  this rank's slice backward, and the reverse;
* ``copy_to_heads`` again on a replicated weight that each heads rank
  applies to its own heads (the ``attn``, ``shared_mlp`` and ``single``
  compressors): its gradient is the sum of the ranks' parts;
* ``average_grads`` and ``grad_norm`` - the optimizer step's data-group
  gradient mean and the global norm it clips by;
* on the ``seq`` mesh of context parallelism (``parallel/context.py``),
  which takes its mesh as an argument: ``gather_from_seq`` (all-gather
  forward; backward the gradient summed over the ranks and this rank's
  slice kept, a reduce-scatter: every rank uses the gathered K/V with its
  own queries, so each rank's slice collects every rank's part),
  ``sum_over_seq`` (a sum with no gradient: the loss's totals) and
  ``sum_grads_over_seq`` (the replicated weights' gradients summed over the
  ranks, as JAX's transpose of a replicated ``in_specs=P()`` sums them, in
  one all-reduce after the backward).

Each reads the current mesh (``with mesh:``, ``parallel/mesh.py``) and is
the identity without one, or where its axis has one rank, so the
single-process path runs bit for bit as before.  The activation sums run in
float32 (a bf16 input is cast up and back), so a sum over heads adds no
rounding of its own beyond the cast.

``gloo`` takes CUDA tensors in every collective used here (it copies them
through the host): on an H100 with torch 2.11, ``chip_smoke.py``'s mesh
phase finds ``all_reduce``, ``broadcast``, ``all_gather`` and
``reduce_scatter_tensor`` right on them, so nothing is staged here.  A host
tensor (the serving engine's new tokens) is moved to the rank's card under
``nccl``, which takes only CUDA tensors.
"""

from __future__ import annotations

from typing import Iterable

import torch
import torch.distributed as dist

from .mesh import AXIS_BATCH, AXIS_HEADS, AXIS_SEQ, Mesh, current_mesh

# the attribute that marks a parameter split over the heads axis (set by
# ``sharding.mark_sharded``); ``grad_norm`` sums its square over heads
HEADS_SHARDED = "heads_sharded"


def _group(axis: str):
    """The current mesh's group along ``axis``, or None where there is no
    mesh or the axis has one rank (every helper is then the identity)."""
    mesh = current_mesh()
    if mesh is None or mesh.size(axis) == 1:
        return None
    return mesh.groups[axis]


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """A new tensor: ``x`` summed over ``group``, in float32 for a bf16 or
    fp16 ``x``."""
    wide = torch.float32 if x.dtype in (torch.bfloat16, torch.float16) else x.dtype
    y = x.to(wide, copy=True, memory_format=torch.contiguous_format)
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


def _all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's tensors concatenated along ``dim`` in group-rank order."""
    src = x.contiguous()
    if dist.get_backend(group) == "nccl" and not src.is_cuda:
        src = src.cuda()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(x.device)


def _local_slice(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n, i = dist.get_world_size(group), dist.get_rank(group)
    size = x.shape[dim] // n
    return x.narrow(dim, i * size, size).contiguous()


class _CopyToHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _local_slice(g, ctx.group, ctx.dim), None, None


class _GatherFromSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _local_slice(_all_reduce(g, ctx.group), ctx.group, ctx.dim), None, None


class _ScatterToHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _local_slice(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.dim), None, None


def copy_to_heads(x: torch.Tensor) -> torch.Tensor:
    """A replicated tensor that the heads ranks use each for their own
    heads: the input of a column-parallel projection (the normed activations
    before q/k/v/gate and before the FF's ``w1``) or a weight shared by the
    heads."""
    group = _group(AXIS_HEADS)
    return x if group is None else _CopyToHeads.apply(x, group)


def reduce_from_heads(x: torch.Tensor) -> torch.Tensor:
    """The output of a row-parallel projection (``w_out``, the FF's ``w2``):
    each heads rank holds a partial sum; every rank gets the whole."""
    group = _group(AXIS_HEADS)
    return x if group is None else _ReduceFromHeads.apply(x, group)


def gather_from_heads(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Every heads rank's slice of ``x`` along ``dim``, concatenated."""
    group = _group(AXIS_HEADS)
    return x if group is None else _GatherFromHeads.apply(x, group, dim)


def scatter_to_heads(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This heads rank's slice of ``x`` along ``dim`` (``x`` the same on
    every heads rank); the gradient is gathered back."""
    group = _group(AXIS_HEADS)
    return x if group is None else _ScatterToHeads.apply(x, group, dim)


def gather_batch(x: torch.Tensor) -> torch.Tensor:
    """Every batch slice's ``x`` concatenated along dim 0, in batch order
    (the serving engine's new tokens); the identity without a data axis."""
    group = _group(AXIS_BATCH)
    return x if group is None else _all_gather(x, group, 0)


def mean_over_batch(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the batch slices (a loss)."""
    group = _group(AXIS_BATCH)
    if group is None:
        return x
    return _all_reduce(x, group) / dist.get_world_size(group)


def average_grads(params: Iterable[torch.Tensor]) -> None:
    """Average every gradient over the batch slices (data, or dcn x data),
    in place, through one all-reduce of the gradients laid end to end.
    Never over the heads axis: a replicated leaf's gradient is already
    whole on every heads rank."""
    group = _group(AXIS_BATCH)
    if group is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def grad_norm(params: Iterable[torch.Tensor]) -> torch.Tensor:
    """The global L2 norm of the gradients, which ``ClippedAdam`` clips by.
    Without a heads axis every rank holds whole leaves, and the norm is
    ``clip_grad_norm_``'s own (``get_total_norm``), so the single-process
    step keeps its bits (``tests/test_torch_parallel.py::
    test_helpers_are_identity_without_a_mesh``).  Over heads the squares
    of the leaves split over heads (``HEADS_SHARDED``) are summed over the
    heads ranks, and the replicated leaves' counted once."""
    params = [p for p in params if p.grad is not None]
    group = _group(AXIS_HEADS)
    if group is None:
        return torch.nn.utils.get_total_norm([p.grad for p in params])
    marked = [getattr(p, HEADS_SHARDED, False) for p in params]
    split = torch.nn.utils.get_total_norm([p.grad for p, m in zip(params, marked) if m])
    whole = torch.nn.utils.get_total_norm([p.grad for p, m in zip(params, marked) if not m])
    return (_all_reduce(split.square(), group) + whole.square()).sqrt()


def _seq_group(mesh: Mesh):
    return None if mesh.size(AXIS_SEQ) == 1 else mesh.groups[AXIS_SEQ]


def gather_from_seq(x: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """Every ``seq`` rank's slice of ``x`` along ``dim``, concatenated in
    rank order; the gradient summed over the ranks, then sliced."""
    group = _seq_group(mesh)
    return x if group is None else _GatherFromSeq.apply(x, group, dim)


def sum_over_seq(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` summed over the ``seq`` ranks, outside autograd."""
    group = _seq_group(mesh)
    return x.detach() if group is None else _all_reduce(x.detach(), group)


def sum_grads_over_seq(params: Iterable[torch.Tensor], mesh: Mesh) -> None:
    """Sum every gradient over the ``seq`` ranks, in place, through one
    all-reduce of the gradients laid end to end (in float32)."""
    group = _seq_group(mesh)
    if group is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    dist.all_reduce(flat, group=group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
