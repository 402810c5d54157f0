"""Parameter, batch and cache partitions of the (data, heads) mesh
(``nsa_tpu/parallel/sharding.py``).

Tensor parallelism over KV heads, JAX's table:

* q/k/v projections ``[dim, h*dh]``     -> column (``(None, "heads")``)
* output projection ``[h*dh, dim]``     -> row (``("heads", None)``; its
  output is summed over heads, ``comm.reduce_from_heads``)
* gate projection ``[dim, 3*h]``        -> column (its columns are
  head-major, so a rank's columns are its heads' gates)
* FF ``w1`` column, ``b1`` over heads, ``w2`` row, ``b2`` replicated;
  the swiglu FF's ``w3`` column as its ``w1`` (JAX's table replicates it
  and GSPMD reshards; the port's FF multiplies ``w1``'s and ``w3``'s
  columns elementwise, so both split alike)
* ``gate_b`` over heads, ``mem_kv [2, kvh, m, d]`` on axis 1, ``k_pos`` /
  ``v_pos [kvh, Bc, d]`` on axis 0
* the per-head compressors' leaves (``mlp``, ``conv``: leading ``kvh``)
  on axis 0
* norms, embeddings, the logits head   -> replicated
* decode caches ``[b, kvh, ...]``      -> ``("data", "heads")``
* token batches                        -> the batch axis on data (on dcn x
  data on a hierarchical mesh)

Where the port's table departs from JAX's: JAX shards every compressor leaf
of rank >= 2 on axis 0, and GSPMD quietly gathers back those whose axis 0
is not the KV heads (``attn``'s ``w_logits [d, d]``, ``shared_mlp``'s and
``single``'s weights, the ``transformer`` compressor's layers).  The port
shards by hand, so it replicates them: each heads rank applies the shared
weight to its own heads, its gradient summed over heads
(``comm.copy_to_heads``), and the ``transformer``
compressor, which mixes the KV heads, runs on every rank over the heads
gathered (``ops/nsa.py::_compress_kv``).  The packed decode weights
(``fuse_decode_params``) are packed by each rank from its own shard: JAX
replicates the fused projection ``w_qkvg``; the port's holds the rank's
own q, k, v and gate columns, each segment split over heads.  A spec is a
tuple with one entry a dimension: ``"heads"`` where it is split, None
elsewhere.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Tuple

import torch

from ..config import ModelConfig
from .comm import HEADS_SHARDED, gather_from_heads
from .mesh import AXIS_BATCH, AXIS_DATA, AXIS_HEADS, Mesh

Spec = Tuple[Optional[str], ...]

# split on axis 1: the column-parallel projections (and the full model's packed
# decode projection ``w_qkv``), ``mem_kv [2, kvh, m, d]``
_ON_AXIS_1 = {"w_q", "w_k", "w_v", "gate_w", "w1", "w3", "w_qkv", "mem_kv"}
# split on axis 0: the row-parallel projections, the per-head biases,
# ``k_pos`` / ``v_pos [kvh, Bc, d]``
_ON_AXIS_0 = {"w_out", "w2", "gate_b", "b1", "k_pos", "v_pos"}
# the compressors whose every leaf carries a leading kv_heads axis; the
# others' leaves are replicated
PER_HEAD_COMPRESSORS = ("mlp", "conv")
# packed decode weights: made again from the local shard (fuse_decode_params)
PACKS = ("decode_fused", "mega", "w_qkv")


def _on(ndim: int, axis: int) -> Spec:
    return tuple(AXIS_HEADS if i == axis else None for i in range(ndim))


def param_spec(path: Sequence, leaf: torch.Tensor, compressor: str = "mlp") -> Spec:
    """The spec of one parameter, keyed on its tree path (the keys from the
    root, list positions as ints) and, inside ``k_compress`` /
    ``v_compress``, on the model's compressor kind."""
    ndim = leaf.dim()
    name = path[-1] if path else ""
    replicated = (None,) * ndim
    if "decode_fused" in path and "attn" in path:
        # the layer's decode pack: per-KV-head packs on axis 0, mem_kv on
        # axis 1, the fused projection's columns split segment by segment
        return _on(ndim, 1) if name in ("mem_kv", "w_qkvg") else _on(ndim, 0)
    if any(p in ("k_compress", "v_compress") for p in path):
        # checked first: the compressors' w1 / w2 are not the FF's
        per_head = compressor in PER_HEAD_COMPRESSORS and ndim >= 2
        return _on(ndim, 0) if per_head else replicated
    if name in _ON_AXIS_1:
        return _on(ndim, 1)
    if name in _ON_AXIS_0:
        return _on(ndim, 0)
    return replicated


def _map(tree: Any, fn: Callable, path: tuple = ()) -> Any:
    """``fn(path, leaf)`` over a params tree, keeping its dicts and lists."""
    if isinstance(tree, dict):
        return {k: _map(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def _without_packs(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _without_packs(v) for k, v in tree.items() if k not in PACKS}
    if isinstance(tree, (list, tuple)):
        return [_without_packs(v) for v in tree]
    return tree


def params_pspecs(params: Any, compressor: str = "mlp") -> Any:
    """Every parameter's spec, in the params' tree layout."""
    return _map(params, lambda path, leaf: param_spec(path, leaf, compressor))


def _split_axis(spec: Spec) -> Optional[int]:
    return spec.index(AXIS_HEADS) if AXIS_HEADS in spec else None


def _narrow(x: torch.Tensor, axis: int, parts: int, index: int, what: str) -> torch.Tensor:
    if x.shape[axis] % parts:
        raise ValueError(f"{what}: size {x.shape[axis]} on axis {axis} does not split "
                         f"over {parts} ranks")
    size = x.shape[axis] // parts
    return x.narrow(axis, index * size, size)


def shard_params(params: Any, mesh: Mesh, cfg: ModelConfig) -> Any:
    """Full params (``utils/checkpoint.py::params_from_numpy``'s layout) ->
    this rank's local slices, contiguous copies.  Packed decode weights are
    left out: ``fuse_decode_params(local, local_config(cfg, mesh))`` packs
    them again from the local shard."""
    heads, index = mesh.heads, mesh.coord(AXIS_HEADS)

    def local(path, leaf):
        axis = _split_axis(param_spec(path, leaf, cfg.nsa.compressor))
        if axis is None or heads == 1:
            return leaf.clone()
        return _narrow(leaf, axis, heads, index, str(path)).contiguous()

    return _map(_without_packs(params), local)


def gather_params(local: Any, mesh: Mesh, cfg: ModelConfig) -> Any:
    """The full params on every rank, gathered over the heads axis (for a
    checkpoint); a collective, so every rank calls it."""
    def full(path, leaf):
        axis = _split_axis(param_spec(path, leaf, cfg.nsa.compressor))
        leaf = leaf.detach()
        return leaf.clone() if axis is None else gather_from_heads(leaf, axis)

    with mesh, torch.no_grad():
        return _map(_without_packs(local), full)


def gather_optimizer_state(optimizer: torch.optim.Optimizer, local: Any, mesh: Mesh,
                           cfg: ModelConfig) -> dict:
    """The optimizer's ``state_dict`` in the single-process layout: each
    moment of a split leaf gathered over heads (its parameters are listed in
    ``tree_leaves`` order, as ``make_optimizer`` lists them).  A
    collective, so every rank calls it; the optimizer is unchanged."""
    specs = []
    _map(local, lambda path, leaf: specs.append(param_spec(path, leaf, cfg.nsa.compressor)))
    state = optimizer.state_dict()

    def full(i, value):
        axis = _split_axis(specs[i])
        if axis is None or not torch.is_tensor(value) or value.dim() == 0:
            return value
        return gather_from_heads(value, axis)

    with mesh, torch.no_grad():
        state["state"] = {i: {k: full(i, v) for k, v in st.items()}
                          for i, st in state["state"].items()}
    return state


def mark_sharded(local: Any, mesh: Mesh, cfg: ModelConfig) -> None:
    """Mark each local parameter split over more than one heads rank
    (``comm.HEADS_SHARDED``), which the global gradient norm reads."""
    def mark(path, leaf):
        split = _split_axis(param_spec(path, leaf, cfg.nsa.compressor)) is not None
        setattr(leaf, HEADS_SHARDED, split and mesh.heads > 1)

    _map(local, mark)


def local_config(cfg: ModelConfig, mesh: Mesh) -> ModelConfig:
    """The config of one heads rank's shard: ``heads`` and ``kv_heads``
    divided by the heads axis."""
    t = mesh.heads
    if cfg.heads % t or cfg.kv_heads % t:
        raise ValueError(f"heads {cfg.heads} and kv_heads {cfg.kv_heads} must both split "
                         f"over the heads axis of {t}")
    return cfg.replace(heads=cfg.heads // t, kv_heads=cfg.kv_heads // t)


def shard_batch(batch: torch.Tensor, mesh: Mesh, batch_axis: int = 0) -> torch.Tensor:
    """This rank's slice of a token batch along ``batch_axis``: its data
    slice (its (dcn, data) slice on a hierarchical mesh)."""
    return _narrow(batch, batch_axis, mesh.batch, mesh.coord(AXIS_BATCH), "batch")


def cache_spec(leaf: torch.Tensor) -> Tuple[Optional[str], ...]:
    """Decode-cache arrays are ``[b, kvh, ...]``: batch on data, heads on
    the heads axis."""
    if leaf.dim() >= 2:
        return (AXIS_DATA, AXIS_HEADS) + (None,) * (leaf.dim() - 2)
    return (None,) * leaf.dim()


def shard_cache(cache: Any, mesh: Mesh) -> Any:
    """This rank's slice of a decode cache (a ``ModelCache``, a layer cache
    or a tuple of them) by ``cache_spec``: its batch slice and its KV
    heads."""
    if isinstance(cache, torch.Tensor):
        for axis, name in enumerate(cache_spec(cache)):
            if name is not None:
                slices = AXIS_BATCH if name == AXIS_DATA else name
                cache = _narrow(cache, axis, mesh.size(slices), mesh.coord(slices), "cache")
        return cache.contiguous()
    if isinstance(cache, tuple) and hasattr(cache, "_fields"):
        return type(cache)(*[shard_cache(v, mesh) for v in cache])
    if isinstance(cache, (list, tuple)):
        return type(cache)(shard_cache(v, mesh) for v in cache)
    return cache
