"""The (data, heads) mesh over ``torch.distributed`` process groups
(``nsa_tpu/parallel/mesh.py``).

JAX lays its devices out in a ``Mesh`` and lets GSPMD insert the
collectives.  Here every rank is one process, and a ``Mesh`` is that
process's place in the world: the axis names, the axes' sizes, this rank's
coordinates, and one process group per axis (made with ``new_group``):

* ``data``  - batch data parallelism (the gradients are averaged over it);
* ``heads`` - tensor parallelism over KV heads.  NSA's selection is per KV
  head, so every block gather reads only the rank's own KV heads; the row-
  parallel projections (``w_out``, the FF's ``w2``) are the only points
  where the activations are summed over it (``parallel/comm.py``);
* ``dcn``   - on ``make_hierarchical_mesh``, the inter-host tier: batches
  shard over (dcn, data), weights stay replicated over it;
* ``seq``   - on ``make_seq_mesh``, a mesh of its own: context parallelism
  (``parallel/context.py``), the sequence split over the ranks, weights
  replicated.  Under it the heads helpers of ``comm.py`` stay the identity.

Ranks are laid out row-major over the axes (the last axis varies fastest),
so the heads of one data slice are neighbouring ranks.  ``with mesh:``
makes the mesh current (as JAX's ``with mesh:``): the model's collective
points and the decode routes read it; without a current mesh everything
runs as one process.

The backend is always the caller's choice (``init_distributed``), and a
rank's device is ``cuda:{local_rank % device_count}`` (``rank_device``):
on a machine with one card every rank shares ``cuda:0`` under ``gloo``
(NCCL refuses two ranks on one device); with a card a rank the same code
runs ``nccl``.  Nothing here picks a backend or falls back to the CPU.
"""

from __future__ import annotations

import faulthandler
import math
import multiprocessing
import os
import pickle
import signal
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass, field
from datetime import timedelta
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import MeshConfig

AXIS_DATA = "data"
AXIS_HEADS = "heads"
AXIS_DCN = "dcn"
AXIS_SEQ = "seq"
# the group over the batch axes: the ranks that hold the same weight shards
# and split the batch (data, or dcn x data)
AXIS_BATCH = "batch"
BATCH_AXES = (AXIS_DCN, AXIS_DATA)

# a collective that waits longer than this fails the rank instead of hanging
GROUP_TIMEOUT_S = 120

_CURRENT: List["Mesh"] = []


@dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place on the mesh.  ``groups`` maps each axis name and
    ``"batch"`` to its process group; a mesh made without groups (the pure
    ``sharding`` helpers take only shapes and coordinates) cannot run a
    collective."""

    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    coords: Tuple[int, ...]
    groups: Dict[str, object] = field(default_factory=dict)
    backend: str = "gloo"

    def size(self, axis: str) -> int:
        if axis == AXIS_BATCH:
            return math.prod(s for a, s in zip(self.axis_names, self.shape) if a in BATCH_AXES)
        return dict(zip(self.axis_names, self.shape)).get(axis, 1)

    def coord(self, axis: str) -> int:
        if axis == AXIS_BATCH:       # the rank's place among the batch slices
            idx = 0
            for a, s, c in zip(self.axis_names, self.shape, self.coords):
                if a in BATCH_AXES:
                    idx = idx * s + c
            return idx
        return dict(zip(self.axis_names, self.coords)).get(axis, 0)

    @property
    def heads(self) -> int:
        return self.size(AXIS_HEADS)

    @property
    def batch(self) -> int:
        """Batch slices: the data axis's size, times the dcn axis's."""
        return self.size(AXIS_BATCH)

    def describe(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    def __enter__(self) -> "Mesh":
        _CURRENT.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _CURRENT.pop()


def current_mesh() -> Optional[Mesh]:
    """The innermost mesh entered with ``with mesh:``, or None."""
    return _CURRENT[-1] if _CURRENT else None


def heads_parallel() -> bool:
    """Whether a current mesh splits the heads over more than one rank."""
    mesh = current_mesh()
    return mesh is not None and mesh.heads > 1


def _build(axis_names: Tuple[str, ...], shape: Tuple[int, ...],
           n_ranks: Optional[int] = None) -> Optional[Mesh]:
    """The mesh of ``shape`` over the world's first ``n_ranks`` ranks (the
    whole world by default), with a group for each axis and for the batch
    axes; every rank of the world makes every group, in one order, as
    ``new_group`` requires, and a rank outside the mesh gets None."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed first")
    world, rank = dist.get_world_size(), dist.get_rank()
    n = world if n_ranks is None else n_ranks
    if math.prod(shape) != n or n > world:
        raise ValueError(f"mesh {dict(zip(axis_names, shape))} needs {math.prod(shape)} ranks, "
                         f"the world has {world}")
    grid = np.arange(n).reshape(shape)
    member = rank < n
    backend = dist.get_backend()
    groups = {}
    timeout = timedelta(seconds=GROUP_TIMEOUT_S)
    batch_axes = tuple(i for i, a in enumerate(axis_names) if a in BATCH_AXES)
    kinds = [(a, (i,)) for i, a in enumerate(axis_names)]
    if len(batch_axes) > 1:      # else the batch group is the data group
        kinds.append((AXIS_BATCH, batch_axes))
    for name, axes in kinds:
        # the groups of one kind: the ranks that differ only along ``axes``
        moved = np.moveaxis(grid, axes, tuple(range(-len(axes), 0)))
        for ranks in moved.reshape(-1, math.prod(grid.shape[a] for a in axes)):
            group = dist.new_group([int(r) for r in ranks], timeout=timeout, backend=backend)
            if rank in ranks:
                groups[name] = group
    if not member:
        return None
    if AXIS_DATA in groups:             # not on the seq mesh
        groups.setdefault(AXIS_BATCH, groups[AXIS_DATA])
    coords = tuple(int(c) for c in np.unravel_index(rank, shape))
    return Mesh(axis_names, tuple(shape), coords, groups, backend)


def make_mesh(data: Optional[int] = None, heads: int = 1) -> Mesh:
    """The (data, heads) mesh over the world; ``data`` defaults to the
    world's size over ``heads``."""
    world = dist.get_world_size()
    if data is None:
        if world % heads:
            raise ValueError(f"{world} ranks do not split over {heads} heads ranks")
        data = world // heads
    if data * heads != world:
        raise ValueError(f"mesh {data}x{heads} != {world} ranks")
    return _build((AXIS_DATA, AXIS_HEADS), (data, heads))


def make_hierarchical_mesh(dcn: int, data: int, heads: int) -> Mesh:
    """The multi-host-shaped (dcn, data, heads) mesh: batches shard over
    both dcn and data, so the gradient average spans the slow tier once;
    weights and tensor parallelism stay inside a host (replicated over
    dcn)."""
    if dcn * data * heads != dist.get_world_size():
        raise ValueError(f"mesh {dcn}x{data}x{heads} != {dist.get_world_size()} ranks")
    return _build((AXIS_DCN, AXIS_DATA, AXIS_HEADS), (dcn, data, heads))


def make_seq_mesh(n: Optional[int] = None) -> Optional[Mesh]:
    """The 1-D ``seq`` mesh (``nsa_tpu.parallel.context.make_seq_mesh``):
    one process group that carries the sequence, over the world's first
    ``n`` ranks (all by default), as ``auto_mesh``."""
    n = n or dist.get_world_size()
    return _build((AXIS_SEQ,), (n,), n)


def auto_mesh(n: Optional[int] = None, kv_heads: int = 4) -> Optional[Mesh]:
    """The largest heads axis dividing both ``kv_heads`` and ``n``; the
    rest becomes the data axis.  The mesh spans the world's first ``n``
    ranks (all by default), as JAX's takes its first ``n`` devices: every
    rank of the world calls it, and a rank past the first ``n`` gets
    None."""
    world = dist.get_world_size()
    n = n or world
    if not 0 < n <= world:
        raise ValueError(f"auto_mesh over {n} ranks, the world has {world}")
    return _build((AXIS_DATA, AXIS_HEADS), auto_mesh_config(n, kv_heads).shape, n)


def auto_mesh_config(n: int, kv_heads: int) -> MeshConfig:
    """``auto_mesh``'s shape for ``n`` ranks, without a world."""
    heads = math.gcd(kv_heads, n)
    return MeshConfig(data=n // heads, heads=heads)


def init_distributed(backend: str, rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     init_method: Optional[str] = None) -> None:
    """Join the world.  Without ``rank`` and ``world_size``, torchrun's
    environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` / ``MASTER_PORT``
    through ``env://``) gives them.  ``backend`` ("gloo" or "nccl") is the
    caller's: nothing here picks one."""
    if rank is None or world_size is None:
        rank, world_size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        init_method = init_method or "env://"
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, timeout=timedelta(seconds=GROUP_TIMEOUT_S))


def rank_device(device: str = "cuda") -> torch.device:
    """This rank's device: ``cuda:{local_rank % device_count}`` (made the
    current device), or the CPU when asked for it.  No card raises."""
    if device == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the ranks on the CPU")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    dev = torch.device("cuda", local % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def _rank_main(fn: Callable, rank: int, world: int, backend: str, store: str, out: str,
               args_path: str) -> None:
    """A spawned rank: one CPU thread, join the world, run ``fn(*args)``
    (the arguments read from ``args_path``), and write its result (or its
    traceback) for the parent.  Its output goes to ``<out>.log``, where
    SIGUSR1 dumps its threads' stacks."""
    log = open(out + ".log", "w", buffering=1)
    sys.stdout = sys.stderr = log
    faulthandler.register(signal.SIGUSR1, file=log, all_threads=True)
    torch.set_num_threads(1)
    try:
        with open(args_path, "rb") as f:    # written by run_ranks
            args = pickle.load(f)
        init_distributed(backend, rank, world, f"file://{store}")
        try:
            result = ("ok", fn(*args))
        finally:
            dist.destroy_process_group()
    except Exception:       # the parent reads the traceback, then the exit code
        result = ("error", traceback.format_exc())
    with open(out, "wb") as f:
        pickle.dump(result, f)
    log.flush()
    # straight out: the interpreter's teardown (collecting a card's worth of
    # objects, the CUDA context) adds seconds and has nothing left to do
    os._exit(0 if result[0] == "ok" else 1)


def run_ranks(fn: Callable, world: int, backend: str, args: Sequence = (),
              timeout_s: float = 60.0, workdir: Optional[str] = None,
              meanwhile: Optional[Callable[[], None]] = None) -> list:
    """Spawn ``world`` ranks (start method ``spawn``), each running
    ``fn(*args)`` in a world joined through a ``FileStore`` in ``workdir``
    (a temporary directory by default; no TCP port), one CPU thread each.
    Returns the ranks' results in rank order.  A rank that raises, dies or
    is still running after ``timeout_s`` fails the run: the other ranks are
    stopped at once (a peer of a dead rank would wait in its collectives)
    and ``RuntimeError`` raised, with the end of each rank's output (a
    stopped rank's stacks first).  ``meanwhile``, if given, runs here once
    the ranks are started (within their timeout); if it raises, the ranks
    are stopped and its exception propagates.  ``fn`` must be importable
    by name (spawned processes import it afresh).  The arguments go through
    a file: through the start pipe, a large one would hold each start until
    the rank before had imported ``fn``'s module."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        store = os.path.join(tmp, "store")
        args_path = os.path.join(tmp, "args.pkl")
        with open(args_path, "wb") as f:
            pickle.dump(tuple(args), f)
        outs = [os.path.join(tmp, f"rank{r}.pkl") for r in range(world)]
        procs = [ctx.Process(target=_rank_main, args=(fn, r, world, backend, store, outs[r],
                                                      args_path), daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            if meanwhile is not None:
                meanwhile()
            while (any(p.is_alive() for p in procs) and time.monotonic() < deadline
                   and not any(p.exitcode for p in procs)):
                time.sleep(0.05)
        finally:
            timed_out = time.monotonic() >= deadline
            hung = [r for r, p in enumerate(procs) if p.is_alive()]
            for r in hung:                   # where each stopped rank waits, into its log
                os.kill(procs[r].pid, signal.SIGUSR1)
            time.sleep(1.0 if hung else 0.0)
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(5)
        results, errors = [], []
        for r, (p, out) in enumerate(zip(procs, outs)):
            if not os.path.isfile(out):
                why = (("timed out" if timed_out else "stopped: another rank failed")
                       if r in hung else f"exited {p.exitcode} with no result")
                errors.append(f"rank {r}: {why}")
                continue
            with open(out, "rb") as f:     # written by the rank above
                status, value = pickle.load(f)
            if status != "ok":
                errors.append(f"rank {r} raised:\n{value}")
            results.append(value)
        if hung and not errors:
            errors.append(f"ranks {hung} timed out after {timeout_s}s")
        if errors:
            for r, out in enumerate(outs):
                if os.path.isfile(out + ".log"):
                    with open(out + ".log") as f:
                        tail = f.read()[-3000:]
                    errors.append(f"--- rank {r} output (end) ---\n{tail}")
            raise RuntimeError("\n".join(errors))
        return results
