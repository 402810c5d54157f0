"""Decode loops as captured CUDA graphs: the port's counterpart of JAX's
jitted decode ``lax.scan`` (``nsa_tpu/eval/efficiency.py:141-172``,
``nsa_tpu/models/transformer.py:594-658``, ``nsa_tpu/serve.py:49-148``).

JAX runs each decode loop as one compiled program.  Here a loop is a step
``body(state)`` run ``n`` times, where ``state`` holds the loop's carried
values as device tensors (the token, the position, the step counter, the
tokens so far) and the body updates them in place: it reads the position
from the device and writes the next token and position there, so nothing
goes back to the host between steps.  The caches and weights the body
reads are written in place at their own addresses.

On the card, ``decode_loop`` captures the body once as a CUDA graph and
replays it: the first step runs eagerly on a side stream (the warm-up,
which also does that step's work), the body is captured, and the other
``n - 1`` steps are replays.  A graph is kept and replayed by the next
loop with the same key, which ``decode_loop`` builds from what the caller
names: the body's code, the tensors it reads or writes besides the state
(``reads``: the weights and caches, by address, shape and dtype), the other
values it closes over (``opts``: the config, the route, the temperature),
the environment switches a step reads (named by the modules that read
them, through ``key_env``),
the generators it draws from (the objects themselves, which the key keeps
alive), and the state's shapes.  The replaying loop's state tensors are the
graph's own, into which the caller's starting values are copied.  Each replay adds to the kernel
wrappers' ``launches`` counters what one captured step launched.  A capture
or launch error raises; nothing falls back to the eager loop.

On the CPU, or with ``capture=False`` on the card (to hold the graph
against the eager steps), the same body runs eagerly ``n`` times.  Under a
mesh (``parallel/mesh.py``) ``capture=True`` raises: the steps' collectives
go through ``gloo``, which copies through the host and cannot be captured
(``nccl``, which could be, is not verified on a machine with one card).
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Callable, Dict, Hashable, Iterable, Sequence

import torch

from ..ops.cuda import (
    flash,
    nsa_decode,
    nsa_decode_fused,
    nsa_decode_mega,
    nsa_decode_ragged,
    nsa_prefill,
    paged_gather,
)
from ..parallel.mesh import current_mesh

# every kernel wrapper's launch counter, which a replay advances as the
# captured step's launches did
COUNTED = (nsa_prefill.prefill_fwd, nsa_prefill.prefill_bwd_dq, nsa_prefill.prefill_bwd_dkv,
           nsa_decode.decode_select, nsa_decode.decode_attend,
           nsa_decode_fused.decode_select_emit, nsa_decode_fused.decode_attend_fused,
           nsa_decode_mega.decode_step_mega, nsa_decode_ragged.decode_select_emit_ragged,
           nsa_decode_ragged.decode_attend_fused_ragged,
           nsa_decode_ragged.decode_attend_fused_paged, paged_gather.paged_gather,
           flash.flash_attention)

MAX_GRAPHS = 8      # graphs kept at once; the least recently used goes first

# the environment switches that choose what a step launches, read as the
# step runs, which the modules that read them name (``key_env``): a graph
# is replayed only under the settings it was captured under
_STEP_ENV: list = []

State = Dict[str, torch.Tensor]


def _addresses(trees) -> tuple:
    """(data pointer, shape, dtype) of every tensor in nested dicts, lists,
    tuples and NamedTuples, in order: what a captured graph reads at fixed
    addresses, for its key."""
    out = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append((x.data_ptr(), tuple(x.shape), x.dtype))
        elif isinstance(x, dict):
            for k in sorted(x, key=str):
                walk(x[k])
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(trees)
    return tuple(out)


def _counts() -> list:
    return [fn.launches for fn in COUNTED]


def _add_counts(delta: Sequence[int]) -> None:
    for fn, d in zip(COUNTED, delta):
        fn.launches += d


class StepGraph:
    """One captured step: the graph, the state tensors it reads and writes
    at fixed addresses, and the launches it makes."""

    def __init__(self, body: Callable[[State], None], state: State,
                 generators: Iterable[torch.Generator] = ()):
        self.state = state
        device = next(iter(state.values())).device
        # the warm-up: the loop's first step, eager, on a side stream
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            body(state)
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        for gen in generators:
            self.graph.register_generator_state(gen)
        before = _counts()
        with torch.cuda.graph(self.graph):
            body(state)
        after = _counts()
        # capture launches nothing: the counts go back, and each replay adds them
        self.launches = [a - b for a, b in zip(after, before)]
        _add_counts([-d for d in self.launches])

    def replay(self) -> None:
        self.graph.replay()
        _add_counts(self.launches)


_GRAPHS: "OrderedDict[Hashable, StepGraph]" = OrderedDict()


def clear() -> None:
    """Drop every kept graph and its memory pool."""
    _GRAPHS.clear()


def key_env(names: Iterable[str]) -> None:
    """Key every graph also on the environment switches ``names``, which a
    step reads as it runs."""
    _STEP_ENV.extend(n for n in names if n not in _STEP_ENV)


def step_key(state: State, body: Callable[[State], None], reads=(), opts: Hashable = (),
             generators: Sequence[torch.Generator] = ()) -> tuple:
    """The key a captured step is kept and replayed by (see the module
    note), the environment switches' values as they stand now among it."""
    device = next(iter(state.values())).device
    return (body.__code__, opts, tuple(os.environ.get(k) for k in _STEP_ENV),
            _addresses(reads), tuple(generators), device,
            tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(state.items())))


def decode_loop(state: State, body: Callable[[State], None], n: int, *,
                reads=(), opts: Hashable = (), capture: bool = True,
                generators: Sequence[torch.Generator] = ()) -> State:
    """Run ``body(state)`` ``n`` times and return the state after the last
    step.  ``state`` holds the starting values, fresh tensors on one device.
    Everything else the body reads must be named, since a kept graph is
    replayed for the same names (see the module note): ``reads`` the
    tensors (nested dicts, lists, tuples), ``opts`` the other values it
    closes over (hashable), and ``generators`` the CUDA generators it draws
    from (each replay then draws fresh numbers, as the eager steps would).
    Captured, the returned tensors are the graph's own: copy out what is
    kept before the next loop with this key."""
    device = next(iter(state.values())).device
    if capture and current_mesh() is not None:
        raise ValueError("a decode loop under a mesh runs eagerly: its collectives cannot be "
                         "captured in a CUDA graph; pass capture=False")
    if n <= 0:
        return state
    if device.type != "cuda" or not capture:
        for _ in range(n):
            body(state)
        return state
    key = step_key(state, body, reads, opts, generators)
    step = _GRAPHS.get(key)
    if step is None:
        step = StepGraph(body, state, generators)          # runs the first step
        n -= 1
        _GRAPHS[key] = step
        while len(_GRAPHS) > MAX_GRAPHS:
            _GRAPHS.popitem(last=False)
    else:
        _GRAPHS.move_to_end(key)
        for k, v in state.items():
            step.state[k].copy_(v)
    for _ in range(n):
        step.replay()
    return step.state


def device_scalar(value: int, device, dtype=torch.int32) -> torch.Tensor:
    """A 0-d tensor holding ``value`` on ``device`` (a fill, no host sync)."""
    return torch.full((), value, dtype=dtype, device=device)


def graph_count() -> int:
    """How many captured graphs are kept."""
    return len(_GRAPHS)
