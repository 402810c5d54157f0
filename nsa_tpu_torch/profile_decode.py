"""Branch-level timing of the sparse decode step on the card
(``scripts/profile_decode.py``, the port's counterpart):

    python -m nsa_tpu_torch.profile_decode [--full-only] [--device cuda]

The reference model (6 layers, dim 512, 8 / 4 heads, the ``mlp``
compressor), a seeded random init in bf16, prefills bs 64 x 128 seeded
prompt ids into a 4096-row cache; then 50 greedy decode steps, the
captured loop of ``greedy_decode``, are timed in full and under each value
of ``NSA_ABLATE`` (``ops/nsa.py::decode_ablation``): ``no_fine``,
``no_compressed``, ``no_emit`` and ``attn_only`` drop the fine and sliding
branches, the compressed branch, the emission, or all three, and move the
step off the kernels they drop.  Each setting times 3 runs after a warm-up,
which captures its own graph (a graph is keyed on the value), each run
from a copy of the prefilled cache, and prints the fastest run's ms a step,
as JAX's script does.  bs 64 decodes on the split route; the whole-model
kernel at b <= 8 ignores the hook.

The prompt ids are seeded (``numpy.random.RandomState(0)``), where JAX's
script decodes zeros.  A measurement needs a CUDA card: without one it
raises; ``--device cpu`` runs the same steps on the host clock, for the
tests only.
"""

from __future__ import annotations

import argparse
import contextlib
import os
from typing import Optional, Sequence

import torch

from .config import reference_model_config
from .eval.efficiency import clone_cache, copy_cache, host_ms, require_cuda, seeded_ids, \
    timed_ms
from .models.transformer import fuse_decode_params, greedy_decode, init_transformer, \
    transformer_prefill
from .ops.nsa import ABLATIONS
from .utils.checkpoint import tree_to

BATCH, PROMPT, GEN, MAX_LEN = 64, 128, 50, 4096
ITERS = 3
SEED = 0


@contextlib.contextmanager
def ablation(value: str):
    """``NSA_ABLATE`` set to ``value`` ("" for none) inside the block, and
    as it was after it."""
    old = os.environ.pop("NSA_ABLATE", None)
    if value:
        os.environ["NSA_ABLATE"] = value
    try:
        yield
    finally:
        os.environ.pop("NSA_ABLATE", None)
        if old is not None:
            os.environ["NSA_ABLATE"] = old


def seeded_model(device):
    """(params, cfg): the reference model from seed ``SEED``, in bf16 on
    ``device``."""
    cfg = reference_model_config().replace(dtype="bfloat16")
    params = init_transformer(cfg, torch.Generator().manual_seed(SEED), device="cpu")
    return tree_to(params, device, torch.bfloat16), cfg


def prefilled(params, cfg, batch: int, prompt: int, max_len: int, device):
    """(first token [batch], cache) after the prefill of seeded prompt ids."""
    ids = seeded_ids(batch, prompt, cfg.vocab_size, SEED, device)
    with torch.no_grad():
        logits, cache = transformer_prefill(params, cfg, ids, max_len)
    return logits[:, -1].argmax(-1), cache


def step_ms(params, cfg, first, cache, gen: int, iters: int, device) -> float:
    """The fastest of ``iters`` greedy decode runs of ``gen`` steps from
    ``first`` and a copy of ``cache`` (left as it is), after a warm-up run,
    in ms a step: device time on the card, host time on the CPU."""
    clock = timed_ms if device.type == "cuda" else host_ms
    run_cache, runs = clone_cache(cache), []
    with torch.no_grad():
        for i in range(iters + 1):
            copy_cache(run_cache, cache)
            ms = clock(lambda: greedy_decode(params, cfg, first, run_cache, gen), device)
            if i:
                runs.append(ms)
    return min(runs) / gen


def profile(params, cfg, values=("",) + ABLATIONS, *, batch: int = BATCH, prompt: int = PROMPT,
            gen: int = GEN, max_len: int = MAX_LEN, iters: int = ITERS, device="cuda",
            log=print) -> dict:
    """ms a decode step under each ``NSA_ABLATE`` value of ``values`` (""
    for the full step), all from one prefill; ``log`` gets a line each."""
    device = torch.device(device)
    params = fuse_decode_params(params, cfg)
    first, cache = prefilled(params, cfg, batch, prompt, max_len, device)
    out = {}
    for value in values:
        with ablation(value):
            ms = step_ms(params, cfg, first, cache, gen, iters, device)
        out[value or "full"] = ms
        log(f"full step: {ms:.3f} ms  ({batch / ms * 1000:.0f} tok/s)" if not value
            else f"{value}: {ms:.3f} ms")
    return out


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--full-only", action="store_true", help="time the full step only")
    p.add_argument("--device", default="cuda",
                   help="cuda (the measurement); cpu runs on the host clock, for the tests")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type != "cpu":
        device = require_cuda(device)
    params, cfg = seeded_model(device)
    values = ("",) if args.full_only else ("",) + ABLATIONS
    return profile(params, cfg, values, device=device)


if __name__ == "__main__":
    main()
