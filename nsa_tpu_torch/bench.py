"""Decode throughput of the sparse model against the full-attention
baseline on the card (``bench.py``, the port's counterpart):

    python -m nsa_tpu_torch.bench [--quick] [--iters 3] [--device cuda]

The cell is ``bench.py``'s: the reference model (6 layers, dim 512, 8 / 4
heads), bs 64, prompt 3900, 100 greedy tokens, the cache pinned at 4096
rows (``--quick``: bs 8, prompt 500, the same cache), in bf16, on the
committed weights ``ckpt_export/sparse_mlp_seq4096.npz`` and
``ckpt_export/full_attn_seq4096.npz`` (a seeded random init, reported as
``"weights": "random"``, where a file is missing).  ``measure_decode``
times each model in turns, sparse, full, full, sparse, in one process; each
turn times ``--iters`` runs after a warm-up.  Every run's tok/s is printed,
then the median of each model's runs, the card's name and power limit, and
last one JSON line with ``bench.py``'s keys.

The prompt ids are seeded (``numpy.random.RandomState(0)``), where
``bench.py`` times zeros.  A measurement needs a CUDA card: without one it
raises.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from typing import Optional, Sequence

import torch

from .config import reference_model_config
from .eval.efficiency import decode_run_ms, require_cuda
from .models.transformer import init_transformer
from .utils.checkpoint import load_params_npz, model_config_from_meta, tree_to

REFERENCE_SPARSE_DECODE_TPS = 1080.2   # BASELINE.md: the reference's best sparse, bs 64
MODELS = (("sparse_mlp", True), ("full_attn", False))
TURNS = ("sparse_mlp", "full_attn", "full_attn", "sparse_mlp")
CELL = dict(batch=64, prompt=3900, gen=100)
QUICK_CELL = dict(batch=8, prompt=500, gen=100)
SEQ_LEN = 4096
SEED = 0
WEIGHTS_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "ckpt_export")


def load_model(name: str, sparse: bool, device):
    """(params, cfg, "trained" or "random"): ``<name>_seq4096.npz`` in bf16
    on ``device``, or a seeded random init when the file is missing."""
    path = os.path.join(WEIGHTS_DIR, f"{name}_seq4096.npz")
    if os.path.isfile(path):
        params, meta = load_params_npz(path, device=device, dtype=torch.bfloat16)
        cfg, source = model_config_from_meta(meta), "trained"
    else:
        print(f"# {name}: no {path}, random init from seed {SEED}", file=sys.stderr)
        cfg = reference_model_config(use_sparse_attn=sparse)
        params = tree_to(init_transformer(cfg, torch.Generator().manual_seed(SEED),
                                          device="cpu"), device, torch.bfloat16)
        source = "random"
    return params, cfg.replace(dtype="bfloat16"), source


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=30, check=True).stdout.strip().splitlines()[0]


def run_bench(quick: bool = False, iters: int = 3, device="cuda", models=None,
              log=print) -> dict:
    """Time both models in turns (``TURNS``) and return ``bench.py``'s
    result keys plus every run's tok/s under ``"samples"``.  ``models``
    maps a name to already loaded (params, cfg, source)."""
    device = require_cuda(device)
    cell = QUICK_CELL if quick else CELL
    b, n, gen = cell["batch"], cell["prompt"], cell["gen"]
    models = dict(models or {})
    for name, sparse in MODELS:
        if name not in models:
            models[name] = load_model(name, sparse, device)
    log(f"# prompt ids: numpy RandomState({SEED}).randint(0, 256, ({b}, {n})); "
        f"bench.py times zeros")
    samples = {name: [] for name, _ in MODELS}
    for turn, name in enumerate(TURNS):
        params, cfg, _ = models[name]
        ms = decode_run_ms(params, cfg, b, n, gen, iters, seq_len=SEQ_LEN, seed=SEED,
                           device=device)
        tps = [b * gen / (x / 1e3) for x in ms]
        samples[name] += tps
        log(f"# turn {turn} {name}: {' '.join(f'{x:.1f}' for x in tps)} decode tok/s "
            f"(bs {b}, prompt {n}, gen {gen}, max_len {SEQ_LEN})")
    sparse_tps = statistics.median(samples["sparse_mlp"])
    full_tps = statistics.median(samples["full_attn"])
    log(f"# median decode tok/s: sparse {sparse_tps:.1f}, full {full_tps:.1f}")
    return {
        "metric": f"NSA sparse decode tokens/s (bs {b}, prompt {n}, gen {gen})",
        "value": round(sparse_tps, 1),
        "unit": "tokens/s",
        "vs_baseline": round(sparse_tps / REFERENCE_SPARSE_DECODE_TPS, 3),
        "full_attn_tokens_per_s": round(full_tps, 1),
        "sparse_over_full": round(sparse_tps / full_tps, 3),
        "weights": ("trained" if all(m[2] == "trained" for m in models.values())
                    else "random"),
        "samples": samples,
    }


def main(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--quick", action="store_true", help="bs 8, prompt 500")
    p.add_argument("--iters", type=int, default=3, help="timed runs a turn")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    result = run_bench(args.quick, args.iters, args.device)
    print(f"# {card()}")
    result.pop("samples")
    print(json.dumps(result))


if __name__ == "__main__":
    main()
