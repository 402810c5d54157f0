"""Long-context (16k) end-to-end efficiency on the card: the sparse model
against the full-attention one (``scripts/efficiency_16k.py``, the same
flags and defaults, plus the weights' paths and ``--device``):

    python -m nsa_tpu_torch.eval.efficiency_16k [--bs 1 8 16] [--prompts 8000 15000]

It runs ``run_efficiency_sweep`` at ``seq_len`` = ``--max-len`` (16,384):
each prompt right-padded to its admission bucket (8,000 -> 8,192, 15,000
-> 16,384) and prefilled, then ``--gen`` greedy steps against a cache of
``--max-len`` rows, both models on their seq-4096 weights in bf16 (the
models carry over to longer positions through rotary; this measures
speed).  The sparse model prefills on row 1 at n 8,192 / 16,384 and
decodes on the whole-model kernel at b <= 8 and the split pair above; the
full model prefills on row 13 and decodes with plain attention over its
16,384-row cache.  The rows go to ``--csv`` (the JAX package's columns) and
to stdout.

``--sparse-ckpt`` and ``--full-ckpt`` take an exported ``.npz`` (the
committed ``ckpt_export/*_seq4096.npz`` by default) or a port checkpoint
directory.  A measurement needs a CUDA card: without one it raises;
``--device cpu`` is for the tests, which run tiny checkpoints through the
same path on the host clock (``host_ms``), no device figure.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import torch

from ..utils.checkpoint import load_params
from .efficiency import require_cuda, run_efficiency_sweep

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SPARSE_WEIGHTS = os.path.join(ROOT, "ckpt_export", "sparse_mlp_seq4096.npz")
FULL_WEIGHTS = os.path.join(ROOT, "ckpt_export", "full_attn_seq4096.npz")


def main(argv: Optional[Sequence[str]] = None) -> list:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--bs", nargs="+", type=int, default=[1, 8, 16])
    p.add_argument("--prompts", nargs="+", type=int, default=[8000, 15000])
    p.add_argument("--gen", type=int, default=100)
    p.add_argument("--max-len", type=int, default=16384)
    p.add_argument("--csv", default="exp_result_torch/efficiency_seq16k.csv")
    p.add_argument("--sparse-ckpt", default=SPARSE_WEIGHTS)
    p.add_argument("--full-ckpt", default=FULL_WEIGHTS)
    p.add_argument("--models", nargs="+", default=["sparse", "full"],
                   choices=["sparse", "full"])
    p.add_argument("--iters", type=int, default=3,
                   help="timed prefill and decode runs a cell, after a warm-up (JAX's 3)")
    p.add_argument("--device", default="cuda", help="cuda; cpu for the tests only")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type != "cpu":
        device = require_cuda(device)
    if args.csv:
        os.makedirs(os.path.dirname(args.csv) or ".", exist_ok=True)

    rows = []
    for model in args.models:
        path = args.sparse_ckpt if model == "sparse" else args.full_ckpt
        params, cfg, _ = load_params(path, device, torch.bfloat16)
        cfg = cfg.replace(dtype="bfloat16")
        mt = "sparse_mlp" if model == "sparse" else "full"
        print(f"== {mt} @ max_len {args.max_len} ==", flush=True)
        rows += run_efficiency_sweep(params, cfg, mt, args.bs, args.prompts, gen_len=args.gen,
                                     seq_len=args.max_len, csv_path=args.csv, step=5000,
                                     device=device, host_clock=device.type == "cpu",
                                     iters=args.iters)
        del params
    return rows


if __name__ == "__main__":
    main()
