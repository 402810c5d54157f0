"""Serving-engine throughput on the card (continuous batching)
(``scripts/serve_bench.py``, the same flags and printed keys, plus
``--device``).

Measures end-to-end engine tokens/s: admission (bucketed whole-prompt
prefill in waves) plus ragged decode, for the reference NSA model:

    python -m nsa_tpu_torch.serve_bench --max-batch 8 --requests 16 \\
        --prompt-len 480 --gen 64 [--steps-per-sync 8] [--ckpt PATH] \\
        [--paged-pages N --page-tokens 64]

``--ckpt`` takes a training checkpoint (a run directory or one of its
``step_*`` directories) or an exported ``.npz``; without it the weights are
a random init from seed 0.  Timing is wall clock over the whole ``run()``
(prefills, decode and host bookkeeping), after one warm-up run of the same
requests.  A measurement needs a CUDA card: without one it raises.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from .config import reference_model_config
from .eval.efficiency import require_cuda
from .models.transformer import init_transformer
from .serve import ContinuousBatchingEngine
from .utils.checkpoint import load_params, tree_to


def load_model(args, device):
    """(params, cfg) from ``--ckpt`` or a seeded random init, in the
    compute dtype on ``device``."""
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    if args.ckpt:
        params, cfg, _ = load_params(args.ckpt, device, dtype)
    else:
        cfg = reference_model_config(use_sparse_attn=not args.full_attention)
        params = tree_to(init_transformer(cfg, torch.Generator().manual_seed(0), device="cpu"),
                         device, dtype)
    return params, cfg.replace(attn_impl=args.attn_impl, dtype=args.dtype)


def main(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--max-len", type=int, default=1024)
    p.add_argument("--requests", type=int, default=16)
    p.add_argument("--prompt-len", type=int, default=480)
    p.add_argument("--gen", type=int, default=64)
    p.add_argument("--steps-per-sync", type=int, default=8)
    p.add_argument("--full-attention", action="store_true")
    p.add_argument("--ckpt", default=None,
                   help="checkpoint dir or exported .npz to load trained weights from")
    # carried into the config for compatibility; the port has one path
    p.add_argument("--attn-impl", default="pallas", choices=["reference", "xla", "pallas"])
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--paged-pages", type=int, default=None,
                   help="use the paged KV pool with this many pages "
                        "(kv memory scales with live tokens)")
    p.add_argument("--page-tokens", type=int, default=64)
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = require_cuda(args.device)
    params, cfg = load_model(args, device)

    rng = np.random.RandomState(0)
    prompts = [rng.randint(32, 127, size=args.prompt_len).astype(np.int32)
               for _ in range(args.requests)]

    def run_once():
        eng = ContinuousBatchingEngine(
            params, cfg, max_batch=args.max_batch, max_len=args.max_len,
            prefill_buckets=(128, 256, 512), steps_per_sync=args.steps_per_sync,
            temperature=args.temperature, paged_pool_pages=args.paged_pages,
            page_tokens=args.page_tokens,
        )
        kv_bytes = sum(c.kv.numel() * c.kv.element_size() for c in eng.cache_layers)
        for pr in prompts:
            eng.add_request(pr, max_new_tokens=args.gen)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        outs = eng.run()
        torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        return dt, sum(len(v) for v in outs.values()), kv_bytes

    with torch.inference_mode():
        run_once()               # warm-up: kernel build, allocator, cuBLAS
        dt, total_new, kv_bytes = run_once()
    print(f"device: {torch.cuda.get_device_name(device)}")
    print({
        "requests": args.requests,
        "prompt_len": args.prompt_len,
        "gen": args.gen,
        "max_batch": args.max_batch,
        "steps_per_sync": args.steps_per_sync,
        "paged_pages": args.paged_pages,
        "kv_pool_mib": round(kv_bytes / 2**20, 1),
        "wall_s": round(dt, 3),
        "new_tokens_per_s": round(total_new / dt, 1),
        "requests_per_s": round(args.requests / dt, 2),
    })


if __name__ == "__main__":
    main()
