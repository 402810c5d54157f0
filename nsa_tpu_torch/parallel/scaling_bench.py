"""Weak scaling of the sharded training step over (data, heads) meshes of
increasing size (``scripts/scaling_bench.py``).

One spawn of as many ranks as the largest mesh (``mesh.run_ranks``) times
``sharded_train_step`` on each mesh size in turn, over the world's first
ranks (``mesh.auto_mesh(n)``, as JAX's takes its first devices), on a
batch of ``per_device_batch x ranks`` rows: the work a rank holds stays
the same, so ideal scaling keeps the step time flat.  The efficiency (t1 / tN) is recorded only where every rank has a
card of its own; where the ranks share one card (``gloo``: NCCL refuses two
ranks on one device) or run on the CPU, the rows carry
``metric_validity`` ``"shared_card"`` or ``"structural_only_cpu_mesh"``
and no efficiency, as JAX's virtual CPU mesh does.

On the card the model is the reference widths at depth 2 in bf16
(``train_step.dryrun_config(kernels=True)``; JAX's ``dim_head`` 16 is below
what the kernels take); on the CPU JAX's own tiny model:

    python -m nsa_tpu_torch.parallel.scaling_bench --devices 1 2 4 [--device cpu]
"""

from __future__ import annotations

import argparse
import subprocess
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..config import TrainConfig, tiny_test_config
from ..ops.cuda import runtime
from ..utils.metrics import CSVLogger
from .mesh import auto_mesh, rank_device, run_ranks
from .train_step import dryrun_config, make_sharded_train_state, sharded_train_step

RANK_TIMEOUT_S = 300


def bench_model(device: str):
    """The benchmark's model: the reference widths at depth 2 on the card,
    JAX's tiny scaling model on the CPU."""
    if device == "cpu":
        return tiny_test_config(heads=8, kv_heads=4, dim=128, dim_head=16)
    return dryrun_config(kernels=True)


def _bench_rank(sizes: Sequence[int], seq_len: int, per_device_batch: int, iters: int,
                device: str) -> dict:
    """One rank of the world of ``max(sizes)`` ranks: for each mesh size n,
    ``auto_mesh(n)`` over the first n ranks and, on those, the median
    seconds of ``iters`` sharded steps after one warm-up step, while the
    other ranks wait at a barrier.  Returns {n: {"mesh", "step_s"}} for
    the sizes this rank was in."""
    dev = rank_device(device)
    if dev.type == "cuda":
        runtime.require_built()
    cfg = bench_model(device)
    out = {}
    for n in sizes:
        mesh = auto_mesh(n, kv_heads=cfg.kv_heads)
        if mesh is not None:
            global_batch = per_device_batch * n
            train_cfg = TrainConfig(batch_size=global_batch, seq_len=seq_len,
                                    grad_accum_every=1)
            params, optimizer = make_sharded_train_state(cfg, train_cfg, mesh, device=dev)
            batch = torch.zeros((1, global_batch, seq_len + 1), dtype=torch.long, device=dev)

            def step():
                float(sharded_train_step(params, optimizer, batch, cfg, 1, mesh))   # waits

            step()
            times = []
            for _ in range(iters):
                t0 = time.perf_counter()
                step()
                times.append(time.perf_counter() - t0)
            out[n] = {"mesh": mesh.describe(), "step_s": float(np.median(times))}
            del params, optimizer
        dist.barrier()
    return out


def scaling_row(n_ranks: int, seq_len: int, per_device_batch: int, res: dict) -> dict:
    """JAX's CSV row of one mesh size from rank 0's figures."""
    global_batch = per_device_batch * n_ranks
    dt = res["step_s"]
    tokens = global_batch * seq_len
    return {
        "n_devices": n_ranks,
        "mesh_data": res["mesh"]["data"],
        "mesh_heads": res["mesh"]["heads"],
        "global_batch": global_batch,
        "seq_len": seq_len,
        "step_ms": round(dt * 1000, 2),
        "step_s": dt,
        "tokens_per_s": round(tokens / dt, 1),
        "tokens_per_s_per_device": round(tokens / dt / n_ranks, 1),
    }


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=30, check=True).stdout.strip().splitlines()[0]


def run_scaling(devices: Sequence[int], seq_len: int, per_device_batch: int, backend: str,
                device: str, csv: Optional[str] = None, iters: int = 5) -> list:
    """The rows of every mesh size in ``devices``, from one spawn of
    ``max(devices)`` ranks; on the card the kernels are built here first,
    and the ranks only load them."""
    if device != "cpu":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass --device cpu to run the ranks on the CPU")
        runtime.library()
    figures = run_ranks(_bench_rank, max(devices), backend,
                        (tuple(devices), seq_len, per_device_batch, iters, device),
                        timeout_s=RANK_TIMEOUT_S)[0]
    return scaling_rows(devices, seq_len, per_device_batch, figures, device, csv)


def scaling_rows(devices: Sequence[int], seq_len: int, per_device_batch: int, figures: dict,
                 device: str, csv: Optional[str] = None) -> list:
    """The CSV rows of rank 0's ``_bench_rank`` figures: the efficiency
    only where every mesh has a card a rank, else the validity says why
    not; each row printed and, with ``csv``, appended there."""
    logger = CSVLogger(csv) if csv else None
    if device == "cpu":
        validity, smi = "structural_only_cpu_mesh", ""
    else:
        smi = card_line()
        validity = "real_devices" if torch.cuda.device_count() >= max(devices) else "shared_card"
    rows, base_t = [], None
    for n in devices:
        row = scaling_row(n, seq_len, per_device_batch, figures[n])
        base_t = row["step_s"] if base_t is None else base_t
        row["weak_scaling_efficiency"] = (round(base_t / row["step_s"], 3)
                                          if validity == "real_devices" else "")
        row["metric_validity"] = validity
        row["card"] = smi
        del row["step_s"]
        if logger:
            logger.append(row)
        print(row, flush=True)
        rows.append(row)
    return rows


def main(argv: Optional[Sequence[str]] = None) -> list:
    p = argparse.ArgumentParser(description="Weak scaling of the sharded training step.")
    p.add_argument("--devices", nargs="+", type=int, default=[1, 2, 4],
                   help="the mesh sizes (ranks) to run")
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--per-device-batch", type=int, default=2)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--backend", default="gloo", choices=["gloo", "nccl"])
    p.add_argument("--device", default="cuda")
    p.add_argument("--csv", default="exp_result_torch/scaling.csv")
    args = p.parse_args(argv)
    return run_scaling(args.devices, args.seq_len, args.per_device_batch, args.backend,
                       args.device, args.csv, args.iters)


if __name__ == "__main__":
    from nsa_tpu_torch.parallel import scaling_bench as _module   # the ranks import it by name

    _module.main()
