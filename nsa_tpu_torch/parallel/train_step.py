"""The sharded training step over the (data, heads) mesh, and the dry run
(``nsa_tpu/parallel/train_step.py``).

Each rank holds its heads shard of the weights (``sharding.shard_params``)
and its data slice of every batch (``sharding.shard_batch``); the model's
collective points (``comm.py``) sum the row-parallel outputs over heads,
and the step averages the gradients over the data slices and clips them by
their global norm (``train/pretrain.py::train_step`` and ``ClippedAdam``
under ``with mesh:``), where JAX lets GSPMD insert the same psums.

``dryrun`` spawns the ranks and runs JAX's ``dryrun`` on them, but for its
context-parallel block (context parallelism is not ported yet): one
sharded train step (on the kernels when the ranks are on the card), a
sharded prefill and decode step, the hierarchical (dcn, data, heads) mesh
at 8 ranks or more against the flat one, and the serving engine over the
mesh token for token against one process:

    python -m nsa_tpu_torch.parallel.train_step --ranks 4 --backend gloo [--device cpu]

The port's counterpart of ``__graft_entry__.dryrun_multichip``.  On a
machine with one card every rank shares it (``gloo``; NCCL refuses two
ranks on one device), and the parent builds the kernels before the ranks
start, which only load them.
"""

from __future__ import annotations

import argparse
import math
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import ModelConfig, NSAConfig, TrainConfig, reference_model_config
from ..models.transformer import (
    fuse_decode_params,
    init_transformer,
    transformer_decode_step,
    transformer_prefill,
)
from ..ops.cuda import runtime
from ..serve import ContinuousBatchingEngine
from ..train.pretrain import ClippedAdam, make_optimizer, train_step, trainable
from .comm import mean_over_batch
from .mesh import Mesh, auto_mesh, make_hierarchical_mesh, rank_device, run_ranks
from .sharding import gather_params, local_config, mark_sharded, shard_batch, shard_params

DRYRUN_TIMEOUT_S = 600


def shard_trainable(params, mesh: Mesh, cfg: ModelConfig, device=None):
    """Full params -> this rank's float32 trainable shard on ``device``,
    its split leaves marked for the global gradient norm."""
    local = trainable(shard_params(params, mesh, cfg), device)
    mark_sharded(local, mesh, cfg)
    return local


def make_sharded_train_state(model_cfg: ModelConfig, train_cfg: TrainConfig, mesh: Mesh,
                             seed: int = 0, device="cuda"):
    """Params from a seeded init (every rank draws the same full init and
    keeps its shard) and their optimizer: (params, optimizer)."""
    full = init_transformer(model_cfg, torch.Generator().manual_seed(seed), device="cpu")
    params = shard_trainable(full, mesh, model_cfg, device)
    return params, make_optimizer(train_cfg, params)


def sharded_train_step(params, optimizer: ClippedAdam, batch: torch.Tensor, cfg: ModelConfig,
                       accum: int, mesh: Mesh) -> torch.Tensor:
    """One optimizer step over the mesh.  ``batch`` [accum, global_batch,
    seq + 1] is the whole batch, the same on every rank, which takes its
    data slice; ``params`` the rank's shard, updated in place; ``cfg`` the
    full model's.  Returns the mean loss over the whole batch."""
    local = shard_batch(batch, mesh, batch_axis=1)
    with mesh:
        loss = train_step(params, optimizer, local, local_config(cfg, mesh), accum)
        return mean_over_batch(loss)


def dryrun_config(kernels: bool = False) -> ModelConfig:
    """JAX's dryrun model (2 layers, dim 64, 8 heads over 4 KV heads,
    dim_head 16, small NSA blocks), or with ``kernels`` the reference
    model's widths and NSA blocks at 2 layers: JAX's dim_head 16 is below
    what the port's kernels take (64)."""
    if kernels:
        return reference_model_config().replace(depth=2, dtype="bfloat16")
    return ModelConfig(
        vocab_size=256, dim=64, depth=2, dim_head=16, heads=8, kv_heads=4,
        nsa=NSAConfig(sliding_window_size=8, compress_block_size=4,
                      compress_block_sliding_stride=2, selection_block_size=4,
                      num_selected_blocks=2, compressor="mlp"),
    )


def _dryrun_rank(n_ranks: int, device: str) -> dict:
    """One rank of ``dryrun``: returns what it checked."""
    dev = rank_device(device)
    if dev.type == "cuda":
        runtime.require_built()
    cfg = dryrun_config(kernels=dev.type == "cuda")
    mesh = auto_mesh(n_ranks, kv_heads=cfg.kv_heads)
    lcfg = local_config(cfg, mesh)
    out = {"mesh": mesh.describe()}
    train_cfg = TrainConfig(batch_size=mesh.batch * 2, seq_len=32, grad_accum_every=2)
    batch = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (train_cfg.grad_accum_every, train_cfg.batch_size,
                            train_cfg.seq_len + 1))).to(dev)
    params, optimizer = make_sharded_train_state(cfg, train_cfg, mesh, device=dev)
    loss = float(sharded_train_step(params, optimizer, batch, cfg,
                                    train_cfg.grad_accum_every, mesh))
    if not math.isfinite(loss):
        raise RuntimeError(f"dryrun train step: loss {loss}")
    out["loss"] = loss

    # sharded prefill + one decode step
    with torch.no_grad(), mesh:
        ids = shard_batch(batch[0, :, :16], mesh)
        logits, cache = transformer_prefill(params, lcfg, ids, max_len=64)
        step_params = fuse_decode_params(params, lcfg)
        logits, cache = transformer_decode_step(step_params, lcfg, logits[:, -1].argmax(-1),
                                                cache)
    if not bool(torch.isfinite(logits).all()):
        raise RuntimeError("dryrun decode step: logits not finite")
    out["decode_logits_shape"] = tuple(logits.shape)

    # the multi-host-shaped mesh: same init and batch, the same loss
    if n_ranks >= 8:
        hmesh = make_hierarchical_mesh(2, n_ranks // (2 * mesh.heads), mesh.heads)
        hparams, hopt = make_sharded_train_state(cfg, train_cfg, hmesh, device=dev)
        hloss = float(sharded_train_step(hparams, hopt, batch, cfg,
                                         train_cfg.grad_accum_every, hmesh))
        if abs(hloss - loss) > 1e-3:
            raise RuntimeError(f"hierarchical mesh loss {hloss} != flat mesh loss {loss}")
        out["hierarchical"] = {"mesh": hmesh.describe(), "loss": hloss}

    # the serving engine over the mesh, token for token one process's
    full = gather_params(params, mesh, cfg)
    prompts = [np.arange(1, 10, dtype=np.int32), np.arange(30, 42, dtype=np.int32)]

    def engine(mesh_arg):
        eng = ContinuousBatchingEngine(full, cfg, max_batch=mesh.batch * 2, max_len=64,
                                       prefill_buckets=(16,), steps_per_sync=2, mesh=mesh_arg,
                                       capture=False)
        rids = [eng.add_request(p, max_new_tokens=4) for p in prompts]
        done = eng.run()
        return [done[r].tolist() for r in rids]

    single, sharded = engine(None), engine(mesh)
    # token for token in float32; in bf16 (the kernels) the heads ranks'
    # partial products round apart from one process's whole ones, which can
    # flip a random init's near-flat argmax, so the share is reported
    if single != sharded and cfg.dtype == "float32":
        raise RuntimeError(f"engine over the mesh {sharded} != one process {single}")
    pairs = [(a, b) for s, m in zip(single, sharded) for a, b in zip(s, m)]
    out["engine_tokens_equal"] = sum(a == b for a, b in pairs) / len(pairs)
    return out


def dryrun(n_ranks: int, backend: str, device: str = "cuda",
           timeout_s: float = DRYRUN_TIMEOUT_S) -> list:
    """Spawn ``n_ranks`` ranks on ``backend`` and run the dry run on each
    (see the module note); returns every rank's summary.  On the card the
    kernels are built here first."""
    if device != "cpu":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run the dry run on the CPU")
        runtime.library()
    return run_ranks(_dryrun_rank, n_ranks, backend, (n_ranks, device), timeout_s=timeout_s)


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description="Dry run of the sharded train, decode and "
                                            "serving steps over spawned ranks.")
    p.add_argument("--ranks", type=int, default=4)
    p.add_argument("--backend", required=True, choices=["gloo", "nccl"])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    for rank, summary in enumerate(dryrun(args.ranks, args.backend, args.device)):
        print(f"rank {rank}: {summary}", flush=True)
    print("dryrun ok", flush=True)


if __name__ == "__main__":
    from nsa_tpu_torch.parallel import train_step as _module   # the ranks import it by name

    _module.main()
