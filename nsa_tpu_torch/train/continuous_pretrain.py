"""Continuous pretraining on the CS441 QA byte stream
(``scripts/continuous_pretrain.py``).

Resume a pretrained checkpoint's params (a port checkpoint directory,
``utils/checkpoint.py``) into a fresh ``ClippedAdam`` and go on training on
the QA byte serialization, each batch mixed with crops of the original
corpus to reduce forgetting; every ``--eval-every`` steps, ID and OOD
perplexity and a checkpoint; the final checkpoint goes to
``<ckpt-dir>_cpt``.  The flags are the JAX script's, but ``--device``
(default ``cuda``) replaces ``--force-cpu``.

``--mesh`` (with ``--backend gloo`` or ``nccl``), under ``torchrun``, runs
the step over ``auto_mesh`` of the ranks (``parallel/train_step.py::
sharded_train_step``): every rank draws the same batch and takes its data
slice; rank 0 alone logs and writes the checkpoints, whose params and
optimizer state are gathered over the heads ranks first, so they load
unchanged in one process.

    python -m nsa_tpu_torch.train.continuous_pretrain --ckpt-dir ckpt/sparse_mlp_seq4096
    torchrun --nproc-per-node 4 -m nsa_tpu_torch.train.continuous_pretrain \
        --ckpt-dir ckpt/sparse_mlp_seq4096 --mesh --backend nccl
"""

from __future__ import annotations

import argparse
import contextlib
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import DataConfig, TrainConfig
from ..eval.perplexity import compute_ppl
from ..parallel.mesh import Mesh, auto_mesh, init_distributed, rank_device
from ..parallel.sharding import gather_optimizer_state, gather_params, local_config
from ..parallel.train_step import shard_trainable, sharded_train_step
from ..utils.checkpoint import (
    latest_checkpoint,
    model_config_from_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from ..utils.metrics import MetricsLogger
from .data import load_byte_corpus, load_cs441_qa_bytes
from .pretrain import make_optimizer, train_step, trainable

LOG_EVERY = 20


def run_continuous_pretrain(
    ckpt_dir: str,
    out_dir: Optional[str] = None,
    num_batches: int = 500,
    batch_size: int = 8,
    seq_len: int = 512,
    lr: float = 3e-5,
    mix_original: float = 0.5,
    seed: int = 0,
    eval_every: int = 0,
    eval_seq_len: Optional[int] = None,
    eval_max_tokens: int = 200_000,
    dtype: Optional[str] = None,
    data_cfg: Optional[DataConfig] = None,
    logger: Optional[MetricsLogger] = None,
    device="cuda",
    mesh: Optional[Mesh] = None,
) -> Tuple[dict, float, str]:
    """The JAX script's loop; returns (params, last logged loss, the final
    checkpoint's path).  ``data_cfg`` is the original corpus (default
    ``DataConfig()``, as the script reads it).  With ``mesh`` every rank
    calls it (see the module note) and gets its own shard of the params."""
    ckpt = latest_checkpoint(ckpt_dir)
    if ckpt is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    cfg = model_config_from_checkpoint(ckpt)
    if dtype:
        cfg = cfg.replace(dtype=dtype)
    state, meta = restore_checkpoint(ckpt, ("params",), device=device)
    lead = mesh is None or not any(mesh.coords)     # the rank that logs and saves
    if mesh is None:
        params, run_cfg = trainable(state["params"], device), cfg
    else:
        params, run_cfg = shard_trainable(state["params"], mesh, cfg, device), \
            local_config(cfg, mesh)
    del state
    say = print if lead else (lambda *a, **k: None)
    say(f"continuing from {ckpt} (step {meta['step']})")

    qa = load_cs441_qa_bytes(split="train")
    corpus, _ = load_byte_corpus(data_cfg or DataConfig())
    say(f"QA bytes: {len(qa):,}; corpus bytes: {len(corpus):,}")

    optimizer = make_optimizer(TrainConfig(batch_size=batch_size, learning_rate=lr,
                                           seq_len=seq_len, grad_accum_every=1), params)
    out_dir = out_dir or ckpt_dir.rstrip("/") + "_cpt"
    if lead:
        logger = logger or MetricsLogger(csv_path=os.path.join(out_dir, "cpt_log.csv"))
    on_mesh = mesh if mesh is not None else contextlib.nullcontext()

    def step_fn(batch):
        if mesh is None:
            return train_step(params, optimizer, batch, cfg, 1)
        return sharded_train_step(params, optimizer, batch, cfg, 1, mesh)

    def save(step, extra):
        """The checkpoint's path; rank 0 writes it, the params and the
        optimizer state gathered over heads first."""
        if mesh is None:
            return save_checkpoint(out_dir, step, params, optimizer.state_dict(), cfg,
                                   extra=extra)
        full = gather_params(params, mesh, cfg)
        opt_state = gather_optimizer_state(optimizer, params, mesh, cfg)
        if lead:
            return save_checkpoint(out_dir, step, full, opt_state, cfg, extra=extra)
        return os.path.join(os.path.abspath(out_dir), f"step_{step:08d}")

    rng = np.random.RandomState(seed)
    n_mix = int(batch_size * mix_original)

    def sample(data, count):
        # wrap-around crops, so that short corpora still fill a window
        starts = rng.randint(0, max(len(data) - 2, 1), size=count)
        idx = (starts[:, None] + np.arange(seq_len + 1)[None, :]) % len(data)
        return data[idx].astype(np.int32)

    qa_test = load_cs441_qa_bytes(split="test")
    val = corpus[-2_000_000:]
    eval_seq = eval_seq_len or seq_len

    def eval_point(step):
        with on_mesh:
            ppl_ood, _ = compute_ppl(params, run_cfg, qa_test, eval_seq, batch_size=4,
                                     max_tokens=eval_max_tokens, device=device)
            ppl_id, _ = compute_ppl(params, run_cfg, val, eval_seq, batch_size=4,
                                    max_tokens=eval_max_tokens, device=device)
        if lead:
            logger.log(step, ppl_id=ppl_id, ppl_ood=ppl_ood)
        save(meta["step"] + step, {"continuous_pretrain": True})

    loss = float("nan")
    for step in range(num_batches):
        batch = np.concatenate([sample(qa, batch_size - n_mix),
                                sample(corpus, n_mix) if n_mix
                                else np.zeros((0, seq_len + 1), np.int32)])
        loss_dev = step_fn(torch.from_numpy(batch)[None].to(device))
        # the loss is read back (a device sync) only at the log points
        if step % LOG_EVERY == 0 or step == num_batches - 1:
            loss = float(loss_dev)
            if lead:
                logger.log(step, cpt_loss=loss)
        if eval_every and (step + 1) % eval_every == 0:
            eval_point(step + 1)

    path = save(meta["step"] + num_batches, {"loss": loss, "continuous_pretrain": True})
    say(f"saved: {path}")
    return params, loss, path


def main(argv: Optional[Sequence[str]] = None):
    """``scripts/continuous_pretrain.py``'s command line, ``--device`` for
    ``--force-cpu``."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ckpt-dir", required=True,
                   help="the port checkpoint directory to continue from")
    p.add_argument("--out-dir", default=None)
    p.add_argument("--num-batches", type=int, default=500)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=512)
    p.add_argument("--lr", type=float, default=3e-5)
    p.add_argument("--mix-original", type=float, default=0.5,
                   help="fraction of each batch drawn from the original corpus")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eval-every", type=int, default=0,
                   help="every N steps, log ID/OOD PPL and save a checkpoint")
    p.add_argument("--eval-seq-len", type=int, default=None,
                   help="PPL window (default: --seq-len)")
    p.add_argument("--eval-max-tokens", type=int, default=200_000)
    p.add_argument("--dtype", default=None, help="override the checkpoint's compute dtype")
    p.add_argument("--mesh", action="store_true",
                   help="run the step over a (data, heads) mesh of the torchrun ranks")
    p.add_argument("--backend", default=None, choices=["gloo", "nccl"],
                   help="the process groups' backend, with --mesh")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    kw = dict(out_dir=args.out_dir, num_batches=args.num_batches, batch_size=args.batch_size,
              seq_len=args.seq_len, lr=args.lr, mix_original=args.mix_original,
              seed=args.seed, eval_every=args.eval_every, eval_seq_len=args.eval_seq_len,
              eval_max_tokens=args.eval_max_tokens, dtype=args.dtype)
    if not args.mesh:
        run_continuous_pretrain(args.ckpt_dir, device=args.device, **kw)
        return
    if args.backend is None:
        p.error("--mesh needs --backend (gloo or nccl)")
    ckpt = latest_checkpoint(args.ckpt_dir)
    if ckpt is None:
        raise FileNotFoundError(f"no checkpoint under {args.ckpt_dir}")
    init_distributed(args.backend)
    try:
        device = rank_device(args.device)
        mesh = auto_mesh(kv_heads=model_config_from_checkpoint(ckpt).kv_heads)
        if not any(mesh.coords):
            print(f"mesh: {mesh.describe()} ({args.backend})", flush=True)
        run_continuous_pretrain(args.ckpt_dir, device=device, mesh=mesh, **kw)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
