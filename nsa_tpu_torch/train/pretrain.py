"""Byte-level GPT pretraining loop (``nsa_tpu/train/pretrain.py``).

Adam after global-norm clipping, gradient accumulation over micro-batches,
periodic validation, greedy generation, checkpoints with true resume and a
bf16 ``.npz`` export, as the JAX package's loop.  Parameters are float32
master tensors updated in place; the forward computes in ``cfg.dtype``.
Runs on ``cuda`` unless asked for ``device="cpu"`` (the tests).  There is
no activation checkpointing: training the reference model at micro-batch
16 x seq 4096 peaks at 35.6 GiB on an 80 GB H100 (``chip_smoke.py``'s train
phase), so the JAX package's remat'd layer scan has no counterpart here.

    python -m nsa_tpu_torch.train.pretrain --num-batches 3 --ckpt-every 2

Like the JAX loop it writes ``data/`` (the synthetic corpus cache) and
``ckpt_export/<run>.npz`` relative to the working directory.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import DataConfig, ModelConfig, TrainConfig, reference_model_config
from ..models.transformer import init_transformer, transformer_greedy, transformer_loss
from ..utils.checkpoint import (
    export_params_npz,
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
    tree_leaves,
    tree_to,
)
from ..utils.metrics import MetricsLogger
from .data import load_byte_corpus, sample_batch


class ClippedAdam(torch.optim.Adam):
    """``optax.chain(clip_by_global_norm(max_norm), adam(lr))``.

    Adam's update is optax's formula (same defaults: betas 0.9 / 0.999, eps
    1e-8 outside the square root).  Clipping differs in one place:
    ``clip_grad_norm_`` scales by ``max_norm / (norm + 1e-6)`` where optax
    scales by ``max_norm / norm``, a relative difference of 1e-6 / norm.
    """

    def __init__(self, params, lr: float, max_norm: float):
        super().__init__(params, lr=lr)
        self.max_norm = max_norm

    @torch.no_grad()
    def step(self, closure=None):
        params = [p for group in self.param_groups for p in group["params"]]
        torch.nn.utils.clip_grad_norm_(params, self.max_norm)
        return super().step(closure)


def make_optimizer(train_cfg: TrainConfig, params) -> ClippedAdam:
    return ClippedAdam(tree_leaves(params), lr=train_cfg.learning_rate,
                       max_norm=train_cfg.grad_clip_norm)


def trainable(params, device=None):
    """A copy of ``params`` as float32 leaf tensors that require grad."""
    if isinstance(params, dict):
        return {k: trainable(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [trainable(v, device) for v in params]
    return params.detach().to(device=device, dtype=torch.float32, copy=True).requires_grad_()


def train_step(params, optimizer: ClippedAdam, batch: torch.Tensor, model_cfg: ModelConfig,
               accum: int) -> torch.Tensor:
    """One optimizer step over ``accum`` micro-batches; params are updated in
    place.  batch: [accum, micro_batch, seq_len + 1] token ids.  Returns the
    mean loss as a device scalar (reading it synchronises)."""
    optimizer.zero_grad(set_to_none=True)
    loss_sum = torch.zeros((), device=batch.device)
    for micro in batch:
        loss = transformer_loss(params, model_cfg, micro)
        (loss / accum).backward()
        loss_sum += loss.detach()
    optimizer.step()
    return loss_sum / accum


@torch.no_grad()
def eval_step(params, batch: torch.Tensor, model_cfg: ModelConfig) -> torch.Tensor:
    return transformer_loss(params, model_cfg, batch)


def decode_bytes(tokens: np.ndarray) -> str:
    return "".join(chr(max(32, int(t))) for t in tokens)


def run_pretrain(
    model_cfg: ModelConfig,
    train_cfg: TrainConfig,
    data_cfg: Optional[DataConfig] = None,
    resume: bool = True,
    logger: Optional[MetricsLogger] = None,
    device="cuda",
) -> Tuple[dict, float]:
    """Train from a seeded random init (or the newest checkpoint in
    ``train_cfg.ckpt_dir``); returns (params, last logged train loss)."""
    data_cfg = data_cfg or DataConfig()
    logger = logger or MetricsLogger(csv_path=train_cfg.log_csv)
    device = torch.device(device)

    train_data, val_data = load_byte_corpus(data_cfg)
    print(f"corpus: {len(train_data):,} train / {len(val_data):,} val bytes")

    rng = np.random.RandomState(train_cfg.seed)
    micro = train_cfg.batch_size
    accum = train_cfg.grad_accum_every
    seq = train_cfg.seq_len

    params = trainable(init_transformer(
        model_cfg, torch.Generator().manual_seed(train_cfg.seed), device="cpu"), device)
    optimizer = make_optimizer(train_cfg, params)
    start_step = 0

    ckpt = latest_checkpoint(train_cfg.ckpt_dir) if resume else None
    if ckpt:
        state, meta = restore_checkpoint(ckpt, device=device)
        with torch.no_grad():
            for p, saved in zip(tree_leaves(params), tree_leaves(state["params"])):
                p.copy_(saved)
        optimizer.load_state_dict(state["opt_state"])
        start_step = meta["step"]
        print(f"resumed from {ckpt} at step {start_step}")

    def to_device(x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(x).to(device)

    loss = float("nan")
    t_window = time.time()
    last_step = start_step          # steps completed (early stop aware)
    last_export_step = -1           # step stamped on the newest npz export
    for step in range(start_step, train_cfg.num_batches):
        last_step = step + 1
        batch = np.stack([sample_batch(train_data, micro, seq, rng) for _ in range(accum)])
        loss_dev = train_step(params, optimizer, to_device(batch), model_cfg, accum)
        # the loss stays on the device between log points: reading it waits
        # for the step to finish
        do_log = (step + 1) % train_cfg.log_every == 0
        if do_log:
            loss = float(loss_dev)
            now = time.time()
            tokens_per_s = micro * accum * seq * train_cfg.log_every / max(now - t_window, 1e-6)
            t_window = now
            logger.log(step, loss=loss, tokens_per_s=round(tokens_per_s))

        if do_log and loss <= train_cfg.early_stop_loss:
            print(f"early stop at step {step}: loss {loss:.4f}")
            save_checkpoint(train_cfg.ckpt_dir, step + 1, params, optimizer.state_dict(),
                            model_cfg, extra={"loss": loss, "early_stop": True})
            _export_npz(train_cfg, params, model_cfg, step + 1, loss)
            last_export_step = step + 1
            break

        if (step + 1) % train_cfg.ckpt_every == 0:
            path = save_checkpoint(train_cfg.ckpt_dir, step + 1, params,
                                   optimizer.state_dict(), model_cfg, extra={"loss": loss})
            print(f"saved checkpoint: {path}")
            _export_npz(train_cfg, params, model_cfg, step + 1, loss)
            last_export_step = step + 1

        if step % train_cfg.validate_every == 0:
            vbatch = sample_batch(val_data, micro, seq, rng)
            vloss = float(eval_step(params, to_device(vbatch), model_cfg))
            logger.log(step, valid_loss=vloss)

        if train_cfg.generate_every and step % train_cfg.generate_every == 0 and step > 0:
            start = rng.randint(0, len(val_data) - train_cfg.prime_length - 1)
            prime = val_data[start:start + train_cfg.prime_length].astype(np.int64)
            with torch.no_grad():
                sampled = transformer_greedy(params, model_cfg, to_device(prime)[None],
                                             train_cfg.generate_length)
            print("--- prime ---")
            print(decode_bytes(prime))
            print("--- sample ---")
            print(decode_bytes(sampled[0].cpu().numpy()))

    # the export stamps the last completed step (early stop breaks before
    # num_batches); skip it when the in-loop export already covers that step
    if last_export_step != last_step:
        _export_npz(train_cfg, params, model_cfg, last_step, loss)
    return params, loss


def _export_npz(train_cfg: TrainConfig, params, model_cfg: ModelConfig, step: int,
                loss: float) -> None:
    """``ckpt_export/<ckpt_dir name>.npz`` with the float32 leaves cast to
    bf16, as the JAX loop writes it; the checkpoints keep float32."""
    export_name = os.path.basename(os.path.normpath(train_cfg.ckpt_dir))
    path = export_params_npz(
        os.path.join("ckpt_export", f"{export_name}.npz"),
        tree_to(params, torch.device("cpu"), torch.bfloat16), model_cfg,
        extra={"step": step, "loss": loss, "export_dtype": "bfloat16"},
    )
    print(f"exported weights: {path} (step {step})")


def main(argv: Optional[Sequence[str]] = None):
    """``scripts/pretrain.py``'s command line, plus ``--device``."""
    p = argparse.ArgumentParser(description="Pretrain the byte-level NSA GPT.")
    p.add_argument("--compressor", default="mlp",
                   choices=["mlp", "conv", "attn", "mean", "shared_mlp", "single"])
    p.add_argument("--full-attention", action="store_true")
    p.add_argument("--seq-len", type=int, default=4096)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--grad-accum", type=int, default=4)
    p.add_argument("--num-batches", type=int, default=5000)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"])
    # carried into the config for JSON compatibility; the port has one path
    p.add_argument("--attn-impl", default="xla", choices=["reference", "xla", "pallas"])
    p.add_argument("--data", default="data/enwik8.gz")
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=2500)
    p.add_argument("--log-csv", default=None)
    p.add_argument("--no-resume", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--generate-every", type=int, default=500)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.full_attention:
        raise NotImplementedError("training the full-attention model is not ported yet "
                                  "(ROADMAP.md, modules queue item 2)")

    ckpt_dir = args.ckpt_dir or f"ckpt/sparse_{args.compressor}_seq{args.seq_len}"
    model_cfg = reference_model_config(compressor=args.compressor).replace(
        dtype=args.dtype, attn_impl=args.attn_impl)
    train_cfg = TrainConfig(
        num_batches=args.num_batches,
        batch_size=args.batch_size,
        grad_accum_every=args.grad_accum,
        learning_rate=args.lr,
        seq_len=args.seq_len,
        ckpt_dir=ckpt_dir,
        ckpt_every=args.ckpt_every,
        seed=args.seed,
        log_csv=args.log_csv or f"{ckpt_dir}/train_log.csv",
        generate_every=args.generate_every,
    )
    run_pretrain(model_cfg, train_cfg, DataConfig(path=args.data),
                 resume=not args.no_resume, device=args.device)


if __name__ == "__main__":
    main()
