"""Continuous pretraining on the CS441 QA byte stream
(``scripts/continuous_pretrain.py``).

Resume a pretrained checkpoint's params (a port checkpoint directory,
``utils/checkpoint.py``) into a fresh ``ClippedAdam`` and go on training on
the QA byte serialization, each batch mixed with crops of the original
corpus to reduce forgetting; every ``--eval-every`` steps, ID and OOD
perplexity and a checkpoint; the final checkpoint goes to
``<ckpt-dir>_cpt``.  The flags are the JAX script's, but ``--device``
(default ``cuda``) replaces ``--force-cpu``, and ``--mesh`` waits for the
parallel slice.

    python -m nsa_tpu_torch.train.continuous_pretrain --ckpt-dir ckpt/sparse_mlp_seq4096
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import DataConfig, TrainConfig
from ..eval.perplexity import compute_ppl
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
) -> Tuple[dict, float, str]:
    """The JAX script's loop; returns (params, last logged loss, the final
    checkpoint's path).  ``data_cfg`` is the original corpus (default
    ``DataConfig()``, as the script reads it)."""
    ckpt = latest_checkpoint(ckpt_dir)
    if ckpt is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    cfg = model_config_from_checkpoint(ckpt)
    if dtype:
        cfg = cfg.replace(dtype=dtype)
    state, meta = restore_checkpoint(ckpt, ("params",), device=device)
    params = trainable(state["params"], device)
    print(f"continuing from {ckpt} (step {meta['step']})")

    qa = load_cs441_qa_bytes(split="train")
    corpus, _ = load_byte_corpus(data_cfg or DataConfig())
    print(f"QA bytes: {len(qa):,}; corpus bytes: {len(corpus):,}")

    optimizer = make_optimizer(TrainConfig(batch_size=batch_size, learning_rate=lr,
                                           seq_len=seq_len, grad_accum_every=1), params)
    out_dir = out_dir or ckpt_dir.rstrip("/") + "_cpt"
    logger = logger or MetricsLogger(csv_path=os.path.join(out_dir, "cpt_log.csv"))

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
        ppl_ood, _ = compute_ppl(params, cfg, qa_test, eval_seq, batch_size=4,
                                 max_tokens=eval_max_tokens, device=device)
        ppl_id, _ = compute_ppl(params, cfg, val, eval_seq, batch_size=4,
                                max_tokens=eval_max_tokens, device=device)
        logger.log(step, ppl_id=ppl_id, ppl_ood=ppl_ood)
        save_checkpoint(out_dir, meta["step"] + step, params, optimizer.state_dict(), cfg,
                        extra={"continuous_pretrain": True})

    loss = float("nan")
    for step in range(num_batches):
        batch = np.concatenate([sample(qa, batch_size - n_mix),
                                sample(corpus, n_mix) if n_mix
                                else np.zeros((0, seq_len + 1), np.int32)])
        loss_dev = train_step(params, optimizer, torch.from_numpy(batch)[None].to(device),
                              cfg, 1)
        # the loss is read back (a device sync) only at the log points
        if step % LOG_EVERY == 0 or step == num_batches - 1:
            loss = float(loss_dev)
            logger.log(step, cpt_loss=loss)
        if eval_every and (step + 1) % eval_every == 0:
            eval_point(step + 1)

    path = save_checkpoint(out_dir, meta["step"] + num_batches, params, optimizer.state_dict(),
                           cfg, extra={"loss": loss, "continuous_pretrain": True})
    print(f"saved: {path}")
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
                   help="run the step over a (data, heads) mesh: not ported yet")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.mesh:
        raise NotImplementedError("--mesh waits for the port's parallelism "
                                  "(ROADMAP.md, modules queue item 5)")
    run_continuous_pretrain(
        args.ckpt_dir, out_dir=args.out_dir, num_batches=args.num_batches,
        batch_size=args.batch_size, seq_len=args.seq_len, lr=args.lr,
        mix_original=args.mix_original, seed=args.seed, eval_every=args.eval_every,
        eval_seq_len=args.eval_seq_len, eval_max_tokens=args.eval_max_tokens,
        dtype=args.dtype, device=args.device)


if __name__ == "__main__":
    main()
