"""CS441 adapter fine-tune and QA-accuracy evaluation
(``scripts/finetune_cs441.py``).

Freeze a pretrained full-attention teacher, train NSA adapters on the
CS441 train split (answer span supervised, cosine restarts, gradient clip
0.1), then measure QA accuracy, base against adapted, on the test split by
greedy generation at a fixed length and answer extraction:

    python -m nsa_tpu_torch.train.finetune_cs441 --teacher-ckpt ckpt_export/full_attn_seq4096.npz

The flags and the printed JSON's keys are the JAX script's; the teacher is
a port checkpoint directory or an exported ``.npz``; ``--device`` (default
``cuda``) picks the device, and ``--force-cpu`` stands for ``--device
cpu`` with float32 compute, as the JAX flag does.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import torch

from ..eval.finetune_eval import evaluate_qa_accuracy, model_forward_fn
from ..models.adapter import MODES
from ..models.transformer import transformer_forward
from ..utils.checkpoint import load_params
from ..utils.metrics import MetricsLogger
from .data import load_cs441_qa_pairs
from .finetune import run_finetune


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description="CS441 adapter fine-tune + QA accuracy.")
    p.add_argument("--teacher-ckpt", default="ckpt/full_attn_seq4096")
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=256)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--mode", default="kl_output_only", choices=list(MODES))
    p.add_argument("--gen-len", type=int, default=32)
    p.add_argument("--max-samples", type=int, default=84)
    p.add_argument("--out", default="exp_result_torch/finetune_cs441.json")
    p.add_argument("--log-csv", default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--force-cpu", action="store_true",
                   help="the CPU in float32 (the same as --device cpu)")
    args = p.parse_args(argv)
    device = "cpu" if args.force_cpu else args.device
    if device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")

    teacher_params, cfg_teacher, meta = load_params(args.teacher_ckpt, device=device,
                                                    dtype=torch.float32)
    if device == "cpu":
        cfg_teacher = cfg_teacher.replace(dtype="float32")
    print(f"teacher: {args.teacher_ckpt} (step {meta.get('step')}, "
          f"sparse={cfg_teacher.use_sparse_attn})", flush=True)

    cfg_student = cfg_teacher.replace(use_sparse_attn=True)
    train_pairs = load_cs441_qa_pairs(split="train")
    test_pairs = load_cs441_qa_pairs(split="test")
    print(f"CS441 pairs: {len(train_pairs)} train / {len(test_pairs)} test", flush=True)

    logger = MetricsLogger(csv_path=args.log_csv)
    adapters, final_loss = run_finetune(
        teacher_params, cfg_teacher, cfg_student, train_pairs,
        num_steps=args.steps, batch_size=args.batch_size,
        seq_len=args.seq_len, lr=args.lr, mode=args.mode, logger=logger,
    )
    print(f"fine-tune done: final loss {final_loss:.4f}", flush=True)

    base_fn = model_forward_fn(lambda ids: transformer_forward(teacher_params, cfg_teacher, ids),
                               teacher_params)
    result = evaluate_qa_accuracy(
        adapters, teacher_params, cfg_student, test_pairs,
        gen_len=args.gen_len, max_samples=args.max_samples,
        json_path=args.out, compare_base=base_fn, fixed_len=args.seq_len,
    )
    summary = {
        "adapted_accuracy": result["accuracy"],
        "adapted_ci95": result["accuracy_ci95"],
        "base_accuracy": result.get("base_accuracy"),
        "base_ci95": result.get("base_accuracy_ci95"),
        "num_samples": result["num_samples"],
        "mode": args.mode,
        "steps": args.steps,
    }
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
