"""Adapter fine-tuning / distillation trainer (``nsa_tpu/train/finetune.py``).

One step over the adapters only (the base model stays frozen): the
distillation loss, its gradient, then ``ClippedAdamW``, the port of
``optax.chain(clip_by_global_norm(0.1), adamw(cosine_restarts))``.

Data: QA pairs serialized to bytes with the answer span supervised and the
prompt masked out (``qa_to_tokens``).  Runs on ``cuda`` unless the caller
asks for ``device="cpu"`` (the tests).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import ModelConfig
from ..models.adapter import distillation_step_loss, init_adapters
from ..utils.checkpoint import tree_leaves
from ..utils.metrics import MetricsLogger
from .pretrain import trainable


def qa_to_tokens(pairs: List[Tuple[str, str]], seq_len: int) -> Tuple[np.ndarray, np.ndarray]:
    """Byte-serialize QA pairs; supervise only the answer span.

    Returns (ids [n, seq_len] int32, label_mask [n, seq_len] bool), the
    mask True on answer bytes."""
    ids, masks = [], []
    for q, a in pairs:
        prompt = f"{q}\nAnswer: ".encode()
        answer = f"{a}\n".encode()
        seq = (prompt + answer)[:seq_len]
        mask = ([False] * len(prompt) + [True] * len(answer))[:seq_len]
        pad = seq_len - len(seq)
        ids.append(list(seq) + [0] * pad)
        masks.append(mask + [False] * pad)
    return np.array(ids, np.int32), np.array(masks, bool)


def cosine_restarts_schedule(base_lr: float, steps: int, num_cycles: int = 3,
                             min_frac: float = 0.0) -> Callable[[int], float]:
    """The learning rate at an update's count: a cosine from ``base_lr``
    down to ``min_frac`` of it over each of ``num_cycles`` cycles."""
    cycle_len = max(steps // max(num_cycles, 1), 1)

    def fn(step: int) -> float:
        pos = (step % cycle_len) / cycle_len
        return base_lr * (min_frac + (1 - min_frac) * 0.5 * (1 + math.cos(math.pi * pos)))
    return fn


class ClippedAdamW(torch.optim.AdamW):
    """``optax.chain(clip_by_global_norm(max_norm), adamw(schedule))``.

    optax's AdamW defaults: betas 0.9 / 0.999, eps 1e-8 outside the square
    root, and weight decay 1e-4 on every leaf (torch's AdamW defaults to
    1e-2), decoupled as in torch: ``p -= lr (adam + wd p)``.  The learning
    rate is ``schedule(count)`` at the update's count before its increment,
    as optax reads it.  The clip is optax's exactly: the gradients scaled by
    ``max_norm / norm`` where the norm is ``max_norm`` or more, without the
    1e-6 that ``clip_grads_with_norm_`` adds (``train/pretrain.py::
    ClippedAdam``)."""

    def __init__(self, params, schedule: Callable[[int], float], max_norm: float,
                 weight_decay: float = 1e-4):
        super().__init__(params, lr=schedule(0), betas=(0.9, 0.999), eps=1e-8,
                         weight_decay=weight_decay)
        self.schedule, self.max_norm, self.count = schedule, max_norm, 0

    @torch.no_grad()
    def step(self, closure=None):
        grads = [p.grad for group in self.param_groups for p in group["params"]
                 if p.grad is not None]
        norm = torch.nn.utils.get_total_norm(grads)
        coef = torch.where(norm < self.max_norm, torch.ones_like(norm), self.max_norm / norm)
        torch._foreach_mul_(grads, coef)
        for group in self.param_groups:
            group["lr"] = self.schedule(self.count)
        self.count += 1
        return super().step(closure)


def make_finetune_optimizer(params, lr: float, steps: int, grad_clip: float = 0.1) -> ClippedAdamW:
    """The fine-tune optimizer over ``params`` (a tree of leaves)."""
    return ClippedAdamW(tree_leaves(params), cosine_restarts_schedule(lr, steps), grad_clip)


def finetune_step(adapters, optimizer: ClippedAdamW, teacher_params, ids: torch.Tensor,
                  label_mask: torch.Tensor, cfg_student: ModelConfig, cfg_teacher: ModelConfig,
                  mode: str = "kl_output_only", *, use_kernels: bool = True) -> torch.Tensor:
    """One update of ``adapters`` (float32 leaves that require grad, in
    place) on ids [b, seq + 1]: the inputs ``ids[:, :-1]``, the mask
    ``label_mask[:, 1:]``.  Returns the loss (a device scalar)."""
    optimizer.zero_grad(set_to_none=True)
    loss = distillation_step_loss(adapters, teacher_params, cfg_student, cfg_teacher,
                                  ids[:, :-1], label_mask=label_mask[:, 1:], mode=mode,
                                  use_kernels=use_kernels)
    loss.backward()
    optimizer.step()
    return loss.detach()


def run_finetune(
    teacher_params: Dict,
    cfg_teacher: ModelConfig,
    cfg_student: ModelConfig,
    pairs: List[Tuple[str, str]],
    num_steps: int = 200,
    batch_size: int = 8,
    seq_len: int = 256,
    lr: float = 1e-4,
    mode: str = "kl_output_only",
    seed: int = 0,
    logger: Optional[MetricsLogger] = None,
    adapters=None,
):
    """Train NSA adapters against a frozen teacher (its params on the
    device the run takes); returns (adapters, last loss).  ``adapters``
    starts from given ones instead of ``init_adapters`` from ``seed``.
    Batches are drawn by ``np.random.RandomState(seed)``, as in JAX."""
    logger = logger or MetricsLogger()
    device = teacher_params["token_emb"].device
    ids, masks = qa_to_tokens(pairs, seq_len + 1)
    if adapters is None:
        adapters = init_adapters(torch.Generator().manual_seed(seed), cfg_student, teacher_params)
    adapters = trainable(adapters, device)
    optimizer = make_finetune_optimizer(adapters, lr, num_steps)
    rng = np.random.RandomState(seed)
    loss = float("nan")
    for step in range(num_steps):
        sel = rng.randint(0, len(ids), size=batch_size)
        loss_dev = finetune_step(adapters, optimizer, teacher_params,
                                 torch.from_numpy(ids[sel]).long().to(device),
                                 torch.from_numpy(masks[sel]).to(device),
                                 cfg_student, cfg_teacher, mode)
        loss = float(loss_dev)
        if step % 10 == 0:
            logger.log(step, finetune_loss=loss)
    return adapters, loss
