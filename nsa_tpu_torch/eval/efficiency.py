"""Prefill, decode and training throughput on the card
(``nsa_tpu/eval/efficiency.py``: ``measure_prefill``, ``measure_decode``,
``kv_cache_saving_ratio``; ``measure_train`` times the port's
``train_step``), for the sparse and the full-attention model.

Timed with CUDA events around work on the current stream, after a warm-up;
a measurement that finds no card raises instead of timing the CPU.  Token
ids come from a numpy seed.  The decode cache is written in place, so every
timed decode run starts from its own copy of the prefilled cache (copied
outside the timed region).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..config import ModelConfig, TrainConfig
from ..models.transformer import (
    ModelCache,
    default_max_len,
    fuse_decode_params,
    greedy_decode,
    transformer_forward,
    transformer_prefill,
    use_mega_decode,
)
from ..train.pretrain import make_optimizer, train_step, trainable


def require_cuda(device="cuda") -> torch.device:
    """The CUDA device to measure on; raise when there is none."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"device measurements need a CUDA card, got {device} "
                           f"(cuda available: {torch.cuda.is_available()})")
    return device


def seeded_ids(batch_size: int, length: int, vocab: int, seed: int, device) -> torch.Tensor:
    ids = np.random.RandomState(seed).randint(0, vocab, (batch_size, length))
    return torch.from_numpy(ids).to(device)


def clone_cache(cache: ModelCache) -> ModelCache:
    """A copy of either model's cache (structured sparse or full kv)."""
    return ModelCache(
        layers=tuple(type(lc)(*(x.clone() for x in lc)) for lc in cache.layers),
        seq_len=cache.seq_len,
    )


def kv_cache_saving_ratio(cfg: ModelConfig, prompt_len: int) -> float:
    """Analytic per-query KV-access saving of sparse attention,
    ``1 - min(len, window + k * block) / len``; 0 for full attention."""
    if not cfg.use_sparse_attn:
        return 0.0
    nsa = cfg.nsa
    selected = nsa.sliding_window_size + nsa.num_selected_blocks * nsa.selection_block_size
    return 1.0 - min(prompt_len, selected) / prompt_len


def timed_ms(fn, device) -> float:
    """Milliseconds of device time that ``fn()`` takes on the current stream."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    stream = torch.cuda.current_stream(device)
    start.record(stream)
    fn()
    end.record(stream)
    end.synchronize()
    return start.elapsed_time(end)


def _pick_mega_steps(gen_len: int) -> int:
    """Tokens per whole-model kernel launch for a ``gen_len`` rollout
    (``nsa_tpu.eval.efficiency._pick_mega_steps``): the largest divisor of
    ``gen_len`` up to ``NSA_MEGA_STEPS`` (default 32)."""
    cap = max(1, min(int(os.environ.get("NSA_MEGA_STEPS", "32")), gen_len))
    return next(s for s in range(cap, 0, -1) if gen_len % s == 0)


def measure_prefill(params, cfg: ModelConfig, batch_size: int, prompt_len: int,
                    iters: int = 5, *, seed: int = 0, device="cuda") -> float:
    """Prefill throughput in tokens/s (full-prompt forward), mean over
    ``iters`` timed runs after one warm-up."""
    device = require_cuda(device)
    ids = seeded_ids(batch_size, prompt_len, cfg.vocab_size, seed, device)
    with torch.no_grad():
        transformer_forward(params, cfg, ids)
        ms = timed_ms(lambda: [transformer_forward(params, cfg, ids) for _ in range(iters)],
                      device)
    return batch_size * prompt_len * iters / (ms / 1e3)


def measure_decode(params, cfg: ModelConfig, batch_size: int, prompt_len: int,
                   gen_len: int = 100, iters: int = 3, seq_len: Optional[int] = None,
                   *, seed: int = 0, device="cuda") -> float:
    """Decode throughput in tokens/s: prefill once, then ``gen_len`` greedy
    cached steps, ``batch_size * gen_len`` tokens per run; all tokens over
    all the time of ``iters`` timed runs after one warm-up.  ``seq_len``
    pins the cache length (the benchmark cell's 4096).  Where
    ``use_mega_decode`` holds, the whole-model kernel decodes
    ``_pick_mega_steps(gen_len)`` tokens per launch, as JAX's
    ``measure_decode`` does."""
    ms = decode_run_ms(params, cfg, batch_size, prompt_len, gen_len, iters, seq_len,
                       seed=seed, device=device)
    return batch_size * gen_len * iters / (sum(ms) / 1e3)


def decode_run_ms(params, cfg: ModelConfig, batch_size: int, prompt_len: int,
                  gen_len: int = 100, iters: int = 3, seq_len: Optional[int] = None,
                  *, seed: int = 0, device="cuda") -> list:
    """Device milliseconds of each of ``iters`` timed decode runs of
    ``measure_decode`` (after its warm-up run)."""
    device = require_cuda(device)
    max_len = default_max_len(cfg, max(prompt_len + gen_len + 1, seq_len or 0))
    ids = seeded_ids(batch_size, prompt_len, cfg.vocab_size, seed, device)
    steps = _pick_mega_steps(gen_len) if use_mega_decode(cfg, batch_size) else 1
    params = fuse_decode_params(params, cfg)
    runs = []
    with torch.no_grad():
        logits, cache = transformer_prefill(params, cfg, ids, max_len)
        first = logits[:, -1].argmax(-1)
        for i in range(iters + 1):
            run_cache = clone_cache(cache)
            ms = timed_ms(lambda: greedy_decode(params, cfg, first, run_cache, gen_len,
                                                steps=steps), device)
            if i:
                runs.append(ms)
    return runs


def measure_train(params, cfg: ModelConfig, micro_batch: int, accum: int, seq_len: int,
                  iters: int = 3, *, seed: int = 0, device="cuda") -> float:
    """Training throughput in tokens/s of ``train_step`` (``accum``
    micro-batches of ``micro_batch x seq_len`` and one Adam update), mean
    over ``iters`` timed steps after one warm-up, on a trainable copy of
    ``params`` with a fresh optimizer (the caller's params are untouched)."""
    device = require_cuda(device)
    params = trainable(params, device)
    optimizer = make_optimizer(TrainConfig(), params)
    batch = seeded_ids(accum * micro_batch, seq_len + 1, cfg.vocab_size, seed, device)
    batch = batch.reshape(accum, micro_batch, seq_len + 1)
    train_step(params, optimizer, batch, cfg, accum)
    ms = timed_ms(lambda: [train_step(params, optimizer, batch, cfg, accum)
                           for _ in range(iters)], device)
    return micro_batch * accum * seq_len * iters / (ms / 1e3)
