"""Prefill, decode and training throughput on the card
(``nsa_tpu/eval/efficiency.py``: ``measure_prefill``, ``measure_decode``,
``kv_cache_saving_ratio``; ``measure_train`` times the port's
``train_step``), for the sparse and the full-attention model.

Timed with CUDA events around work on the current stream, after a warm-up;
a measurement that finds no card raises instead of timing the CPU.  Token
ids come from a numpy seed.  The decode cache is written in place, so every
timed decode run starts from a copy of the prefilled cache, copied outside
the timed region into one run cache, whose addresses the captured decode
graph keeps (the warm-up run captures it, as JAX's warm-up compiles).

``run_efficiency_sweep`` and ``run_efficiency_eval`` write the JAX
package's efficiency CSV rows.  Prompts are seeded random ids
(``seeded_ids``), where JAX times zeros: the sparse model's selections,
and so its timings, follow the ids (``ROADMAP.md`` section 3, "benchmark
input").
"""

from __future__ import annotations

import os
import time
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
from ..utils.metrics import CSVLogger


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


def copy_cache(dst: ModelCache, src: ModelCache) -> None:
    """Copy ``src``'s tensors into ``dst``'s, in place (same shapes)."""
    for a, b in zip(dst.layers, src.layers):
        for x, y in zip(a, b):
            x.copy_(y)


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


def host_ms(fn, device) -> float:
    """Milliseconds of host time that ``fn()`` takes, the device drained at
    both ends: the CPU tests' clock, never a device figure."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return (time.perf_counter() - t0) * 1e3


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
    ``measure_decode`` does.  The loop runs as a captured CUDA graph
    (``greedy_decode``)."""
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
    params = fuse_decode_params(params, cfg)
    with torch.no_grad():
        logits, cache = transformer_prefill(params, cfg, ids, max_len)
        return _decode_runs_ms(params, cfg, logits[:, -1].argmax(-1), cache, gen_len, iters,
                               device)


def _decode_runs_ms(params, cfg: ModelConfig, first: torch.Tensor, cache: ModelCache,
                    gen_len: int, iters: int, device, clock=timed_ms) -> list:
    """Milliseconds (``clock``: device time by default) of ``iters`` greedy
    decode runs of ``gen_len`` steps from ``first`` and ``cache`` (left as
    it is), after one warm-up run; each run starts from a copy of ``cache``
    in one run cache.  Where ``use_mega_decode`` holds,
    ``_pick_mega_steps(gen_len)`` tokens a launch."""
    steps = _pick_mega_steps(gen_len) if use_mega_decode(cfg, first.shape[0]) else 1
    run_cache = clone_cache(cache)
    runs = []
    for i in range(iters + 1):
        if i:
            copy_cache(run_cache, cache)
        ms = clock(lambda: greedy_decode(params, cfg, first, run_cache, gen_len,
                                         steps=steps), device)
        if i:
            runs.append(ms)
    return runs


def sweep_max_len(cfg: ModelConfig, prompt_lens, gen_len: int,
                  seq_len: Optional[int] = None) -> int:
    """The one cache length of a sweep: room for the longest prompt and
    ``gen_len`` tokens, at least ``seq_len``."""
    return default_max_len(cfg, max(max(prompt_lens) + gen_len + 1, seq_len or 0))


def prefill_bucket(prompt_len: int, max_len: int) -> int:
    """The serving-style admission bucket a prompt is right-padded to: the
    smallest power of two from 128 that holds ``prompt_len + 1``, at most
    ``max_len``."""
    bucket = 128
    while bucket < prompt_len + 1:
        bucket *= 2
    return min(bucket, max_len)


def run_efficiency_sweep(
    params,
    cfg: ModelConfig,
    model_type: str,
    batch_sizes,
    prompt_lens,
    gen_len: int = 100,
    seq_len: Optional[int] = None,
    csv_path: Optional[str] = None,
    step: int = 0,
    *,
    device="cuda",
    log=print,
    host_clock: bool = False,
    iters: int = 3,
) -> list:
    """Prefill and decode throughput over batch sizes x prompt lengths
    (``nsa_tpu.eval.efficiency.run_efficiency_sweep``), one CSV row a cell.

    Each prompt is right-padded to its admission bucket (``prefill_bucket``)
    and prefilled with its true length, so a short prompt pays the small
    bucket's cost; the first token is the argmax at the last true position.
    Every decode runs ``gen_len`` greedy steps against one cache of
    ``sweep_max_len`` rows (``_decode_runs_ms``: the whole-model kernel at
    ``_pick_mega_steps`` tokens a launch where ``use_mega_decode`` holds, the
    split pair above b = 8).  Prefill time is the mean of ``iters`` timed
    runs after one warm-up, decode time the mean of ``iters`` runs (3 each,
    as in JAX).  The row records ``max_len``, the bucket, ``prefill_tokens_per_s`` over the true
    prompt tokens and ``prefill_bucket_tokens_per_s`` over the padded ones;
    ``log`` gets each row as a line.  Raises without a card: it measures,
    unless ``host_clock`` asks for the host clock (``host_ms``) on any
    device, the CPU tests' path, whose figures are no device time."""
    device = torch.device(device) if host_clock else require_cuda(device)
    clock = host_ms if host_clock else timed_ms
    prompt_lens = list(prompt_lens)
    params = fuse_decode_params(params, cfg)
    max_len = sweep_max_len(cfg, prompt_lens, gen_len, seq_len)
    rows = []
    with torch.no_grad():
        for bs in batch_sizes:
            for prompt_len in prompt_lens:
                bucket = prefill_bucket(prompt_len, max_len)
                ids = seeded_ids(bs, bucket, cfg.vocab_size, 0, device)

                def prefill_first():
                    logits, cache = transformer_prefill(params, cfg, ids, max_len,
                                                        true_len=prompt_len)
                    return logits[:, prompt_len - 1].argmax(-1), cache

                def prefills():
                    for _ in range(iters):
                        prefill_first()

                first, cache = prefill_first()
                dt_pre = clock(prefills, device) / iters / 1e3
                dt_dec = sum(_decode_runs_ms(params, cfg, first, cache, gen_len, iters,
                                             device, clock)) / iters / 1e3
                row = {
                    "model_type": model_type,
                    "step": step,
                    "seq_len": seq_len or max_len,
                    "batch_size": bs,
                    "prompt_len": prompt_len,
                    "gen_len": gen_len,
                    "max_len": max_len,
                    "prefill_bucket": bucket,
                    "prefill_tokens_per_s": round(bs * prompt_len / dt_pre, 1),
                    "prefill_bucket_tokens_per_s": round(bs * bucket / dt_pre, 1),
                    "decode_tokens_per_s": round(bs * gen_len / dt_dec, 1),
                    "kv_cache_saving_ratio": round(kv_cache_saving_ratio(cfg, prompt_len), 4),
                }
                rows.append(row)
                if csv_path:
                    CSVLogger(csv_path).append(row)
                log(f"efficiency: {row}")
                del cache
    return rows


def run_efficiency_eval(
    params,
    cfg: ModelConfig,
    model_type: str,
    batch_size: int,
    prompt_len: int,
    gen_len: int = 100,
    seq_len: Optional[int] = None,
    csv_path: Optional[str] = None,
    step: int = 0,
    *,
    device="cuda",
) -> dict:
    """One cell's prefill and decode tok/s (``measure_prefill``,
    ``measure_decode``) as a CSV row.  Raises without a card."""
    prefill_tps = measure_prefill(params, cfg, batch_size, prompt_len, device=device)
    decode_tps = measure_decode(params, cfg, batch_size, prompt_len, gen_len, seq_len=seq_len,
                                device=device)
    row = {
        "model_type": model_type,
        "step": step,
        "seq_len": seq_len or prompt_len,
        "batch_size": batch_size,
        "prompt_len": prompt_len,
        "gen_len": gen_len,
        "prefill_tokens_per_s": round(prefill_tps, 1),
        "decode_tokens_per_s": round(decode_tps, 1),
        "kv_cache_saving_ratio": round(kv_cache_saving_ratio(cfg, prompt_len), 4),
    }
    if csv_path:
        CSVLogger(csv_path).append(row)
    return row


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
