"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its name and seconds as it ends:

1. device  - the card's name, count, and ``nvidia-smi`` name and power limit;
             no card: exit 1 before any result.
2. build   - the one ``nvcc`` call that builds the kernels (with ptxas's
             register / shared-memory / spill lines).
3. weights - the trained reference model, ``ckpt_export/sparse_mlp_seq4096.npz``,
             read into bf16 tensors on the card; its config is the cell's.
4. kernels - each kernel against its plain PyTorch version at the benchmark
             cell's shapes (bs 64, max_len 4096, prefill n 3900), inputs from
             a seeded generator, with kernel, plain and bound times.
5. main    - the port's main path through its entry points: prefill of
             64 x 3900 seeded tokens, then 100 greedy decode steps with the
             4096-row cache; launch counts read around exactly that run; the
             first decode step's logits held against the plain versions'.
6. measure - decode and prefill tok/s over 3 more timed runs each
             (``measure_decode``, ``measure_prefill``).
7. profile - ``torch.profiler`` over one prefill and 5 decode steps: device
             time by op and the device's busy share of the wall time.
8. small   - the small-batch decode path (b <= 8: the whole-model kernel,
             JAX's default there) on the trained model at bs 8 and bs 1:
             prefill of 3900 seeded tokens, 100 greedy steps with the
             4096-row cache, launch counts read around exactly that run
             (``decode_step_mega`` once a token, no per-layer launch); the
             first step's logits held against the plain whole-model decode,
             the fused and the split kernel routes; one launch of 25 greedy
             tokens against 25 launches of one, bit for bit; decode tok/s of
             the routes in turns (mega, fused, split, split, fused, mega at
             bs 8; mega, fused, fused, mega at bs 1), the fused pair's launch
             counts (depth x 100 each) read around its first run;
             ``measure_decode`` (25 tokens a launch); ``torch.profiler`` over
             5 steps of the mega and of the fused route.
9. train   - the training path: ``run_pretrain`` on the reference config
             from a seeded random init, micro-batch 16 x accum 4 x seq 4096,
             bf16 compute, in a temporary working directory (the corpus
             cache, checkpoints and export land there, never in the tree):
             3 steps with a checkpoint at step 2, then a resume that must
             start at step 2 from the saved params; launch counts read
             around exactly those two runs; one micro-batch's loss and
             every parameter gradient through the kernels held against the
             plain path; ``measure_train`` tokens/s; ``torch.profiler`` over
             one micro-step.
10. serve  - the serving engine (``nsa_tpu_torch.serve.ContinuousBatchingEngine``)
             on the trained model: 48 seeded requests (prompts of 256-3900
             bytes in [32, 127), 32-128 new tokens each) through 16 slots of
             4096 rows in buckets of 512-4096, 8 tokens a sync, greedy, on a
             dense pool and on a paged pool of 640 pages of 64 rows (62.5% of
             the dense pool's); every request's tokens equal on both; 4
             requests at 1 token a sync equal the same at 8, their first
             ragged step's logits held against prefill + a b = 1 decode step
             of the same prompt; launch counts read around each run (depth
             ragged select-emit and ragged or paged attend launches a decode
             step, none of the one-position decode kernels); 4 requests on
             the split route (depth block-gather launches a step); every page
             back on the free list; no host sync inside a multi-token window
             (``torch.cuda.set_sync_debug_mode("error")``); new tokens/s,
             requests/s, wall time, kv pool MiB, peak memory, and a profile of
             5 ragged steps at 16 slots.
11. full   - the full-attention baseline (``ckpt_export/full_attn_seq4096.npz``
             in bf16) at the serving cell: prefill of 64 x 3900 seeded tokens
             through the flash attention kernel, then 100 greedy decode steps
             with the 4096-row cache; launch counts read around exactly that
             run (``flash_attention`` once a layer, no other kernel); the
             first decode step's logits held against the plain path (the
             plain flash prefill, then the same step); 4 requests on the
             serving engine's dense pool at 1 and at 8 tokens a sync, token
             for token equal; ``nsa_tpu_torch.bench``'s turns (sparse, full,
             full, sparse decode tok/s on the cell, its JSON printed on a line
             of its own); ``torch.profiler`` over the prefill and 5 decode
             steps, with the device time of copies a step (none of the cache).

The kernels phase also holds the two backward kernels against their plain
versions at the training cell's shapes (bs 16, n 4096), the two fused
decode kernels at the small-batch cell's (bs 8, layer 0's trained weights,
seeded activations and caches; the select kernel at an emission step and
at the step before it), the whole-model decode kernel there (bs 8, all
layers' trained weights, seeded tokens and full-length caches, an emission
step and the step before it), and the serving engine's four kernels at 16
slots of 4096 rows with layer 0's trained weights: the ragged select-emit
and attend kernels at seeded mixed positions (t = 0, emitting and
non-emitting rows before and after the first full compression window, t up
to 4095), and at one position against the one-position pair; the paged
attend kernel under a seeded permutation page table of 64-row pages, bit
for bit the ragged one; the block gather of the ragged split route; and the
flash attention kernel of the full-attention baseline at the serving cell's
shapes (q [64, 8, 3900, 64], k / v [64, 4, 3900, 64], causal), with
``torch.nn.functional.scaled_dot_product_attention`` timed beside it as its
library yardstick (the port never calls it).

Then one JSON line with the kernels, the card's name and power limit, and as
the last line ``{"ok": true, "device": {...}}``.  Any failure raises and
exits non-zero; nothing catches it.  Imports nothing of JAX or ``nsa_tpu``.
"""

import faulthandler
import json
import math
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import nsa_tpu_torch  # noqa: E402,F401  (fails at once outside a checkout)
from nsa_tpu_torch.config import DataConfig, TrainConfig  # noqa: E402
from nsa_tpu_torch.eval.efficiency import (  # noqa: E402
    _pick_mega_steps,
    clone_cache,
    measure_decode,
    measure_prefill,
    measure_train,
    seeded_ids,
)
from nsa_tpu_torch.models.transformer import (  # noqa: E402
    KVDecodeCache,
    cache_tensors,
    fuse_decode_params,
    greedy_decode,
    init_transformer,
    transformer_decode_step,
    transformer_decode_step_mega,
    transformer_forward,
    transformer_loss,
    transformer_prefill,
    use_mega_decode,
)
from nsa_tpu_torch.ops.cuda import (  # noqa: E402
    flash,
    nsa_decode,
    nsa_decode_fused,
    nsa_decode_mega,
    nsa_decode_ragged,
    nsa_prefill,
    paged_gather,
    runtime,
)
from nsa_tpu_torch.ops.nsa import _ckv_width, fuse_decode_layer  # noqa: E402
from nsa_tpu_torch import bench as port_bench  # noqa: E402
from nsa_tpu_torch import serve  # noqa: E402
from nsa_tpu_torch.train import pretrain  # noqa: E402
from nsa_tpu_torch.utils.checkpoint import (  # noqa: E402
    latest_checkpoint,
    load_params_npz,
    model_config_from_meta,
    restore_checkpoint,
    tree_items,
    tree_leaves,
)
from nsa_tpu_torch.utils.metrics import MetricsLogger  # noqa: E402

TIME_LIMIT_S = 1100          # hard stop: dump the stacks and exit 1
# about twice each phase's longest time on the H100 (61 s build of the eight
# kernels, 12 s small phase, 79 s train on the slower host, 19 s serve, 5.2 s
# kernels with the plain flash attention at full size, 20.6 s full), at least
# 10 s for the phases of a few seconds, whose time is host noise; 512 s in all
BUDGET_S = {"device": 10, "build": 120, "weights": 10, "kernels": 12, "main": 10,
            "measure": 20, "profile": 50, "small": 30, "serve": 40, "full": 50,
            "train": 160}
BATCH, PROMPT, GEN, MAX_LEN = 64, 3900, 100, 4096
SMALL_BATCHES = (8, 1)       # the small-batch cell: the whole-model decode route
FUSED_KERNELS = ("decode_select_emit", "decode_attend_fused")
MEGA_STEPS = _pick_mega_steps(GEN)   # tokens per launch in measure_decode: 25
# the training cell: the JAX trainer's settings (nsa_tpu/config.py:137-159)
MICRO, ACCUM, SEQ = 16, 4, 4096
TRAIN_STEPS, CKPT_STEP = 3, 2
# synthetic corpus cut from the default 32,000,000 bytes to keep its
# generation (pure Python, ~2 s per MB) inside the phase budget
CORPUS_BYTES = 4_000_000
DECODE_T = PROMPT + GEN - 1  # the last decode position of the cell
SEED = 0
DEVICE = "cuda"
WEIGHTS = os.path.join(HERE, "ckpt_export", "sparse_mlp_seq4096.npz")
FULL_WEIGHTS = os.path.join(HERE, "ckpt_export", "full_attn_seq4096.npz")
HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12     # dense bf16 tensor-core peak, same source
# bf16 keeps 8 significant bits (unit roundoff 2^-9).  The plain decode
# versions round their softmax weights to bf16 before the weighted sum and
# round the output; the kernels keep the weights in float32 (so does the
# plain prefill forward, which then differs by sum order and the output's
# rounding).  On outputs that are convex combinations of values |v| <= ~5
# that is <= ~2 * 2^-9 * 5 = 0.02.
TOL_OUT = 0.03
TOL_LSE = 1e-3               # float32 both ways, same bf16 inputs: sum order only
TIE = 1e-6                   # selection scores closer than this count as ties
# logits after 6 bf16 layers: each layer's attention output differs by about
# one bf16 rounding (2^-8 relative) between the paths; through the residual
# stream that stays within ~1% of the logits' scale.
TOL_LOGITS_REL = 0.02
# backward kernels against their plain versions, same bf16 inputs, float32
# arithmetic both ways: dq, dk, dv are rounded to bf16 at the end by both, so
# they differ by at most one bf16 ulp of the largest value (2^-7 of it, the
# top binade's ulp with 8 significant bits); d_gates and the deltas stay
# float32 and differ by sum order over <= 64 terms and expf (1e-4 of the max).
TOL_BWD_BF16 = 2.0 ** -7
TOL_BWD_F32 = 1e-4
# One micro-batch, bf16 compute, relative L2 error per gradient tensor.
# Kernels vs the kernel forward with the plain backward (the two backward
# kernels alone): dq, dk, dv differ by <= one bf16 ulp (2^-8 relative) per
# element, carried back through the earlier layers: 0.05.  Kernels vs the
# plain path: the two forwards also differ by one rounding of their bf16
# outputs, and gradients that are net sums over all 65k positions with heavy
# cancellation (k_pos, the compressors' first bias, gate_b: norms 1e-7 to
# 1e-5, far below their summands) magnify that to 6-8% where the backward
# alone stays under 3%: 0.1.  The loss agrees within 2e-3 relative.
TOL_GRAD_BWD_REL_L2 = 0.05
TOL_GRAD_REL_L2 = 0.1
TOL_LOSS_REL = 2e-3
# The fused decode kernels against their plain versions: both round at the
# same points (the emitted ckv row, the combined attention output, the
# layer's y, the FF's hidden row and output) from float32 sums taken in
# another order, so a rounding can flip by one bf16 ulp (2^-7 of the
# largest value) and carry at most one more ulp downstream: 2^-6 of the
# largest value.  The ring shift and the kv row write are copies: bit-equal.
# The whole-model kernel against its plain version: the same bodies and
# rounding points through every layer, held to the same 2^-6.
TOL_FUSED = 2.0 ** -6
# The flash attention kernel against its plain version, element by element
# (``flash.flash_attention_tolerance``): 2^-7 of |plain| for the two bf16
# roundings of the output, plus 2^-8 of the same attention taken over |v| for
# the kernel's rounding of its softmax weights to bf16 before P.V (the plain
# version, like the TPU kernel, keeps them float32); each term twice its
# stated source.  The largest ratio |kernel - plain| / bound must stay <= 1;
# an output with one middle 64-key tile left out of the late query rows (a
# wrong kernel, built from the plain version) must exceed it.
FLASH_DROPPED_KEYS = (1920, 1984)
# A copy of one of the decode's cache slices ([64, 4, <= 4096, 64] bf16,
# <= 134 MB read and written) would take >= 80 us at 3.35 TB/s; the step's
# own copies (casts of its activations and softmax weights, the new row)
# take a few us each.  Held to the longest single copy kernel of the profile
# (not a mean over the kernels of one name, which the many small casts
# would pull down); a deliberate copy of one cache slice, profiled the same
# way, must exceed it.
MAX_COPY_KERNEL_MS = 0.02
# the serving cell: the engine's slot pool at the trained model's cache length
SERVE_SLOTS, SERVE_REQUESTS, SERVE_SYNC = 16, 48, 8
SERVE_BUCKETS = (512, 1024, 2048, 4096)
PAGE_TOKENS, POOL_PAGES = 64, 640
SERVE_CHECK_REQUESTS = 4
# every kernel the port has, counted around each path's run
ALL_KERNELS = (nsa_prefill.prefill_fwd, nsa_prefill.prefill_bwd_dq, nsa_prefill.prefill_bwd_dkv,
               nsa_decode.decode_select, nsa_decode.decode_attend,
               nsa_decode_fused.decode_select_emit, nsa_decode_fused.decode_attend_fused,
               nsa_decode_mega.decode_step_mega, nsa_decode_ragged.decode_select_emit_ragged,
               nsa_decode_ragged.decode_attend_fused_ragged,
               nsa_decode_ragged.decode_attend_fused_paged, paged_gather.paged_gather,
               flash.flash_attention)

PHASES = []


def phase(name, t0):
    dt = time.perf_counter() - t0
    PHASES.append((name, dt))
    print(f"phase {name} {dt:.3f}s (budget {BUDGET_S[name]}s)", flush=True)
    if dt > BUDGET_S[name]:
        raise RuntimeError(f"phase {name} took {dt:.1f}s, over its {BUDGET_S[name]}s budget")
    return time.perf_counter()


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def timed_ms(fn, iters, flush):
    """Median device ms of fn(), L2 flushed before each launch.  Every
    function timed here has run once before, for its comparison: that run is
    its warm-up."""
    events = []
    for _ in range(iters):
        flush.zero_()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    ts = sorted(s.elapsed_time(e) for s, e in events)
    return ts[len(ts) // 2]


def bound_ms(nbytes, flops):
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


def prefill_inputs(gen, cfg, b, n):
    """Seeded prefill-kernel inputs at [b, n]: rq, rk, v in bf16; selected
    blocks strictly before each row's own block (duplicates allowed: the
    union must count them once), 90% valid."""
    kvh, G, d = cfg.kv_heads, cfg.num_grouped_queries, cfg.dim_head
    Bs, S = cfg.nsa.selection_block_size, cfg.nsa.num_selected_blocks
    dev = DEVICE
    rq = torch.randn((b, kvh * G, n, d), generator=gen, device=dev).to(torch.bfloat16)
    rk = torch.randn((b, kvh, n, d), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((b, kvh, n, d), generator=gen, device=dev).to(torch.bfloat16)
    q_blk = torch.arange(n, device=dev) // Bs
    raw = torch.randint(0, 1 << 30, (b, kvh, n, S), generator=gen, device=dev)
    sel_idx = (raw % q_blk.clamp(min=1)[:, None]).to(torch.int32)
    sel_mask = (torch.rand((b, kvh, n, S), generator=gen, device=dev) < 0.9) \
        & (q_blk > 0)[:, None]
    return rq, rk, v, sel_idx, sel_mask


def needed_keys(sel_idx, sel_mask, cfg):
    """(row, key) pairs these inputs need: the valid selected blocks once
    each, the diagonal block up to the row (fine), and the band (sliding)."""
    b, kvh, n, S = sel_idx.shape
    Bs, window = cfg.nsa.selection_block_size, cfg.nsa.sliding_window_size
    pos = torch.arange(n, device=sel_idx.device)
    q_blk = pos // Bs
    keep = sel_mask & (sel_idx != q_blk[:, None])
    same = sel_idx[..., :, None] == sel_idx[..., None, :]
    earlier = torch.ones(S, S, dtype=torch.bool, device=sel_idx.device).tril(-1)
    keep &= ~(same & keep[..., None, :] & earlier).any(-1)
    fine = keep.sum().item() * Bs + b * kvh * (pos % Bs + 1).sum().item()
    band = b * kvh * (pos.clamp(max=window) + 1).sum().item()
    return fine, band


def kernel_prefill(gen, flush, cfg):
    nsa = cfg.nsa
    G, d = cfg.num_grouped_queries, cfg.dim_head
    Bs, window, scale = nsa.selection_block_size, nsa.sliding_window_size, d ** -0.5
    rq, rk, v, sel_idx, sel_mask = prefill_inputs(gen, cfg, BATCH, PROMPT)
    args = (rq, rk, v, sel_idx, sel_mask, Bs, window, scale)

    got = nsa_prefill.prefill_fwd(*args)
    want = nsa_prefill.fine_sliding_plain(*args)
    torch.cuda.synchronize()
    errs = [max_err(x, y) for x, y in zip(got, want)]
    print(f"  prefill_fwd max|err| fine {errs[0]:.5f} sliding {errs[1]:.5f} "
          f"(tol {TOL_OUT}), lse {errs[2]:.2e} {errs[3]:.2e} (tol {TOL_LSE})", flush=True)
    check(errs[0] <= TOL_OUT and errs[1] <= TOL_OUT, "prefill_fwd outputs disagree")
    check(errs[2] <= TOL_LSE and errs[3] <= TOL_LSE, "prefill_fwd LSEs disagree")
    check(all(torch.isfinite(x.float()).all().item() for x in got), "prefill_fwd non-finite")

    flops = sum(needed_keys(sel_idx, sel_mask, cfg)) * G * 4 * d
    bms, by = bound_ms(nbytes(rq, rk, v, sel_idx, sel_mask, *got), flops)
    ms = timed_ms(lambda: nsa_prefill.prefill_fwd(*args), 10, flush)
    plain = timed_ms(lambda: nsa_prefill.fine_sliding_plain(*args), 2, flush)
    return {"name": "prefill_fwd", "route": "cuda",
            "source": "nsa_tpu_torch/csrc/nsa_prefill.cu",
            "replaces": "nsa_tpu/ops/pallas/nsa_prefill.py:315",
            "max_abs_err": max(errs[0], errs[1]), "ms": ms, "plain_ms": plain,
            "bound_ms": bms, "bound_by": by, "library_ms": None}


def kernel_prefill_bwd(gen, flush, cfg):
    """Both backward kernels against their plain versions at the training
    cell's shapes; seeded inputs and cotangents, the forward from the kernel."""
    nsa = cfg.nsa
    G, d = cfg.num_grouped_queries, cfg.dim_head
    Bs, window, scale = nsa.selection_block_size, nsa.sliding_window_size, d ** -0.5
    rq, rk, v, sel_idx, sel_mask = prefill_inputs(gen, cfg, MICRO, SEQ)
    sel = (rq, rk, v, sel_idx, sel_mask)
    fo, so, flse, slse = nsa_prefill.prefill_fwd(*sel, Bs, window, scale)
    dfo = torch.randn(fo.shape, generator=gen, device=DEVICE).to(torch.bfloat16)
    dso = torch.randn(so.shape, generator=gen, device=DEVICE).to(torch.bfloat16)
    dq_args = (*sel, fo, so, flse, slse, dfo, dso, Bs, window, scale)
    got_q = nsa_prefill.prefill_bwd_dq(*dq_args)
    want_q = nsa_prefill.prefill_bwd_dq_plain(*dq_args)
    # the dkv kernel and its plain version read the same (plain) deltas
    dkv_args = (*sel, flse, slse, want_q[2], want_q[3], dfo, dso, Bs, window, scale)
    got_kv = nsa_prefill.prefill_bwd_dkv(*dkv_args)
    want_kv = nsa_prefill.prefill_bwd_dkv_plain(*dkv_args)
    again = nsa_prefill.prefill_bwd_dkv(*dkv_args)
    torch.cuda.synchronize()
    errs = {}
    for name, x, y, tol in (("dq", got_q[0], want_q[0], TOL_BWD_BF16),
                            ("d_gates", got_q[1], want_q[1], TOL_BWD_F32),
                            ("fine_delta", got_q[2], want_q[2], TOL_BWD_F32),
                            ("sliding_delta", got_q[3], want_q[3], TOL_BWD_F32),
                            ("dk", got_kv[0], want_kv[0], TOL_BWD_BF16),
                            ("dv", got_kv[1], want_kv[1], TOL_BWD_BF16)):
        err, top = max_err(x, y), y.float().abs().max().item()
        errs[name] = err
        print(f"  prefill_bwd {name}: max|err| {err:.3e} (tol {tol:.3g} x max|plain| "
              f"{top:.3f})", flush=True)
        check(torch.isfinite(x.float()).all().item() and err <= tol * top,
              f"prefill_bwd {name} disagrees with its plain version")
    check(torch.equal(got_kv[0], again[0]) and torch.equal(got_kv[1], again[1]),
          "prefill_bwd_dkv is not deterministic")

    fine, band = needed_keys(sel_idx, sel_mask, cfg)
    common = nbytes(*sel, flse, slse, dfo, dso)
    # dq: s, do.v and dS.k per (row, key, head); dkv: s, do.v, dS.q, p.do per
    # (row, key, head) of each branch
    bq, byq = bound_ms(common + nbytes(fo, so, *got_q), (fine + band) * G * 6 * d)
    bkv, bykv = bound_ms(common + nbytes(got_q[2], got_q[3], *got_kv), (fine + band) * G * 8 * d)
    out = []
    for name, fn, plain, args, bms, by, err, line in (
            ("prefill_bwd_dq", nsa_prefill.prefill_bwd_dq, nsa_prefill.prefill_bwd_dq_plain,
             dq_args, bq, byq, max(errs["dq"], errs["d_gates"]), 657),
            ("prefill_bwd_dkv", nsa_prefill.prefill_bwd_dkv, nsa_prefill.prefill_bwd_dkv_plain,
             dkv_args, bkv, bykv, max(errs["dk"], errs["dv"]), 677)):
        out.append({"name": name, "route": "cuda", "source": "nsa_tpu_torch/csrc/nsa_prefill_bwd.cu",
                    "replaces": f"nsa_tpu/ops/pallas/nsa_prefill.py:{line}",
                    "max_abs_err": err, "ms": timed_ms(lambda: fn(*args), 10, flush),
                    "plain_ms": timed_ms(lambda: plain(*args), 2, flush),
                    "bound_ms": bms, "bound_by": by, "library_ms": None})
    return out


def check_selection(info_k, info_p, scores, num_sel, n_slide, label):
    """Packed info rows [..., INFO_WIDTH] of a kernel and its plain version:
    trailing ids equal; selected ids equal except where the scores tie
    within TIE; validity equal on the rows whose ids agree.  Returns the
    number of rows that differ by ties."""
    n_slots = num_sel + n_slide
    check(torch.equal(info_k[..., num_sel:n_slots], info_p[..., num_sel:n_slots]),
          f"{label} trailing ids disagree")
    ids_k, ids_p = info_k[..., :num_sel].long(), info_p[..., :num_sel].long()
    gap = (scores.gather(-1, ids_k) - scores.gather(-1, ids_p)).abs()
    differ = ids_k != ids_p
    check(bool((gap[differ] <= TIE).all()), f"{label} picks a block that is not a tie")
    same_rows = ~differ.any(-1)
    vk, vp = info_k[..., n_slots:n_slots + num_sel], info_p[..., n_slots:n_slots + num_sel]
    check(torch.equal(vk[same_rows], vp[same_rows]), f"{label} validity disagrees")
    return differ.any(-1).sum().item()


def attend_rows(vp, t, Bs, n_slide, window, bkvh):
    """kv rows the attention needs: valid selected blocks, the band and the
    diagonal block up to t."""
    trail = t // Bs - torch.arange(n_slide - 1, -1, -1)
    j = trail[:, None] * Bs + torch.arange(Bs)
    diag = torch.zeros_like(j, dtype=torch.bool)
    diag[-1] = True
    trail_rows = (((j >= t - window) | diag) & (j <= t) & (trail >= 0)[:, None]).sum().item()
    return vp.sum().item() * Bs + bkvh * trail_rows


def kernel_decode_fused(gen, flush, cfg, params, b):
    """Rows 6 and 7 at bs ``b``: layer 0's trained weights, packed; seeded
    queries, caches and residual stream."""
    nsa = cfg.nsa
    kvh, g, d, dim = cfg.kv_heads, cfg.num_grouped_queries, cfg.dim_head, cfg.dim
    stride, Bs, Bc, window = nsa.compress_block_sliding_stride, nsa.selection_block_size, \
        nsa.compress_block_size, nsa.sliding_window_size
    num_sel, M = nsa.num_selected_blocks, nsa.num_compressed_mem_kv
    n_slide = -(-window // Bs) + 1
    scale = d ** -0.5
    Wc = _ckv_width(MAX_LEN, stride, nsa.num_compress_per_fine)
    layer = fuse_decode_layer(params["layers"][0], torch.bfloat16)
    fp, ffp = layer["attn"]["decode_fused"], layer["ff"]["decode_fused"]
    weights = (fp["pos_kv"], fp["w1k"], fp["b1k"], fp["w1v"], fp["b1v"], fp["w2"], fp["b2"])
    ff = tuple(ffp[k] for k in ("norm_scale", "w1", "b1", "w2", "b2"))
    dev = DEVICE

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    q, ckv, ring, kv_new = randn(b, kvh, g, d), randn(b, kvh, Wc, 2 * d), \
        randn(b, kvh, Bc, 2 * d), randn(b, kvh, 1, 2 * d)
    mem_kv = fp["mem_kv"]
    kw = dict(max_blocks=MAX_LEN // Bs, stride=stride, sel_block=Bs, num_sel=num_sel,
              n_slide=n_slide, scale=scale)
    times, plain_times, errs, outs = {}, {}, [], {}
    for t in (DECODE_T, DECODE_T - 1):          # an emission step, then one without
        num_cb = t // stride
        caches = [(ckv.clone(), ring.clone()) for _ in range(2)]
        c_k, info_k = nsa_decode_fused.decode_select_emit(q, *caches[0], kv_new, mem_kv,
                                                          *weights, t, num_cb, **kw)
        c_p, info_p = nsa_decode_fused.decode_select_emit_plain(q, *caches[1], kv_new, mem_kv,
                                                                *weights, t, num_cb, **kw)
        _, scores = nsa_decode.select_scores_plain(q, ckv, mem_kv, num_cb, t, stride=stride,
                                                   sel_block=Bs, scale=scale)
        torch.cuda.synchronize()
        emit = nsa_decode_fused.emits(t, stride)
        err_c = max_err(c_k, c_p)
        ties = check_selection(info_k.reshape(b, kvh, -1), info_p.reshape(b, kvh, -1), scores,
                               num_sel, n_slide, f"decode_select_emit t={t}")
        check(torch.equal(caches[0][1], caches[1][1])
              and torch.equal(caches[0][1][:, :, -1:], kv_new)
              and torch.equal(caches[0][1][:, :, :-1], ring[:, :, 1:]),
              f"decode_select_emit t={t}: the shifted ring is not bit-equal")
        others = [i for i in range(Wc) if i != num_cb]
        for label, ckv_x in (("kernel", caches[0][0]), ("plain", caches[1][0])):
            check(torch.equal(ckv_x[:, :, others], ckv[:, :, others]),
                  f"decode_select_emit t={t}: the {label} wrote a ckv row other than {num_cb}")
        row_k, row_p = caches[0][0][:, :, num_cb], caches[1][0][:, :, num_cb]
        err_row = max_err(row_k, row_p)
        top_row = row_p.float().abs().max().item()
        if emit:
            check(err_row <= TOL_FUSED * top_row and not torch.equal(row_p, ckv[:, :, num_cb]),
                  f"decode_select_emit t={t}: the emitted ckv row disagrees")
        else:
            check(torch.equal(row_k, ckv[:, :, num_cb]) and torch.equal(row_p, ckv[:, :, num_cb]),
                  f"decode_select_emit t={t}: a row was emitted off the stride")
        check(err_c <= TOL_OUT and bool(torch.isfinite(c_k.float()).all()),
              f"decode_select_emit t={t}: c_out disagrees")
        print(f"  decode_select_emit bs {b} t={t} (emits: {emit}): max|err| c_out {err_c:.5f} "
              f"(tol {TOL_OUT}); ids equal on {b * kvh - ties}/{b * kvh} rows, {ties} differ "
              f"only by ties within {TIE}; emitted row max|err| {err_row:.5f} (tol {TOL_FUSED:g} "
              f"x max {top_row:.3f}); ring bit-equal; other ckv rows unchanged", flush=True)
        errs.append(max(err_c, err_row))
        outs[t] = (c_p, info_p)
        work = (q, ckv.clone(), ring.clone(), kv_new, mem_kv, *weights)
        times[t] = timed_ms(lambda: nsa_decode_fused.decode_select_emit(
            *work, t, num_cb, **kw), 50, flush)
        plain_times[t] = timed_ms(lambda: nsa_decode_fused.decode_select_emit_plain(
            *work, t, num_cb, **kw), 10, flush)
    # amortised over the stride: one emission step in `stride`
    amort = (times[DECODE_T] + (stride - 1) * times[DECODE_T - 1]) / stride
    amort_plain = (plain_times[DECODE_T] + (stride - 1) * plain_times[DECODE_T - 1]) / stride
    num_cb = DECODE_T // stride
    c_p, info_p = outs[DECODE_T]
    step_bytes = (nbytes(q, mem_kv, c_p, info_p, kv_new) + 2 * nbytes(ring)
                  + b * kvh * num_cb * 2 * d * 2)
    emit_bytes = nbytes(*weights) + b * kvh * 2 * d * 2
    hid = fp["w1k"].shape[2]
    step_flops = b * kvh * g * (num_cb + M) * 4 * d
    emit_flops = b * kvh * 2 * (Bc * d * hid + hid * d) * 2
    bms, by = bound_ms(step_bytes + emit_bytes / stride, step_flops + emit_flops / stride)
    print(f"  decode_select_emit bs {b}: {times[DECODE_T]:.4f} ms emitting, "
          f"{times[DECODE_T - 1]:.4f} ms not, {amort:.4f} ms amortised over {stride} steps "
          f"(bound {bms:.5f} ms, by {by}); plain {amort_plain:.4f} ms", flush=True)
    sel = {"name": "decode_select_emit", "route": "cuda",
           "source": "nsa_tpu_torch/csrc/nsa_decode_fused.cu",
           "replaces": "nsa_tpu/ops/pallas/nsa_decode_fused.py:441",
           "max_abs_err": max(errs), "ms": amort, "plain_ms": amort_plain,
           "bound_ms": bms, "bound_by": by, "library_ms": None,
           "ms_emit_step": times[DECODE_T], "ms_other_step": times[DECODE_T - 1]}

    # attend: both versions get the same info and c_out (the plain select's)
    t = DECODE_T
    rq, kv = randn(b, kvh, g, d), randn(b, kvh, MAX_LEN, 2 * d)
    kv_row = randn(b, kvh, 1, 2 * d)
    gates = torch.sigmoid(randn(b, kvh, g, 3).float()).to(torch.bfloat16)
    x = randn(b, 1, dim)
    akw = dict(sel_block=Bs, window=window, num_sel=num_sel, n_slide=n_slide, scale=scale,
               eps=cfg.norm_eps)
    kv_k, kv_p = kv.clone(), kv.clone()
    args = (kv_row, info_p, c_p, gates, x, fp["w_out"], t, ff)
    out_k = nsa_decode_fused.decode_attend_fused(rq, kv_k, *args, **akw)
    out_p = nsa_decode_fused.decode_attend_fused_plain(rq, kv_p, *args, **akw)
    torch.cuda.synchronize()
    err_a, top = max_err(out_k, out_p), out_p.float().abs().max().item()
    check(torch.equal(kv_k, kv_p) and torch.equal(kv_k[:, :, t], kv_row[:, :, 0])
          and torch.equal(kv_k[:, :, :t], kv[:, :, :t])
          and torch.equal(kv_k[:, :, t + 1:], kv[:, :, t + 1:]),
          "decode_attend_fused: the kv cache is not the old one with row t written")
    check(err_a <= TOL_FUSED * top and bool(torch.isfinite(out_k.float()).all()),
          "decode_attend_fused disagrees")
    print(f"  decode_attend_fused bs {b} (FF inside): max|err| {err_a:.5f} (tol {TOL_FUSED:g} x "
          f"max {top:.3f}); kv row {t} written, bit-equal; no other row changed", flush=True)
    vp = info_p.reshape(b, kvh, -1)[..., num_sel + n_slide:2 * num_sel + n_slide]
    rows = attend_rows(vp, t, Bs, n_slide, window, b * kvh)
    hid4 = ff[1].shape[1]
    bms, by = bound_ms(nbytes(rq, info_p, c_p, gates, x, kv_row, fp["w_out"], *ff, out_k)
                       + rows * 2 * d * 2 + nbytes(kv_row),
                       rows * g * 4 * d + b * 2 * (kvh * g * d * dim + 2 * dim * hid4))
    att = {"name": "decode_attend_fused", "route": "cuda",
           "source": "nsa_tpu_torch/csrc/nsa_decode_fused.cu",
           "replaces": "nsa_tpu/ops/pallas/nsa_decode_fused.py:830",
           "max_abs_err": err_a,
           "ms": timed_ms(lambda: nsa_decode_fused.decode_attend_fused(rq, kv_k, *args, **akw),
                          50, flush),
           "plain_ms": timed_ms(lambda: nsa_decode_fused.decode_attend_fused_plain(
               rq, kv_p, *args, **akw), 10, flush),
           "bound_ms": bms, "bound_by": by, "library_ms": None}
    print(f"  decode_attend_fused bs {b}: {att['ms']:.4f} ms (bound {bms:.5f} ms, by {by}); "
          f"plain {att['plain_ms']:.4f} ms", flush=True)
    return sel, att


def kernel_decode_mega(gen, flush, cfg, packed, b):
    """Row 12 at bs ``b``: the whole model's trained weights (packed);
    seeded tokens and caches at full length; an emission step and the step
    before it.  The rows a step writes (kv row t, the ring's new row, the
    emitted ckv row) come from bf16 roundings of float32 sums that the two
    versions take in another order, so they are held within TOL_FUSED of the
    largest value; every other cache row, and the ring's shifted rows, must
    be bit-equal to what was there."""
    nsa = cfg.nsa
    L, kvh, d, stride = cfg.depth, cfg.kv_heads, cfg.dim_head, nsa.compress_block_sliding_stride
    Bc, Bs, window = nsa.compress_block_size, nsa.selection_block_size, nsa.sliding_window_size
    num_sel, n_slide = nsa.num_selected_blocks, -(-window // nsa.selection_block_size) + 1
    Wc = _ckv_width(MAX_LEN, stride, nsa.num_compress_per_fine)
    mp = packed["mega"]
    dev = DEVICE

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    kv, ckv, ring = randn(L, b, kvh, MAX_LEN, 2 * d), randn(L, b, kvh, Wc, 2 * d), \
        randn(L, b, kvh, Bc, 2 * d)
    token = torch.randint(0, cfg.vocab_size, (b,), generator=gen, device=dev)
    infos = []                   # the plain version's selections, for the bound
    real_select = nsa_decode_mega.decode_select_emit_plain

    def recording_select(*a, **k):
        out = real_select(*a, **k)
        infos.append(out[1])
        return out

    times, plain_times, errs, phases = {}, {}, [], {}
    for t in (DECODE_T, DECODE_T - 1):           # an emission step, then one without
        num_cb, emit = t // stride, nsa_decode_fused.emits(t, stride)
        caches = [(kv.clone(), ckv.clone(), ring.clone()) for _ in range(2)]
        lg_k, tok_k, *_ = transformer_decode_step_mega(mp, cfg, token, *caches[0], t, greedy=True)
        infos.clear()
        nsa_decode_mega.decode_select_emit_plain = recording_select
        try:
            lg_p, tok_p, *_ = transformer_decode_step_mega(mp, cfg, token, *caches[1], t,
                                                           greedy=True, use_kernels=False)
        finally:
            nsa_decode_mega.decode_select_emit_plain = real_select
        torch.cuda.synchronize()
        err, top = max_err(lg_k, lg_p), lg_p.abs().max().item()
        check(bool(torch.isfinite(lg_k).all()) and err <= TOL_FUSED * top,
              f"decode_step_mega t={t}: logits disagree with the plain version")
        # the argmax: equal, except where the plain logits' top two are
        # closer than the tolerance
        top2 = lg_p.float().topk(2, dim=-1).values
        near = (top2[:, 0] - top2[:, 1]) <= TOL_FUSED * top
        check(bool(((tok_k[:, 0] == tok_p[:, 0]) | near).all())
              and torch.equal(tok_k[:, 0].long(), lg_k.argmax(-1)),
              f"decode_step_mega t={t}: the in-kernel argmax disagrees")
        slot = min(num_cb, Wc - 1)
        row_errs = []
        for (kv_x, ckv_x, ring_x) in caches:
            check(torch.equal(kv_x[..., :t, :], kv[..., :t, :])
                  and torch.equal(kv_x[..., t + 1:, :], kv[..., t + 1:, :])
                  and torch.equal(ring_x[..., :-1, :], ring[..., 1:, :])
                  and torch.equal(ckv_x[..., :slot, :], ckv[..., :slot, :])
                  and torch.equal(ckv_x[..., slot + 1:, :], ckv[..., slot + 1:, :]),
                  f"decode_step_mega t={t}: a cache row other than the step's own changed")
            check(emit or torch.equal(ckv_x, ckv),
                  f"decode_step_mega t={t}: a ckv row was written off the stride")
        for name, a_, b_ in (("kv row t", caches[0][0][..., t, :], caches[1][0][..., t, :]),
                             ("ring row", caches[0][2][..., -1, :], caches[1][2][..., -1, :]),
                             ("emitted ckv row", caches[0][1][..., slot, :],
                              caches[1][1][..., slot, :])):
            e, m = max_err(a_, b_), b_.float().abs().max().item()
            check(e <= TOL_FUSED * m, f"decode_step_mega t={t}: {name} disagrees")
            row_errs.append(e)
        print(f"  decode_step_mega bs {b} t={t} (emits: {emit}): logits max|err| {err:.5f} (tol "
              f"{TOL_FUSED:g} x max {top:.3f}); argmax equal on "
              f"{int((tok_k[:, 0] == tok_p[:, 0]).sum())}/{b} rows ({int(near.sum())} near-ties); "
              f"written rows max|err| kv {row_errs[0]:.5f} ring {row_errs[1]:.5f} ckv "
              f"{row_errs[2]:.5f}; every other cache row bit-equal", flush=True)
        errs.append(max(err, *row_errs))
        work = (kv.clone(), ckv.clone(), ring.clone())
        times[t] = timed_ms(lambda: transformer_decode_step_mega(
            mp, cfg, token, *work, t, greedy=True), 20, flush)
        plain_times[t] = timed_ms(lambda: transformer_decode_step_mega(
            mp, cfg, token, *work, t, greedy=True, use_kernels=False), 3, flush)
        if emit:
            emit_infos = list(infos)
        phases[t] = mega_phase_us(mp, cfg, token, work, t)
        print(f"  decode_step_mega bs {b} t={t}: us per phase (mean over layers): "
              f"{ {k: round(v, 2) for k, v in phases[t].items()} }", flush=True)
    amort = (times[DECODE_T] + (stride - 1) * times[DECODE_T - 1]) / stride
    amort_plain = (plain_times[DECODE_T] + (stride - 1) * plain_times[DECODE_T - 1]) / stride

    # the bound of the amortised step: each layer's weights, the live ckv
    # rows, the kv rows the masks keep, the ring read and written, the row
    # written; the compressors at 1 step in `stride`
    num_cb = DECODE_T // stride
    dense = [mp[k] for k in ("attn_norm", "w_qkvg", "gate_b", "mem_kv", "w_out", "ff_norm",
                             "fw1", "fb1", "fw2", "fb2", "out_norm", "to_logits")]
    comp = [mp[k] for k in ("pos_kv", "b1k", "b1v", "b2c", "w1k", "w1v", "w2c")]
    rows = sum(attend_rows(info.reshape(b, kvh, -1)[..., num_sel + n_slide:
                                                    2 * num_sel + n_slide],
                           DECODE_T, Bs, n_slide, window, b * kvh) for info in emit_infos)
    step_bytes = (nbytes(*dense) + b * cfg.dim * 2 + L * b * kvh * num_cb * 2 * d * 2
                  + rows * 2 * d * 2 + 2 * nbytes(ring) + L * b * kvh * 2 * d * 2
                  + b * cfg.vocab_size * 4 + b * 4)
    emit_bytes = nbytes(*comp) + L * b * kvh * 2 * d * 2
    P, hid4 = mp["w_qkvg"].shape[2], mp["fw1"].shape[2]
    g, hid = cfg.num_grouped_queries, mp["w1k"].shape[3]
    step_flops = (2 * b * L * (cfg.dim * P + cfg.dim_inner * cfg.dim + 2 * cfg.dim * hid4)
                  + 2 * b * cfg.dim * cfg.vocab_size
                  + L * b * kvh * g * (num_cb + nsa.num_compressed_mem_kv) * 4 * d
                  + rows * g * 4 * d)
    emit_flops = L * b * kvh * 2 * (Bc * d * hid + hid * d) * 2
    bms, by = bound_ms(step_bytes + emit_bytes / stride, step_flops + emit_flops / stride)
    print(f"  decode_step_mega bs {b}: {times[DECODE_T]:.4f} ms emitting, "
          f"{times[DECODE_T - 1]:.4f} ms not, {amort:.4f} ms amortised over {stride} steps "
          f"(bound {bms:.5f} ms, by {by}); plain {amort_plain:.4f} ms", flush=True)
    return {"name": "decode_step_mega", "route": "cuda",
            "source": "nsa_tpu_torch/csrc/nsa_decode_mega.cu",
            "replaces": "nsa_tpu/ops/pallas/nsa_megakernel.py:1234",
            "max_abs_err": max(errs), "ms": amort, "plain_ms": amort_plain,
            "bound_ms": bms, "bound_by": by, "library_ms": None,
            "ms_emit_step": times[DECODE_T], "ms_other_step": times[DECODE_T - 1],
            "phase_us_emit_step": phases[DECODE_T], "phase_us_other_step": phases[DECODE_T - 1]}


MEGA_PHASES = ("norm+qkvg", "select+emission", "attend+w_out", "residual+ff1", "ff2")


def mega_phase_us(mp, cfg, token, caches, t):
    """Where one launch's time goes: the kernel's global-timer marks after
    each grid sync, as microseconds per phase (the mean over the layers),
    the LM head, and the span from the first mark to the last."""
    L = cfg.depth
    marks = torch.zeros(nsa_decode_mega.phase_marks(L, 1), dtype=torch.int64, device=DEVICE)
    transformer_decode_step_mega(mp, cfg, token, *caches, t, greedy=True, phase_ns=marks)
    torch.cuda.synchronize()
    us = (marks[1:] - marks[:-1]).double().cpu() / 1e3
    per_layer = us[:5 * L].reshape(L, 5).mean(0)
    return {**{name: per_layer[i].item() for i, name in enumerate(MEGA_PHASES)},
            "lm_head": us[5 * L].item(), "span": (marks[-1] - marks[0]).item() / 1e3}


def ragged_positions(gen, b):
    """Per-row positions: t = 0; before the first full compression window
    5 (no emission), 7 and 15 (emitting); 4095 (emitting) and 4094, 3999
    (emitting) and 3998; the rest seeded uniform in [16, 4096)."""
    fixed = torch.tensor([0, 5, 7, 15, 4095, 4094, DECODE_T, DECODE_T - 1], device=DEVICE)
    rest = torch.randint(16, MAX_LEN, (b - len(fixed),), generator=gen, device=DEVICE)
    return torch.cat([fixed, rest]).int()


def ragged_attend_rows(info, t, cfg):
    """kv rows the attention of each (row, head) needs at its own t."""
    nsa = cfg.nsa
    Bs, window, num_sel = nsa.selection_block_size, nsa.sliding_window_size, nsa.num_selected_blocks
    n_slide = -(-window // Bs) + 1
    b, kvh = info.shape[0], cfg.kv_heads
    vp = info.reshape(b, kvh, -1)[..., num_sel + n_slide:2 * num_sel + n_slide].cpu()
    return sum(attend_rows(vp[i:i + 1], int(ti), Bs, n_slide, window, kvh)
               for i, ti in enumerate(t.tolist()))


def kernel_decode_ragged(gen, flush, cfg, params, b):
    """Rows 8-11 at ``b`` slots of MAX_LEN rows: layer 0's trained weights,
    packed; seeded queries, caches, residual stream and mixed positions."""
    nsa = cfg.nsa
    kvh, g, d, dim = cfg.kv_heads, cfg.num_grouped_queries, cfg.dim_head, cfg.dim
    stride, Bs, Bc, window = nsa.compress_block_sliding_stride, nsa.selection_block_size, \
        nsa.compress_block_size, nsa.sliding_window_size
    num_sel, M = nsa.num_selected_blocks, nsa.num_compressed_mem_kv
    n_slide = -(-window // Bs) + 1
    n_slots, scale = num_sel + n_slide, d ** -0.5
    Wc = _ckv_width(MAX_LEN, stride, nsa.num_compress_per_fine)
    layer = fuse_decode_layer(params["layers"][0], torch.bfloat16)
    fp, ffp = layer["attn"]["decode_fused"], layer["ff"]["decode_fused"]
    weights = (fp["pos_kv"], fp["w1k"], fp["b1k"], fp["w1v"], fp["b1v"], fp["w2"], fp["b2"])
    ff = tuple(ffp[k] for k in ("norm_scale", "w1", "b1", "w2", "b2"))
    mem_kv = fp["mem_kv"]
    R = nsa_decode_ragged

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=DEVICE).to(torch.bfloat16)

    q, ckv, ring, kv_new = randn(b, kvh, g, d), randn(b, kvh, Wc, 2 * d), \
        randn(b, kvh, Bc, 2 * d), randn(b, kvh, 1, 2 * d)
    t = ragged_positions(gen, b)
    num_cb = t // stride
    kw = dict(max_blocks=MAX_LEN // Bs, stride=stride, sel_block=Bs, num_sel=num_sel,
              n_slide=n_slide, scale=scale)
    rows = torch.arange(b, device=DEVICE)
    emit = R.ragged_emits(t, num_cb, stride)
    slot = num_cb.long().clamp(max=Wc - 1)

    # ---- row 8: the ragged select-emit at mixed positions ------------------
    caches = [(ckv.clone(), ring.clone()) for _ in range(2)]
    c_k, info_k = R.decode_select_emit_ragged(q, *caches[0], kv_new, mem_kv, *weights, t,
                                              num_cb, **kw)
    c_p, info_p = R.decode_select_emit_ragged_plain(q, *caches[1], kv_new, mem_kv, *weights, t,
                                                    num_cb, **kw)
    _, scores = nsa_decode.select_scores_plain(q, ckv, mem_kv, num_cb, t, stride=stride,
                                               sel_block=Bs, scale=scale)
    torch.cuda.synchronize()
    err_c, top_c = max_err(c_k, c_p), c_p.float().abs().max().item()
    ties = check_selection(info_k.reshape(b, kvh, -1), info_p.reshape(b, kvh, -1), scores,
                           num_sel, n_slide, "decode_select_emit_ragged")
    check(torch.equal(caches[0][1], caches[1][1])
          and torch.equal(caches[0][1][:, :, -1:], kv_new)
          and torch.equal(caches[0][1][:, :, :-1], ring[:, :, 1:]),
          "decode_select_emit_ragged: the shifted ring is not bit-equal")
    others = (torch.arange(Wc, device=DEVICE)[None] != slot[:, None])[:, None, :, None] \
        .expand_as(ckv)
    for label, ckv_x in (("kernel", caches[0][0]), ("plain", caches[1][0])):
        check(torch.equal(ckv_x[others], ckv[others]),
              f"decode_select_emit_ragged: the {label} wrote a ckv row off its row's slot")
        check(torch.equal(ckv_x[rows, :, slot][~emit], ckv[rows, :, slot][~emit]),
              f"decode_select_emit_ragged: the {label} wrote a non-emitting row's slot")
    row_k, row_p = caches[0][0][rows, :, slot][emit], caches[1][0][rows, :, slot][emit]
    err_row, top_row = max_err(row_k, row_p), row_p.float().abs().max().item()
    check(err_c <= TOL_FUSED * top_c and bool(torch.isfinite(c_k.float()).all()),
          "decode_select_emit_ragged: c_out disagrees")
    check(err_row <= TOL_FUSED * top_row, "decode_select_emit_ragged: an emitted row disagrees")
    n_emit = int(emit.sum())
    print(f"  decode_select_emit_ragged {b} slots at t={t.tolist()} ({n_emit} emit): max|err| "
          f"c_out {err_c:.5f} (tol {TOL_FUSED:g} x max {top_c:.3f}); ids equal on "
          f"{b * kvh - ties}/{b * kvh} rows, {ties} differ only by ties within {TIE}; emitted "
          f"rows max|err| {err_row:.5f} (tol {TOL_FUSED:g} x max {top_row:.3f}); ring "
          f"bit-equal; every other ckv row unchanged", flush=True)
    work = (q, ckv.clone(), ring.clone(), kv_new, mem_kv, *weights, t, num_cb)
    live = int(num_cb.sum())
    sel_bytes = (nbytes(q, mem_kv, c_p, info_p, kv_new, t, num_cb) + 2 * nbytes(ring)
                 + live * kvh * 2 * d * 2 + (nbytes(*weights) if n_emit else 0)
                 + n_emit * kvh * 2 * d * 2)
    hid = fp["w1k"].shape[2]
    sel_flops = ((live + b * M) * kvh * g * 4 * d
                 + n_emit * kvh * 2 * (Bc * d * hid + hid * d) * 2)
    bms, by = bound_ms(sel_bytes, sel_flops)
    sel = {"name": "decode_select_emit_ragged", "route": "cuda",
           "source": "nsa_tpu_torch/csrc/nsa_decode_ragged.cu",
           "replaces": "nsa_tpu/ops/pallas/nsa_decode_fused.py:1059",
           "max_abs_err": max(err_c, err_row),
           "ms": timed_ms(lambda: R.decode_select_emit_ragged(*work, **kw), 50, flush),
           "plain_ms": timed_ms(lambda: R.decode_select_emit_ragged_plain(*work, **kw), 10, flush),
           "bound_ms": bms, "bound_by": by, "library_ms": None}

    # ---- row 9: the ragged attend, FF inside, at the same positions --------
    rq, kv = randn(b, kvh, g, d), randn(b, kvh, MAX_LEN, 2 * d)
    kv_row = randn(b, kvh, 1, 2 * d)
    gates = torch.sigmoid(randn(b, kvh, g, 3).float()).to(torch.bfloat16)
    x = randn(b, 1, dim)
    akw = dict(sel_block=Bs, window=window, num_sel=num_sel, n_slide=n_slide, scale=scale,
               eps=cfg.norm_eps)
    args = (kv_row, info_p, c_p, gates, x, fp["w_out"], t, ff)
    kv_k, kv_p = kv.clone(), kv.clone()
    out_k = R.decode_attend_fused_ragged(rq, kv_k, *args, **akw)
    out_p = R.decode_attend_fused_ragged_plain(rq, kv_p, *args, **akw)
    torch.cuda.synchronize()
    err_a, top = max_err(out_k, out_p), out_p.float().abs().max().item()
    written = torch.zeros(b, MAX_LEN, dtype=torch.bool, device=DEVICE)
    written[rows, t.long()] = True
    written = written[:, None, :, None].expand_as(kv)
    check(torch.equal(kv_k, kv_p) and torch.equal(kv_k[rows, :, t.long()], kv_row[:, :, 0])
          and torch.equal(kv_k[~written], kv[~written]),
          "decode_attend_fused_ragged: the kv cache is not the old one with each row's t written")
    check(err_a <= TOL_FUSED * top and bool(torch.isfinite(out_k.float()).all()),
          "decode_attend_fused_ragged disagrees")
    print(f"  decode_attend_fused_ragged {b} slots (FF inside): max|err| {err_a:.5f} (tol "
          f"{TOL_FUSED:g} x max {top:.3f}); each row's kv row t written, bit-equal; no other "
          f"row changed", flush=True)
    kv_rows = ragged_attend_rows(info_p, t, cfg)
    hid4 = ff[1].shape[1]
    att_bytes = (nbytes(rq, info_p, c_p, gates, x, kv_row, fp["w_out"], *ff, out_k, t)
                 + kv_rows * 2 * d * 2 + nbytes(kv_row))
    att_flops = kv_rows * g * 4 * d + b * 2 * (kvh * g * d * dim + 2 * dim * hid4)
    bms, by = bound_ms(att_bytes, att_flops)
    att = {"name": "decode_attend_fused_ragged", "route": "cuda",
           "source": "nsa_tpu_torch/csrc/nsa_decode_ragged.cu",
           "replaces": "nsa_tpu/ops/pallas/nsa_decode_fused.py:1317",
           "max_abs_err": err_a,
           "ms": timed_ms(lambda: R.decode_attend_fused_ragged(rq, kv_k, *args, **akw), 50,
                          flush),
           "plain_ms": timed_ms(lambda: R.decode_attend_fused_ragged_plain(rq, kv_p, *args,
                                                                           **akw), 10, flush),
           "bound_ms": bms, "bound_by": by, "library_ms": None}

    # ---- row 10: the paged attend under a permutation table ----------------
    n_pg = MAX_LEN // PAGE_TOKENS
    table = torch.randperm(b * n_pg, generator=gen, device=DEVICE).reshape(b, n_pg).int()
    pool = randn(b * n_pg + 1, kvh, PAGE_TOKENS, 2 * d)
    pool[table.reshape(-1).long()] = kv.reshape(b, kvh, n_pg, PAGE_TOKENS, 2 * d) \
        .transpose(1, 2).reshape(-1, kvh, PAGE_TOKENS, 2 * d)
    trash = pool[-1].clone()
    pool_k, pool_p = pool.clone(), pool.clone()
    out_g = R.decode_attend_fused_paged(rq, pool_k, table, *args, **akw)
    out_gp = R.decode_attend_fused_paged_plain(rq, pool_p, table, *args, **akw)
    torch.cuda.synchronize()
    logical = pool_k[table.long()].transpose(1, 2).reshape(b, kvh, MAX_LEN, 2 * d)
    same = torch.equal(out_g, out_k)
    check(same and torch.equal(logical, kv_k) and torch.equal(pool_k[-1], trash),
          "decode_attend_fused_paged is not bit-equal to the ragged kernel on the same "
          "logical cache")
    err_g, top_g = max_err(out_g, out_gp), out_gp.float().abs().max().item()
    check(err_g <= TOL_FUSED * top_g and torch.equal(pool_k, pool_p),
          "decode_attend_fused_paged disagrees with its plain version")
    print(f"  decode_attend_fused_paged {b} slots, pages of {PAGE_TOKENS} rows under a "
          f"permutation table: output bit-equal to the ragged kernel's: {same}; its pool through "
          f"the table equals the ragged kernel's kv; max|err| vs plain {err_g:.5f} (tol "
          f"{TOL_FUSED:g} x max {top_g:.3f})", flush=True)
    bms, by = bound_ms(att_bytes + nbytes(table), att_flops)
    pag = {"name": "decode_attend_fused_paged", "route": "cuda",
           "source": "nsa_tpu_torch/csrc/nsa_decode_ragged.cu",
           "replaces": "nsa_tpu/ops/pallas/nsa_decode_fused.py:1608",
           "max_abs_err": err_g,
           "ms": timed_ms(lambda: R.decode_attend_fused_paged(rq, pool_k, table, *args, **akw),
                          50, flush),
           "plain_ms": timed_ms(lambda: R.decode_attend_fused_paged_plain(
               rq, pool_p, table, *args, **akw), 10, flush),
           "bound_ms": bms, "bound_by": by, "library_ms": None}

    # ---- rows 8-9 at one position for every row, against rows 6-7 ----------
    tu = torch.full((b,), DECODE_T, dtype=torch.int32, device=DEVICE)
    caches = [(ckv.clone(), ring.clone()) for _ in range(2)]
    c_r, info_r = R.decode_select_emit_ragged(q, *caches[0], kv_new, mem_kv, *weights, tu,
                                              tu // stride, **kw)
    c_s, info_s = nsa_decode_fused.decode_select_emit(q, *caches[1], kv_new, mem_kv, *weights,
                                                      DECODE_T, DECODE_T // stride, **kw)
    uargs = (kv_row, info_s, c_s, gates, x, fp["w_out"])
    kv_r, kv_s = kv.clone(), kv.clone()
    o_r = R.decode_attend_fused_ragged(rq, kv_r, *uargs, tu, ff, **akw)
    o_s = nsa_decode_fused.decode_attend_fused(rq, kv_s, *uargs, DECODE_T, ff, **akw)
    torch.cuda.synchronize()
    bits = {"c_out": torch.equal(c_r, c_s), "info": torch.equal(info_r, info_s),
            "ckv": torch.equal(caches[0][0], caches[1][0]),
            "ring": torch.equal(caches[0][1], caches[1][1]),
            "attend_out": torch.equal(o_r, o_s), "kv": torch.equal(kv_r, kv_s)}
    uerr = max(max_err(c_r, c_s) / max(c_s.float().abs().max().item(), 1e-30),
               max_err(caches[0][0], caches[1][0]) / caches[1][0].float().abs().max().item(),
               max_err(o_r, o_s) / o_s.float().abs().max().item())
    check(uerr <= TOL_FUSED and bits["ring"] and bits["kv"],
          "rows 8-9 at one position disagree with rows 6-7")
    check_selection(info_r.reshape(b, kvh, -1), info_s.reshape(b, kvh, -1),
                    nsa_decode.select_scores_plain(q, ckv, mem_kv, DECODE_T // stride, DECODE_T,
                                                   stride=stride, sel_block=Bs, scale=scale)[1],
                    num_sel, n_slide, "ragged vs one-position select")
    print(f"  rows 8-9 at t={DECODE_T} for every slot vs rows 6-7: max relative err {uerr:.5f} "
          f"(tol {TOL_FUSED:g}); bit-equal: {bits}", flush=True)

    # ---- row 11: the block gather of the ragged split route ----------------
    idx = info_p.reshape(b, kvh, -1)[..., :n_slots].contiguous()
    gk = paged_gather.paged_gather(kv, idx, Bs)
    gp = paged_gather.paged_gather_plain(kv, idx, Bs)
    blocks = kv.view(b, kvh, MAX_LEN // Bs, Bs, 2 * d)
    bi, hi, il = rows[:, None, None], torch.arange(kvh, device=DEVICE)[None, :, None], idx.long()
    lib = blocks[bi, hi, il]
    torch.cuda.synchronize()
    check(torch.equal(gk, gp) and torch.equal(gk, lib.reshape(gk.shape)),
          "paged_gather is not the blocks it was asked for")
    print(f"  paged_gather {b} slots x {kvh} heads x {n_slots} blocks of {Bs} rows: equal to "
          f"its plain version and to advanced indexing", flush=True)
    bms, by = bound_ms(2 * nbytes(gk) + nbytes(idx), 0)
    gat = {"name": "paged_gather", "route": "cuda", "source": "nsa_tpu_torch/csrc/paged_gather.cu",
           "replaces": "nsa_tpu/ops/pallas/paged_gather.py:73", "max_abs_err": 0.0,
           "ms": timed_ms(lambda: paged_gather.paged_gather(kv, idx, Bs), 50, flush),
           "plain_ms": timed_ms(lambda: paged_gather.paged_gather_plain(kv, idx, Bs), 10, flush),
           "bound_ms": bms, "bound_by": by,
           "library_ms": timed_ms(lambda: blocks[bi, hi, il], 50, flush)}
    for k in (sel, att, pag, gat):
        print(f"  {k['name']} {b} slots: {k['ms']:.4f} ms (bound {k['bound_ms']:.5f} ms, by "
              f"{k['bound_by']}); plain {k['plain_ms']:.4f} ms; library {k['library_ms']}",
              flush=True)
    return sel, att, pag, gat


def kernel_decode(gen, flush, cfg):
    nsa = cfg.nsa
    b, kvh, g, d = BATCH, cfg.kv_heads, cfg.num_grouped_queries, cfg.dim_head
    stride, Bs, window = nsa.compress_block_sliding_stride, nsa.selection_block_size, \
        nsa.sliding_window_size
    num_sel, M = nsa.num_selected_blocks, nsa.num_compressed_mem_kv
    n_slide = -(-window // Bs) + 1
    t, scale = DECODE_T, d ** -0.5
    num_cb = t // stride
    Wc = _ckv_width(MAX_LEN, stride, nsa.num_compress_per_fine)
    dev = DEVICE

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    q, ckv, mem_kv = randn(b, kvh, g, d), randn(b, kvh, Wc, 2 * d), randn(2, kvh, M, d)
    kw = dict(max_blocks=MAX_LEN // Bs, stride=stride, sel_block=Bs, num_sel=num_sel,
              n_slide=n_slide, scale=scale)
    c_k, info_k = nsa_decode.decode_select(q, ckv, mem_kv, t, num_cb, **kw)
    c_p, info_p = nsa_decode.decode_select_plain(q, ckv, mem_kv, t, num_cb, **kw)
    _, scores = nsa_decode.select_scores_plain(q, ckv, mem_kv, num_cb, t, stride=stride,
                                               sel_block=Bs, scale=scale)
    torch.cuda.synchronize()
    n_slots = num_sel + n_slide
    err_c = max_err(c_k, c_p)
    ties = check_selection(info_k, info_p, scores, num_sel, n_slide, "decode_select")
    vp = info_p[..., n_slots:n_slots + num_sel]
    print(f"  decode_select max|err| c_out {err_c:.5f} (tol {TOL_OUT}); ids equal on "
          f"{b * kvh - ties}/{b * kvh} rows, {ties} rows differ only by ties within {TIE}",
          flush=True)
    check(err_c <= TOL_OUT, "decode_select c_out disagrees")
    rows_read = b * kvh * num_cb * 2 * d * 2
    bms, by = bound_ms(nbytes(q, mem_kv, c_k, info_k) + rows_read,
                       b * kvh * g * (num_cb + M) * 4 * d)
    sel = {"name": "decode_select", "route": "cuda",
           "source": "nsa_tpu_torch/csrc/nsa_decode.cu",
           "replaces": "nsa_tpu/ops/pallas/nsa_decode.py:195",
           "max_abs_err": err_c,
           "ms": timed_ms(lambda: nsa_decode.decode_select(q, ckv, mem_kv, t, num_cb, **kw),
                          50, flush),
           "plain_ms": timed_ms(lambda: nsa_decode.decode_select_plain(
               q, ckv, mem_kv, t, num_cb, **kw), 10, flush),
           "bound_ms": bms, "bound_by": by, "library_ms": None}

    # attend: both versions get the same info, c_out and gates
    rq, kv = randn(b, kvh, g, d), randn(b, kvh, MAX_LEN, 2 * d)
    gates = torch.sigmoid(randn(b, kvh, g, 3).float()).to(torch.bfloat16)
    akw = dict(sel_block=Bs, window=window, num_sel=num_sel, n_slide=n_slide, scale=scale)
    out_k = nsa_decode.decode_attend(rq, kv, info_p, c_p, gates, t, **akw)
    out_p = nsa_decode.decode_attend_plain(rq, kv, info_p, c_p, gates, t, **akw)
    torch.cuda.synchronize()
    err_a = max_err(out_k, out_p)
    print(f"  decode_attend max|err| {err_a:.5f} (tol {TOL_OUT})", flush=True)
    check(err_a <= TOL_OUT and torch.isfinite(out_k.float()).all().item(),
          "decode_attend disagrees")
    rows = attend_rows(vp, t, Bs, n_slide, window, b * kvh)
    bms, by = bound_ms(nbytes(rq, info_p, c_p, gates, out_k) + rows * 2 * d * 2,
                       rows * g * 4 * d)
    att = {"name": "decode_attend", "route": "cuda",
           "source": "nsa_tpu_torch/csrc/nsa_decode.cu",
           "replaces": "nsa_tpu/ops/pallas/nsa_decode.py:325",
           "max_abs_err": err_a,
           "ms": timed_ms(lambda: nsa_decode.decode_attend(rq, kv, info_p, c_p, gates, t, **akw),
                          50, flush),
           "plain_ms": timed_ms(lambda: nsa_decode.decode_attend_plain(
               rq, kv, info_p, c_p, gates, t, **akw), 10, flush),
           "bound_ms": bms, "bound_by": by, "library_ms": None}
    return sel, att


def dropped_key_attention(q, k, v, keys):
    """Causal attention in the plain version's float32 numerics with keys
    keys[0] .. keys[1] - 1 left out of every query row past them: what a
    flash kernel that skipped one key tile of the late query tiles returns."""
    n, g = q.shape[2], q.shape[1] // k.shape[1]
    rows = torch.arange(n, device=q.device)[:, None]
    cols = torch.arange(n, device=q.device)[None, :]
    valid = (rows >= cols) & ~((cols >= keys[0]) & (cols < keys[1]) & (rows >= keys[1]))
    kf, vf = (x.float().repeat_interleave(g, 1) for x in (k, v))
    s = ((q.float() * q.shape[-1] ** -0.5) @ kf.transpose(-1, -2)).masked_fill(~valid, -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True)).masked_fill(~valid, 0.0)
    return ((p @ vf) / p.sum(-1, keepdim=True)).to(q.dtype)


def kernel_flash(gen, flush, cfg):
    """Row 13 at the full-attention serving cell: seeded bf16 q [64, 8, 3900,
    64], k / v [64, 4, 3900, 64], causal, against its plain version; SDPA
    on the same inputs is the library yardstick."""
    b, h, kvh, d, n = BATCH, cfg.heads, cfg.kv_heads, cfg.dim_head, PROMPT
    q = torch.randn((b, h, n, d), generator=gen, device=DEVICE).to(torch.bfloat16)
    k = torch.randn((b, kvh, n, d), generator=gen, device=DEVICE).to(torch.bfloat16)
    v = torch.randn((b, kvh, n, d), generator=gen, device=DEVICE).to(torch.bfloat16)
    got = flash.flash_attention(q, k, v)
    want = flash.flash_attention_plain(q, k, v)
    tol = flash.flash_attention_tolerance(q, k, v, want)
    torch.cuda.synchronize()
    err = max_err(got, want)
    ratio = ((got.float() - want.float()).abs() / tol).max().item()
    # the control: a wrong kernel's output on the first 2 sequences
    wrong = dropped_key_attention(q[:2], k[:2], v[:2], FLASH_DROPPED_KEYS)
    control = ((wrong.float() - want[:2].float()).abs() / tol[:2]).max().item()
    del tol, wrong

    def library():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)

    lib_err = max_err(library(), want)
    print(f"  flash_attention bs {b} n {n}: max|err| {err:.5f}, max |err| / bound {ratio:.4f} "
          f"(<= 1: 2^-7 |plain| + 2^-8 attention over |v|); keys {FLASH_DROPPED_KEYS[0]}.."
          f"{FLASH_DROPPED_KEYS[1] - 1} left out of the later rows: {control:.2f} (must be > 1); "
          f"the SDPA yardstick vs plain max|err| {lib_err:.5f}", flush=True)
    check(control > 1.0, "the flash rule passes a kernel that leaves out a key tile")
    check(bool(torch.isfinite(got.float()).all()) and ratio <= 1.0,
          "flash_attention disagrees with its plain version")
    flops = 4 * b * h * d * (n * (n + 1) // 2)            # q.k and p.v per (row, key <= row)
    bms, by = bound_ms(nbytes(q, k, v, got), flops)
    ms = timed_ms(lambda: flash.flash_attention(q, k, v), 10, flush)
    plain = timed_ms(lambda: flash.flash_attention_plain(q, k, v), 2, flush)
    lib = timed_ms(library, 10, flush)
    print(f"  flash_attention {ms:.4f} ms (bound {bms:.4f} ms by {by}: {ms / bms:.2f}x), plain "
          f"{plain:.3f} ms, SDPA {lib:.4f} ms", flush=True)
    return {"name": "flash_attention", "route": "cuda",
            "source": "nsa_tpu_torch/csrc/flash_attention.cu",
            "replaces": "nsa_tpu/ops/pallas/flash.py:248",
            "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bms,
            "bound_by": by, "library_ms": lib}


def _dev_us(e):
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def _report(prof, label, wall, per=1, top=8):
    """Print device time of a profile, by kernel and by the op that launched
    it; return the device's busy share of ``wall`` and the device records
    per ``per``.  Busy time sums the device-side records only (kernels,
    copies): an op's record carries its kernels' time again."""
    from torch.autograd import DeviceType

    avgs = [e for e in prof.key_averages() if _dev_us(e) > 0]
    kernels = [e for e in avgs if e.device_type == DeviceType.CUDA]
    ops = [e for e in avgs if e.device_type != DeviceType.CUDA]
    busy = sum(_dev_us(e) for e in kernels)
    unit = "step" if per > 1 else "run"
    print(f"  profile {label}: wall {wall * 1e3:.2f} ms, device busy {busy / 1e3:.2f} ms "
          f"({100 * busy / 1e6 / wall:.1f}%), {sum(e.count for e in kernels)} device "
          f"records", flush=True)
    for title, group in (("kernels", kernels), ("ops", ops)):
        print(f"   top {title}:", flush=True)
        for e in sorted(group, key=_dev_us, reverse=True)[:top]:
            print(f"    {_dev_us(e) / 1e3 / per:9.3f} ms/{unit} x{e.count // per:<5d} "
                  f"{e.key[:90]}", flush=True)
    return busy / 1e6 / wall, sum(e.count for e in kernels) / per


def profile_decode(params, cfg, token, cache, label, steps=5, route=None):
    """torch.profiler over ``steps`` decode steps on ``route`` after a warm
    step, on copies of the cache; returns the device's busy share of their
    wall time and the device records per step."""
    from torch.profiler import ProfilerActivity, profile

    transformer_decode_step(params, cfg, token, clone_cache(cache), route=route)   # warm
    cache = clone_cache(cache)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, cache = transformer_decode_step(params, cfg, token, cache, route=route)
            token = logits.argmax(-1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return _report(prof, f"{steps} decode steps, {label}", wall, per=steps)


def profile_main_path(params, cfg, ids, first, steps=5):
    """torch.profiler over one prefill and ``steps`` decode steps: device
    time by op; returns the device's busy share of the decode wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, cache = transformer_prefill(params, cfg, ids, MAX_LEN)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _report(prof, f"prefill {BATCH}x{PROMPT}", wall)
    return profile_decode(params, cfg, first, cache, f"bs {BATCH}", steps)[0]


def decode_run(params, cfg, first, cache, route=None, steps=1):
    """``GEN`` greedy decode steps from ``first``; returns (tokens, device
    seconds between CUDA events around the steps)."""
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    tokens = greedy_decode(params, cfg, first, cache, GEN, route=route, steps=steps)
    e.record()
    torch.cuda.synchronize()
    return tokens, s.elapsed_time(e) / 1e3


def zero_launches(counted):
    torch.cuda.synchronize()
    for fn in counted:
        fn.launches = 0


def read_launches(counted):
    torch.cuda.synchronize()
    return {fn.__name__: fn.launches for fn in counted}


def check_mega_steps(packed, cfg, first, start, b):
    """One launch of MEGA_STEPS greedy tokens against MEGA_STEPS launches of
    one, from copies of the same cache: the tokens, the last logits and
    every cache tensor bit for bit."""
    mp = packed["mega"]
    single, multi = clone_cache(start), clone_cache(start)
    tok, toks = first, []
    for i in range(MEGA_STEPS):
        lg1, nxt, *_ = transformer_decode_step_mega(mp, cfg, tok, *cache_tensors(single),
                                                    start.seq_len + i, greedy=True)
        toks.append(nxt)
        tok = nxt[:, 0]
    lgn, toksn, *_ = transformer_decode_step_mega(mp, cfg, first, *cache_tensors(multi),
                                                  start.seq_len, greedy=True, steps=MEGA_STEPS)
    torch.cuda.synchronize()
    same = (torch.equal(torch.cat(toks, 1), toksn) and torch.equal(lg1, lgn)
            and all(torch.equal(x, y) for a, c in zip(single.layers, multi.layers)
                    for x, y in zip(a, c)))
    print(f"  bs {b} one launch of {MEGA_STEPS} greedy tokens vs {MEGA_STEPS} launches of one: "
          f"tokens, last logits and caches bit-equal: {same}", flush=True)
    check(same, f"bs {b}: steps={MEGA_STEPS} differs from {MEGA_STEPS} single steps")


def small_batch_phase(params, cfg, smi):
    """The small-batch decode path at each of SMALL_BATCHES: prefill, then
    GEN greedy steps on the default route (the whole-model kernel), launch
    counts read around exactly that run; the first step against the plain
    whole-model decode, the fused and the split kernel routes;
    MEGA_STEPS tokens in one launch against single launches; tok/s of the
    routes in turns (mega, fused, [split, split,] fused, mega), the fused
    pair's launch counts read around its first run; ``measure_decode``
    (MEGA_STEPS tokens a launch); a profile of 5 steps on the mega and the
    fused route.  Returns the launch counts of the first batch size's runs,
    default and fused, and the metrics."""
    packed = fuse_decode_params(params, cfg)
    counted = (nsa_prefill.prefill_fwd, nsa_decode.decode_select, nsa_decode.decode_attend,
               nsa_decode_fused.decode_select_emit, nsa_decode_fused.decode_attend_fused,
               nsa_decode_mega.decode_step_mega)
    none = {fn.__name__: 0 for fn in counted}
    metrics, first_launches, fused_launches = {}, None, None
    for b in SMALL_BATCHES:
        check(use_mega_decode(cfg, b), f"bs {b} does not take the whole-model decode")
        ids = seeded_ids(b, PROMPT, cfg.vocab_size, SEED + b, DEVICE)
        zero_launches(counted)
        logits, cache = transformer_prefill(params, cfg, ids, MAX_LEN)
        first = logits[:, -1].argmax(-1)
        start = clone_cache(cache)
        tokens, decode_s = decode_run(packed, cfg, first, cache)
        launches = read_launches(counted)
        first_launches = first_launches or launches
        print(f"  bs {b} launches {launches}", flush=True)
        want = {**none, "prefill_fwd": cfg.depth, "decode_step_mega": GEN}
        check(launches == want, f"bs {b} small-batch launches {launches}, expected {want}")
        check(tuple(tokens.shape) == (b, GEN) and int(tokens.min()) >= 0
              and int(tokens.max()) < cfg.vocab_size, f"bs {b} generated tokens malformed")

        step0, _ = transformer_decode_step(packed, cfg, first, clone_cache(start))
        m = {"decode_tok_s": b * GEN / decode_s}
        for label, kw in (("plain whole-model decode", dict(use_kernels=False)),
                          ("fused kernel route", dict(route="fused")),
                          ("split kernel route", dict(route="split"))):
            ref, _ = transformer_decode_step(packed, cfg, first, clone_cache(start), **kw)
            err, scale_l = max_err(step0, ref), ref.abs().max().item()
            agree = (step0.argmax(-1) == ref.argmax(-1)).float().mean().item()
            print(f"  bs {b} first decode step logits: whole-model kernel vs {label} max|err| "
                  f"{err:.4f} (tol {TOL_LOGITS_REL} x max|logit| {scale_l:.2f}); argmax agrees "
                  f"on {agree * 100:.1f}% of rows", flush=True)
            check(bool(torch.isfinite(step0).all()) and err <= TOL_LOGITS_REL * max(scale_l, 1.0),
                  f"bs {b} whole-model decode logits disagree with the {label}")
            m[f"logits_max_abs_err_vs_{label.split()[0]}"] = err
        print(f"  bs {b} decode {GEN} steps: {decode_s:.3f}s = {b * GEN / decode_s:.1f} tok/s "
              f"(whole-model kernel, 1 token a launch); {smi}", flush=True)
        check_mega_steps(packed, cfg, first, start, b)

        # the routes in turns in this call; the fused pair's launches are
        # read around its first run
        order = (("mega", "fused", "split", "split", "fused", "mega") if b == SMALL_BATCHES[0]
                 else ("mega", "fused", "fused", "mega"))
        tps, toks = {r: [] for r in order}, {}
        for route in order:
            if route == "fused" and not tps["fused"]:
                zero_launches(counted)
            toks[route], sec = decode_run(packed, cfg, first, clone_cache(start), route)
            if route == "fused" and not tps["fused"]:
                runs = read_launches(counted)
                want = {**none, "decode_select_emit": cfg.depth * GEN,
                        "decode_attend_fused": cfg.depth * GEN}
                check(runs == want, f"bs {b} fused-route launches {runs}, expected {want}")
                fused_launches = fused_launches or runs
            tps[route].append(b * GEN / sec)
        means = {r: sum(v) / len(v) for r, v in tps.items()}
        agree = {r: (toks["mega"] == toks[r]).float().mean().item() for r in tps if r != "mega"}
        print(f"  bs {b} decode tok/s in turns {' '.join(order)}: {tps}; means {means}; greedy "
              f"tokens agree with the mega route's on {agree}; {smi}", flush=True)
        m.update({f"ab_{r}_tok_s": v for r, v in tps.items()})
        m["greedy_tokens_agree"] = agree

        tps_m = measure_decode(params, cfg, b, PROMPT, GEN, iters=3, seq_len=MAX_LEN, seed=SEED)
        print(f"  measure_decode bs {b} prompt {PROMPT} gen {GEN} max_len {MAX_LEN}: "
              f"{tps_m:.1f} tok/s (mean of 3, {_pick_mega_steps(GEN)} tokens a launch); {smi}",
              flush=True)
        m["measure_decode_tok_s"] = tps_m
        for label, route in (("mega", None), ("fused", "fused")):
            busy, records = profile_decode(packed, cfg, tokens[:, -1], start,
                                           f"bs {b} {label} route", route=route)
            m.update({f"{label}_device_busy": busy, f"{label}_device_records_per_step": records})
        metrics[f"bs{b}"] = m
        del cache, start
        torch.cuda.empty_cache()
    return first_launches, fused_launches, metrics


def serve_requests(n, seed=0):
    """``n`` seeded requests: prompts of 256-3900 bytes in [32, 127), as
    ``scripts/serve_bench.py`` makes them, and 32-128 new tokens each."""
    rs = np.random.RandomState(seed)
    reqs = []
    for _ in range(n):
        prompt = rs.randint(32, 127, size=rs.randint(256, 3901)).astype(np.int32)
        reqs.append((prompt, int(rs.randint(32, 129))))
    return reqs


class EngineRun:
    """Count the ragged decode steps and prefill waves of engine runs, and
    run every multi-token window under ``set_sync_debug_mode("error")``:
    a host sync inside one raises."""

    def __enter__(self):
        self.steps = self.waves = self.windows = 0
        self.real = (serve.transformer_decode_step_ragged, serve.wave_prefill,
                     serve.ragged_decode_multi)
        step, wave, multi = self.real

        def counted_step(*a, **k):
            self.steps += 1
            return step(*a, **k)

        def counted_wave(*a, **k):
            self.waves += 1
            return wave(*a, **k)

        def no_sync_multi(*a, **k):
            self.windows += 1
            torch.cuda.set_sync_debug_mode("error")
            try:
                return multi(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode("default")

        serve.transformer_decode_step_ragged = counted_step
        serve.wave_prefill = counted_wave
        serve.ragged_decode_multi = no_sync_multi
        return self

    def __exit__(self, *exc):
        (serve.transformer_decode_step_ragged, serve.wave_prefill,
         serve.ragged_decode_multi) = self.real


def run_engine(params, cfg, reqs, **kw):
    """Add ``reqs`` to a fresh engine and run it, the counts set to 0 just
    before and read just after; returns (tokens per request, engine, wall
    seconds, launches, steps, waves, windows, held), ``held`` the engine
    steps after whose admission requests waited beside a free slot (the
    paged pool out of pages)."""
    eng = serve.ContinuousBatchingEngine(params, cfg, max_batch=SERVE_SLOTS, max_len=MAX_LEN,
                                         prefill_buckets=SERVE_BUCKETS, **kw)
    rids = [eng.add_request(p, max_new_tokens=n) for p, n in reqs]
    admit, held = eng._admit, [0]

    def counted_admit():
        admit()
        held[0] += bool(eng.pending) and eng.num_active < eng.max_batch

    eng._admit = counted_admit
    with EngineRun() as run:
        zero_launches(ALL_KERNELS)
        t0 = time.perf_counter()
        outs = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches(ALL_KERNELS)
    check(sorted(outs) == sorted(rids) and not eng.pending and eng.num_active == 0,
          "the engine left requests unfinished")
    for (p, n), r in zip(reqs, rids):
        check(1 <= len(outs[r]) <= n and int(outs[r].min()) >= 0
              and int(outs[r].max()) < cfg.vocab_size, f"request {r}: malformed tokens")
    return [outs[r] for r in rids], eng, wall, launches, run.steps, run.waves, run.windows, \
        held[0]


def check_engine_launches(launches, depth, steps, waves, attend, label):
    none = {fn.__name__: 0 for fn in ALL_KERNELS}
    want = {**none, "prefill_fwd": depth * waves}
    if attend == "paged_gather":
        want["paged_gather"] = depth * steps
    else:
        want.update({"decode_select_emit_ragged": depth * steps, attend: depth * steps})
    print(f"  {label}: {steps} ragged steps, {waves} prefill waves; launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    check(launches == want, f"{label} launches {launches}, expected {want}")


def kv_pool_mib(eng):
    return sum(lc.kv.numel() * lc.kv.element_size() for lc in eng.cache_layers) / 2**20


def serve_phase(params, cfg, smi):
    """The serving engine at the cell: the checks on 4 requests first (they
    warm the prefill shapes), then the 48-request mix on the dense and the
    paged pool, then a profile of 5 ragged steps.  Returns the launch
    counts of the dense, paged and split runs and the metrics."""
    L = cfg.depth
    reqs = serve_requests(SERVE_REQUESTS)
    few = reqs[:SERVE_CHECK_REQUESTS]
    m = {}

    # 4 requests at 1 token a sync: the first ragged step's logits, against
    # prefill + one b = 1 decode step of the same prompt
    first_logits = []
    real_step = serve.ragged_decode_step

    def recording_step(*a, **k):
        out = real_step(*a, **k)
        if not first_logits:
            first_logits.append(out[0].clone())
        return out

    serve.ragged_decode_step = recording_step
    try:
        one, eng1, *_ = run_engine(params, cfg, few, steps_per_sync=1)
    finally:
        serve.ragged_decode_step = real_step
    eight, *_ = run_engine(params, cfg, few, steps_per_sync=SERVE_SYNC)
    same = all(np.array_equal(a, b) for a, b in zip(one, eight))
    print(f"  {SERVE_CHECK_REQUESTS} requests at 1 and at {SERVE_SYNC} tokens a sync: token "
          f"for token equal: {same}", flush=True)
    check(same, f"steps_per_sync 1 and {SERVE_SYNC} give different tokens")
    packed = eng1.params
    agree, errs, firsts = [], [], []
    for i, (prompt, n) in enumerate(few):
        # the prompt alone at its own length, then the engine's first token
        # through one decode step at b = 1 (the whole-model kernel)
        ids = torch.from_numpy(prompt).long().to(DEVICE)[None]
        logits, cache = transformer_prefill(packed, cfg, ids, MAX_LEN)
        firsts.append(int(logits[0, -1].argmax()) == int(one[i][0]))
        first = torch.tensor([int(one[i][0])], device=DEVICE)
        ref, cache = transformer_decode_step(packed, cfg, first, cache)
        got = first_logits[0][i]
        err, top = max_err(got, ref[0]), ref.abs().max().item()
        errs.append(err)
        check(bool(torch.isfinite(got).all()) and err <= TOL_LOGITS_REL * max(top, 1.0),
              f"request {i}: the engine's first ragged step disagrees with prefill + decode")
        toks = greedy_decode(packed, cfg, ref.argmax(-1), cache, n - 1)[0].cpu().numpy()
        agree.append(float(np.mean(toks == one[i][1:n])))
    print(f"  first ragged step logits vs prefill + a b = 1 decode step of the same token: "
          f"max|err| {[round(e, 4) for e in errs]} (tol {TOL_LOGITS_REL} x max|logit|); the "
          f"prefill's first token equals the engine's: {firsts}; the {[n - 1 for _, n in few]} "
          f"greedy tokens after it agree with b = 1 decoding on "
          f"{[round(a, 3) for a in agree]}", flush=True)
    m["first_step_logits_max_abs_err"] = max(errs)
    m["b1_token_agreement"] = agree

    # 4 requests on the split route: the block gather, depth times a step
    split, _, _, split_launches, steps, waves, _, _ = run_engine(
        params, cfg, few, steps_per_sync=SERVE_SYNC, route="split")
    check_engine_launches(split_launches, L, steps, waves, "paged_gather",
                          f"split route, {SERVE_CHECK_REQUESTS} requests")
    m["split_token_agreement"] = float(np.mean([np.mean(a == b) for a, b in zip(split, eight)]))

    # the 48-request mix, dense then paged
    runs = {}
    for label, kw, attend in (
            ("dense", {}, "decode_attend_fused_ragged"),
            ("paged", dict(paged_pool_pages=POOL_PAGES, page_tokens=PAGE_TOKENS),
             "decode_attend_fused_paged")):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        toks, eng, wall, launches, steps, waves, windows, held = run_engine(
            params, cfg, reqs, steps_per_sync=SERVE_SYNC, **kw)
        peak = torch.cuda.max_memory_allocated()
        check_engine_launches(launches, L, steps, waves, attend, f"{label} pool")
        if label == "paged":
            check(sorted(eng._free_pages) == list(range(POOL_PAGES))
                  and bool(np.all(eng.page_table == eng.trash_page)),
                  "paged engine: pages not all back on the free list")
        new = sum(len(x) for x in toks)
        mib = kv_pool_mib(eng)
        runs[label] = dict(tokens=toks, launches=launches)
        print(f"  serve {label}: {SERVE_REQUESTS} requests, {new} new tokens in {wall:.3f}s = "
              f"{new / wall:.1f} new tokens/s, {SERVE_REQUESTS / wall:.3f} requests/s; "
              f"{steps} ragged steps in {windows} windows of {SERVE_SYNC} (no host sync inside "
              f"any), {waves} prefill waves, requests held back beside a free slot after "
              f"{held} admissions; kv pool {mib:.1f} MiB ({mib / L:.2f} MiB a layer); "
              f"peak memory {peak / 2**30:.2f} GiB; {smi}", flush=True)
        m[label] = {"wall_s": wall, "new_tokens": new, "new_tokens_per_s": new / wall,
                    "requests_per_s": SERVE_REQUESTS / wall, "ragged_steps": steps,
                    "windows": windows, "waves": waves, "held_admissions": held,
                    "kv_pool_mib": mib,
                    "peak_bytes": peak}
        del eng
    same = all(np.array_equal(a, b) for a, b in zip(runs["dense"]["tokens"],
                                                    runs["paged"]["tokens"]))
    print(f"  every request's tokens equal on the dense and the paged pool: {same}", flush=True)
    check(same, "the dense and the paged engine give different tokens")

    # a profile of 5 ragged steps at 16 slots (the mix's first 16 admitted)
    from torch.profiler import ProfilerActivity, profile

    eng = serve.ContinuousBatchingEngine(params, cfg, max_batch=SERVE_SLOTS, max_len=MAX_LEN,
                                         prefill_buckets=SERVE_BUCKETS)
    for p, n in reqs[:SERVE_SLOTS]:
        eng.add_request(p, max_new_tokens=n)
    eng._admit()
    args = eng._decode_args()
    serve.ragged_decode_step(*args)                          # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            serve.ragged_decode_step(*args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, records = _report(prof, f"5 ragged decode steps, {SERVE_SLOTS} slots", wall, per=5)
    m.update({"ragged_step_device_busy": busy, "ragged_step_device_records": records,
              "ragged_step_ms_profiled": wall / 5 * 1e3})
    del eng
    torch.cuda.empty_cache()
    return runs["dense"]["launches"], runs["paged"]["launches"], split_launches, m


def copy_ms(prof, per):
    """(device ms per ``per`` of all copy kernels in a profile, the longest
    single copy kernel in ms), from the profile's device events one by one."""
    from torch.autograd import DeviceType

    copies = [_dev_us(e) for e in prof.events() if e.device_type == DeviceType.CUDA
              and ("copy" in e.name.lower() or "memcpy" in e.name.lower())]
    return sum(copies) / 1e3 / per, max(copies, default=0.0) / 1e3


def full_phase(sparse_params, sparse_cfg, smi):
    """The full-attention baseline at the serving cell: prefill + GEN greedy
    steps with launch counts read around exactly that run; the first step
    against the plain path; the engine at 1 and 8 tokens a sync; the
    benchmark's turns; a profile of the prefill and 5 decode steps.
    Returns the run's launch counts and the metrics."""
    params, meta = load_params_npz(FULL_WEIGHTS, device="cuda", dtype=torch.bfloat16)
    cfg = model_config_from_meta(meta).replace(dtype="bfloat16")
    print(f"  loaded {os.path.relpath(FULL_WEIGHTS, HERE)} (step {meta.get('step')}): depth "
          f"{cfg.depth}, dim {cfg.dim}, heads {cfg.heads}/{cfg.kv_heads}, sparse "
          f"{cfg.use_sparse_attn}", flush=True)
    check(not cfg.use_sparse_attn, "the full-attention weights load as a sparse model")
    params = fuse_decode_params(params, cfg)          # the fused q|k|v, once
    ids = seeded_ids(BATCH, PROMPT, cfg.vocab_size, SEED, DEVICE)
    torch.cuda.reset_peak_memory_stats()
    zero_launches(ALL_KERNELS)
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    logits, cache = transformer_prefill(params, cfg, ids, MAX_LEN)
    e.record()
    first = logits[:, -1].argmax(-1)
    start = clone_cache(cache)
    ds, de = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ds.record()
    step0, cache = transformer_decode_step(params, cfg, first, cache)
    tokens = torch.cat([first[:, None],
                        greedy_decode(params, cfg, step0.argmax(-1), cache, GEN - 1)], 1)
    de.record()
    launches = read_launches(ALL_KERNELS)
    prefill_s, decode_s = s.elapsed_time(e) / 1e3, ds.elapsed_time(de) / 1e3
    peak = torch.cuda.max_memory_allocated()
    print(f"  full launches { {k: v for k, v in launches.items() if v} }", flush=True)
    want = {**{fn.__name__: 0 for fn in ALL_KERNELS}, "flash_attention": cfg.depth}
    check(launches == want, f"full-model launches {launches}, expected {want}")
    check(all(isinstance(lc, KVDecodeCache) for lc in cache.layers)
          and cache.layers[0].kv.shape == (BATCH, cfg.kv_heads, MAX_LEN, 2 * cfg.dim_head),
          "full-model cache malformed")
    check(tuple(logits.shape) == (BATCH, PROMPT, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "full prefill logits not finite/shaped")
    check(tuple(tokens.shape) == (BATCH, GEN) and int(tokens.min()) >= 0
          and int(tokens.max()) < cfg.vocab_size, "full-model tokens malformed")

    # the plain path: the plain flash prefill, then the same first step
    p_logits, p_cache = transformer_forward(params, cfg, ids, return_cache_max_len=MAX_LEN,
                                            use_kernels=False)
    pre_err = max_err(logits, p_logits)
    plain_step, _ = transformer_decode_step(params, cfg, first, p_cache)
    err, scale_l = max_err(step0, plain_step), plain_step.abs().max().item()
    agree = (step0.argmax(-1) == plain_step.argmax(-1)).float().mean().item()
    print(f"  full prefill logits kernel vs plain max|err| {pre_err:.4f} (tol {TOL_LOGITS_REL} "
          f"x max|logit| {p_logits.abs().max().item():.2f}); first decode step "
          f"logits max|err| {err:.4f} (tol {TOL_LOGITS_REL} x max|logit| {scale_l:.2f}); greedy "
          f"tokens agree on {agree * 100:.1f}% of rows", flush=True)
    check(pre_err <= TOL_LOGITS_REL * max(p_logits.abs().max().item(), 1.0),
          "full-model prefill logits disagree with the plain path")
    check(bool(torch.isfinite(step0).all()) and err <= TOL_LOGITS_REL * max(scale_l, 1.0),
          "full-model decode logits disagree with the plain path")
    print(f"  full prefill {BATCH}x{PROMPT}: {prefill_s:.3f}s; decode {GEN} steps: "
          f"{decode_s:.3f}s = {BATCH * GEN / decode_s:.1f} tok/s; peak memory "
          f"{peak / 2**30:.2f} GiB; {smi}", flush=True)
    m = {"prefill_s": prefill_s, "decode_tok_s": BATCH * GEN / decode_s, "peak_bytes": peak,
         "prefill_logits_max_abs_err": pre_err, "logits_max_abs_err": err}
    del p_logits, p_cache, cache, logits

    # the engine's dense pool, 4 requests at 1 and at SERVE_SYNC tokens a sync
    few = serve_requests(SERVE_CHECK_REQUESTS)
    runs = []
    for sps in (1, SERVE_SYNC):
        toks, eng, wall, e_launches, steps, waves, _, _ = run_engine(params, cfg, few,
                                                                     steps_per_sync=sps)
        want = {**{fn.__name__: 0 for fn in ALL_KERNELS}, "flash_attention": cfg.depth * waves}
        check(e_launches == want, f"full engine launches {e_launches}, expected {want}")
        check(all(isinstance(lc, KVDecodeCache) for lc in eng.cache_layers),
              "the full engine's pool is not a kv cache")
        runs.append(toks)
        print(f"  full engine, {SERVE_CHECK_REQUESTS} requests at {sps} token(s) a sync: "
              f"{steps} ragged steps, {waves} prefill waves, {sum(len(x) for x in toks)} new "
              f"tokens in {wall:.3f}s", flush=True)
        del eng
    same = all(np.array_equal(a, b) for a, b in zip(*runs))
    print(f"  full engine at 1 and {SERVE_SYNC} tokens a sync: token for token equal: {same}",
          flush=True)
    check(same, "the full engine gives different tokens at 1 and 8 tokens a sync")

    # the benchmark's turns, both models already on the card
    result = port_bench.run_bench(models={"sparse_mlp": (sparse_params, sparse_cfg, "trained"),
                                          "full_attn": (params, cfg, "trained")},
                                  log=lambda line: print("  " + line, flush=True))
    print(json.dumps({"bench": result}), flush=True)
    m["bench"] = result

    # where the time goes: the prefill, then 5 decode steps from its cache
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        transformer_prefill(params, cfg, ids, MAX_LEN)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    m["prefill_device_busy"] = _report(prof, f"full prefill {BATCH}x{PROMPT}", wall)[0]
    token = tokens[:, 0]
    transformer_decode_step(params, cfg, token, clone_cache(start))       # warm

    def steps(copy_slice):
        """5 decode steps from the prefill's cache under the profiler; with
        ``copy_slice`` each step also copies one cache slice (the control)."""
        tok, run_cache = token, clone_cache(start)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(5):
                lg, run_cache = transformer_decode_step(params, cfg, tok, run_cache)
                tok = lg.argmax(-1)
                if copy_slice:
                    run_cache.layers[0].kv[..., :cfg.dim_head].contiguous()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        return prof, wall

    prof, wall = steps(False)
    busy, records = _report(prof, f"5 full decode steps, bs {BATCH}", wall, per=5)
    copies, longest = copy_ms(prof, 5)
    control = steps(True)[0]
    slice_ms = copy_ms(control, 5)[1]
    if slice_ms <= MAX_COPY_KERNEL_MS:
        _report(control, "the control's 5 steps", wall, per=5)
    print(f"  full decode: copy kernels {copies:.4f} ms a step, the longest {longest:.4f} ms "
          f"(max {MAX_COPY_KERNEL_MS}: no copy of a cache slice); the same steps, each with "
          f"a deliberate copy of one cache slice: the longest {slice_ms:.4f} ms", flush=True)
    check(slice_ms > MAX_COPY_KERNEL_MS, "the no-copy gate misses a copy of a cache slice")
    check(longest <= MAX_COPY_KERNEL_MS, "the full decode step copies its cache")
    m.update({"decode_device_busy": busy, "decode_device_records_per_step": records,
              "decode_step_ms_profiled": wall / 5 * 1e3, "decode_copy_ms_per_step": copies,
              "decode_longest_copy_ms": longest, "cache_slice_copy_ms": slice_ms})
    del params, start
    torch.cuda.empty_cache()
    return launches, m


class StepLog(MetricsLogger):
    """The trainer's logger, keeping what it logs for the gates."""

    def __init__(self, csv_path):
        super().__init__(csv_path)
        self.rows = []

    def log(self, step, **metrics):
        super().log(step, **metrics)
        self.rows.append((step, metrics))


def expected_launches(cfg, tc, start):
    """Kernel launches of ``run_pretrain`` over steps start .. num_batches-1:
    a forward per micro-batch, validation and generation prefill, a backward
    per micro-batch, and the generation's decode steps."""
    steps = range(start, tc.num_batches)
    val = sum(s % tc.validate_every == 0 for s in steps)
    gen = sum(bool(tc.generate_every) and s % tc.generate_every == 0 and s > 0 for s in steps)
    micro = len(steps) * tc.grad_accum_every
    return {"prefill_fwd": cfg.depth * (micro + val + gen),
            "prefill_bwd_dq": cfg.depth * micro, "prefill_bwd_dkv": cfg.depth * micro,
            "decode_select": 0, "decode_attend": 0,       # generation runs at bs 1: mega
            "decode_select_emit": 0, "decode_attend_fused": 0,
            "decode_step_mega": gen * tc.generate_length}


def rel_l2(a, b):
    diff = (a.float() - b.float()).norm().item()
    ref = b.float().norm().item()
    return diff / ref if ref > 0 else diff


def train_phase(smi):
    """The training path at the cell, from a seeded random init; returns its
    launch counts and metrics."""
    cfg = nsa_tpu_torch.reference_model_config().replace(dtype="bfloat16")
    counted = (nsa_prefill.prefill_fwd, nsa_prefill.prefill_bwd_dq, nsa_prefill.prefill_bwd_dkv,
               nsa_decode.decode_select, nsa_decode.decode_attend,
               nsa_decode_fused.decode_select_emit, nsa_decode_fused.decode_attend_fused,
               nsa_decode_mega.decode_step_mega)
    here = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            tc = TrainConfig(num_batches=TRAIN_STEPS, batch_size=MICRO, grad_accum_every=ACCUM,
                             seq_len=SEQ, log_every=1, validate_every=2, generate_every=2,
                             generate_length=16, ckpt_every=CKPT_STEP,
                             ckpt_dir=os.path.join(tmp, "ckpt", "smoke"),
                             log_csv=os.path.join(tmp, "ckpt", "smoke", "log.csv"))
            data = DataConfig(path=os.path.join(tmp, "enwik8.gz"), synthetic_bytes=CORPUS_BYTES)
            log1, log2 = StepLog(tc.log_csv), StepLog(tc.log_csv)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for fn in counted:
                fn.launches = 0
            t0 = time.perf_counter()
            pretrain.run_pretrain(cfg, tc, data, logger=log1, device=DEVICE)
            ckpt = latest_checkpoint(tc.ckpt_dir)
            check(ckpt is not None and ckpt.endswith(f"step_{CKPT_STEP:08d}"),
                  f"no checkpoint at step {CKPT_STEP}: {ckpt}")
            check(os.path.isfile(os.path.join(tmp, "ckpt_export", "smoke.npz")),
                  "run_pretrain wrote no export")
            # the resume must start at the checkpoint's step, from its params
            saved = tree_leaves(restore_checkpoint(ckpt, ("params",), DEVICE)[0]["params"])
            first = []
            real_step = pretrain.train_step

            def recording_step(params, *args, **kw):
                if not first:
                    first.append(all(torch.equal(p.detach(), q)
                                     for p, q in zip(tree_leaves(params), saved)))
                return real_step(params, *args, **kw)

            pretrain.train_step = recording_step
            try:
                pretrain.run_pretrain(cfg, tc, data, logger=log2, device=DEVICE)
            finally:
                pretrain.train_step = real_step
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            launches = {fn.__name__: fn.launches for fn in counted}
            peak = torch.cuda.max_memory_allocated()
        finally:
            os.chdir(here)
    want = expected_launches(cfg, tc, 0)
    for k, n in expected_launches(cfg, tc, CKPT_STEP).items():
        want[k] += n
    print(f"  train launches {launches}", flush=True)
    check(launches == want, f"train-path launches {launches}, expected {want}")
    check(first == [True] and log2.rows and log2.rows[0][0] == CKPT_STEP,
          f"resume did not start at step {CKPT_STEP} from the saved params")
    losses = [m.get("loss", m.get("valid_loss")) for _, m in log1.rows + log2.rows]
    check(len(losses) == 3 + 2 + 1 + 1 and all(math.isfinite(x) for x in losses),
          f"train losses not all finite: {losses}")
    print(f"  train: {TRAIN_STEPS} + {TRAIN_STEPS - CKPT_STEP} steps of {MICRO}x{ACCUM}x{SEQ} "
          f"in {train_s:.2f}s (corpus, checkpoints, validation and generation included); "
          f"peak memory {peak / 2**30:.2f} GiB; {smi}", flush=True)

    # one micro-batch: loss and every gradient, kernels vs the plain path,
    # and vs the kernel forward with the plain backward (the two backward
    # kernels alone)
    params = pretrain.trainable(init_transformer(cfg, torch.Generator().manual_seed(SEED),
                                                 device="cpu"), DEVICE)
    ids = seeded_ids(MICRO, SEQ + 1, cfg.vocab_size, SEED + 1, DEVICE)
    leaves = tree_leaves(params)

    def loss_and_grads(use_kernels):
        loss = transformer_loss(params, cfg, ids, use_kernels=use_kernels)
        return loss.item(), torch.autograd.grad(loss, leaves)

    lk, gk = loss_and_grads(True)
    lp, gp = loss_and_grads(False)
    kernel_bwd = nsa_prefill.prefill_bwd_dq, nsa_prefill.prefill_bwd_dkv
    nsa_prefill.prefill_bwd_dq = nsa_prefill.prefill_bwd_dq_plain
    nsa_prefill.prefill_bwd_dkv = nsa_prefill.prefill_bwd_dkv_plain
    try:
        _, gh = loss_and_grads(True)
    finally:
        nsa_prefill.prefill_bwd_dq, nsa_prefill.prefill_bwd_dkv = kernel_bwd
    check(math.isfinite(lk) and abs(lk - lp) <= TOL_LOSS_REL * abs(lp),
          f"kernel-path loss {lk} disagrees with the plain path's {lp}")
    check(all(torch.isfinite(g).all().item() for g in gk), "kernel-path gradients not finite")
    print(f"  micro-batch {MICRO}x{SEQ} loss kernels {lk:.6f} plain {lp:.6f}", flush=True)
    grad_errs = {}
    for label, other, tol in (("plain path", gp, TOL_GRAD_REL_L2),
                              ("kernel forward + plain backward", gh, TOL_GRAD_BWD_REL_L2)):
        errs = {key: rel_l2(a, b) for (key, _), a, b in zip(tree_items(params), gk, other)}
        worst = max(errs, key=errs.get)
        grad_errs[label] = errs[worst]
        print(f"  gradients, kernels vs {label}: rel L2 max {errs[worst]:.3e} at {worst} "
              f"(tol {tol}), median {sorted(errs.values())[len(errs) // 2]:.3e} "
              f"over {len(errs)} tensors", flush=True)
        check(errs[worst] <= tol, f"kernel-path gradients disagree with the {label}")
    del gk, gp, gh

    tps = measure_train(params, cfg, MICRO, ACCUM, SEQ, iters=3, seed=SEED, device=DEVICE)
    print(f"  measure_train micro {MICRO} accum {ACCUM} seq {SEQ}: {tps:.1f} tokens/s "
          f"(mean of 3 steps); {smi}", flush=True)

    from torch.profiler import ProfilerActivity, profile

    loss = transformer_loss(params, cfg, ids)        # warm
    loss.backward()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        transformer_loss(params, cfg, ids).backward()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = _report(prof, f"one training micro-step {MICRO}x{SEQ}", wall)[0]
    return launches, {"train_s": train_s, "train_peak_bytes": peak,
                      "train_losses": losses, "measure_train_tok_s": tps,
                      "grad_rel_l2_max": grad_errs["plain path"],
                      "grad_rel_l2_max_bwd_only": grad_errs["kernel forward + plain backward"],
                      "loss_kernels": lk, "loss_plain": lp,
                      "train_micro_step_device_busy": busy}


def main():
    faulthandler.dump_traceback_later(TIME_LIMIT_S, exit=True)
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on a GPU", file=sys.stderr)
        sys.exit(1)
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=30, check=True).stdout.strip().splitlines()[0]
    print(f"device {kind} x{count}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"nvidia-smi: {smi}", flush=True)
    t0 = phase("device", t0)

    lib = runtime.library()
    print(f"  built {os.path.relpath(lib.path, HERE)} in {lib.build_seconds:.2f}s", flush=True)
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  " + line.strip(), flush=True)
    t0 = phase("build", t0)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.inference_mode():
        params, meta = load_params_npz(WEIGHTS, device="cuda", dtype=torch.bfloat16)
        cfg = model_config_from_meta(meta).replace(dtype="bfloat16")
        print(f"  loaded {os.path.relpath(WEIGHTS, HERE)} (step {meta.get('step')}): "
              f"depth {cfg.depth}, dim {cfg.dim}, heads {cfg.heads}/{cfg.kv_heads}, "
              f"dim_head {cfg.dim_head}, compressor {cfg.nsa.compressor}", flush=True)
        t0 = phase("weights", t0)

        gen = torch.Generator(device="cuda").manual_seed(SEED)
        flush = torch.empty(256 << 20, dtype=torch.int8, device="cuda")
        kernels = [kernel_prefill(gen, flush, cfg), *kernel_decode(gen, flush, cfg),
                   *kernel_prefill_bwd(gen, flush, cfg),
                   *kernel_decode_fused(gen, flush, cfg, params, SMALL_BATCHES[0]),
                   kernel_decode_mega(gen, flush, cfg, fuse_decode_params(params, cfg),
                                      SMALL_BATCHES[0]),
                   *kernel_decode_ragged(gen, flush, cfg, params, SERVE_SLOTS),
                   kernel_flash(gen, flush, cfg)]
        del flush
        torch.cuda.empty_cache()
        t0 = phase("kernels", t0)

        ids = seeded_ids(BATCH, PROMPT, cfg.vocab_size, SEED, "cuda")
        counted = (nsa_prefill.prefill_fwd, nsa_decode.decode_select, nsa_decode.decode_attend,
                   nsa_decode_fused.decode_select_emit, nsa_decode_fused.decode_attend_fused,
                   nsa_decode_mega.decode_step_mega, flash.flash_attention)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counted:
            fn.launches = 0
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        logits, cache = transformer_prefill(params, cfg, ids, MAX_LEN)
        e.record()
        first = logits[:, -1].argmax(-1)
        plain_cache = clone_cache(cache)
        ds, de = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ds.record()
        step0, cache = transformer_decode_step(params, cfg, first, cache)
        tokens = torch.cat([first[:, None],
                            greedy_decode(params, cfg, step0.argmax(-1), cache, GEN - 1)], 1)
        de.record()
        torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches for fn in counted}
        prefill_s = s.elapsed_time(e) / 1e3
        decode_s = ds.elapsed_time(de) / 1e3
        peak = torch.cuda.max_memory_allocated()
        print(f"  launches {launches}", flush=True)
        want = {"prefill_fwd": cfg.depth, "decode_select": cfg.depth * GEN,
                "decode_attend": cfg.depth * GEN, "decode_select_emit": 0,
                "decode_attend_fused": 0, "decode_step_mega": 0,   # bs 64: the split route
                "flash_attention": 0}
        check(launches == want, f"main-path launches {launches}, expected {want}")
        check(tuple(logits.shape) == (BATCH, PROMPT, cfg.vocab_size)
              and bool(torch.isfinite(logits).all()), "prefill logits not finite/shaped")
        check(tuple(tokens.shape) == (BATCH, GEN) and int(tokens.min()) >= 0
              and int(tokens.max()) < cfg.vocab_size, "generated tokens malformed")

        plain_logits, _ = transformer_decode_step(params, cfg, first, plain_cache,
                                                  use_kernels=False)
        err = max_err(step0, plain_logits)
        scale_l = plain_logits.abs().max().item()
        agree = (step0.argmax(-1) == plain_logits.argmax(-1)).float().mean().item()
        print(f"  first decode step logits: kernels vs plain max|err| {err:.4f} "
              f"(tol {TOL_LOGITS_REL} x max|logit| {scale_l:.2f}); greedy tokens agree "
              f"on {agree * 100:.1f}% of rows", flush=True)
        check(bool(torch.isfinite(step0).all()) and err <= TOL_LOGITS_REL * max(scale_l, 1.0),
              "kernel-path decode logits disagree with the plain path")
        print(f"  prefill {BATCH}x{PROMPT}: {prefill_s:.3f}s; decode {GEN} steps: "
              f"{decode_s:.3f}s = {BATCH * GEN / decode_s:.1f} tok/s; peak memory "
              f"{peak / 2**30:.2f} GiB; {smi}", flush=True)
        del plain_cache, cache
        t0 = phase("main", t0)

        tps = measure_decode(params, cfg, BATCH, PROMPT, GEN, iters=3, seq_len=MAX_LEN,
                             seed=SEED)
        print(f"  measure_decode bs {BATCH} prompt {PROMPT} gen {GEN} max_len {MAX_LEN}: "
              f"{tps:.1f} tok/s (mean of 3); {smi}", flush=True)
        prefill_tps = measure_prefill(params, cfg, BATCH, PROMPT, iters=3, seed=SEED)
        print(f"  measure_prefill bs {BATCH} prompt {PROMPT}: {prefill_tps:.1f} tok/s "
              f"= {BATCH * PROMPT / prefill_tps:.3f} s per prefill (mean of 3); {smi}",
              flush=True)
        t0 = phase("measure", t0)

        busy = profile_main_path(params, cfg, ids, first)
        del ids, logits
        torch.cuda.empty_cache()
        t0 = phase("profile", t0)

        small_launches, fused_launches, small = small_batch_phase(params, cfg, smi)
        torch.cuda.empty_cache()
        t0 = phase("small", t0)

        dense_launches, paged_launches, split_launches, served = serve_phase(params, cfg, smi)
        torch.cuda.empty_cache()
        t0 = phase("serve", t0)

        full_launches, full = full_phase(params, cfg, smi)
        del params
        torch.cuda.empty_cache()
        t0 = phase("full", t0)

    train_launches, train = train_phase(smi)
    torch.cuda.empty_cache()
    t0 = phase("train", t0)

    for k in kernels:
        # each kernel's count from its own path: serving at bs 64 for the
        # forward and split decode kernels, the fused route's run at bs 8
        # for the fused pair, serving at bs 8 (the default route) for the
        # whole-model kernel, training for the backward ones, the serving
        # engine's dense, paged and split-route runs for its four, the
        # full-attention baseline's serving run for the flash kernel
        k["launches"] = (train_launches if k["name"].startswith("prefill_bwd")
                         else full_launches if k["name"] == "flash_attention"
                         else fused_launches if k["name"] in FUSED_KERNELS
                         else small_launches if k["name"] == "decode_step_mega"
                         else paged_launches if k["name"] == "decode_attend_fused_paged"
                         else split_launches if k["name"] == "paged_gather"
                         else dense_launches if k["name"].endswith("_ragged")
                         else launches)[k["name"]]
    print(json.dumps({"main": {
        "prefill_s": prefill_s, "decode_tok_s": BATCH * GEN / decode_s,
        "measure_decode_tok_s": tps, "measure_prefill_tok_s": prefill_tps, "peak_bytes": peak,
        "logits_max_abs_err": err, "decode_device_busy": busy, "small": small,
        "serve": served, "full": full, **train,
        "train_launches": train_launches, "phases_s": dict(PHASES)}}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)   # the card's name and power limit, as nvidia-smi gives them
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main()
