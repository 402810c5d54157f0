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
8. small   - the small-batch decode path (b <= 8, the fused route) on the
             trained model at bs 8 and bs 1: prefill of 3900 seeded tokens,
             100 greedy steps with the 4096-row cache, launch counts read
             around exactly that run (the fused pair depth x 100 each, no
             split launch); the first step's logits held against the plain
             fused route and, at bs 8, the split kernel route; decode tok/s of
             the fused and the split route at bs 8 in turns (fused, split,
             split, fused); ``torch.profiler`` over 5 steps.
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

The kernels phase also holds the two backward kernels against their plain
versions at the training cell's shapes (bs 16, n 4096), and the two fused
decode kernels at the small-batch cell's (bs 8, layer 0's trained weights,
seeded activations and caches; the select kernel at an emission step and
at the step before it).

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

import torch  # noqa: E402

import nsa_tpu_torch  # noqa: E402,F401  (fails at once outside a checkout)
from nsa_tpu_torch.config import DataConfig, TrainConfig  # noqa: E402
from nsa_tpu_torch.eval.efficiency import (  # noqa: E402
    clone_cache,
    measure_decode,
    measure_prefill,
    measure_train,
    seeded_ids,
)
from nsa_tpu_torch.models.transformer import (  # noqa: E402
    fuse_decode_params,
    greedy_decode,
    init_transformer,
    transformer_decode_step,
    transformer_loss,
    transformer_prefill,
)
from nsa_tpu_torch.ops.cuda import (  # noqa: E402
    nsa_decode,
    nsa_decode_fused,
    nsa_prefill,
    runtime,
)
from nsa_tpu_torch.ops.nsa import _ckv_width, fuse_decode_layer  # noqa: E402
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
# about twice each phase's longest time over two H100 runs (47 s build, 79 s
# train on the slower host), at least 10 s for the phases of a few seconds,
# whose time is host noise; 400 s in all
BUDGET_S = {"device": 10, "build": 100, "weights": 10, "kernels": 10, "main": 10,
            "measure": 20, "profile": 50, "small": 30, "train": 160}
BATCH, PROMPT, GEN, MAX_LEN = 64, 3900, 100, 4096
SMALL_BATCHES = (8, 1)       # the small-batch cell: the fused decode route
FUSED_KERNELS = ("decode_select_emit", "decode_attend_fused")
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
TOL_FUSED = 2.0 ** -6

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


def profile_decode(params, cfg, token, cache, label, steps=5):
    """torch.profiler over ``steps`` decode steps after a warm step on a
    copy of the cache; returns the device's busy share of their wall time
    and the device records per step."""
    from torch.profiler import ProfilerActivity, profile

    transformer_decode_step(params, cfg, token, clone_cache(cache))   # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, cache = transformer_decode_step(params, cfg, token, cache)
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


def decode_run(params, cfg, first, cache, route=None):
    """``GEN`` greedy decode steps from ``first``; returns (tokens, device
    seconds between CUDA events around the steps)."""
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    tokens = greedy_decode(params, cfg, first, cache, GEN, route=route)
    e.record()
    torch.cuda.synchronize()
    return tokens, s.elapsed_time(e) / 1e3


def small_batch_phase(params, cfg, smi):
    """The small-batch decode path at each of SMALL_BATCHES: prefill,
    then GEN greedy steps on the default (fused) route, launch counts read
    around exactly that run; the first step against the plain fused route
    and, at bs 8, the split kernel route; tok/s of both routes in turns at
    bs 8; a profile of 5 steps.  Returns the launch counts of the first
    batch size's run and the metrics."""
    packed = fuse_decode_params(params, cfg)
    fused = (nsa_decode_fused.decode_select_emit, nsa_decode_fused.decode_attend_fused)
    counted = (nsa_prefill.prefill_fwd, nsa_decode.decode_select, nsa_decode.decode_attend,
               *fused)
    metrics, first_launches = {}, None
    for b in SMALL_BATCHES:
        ids = seeded_ids(b, PROMPT, cfg.vocab_size, SEED + b, DEVICE)
        torch.cuda.synchronize()
        for fn in counted:
            fn.launches = 0
        logits, cache = transformer_prefill(params, cfg, ids, MAX_LEN)
        first = logits[:, -1].argmax(-1)
        start = clone_cache(cache)
        tokens, decode_s = decode_run(packed, cfg, first, cache)
        launches = {fn.__name__: fn.launches for fn in counted}
        first_launches = first_launches or launches
        print(f"  bs {b} launches {launches}", flush=True)
        want = {"prefill_fwd": cfg.depth, "decode_select": 0, "decode_attend": 0,
                "decode_select_emit": cfg.depth * GEN, "decode_attend_fused": cfg.depth * GEN}
        check(launches == want, f"bs {b} small-batch launches {launches}, expected {want}")
        check(tuple(tokens.shape) == (b, GEN) and int(tokens.min()) >= 0
              and int(tokens.max()) < cfg.vocab_size, f"bs {b} generated tokens malformed")

        step0, _ = transformer_decode_step(packed, cfg, first, clone_cache(start))
        others = [("plain fused route", dict(use_kernels=False))]
        if b == SMALL_BATCHES[0]:
            others.append(("split kernel route", dict(route="split")))
        m = {"decode_tok_s": b * GEN / decode_s}
        for label, kw in others:
            ref, _ = transformer_decode_step(packed, cfg, first, clone_cache(start), **kw)
            err, scale_l = max_err(step0, ref), ref.abs().max().item()
            agree = (step0.argmax(-1) == ref.argmax(-1)).float().mean().item()
            print(f"  bs {b} first decode step logits: fused kernels vs {label} max|err| "
                  f"{err:.4f} (tol {TOL_LOGITS_REL} x max|logit| {scale_l:.2f}); argmax agrees "
                  f"on {agree * 100:.1f}% of rows", flush=True)
            check(bool(torch.isfinite(step0).all()) and err <= TOL_LOGITS_REL * max(scale_l, 1.0),
                  f"bs {b} fused-route decode logits disagree with the {label}")
            m[f"logits_max_abs_err_vs_{label.split()[0]}"] = err
        print(f"  bs {b} decode {GEN} steps: {decode_s:.3f}s = {b * GEN / decode_s:.1f} tok/s "
              f"(fused route); {smi}", flush=True)

        if b == SMALL_BATCHES[0]:
            # the two routes in turns in this call: fused, split, split, fused
            tps, toks = {"fused": [], "split": []}, {}
            for route in ("fused", "split", "split", "fused"):
                toks[route], sec = decode_run(packed, cfg, first, clone_cache(start), route)
                tps[route].append(b * GEN / sec)
            agree = (toks["fused"] == toks["split"]).float().mean().item()
            print(f"  bs {b} decode tok/s, fused {tps['fused']} split {tps['split']} (in turns "
                  f"f, s, s, f); means fused {sum(tps['fused']) / 2:.1f} split "
                  f"{sum(tps['split']) / 2:.1f}; greedy tokens of the two routes agree on "
                  f"{agree * 100:.1f}%; {smi}", flush=True)
            m.update({"ab_fused_tok_s": tps["fused"], "ab_split_tok_s": tps["split"],
                      "greedy_tokens_agree_split": agree})
        busy, records = profile_decode(packed, cfg, tokens[:, -1], cache, f"bs {b} fused route")
        m.update({"decode_device_busy": busy, "device_records_per_step": records})
        metrics[f"bs{b}"] = m
        del cache, start
        torch.cuda.empty_cache()
    return first_launches, metrics


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
            "decode_select": 0, "decode_attend": 0,       # generation runs at bs 1: fused
            "decode_select_emit": cfg.depth * gen * tc.generate_length,
            "decode_attend_fused": cfg.depth * gen * tc.generate_length}


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
               nsa_decode_fused.decode_select_emit, nsa_decode_fused.decode_attend_fused)
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
                   *kernel_decode_fused(gen, flush, cfg, params, SMALL_BATCHES[0])]
        del flush
        torch.cuda.empty_cache()
        t0 = phase("kernels", t0)

        ids = seeded_ids(BATCH, PROMPT, cfg.vocab_size, SEED, "cuda")
        counted = (nsa_prefill.prefill_fwd, nsa_decode.decode_select, nsa_decode.decode_attend,
                   nsa_decode_fused.decode_select_emit, nsa_decode_fused.decode_attend_fused)
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
                "decode_attend_fused": 0}       # bs 64 takes the split route
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

        small_launches, small = small_batch_phase(params, cfg, smi)
        del params
        torch.cuda.empty_cache()
        t0 = phase("small", t0)

    train_launches, train = train_phase(smi)
    torch.cuda.empty_cache()
    t0 = phase("train", t0)

    for k in kernels:
        # each kernel's count from its own path: serving at bs 64 for the
        # forward and split decode kernels, serving at bs 8 for the fused
        # ones, training for the backward ones
        k["launches"] = (train_launches if k["name"].startswith("prefill_bwd")
                         else small_launches if k["name"] in FUSED_KERNELS
                         else launches)[k["name"]]
    print(json.dumps({"main": {
        "prefill_s": prefill_s, "decode_tok_s": BATCH * GEN / decode_s,
        "measure_decode_tok_s": tps, "measure_prefill_tok_s": prefill_tps, "peak_bytes": peak,
        "logits_max_abs_err": err, "decode_device_busy": busy, "small": small, **train,
        "train_launches": train_launches, "phases_s": dict(PHASES)}}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)   # the card's name and power limit, as nvidia-smi gives them
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main()
