"""Device times of the decode kernels at their cells, launch by launch.

    python -m nsa_tpu_torch.kernel_times [--json PATH]

Times the decode kernels (rows 2, 3, 6-12 of ``PERF.md``'s kernel table)
on the trained reference weights (``ckpt_export/sparse_mlp_seq4096.npz``,
layer 0 for the per-layer ones), seeded activations and full-length
caches: the fused pair (rows 6-7; row 6 on an emitting step and on the
step before it) and the whole-model kernel (row 12) at bs 8, the fused
pair again at bs 1, the engine's ragged select-emit, ragged attend and
paged attend (rows 8-10) at 16 slots of 4096 rows at mixed positions, the
split pair (rows 2-3) at bs 64 and the block gather (row 11) at 16 and 64
slots.
For each it prints the event-timed median (L2 flushed before each call by
zeroing a 256 MB buffer: the call pays the write-back of the dirty lines it
evicts; see ``Flush``),
the device time of every launch the call makes with the gaps between them
(``torch.profiler``, one profile a call, medians over the calls), the host
time of the call, and a SHA-256 of the outputs and the caches it writes,
so that two trees run on one card compare bit for bit.  Beside them, for
each kernel launch of every case, the grid, block, registers per thread
and shared memory that the profiler's trace records; for rows 2 and 3
their grid, blocks that fit an SM, shared memory and ptxas registers and
spills (``split_geometry``, where the port has ``nsa_decode.split_plan``);
the one-launch
attend kernels' time by phase (their ``phase_ns`` marks, median of 5
launches, where the wrapper takes them); the whole-model kernel's time by
phase and by layer (median of 5 launches, an emission step and the step
before it); and greedy decode tok/s at bs 8 and bs 1 of the whole-model
kernel (``mega_tok_s``) and of the fused route (``fused_tok_s``).
Rows 2, 3 and 11 are timed again under the clean-cold flush
(``Flush(clean=True)``), and row 11 has a probe beside it at 16 and 64
slots, each case under both flushes: the kernel, advanced indexing (the
library call), a device-to-device ``cudaMemcpyAsync`` of the same bytes,
an empty kernel (the launch floor), the kernel on blocks of one 16-byte
row (its grid and id load with next to no data), and at 16 slots both
kernels on ids just copied (in L2, as the engine's selection leaves them).
The script uses only the wrappers' public signatures, so a copy of it runs
in an older checkout of the port too: run it there and here in one chip
call, in turns, to compare two versions of a kernel (rows 2, 3, 6, 7 and
12 take their position as a device tensor here, made before the timed
calls, and as an int in a tree whose kernels take it as a launch
argument: ``position``).  Needs the card.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import os
import tempfile
import time

import torch

MAX_LEN, DECODE_T, SLOTS, SMALL_B, SPLIT_B, PAGE = 4096, 3999, 16, 8, 64, 64
SEED = 0


class Flush:
    """The L2 flush before each timed call, through 256 MB buffers (five
    times the card's 50 MB of L2).  The zeroing flush (``clean=False``)
    zeroes one: L2 is left full of dirty lines, so the timed call pays a
    write-back for every line it evicts.  The clean-cold flush
    (``clean=True``) zeroes it and then reads a second one into one scalar:
    L2 is left full of clean lines that the call never touched."""

    def __init__(self, clean: bool = False):
        self.name = "clean-cold" if clean else "zeroing"
        self.dirty = torch.empty(256 << 20, dtype=torch.int8, device="cuda")
        self.clean = torch.zeros(256 << 20, dtype=torch.int8, device="cuda") if clean else None

    def __call__(self) -> None:
        self.dirty.zero_()
        if self.clean is not None:
            self.clean.sum(dtype=torch.int64)


# host idle seconds inside a profile's window before the call: the profiler
# can lose the device records of its window's first milliseconds (a late
# profile in a long process lost every record of a 0.5 ms call)
PROFILE_PAD_S = 0.05


def launch_breakdown(fn, flush, iters: int = 5) -> dict:
    """One ``torch.profiler`` profile per call of ``fn`` (L2 flushed and the
    card idle before each, ``PROFILE_PAD_S`` of it inside the window): the
    device ms of each launch in order, the gaps between them, their sum and
    the span from the first start to the last end, medians over ``iters``
    calls: only profiles that recorded as many of the call's launches as
    the longest count, and profiles are taken
    until ``iters`` of those are in hand, at most 3 x ``iters`` in all
    (``profiles``: how many the medians used); with the event-timed median
    and the host ms of the call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def med(xs):
        xs = sorted(xs)
        return xs[len(xs) // 2]

    runs = []
    for _ in range(3 * iters):      # a profile now and then misses device events: retried
        flush()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            fn()
            torch.cuda.synchronize()
        ev = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
        if ev:
            runs.append([(e.name, e.time_range.start, e.time_range.end) for e in ev])
            n = max(len(r) for r in runs)
            if sum(len(r) == n for r in runs) == iters:
                break
    if not runs:
        raise RuntimeError("torch.profiler recorded no device event for the call")
    runs = [r for r in runs if len(r) == n]
    names = [nm for nm, _, _ in runs[0][:n]]
    launch = [med([(r[i][2] - r[i][1]) / 1e3 for r in runs]) for i in range(n)]
    gaps = [med([(r[i + 1][1] - r[i][2]) / 1e3 for r in runs]) for i in range(n - 1)]
    host = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return {"launches": [{"name": nm[:60], "ms": ms} for nm, ms in zip(names, launch)],
            "gaps_ms": gaps, "device_ms": med([sum((e - s) / 1e3 for _, s, e in r[:n])
                                               for r in runs]),
            "span_ms": med([(r[n - 1][2] - r[0][1]) / 1e3 for r in runs]),
            "event_ms": event_ms(fn, 30, flush), "host_ms": med(host), "profiles": len(runs)}


def event_ms(fn, iters, flush) -> float:
    """Median ms between CUDA events around fn(), L2 flushed before each."""
    pairs = []
    for _ in range(iters):
        flush()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    ts = sorted(s.elapsed_time(e) for s, e in pairs)
    return ts[len(ts) // 2]


# the cases timed under both flushes: rows 2, 3 and 11 and row 11's probe
CLEAN_TOO = ("decode_select", "decode_attend", "paged_gather", "paged_gather (ids in L2)",
             "paged_gather 16-byte blocks", "paged_gather 16-byte blocks (ids in L2)",
             "advanced indexing", "memcpy DtoD", "empty kernel")
LAUNCH_KEYS = ("grid", "block", "registers per thread", "shared memory", "blocks per SM")


def launch_args(fn) -> list:
    """Each kernel that ``fn()`` launches, in order, with the launch
    arguments the profiler's trace records for it (``LAUNCH_KEYS``; shared
    memory is static + dynamic bytes a block)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    kernels = sorted((e for e in events if e.get("cat") == "kernel"), key=lambda e: e["ts"])
    return [{"name": e["name"][:60], **{k: e.get("args", {}).get(k) for k in LAUNCH_KEYS}}
            for e in kernels]


def ptxas_usage(log, kernel, *also):
    """(registers, spill store bytes, spill load bytes) that ptxas reports
    for the first entry function whose name holds ``kernel`` and each of
    ``also``."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and kernel in line \
                and all(a in line for a in also):
            regs = spill = None
            for nxt in lines[i + 1:i + 6]:
                if "Compiling entry function" in nxt:
                    break
                if "spill stores" in nxt:
                    words = nxt.replace(",", "").split()
                    spill = (int(words[words.index("spill") - 2]), int(words[-4]))
                if "Used" in nxt and "registers" in nxt:
                    words = nxt.replace(",", "").split()
                    regs = int(words[words.index("registers") - 1])
            return regs, spill
    return None, None


def split_geometry(log: str, device="cuda") -> dict:
    """Rows 2 and 3's launch geometry at the split cell: each kernel's grid,
    blocks that fit an SM, shared memory a block (``nsa_decode.split_plan``)
    and the registers and spills ptxas reported when the library was built
    (``log``); empty where the port has no ``split_plan``."""
    from .config import reference_model_config
    from .ops.cuda import nsa_decode
    from .ops.nsa import _ckv_width

    if not hasattr(nsa_decode, "split_plan"):
        return {}
    cfg = reference_model_config()
    nsa = cfg.nsa
    kvh, g, d = cfg.kv_heads, cfg.num_grouped_queries, cfg.dim_head
    stride, Bs = nsa.compress_block_sliding_stride, nsa.selection_block_size
    Wc = _ckv_width(MAX_LEN, stride, nsa.num_compress_per_fine)
    q = torch.empty((SPLIT_B, kvh, g, d), dtype=torch.bfloat16, device=device)
    ckv = torch.empty((1, kvh, Wc, 2 * d), dtype=torch.bfloat16, device=device)
    mem = torch.empty((2, kvh, nsa.num_compressed_mem_kv, d), dtype=torch.bfloat16, device=device)
    plan = nsa_decode.split_plan(q, ckv, mem, stride=stride, sel_block=Bs,
                                 num_sel=nsa.num_selected_blocks,
                                 n_slide=-(-nsa.sliding_window_size // Bs) + 1)
    out = {}
    for name, kern in (("decode_select", f"select_kernelILi{g}E"),
                       ("decode_attend", f"attend_kernelILi{g}E")):
        short = name.split("_")[1]
        regs, spill = ptxas_usage(log, kern, "nsa_decode_cu")
        out[name] = {"grid": plan["grid"], "blocks_per_sm": plan[f"{short}_blocks_per_sm"],
                     "smem_bytes": plan[f"{short}_smem_bytes"], "smem_optin": plan["smem_optin"],
                     "registers": regs, "spill_bytes": spill}
    return out


ATTEND_PHASES = ("attention", "w_out + residual", "norm + ff w1", "ff w2")


def attend_phase_us(fn, flush, iters: int = 5):
    """A one-launch attend kernel's time by phase: ``fn(marks)`` launches it
    with ``phase_ns=marks`` (or returns None where the wrapper takes no
    ``phase_ns``: then so does this); block 0's global timer at the start
    and after each grid sync, as microseconds per phase, the median of
    ``iters`` launches, L2 flushed before each.  The last phase ends where
    the block holding ff w2's first tile ends its share."""
    runs = []
    for _ in range(iters):
        marks = torch.zeros(len(ATTEND_PHASES) + 1, dtype=torch.int64, device="cuda")
        flush()
        if fn(marks) is None:
            return None
        torch.cuda.synchronize()
        runs.append(((marks[1:] - marks[:-1]).double() / 1e3).tolist())
    return {name: sorted(r[i] for r in runs)[iters // 2] for i, name in enumerate(ATTEND_PHASES)}


def takes_phase_ns(fn) -> bool:
    return "phase_ns" in inspect.signature(fn).parameters


def mega_phase_table(params, cfg, iters: int = 5, device="cuda") -> dict:
    """The whole-model kernel's time by phase and by layer at bs 8 with
    full-length seeded caches, at an emission step (DECODE_T) and the step
    before it: block 0's global-timer marks after each grid sync
    (``phase_ns``), microseconds, the median of ``iters`` launches, L2 not
    flushed (a step follows a step)."""
    from .models.transformer import fuse_decode_params, transformer_decode_step_mega
    from .ops.cuda import nsa_decode_mega
    from .ops.nsa import _ckv_width

    nsa = cfg.nsa
    L, kvh, d, b = cfg.depth, cfg.kv_heads, cfg.dim_head, SMALL_B
    Wc = _ckv_width(MAX_LEN, nsa.compress_block_sliding_stride, nsa.num_compress_per_fine)
    gen = torch.Generator(device=device).manual_seed(SEED)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)

    mp = fuse_decode_params(params, cfg)["mega"]
    caches = (randn(L, b, kvh, MAX_LEN, 2 * d), randn(L, b, kvh, Wc, 2 * d),
              randn(L, b, kvh, nsa.compress_block_size, 2 * d))
    token = torch.randint(0, cfg.vocab_size, (b,), generator=gen, device=device)
    names = getattr(nsa_decode_mega, "PHASE_NAMES",
                    ("norm+qkvg", "select+emission", "attend+w_out", "residual+ff1", "ff2"))
    out = {}
    for t in (DECODE_T, DECODE_T - 1):
        runs = []
        for _ in range(iters):
            marks = torch.zeros(nsa_decode_mega.phase_marks(L, 1), dtype=torch.int64,
                                device=device)
            transformer_decode_step_mega(mp, cfg, token, *caches, t, greedy=True, phase_ns=marks)
            torch.cuda.synchronize()
            runs.append(((marks[1:] - marks[:-1]).double() / 1e3).cpu())
        us = torch.stack(runs).median(0).values
        per_layer = us[:5 * L].reshape(L, 5)
        out[t] = {"phases": list(names), "us_by_layer": per_layer.tolist(),
                  "us_mean": per_layer.mean(0).tolist(), "lm_head_us": us[5 * L].item(),
                  "span_us": us.sum().item()}
        print(f"decode_step_mega bs {b} t={t} us by phase ({', '.join(names)}), layer by layer: "
              + "; ".join(f"L{l} " + " ".join(f"{v:.2f}" for v in row)
                          for l, row in enumerate(per_layer.tolist()))
              + f"; mean {[round(v, 2) for v in out[t]['us_mean']]}; lm head "
              f"{out[t]['lm_head_us']:.2f}; span {out[t]['span_us']:.2f}", flush=True)
    return out


def mega_tok_s(params, cfg, b: int, iters: int = 5, device="cuda") -> float:
    """Greedy decode tok/s of the whole-model kernel at bs ``b`` on the
    cell's cache (seeded full-length caches; the 100 positions from the
    cell's prompt length 3900 on), 25 tokens a launch as ``measure_decode``
    takes them: b x 100 over the median of ``iters`` timed runs (CUDA
    events), after a warm-up run."""
    from .models.transformer import fuse_decode_params, transformer_decode_step_mega
    from .ops.nsa import _ckv_width

    nsa = cfg.nsa
    L, kvh, d = cfg.depth, cfg.kv_heads, cfg.dim_head
    Wc = _ckv_width(MAX_LEN, nsa.compress_block_sliding_stride, nsa.num_compress_per_fine)
    gen = torch.Generator(device=device).manual_seed(SEED)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)

    mp = fuse_decode_params(params, cfg)["mega"]
    caches = (randn(L, b, kvh, MAX_LEN, 2 * d), randn(L, b, kvh, Wc, 2 * d),
              randn(L, b, kvh, nsa.compress_block_size, 2 * d))
    token = torch.randint(0, cfg.vocab_size, (b,), generator=gen, device=device)
    start, gen_len, per = DECODE_T + 1 - 100, 100, 25

    def run():
        tok = token
        for t in range(start, start + gen_len, per):
            _, toks, *_ = transformer_decode_step_mega(mp, cfg, tok, *caches, t, greedy=True,
                                                       steps=per)
            tok = toks[:, -1]

    run()
    ms = []
    for _ in range(iters):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        run()
        e.record()
        torch.cuda.synchronize()
        ms.append(s.elapsed_time(e))
    return b * gen_len / (sorted(ms)[iters // 2] / 1e3)


def fused_tok_s(params, cfg, b: int, iters: int = 3, device="cuda") -> float:
    """Greedy decode tok/s of the fused route (rows 6-7 a layer) at bs ``b``
    on the cell's cache (seeded full-length caches; the 100 positions from
    the cell's prompt length 3900 on), one token a step through
    ``greedy_decode``: b x 100 over the median of ``iters`` timed runs (CUDA
    events), after a warm-up run.  The route is host-bound, so this reads
    the host's share too."""
    from .models.transformer import ModelCache, fuse_decode_params, greedy_decode
    from .ops.nsa import NSADecodeCache, _ckv_width

    nsa = cfg.nsa
    L, kvh, d = cfg.depth, cfg.kv_heads, cfg.dim_head
    Wc = _ckv_width(MAX_LEN, nsa.compress_block_sliding_stride, nsa.num_compress_per_fine)
    gen = torch.Generator(device=device).manual_seed(SEED)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)

    packed = fuse_decode_params(params, cfg)
    layers = tuple(NSADecodeCache(randn(b, kvh, MAX_LEN, 2 * d), randn(b, kvh, Wc, 2 * d),
                                  randn(b, kvh, nsa.compress_block_size, 2 * d))
                   for _ in range(L))
    token = torch.randint(0, cfg.vocab_size, (b,), generator=gen, device=device)
    start, gen_len = DECODE_T + 1 - 100, 100

    def run():
        greedy_decode(packed, cfg, token, ModelCache(layers=layers, seq_len=start), gen_len,
                      route="fused")

    run()
    ms = []
    for _ in range(iters):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        run()
        e.record()
        torch.cuda.synchronize()
        ms.append(s.elapsed_time(e))
    return b * gen_len / (sorted(ms)[iters // 2] / 1e3)


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for x in tensors:
        h.update(x.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def ragged_positions(gen, b, device):
    """t = 0; 5 (no emission), 7 and 15 (emitting) before the first full
    compression window; 4095, 4094, 3999 and 3998; the rest seeded uniform in
    [16, 4096)."""
    fixed = torch.tensor([0, 5, 7, 15, 4095, 4094, DECODE_T, DECODE_T - 1], device=device)
    rest = torch.randint(16, MAX_LEN, (b - len(fixed),), generator=gen, device=device)
    return torch.cat([fixed, rest]).int()


def position(t: int, device):
    """The position ``t`` as the one-position decode wrappers (rows 2, 3, 6,
    7, 12) take it in this tree: a 0-d int32 tensor on the card, made once
    outside the timed calls, where their kernels read the position from
    device memory; the int itself in an older tree, whose kernels take it
    as a launch argument."""
    from .ops.cuda import runtime

    if hasattr(runtime, "device_position"):
        return torch.full((), t, dtype=torch.int32, device=device)
    return t


def cases(params, cfg, device="cuda"):
    """{row name: (setup, run)} at the cells: ``setup()`` copies the caches
    the kernel writes, ``run(state)`` launches it on them and returns every
    tensor whose bits it leaves (the outputs, then the caches).  A timed
    ``run`` reuses one state: the kernels rewrite the same rows each time."""
    from .ops.cuda import nsa_decode, nsa_decode_fused, nsa_decode_ragged
    from .ops.nsa import _ckv_width, fuse_decode_layer
    from .models.transformer import fuse_decode_params, transformer_decode_step_mega

    nsa = cfg.nsa
    kvh, g, d, dim, L = cfg.kv_heads, cfg.num_grouped_queries, cfg.dim_head, cfg.dim, cfg.depth
    stride, Bs, Bc, window = nsa.compress_block_sliding_stride, nsa.selection_block_size, \
        nsa.compress_block_size, nsa.sliding_window_size
    num_sel = nsa.num_selected_blocks
    n_slide = -(-window // Bs) + 1
    scale = d ** -0.5
    Wc = _ckv_width(MAX_LEN, stride, nsa.num_compress_per_fine)
    layer = fuse_decode_layer(params["layers"][0], torch.bfloat16)
    fp, ffp = layer["attn"]["decode_fused"], layer["ff"]["decode_fused"]
    weights = (fp["mem_kv"], fp["pos_kv"], fp["w1k"], fp["b1k"], fp["w1v"], fp["b1v"], fp["w2"],
               fp["b2"])
    ff = tuple(ffp[k] for k in ("norm_scale", "w1", "b1", "w2", "b2"))
    skw = dict(max_blocks=MAX_LEN // Bs, stride=stride, sel_block=Bs, num_sel=num_sel,
               n_slide=n_slide, scale=scale)
    akw = dict(sel_block=Bs, window=window, num_sel=num_sel, n_slide=n_slide, scale=scale,
               eps=cfg.norm_eps)
    gen = torch.Generator(device=device).manual_seed(SEED)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)

    def clones(*ts):
        return lambda: tuple(x.clone() for x in ts)

    def inputs(b):
        q, ckv, ring, kv_new = randn(b, kvh, g, d), randn(b, kvh, Wc, 2 * d), \
            randn(b, kvh, Bc, 2 * d), randn(b, kvh, 1, 2 * d)
        rq, kv, kv_row, x = randn(b, kvh, g, d), randn(b, kvh, MAX_LEN, 2 * d), \
            randn(b, kvh, 1, 2 * d), randn(b, 1, dim)
        gates = torch.sigmoid(randn(b, kvh, g, 3).float()).to(torch.bfloat16)
        return q, ckv, ring, kv_new, rq, kv, kv_row, x, gates

    def fused_pair(b, suffix):
        """Rows 6-7 at one position: row 6 on an emitting step and the step
        before it, row 7 at the emitting step (``run`` takes ``phase_ns``
        where the wrapper does, else returns None when asked for it)."""
        q, ckv, ring, kv_new, rq, kv, kv_row, x, gates = inputs(b)
        for tt, name in ((DECODE_T, "decode_select_emit emitting"),
                         (DECODE_T - 1, "decode_select_emit")):
            def sel(st, pt=position(tt, device), ncb=tt // stride, q=q, kv_new=kv_new):
                return (*nsa_decode_fused.decode_select_emit(
                    q, *st, kv_new, *weights, pt, ncb, **skw), *st)
            out[name + suffix] = (clones(ckv, ring), sel)
        c_p, info_p = nsa_decode.decode_select_plain(q, ckv, fp["mem_kv"], DECODE_T,
                                                     DECODE_T // stride, **skw,
                                                     weights_dtype=torch.float32)
        args = (kv_row, info_p.reshape(b, -1), c_p, gates, x, fp["w_out"],
                position(DECODE_T, device), ff)

        def att(st, rq=rq, args=args, **kw):
            if kw and not takes_phase_ns(nsa_decode_fused.decode_attend_fused):
                return None
            return nsa_decode_fused.decode_attend_fused(rq, *st, *args, **akw, **kw), *st
        out["decode_attend_fused" + suffix] = (clones(kv), att)

    out = {}
    for b in (SMALL_B, SLOTS):
        if b == SMALL_B:
            fused_pair(b, "")
            continue
        q, ckv, ring, kv_new, rq, kv, kv_row, x, gates = inputs(b)
        tv = ragged_positions(gen, b, device)
        num_cb = tv // stride

        def rsel(st, q=q, kv_new=kv_new, tv=tv, num_cb=num_cb):
            return (*nsa_decode_ragged.decode_select_emit_ragged(
                q, *st, kv_new, *weights, tv, num_cb, **skw), *st)
        out["decode_select_emit_ragged"] = (clones(ckv, ring), rsel)
        c_p, info_p = nsa_decode.decode_select_plain(q, ckv, fp["mem_kv"], tv, num_cb, **skw,
                                                     weights_dtype=torch.float32)
        args = (kv_row, info_p.reshape(b, -1), c_p, gates, x, fp["w_out"], tv, ff)

        def ratt(st, rq=rq, args=args, **kw):
            return nsa_decode_ragged.decode_attend_fused_ragged(rq, *st, *args, **akw,
                                                                **kw), *st
        out["decode_attend_fused_ragged"] = (clones(kv), ratt)
        n_pg = MAX_LEN // PAGE
        table = torch.randperm(b * n_pg, generator=gen, device=device).reshape(b, n_pg).int()
        pool = randn(b * n_pg + 1, kvh, PAGE, 2 * d)
        pool[table.reshape(-1).long()] = kv.reshape(b, kvh, n_pg, PAGE, 2 * d) \
            .transpose(1, 2).reshape(-1, kvh, PAGE, 2 * d)

        def patt(st, rq=rq, table=table, args=args, **kw):
            return nsa_decode_ragged.decode_attend_fused_paged(rq, st[0], table, *args,
                                                               **akw, **kw), *st
        out["decode_attend_fused_paged"] = (clones(pool), patt)

    # rows 2 and 3 (the split route, bs 64) and 11 (the ragged split route's
    # block gather, at 16 slots and at 64), whose code this script's A/B
    # also holds
    from .ops.cuda import paged_gather

    b = SPLIT_B
    q, ckv, rq = randn(b, kvh, g, d), randn(b, kvh, Wc, 2 * d), randn(b, kvh, g, d)
    kv = randn(b, kvh, MAX_LEN, 2 * d)
    gates = torch.sigmoid(randn(b, kvh, g, 3).float()).to(torch.bfloat16)
    c_p, info_p = nsa_decode.decode_select_plain(q, ckv, fp["mem_kv"], DECODE_T,
                                                 DECODE_T // stride, **skw)
    pt = position(DECODE_T, device)
    out["decode_select"] = (lambda: (), lambda st, q=q, ckv=ckv: nsa_decode.decode_select(
        q, ckv, fp["mem_kv"], pt, DECODE_T // stride, **skw))
    tkw = {k: v for k, v in akw.items() if k != "eps"}
    out["decode_attend"] = (lambda: (), lambda st, rq=rq, kv=kv, info=info_p, c=c_p, gt=gates: (
        nsa_decode.decode_attend(rq, kv, info, c, gt, pt, **tkw),))
    # beside row 11: the library call (advanced indexing), a device-to-device
    # cudaMemcpyAsync of the same bytes, the kernel on ids already in L2, an
    # empty kernel (one block: the launch floor), and the kernel on 16-byte
    # blocks (one row of 16 bytes), its own grid with the same ids but next
    # to no data: its launch and ramp and its dependent id load
    for slots, suffix in ((SLOTS, ""), (SPLIT_B, f" bs {SPLIT_B}")):
        idx = info_p[..., :num_sel + n_slide][:slots].contiguous()
        kvs = kv[:slots]
        out["paged_gather" + suffix] = (lambda: (), lambda st, kvs=kvs, idx=idx: (
            paged_gather.paged_gather(kvs, idx, Bs),))
        blocks = kvs.view(slots, kvh, MAX_LEN // Bs, Bs, 2 * d)
        bi = torch.arange(slots, device=device)[:, None, None]
        hi = torch.arange(kvh, device=device)[None, :, None]
        out["advanced indexing" + suffix] = (lambda: (), lambda st, blocks=blocks, bi=bi, hi=hi,
                                             il=idx.long(): (blocks[bi, hi, il],))
        n = idx.numel() * Bs * 2 * d
        src, dst = kvs.reshape(-1)[:n], torch.empty(n, dtype=kv.dtype, device=device)
        out["memcpy DtoD" + suffix] = (lambda: (), lambda st, src=src, dst=dst: (dst.copy_(src),))
        tiny = randn(slots, kvh, MAX_LEN, 8)
        out["paged_gather 16-byte blocks" + suffix] = (lambda: (), lambda st, tiny=tiny, idx=idx: (
            paged_gather.paged_gather(tiny, idx, 1),))
        if slots == SLOTS:
            # the ids just written, as the engine's selection leaves them: a
            # copy of them first (its own launch in the breakdown)
            out["paged_gather (ids in L2)"] = (lambda: (), lambda st, kvs=kvs, idx=idx: (
                paged_gather.paged_gather(kvs, idx.clone(), Bs),))
            out["paged_gather 16-byte blocks (ids in L2)"] = (
                lambda: (), lambda st, tiny=tiny, idx=idx: (
                    paged_gather.paged_gather(tiny, idx.clone(), 1),))
    out["empty kernel"] = (lambda: (), lambda st: torch.cuda._sleep(0) or ())

    mp = fuse_decode_params(params, cfg)["mega"]
    b = SMALL_B
    caches = (randn(L, b, kvh, MAX_LEN, 2 * d), randn(L, b, kvh, Wc, 2 * d),
              randn(L, b, kvh, Bc, 2 * d))
    token = torch.randint(0, cfg.vocab_size, (b,), generator=gen, device=device)
    for tt, name in ((DECODE_T, "decode_step_mega emitting"), (DECODE_T - 1, "decode_step_mega")):
        def mega(st, pt=position(tt, device)):
            lg, tok, *_ = transformer_decode_step_mega(mp, cfg, token, *st, pt, greedy=True)
            return (lg, tok, *st)
        out[name] = (clones(*caches), mega)
    fused_pair(1, " bs 1")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", default=None, help="also write the results here")
    ap.add_argument("--iters", type=int, default=5, help="profiled calls per kernel")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times needs an NVIDIA GPU")
    from .ops.cuda import runtime
    from .utils.checkpoint import load_params_npz, model_config_from_meta

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    lib = runtime.library()
    with torch.inference_mode():
        params, meta = load_params_npz(os.path.join(root, "ckpt_export", "sparse_mlp_seq4096.npz"),
                                       device="cuda", dtype=torch.bfloat16)
        cfg = model_config_from_meta(meta).replace(dtype="bfloat16")
        flush, clean = Flush(), Flush(clean=True)
        res = {"root": root, "device": torch.cuda.get_device_name(0),
               "build_s": lib.build_seconds, "kernels": {}}
        geometry = split_geometry(lib.log)
        for name, (setup, run) in cases(params, cfg).items():
            bits = digest(*run(setup()))          # also the warm-up
            state = setup()
            r = launch_breakdown(lambda: run(state), flush, args.iters)
            r["sha256"] = bits
            r["flush"] = flush.name
            if name.split(" bs ")[0] in CLEAN_TOO:
                r["clean"] = launch_breakdown(lambda: run(state), clean, args.iters)
            r["launch_args"] = launch_args(lambda: run(state))
            if name.startswith("decode_attend_fused"):
                r["phase_us"] = attend_phase_us(lambda m: run(state, phase_ns=m), flush)
            res["kernels"][name] = r
            print(f"{name}: event {r['event_ms']:.4f} ms, device {r['device_ms']:.4f} ms over "
                  f"{len(r['launches'])} launches, span {r['span_ms']:.4f} ms, host "
                  f"{r['host_ms']:.4f} ms, {r['profiles']} profiles; " + ", ".join(
                      f"{x['name'][:40]} {x['ms']:.4f}" for x in r["launches"])
                  + f"; gaps {[round(x, 4) for x in r['gaps_ms']]}; bits {bits}", flush=True)
            if "clean" in r:
                c = r["clean"]
                print(f"  {clean.name} flush: event {c['event_ms']:.4f} ms, device "
                      f"{c['device_ms']:.4f} ms, span {c['span_ms']:.4f} ms, "
                      f"{c['profiles']} profiles; "
                      + ", ".join(f"{x['name'][:40]} {x['ms']:.4f}" for x in c["launches"]),
                      flush=True)
            for x in r["launch_args"]:
                print("  launch " + ", ".join(f"{k} {x[k]}" for k in ("name", *LAUNCH_KEYS)),
                      flush=True)
            if name in geometry:
                r["geometry"] = geometry[name]
                print("  geometry " + ", ".join(f"{k} {v}" for k, v in geometry[name].items()),
                      flush=True)
            if r.get("phase_us"):
                print(f"  us per phase (the card's global timer, median of 5): "
                      f"{ {k: round(v, 2) for k, v in r['phase_us'].items()} }", flush=True)
        res["mega_phases"] = mega_phase_table(params, cfg)
        res["mega_tok_s"] = {b: mega_tok_s(params, cfg, b) for b in (SMALL_B, 1)}
        print(f"decode_step_mega greedy tok/s, 25 tokens a launch: "
              f"{ {b: round(v, 1) for b, v in res['mega_tok_s'].items()} }", flush=True)
        res["fused_tok_s"] = {b: fused_tok_s(params, cfg, b) for b in (SMALL_B, 1)}
        print(f"fused route greedy tok/s, 1 token a step: "
              f"{ {b: round(v, 1) for b, v in res['fused_tok_s'].items()} }", flush=True)
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(res, fh, indent=1)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
