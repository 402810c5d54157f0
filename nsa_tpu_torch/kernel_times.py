"""Device times of the decode kernels at their cells, launch by launch.

    python -m nsa_tpu_torch.kernel_times [--json PATH]

Times the per-layer and whole-model decode kernels (rows 6-10 and 12 of
``PERF.md``'s kernel table) on the trained reference weights
(``ckpt_export/sparse_mlp_seq4096.npz``, layer 0 for the per-layer ones),
seeded activations and full-length caches: the fused pair (rows 6-7) and
the whole-model kernel (row 12) at bs 8, the engine's ragged select-emit,
ragged attend and paged attend (rows 8-10) at 16 slots of 4096 rows at
mixed positions.  For each it prints the event-timed median (L2 flushed
before each call), the device time of every launch the call makes with the
gaps between them (``torch.profiler``, one profile a call, medians over
the calls), the host time of the call, and a SHA-256 of the outputs and
the caches it writes, so that two trees run on one card compare bit for
bit.  The script uses only the wrappers' public signatures, so a copy of
it runs in an older checkout of the port too: run it there and here in one
chip call, in turns, to compare two versions of a kernel.  Needs the card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import time

import torch

MAX_LEN, DECODE_T, SLOTS, SMALL_B, PAGE = 4096, 3999, 16, 8, 64
SEED = 0


def launch_breakdown(fn, flush, iters: int = 5) -> dict:
    """One ``torch.profiler`` profile per call of ``fn`` (L2 flushed and the
    card idle before each): the device ms of each launch in order, the gaps
    between them, their sum and the span from the first start to the last
    end, medians over ``iters`` calls (a profile with no device event is
    taken again, at most 3 x ``iters`` profiles in all); with the
    event-timed median and the host ms of the call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def med(xs):
        xs = sorted(xs)
        return xs[len(xs) // 2]

    runs = []
    for _ in range(3 * iters):      # a profile now and then records no device event: retried
        flush.zero_()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ev = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
        if ev:
            runs.append([(e.name, e.time_range.start, e.time_range.end) for e in ev])
        if len(runs) == iters:
            break
    if not runs:
        raise RuntimeError("torch.profiler recorded no device event for the call")
    n = min(len(r) for r in runs)
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
            "event_ms": event_ms(fn, 30, flush), "host_ms": med(host)}


def event_ms(fn, iters, flush) -> float:
    """Median ms between CUDA events around fn(), L2 flushed before each."""
    pairs = []
    for _ in range(iters):
        flush.zero_()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    ts = sorted(s.elapsed_time(e) for s, e in pairs)
    return ts[len(ts) // 2]


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

    out = {}
    for b in (SMALL_B, SLOTS):
        q, ckv, ring, kv_new = randn(b, kvh, g, d), randn(b, kvh, Wc, 2 * d), \
            randn(b, kvh, Bc, 2 * d), randn(b, kvh, 1, 2 * d)
        rq, kv, kv_row, x = randn(b, kvh, g, d), randn(b, kvh, MAX_LEN, 2 * d), \
            randn(b, kvh, 1, 2 * d), randn(b, 1, dim)
        gates = torch.sigmoid(randn(b, kvh, g, 3).float()).to(torch.bfloat16)
        if b == SMALL_B:                       # rows 6-7 at one position
            for tt, name in ((DECODE_T, "decode_select_emit emitting"),
                             (DECODE_T - 1, "decode_select_emit")):
                def sel(st, tt=tt, q=q, kv_new=kv_new):
                    return (*nsa_decode_fused.decode_select_emit(
                        q, *st, kv_new, *weights, tt, tt // stride, **skw), *st)
                out[name] = (clones(ckv, ring), sel)
            c_p, info_p = nsa_decode.decode_select_plain(q, ckv, fp["mem_kv"], DECODE_T,
                                                         DECODE_T // stride, **skw,
                                                         weights_dtype=torch.float32)
            args = (kv_row, info_p.reshape(b, -1), c_p, gates, x, fp["w_out"], DECODE_T, ff)

            def att(st, rq=rq, args=args):
                return nsa_decode_fused.decode_attend_fused(rq, *st, *args, **akw), *st
            out["decode_attend_fused"] = (clones(kv), att)
            continue
        tv = ragged_positions(gen, b, device)
        num_cb = tv // stride

        def rsel(st, q=q, kv_new=kv_new, tv=tv, num_cb=num_cb):
            return (*nsa_decode_ragged.decode_select_emit_ragged(
                q, *st, kv_new, *weights, tv, num_cb, **skw), *st)
        out["decode_select_emit_ragged"] = (clones(ckv, ring), rsel)
        c_p, info_p = nsa_decode.decode_select_plain(q, ckv, fp["mem_kv"], tv, num_cb, **skw,
                                                     weights_dtype=torch.float32)
        args = (kv_row, info_p.reshape(b, -1), c_p, gates, x, fp["w_out"], tv, ff)

        def ratt(st, rq=rq, args=args):
            return nsa_decode_ragged.decode_attend_fused_ragged(rq, *st, *args, **akw), *st
        out["decode_attend_fused_ragged"] = (clones(kv), ratt)
        n_pg = MAX_LEN // PAGE
        table = torch.randperm(b * n_pg, generator=gen, device=device).reshape(b, n_pg).int()
        pool = randn(b * n_pg + 1, kvh, PAGE, 2 * d)
        pool[table.reshape(-1).long()] = kv.reshape(b, kvh, n_pg, PAGE, 2 * d) \
            .transpose(1, 2).reshape(-1, kvh, PAGE, 2 * d)

        def patt(st, rq=rq, table=table, args=args):
            return nsa_decode_ragged.decode_attend_fused_paged(rq, st[0], table, *args,
                                                               **akw), *st
        out["decode_attend_fused_paged"] = (clones(pool), patt)

    mp = fuse_decode_params(params, cfg)["mega"]
    b = SMALL_B
    caches = (randn(L, b, kvh, MAX_LEN, 2 * d), randn(L, b, kvh, Wc, 2 * d),
              randn(L, b, kvh, Bc, 2 * d))
    token = torch.randint(0, cfg.vocab_size, (b,), generator=gen, device=device)
    for tt, name in ((DECODE_T, "decode_step_mega emitting"), (DECODE_T - 1, "decode_step_mega")):
        def mega(st, tt=tt):
            lg, tok, *_ = transformer_decode_step_mega(mp, cfg, token, *st, tt, greedy=True)
            return (lg, tok, *st)
        out[name] = (clones(*caches), mega)
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
        flush = torch.empty(256 << 20, dtype=torch.int8, device="cuda")
        res = {"root": root, "device": torch.cuda.get_device_name(0),
               "build_s": lib.build_seconds, "kernels": {}}
        for name, (setup, run) in cases(params, cfg).items():
            bits = digest(*run(setup()))          # also the warm-up
            state = setup()
            r = launch_breakdown(lambda: run(state), flush, args.iters)
            r["sha256"] = bits
            res["kernels"][name] = r
            print(f"{name}: event {r['event_ms']:.4f} ms, device {r['device_ms']:.4f} ms over "
                  f"{len(r['launches'])} launches, span {r['span_ms']:.4f} ms, host "
                  f"{r['host_ms']:.4f} ms; " + ", ".join(
                      f"{x['name'][:40]} {x['ms']:.4f}" for x in r["launches"])
                  + f"; gaps {[round(x, 4) for x in r['gaps_ms']]}; bits {bits}", flush=True)
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(res, fh, indent=1)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
