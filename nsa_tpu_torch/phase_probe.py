"""Time by phase of the split route's decode kernels (rows 2 and 3).

    python -m nsa_tpu_torch.phase_probe [--src CSRC_DIR] [--json PATH]

Copies the kernel sources of ``--src`` (default: this package's
``csrc/``) into a temporary directory, inserts a mark at each phase
boundary of ``select_body`` and ``attend_body`` (``decode_common.cuh``):
a block barrier, then thread 0 records the SM's cycle counter and the
card's global timer for its block; builds ``nsa_decode.cu`` alone from
the marked copy, and launches ``nsa_decode_select`` and
``nsa_decode_attend`` at the serving cell (bs 64, 4 KV heads, G 2,
position 3999 of a 4096-row cache, seeded inputs, L2 flushed before each
launch as ``kernel_times`` flushes it).  Prints, for each kernel, each
phase's cycles and microseconds (the median over the grid's blocks of the
median over the launches), a
block's whole span, the kernel's span from the first block's start to the
last block's end, the event time of the marked and of the unmarked kernel
(the marks' own cost), and the event time of the unmarked select and
attend launched back to back, as the decode step launches them.  The phase
boundaries are found by anchor lines: the ``// phase: NAME`` comments of
the bodies, or, in a tree whose bodies have none, the lines of the earlier
bodies that staged the k halves, then the v halves (``STAGED_SELECT``,
``STAGED_ATTEND``), so one copy of this script probes both.  Needs the card
and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

MAX_MARKS = 16
MAX_BLOCKS = 4096
MARK = "NSA_PROBE_MARK({k});\n"

# The earlier bodies, which staged the k halves, then the v halves: (phase
# that ends at the anchor, anchor text); a mark is inserted before each
# anchor.  The first entry marks the start.
STAGED_SELECT = [
    ("start", "  // logits of the live rows, tile by tile; then of the mem slots\n"),
    ("k staging", "    for (int r = tid; r < nr; r += blockDim.x) {\n      float s[G];\n"),
    ("logits", "  for (int o = tid; o < G * M; o += blockDim.x) {\n"),
    ("mem slots", "  // importance: mean over the group (mem slots excluded), pooled over the\n"),
    ("importance", "  // pad(-1e3) -> softmax -> strip, without materializing the pad slot\n"),
    ("score softmax", "  // compressed softmax over the live rows and the mem slots\n"),
    ("compressed softmax",
     "  // c_out = sum_j p_j v_j / den over the v halves, tile by tile; thread\n"),
    ("v staging", "    for (int o = tid; o < parts * outs; o += blockDim.x) {\n"
                  "      const int part = o / outs, g = (o % outs) / kD, e = o % kD;\n"
                  "      const float* p = sim"),
    ("c_out", "  // iterative top-k by warp 0: num_sel passes of (max, lowest index)\n"),
    ("top-k", "\n// Where row r of item bh = (batch row, KV head) of the packed kv cache\n"),
]
STAGED_ATTEND = [
    ("start", "  for (int i = tid; i < G * kD; i += blockDim.x)\n    qs[i] = __bfloat162float(rq["),
    ("rq + info row + masks",
     "  // stage the rows either mask keeps (k and v), all in flight at once\n"),
    ("staging", "  for (int col = tid; col < J; col += blockDim.x) {\n"
                "    const int ok = okm[col];\n"),
    ("dots", "  float inv_f[G], inv_s[G];\n"),
    ("reductions", "  for (int o = tid; o < parts * outs; o += blockDim.x) {\n"
                   "    const int part = o / outs, g = (o % outs) / kD, e = o % kD;\n"
                   "    float af"),
    ("P.V", "  float* comb = qs;\n"),
    ("combine", "  return comb;\n"),
]

PRELUDE = """
// ---- phase probe (nsa_tpu_torch/phase_probe.py) ----
__device__ unsigned long long nsa_probe_clk[%(n)d];
__device__ unsigned long long nsa_probe_ns[%(n)d];
__device__ int nsa_probe_base;
#define NSA_PROBE_MARK(k)                                                          \\
  do {                                                                             \\
    __syncthreads();                                                               \\
    if (threadIdx.x == 0) {                                                        \\
      unsigned long long ns_;                                                      \\
      asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(ns_));                     \\
      const int i_ = nsa_probe_base + blockIdx.x * %(m)d + (k);                    \\
      nsa_probe_clk[i_] = clock64();                                               \\
      nsa_probe_ns[i_] = ns_;                                                      \\
    }                                                                              \\
  } while (0)
""" % {"n": 2 * MAX_BLOCKS * MAX_MARKS, "m": MAX_MARKS}

READER = """
extern "C" int nsa_probe_read(void* clk, void* ns, int n) {
  cudaError_t e = cudaMemcpyFromSymbol(clk, nsa_probe_clk, (size_t)n * 8);
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(ns, nsa_probe_ns, (size_t)n * 8);
  return (int)e;
}
extern "C" int nsa_probe_set_base(int base) {
  return (int)cudaMemcpyToSymbol(nsa_probe_base, &base, sizeof(int));
}
"""


def body_span(text: str, name: str) -> tuple:
    """Start and end offsets of the body of the device function ``name``."""
    m = re.search(r"__device__ [^;{]*\b%s\(" % name, text)
    if m is None:
        raise ValueError(f"no {name} in decode_common.cuh")
    start = text.index("{", m.end())
    depth = 0
    for i in range(start, len(text)):
        depth += {"{": 1, "}": -1}.get(text[i], 0)
        if depth == 0:
            return start, i
    raise ValueError(f"unbalanced braces in {name}")


def marked_phases(text: str, name: str) -> list:
    """The phase names of ``// phase: NAME`` comments in ``name``'s body,
    in order (an empty list when it has none)."""
    s, e = body_span(text, name)
    return re.findall(r"^\s*// phase: (.+)$", text[s:e], flags=re.M)


def instrument(text: str) -> tuple:
    """decode_common.cuh with marks inserted; (text, {body: phase names}).
    A mark goes before each ``// phase:`` comment (and one before the
    body's closing brace) where the bodies have them, else before each
    anchor of the earlier layout."""
    phases = {}
    for name, table in (("select_body", STAGED_SELECT), ("attend_body", STAGED_ATTEND)):
        own = marked_phases(text, name)
        if own:
            s, e = body_span(text, name)
            body, k = text[s:e], 0
            out = []
            for line in body.splitlines(keepends=True):
                if re.match(r"^\s*// phase: ", line):
                    out.append(MARK.format(k=k))
                    k += 1
                out.append(line)
            if name == "attend_body":     # before the return
                joined = "".join(out)
                i = joined.rindex("  return ")
                joined = joined[:i] + MARK.format(k=k) + joined[i:]
            else:
                joined = "".join(out) + MARK.format(k=k)
            text = text[:s] + joined + text[e:]
            phases[name] = own
            continue
        for k, (_, anchor) in enumerate(table):
            if text.count(anchor) != 1:
                raise ValueError(f"{name}: anchor not found once: {anchor!r}")
            if anchor.startswith("\n// Where row r"):        # after the body's closing brace
                s, e = body_span(text, name)
                text = text[:e] + MARK.format(k=k) + text[e:]
            else:
                text = text.replace(anchor, MARK.format(k=k) + anchor, 1)
        phases[name] = [p for p, _ in table[1:]]
    return text.replace('#include "common.cuh"\n', '#include "common.cuh"\n' + PRELUDE, 1), phases


def build(src: Path, out_dir: Path) -> tuple:
    """The marked copy of ``src`` built into ``out_dir``; (library, phases, log)."""
    from .ops.cuda import runtime

    work = out_dir / "csrc"
    shutil.copytree(src, work)
    text, phases = instrument((work / "decode_common.cuh").read_text())
    (work / "decode_common.cuh").write_text(text)
    cu = work / "nsa_decode.cu"
    cu.write_text(cu.read_text() + READER)
    so = out_dir / "probe.so"
    proc = subprocess.run([runtime._nvcc(), *runtime.NVCC_FLAGS, "-shared", "-o", str(so),
                           str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the marked copy:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    for fn in ("nsa_decode_select", "nsa_decode_attend"):
        getattr(lib, fn).argtypes = runtime.SIGNATURES[fn]
        getattr(lib, fn).restype = ctypes.c_int
    lib.nsa_probe_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    lib.nsa_probe_set_base.argtypes = [ctypes.c_int]
    return lib, phases, proc.stdout + proc.stderr


def serving_inputs(seed: int = 0, device="cuda"):
    """The split pair's operands at the serving cell, as ``kernel_times``
    draws them for rows 2 and 3."""
    from .config import reference_model_config
    from .ops.cuda import nsa_decode
    from .ops.nsa import _ckv_width

    cfg = reference_model_config().replace(dtype="bfloat16")
    nsa = cfg.nsa
    b, kvh, g, d, max_len, t = 64, cfg.kv_heads, cfg.num_grouped_queries, cfg.dim_head, 4096, 3999
    stride, Bs = nsa.compress_block_sliding_stride, nsa.selection_block_size
    n_slide = -(-nsa.sliding_window_size // Bs) + 1
    Wc = _ckv_width(max_len, stride, nsa.num_compress_per_fine)
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)

    q, ckv, mem_kv = randn(b, kvh, g, d), randn(b, kvh, Wc, 2 * d), \
        randn(2, kvh, nsa.num_compressed_mem_kv, d)
    rq, kv = randn(b, kvh, g, d), randn(b, kvh, max_len, 2 * d)
    gates = torch.sigmoid(randn(b, kvh, g, 3).float()).to(torch.bfloat16)
    skw = dict(max_blocks=max_len // Bs, stride=stride, sel_block=Bs,
               num_sel=nsa.num_selected_blocks, n_slide=n_slide, scale=d ** -0.5)
    c_out, info = nsa_decode.decode_select_plain(q, ckv, mem_kv, t, t // stride, **skw)
    return dict(q=q, ckv=ckv, mem_kv=mem_kv, rq=rq, kv=kv, gates=gates, c_out=c_out, info=info,
                t=t, num_cb=t // stride, skw=skw, window=nsa.sliding_window_size)


def launchers(lib, x):
    """(select launch, attend launch) through ``lib``'s C entries."""
    from .ops.cuda import nsa_decode

    q, ckv, mem_kv, rq, kv = x["q"], x["ckv"], x["mem_kv"], x["rq"], x["kv"]
    b, kvh, g, d = q.shape
    k = x["skw"]
    c_out, info = torch.empty_like(q), torch.empty_like(x["info"])
    out = torch.empty_like(rq)
    pos = torch.full((), x["t"], dtype=torch.int32, device=q.device)   # read on the device
    stream = torch.cuda.current_stream().cuda_stream

    def select():
        rc = lib.nsa_decode_select(q.data_ptr(), ckv.data_ptr(), mem_kv.data_ptr(),
                                   c_out.data_ptr(), info.data_ptr(), pos.data_ptr(), b, kvh, g,
                                   ckv.shape[2], mem_kv.shape[2], k["stride"],
                                   k["sel_block"], k["num_sel"], k["n_slide"], k["max_blocks"],
                                   nsa_decode.INFO_WIDTH, k["scale"], stream)
        if rc:
            raise RuntimeError(f"nsa_decode_select failed with cudaError_t {rc}")

    def attend():
        rc = lib.nsa_decode_attend(rq.data_ptr(), kv.data_ptr(), x["info"].data_ptr(),
                                   x["c_out"].data_ptr(), x["gates"].data_ptr(), out.data_ptr(),
                                   pos.data_ptr(), b, kvh, g, kv.shape[2], k["sel_block"],
                                   x["window"],
                                   k["num_sel"], k["n_slide"], nsa_decode.INFO_WIDTH, k["scale"],
                                   stream)
        if rc:
            raise RuntimeError(f"nsa_decode_attend failed with cudaError_t {rc}")

    return select, attend


def probe(lib, fn, phases, blocks, flush, iters=9, slot=0) -> dict:
    """Each phase's cycles and microseconds for ``fn()``'s blocks."""
    from .kernel_times import event_ms

    n = len(phases) + 1
    base = slot * MAX_BLOCKS * MAX_MARKS
    if lib.nsa_probe_set_base(base):
        raise RuntimeError("nsa_probe_set_base failed")
    runs = []
    for _ in range(iters):
        flush()
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
        size = base + MAX_BLOCKS * MAX_MARKS
        clk = (ctypes.c_ulonglong * size)()
        ns = (ctypes.c_ulonglong * size)()
        if lib.nsa_probe_read(ctypes.addressof(clk), ctypes.addressof(ns), size):
            raise RuntimeError("nsa_probe_read failed")
        c = torch.tensor(clk[base:size], dtype=torch.float64).reshape(MAX_BLOCKS, MAX_MARKS)
        t = torch.tensor(ns[base:size], dtype=torch.float64).reshape(MAX_BLOCKS, MAX_MARKS)
        runs.append((c[:blocks, :n], t[:blocks, :n]))
    cyc = torch.stack([c[:, 1:] - c[:, :-1] for c, _ in runs])        # [iters, blocks, phases]
    ghz = torch.stack([(c[:, -1] - c[:, 0]) / (t[:, -1] - t[:, 0]).clamp(min=1)
                       for c, t in runs]).median().item()
    per_block = cyc.median(0).values                                   # [blocks, phases]
    med = per_block.median(0).values
    span = torch.tensor([(t[:, -1].max() - t[:, 0].min()).item() / 1e3 for _, t in runs])
    return {"phases": phases, "cycles": med.tolist(), "us": (med / ghz / 1e3).tolist(),
            "block_us": (per_block.sum(1).median() / ghz / 1e3).item(),
            "kernel_span_us": span.median().item(), "ghz": ghz,
            "event_ms_marked": event_ms(fn, 30, flush)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parent / "csrc"),
                    help="the csrc directory whose bodies are probed")
    ap.add_argument("--json", default=None, help="also write the results here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("phase_probe needs an NVIDIA GPU")
    from .kernel_times import Flush, event_ms
    from .ops.cuda import runtime

    res = {"src": args.src, "device": torch.cuda.get_device_name(0)}
    with tempfile.TemporaryDirectory() as tmp:
        lib, phases, log = build(Path(args.src), Path(tmp))
        res["ptxas"] = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        plain = ctypes.CDLL(str(build_unmarked(Path(args.src), Path(tmp))))
        for fn in ("nsa_decode_select", "nsa_decode_attend"):
            getattr(plain, fn).argtypes = runtime.SIGNATURES[fn]
            getattr(plain, fn).restype = ctypes.c_int
        x = serving_inputs()
        flush = Flush()
        blocks = x["q"].shape[0] * x["q"].shape[1]
        sel, att = launchers(lib, x)
        psel, patt = launchers(plain, x)
        psel(), patt()
        for i, (name, fn, unmarked, body) in enumerate((
                ("decode_select", sel, psel, "select_body"),
                ("decode_attend", att, patt, "attend_body"))):
            fn()
            r = probe(lib, fn, phases[body], blocks, flush, slot=i)
            r["event_ms_unmarked"] = event_ms(unmarked, 30, flush)
            res[name] = r
            print(f"{name} bs 64 by phase (cycles, us; median over {blocks} blocks of the "
                  f"median of 9 launches at {r['ghz']:.3f} GHz): "
                  + "; ".join(f"{p} {c:.0f} {u:.2f}" for p, c, u in
                              zip(r["phases"], r["cycles"], r["us"]))
                  + f"; a block {r['block_us']:.2f} us, the kernel's span "
                  f"{r['kernel_span_us']:.2f} us; event ms marked {r['event_ms_marked']:.4f}, "
                  f"unmarked {r['event_ms_unmarked']:.4f}", flush=True)
        # the pair as the decode step launches it: attend right after select
        res["pair_event_ms"] = event_ms(lambda: (psel(), patt()), 30, flush)
        print(f"select then attend, unmarked: event ms {res['pair_event_ms']:.4f}", flush=True)
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(res, fh, indent=1)
    print(json.dumps(res))


def build_unmarked(src: Path, out_dir: Path) -> Path:
    """``nsa_decode.cu`` of ``src`` built as it is, beside the marked copy."""
    from .ops.cuda import runtime

    so = out_dir / "unmarked.so"
    proc = subprocess.run([runtime._nvcc(), *runtime.NVCC_FLAGS, "-shared", "-o", str(so),
                           str(src / "nsa_decode.cu")], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    return so


if __name__ == "__main__":
    main()
