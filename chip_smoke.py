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
             a seeded generator, with kernel, plain and bound times; the
             prefill forward twice: on seeded random selections and on the
             selections (and rq, rk, v) that layer 0 of the trained model's
             prefill of seeded ids makes, element by element
             (``fine_sliding_tolerance``) with a control that leaves each
             row's first selected block out, the union sizes per 16- and
             64-row tile, and ``flex_attention`` timed beside it.
5. main    - the port's main path through its entry points: prefill of
             64 x 3900 seeded tokens, then 100 greedy decode steps with the
             4096-row cache (one eager step, then ``greedy_decode``'s
             captured loop); launch counts read around exactly that run; the
             prefill's logits held against the plain path's, and the first
             decode step's logits against the plain versions'.
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
             requests/s, wall time, kv pool MiB, peak memory; how many
             ragged steps have an emitting slot and how many slots emit a
             step (counted in one more, untimed run of the dense pool); and
             a profile of 5 ragged steps at 16 slots with rows
             8-10's device time and their share of the step's.
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
12. eval   - the evaluation suite (``nsa_tpu_torch.eval``) on the trained
             sparse and full weights in bf16, in a temporary directory (the
             4,000,000-byte synthetic corpus, the CSVs): ``run_ppl_eval`` at
             seq 4096 on the first 65,536 validation bytes and the CS441 QA
             stand-in, launch counts read around it (row 1 or row 13 once a
             layer a batch, no decode kernel); three perplexity gates, each
             with a control that scores every label one byte late and must
             fail: the kernel path against the plain path on the same
             windows, ``compute_ppl_incremental`` (a 1-byte prefill, then
             4,095 teacher-forced steps, row 12 once a step for the sparse
             model) against ``compute_ppl`` on one window, and 2 windows
             against ``nsa_tpu``'s own float32 ``compute_ppl`` of the same
             bytes (a constant computed on a CPU); the incremental loop
             eager against captured on 513 bytes, equal; ``generate_samples``
             (128 greedy bytes at b = 1) with its tokens equal on a second
             call and the first step's logits against the plain path;
             ``run_efficiency_sweep`` over bs 1, 8, 64 x prompt 500, 3900 at
             gen 100 and the 4096-row cache, launch counts read around it
             (rows 1 / 13, 12, 2-3); the perplexity table and the sweep's
             CSV rows with the card's name and power limit.
13. graph  - the decode loops as captured CUDA graphs (``models/decode_graph.py``,
             the default on the card; the phases above already run them)
             against the same steps eager (``capture=False``), in turns
             (eager, captured, captured, eager): the serving cell on the
             sparse and the full model, bs 8 on the whole-model kernel
             (greedy at 1 and 25 tokens a launch, tempered at one with
             seeded noise), the 48-request engine on the dense and the paged
             pool; tokens and every cache tensor equal, launch counts equal
             in every turn (a replay adds one eager step's), the logits of a
             captured 3-step loop against eager (bit for bit, or within the
             2% gate with the argmax equal); tok/s, peak memory; one
             profiled run of replays for the split, full, whole-model and
             engine steps, whose device records of each kernel a replay
             must equal the step's launches and its wrapper's counter a
             replay, with the device's busy share beside the eager steps'.

The kernels phase holds the split route's two decode kernels (rows 2-3)
at the serving cell's shapes (bs 64, t = 3999, seeded inputs): c_out
within TOL_OUT and element by element under
``nsa_decode_ragged.select_tolerance``, with the plain c_out over all but
the first 64 live rows as a control that must fail it, the selected ids
equal but for ties; the attend output within TOL_OUT and under
``attend_tolerance``, with each row's first selected block left out as a
control that must fail it; second launches bit for bit; each kernel's
grid, blocks an SM, shared memory and ptxas registers and spills.  It
also holds the two backward kernels against their plain
versions at the training cell's shapes (bs 16, n 4096) on seeded random
selections and on those layer 0 of the trained weights' forward of a seeded
micro-batch makes: dq, dk, dv element by element
(``prefill_bwd_tolerance``) with a dropped-block control, d_gates and the
deltas, each kernel bit-equal on a second launch, rows per inverted list
and union blocks per 16 rows, ptxas's registers and spills at G = 2, and
``flex_attention``'s backward (dq, dk, dv of both branches) timed beside
them; the train phase prints the same sizes for its random-init model's
selections and rows 4-5's share of the profiled micro-step.  It holds the two fused
decode kernels at the small-batch cell's (bs 8, layer 0's trained weights,
seeded activations and caches; the select kernel at an emission step and
at the step before it), the whole-model decode kernel there (bs 8, all
layers' trained weights, seeded tokens and full-length caches, an emission
step and the step before it; the plain version with one emission chunk
left out must fail the emitted-row gate; every layer's attention output
held element by element to ``attend_tolerance`` on the kernel's own inputs,
a control with each row's first selected block left out failing it; every
layer's selection held to the plain one on the kernel's own query, ids
equal but ties, a selection one rank short failing it, its c_out, emitted
row, queries and gates within TOL_FUSED; its launch plan, ptxas registers and time by phase and layer), and the serving
engine's four kernels at 16
slots of 4096 rows with layer 0's trained weights: the ragged select-emit
and attend kernels at seeded mixed positions (t = 0, emitting and
non-emitting rows before and after the first full compression window, t up
to 4095; the select-emit's second launch bit for bit, its dropped-chunk
control failing the emitted-row gate), and at one position against the
one-position pair; the paged
attend kernel under a seeded permutation page table of 64-row pages, bit
for bit the ragged one; the attend kernels' rounded attention output
element by element (``nsa_decode_ragged.attend_tolerance``) and their
output within TOL_FUSED, the plain version with each row's first selected
block left out failing both, a second launch bit for bit; rows 8-10 timed
as device time from the profiler launch by launch, with the event-timed
figure and the host time of a call beside it; the attend kernel's grid,
shared memory and ptxas registers; the block gather of the ragged split route
at the engine cell and at 64 rows, bit for bit its plain version and
advanced indexing on contiguous ids and on the strided view of the info
rows the route passes, a wrong-id control giving other bits, its launch
geometry and ptxas registers, its device time and advanced indexing's under
the zeroing and the clean-cold L2 flush (``kernel_times.Flush``); and the
flash attention kernel of the full-attention baseline at the serving cell's
shapes (q [64, 8, 3900, 64], k / v [64, 4, 3900, 64], causal), with
``torch.nn.functional.scaled_dot_product_attention`` timed beside it as its
library yardstick (the port never calls it).

Then one JSON line with the kernels, the card's name and power limit, and as
the last line ``{"ok": true, "device": {...}}``.  Any failure raises and
exits non-zero; nothing catches it.  Imports nothing of JAX or ``nsa_tpu``.
"""

import contextlib
import faulthandler
import inspect
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
    copy_cache,
    measure_decode,
    measure_prefill,
    measure_train,
    run_efficiency_sweep,
    seeded_ids,
)
from nsa_tpu_torch.eval.generate import (  # noqa: E402
    decode_bytes,
    generate_samples,
    greedy_continuation,
)
from nsa_tpu_torch.eval.perplexity import (  # noqa: E402
    compute_ppl,
    compute_ppl_incremental,
    ppl_windows,
    run_ppl_eval,
)
from nsa_tpu_torch.eval.visualize import ppl_markdown_table  # noqa: E402
from nsa_tpu_torch.models.transformer import (  # noqa: E402
    KVDecodeCache,
    cache_tensors,
    default_max_len,
    fuse_decode_params,
    greedy_decode,
    init_transformer,
    sample_decode,
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
from nsa_tpu_torch.models import decode_graph  # noqa: E402
from nsa_tpu_torch.ops import nsa as nsa_layer  # noqa: E402
from nsa_tpu_torch.ops.nsa import _ckv_width, fuse_decode_layer  # noqa: E402
from nsa_tpu_torch import bench as port_bench  # noqa: E402
from nsa_tpu_torch import kernel_times  # noqa: E402
from nsa_tpu_torch import serve  # noqa: E402
from nsa_tpu_torch.train import pretrain  # noqa: E402
from nsa_tpu_torch.train.data import load_byte_corpus, load_cs441_qa_bytes  # noqa: E402
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
# kernels, 12 s small phase, 79 s train on the slower host, 19 s serve, 63 s
# kernels with the plain flash attention at full size and flex_attention's
# compiles, forward and backward, 20.6 s full, 5.7 s main with its two plain
# prefills), at least 10 s for the phases of a few seconds, whose time is
# host noise; the graph phase's (eager and captured decode in turns, ~60 s
# predicted, mostly the eager engine runs) 150 s; the eval phase's 60 s
# (27.8 s alone on the H100); 845 s in all
BUDGET_S = {"device": 10, "build": 120, "weights": 10, "kernels": 130, "main": 15,
            "measure": 20, "profile": 50, "small": 30, "serve": 40, "full": 50,
            "eval": 60, "graph": 150, "train": 160}
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
# round the output; the kernels keep the weights in float32.  On outputs
# that are convex combinations of values |v| <= ~5 that is <= ~2 * 2^-9 * 5
# = 0.02.  The prefill forward (row 1) is held element by element instead
# (``nsa_prefill.fine_sliding_tolerance``): 2^-7 |plain| for the outputs'
# two bf16 roundings plus 2^-8 of the same branch's attention over |v| for
# the kernel's bf16 softmax weights in P.V, each term twice its source; a
# control with each row's first selected block left out must fail it.
TOL_OUT = 0.03
TOL_LSE = 1e-3               # float32 both ways, same bf16 inputs: sum order only
TIE = 1e-6                   # selection scores closer than this count as ties
# logits after 6 bf16 layers: each layer's attention output differs by about
# one bf16 rounding (2^-8 relative) between the paths; through the residual
# stream that stays within ~1% of the logits' scale.
TOL_LOGITS_REL = 0.02
# The backward kernels (rows 4 and 5) against their plain versions, same
# bf16 inputs: dq, dk, dv element by element (``nsa_prefill.
# prefill_bwd_tolerance``), 2^-7 |plain| for the outputs' two bf16 roundings
# plus 2^-8 of the same sum over absolute values for the kernels' bf16
# tensor-core operands (P in dV; dS as a bf16 pair in dQ and dK), each term
# twice its source, with a dropped-block control that must fail it;
# d_gates and the deltas stay float32 and differ by sum order and exp2
# (1e-4 of the max).
TOL_BWD_F32 = 1e-4
# One micro-batch, bf16 compute, relative L2 error per gradient tensor.
# Kernels vs the kernel forward with the plain backward (the two backward
# kernels alone): dq, dk, dv differ by about one bf16 ulp (2^-8 relative) per
# element (dv by up to as much again for P's bf16 rounding), carried back
# through the earlier layers: 0.05.  Kernels vs the
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
# the evaluation cell: the suite's perplexity at seq 4096 on the first 65,536
# bytes of the synthetic corpus's validation split (16 windows, 2 batches of
# 8 x 4,097) and the CS441 QA stand-in; greedy samples of the suite's length;
# the sweep over bs x prompt at the serving cell's gen and cache length
EVAL_SEQ, EVAL_ID_TOKENS, EVAL_GEN = 4096, 65_536, 128
EVAL_SWEEP_BATCHES, EVAL_SWEEP_PROMPTS = (1, 8, 64), (500, 3900)
EVAL_EAGER_BYTES = 513       # the incremental loop eager against captured
# nsa_tpu's own float32 compute_ppl of the first 2 x 4096 + 1 validation
# bytes of the 4,000,000-byte synthetic corpus, on the committed weights,
# computed once on a CPU (attn_impl "xla", batch_size 1: the two windows
# one at a time; rows are independent, so only the order of the sum moves):
#   _, val = nsa_tpu.train.data.load_byte_corpus(DataConfig(synthetic_bytes=4_000_000))
#   cfg = replace(model_config_from_json(<the export's meta model_config>),
#                 dtype="float32", attn_impl="xla")
#   params = import_params_npz("ckpt_export/<name>_seq4096.npz", <init_transformer shapes>)
#   nsa_tpu.eval.perplexity.compute_ppl(<params as float32>, cfg, val[:8193], 4096,
#                                       batch_size=1)
# -> (1.9425824999092995, 8192) sparse, (1.9812038092760385, 8192) full
JAX_PPL_TWO_WINDOWS = {"sparse_mlp": 1.9425824999092995, "full_attn": 1.9812038092760385}
# The perplexity gates, relative: bf16 rounding moves each byte's NLL by a
# small amount of either sign, and the mean over thousands of bytes moves far
# less.  On an H100 (700 W limit) the kernel path and the plain path differed by
# 3.4e-5 (sparse) and 7.8e-6 (full), the incremental path and the dense one
# by 1.7e-4 and 1.2e-4 (bf16 through the decode kernels against the prefill
# kernels), and the card and nsa_tpu's float32 figure by 8.9e-5 and 1.5e-4:
# each bound is about ten times the larger figure (the incremental one is
# JAX's own bound for its two float32 paths, tests/test_eval_suite.py).  A
# control that scores every label one byte late gives ~2e4 times the
# perplexity and must fail each.
TOL_PPL_PLAIN = 5e-4
TOL_PPL_INCREMENTAL = 2e-3
TOL_PPL_JAX = 2e-3
# every kernel the port has, counted around each path's run
ALL_KERNELS = (nsa_prefill.prefill_fwd, nsa_prefill.prefill_bwd_dq, nsa_prefill.prefill_bwd_dkv,
               nsa_decode.decode_select, nsa_decode.decode_attend,
               nsa_decode_fused.decode_select_emit, nsa_decode_fused.decode_attend_fused,
               nsa_decode_mega.decode_step_mega, nsa_decode_ragged.decode_select_emit_ragged,
               nsa_decode_ragged.decode_attend_fused_ragged,
               nsa_decode_ragged.decode_attend_fused_paged, paged_gather.paged_gather,
               flash.flash_attention)

# the device kernels of rows 8 and 9 (10 is row 9's kernel over the page
# pool), as the engine's ragged step launches them on the dense pool
RAGGED_STEP_KERNELS = {"row 8": ("emit_partial_ragged_kernel", "select_emit_ragged_kernel"),
                       "row 9": ("attend_persistent_kernel",)}

# the kernels the backward of the fine + sliding attention launches (rows 4
# and 5, and the dkv kernel's pre-pass and last pass)
BWD_KERNELS = ("bwd_dq_kernel", "bwd_dkv_kernel", "list_rows_kernel", "exclusive_scan_kernel",
               "list_sort_kernel", "plan_kernel", "items_kernel", "dkv_reduce_kernel")

PHASES = []


def phase(name, t0):
    dt = time.perf_counter() - t0
    PHASES.append((name, dt))
    print(f"phase {name} {dt:.3f}s (budget {BUDGET_S[name]}s)", flush=True)
    if dt > BUDGET_S[name]:
        raise RuntimeError(f"phase {name} took {dt:.1f}s, over its {BUDGET_S[name]}s budget")
    return time.perf_counter()


def device_t(t):
    """The position ``t`` as the decode kernels read it on the main path: one
    int32 on the card, made before the calls that are timed."""
    return torch.full((), t, dtype=torch.int32, device=DEVICE)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def timed_ms(fn, iters, flush):
    """Median event-timed ms of fn(), L2 flushed before each launch.  Every
    function timed here has run once before, for its comparison: that run is
    its warm-up."""
    return kernel_times.event_ms(fn, iters, flush)


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


def union_sizes(sel_idx, sel_mask, sel_block, rows):
    """Mean and largest number of distinct blocks over tiles of ``rows``
    query rows: the valid selections at or before each row's own block, and
    each row's own block (the union the prefill kernel streams; within 16
    rows at most 16 S + 1 blocks)."""
    b, kvh, n, S = sel_idx.shape
    nblk, tiles = -(-n // sel_block), -(-n // rows)
    pos = torch.arange(n, device=sel_idx.device)
    q_blk, tile = pos // sel_block, pos // rows
    idx = sel_idx.long()
    ok = sel_mask & (idx >= 0) & (idx <= q_blk[:, None])
    base = (torch.arange(b * kvh, device=sel_idx.device).reshape(b, kvh, 1, 1) * tiles
            + tile[:, None]) * nblk
    hit = torch.zeros(b * kvh * tiles * nblk, dtype=torch.bool, device=sel_idx.device)
    hit[(base + idx)[ok]] = True
    hit[(base[..., 0] + q_blk).flatten()] = True
    u = hit.reshape(b, kvh, tiles, nblk).sum(-1).float()
    return {"mean": u.mean().item(), "max": u.max().item()}


def flex_block_masks(sel_idx, sel_mask, sel_block, window, heads, block=128):
    """The fine and sliding branches' ``BlockMask``s for ``flex_attention``,
    built from the rows' block membership: each 128 x 128 block that holds a
    kept (row, key) is a partial block under the ``mask_mod``."""
    from torch.nn.attention.flex_attention import BlockMask

    b, kvh, n, _ = sel_idx.shape
    dev, G, nblk = sel_idx.device, heads // kvh, -(-n // sel_block)
    pos = torch.arange(n, device=dev)
    q_blk = pos // sel_block
    idx = sel_idx.long()
    ok = sel_mask & (idx >= 0) & (idx <= q_blk[:, None])
    member = torch.zeros((b, kvh, n, nblk), dtype=torch.bool, device=dev)
    member.scatter_(-1, torch.where(ok, idx, q_blk[:, None]), True)
    member.scatter_(-1, q_blk[:, None].expand(b, kvh, n, 1), True)

    def fine(bb, hh, qi, ki):
        return (ki <= qi) & member[bb, hh // G, qi, ki // sel_block]

    def band(bb, hh, qi, ki):
        return (ki <= qi) & (qi - ki <= window)

    nb, per = -(-n // block), block // sel_block
    padded = torch.zeros((b, kvh, nb * block, nb * per), dtype=torch.bool, device=dev)
    padded[:, :, :n, :nblk] = member
    qb = torch.arange(nb, device=dev)
    causal = qb[None, :] <= qb[:, None]                                   # [q block, kv block]
    fine_blocks = padded.reshape(b, kvh, nb, block, nb, per).any(5).any(3) & causal
    band_blocks = causal & (qb[None, :] >= (qb[:, None] * block - window) // block)

    def block_mask(any_blocks, mask_mod):
        return BlockMask.from_kv_blocks(
            any_blocks.sum(-1, dtype=torch.int32),
            torch.argsort(any_blocks.to(torch.int8), dim=-1, descending=True,
                          stable=True).to(torch.int32),
            BLOCK_SIZE=block, mask_mod=mask_mod, seq_lengths=(n, n))

    return (block_mask(fine_blocks.repeat_interleave(G, dim=1), fine),
            block_mask(band_blocks[None, None], band))


def flex_prefill(rq, rk, v, sel_idx, sel_mask, sel_block, window, scale):
    """Row 1's library yardstick: ``flex_attention`` under ``torch.compile``
    for each branch with its log-sum-exp, the fine branch through a
    selection-lookup ``mask_mod`` and the sliding one through a band; the
    block masks are built here, outside the timed call.  The port never
    calls it."""
    from torch.nn.attention.flex_attention import flex_attention

    fine_mask, band_mask = flex_block_masks(sel_idx, sel_mask, sel_block, window, rq.shape[1])
    attend = torch.compile(flex_attention)

    def run():
        fo, flse = attend(rq, rk, v, block_mask=fine_mask, scale=scale, enable_gqa=True,
                          return_lse=True)
        so, slse = attend(rq, rk, v, block_mask=band_mask, scale=scale, enable_gqa=True,
                          return_lse=True)
        return fo, so, flse, slse

    return run


def check_prefill(name, inputs, flush, cfg):
    """Row 1 on one set of inputs: both outputs against the plain version
    element by element (``fine_sliding_tolerance``), both log-sum-exps
    within TOL_LSE, and a control (the plain fine output with each row's
    first valid selected block left out, on 2 sequences) that must fail the
    rule; the union sizes per 16- and 64-row tile; kernel, plain, bound and
    flex_attention times."""
    nsa = cfg.nsa
    G, d = cfg.num_grouped_queries, cfg.dim_head
    Bs, window, scale = nsa.selection_block_size, nsa.sliding_window_size, d ** -0.5
    rq, rk, v, sel_idx, sel_mask = inputs
    args = (rq, rk, v, sel_idx, sel_mask, Bs, window, scale)

    got = nsa_prefill.prefill_fwd(*args)
    want = nsa_prefill.fine_sliding_plain(*args)
    tols = nsa_prefill.fine_sliding_tolerance(*args, want)
    torch.cuda.synchronize()
    ratios = [((x.float() - y.float()).abs() / t).max().item()
              for x, y, t in zip(got[:2], want[:2], tols)]
    lse = [max_err(x, y) for x, y in zip(got[2:], want[2:])]
    two = (rq[:2], rk[:2], v[:2], sel_idx[:2])
    wrong = nsa_prefill.fine_sliding_plain(
        *two, nsa_prefill.without_first_block(sel_idx[:2], sel_mask[:2], Bs), Bs, window,
        scale)[0]
    control = ((wrong.float() - want[0][:2].float()).abs() / tols[0][:2]).max().item()
    del tols, wrong
    unions = {f"u{r}": union_sizes(sel_idx, sel_mask, Bs, r) for r in (16, 64)}
    print(f"  {name}: max |err| / bound fine {ratios[0]:.4f} sliding {ratios[1]:.4f} (<= 1: "
          f"2^-7 |plain| + 2^-8 attention over |v|), lse max|err| {lse[0]:.2e} {lse[1]:.2e} "
          f"(tol {TOL_LSE}); each row's first selected block left out: {control:.2f} (must be "
          f"> 1); union blocks per 16 rows {unions['u16']}, per 64 rows {unions['u64']}",
          flush=True)
    check(control > 1.0, f"{name}: the prefill rule passes a kernel that leaves out a block")
    check(all(torch.isfinite(x.float()).all().item() for x in got)
          and max(ratios) <= 1.0, f"{name}: outputs disagree with the plain version")
    check(max(lse) <= TOL_LSE, f"{name}: log-sum-exps disagree with the plain version")

    flops = sum(needed_keys(sel_idx, sel_mask, cfg)) * G * 4 * d
    bms, by = bound_ms(nbytes(rq, rk, v, sel_idx, sel_mask, *got), flops)
    ms = timed_ms(lambda: nsa_prefill.prefill_fwd(*args), 10, flush)
    plain = timed_ms(lambda: nsa_prefill.fine_sliding_plain(*args), 2, flush)
    t0 = time.perf_counter()
    library = flex_prefill(*args)
    lib_err = max(max_err(x, y) for x, y in zip(library()[:2], want[:2]))
    setup = time.perf_counter() - t0
    lib = timed_ms(library, 10, flush)
    print(f"  {name} {ms:.4f} ms (bound {bms:.4f} ms by {by}: {ms / bms:.2f}x), plain "
          f"{plain:.3f} ms, flex_attention (both branches) {lib:.4f} ms, its outputs vs plain "
          f"max|err| {lib_err:.5f} (block masks and compile {setup:.1f}s)", flush=True)
    return {"name": name, "route": "cuda", "source": "nsa_tpu_torch/csrc/nsa_prefill.cu",
            "replaces": "nsa_tpu/ops/pallas/nsa_prefill.py:315",
            "max_abs_err": max(max_err(x, y) for x, y in zip(got[:2], want[:2])), "ms": ms,
            "plain_ms": plain, "bound_ms": bms, "bound_by": by, "library_ms": lib,
            "unions": unions}


def layer0_prefill_inputs(params, cfg, run):
    """Row 1's inputs as layer 0 of ``run(params, cfg)`` gives them: rq,
    rk, v and the selections, recorded around the kernel's wrapper."""
    recorded, real = [], nsa_prefill.prefill_fwd

    def recording(*a, **k):
        if not recorded:
            recorded.append([x.clone() for x in a[:5]])
        return real(*a, **k)

    recording.launches = 0
    nsa_prefill.prefill_fwd = recording
    try:
        run(params, cfg)
    finally:
        nsa_prefill.prefill_fwd = real
    return recorded[0]


def serving_prefill(params, cfg):
    """The serving cell's prefill of seeded prompt ids."""
    ids = seeded_ids(BATCH, PROMPT, cfg.vocab_size, SEED, DEVICE)
    transformer_prefill(params, cfg, ids, MAX_LEN)


def training_forward(params, cfg):
    """The forward of one seeded micro-batch at the training cell."""
    transformer_forward(params, cfg, seeded_ids(MICRO, SEQ, cfg.vocab_size, SEED, DEVICE))


def kernel_prefill(gen, flush, cfg, params):
    """Row 1 at the serving cell on seeded random selections (close to the
    worst case for the union) and on the trained weights' own (the user's
    case)."""
    random = check_prefill("prefill_fwd", prefill_inputs(gen, cfg, BATCH, PROMPT), flush, cfg)
    trained = check_prefill("prefill_fwd_trained",
                            layer0_prefill_inputs(params, cfg, serving_prefill), flush, cfg)
    return random, trained


def prefill_logits_vs_plain(params, cfg, ids):
    """The kernel path's prefill logits against the plain path's, the plain
    path run on the kernel path's selections layer by layer.  Selection is
    the same plain code on both paths, but its top-k flips where a layer's
    input moves by a bf16 rounding, and a flipped block moves that row's
    logits by more than the kernels' rounding does (with the parent
    commit's kernel as with this one: 8-10 of the 249,600 positions at the
    serving cell).  Returns the largest error, the largest plain logit and
    how many positions exceed the tolerance on the plain path's own
    selections."""
    real = nsa_layer.nsa_fine_sliding_attention
    recorded, feed = [], None

    def record(*a, **k):
        recorded.append(a[3:5])
        return real(*a, **k)

    def replay(*a, **k):
        return real(*a[:3], *next(feed), *a[5:], **k)

    try:
        nsa_layer.nsa_fine_sliding_attention = record
        got = transformer_forward(params, cfg, ids)
        feed = iter(recorded)
        nsa_layer.nsa_fine_sliding_attention = replay
        want = transformer_forward(params, cfg, ids, use_kernels=False)
    finally:
        nsa_layer.nsa_fine_sliding_attention = real
    err, top = max_err(got, want), want.abs().max().item()
    del want, recorded
    own = transformer_forward(params, cfg, ids, use_kernels=False)
    flipped = int(((got - own).abs().amax(-1) > TOL_LOGITS_REL * max(top, 1.0)).sum())
    return err, top, flipped


def list_sizes(sel_idx, sel_mask, sel_block):
    """Mean and largest number of rows per inverted list: for each (batch,
    KV head, block) the rows whose valid selection names the block before
    the row's own block, each row once (the lists row 5 walks)."""
    b, kvh, n, S = sel_idx.shape
    nblk = -(-n // sel_block)
    q_blk = (torch.arange(n, device=sel_idx.device) // sel_block)[:, None]
    idx = sel_idx.long()
    ok = sel_mask & (idx >= 0) & (idx < q_blk)
    member = torch.zeros((b, kvh, n, nblk + 1), dtype=torch.bool, device=sel_idx.device)
    member.scatter_(-1, torch.where(ok, idx, nblk), True)
    rows = member[..., :nblk].sum(2).float()
    return {"mean": rows.mean().item(), "max": rows.max().item()}


def selection_stats(sel_idx, sel_mask, sel_block):
    """What the backward kernels' designs depend on: rows per inverted list
    (row 5) and union blocks per 16 query rows (row 4)."""
    return {"rows_per_list": list_sizes(sel_idx, sel_mask, sel_block),
            "u16": union_sizes(sel_idx, sel_mask, sel_block, 16)}


def flex_backward(inputs, fo_grad, so_grad, sel_block, window, scale, flush, iters=10):
    """Rows 4 and 5's library yardstick: ``torch.autograd.grad`` through
    ``flex_prefill`` (``flex_attention`` for both branches under
    ``torch.compile``), dq, dk and dv; no d_gates.  A first forward and
    backward compile both; then the median device ms of the backward alone
    (each timed call on a forward run before it, L2 flushed) and the first
    call's gradients."""
    with torch.inference_mode(False), torch.enable_grad():
        rq, rk, v = (x.clone().requires_grad_() for x in inputs[:3])
        run = flex_prefill(rq, rk, v, *(x.clone() for x in inputs[3:]), sel_block, window,
                           scale)
        cot = (fo_grad.clone(), so_grad.clone())
        grads = torch.autograd.grad(run()[:2], (rq, rk, v), cot)
        events = []
        for _ in range(iters):
            outs = run()[:2]
            with torch.inference_mode():
                flush()
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            torch.autograd.grad(outs, (rq, rk, v), cot)
            e.record()
            events.append((s, e))
        torch.cuda.synchronize()
    ts = sorted(s.elapsed_time(e) for s, e in events)
    return ts[len(ts) // 2], grads


def check_prefill_bwd(name, inputs, gen, flush, cfg, log):
    """Rows 4 and 5 on one set of inputs at the training cell: the forward
    kernel's outputs, seeded cotangents; dq, dk, dv against the plain
    versions element by element (``prefill_bwd_tolerance``) with a control
    (the plain backward with each row's first selected block left out, on
    2 sequences) that must fail the rule; d_gates and the deltas within
    TOL_BWD_F32; each kernel bit-equal on a second launch; the lists' and
    unions' sizes; kernel, plain, bound and flex_attention backward times."""
    nsa = cfg.nsa
    G, d = cfg.num_grouped_queries, cfg.dim_head
    Bs, window, scale = nsa.selection_block_size, nsa.sliding_window_size, d ** -0.5
    rq, rk, v, sel_idx, sel_mask = sel = inputs
    fo, so, flse, slse = nsa_prefill.prefill_fwd(*sel, Bs, window, scale)
    dfo = torch.randn(fo.shape, generator=gen, device=DEVICE).to(torch.bfloat16)
    dso = torch.randn(so.shape, generator=gen, device=DEVICE).to(torch.bfloat16)
    dq_args = (*sel, fo, so, flse, slse, dfo, dso, Bs, window, scale)
    got_q = nsa_prefill.prefill_bwd_dq(*dq_args)
    want_q = nsa_prefill.prefill_bwd_dq_plain(*dq_args)
    # the dkv kernel and its plain version read the same (plain) deltas
    terms = (flse, slse, want_q[2], want_q[3], dfo, dso)
    dkv_args = (*sel, *terms, Bs, window, scale)
    got_kv = nsa_prefill.prefill_bwd_dkv(*dkv_args)
    want_kv = nsa_prefill.prefill_bwd_dkv_plain(*dkv_args)
    again = (*nsa_prefill.prefill_bwd_dq(*dq_args), *nsa_prefill.prefill_bwd_dkv(*dkv_args))
    torch.cuda.synchronize()
    want = (want_q[0], *want_kv)
    tols = nsa_prefill.prefill_bwd_tolerance(*sel, *terms, Bs, window, scale, want)
    ratios = {k: ((x.float() - y.float()).abs() / t).max().item()
              for k, x, y, t in zip(("dq", "dk", "dv"), (got_q[0], *got_kv), want, tols)}
    f32 = {k: max_err(x, y) / y.float().abs().max().item()
           for k, x, y in zip(("d_gates", "fine_delta", "sliding_delta"), got_q[1:], want_q[1:])}
    two = [x[:2] for x in sel]
    dropped = nsa_prefill.without_first_block(two[3], two[4], Bs)
    wrong = (nsa_prefill.prefill_bwd_dq_plain(*two[:4], dropped,
                                              *[x[:2] for x in dq_args[5:11]], *dq_args[11:])[0],
             *nsa_prefill.prefill_bwd_dkv_plain(*two[:4], dropped,
                                                *[x[:2] for x in dkv_args[5:11]], *dkv_args[11:]))
    control = [((x.float() - y[:2].float()).abs() / t[:2]).max().item()
               for x, y, t in zip(wrong, want, tols)]
    del tols, wrong
    stats = selection_stats(sel_idx, sel_mask, Bs)
    print(f"  {name}: max |err| / bound dq {ratios['dq']:.4f} dk {ratios['dk']:.4f} dv "
          f"{ratios['dv']:.4f} (<= 1: 2^-7 |plain| + 2^-8 of the sum over absolute values); "
          f"max |err| / max |plain| d_gates {f32['d_gates']:.2e} deltas {f32['fine_delta']:.2e} "
          f"{f32['sliding_delta']:.2e} (tol {TOL_BWD_F32}); each row's first selected block left "
          f"out: dq {control[0]:.2f} dk {control[1]:.2f} dv {control[2]:.2f} (dq and dk or dv "
          f"must be > 1); rows per inverted list {stats['rows_per_list']}, union blocks per 16 "
          f"rows {stats['u16']}", flush=True)
    check(control[0] > 1.0 and max(control[1:]) > 1.0,
          f"{name}: the backward rule passes a kernel that leaves out a block")
    check(all(torch.isfinite(x.float()).all().item() for x in (*got_q, *got_kv))
          and max(ratios.values()) <= 1.0, f"{name}: dq, dk or dv disagree with the plain version")
    check(max(f32.values()) <= TOL_BWD_F32, f"{name}: d_gates or a delta disagrees")
    check(all(torch.equal(x, y) for x, y in zip((*got_q, *got_kv), again)),
          f"{name}: a backward kernel is not deterministic")

    fine, band = needed_keys(sel_idx, sel_mask, cfg)
    common = nbytes(*sel, flse, slse, dfo, dso)
    # dq: s, do.v and dS.k per (row, key, head); dkv: s, do.v, dS.q, p.do per
    # (row, key, head) of each branch
    bq, byq = bound_ms(common + nbytes(fo, so, *got_q), (fine + band) * G * 6 * d)
    bkv, bykv = bound_ms(common + nbytes(got_q[2], got_q[3], *got_kv), (fine + band) * G * 8 * d)
    t0 = time.perf_counter()
    lib, lib_out = flex_backward(sel, dfo, dso, Bs, window, scale, flush)
    lib_err = max(max_err(x, y) for x, y in zip(lib_out, want))
    setup = time.perf_counter() - t0
    del lib_out
    out = []
    for kname, fn, plain, args, bms, by, err, line in (
            ("prefill_bwd_dq", nsa_prefill.prefill_bwd_dq, nsa_prefill.prefill_bwd_dq_plain,
             dq_args, bq, byq, max_err(got_q[0], want_q[0]), 657),
            ("prefill_bwd_dkv", nsa_prefill.prefill_bwd_dkv, nsa_prefill.prefill_bwd_dkv_plain,
             dkv_args, bkv, bykv, max(max_err(x, y) for x, y in zip(got_kv, want_kv)), 677)):
        ms = timed_ms(lambda: fn(*args), 10, flush)
        regs, spill = kernel_times.ptxas_usage(log, ("bwd_dq_kernelILi2E" if kname.endswith("dq")
                                        else "bwd_dkv_kernelILi2E"))
        print(f"  {kname + name.removeprefix('prefill_bwd')} {ms:.4f} ms (bound {bms:.4f} ms by "
              f"{by}: {ms / bms:.2f}x); registers {regs}, spill stores / loads {spill} bytes at "
              f"G = 2", flush=True)
        out.append({"name": kname + name.removeprefix("prefill_bwd"), "route": "cuda",
                    "source": "nsa_tpu_torch/csrc/nsa_prefill_bwd.cu",
                    "replaces": f"nsa_tpu/ops/pallas/nsa_prefill.py:{line}",
                    "max_abs_err": err, "ms": ms,
                    "plain_ms": timed_ms(lambda: plain(*args), 2, flush),
                    "bound_ms": bms, "bound_by": by, "library_ms": lib,
                    "library": "flex_attention backward of both branches (dq, dk, dv; no "
                               "d_gates), rows 4 and 5 together",
                    "registers_g2": regs, "spill_bytes_g2": spill, **stats})
    print(f"  {name}: flex_attention backward (dq, dk, dv of both branches together, no d_gates) "
          f"{lib:.4f} ms against rows 4 + 5 {out[0]['ms'] + out[1]['ms']:.4f} ms; its gradients "
          f"vs plain max|err| {lib_err:.5f} (block masks, compiles and timing {setup:.1f}s)",
          flush=True)
    return out


def kernel_prefill_bwd(gen, flush, cfg, params, log):
    """Rows 4 and 5 at the training cell on seeded random selections and on
    the trained weights' own (layer 0 of a seeded micro-batch's forward)."""
    random = check_prefill_bwd("prefill_bwd", prefill_inputs(gen, cfg, MICRO, SEQ), gen, flush,
                               cfg, log)
    trained = check_prefill_bwd("prefill_bwd_trained",
                                layer0_prefill_inputs(params, cfg, training_forward), gen,
                                flush, cfg, log)
    return [*random, *trained]


def check_selection(info_k, info_p, scores, num_sel, n_slide, label):
    """Packed info rows [..., INFO_WIDTH] of a kernel and its plain version:
    trailing ids equal; selected ids equal except where the scores tie
    within TIE; validity equal on the rows whose ids agree.  Returns the
    number of rows that differ by ties."""
    faults, ties = nsa_decode.selection_faults(info_k, info_p, scores, num_sel=num_sel,
                                               n_slide=n_slide, tie=TIE)
    check(not faults, f"{label}: {'; '.join(faults)}")
    return ties


def attend_rows(vp, t, Bs, n_slide, window, bkvh):
    """kv rows the attention needs: valid selected blocks, the band and the
    diagonal block up to t."""
    trail = t // Bs - torch.arange(n_slide - 1, -1, -1)
    j = trail[:, None] * Bs + torch.arange(Bs)
    diag = torch.zeros_like(j, dtype=torch.bool)
    diag[-1] = True
    trail_rows = (((j >= t - window) | diag) & (j <= t) & (trail >= 0)[:, None]).sum().item()
    return vp.sum().item() * Bs + bkvh * trail_rows


def kernel_decode_fused(gen, flush, cfg, params, b, log):
    """Rows 6 and 7 at bs ``b``: layer 0's trained weights, packed; seeded
    queries, caches and residual stream.  Row 6 on an emission step and the
    step before it, row 7 with the FF inside, each held as rows 8-9 are:
    the emitted row and the output within TOL_FUSED of the largest value,
    the rounded attention output element by element under
    ``attend_tolerance``, each with a control that must fail; a second
    launch bit for bit; device time from the profiler."""
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
    F = nsa_decode_fused
    dev = DEVICE

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    q, ckv, ring, kv_new = randn(b, kvh, g, d), randn(b, kvh, Wc, 2 * d), \
        randn(b, kvh, Bc, 2 * d), randn(b, kvh, 1, 2 * d)
    mem_kv = fp["mem_kv"]
    kw = dict(max_blocks=MAX_LEN // Bs, stride=stride, sel_block=Bs, num_sel=num_sel,
              n_slide=n_slide, scale=scale)
    steps, plain_times, errs, outs = {}, {}, [], {}
    for t in (DECODE_T, DECODE_T - 1):          # an emission step, then one without
        num_cb, pt = t // stride, device_t(t)
        caches = [(ckv.clone(), ring.clone()) for _ in range(4)]
        c_k, info_k = F.decode_select_emit(q, *caches[0], kv_new, mem_kv, *weights, pt, num_cb,
                                           **kw)
        c_2, info_2 = F.decode_select_emit(q, *caches[2], kv_new, mem_kv, *weights, pt, num_cb,
                                           **kw)
        c_p, info_p = F.decode_select_emit_plain(q, *caches[1], kv_new, mem_kv, *weights, t,
                                                 num_cb, **kw)
        with dropped_emission_chunk():     # the control: one emission chunk left out
            F.decode_select_emit_plain(q, *caches[3], kv_new, mem_kv, *weights, t, num_cb, **kw)
        _, scores = nsa_decode.select_scores_plain(q, ckv, mem_kv, num_cb, t, stride=stride,
                                                   sel_block=Bs, scale=scale)
        torch.cuda.synchronize()
        emit = F.emits(t, stride)
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
        err_ctl = max_err(caches[3][0][:, :, num_cb], row_p)
        if emit:
            check(err_row <= TOL_FUSED * top_row and not torch.equal(row_p, ckv[:, :, num_cb]),
                  f"decode_select_emit t={t}: the emitted ckv row disagrees")
            check(err_ctl > TOL_FUSED * top_row, f"decode_select_emit t={t}: the dropped-chunk "
                  f"control passes the emitted-row gate")
        else:
            check(torch.equal(row_k, ckv[:, :, num_cb]) and torch.equal(row_p, ckv[:, :, num_cb]),
                  f"decode_select_emit t={t}: a row was emitted off the stride")
        check(err_c <= TOL_OUT and bool(torch.isfinite(c_k.float()).all()),
              f"decode_select_emit t={t}: c_out disagrees")
        same2 = (torch.equal(c_2, c_k) and torch.equal(info_2, info_k)
                 and torch.equal(caches[2][0], caches[0][0])
                 and torch.equal(caches[2][1], caches[0][1]))
        check(same2, f"decode_select_emit t={t}: a second launch gives other bits")
        print(f"  decode_select_emit bs {b} t={t} (emits: {emit}): max|err| c_out {err_c:.5f} "
              f"(tol {TOL_OUT}); ids equal on {b * kvh - ties}/{b * kvh} rows, {ties} differ "
              f"only by ties within {TIE}; emitted row max|err| {err_row:.5f} (tol {TOL_FUSED:g} "
              f"x max {top_row:.3f})" + (f", the dropped-chunk control {err_ctl:.5f} (must "
                                         f"exceed it)" if emit else "")
              + f"; ring bit-equal; other ckv rows unchanged; a second launch bit-equal: "
              f"{same2}", flush=True)
        errs.append(max(err_c, err_row))
        outs[t] = (c_p, info_p, err_ctl / (TOL_FUSED * top_row) if emit else None)
        work = (q, ckv.clone(), ring.clone(), kv_new, mem_kv, *weights)
        steps[t] = breakdown(f"decode_select_emit t={t}", lambda: F.decode_select_emit(
            *work, pt, num_cb, **kw), flush)
        plain_times[t] = timed_ms(lambda: F.decode_select_emit_plain(
            *work, t, num_cb, **kw), 10, flush)
    # amortised over the stride: one emission step in `stride`
    amort = (steps[DECODE_T]["ms"] + (stride - 1) * steps[DECODE_T - 1]["ms"]) / stride
    amort_plain = (plain_times[DECODE_T] + (stride - 1) * plain_times[DECODE_T - 1]) / stride
    num_cb = DECODE_T // stride
    c_p, info_p, ctl_ratio = outs[DECODE_T]
    step_bytes = (nbytes(q, mem_kv, c_p, info_p, kv_new) + 2 * nbytes(ring)
                  + b * kvh * num_cb * 2 * d * 2)
    emit_bytes = nbytes(*weights) + b * kvh * 2 * d * 2
    hid = fp["w1k"].shape[2]
    step_flops = b * kvh * g * (num_cb + M) * 4 * d
    emit_flops = b * kvh * 2 * (Bc * d * hid + hid * d) * 2
    bms, by = bound_ms(step_bytes + emit_bytes / stride, step_flops + emit_flops / stride)
    eplan = nsa_decode_ragged.device_emit_plan(q, ring, fp["w1k"])
    print(f"  decode_select_emit bs {b}: device {steps[DECODE_T]['ms']:.4f} ms emitting, "
          f"{steps[DECODE_T - 1]['ms']:.4f} ms not, {amort:.4f} ms amortised over {stride} "
          f"steps (bound {bms:.5f} ms, by {by}); plain {amort_plain:.4f} ms; emission launch "
          f"{eplan['blocks']} blocks of {eplan['smem_bytes']} B shared memory", flush=True)
    sel = {"name": "decode_select_emit", "route": "cuda",
           "source": "nsa_tpu_torch/csrc/nsa_decode_fused.cu",
           "replaces": "nsa_tpu/ops/pallas/nsa_decode_fused.py:441",
           "max_abs_err": max(errs), "ms": amort, "plain_ms": amort_plain,
           "bound_ms": bms, "bound_by": by, "library_ms": None, "emit_plan": eplan,
           "control_over_gate": ctl_ratio,
           "ms_emit_step": steps[DECODE_T]["ms"], "ms_other_step": steps[DECODE_T - 1]["ms"],
           "emit_step": steps[DECODE_T], "other_step": steps[DECODE_T - 1]}

    # attend: both versions get the same info and c_out (the plain select's)
    t = DECODE_T
    rq, kv = randn(b, kvh, g, d), randn(b, kvh, MAX_LEN, 2 * d)
    kv_row = randn(b, kvh, 1, 2 * d)
    gates = torch.sigmoid(randn(b, kvh, g, 3).float()).to(torch.bfloat16)
    x = randn(b, 1, dim)
    akw = dict(sel_block=Bs, window=window, num_sel=num_sel, n_slide=n_slide, scale=scale,
               eps=cfg.norm_eps)
    tkw = {k: v for k, v in akw.items() if k != "eps"}
    kv_k, kv_p, kv_2 = kv.clone(), kv.clone(), kv.clone()
    comb_k, comb_2 = torch.empty_like(rq), torch.empty_like(rq)
    args = (kv_row, info_p, c_p, gates, x, fp["w_out"], t, ff)
    args_k = (*args[:6], device_t(t), ff)      # the kernel reads t on the device
    out_k = F.decode_attend_fused(rq, kv_k, *args_k, attn_out=comb_k, **akw)
    out_2 = F.decode_attend_fused(rq, kv_2, *args_k, attn_out=comb_2, **akw)
    out_p = F.decode_attend_fused_plain(rq, kv_p, *args, **akw)
    # the control: the plain version with each row's first selected block left out
    dropped = nsa_decode_ragged.without_first_selected(info_p, num_sel, n_slide)
    out_c = F.decode_attend_fused_plain(rq, kv.clone(), kv_row, dropped, *args[2:], **akw)
    torch.cuda.synchronize()
    err_a, top = max_err(out_k, out_p), out_p.float().abs().max().item()
    err_ctl = max_err(out_c, out_p)
    check(torch.equal(kv_k, kv_p) and torch.equal(kv_k[:, :, t], kv_row[:, :, 0])
          and torch.equal(kv_k[:, :, :t], kv[:, :, :t])
          and torch.equal(kv_k[:, :, t + 1:], kv[:, :, t + 1:]),
          "decode_attend_fused: the kv cache is not the old one with row t written")
    check(err_a <= TOL_FUSED * top and bool(torch.isfinite(out_k.float()).all()),
          "decode_attend_fused disagrees")
    check(err_ctl > TOL_FUSED * top,
          "decode_attend_fused: the dropped-block control passes the output gate")
    want, tol = nsa_decode_ragged.attend_tolerance(rq, kv_p, info_p, c_p, gates, t, **tkw)
    wrong, _ = nsa_decode_ragged.attend_tolerance(rq, kv_p, dropped, c_p, gates, t, **tkw)
    ratio = ((comb_k.float() - want.float()).abs() / tol).max().item()
    ratio_ctl = ((wrong.float() - want.float()).abs() / tol).max().item()
    check(ratio <= 1.0, "decode_attend_fused: the attention output breaks attend_tolerance")
    check(ratio_ctl > 1.0, "decode_attend_fused: the dropped-block control passes "
          "attend_tolerance")
    same2 = torch.equal(out_2, out_k) and torch.equal(comb_2, comb_k) and torch.equal(kv_2, kv_k)
    check(same2, "decode_attend_fused: a second launch gives other bits")
    print(f"  decode_attend_fused bs {b} (FF inside): max|err| {err_a:.5f} (tol {TOL_FUSED:g} x "
          f"max {top:.3f}), the dropped-block control {err_ctl:.5f} (must exceed it); attention "
          f"output worst |err| / attend_tolerance {ratio:.4f} (<= 1), the control "
          f"{ratio_ctl:.1f} (> 1); kv row {t} written, bit-equal; no other row changed; a "
          f"second launch bit-equal: {same2}", flush=True)
    plan = nsa_decode_ragged.attend_plan(rq, dim, ff[1].shape[1], sel_block=Bs,
                                         num_sel=num_sel, n_slide=n_slide)
    regs, spill = kernel_times.ptxas_usage(log, f"attend_persistent_kernelILi{g}E", "OnePosition")
    print(f"  decode_attend_fused launch: grid {plan['grid']}, {plan['blocks_per_sm']} block(s) "
          f"fit an SM, shared memory {plan['smem_bytes']} B a block (card limit "
          f"{plan['smem_optin']}); ptxas: {regs} registers, spills (stores, loads) {spill}",
          flush=True)
    vp = info_p.reshape(b, kvh, -1)[..., num_sel + n_slide:2 * num_sel + n_slide]
    rows = attend_rows(vp, t, Bs, n_slide, window, b * kvh)
    hid4 = ff[1].shape[1]
    bms, by = bound_ms(nbytes(rq, info_p, c_p, gates, x, kv_row, fp["w_out"], *ff, out_k)
                       + rows * 2 * d * 2 + nbytes(kv_row),
                       rows * g * 4 * d + b * 2 * (kvh * g * d * dim + 2 * dim * hid4))
    att = {"name": "decode_attend_fused", "route": "cuda",
           "source": "nsa_tpu_torch/csrc/nsa_decode_ragged.cu",
           "replaces": "nsa_tpu/ops/pallas/nsa_decode_fused.py:830",
           "max_abs_err": err_a, "attend_tolerance_ratio": ratio,
           "control_over_gate": err_ctl / (TOL_FUSED * top), "control_ratio": ratio_ctl,
           **breakdown("decode_attend_fused", lambda: F.decode_attend_fused(
               rq, kv_k, *args_k, **akw), flush),
           "plain_ms": timed_ms(lambda: F.decode_attend_fused_plain(rq, kv_p, *args, **akw),
                                10, flush),
           "bound_ms": bms, "bound_by": by, "library_ms": None,
           "plan": plan, "registers": regs, "spill_bytes": spill,
           "phase_us": kernel_times.attend_phase_us(lambda m: F.decode_attend_fused(
               rq, kv_k, *args_k, phase_ns=m, **akw), flush)}
    print(f"  decode_attend_fused bs {b}: device {att['ms']:.4f} ms (bound {bms:.5f} ms, by "
          f"{by}); plain {att['plain_ms']:.4f} ms; us per phase (the card's global timer, "
          f"median of 5): { {k: round(v, 2) for k, v in att['phase_us'].items()} }", flush=True)
    return sel, att


def mega_selection_gate(mp, insp, start, after, plain, t, cfg):
    """Each layer's selection of the whole-model kernel, held as row 8's
    is: the plain select-emit on the kernel's own query and new row of that
    layer (``inspect``; the caches as they were before the step) must pick
    the same ids except ties within TIE, give c_out and the emitted ckv row
    within TOL_FUSED of the largest value, and the kernel's selection one
    rank short (``with_next_ranked``) must fail at every layer.  The
    kernel's queries, rotated queries, gates and c_out are also held within
    TOL_FUSED to the plain run's own of the same layer (``plain``: its
    selections, (q, c_out) and (rq, gates) a layer); the ids of the two
    runs, whose queries differ by roundings, are counted, not gated."""
    nsa = cfg.nsa
    L, b, kvh = cfg.depth, insp["q"].shape[1], cfg.kv_heads
    stride, Bs = nsa.compress_block_sliding_stride, nsa.selection_block_size
    num_sel, n_slide = nsa.num_selected_blocks, -(-nsa.sliding_window_size // Bs) + 1
    kw = dict(max_len=MAX_LEN, stride=stride, sel_block=Bs, num_sel=num_sel, n_slide=n_slide,
              scale=cfg.dim_head ** -0.5)
    gkw = dict(num_sel=num_sel, n_slide=n_slide, tie=TIE)
    slot = min(t // stride, after[1].shape[3] - 1)
    emit = nsa_decode_fused.emits(t, stride)
    infos, plain_sel, plain_att = plain
    own, cross, ties, departs, fails, same_ids = [], [], [], [], 0, 0

    def ratio(got, want):
        return max_err(got, want) / (TOL_FUSED * want.float().abs().max().item())

    for l in range(L):
        info_k = insp["info"][l].reshape(b, kvh, -1)
        c_p, info_p, ckv_p, scores = nsa_decode_mega.layer_select_emit_plain(
            mp, l, insp["q"][l], start[1][l], start[2][l], after[2][l][..., -1:, :], t, **kw)
        faults, n_ties = nsa_decode.selection_faults(info_k, info_p, scores, **gkw)
        departs += [f"layer {l}: {x}" for x in faults]
        wrong = nsa_decode.with_next_ranked(info_k, scores, num_sel)
        fails += bool(nsa_decode.selection_faults(wrong, info_p, scores, **gkw)[0])
        ties.append(n_ties)
        own.append(max(ratio(insp["c_out"][l], c_p),
                       ratio(after[1][l][..., slot, :], ckv_p[..., slot, :]) if emit else 0.0))
        q_p, cp_run = plain_sel[l]
        rq_p, gates_p = plain_att[l]
        cross.append(max(ratio(insp["q"][l], q_p), ratio(insp["rq"][l], rq_p),
                         ratio(insp["gates"][l], gates_p.reshape(insp["gates"][l].shape)),
                         ratio(insp["c_out"][l], cp_run)))
        same_ids += int((info_k[..., :num_sel] == infos[l].reshape(b, kvh, -1)[..., :num_sel])
                        .all(-1).sum())
    print(f"  decode_step_mega bs {b} t={t}: each layer's selection on the kernel's query: ids "
          f"equal on {[b * kvh - x for x in ties]} of {b * kvh} (row, head)s, the rest ties "
          f"within {TIE} (faults: {departs or 'none'}); the one-rank-short control fails at {fails}/{L} layers; c_out and "
          f"emitted row worst |err| / (TOL_FUSED x max) {[round(r, 3) for r in own]}; q, rq, "
          f"gates, c_out against the plain run's {[round(r, 3) for r in cross]} (<= 1); ids "
          f"equal to the plain run's on {same_ids}/{L * b * kvh} (row, head)s (counted)",
          flush=True)
    check(not departs, f"decode_step_mega t={t}: the selection departs from the plain one on "
          f"the kernel's query: {departs}")
    check(max(own) <= 1.0, f"decode_step_mega t={t}: a layer's c_out or emitted row departs from "
          f"the plain select-emit on the kernel's query")
    check(max(cross) <= 1.0, f"decode_step_mega t={t}: a layer's q, rq, gates or c_out departs "
          f"from the plain run's")
    check(fails == L, f"decode_step_mega t={t}: the selection one rank short passes the "
          f"selection gate at {L - fails} of {L} layers")
    return {"selection_ties": ties, "control_fails": fails, "own_ratio": max(own),
            "cross_ratio": max(cross), "ids_equal_to_plain_run": same_ids}


def kernel_decode_mega(gen, flush, cfg, packed, b, log):
    """Row 12 at bs ``b``: the whole model's trained weights (packed);
    seeded tokens and caches at full length; an emission step and the step
    before it.  The rows a step writes (kv row t, the ring's new row, the
    emitted ckv row) come from bf16 roundings of float32 sums that the two
    versions take in another order, so they are held within TOL_FUSED of the
    largest value; every other cache row, and the ring's shifted rows, must
    be bit-equal to what was there.  Two controls, the plain version with
    one emission chunk left out (``dropped_emission_chunk``) and with each
    (row, head)'s first selected block left out in every layer
    (``dropped_selected_block``): the first must fail the emitted-row gate;
    the second the logits gate and the written rows' do not see (their
    ratios are printed), so a finer gate holds every layer's rounded
    attention output, element by element, to the plain combine on the
    kernel's own inputs of that layer (``inspect``, ``attend_tolerance``, as
    for rows 9-10), and the same inputs with each row's first selected block
    left out must fail it at every layer.  Each layer's selection, c_out,
    gates and emitted row are held too (``mega_selection_gate``), with a
    selection one rank short as the control.  Also the launch plan, ptxas's
    registers and the time by phase and layer."""
    nsa = cfg.nsa
    L, kvh, d, stride = cfg.depth, cfg.kv_heads, cfg.dim_head, nsa.compress_block_sliding_stride
    Bc, Bs, window = nsa.compress_block_size, nsa.selection_block_size, nsa.sliding_window_size
    num_sel, n_slide = nsa.num_selected_blocks, -(-window // nsa.selection_block_size) + 1
    Wc = _ckv_width(MAX_LEN, stride, nsa.num_compress_per_fine)
    mp = packed["mega"]
    dev = DEVICE
    tkw = dict(sel_block=Bs, window=window, num_sel=num_sel, n_slide=n_slide, scale=d ** -0.5)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    kv, ckv, ring = randn(L, b, kvh, MAX_LEN, 2 * d), randn(L, b, kvh, Wc, 2 * d), \
        randn(L, b, kvh, Bc, 2 * d)
    token = torch.randint(0, cfg.vocab_size, (b,), generator=gen, device=dev)
    # the plain run's own per-layer values: the selections (also for the
    # bound), the queries and compressed outputs; the rotated queries and
    # gates its attend takes
    infos, plain_sel, plain_att = [], [], []
    real_select = nsa_decode_mega.decode_select_emit_plain
    real_attend = nsa_decode_mega.decode_attend_fused_plain

    def recording_select(*a, **k):
        out = real_select(*a, **k)
        infos.append(out[1])
        plain_sel.append((a[0], out[0]))
        return out

    def recording_attend(rq, kv_l, kv_row, info, c_out, gates, *a, **k):
        plain_att.append((rq, gates))
        return real_attend(rq, kv_l, kv_row, info, c_out, gates, *a, **k)

    times, plain_times, errs, phases, controls, timed, sel_gates = {}, {}, [], {}, {}, {}, {}
    for t in (DECODE_T, DECODE_T - 1):           # an emission step, then one without
        num_cb, emit = t // stride, nsa_decode_fused.emits(t, stride)
        caches = [(kv.clone(), ckv.clone(), ring.clone()) for _ in range(2)]
        insp = {}
        lg_k, tok_k, *_ = transformer_decode_step_mega(mp, cfg, token, *caches[0], t, greedy=True,
                                                       inspect=insp)
        for rec in (infos, plain_sel, plain_att):
            rec.clear()
        nsa_decode_mega.decode_select_emit_plain = recording_select
        nsa_decode_mega.decode_attend_fused_plain = recording_attend
        try:
            lg_p, tok_p, *_ = transformer_decode_step_mega(mp, cfg, token, *caches[1], t,
                                                           greedy=True, use_kernels=False)
        finally:
            nsa_decode_mega.decode_select_emit_plain = real_select
            nsa_decode_mega.decode_attend_fused_plain = real_attend
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
        # the controls, on the plain version: one emission chunk left out (at
        # the emission step), each row's first selected block left out
        for name, ctl in (("emission chunk", dropped_emission_chunk),
                          ("selected block", dropped_selected_block)):
            if name == "emission chunk" and not emit:
                continue
            work = (kv.clone(), ckv.clone(), ring.clone())
            with ctl():
                lg_c, *_ = transformer_decode_step_mega(mp, cfg, token, *work, t, greedy=True,
                                                        use_kernels=False)
            torch.cuda.synchronize()
            if name == "emission chunk":
                e_c = max_err(work[1][..., slot, :], caches[1][1][..., slot, :])
                m_c = caches[1][1][..., slot, :].float().abs().max().item()
                check(e_c > TOL_FUSED * m_c,
                      f"decode_step_mega t={t}: the dropped-chunk control passes the emitted-row "
                      f"gate")
            else:
                # the logits gate and the written rows' are too coarse to see
                # one block of each row's selection (the trained fine
                # branch's gate is ~0.12): their ratios are printed; the
                # finer gate below, on each layer's attention output, must
                # see it
                controls[(t, "selected block, kv rows t")] = max_err(
                    work[0][..., t, :], caches[1][0][..., t, :]) / (
                    TOL_FUSED * caches[1][0][..., t, :].float().abs().max().item())
                e_c, m_c = max_err(lg_c, lg_p), top
                name = "selected block, logits"
            controls[(t, name)] = e_c / (TOL_FUSED * m_c)
        # the finer gate: every layer's rounded attention output, element by
        # element, against the plain combine on the kernel's own inputs of
        # that layer (attend_tolerance, as for rows 9-10), with the control
        # that leaves each row's first selected block out, which must fail it
        ratios, ratios_ctl = [], []
        for l in range(L):
            inputs = (insp["rq"][l], caches[0][0][l], insp["info"][l], insp["c_out"][l],
                      insp["gates"][l], t)
            want, tol = nsa_decode_ragged.attend_tolerance(*inputs, **tkw)
            dropped = nsa_decode_ragged.without_first_selected(insp["info"][l], num_sel, n_slide)
            wrong, _ = nsa_decode_ragged.attend_tolerance(inputs[0], inputs[1], dropped,
                                                          *inputs[3:], **tkw)
            ratios.append(((insp["attn_out"][l].float() - want.float()).abs() / tol).max().item())
            ratios_ctl.append(((wrong.float() - want.float()).abs() / tol).max().item())
        check(max(ratios) <= 1.0, f"decode_step_mega t={t}: a layer's attention output breaks "
              f"attend_tolerance")
        check(min(ratios_ctl) > 1.0, f"decode_step_mega t={t}: the dropped-block control passes "
              f"attend_tolerance at a layer")
        controls[(t, "selected block, attention outputs (min over layers)")] = min(ratios_ctl)
        print(f"  decode_step_mega bs {b} t={t}: each layer's attention output worst |err| / "
              f"attend_tolerance {[round(r, 4) for r in ratios]} (<= 1), the dropped-block "
              f"control {[round(r, 1) for r in ratios_ctl]} (> 1)", flush=True)
        sel_gate = mega_selection_gate(mp, insp, (kv, ckv, ring), caches[0], (infos, plain_sel,
                                                                             plain_att), t, cfg)
        controls[(t, "selection one rank short (layers failing)")] = sel_gate["control_fails"]
        sel_gates[t] = sel_gate
        print(f"  decode_step_mega bs {b} t={t}: controls over their gate "
              f"{ {k[1]: round(v, 2) for k, v in controls.items() if k[0] == t} } (the emission "
              f"chunk's and the attention outputs' > 1; logits and kv rows t printed only)",
              flush=True)
        print(f"  decode_step_mega bs {b} t={t} (emits: {emit}): logits max|err| {err:.5f} (tol "
              f"{TOL_FUSED:g} x max {top:.3f}); argmax equal on "
              f"{int((tok_k[:, 0] == tok_p[:, 0]).sum())}/{b} rows ({int(near.sum())} near-ties); "
              f"written rows max|err| kv {row_errs[0]:.5f} ring {row_errs[1]:.5f} ckv "
              f"{row_errs[2]:.5f}; every other cache row bit-equal", flush=True)
        errs.append(max(err, *row_errs))
        work = (kv.clone(), ckv.clone(), ring.clone())
        # device time from the profiler (the call's launches: the token's
        # cast and the kernel), as for rows 8-10: the wrapper's host time now
        # exceeds the kernel's, and the event-timed figure reads it
        timed[t] = breakdown(f"decode_step_mega t={t}", lambda: transformer_decode_step_mega(
            mp, cfg, token, *work, device_t(t), greedy=True), flush)
        times[t] = timed[t]["ms"]
        plain_times[t] = timed_ms(lambda: transformer_decode_step_mega(
            mp, cfg, token, *work, t, greedy=True, use_kernels=False), 3, flush)
        if emit:
            emit_infos = list(infos)
        phases[t] = mega_phase_us(mp, cfg, token, work, t)
        print(f"  decode_step_mega bs {b} t={t}: us per phase (mean over layers): "
              f"{ {k: round(v, 2) for k, v in phases[t].items() if k != 'by_layer'} }; "
              f"layer by layer {phases[t]['by_layer']}", flush=True)
    amort = (times[DECODE_T] + (stride - 1) * times[DECODE_T - 1]) / stride
    amort_event = (timed[DECODE_T]["event_ms"]
                   + (stride - 1) * timed[DECODE_T - 1]["event_ms"]) / stride
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
    print(f"  decode_step_mega bs {b}: device {times[DECODE_T]:.4f} ms emitting, "
          f"{times[DECODE_T - 1]:.4f} ms not, {amort:.4f} ms amortised over {stride} steps "
          f"(event-timed {amort_event:.4f}; bound {bms:.5f} ms, by {by}); plain "
          f"{amort_plain:.4f} ms", flush=True)
    plan = nsa_decode_mega.launch_plan(DEVICE, [
        L, b, kvh, cfg.num_grouped_queries, MAX_LEN, Wc, Bc, nsa.num_compressed_mem_kv,
        mp["w1k"].shape[3], cfg.dim, cfg.vocab_size, mp["fw1"].shape[2], 1, 0, stride, Bs,
        num_sel, n_slide, window, nsa_decode.INFO_WIDTH])
    regs, spill = kernel_times.ptxas_usage(log, f"mega_kernelILi{cfg.num_grouped_queries}E")
    print(f"  decode_step_mega launch: grid {plan['grid']}, {plan['blocks_per_sm']} block(s) fit "
          f"an SM, weight tiles {plan['slice_bytes']} B on the largest block "
          f"({plan['slice_total']} B in all), work space {plan['work_bytes']} B, shared memory "
          f"{plan['smem_bytes']} B a block (card limit {plan['smem_optin']}); ptxas: {regs} "
          f"registers, spills (stores, loads) {spill}", flush=True)
    return {"name": "decode_step_mega", "route": "cuda",
            "source": "nsa_tpu_torch/csrc/nsa_decode_mega.cu",
            "replaces": "nsa_tpu/ops/pallas/nsa_megakernel.py:1234",
            "max_abs_err": max(errs), "ms": amort, "plain_ms": amort_plain,
            "bound_ms": bms, "bound_by": by, "library_ms": None,
            "ms_emit_step": times[DECODE_T], "ms_other_step": times[DECODE_T - 1],
            "event_ms": amort_event, "host_ms_other_step": timed[DECODE_T - 1]["host_ms"],
            "phase_us_emit_step": phases[DECODE_T], "phase_us_other_step": phases[DECODE_T - 1],
            "plan": plan, "registers": regs, "spill_bytes": spill,
            "controls_over_gate": {f"t={k[0]} {k[1]}": v for k, v in controls.items()},
            "selection_gates": {f"t={k}": v for k, v in sel_gates.items()}}


@contextlib.contextmanager
def dropped_emission_chunk(chunk=0):
    """The plain select-emit versions with the emission's hidden chunk
    ``chunk`` left out (``emission_plain(..., drop_chunk=)``): a kernel that
    lost one emission item.  The control the emitted-row gates must fail."""
    real = nsa_decode_fused.emission_plain

    def dropped(*a, **k):
        return real(*a, drop_chunk=chunk, **k)

    nsa_decode_fused.emission_plain = nsa_decode_ragged.emission_plain = dropped
    try:
        yield
    finally:
        nsa_decode_fused.emission_plain = nsa_decode_ragged.emission_plain = real


@contextlib.contextmanager
def dropped_selected_block():
    """The plain whole-model decode with each (row, KV head)'s first valid
    selected block left out of every layer's attention
    (``without_first_selected``).  The control the logits gate must fail."""
    real = nsa_decode_mega.decode_attend_fused_plain
    kw_names = ("num_sel", "n_slide")

    def dropped(rq, kv, kv_new, info, *a, **k):
        info = nsa_decode_ragged.without_first_selected(info, *(k[n] for n in kw_names))
        return real(rq, kv, kv_new, info, *a, **k)

    nsa_decode_mega.decode_attend_fused_plain = dropped
    try:
        yield
    finally:
        nsa_decode_mega.decode_attend_fused_plain = real


def mega_phase_us(mp, cfg, token, caches, t):
    """Where one launch's time goes: the kernel's global-timer marks after
    each grid sync, as microseconds per phase (the mean over the layers, and
    layer by layer), the LM head, and the span from the first mark to the
    last."""
    L = cfg.depth
    marks = torch.zeros(nsa_decode_mega.phase_marks(L, 1), dtype=torch.int64, device=DEVICE)
    transformer_decode_step_mega(mp, cfg, token, *caches, t, greedy=True, phase_ns=marks)
    torch.cuda.synchronize()
    us = (marks[1:] - marks[:-1]).double().cpu() / 1e3
    by_layer = us[:5 * L].reshape(L, 5)
    per_layer = by_layer.mean(0)
    return {**{name: per_layer[i].item() for i, name in enumerate(nsa_decode_mega.PHASE_NAMES)},
            "lm_head": us[5 * L].item(), "span": (marks[-1] - marks[0]).item() / 1e3,
            "by_layer": [[round(v, 2) for v in row] for row in by_layer.tolist()]}


def ragged_attend_rows(info, t, cfg):
    """kv rows the attention of each (row, head) needs at its own t."""
    nsa = cfg.nsa
    Bs, window, num_sel = nsa.selection_block_size, nsa.sliding_window_size, nsa.num_selected_blocks
    n_slide = -(-window // Bs) + 1
    b, kvh = info.shape[0], cfg.kv_heads
    vp = info.reshape(b, kvh, -1)[..., num_sel + n_slide:2 * num_sel + n_slide].cpu()
    return sum(attend_rows(vp[i:i + 1], int(ti), Bs, n_slide, window, kvh)
               for i, ti in enumerate(t.tolist()))


def breakdown(name, fn, flush):
    """A kernel's device time from the profiler, launch by launch, with the
    event-timed figure and the host time beside it (rows 8-10, whose wrapper
    host time the L2 flush may not hide); printed, and returned as the keys
    of its kernels-line entry ("ms" is the device time)."""
    r = kernel_times.launch_breakdown(fn, flush)
    print(f"  {name}: device {r['device_ms']:.4f} ms in {len(r['launches'])} launch(es) "
          f"{[round(x['ms'], 4) for x in r['launches']]}, gaps "
          f"{[round(x, 4) for x in r['gaps_ms']]}"
          f" ms, span {r['span_ms']:.4f} ms; event-timed {r['event_ms']:.4f} ms; host "
          f"{r['host_ms']:.4f} ms a call", flush=True)
    return {"ms": r["device_ms"], "event_ms": r["event_ms"], "host_ms": r["host_ms"],
            "launch_ms": [x["ms"] for x in r["launches"]], "gap_ms": r["gaps_ms"]}


def kernel_decode_ragged(gen, flush, cfg, params, b, log):
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
    t = kernel_times.ragged_positions(gen, b, DEVICE)
    num_cb = t // stride
    kw = dict(max_blocks=MAX_LEN // Bs, stride=stride, sel_block=Bs, num_sel=num_sel,
              n_slide=n_slide, scale=scale)
    rows = torch.arange(b, device=DEVICE)
    emit = R.ragged_emits(t, num_cb, stride)
    slot = num_cb.long().clamp(max=Wc - 1)

    # ---- row 8: the ragged select-emit at mixed positions ------------------
    caches = [(ckv.clone(), ring.clone()) for _ in range(4)]
    c_k, info_k = R.decode_select_emit_ragged(q, *caches[0], kv_new, mem_kv, *weights, t,
                                              num_cb, **kw)
    c_2, info_2 = R.decode_select_emit_ragged(q, *caches[2], kv_new, mem_kv, *weights, t,
                                              num_cb, **kw)
    c_p, info_p = R.decode_select_emit_ragged_plain(q, *caches[1], kv_new, mem_kv, *weights, t,
                                                    num_cb, **kw)
    with dropped_emission_chunk():     # the control: one emission chunk left out
        R.decode_select_emit_ragged_plain(q, *caches[3], kv_new, mem_kv, *weights, t, num_cb,
                                          **kw)
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
    err_ctl = max_err(caches[3][0][rows, :, slot][emit], row_p)
    check(err_c <= TOL_FUSED * top_c and bool(torch.isfinite(c_k.float()).all()),
          "decode_select_emit_ragged: c_out disagrees")
    check(err_row <= TOL_FUSED * top_row, "decode_select_emit_ragged: an emitted row disagrees")
    check(err_ctl > TOL_FUSED * top_row,
          "decode_select_emit_ragged: the dropped-chunk control passes the emitted-row gate")
    same2 = (torch.equal(c_2, c_k) and torch.equal(info_2, info_k)
             and torch.equal(caches[2][0], caches[0][0]) and torch.equal(caches[2][1], caches[0][1]))
    check(same2, "decode_select_emit_ragged: a second launch gives other bits")
    n_emit = int(emit.sum())
    eplan = R.device_emit_plan(q, ring, fp["w1k"])
    print(f"  decode_select_emit_ragged {b} slots at t={t.tolist()} ({n_emit} emit): max|err| "
          f"c_out {err_c:.5f} (tol {TOL_FUSED:g} x max {top_c:.3f}); ids equal on "
          f"{b * kvh - ties}/{b * kvh} rows, {ties} differ only by ties within {TIE}; emitted "
          f"rows max|err| {err_row:.5f} (tol {TOL_FUSED:g} x max {top_row:.3f}), the "
          f"dropped-chunk control {err_ctl:.5f} (must exceed it); ring bit-equal; every other "
          f"ckv row unchanged; a second launch bit-equal: {same2}; emission launch "
          f"{eplan['blocks']} blocks of {eplan['smem_bytes']} B shared memory", flush=True)
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
           "max_abs_err": max(err_c, err_row), "emit_plan": eplan,
           "control_over_gate": err_ctl / (TOL_FUSED * top_row),
           **breakdown("decode_select_emit_ragged",
                       lambda: R.decode_select_emit_ragged(*work, **kw), flush),
           "plain_ms": timed_ms(lambda: R.decode_select_emit_ragged_plain(*work, **kw), 10, flush),
           "bound_ms": bms, "bound_by": by, "library_ms": None}

    # ---- row 9: the ragged attend, FF inside, at the same positions --------
    rq, kv = randn(b, kvh, g, d), randn(b, kvh, MAX_LEN, 2 * d)
    kv_row = randn(b, kvh, 1, 2 * d)
    gates = torch.sigmoid(randn(b, kvh, g, 3).float()).to(torch.bfloat16)
    x = randn(b, 1, dim)
    akw = dict(sel_block=Bs, window=window, num_sel=num_sel, n_slide=n_slide, scale=scale,
               eps=cfg.norm_eps)
    tkw = {k: v for k, v in akw.items() if k != "eps"}
    args = (kv_row, info_p, c_p, gates, x, fp["w_out"], t, ff)
    kv_k, kv_p, kv_2 = kv.clone(), kv.clone(), kv.clone()
    comb_k, comb_2 = torch.empty_like(rq), torch.empty_like(rq)
    out_k = R.decode_attend_fused_ragged(rq, kv_k, *args, attn_out=comb_k, **akw)
    out_2 = R.decode_attend_fused_ragged(rq, kv_2, *args, attn_out=comb_2, **akw)
    out_p = R.decode_attend_fused_ragged_plain(rq, kv_p, *args, **akw)
    # the control: the plain version with each row's first selected block left out
    dropped = R.without_first_selected(info_p, num_sel, n_slide)
    out_c = R.decode_attend_fused_ragged_plain(rq, kv.clone(), kv_row, dropped, *args[2:],
                                               **akw)
    torch.cuda.synchronize()
    err_a, top = max_err(out_k, out_p), out_p.float().abs().max().item()
    err_ctl = max_err(out_c, out_p)
    written = torch.zeros(b, MAX_LEN, dtype=torch.bool, device=DEVICE)
    written[rows, t.long()] = True
    written = written[:, None, :, None].expand_as(kv)
    check(torch.equal(kv_k, kv_p) and torch.equal(kv_k[rows, :, t.long()], kv_row[:, :, 0])
          and torch.equal(kv_k[~written], kv[~written]),
          "decode_attend_fused_ragged: the kv cache is not the old one with each row's t written")
    check(err_a <= TOL_FUSED * top and bool(torch.isfinite(out_k.float()).all()),
          "decode_attend_fused_ragged disagrees")
    check(err_ctl > TOL_FUSED * top,
          "decode_attend_fused_ragged: the dropped-block control passes the output gate")
    want, tol = R.attend_tolerance(rq, kv_p, info_p, c_p, gates, t, **tkw)
    wrong, _ = R.attend_tolerance(rq, kv_p, dropped, c_p, gates, t, **tkw)
    ratio = ((comb_k.float() - want.float()).abs() / tol).max().item()
    ratio_ctl = ((wrong.float() - want.float()).abs() / tol).max().item()
    check(ratio <= 1.0, "decode_attend_fused_ragged: the attention output breaks attend_tolerance")
    check(ratio_ctl > 1.0, "decode_attend_fused_ragged: the dropped-block control passes "
          "attend_tolerance")
    same2 = torch.equal(out_2, out_k) and torch.equal(comb_2, comb_k) and torch.equal(kv_2, kv_k)
    check(same2, "decode_attend_fused_ragged: a second launch gives other bits")
    print(f"  decode_attend_fused_ragged {b} slots (FF inside): max|err| {err_a:.5f} (tol "
          f"{TOL_FUSED:g} x max {top:.3f}), the dropped-block control {err_ctl:.5f} (must "
          f"exceed it); attention output worst |err| / attend_tolerance {ratio:.4f} (<= 1), the "
          f"control {ratio_ctl:.1f} (> 1); each row's kv row t written, bit-equal; no other "
          f"row changed; a second launch bit-equal: {same2}", flush=True)
    plan = R.attend_plan(rq, dim, ff[1].shape[1], sel_block=Bs, num_sel=num_sel,
                         n_slide=n_slide)
    regs, spill = kernel_times.ptxas_usage(log, f"attend_persistent_kernelILi{g}E", "DenseRows",
                              "RowPositions")
    print(f"  decode_attend_fused_ragged launch: grid {plan['grid']}, {plan['blocks_per_sm']} "
          f"block(s) fit an SM, weight tiles {plan['slice_bytes']} B on the largest block "
          f"({plan['slice_total'] / plan['grid']:.0f} B mean, {plan['slice_total']} B in all), "
          f"work space {plan['work_bytes']} B, shared memory {plan['smem_bytes']} B a block "
          f"(card limit {plan['smem_optin']}); ptxas: {regs} registers, spills "
          f"(stores, loads) {spill}", flush=True)
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
           **breakdown("decode_attend_fused_ragged",
                       lambda: R.decode_attend_fused_ragged(rq, kv_k, *args, **akw), flush),
           "plain_ms": timed_ms(lambda: R.decode_attend_fused_ragged_plain(rq, kv_p, *args,
                                                                           **akw), 10, flush),
           "bound_ms": bms, "bound_by": by, "library_ms": None,
           "plan": plan, "registers": regs, "spill_bytes": spill,
           "phase_us": kernel_times.attend_phase_us(lambda m: R.decode_attend_fused_ragged(
               rq, kv_k, *args, phase_ns=m, **akw), flush)}
    print(f"  decode_attend_fused_ragged us per phase (the card's global timer, median of 5): "
          f"{ {k: round(v, 2) for k, v in att['phase_us'].items()} }", flush=True)

    # ---- row 10: the paged attend under a permutation table ----------------
    n_pg = MAX_LEN // PAGE_TOKENS
    table = torch.randperm(b * n_pg, generator=gen, device=DEVICE).reshape(b, n_pg).int()
    pool = randn(b * n_pg + 1, kvh, PAGE_TOKENS, 2 * d)
    pool[table.reshape(-1).long()] = kv.reshape(b, kvh, n_pg, PAGE_TOKENS, 2 * d) \
        .transpose(1, 2).reshape(-1, kvh, PAGE_TOKENS, 2 * d)
    trash = pool[-1].clone()
    pool_k, pool_p = pool.clone(), pool.clone()
    comb_g = torch.empty_like(rq)
    out_g = R.decode_attend_fused_paged(rq, pool_k, table, *args, attn_out=comb_g, **akw)
    out_gp = R.decode_attend_fused_paged_plain(rq, pool_p, table, *args, **akw)
    torch.cuda.synchronize()
    logical = pool_k[table.long()].transpose(1, 2).reshape(b, kvh, MAX_LEN, 2 * d)
    same = torch.equal(out_g, out_k) and torch.equal(comb_g, comb_k)
    check(same and torch.equal(logical, kv_k) and torch.equal(pool_k[-1], trash),
          "decode_attend_fused_paged is not bit-equal to the ragged kernel on the same "
          "logical cache")
    err_g, top_g = max_err(out_g, out_gp), out_gp.float().abs().max().item()
    check(err_g <= TOL_FUSED * top_g and torch.equal(pool_k, pool_p),
          "decode_attend_fused_paged disagrees with its plain version")
    print(f"  decode_attend_fused_paged {b} slots, pages of {PAGE_TOKENS} rows under a "
          f"permutation table: output and attention output bit-equal to the ragged kernel's: "
          f"{same}; its pool through the table equals the ragged kernel's kv; max|err| vs plain "
          f"{err_g:.5f} (tol {TOL_FUSED:g} x max {top_g:.3f})", flush=True)
    bms, by = bound_ms(att_bytes + nbytes(table), att_flops)
    pag = {"name": "decode_attend_fused_paged", "route": "cuda",
           "source": "nsa_tpu_torch/csrc/nsa_decode_ragged.cu",
           "replaces": "nsa_tpu/ops/pallas/nsa_decode_fused.py:1608",
           "max_abs_err": err_g,
           **breakdown("decode_attend_fused_paged",
                       lambda: R.decode_attend_fused_paged(rq, pool_k, table, *args, **akw),
                       flush),
           "plain_ms": timed_ms(lambda: R.decode_attend_fused_paged_plain(
               rq, pool_p, table, *args, **akw), 10, flush),
           "bound_ms": bms, "bound_by": by, "library_ms": None}

    # ---- rows 8-9 at one position for every row, against rows 6-7 ----------
    # rows 6-7 run rows 8-9's bodies at one position: the same bits, on an
    # emission step and the step before it, with the FF and without
    for tt in (DECODE_T, DECODE_T - 1):
        tu = torch.full((b,), tt, dtype=torch.int32, device=DEVICE)
        caches = [(ckv.clone(), ring.clone()) for _ in range(2)]
        c_r, info_r = R.decode_select_emit_ragged(q, *caches[0], kv_new, mem_kv, *weights, tu,
                                                  tu // stride, **kw)
        c_s, info_s = nsa_decode_fused.decode_select_emit(q, *caches[1], kv_new, mem_kv,
                                                          *weights, tt, tt // stride, **kw)
        bits = {"c_out": torch.equal(c_r, c_s), "info": torch.equal(info_r, info_s),
                "ckv": torch.equal(caches[0][0], caches[1][0]),
                "ring": torch.equal(caches[0][1], caches[1][1])}
        uargs = (kv_row, info_s, c_s, gates, x, fp["w_out"])
        for label, ff_x in (("ff", ff), ("no ff", ())):
            kv_r, kv_s = kv.clone(), kv.clone()
            comb_r, comb_s = torch.empty_like(rq), torch.empty_like(rq)
            o_r = R.decode_attend_fused_ragged(rq, kv_r, *uargs, tu, ff_x, attn_out=comb_r,
                                               **akw)
            o_s = nsa_decode_fused.decode_attend_fused(rq, kv_s, *uargs, tt, ff_x,
                                                       attn_out=comb_s, **akw)
            torch.cuda.synchronize()
            bits.update({f"out ({label})": torch.equal(o_r, o_s),
                         f"attn_out ({label})": torch.equal(comb_r, comb_s),
                         f"kv ({label})": torch.equal(kv_r, kv_s)})
        print(f"  rows 8-9 at t={tt} for every slot vs rows 6-7: bit-equal {bits}", flush=True)
        check(all(bits.values()), f"rows 8-9 at one position t={tt} give other bits than rows "
              f"6-7: {bits}")

    # ---- row 11: the block gather of the ragged split route ----------------
    # at the engine cell and at the serving batch (64 rows of seeded blocks);
    # the ids as the split route passes them, the first columns of the info
    # rows (a strided view), and contiguous
    clean = kernel_times.Flush(clean=True)
    blk_ids = torch.randint(0, MAX_LEN // Bs, (BATCH, kvh, nsa_decode.INFO_WIDTH),
                            generator=gen, device=DEVICE, dtype=torch.int32)
    gathers = {}
    for label, kv_g, info_g in (("engine", kv, info_p.reshape(b, kvh, -1)),
                                (f"bs {BATCH}", randn(BATCH, kvh, MAX_LEN, 2 * d), blk_ids)):
        rows_g = kv_g.shape[0]
        view = info_g[..., :n_slots]
        idx = view.contiguous()
        before = paged_gather.paged_gather.launches
        gk, gv = paged_gather.paged_gather(kv_g, idx, Bs), paged_gather.paged_gather(kv_g, view, Bs)
        gp = paged_gather.paged_gather_plain(kv_g, idx, Bs)
        blocks = kv_g.view(rows_g, kvh, MAX_LEN // Bs, Bs, 2 * d)
        bi = torch.arange(rows_g, device=DEVICE)[:, None, None]
        hi, il = torch.arange(kvh, device=DEVICE)[None, :, None], idx.long()
        lib = blocks[bi, hi, il]
        wrong = idx.clone()
        wrong[0, 0, 0] = (wrong[0, 0, 0].clamp(0, MAX_LEN // Bs - 1) + 1) % (MAX_LEN // Bs)
        torch.cuda.synchronize()
        check(paged_gather.paged_gather.launches == before + 2,
              "paged_gather: one launch a call")
        check(torch.equal(gk, gp) and torch.equal(gk, lib.reshape(gk.shape))
              and torch.equal(gv, gk), f"paged_gather ({label}) is not the blocks it was asked for")
        check(not torch.equal(gk, paged_gather.paged_gather_plain(kv_g, wrong, Bs)),
              f"paged_gather ({label}): the wrong-id control gives the same bits")
        geo = kernel_times.launch_args(lambda: paged_gather.paged_gather(kv_g, view, Bs))
        print(f"  paged_gather {label}, {rows_g} rows x {kvh} heads x {n_slots} blocks of {Bs} "
              f"rows: equal to its plain version and to advanced indexing, the strided id view "
              f"too; one id moved one block on gives other bits; launch "
              + "; ".join(", ".join(f"{k} {x[k]}" for k in ("name", *kernel_times.LAUNCH_KEYS))
                          for x in geo), flush=True)
        bms, by = bound_ms(2 * nbytes(gk) + nbytes(idx), 0)
        g = {"name": "paged_gather", "route": "cuda",
             "source": "nsa_tpu_torch/csrc/paged_gather.cu",
             "replaces": "nsa_tpu/ops/pallas/paged_gather.py:73", "max_abs_err": 0.0,
             **breakdown(f"paged_gather {label}",
                         lambda: paged_gather.paged_gather(kv_g, view, Bs), flush),
             "plain_ms": timed_ms(lambda: paged_gather.paged_gather_plain(kv_g, idx, Bs), 10,
                                  flush),
             "bound_ms": bms, "bound_by": by, "launch": geo,
             "library_ms": kernel_times.launch_breakdown(lambda: blocks[bi, hi, il],
                                                         flush)["device_ms"]}
        # the same under the clean-cold flush: L2 full of clean lines
        g["clean_ms"] = kernel_times.launch_breakdown(
            lambda: paged_gather.paged_gather(kv_g, view, Bs), clean)["device_ms"]
        g["library_clean_ms"] = kernel_times.launch_breakdown(lambda: blocks[bi, hi, il],
                                                              clean)["device_ms"]
        print(f"  paged_gather {label}: device {g['ms']:.4f} ms under the zeroing flush, "
              f"{g['clean_ms']:.4f} under the clean-cold one; advanced indexing "
              f"{g['library_ms']:.4f} / {g['library_clean_ms']:.4f}; bound {bms:.5f} ms",
              flush=True)
        gathers[label] = g
    del clean
    gat = gathers["engine"]
    gat["bs64"] = {k: v for k, v in gathers[f"bs {BATCH}"].items()
                   if k.endswith("ms") or k == "launch"}
    regs, spill = kernel_times.ptxas_usage(log, "paged_gather_kernelILi256E", "paged_gather_cu")
    gat.update(registers=regs, spill_bytes=spill)
    print(f"  paged_gather ptxas: {regs} registers, spills (stores, loads) {spill}", flush=True)
    for k in (sel, att, pag, gat):
        print(f"  {k['name']} {b} slots: {k['ms']:.4f} ms (bound {k['bound_ms']:.5f} ms, by "
              f"{k['bound_by']}); plain {k['plain_ms']:.4f} ms; library {k['library_ms']}",
              flush=True)
    return sel, att, pag, gat


def kernel_decode(gen, flush, cfg, log):
    """Rows 2 and 3 at the serving cell (bs 64, t = 3999, seeded inputs):
    row 2's c_out within TOL_OUT and element by element under
    ``select_tolerance``, with a dropped-chunk control that must fail it,
    its selected ids equal to the plain version's but for ties; row 3's
    output within TOL_OUT and under ``attend_tolerance``, with a
    dropped-block control that must fail it; second launches bit for bit;
    each kernel's launch geometry and ptxas registers / spills."""
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
    R = nsa_decode_ragged

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    q, ckv, mem_kv = randn(b, kvh, g, d), randn(b, kvh, Wc, 2 * d), randn(2, kvh, M, d)
    kw = dict(max_blocks=MAX_LEN // Bs, stride=stride, sel_block=Bs, num_sel=num_sel,
              n_slide=n_slide, scale=scale)
    pt = device_t(t)                              # the kernels read t on the device
    c_k, info_k = nsa_decode.decode_select(q, ckv, mem_kv, pt, num_cb, **kw)
    c_2, info_2 = nsa_decode.decode_select(q, ckv, mem_kv, pt, num_cb, **kw)
    c_p, info_p = nsa_decode.decode_select_plain(q, ckv, mem_kv, t, num_cb, **kw)
    _, scores = nsa_decode.select_scores_plain(q, ckv, mem_kv, num_cb, t, stride=stride,
                                               sel_block=Bs, scale=scale)
    skw = dict(stride=stride, sel_block=Bs, scale=scale)
    want, tol = R.select_tolerance(q, ckv, mem_kv, t, num_cb, **skw)
    # the control: c_out with the first 64 live rows left out
    moved, live = R.without_live_chunk(ckv, num_cb)
    wrong, _ = nsa_decode.select_scores_plain(q, moved, mem_kv, live, t,
                                              weights_dtype=torch.float32, **skw)
    torch.cuda.synchronize()
    n_slots = num_sel + n_slide
    err_c = max_err(c_k, c_p)
    ties = check_selection(info_k, info_p, scores, num_sel, n_slide, "decode_select")
    vp = info_p[..., n_slots:n_slots + num_sel]
    ratio = ((c_k.float() - want.float()).abs() / tol).max().item()
    ratio_ctl = ((wrong.float() - want.float()).abs() / tol).max().item()
    same2 = torch.equal(c_2, c_k) and torch.equal(info_2, info_k)
    geometry = kernel_times.split_geometry(log)
    for name, x in geometry.items():
        print(f"  {name} launch: grid {x['grid']} of 256 threads, {x['blocks_per_sm']} block(s) "
              f"fit an SM, shared memory {x['smem_bytes']} B a block (card limit "
              f"{x['smem_optin']}); ptxas: {x['registers']} registers, spills (stores, loads) "
              f"{x['spill_bytes']}", flush=True)
    print(f"  decode_select max|err| c_out {err_c:.5f} (tol {TOL_OUT}); worst |err| / "
          f"select_tolerance {ratio:.4f} (<= 1), the dropped-chunk control {ratio_ctl:.1f} (> 1); "
          f"ids equal on {b * kvh - ties}/{b * kvh} rows, {ties} rows differ only by ties within "
          f"{TIE}; a second launch bit-equal: {same2}", flush=True)
    check(err_c <= TOL_OUT and bool(torch.isfinite(c_k.float()).all()),
          "decode_select c_out disagrees")
    check(ratio <= 1.0, "decode_select: c_out breaks select_tolerance")
    check(ratio_ctl > 1.0, "decode_select: the dropped-chunk control passes select_tolerance")
    check(same2, "decode_select: a second launch gives other bits")
    rows_read = b * kvh * num_cb * 2 * d * 2
    bms, by = bound_ms(nbytes(q, mem_kv, c_k, info_k) + rows_read,
                       b * kvh * g * (num_cb + M) * 4 * d)
    sel = {"name": "decode_select", "route": "cuda",
           "source": "nsa_tpu_torch/csrc/nsa_decode.cu",
           "replaces": "nsa_tpu/ops/pallas/nsa_decode.py:195",
           "max_abs_err": err_c, "select_tolerance_ratio": ratio, "control_ratio": ratio_ctl,
           "ms": timed_ms(lambda: nsa_decode.decode_select(q, ckv, mem_kv, pt, num_cb, **kw),
                          50, flush),
           "plain_ms": timed_ms(lambda: nsa_decode.decode_select_plain(
               q, ckv, mem_kv, t, num_cb, **kw), 10, flush),
           "bound_ms": bms, "bound_by": by, "library_ms": None,
           **geometry["decode_select"]}

    # attend: both versions get the same info, c_out and gates
    rq, kv = randn(b, kvh, g, d), randn(b, kvh, MAX_LEN, 2 * d)
    gates = torch.sigmoid(randn(b, kvh, g, 3).float()).to(torch.bfloat16)
    akw = dict(sel_block=Bs, window=window, num_sel=num_sel, n_slide=n_slide, scale=scale)
    out_k = nsa_decode.decode_attend(rq, kv, info_p, c_p, gates, pt, **akw)
    out_2 = nsa_decode.decode_attend(rq, kv, info_p, c_p, gates, pt, **akw)
    out_p = nsa_decode.decode_attend_plain(rq, kv, info_p, c_p, gates, t, **akw)
    want, tol = R.attend_tolerance(rq, kv, info_p, c_p, gates, t, **akw)
    # the control: each row's first selected block left out
    dropped = R.without_first_selected(info_p, num_sel, n_slide)
    wrong, _ = R.attend_tolerance(rq, kv, dropped, c_p, gates, t, **akw)
    torch.cuda.synchronize()
    err_a = max_err(out_k, out_p)
    ratio = ((out_k.float() - want.float()).abs() / tol).max().item()
    ratio_ctl = ((wrong.float() - want.float()).abs() / tol).max().item()
    same2 = torch.equal(out_2, out_k)
    print(f"  decode_attend max|err| {err_a:.5f} (tol {TOL_OUT}); worst |err| / "
          f"attend_tolerance {ratio:.4f} (<= 1), the dropped-block control {ratio_ctl:.1f} "
          f"(> 1); a second launch bit-equal: {same2}", flush=True)
    check(err_a <= TOL_OUT and torch.isfinite(out_k.float()).all().item(),
          "decode_attend disagrees")
    check(ratio <= 1.0, "decode_attend: the output breaks attend_tolerance")
    check(ratio_ctl > 1.0, "decode_attend: the dropped-block control passes attend_tolerance")
    check(same2, "decode_attend: a second launch gives other bits")
    rows = attend_rows(vp, t, Bs, n_slide, window, b * kvh)
    bms, by = bound_ms(nbytes(rq, info_p, c_p, gates, out_k) + rows * 2 * d * 2,
                       rows * g * 4 * d)
    att = {"name": "decode_attend", "route": "cuda",
           "source": "nsa_tpu_torch/csrc/nsa_decode.cu",
           "replaces": "nsa_tpu/ops/pallas/nsa_decode.py:325",
           "max_abs_err": err_a, "attend_tolerance_ratio": ratio, "control_ratio": ratio_ctl,
           "ms": timed_ms(lambda: nsa_decode.decode_attend(rq, kv, info_p, c_p, gates, pt,
                                                           **akw), 50, flush),
           "plain_ms": timed_ms(lambda: nsa_decode.decode_attend_plain(
               rq, kv, info_p, c_p, gates, t, **akw), 10, flush),
           "bound_ms": bms, "bound_by": by, "library_ms": None,
           **geometry["decode_attend"]}
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
    """Count the ragged decode steps (the single steps, and each window's
    tokens: a captured window replays its step without calling the step
    function) and prefill waves of engine runs, and run every multi-token
    window, its capture included, under ``set_sync_debug_mode("error")``:
    a host sync inside one raises."""

    NAMES = ("ragged_decode_step", "ragged_decode_step_paged", "wave_prefill",
             "ragged_decode_multi")

    def __enter__(self):
        self.steps = self.waves = self.windows = 0
        self.real = tuple(getattr(serve, n) for n in self.NAMES)
        step, step_paged, wave, multi = self.real

        def counted(fn):
            def run(*a, **k):
                self.steps += 1
                return fn(*a, **k)
            return run

        def counted_wave(*a, **k):
            self.waves += 1
            return wave(*a, **k)

        def no_sync_multi(*a, **k):
            self.windows += 1
            self.steps += a[5]                   # num_steps
            torch.cuda.set_sync_debug_mode("error")
            try:
                return multi(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode("default")

        for n, fn in zip(self.NAMES, (counted(step), counted(step_paged), counted_wave,
                                      no_sync_multi)):
            setattr(serve, n, fn)
        return self

    def __exit__(self, *exc):
        for n, fn in zip(self.NAMES, self.real):
            setattr(serve, n, fn)


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


@contextlib.contextmanager
def emitting_slots(cfg):
    """Records, for every ragged select-emit call of the layer, how many of
    its slots emit (a device tensor each, so no host sync inside a
    window); the engine's step calls it once a layer.  It adds launches:
    the run it wraps is not timed."""
    real = nsa_layer.decode_select_emit_ragged
    signature = inspect.signature(real)
    stride = cfg.nsa.compress_block_sliding_stride
    counts = []

    def recording(*a, **k):
        args = signature.bind(*a, **k).arguments
        counts.append(nsa_decode_ragged.ragged_emits(args["t"], args["num_cb"], stride).sum())
        return real(*a, **k)

    nsa_layer.decode_select_emit_ragged = recording
    try:
        yield counts
    finally:
        nsa_layer.decode_select_emit_ragged = real


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
    # the emitting slots a ragged step, counted in one more dense run (the
    # count adds launches to every step, so the timed runs above go without;
    # eager, since a captured window would record only its capture)
    with emitting_slots(cfg) as emitting:
        counted, *_ = run_engine(params, cfg, reqs, steps_per_sync=SERVE_SYNC, capture=False)
    check(all(np.array_equal(a, b) for a, b in zip(counted, runs["dense"]["tokens"])),
          "the counted engine run gives other tokens")
    emit_counts = torch.stack(emitting[::L]).cpu() if emitting else torch.zeros(0)
    m["emitting_slots"] = {
        "steps": len(emit_counts), "steps_with_an_emitting_slot": int((emit_counts > 0).sum()),
        "mean_emitting_slots": emit_counts.float().mean().item() if len(emit_counts) else 0.0,
        "histogram": torch.bincount(emit_counts.long(), minlength=1).tolist()}
    print(f"  serve: ragged steps with an emitting slot "
          f"{m['emitting_slots']['steps_with_an_emitting_slot']} of {len(emit_counts)}; "
          f"emitting slots a step: mean {m['emitting_slots']['mean_emitting_slots']:.3f}, steps "
          f"by count {m['emitting_slots']['histogram']}", flush=True)
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
    from torch.autograd import DeviceType

    device = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and _dev_us(e) > 0]
    device_ms = sum(_dev_us(e) for e in device) / 1e3 / 5
    rows_ms = {row: sum(_dev_us(e) for e in device if any(k in e.key for k in names)) / 1e3 / 5
               for row, names in RAGGED_STEP_KERNELS.items()}
    print(f"  rows 8-10 in a ragged step: row 8 {rows_ms['row 8']:.4f} ms, row 9 "
          f"{rows_ms['row 9']:.4f} ms, of {device_ms:.4f} ms device time "
          f"({100 * sum(rows_ms.values()) / device_ms:.1f}%); {smi}", flush=True)
    m.update({"ragged_step_device_busy": busy, "ragged_step_device_records": records,
              "ragged_step_ms_profiled": wall / 5 * 1e3, "ragged_step_device_ms": device_ms,
              "ragged_step_rows_ms": rows_ms})
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


def shifted_label_ppl(params, cfg, tokens, seq_len, batch_size=8):
    """The perplexity gates' control: ``compute_ppl``'s windows through the
    kernel path with every label one byte late (position j scored on byte
    j + 2 where it lies in the window)."""
    windows, valids = ppl_windows(tokens, seq_len)
    total, count = 0.0, 0
    for i in range(0, len(windows), batch_size):
        w = torch.from_numpy(np.stack(windows[i:i + batch_size])).to(DEVICE)
        v = torch.from_numpy(np.stack(valids[i:i + batch_size])).to(DEVICE)[:, 1:]
        logp = torch.log_softmax(transformer_forward(params, cfg, w[:, :-2]).float(), -1)
        total += float(-(logp.gather(-1, w[:, 2:, None])[..., 0] * v).sum())
        count += int(v.sum())
    return math.exp(total / count)


def ppl_gate(label, got, ref, tol, control):
    """|got / ref - 1| <= tol, and the control's |control / ref - 1| above it."""
    rel, rel_c = abs(got / ref - 1), abs(control / ref - 1)
    print(f"  {label}: {got:.6f} vs {ref:.6f}, rel {rel:.3e} (tol {tol:.0e}); control (labels "
          f"one byte late) {control:.6f}, rel {rel_c:.3e}", flush=True)
    check(rel_c > tol, f"{label}: the shifted-label control passes the gate")
    check(rel <= tol, f"{label}: rel {rel:.3e} over {tol:.0e}")
    return rel


def eval_phase(sparse_params, sparse_cfg, sparse_step, smi):
    """The evaluation suite (``nsa_tpu_torch.eval``) on the trained sparse
    and full weights in bf16: ``run_ppl_eval`` at seq 4096 (ID and OOD) with
    launch counts; the three perplexity gates, each with a shifted-label
    control; ``generate_samples`` with bit-equal repeats and the first
    step's logits against the plain path; ``run_efficiency_sweep`` with
    launch counts.  Every CSV and the corpus land in a temporary directory.
    Returns the launch counts of each run and the metrics."""
    full_params, meta = load_params_npz(FULL_WEIGHTS, device="cuda", dtype=torch.bfloat16)
    full_cfg = model_config_from_meta(meta).replace(dtype="bfloat16")
    models = {"sparse_mlp": (fuse_decode_params(sparse_params, sparse_cfg), sparse_cfg,
                             sparse_step, "prefill_fwd"),
              "full_attn": (fuse_decode_params(full_params, full_cfg), full_cfg,
                            meta.get("step", 0), "flash_attention")}
    none = {fn.__name__: 0 for fn in ALL_KERNELS}
    launches, m = {}, {}
    here = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            t0 = time.perf_counter()
            _, val = load_byte_corpus(DataConfig(path=os.path.join(tmp, "enwik8.gz"),
                                                 synthetic_bytes=CORPUS_BYTES))
            ood = load_cs441_qa_bytes()
            print(f"  corpus: {CORPUS_BYTES} synthetic bytes ({time.perf_counter() - t0:.1f}s; "
                  f"{smi}), val {len(val)}; OOD {len(ood)} QA bytes", flush=True)
            batches = sum(-(-len(ppl_windows(x, EVAL_SEQ)[0]) // 8)
                          for x in (val[:EVAL_ID_TOKENS], ood))
            for name, (params, cfg, step, prefill_kernel) in models.items():
                mm = m[name] = {}
                csv_path = os.path.join(tmp, f"ppl_seq{EVAL_SEQ}.csv")
                zero_launches(ALL_KERNELS)
                t0 = time.perf_counter()
                row = run_ppl_eval(params, cfg, name, EVAL_SEQ, val, ood, csv_path=csv_path,
                                   step=step, max_id_tokens=EVAL_ID_TOKENS, device=DEVICE)
                wall = time.perf_counter() - t0
                got = launches[f"{name} ppl"] = read_launches(ALL_KERNELS)
                want = {**none, prefill_kernel: cfg.depth * batches}
                print(f"  {name} ppl (seq {EVAL_SEQ}): {row} in {wall:.2f}s; launches "
                      f"{ {k: v for k, v in got.items() if v} }; {smi}", flush=True)
                check(got == want, f"{name} ppl launches {got}, expected {want}")
                check(row["tokens_id"] == EVAL_ID_TOKENS - 1 and math.isfinite(row["ppl_id"])
                      and math.isfinite(row["ppl_ood"]) and row["tokens_ood"] == len(ood) - 1,
                      f"{name} ppl row malformed: {row}")
                mm.update(row=row, ppl_s=wall)

                # gate 1: the kernel path against the plain path on the same windows
                ppl_k = compute_ppl(params, cfg, val, EVAL_SEQ, max_tokens=EVAL_ID_TOKENS,
                                    device=DEVICE)[0]
                check(round(ppl_k, 4) == row["ppl_id"], f"{name}: a second kernel-path run "
                      f"gives {ppl_k}, the row {row['ppl_id']}")
                ppl_p = compute_ppl(params, cfg, val, EVAL_SEQ, max_tokens=EVAL_ID_TOKENS,
                                    use_kernels=False, device=DEVICE)[0]
                control = shifted_label_ppl(params, cfg, val[:EVAL_ID_TOKENS], EVAL_SEQ)
                mm["kernel_vs_plain_rel"] = ppl_gate(f"{name} ID ppl, kernels vs plain", ppl_k,
                                                     ppl_p, TOL_PPL_PLAIN, control)

                # gate 2: the incremental path against the dense one on one window
                window = val[:EVAL_SEQ + 1]
                zero_launches(ALL_KERNELS)
                s_ev = torch.cuda.Event(enable_timing=True)
                e_ev = torch.cuda.Event(enable_timing=True)
                s_ev.record()
                ppl_i, n_i = compute_ppl_incremental(params, cfg, window, EVAL_SEQ,
                                                     max_tokens=None, device=DEVICE)
                e_ev.record()
                got = launches[f"{name} incremental"] = read_launches(ALL_KERNELS)
                inc_s = s_ev.elapsed_time(e_ev) / 1e3
                want = {**none, prefill_kernel: cfg.depth}
                if cfg.use_sparse_attn:
                    want["decode_step_mega"] = EVAL_SEQ - 1
                print(f"  {name} incremental ppl: {ppl_i:.6f} over {n_i} bytes in {inc_s:.3f}s "
                      f"({n_i / inc_s:.1f} steps/s); launches "
                      f"{ {k: v for k, v in got.items() if v} }; {smi}", flush=True)
                check(got == want, f"{name} incremental launches {got}, expected {want}")
                ppl_d, n_d = compute_ppl(params, cfg, window, EVAL_SEQ, max_tokens=None,
                                       device=DEVICE)
                check(n_i == n_d == EVAL_SEQ, f"{name}: counts {n_i} / {n_d}")
                control = shifted_label_ppl(params, cfg, window, EVAL_SEQ)
                mm["incremental_vs_dense_rel"] = ppl_gate(
                    f"{name} incremental vs dense ppl", ppl_i, ppl_d, TOL_PPL_INCREMENTAL, control)
                mm.update(incremental_s=inc_s, ppl_incremental=ppl_i, ppl_dense_window=ppl_d)
                # the captured loop against the same steps eager
                short = val[:EVAL_EAGER_BYTES]
                eager = compute_ppl_incremental(params, cfg, short, EVAL_SEQ, max_tokens=None,
                                                capture=False, device=DEVICE)
                captured = compute_ppl_incremental(params, cfg, short, EVAL_SEQ, max_tokens=None,
                                                   device=DEVICE)
                print(f"  {name} incremental on {EVAL_EAGER_BYTES} bytes, eager {eager} / "
                      f"captured {captured}: equal {eager == captured}", flush=True)
                check(eager == captured, f"{name}: the captured incremental loop differs from "
                      "the eager one")

                # gate 3: the card against nsa_tpu's float32 compute_ppl of the same bytes
                two = val[:2 * EVAL_SEQ + 1]
                ppl_2, n_2 = compute_ppl(params, cfg, two, EVAL_SEQ, max_tokens=None, device=DEVICE)
                check(n_2 == 2 * EVAL_SEQ, f"{name}: {n_2} bytes predicted")
                control = shifted_label_ppl(params, cfg, two, EVAL_SEQ)
                mm["vs_jax_float32_rel"] = ppl_gate(
                    f"{name} ppl of val[:{2 * EVAL_SEQ + 1}] vs nsa_tpu float32 (CPU)", ppl_2,
                    JAX_PPL_TWO_WINDOWS[name], TOL_PPL_JAX, control)
                mm["ppl_two_windows"] = ppl_2

                # generation: greedy samples, repeated bit for bit
                snippet = val[:64]
                zero_launches(ALL_KERNELS)
                gen_row = generate_samples(params, cfg, name, gen_len=EVAL_GEN,
                                           id_snippet=snippet, step=step,
                                           csv_path=os.path.join(tmp, "generation.csv"),
                                           device=DEVICE)
                got = launches[f"{name} generate"] = read_launches(ALL_KERNELS)
                want = {**none, prefill_kernel: 2 * cfg.depth}
                if cfg.use_sparse_attn:
                    want["decode_step_mega"] = 2 * EVAL_GEN
                print(f"  {name} generation launches { {k: v for k, v in got.items() if v} }",
                      flush=True)
                check(got == want, f"{name} generation launches {got}, expected {want}")
                for key, prompt in (("id", snippet), ("ood", np.frombuffer(
                        gen_row["ood_prompt"].encode(), np.uint8))):
                    a = greedy_continuation(params, cfg, prompt, EVAL_GEN, device=DEVICE)
                    b = greedy_continuation(params, cfg, prompt, EVAL_GEN, device=DEVICE)
                    print(f"  {name} {key} prompt {gen_row[key + '_prompt']!r}\n"
                          f"    -> {gen_row[key + '_generation']!r}", flush=True)
                    check(np.array_equal(a, b), f"{name} {key}: a second call gives other tokens")
                    check(decode_bytes(a) == gen_row[key + "_generation"],
                          f"{name} {key}: generate_samples' row differs from the tokens")
                ids = torch.from_numpy(snippet.astype(np.int64))[None].to(DEVICE)
                logits, cache = transformer_prefill(params, cfg, ids,
                                                    default_max_len(cfg, len(snippet) + EVAL_GEN))
                first = logits[:, -1].argmax(-1)
                plain_cache = clone_cache(cache)
                step_k = transformer_decode_step(params, cfg, first, cache)[0]
                step_p = transformer_decode_step(params, cfg, first, plain_cache,
                                                 use_kernels=False)[0]
                err, scale = max_err(step_k, step_p), step_p.abs().max().item()
                print(f"  {name} generation, first step's logits vs plain max|err| {err:.4f} "
                      f"(tol {TOL_LOGITS_REL} x max|logit| {scale:.2f})", flush=True)
                check(err <= TOL_LOGITS_REL * max(scale, 1.0),
                      f"{name}: the generation step's logits disagree with the plain path")
                mm.update(generation=gen_row, first_step_logits_max_abs_err=err)
                del cache, plain_cache

                # the efficiency sweep
                zero_launches(ALL_KERNELS)
                t0 = time.perf_counter()
                rows = run_efficiency_sweep(params, cfg, name, EVAL_SWEEP_BATCHES,
                                            EVAL_SWEEP_PROMPTS, GEN, seq_len=MAX_LEN,
                                            csv_path=os.path.join(tmp, "efficiency.csv"),
                                            step=step, device=DEVICE,
                                            log=lambda line: print(f"  {line}; {smi}",
                                                                   flush=True))
                wall = time.perf_counter() - t0
                got = launches[f"{name} sweep"] = read_launches(ALL_KERNELS)
                runs = 4 * len(EVAL_SWEEP_PROMPTS)      # warm-up + 3 timed, each prompt
                want = {**none, prefill_kernel: runs * len(EVAL_SWEEP_BATCHES) * cfg.depth}
                if cfg.use_sparse_attn:
                    small = [b for b in EVAL_SWEEP_BATCHES if use_mega_decode(cfg, b)]
                    want["decode_step_mega"] = runs * len(small) * GEN // MEGA_STEPS
                    split = runs * (len(EVAL_SWEEP_BATCHES) - len(small)) * GEN * cfg.depth
                    want.update(decode_select=split, decode_attend=split)
                print(f"  {name} sweep in {wall:.1f}s; launches "
                      f"{ {k: v for k, v in got.items() if v} }; {smi}", flush=True)
                check(got == want, f"{name} sweep launches {got}, expected {want}")
                check(len(rows) == len(EVAL_SWEEP_BATCHES) * len(EVAL_SWEEP_PROMPTS)
                      and all(r["max_len"] == MAX_LEN and r["decode_tokens_per_s"] > 0
                              and r["prefill_tokens_per_s"] > 0 for r in rows),
                      f"{name} sweep rows malformed")
                mm.update(sweep=rows, sweep_s=wall)
            print("  " + ppl_markdown_table(os.path.join(tmp, f"ppl_seq{EVAL_SEQ}.csv"))
                  .replace("\n", "\n  "), flush=True)
            with open(os.path.join(tmp, "efficiency.csv")) as f:
                print("  efficiency.csv (" + smi + "):\n    " + f.read().strip()
                      .replace("\n", "\n    "), flush=True)
        finally:
            os.chdir(here)
    del full_params, models
    return launches, m


# the kernels of a captured step, by a piece of their device name: the
# wrapper that launches each, and how many a step launches ("depth": one a
# layer); the full model's step runs none of the port's kernels
GRAPH_KERNELS = {
    "split": {"select_kernel<": ("decode_select", "depth"),
              "attend_kernel<": ("decode_attend", "depth")},
    "mega": {"mega_kernel<": ("decode_step_mega", 1)},
    "ragged": {"emit_partial_ragged_kernel": ("decode_select_emit_ragged", "depth"),
               "select_emit_ragged_kernel": ("decode_select_emit_ragged", "depth"),
               "attend_persistent_kernel": ("decode_attend_fused_ragged", "depth")},
    "full": {},
}
GRAPH_TURNS = ("eager", "captured", "captured", "eager")
PROFILE_PAD_S = 0.05   # host idle seconds at each end of a profile_run window


def profile_run(fn, label, per):
    """torch.profiler over ``fn()``: (the profile, its wall seconds, the
    device's busy share, device records per ``per``).  The host idles
    PROFILE_PAD_S inside the profiler's window before and after the run:
    without it the profiler can lose the device records of a run's first
    few milliseconds (on the H100, the first of 5 whole-model replays)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        time.sleep(PROFILE_PAD_S)
    busy, records = _report(prof, label, wall, per=per, top=5)
    return prof, wall, busy, records


def replayed_kernels(run, kind, depth, per, label):
    """Profile ``run()``, ``per`` replays of a kept graph (a few: a profile
    of thousands of records may drop some), and hold each kernel of the
    step (``GRAPH_KERNELS[kind]``) to the device's own record: its device
    records a replay, the step's launches, and its wrapper's counter a
    replay (what the graph adds on each replay) are one number, and no
    other wrapper counts."""
    from torch.autograd import DeviceType

    zero_launches(ALL_KERNELS)
    prof = profile_run(run, f"{label}: {per} replays of the captured step", per)[0]
    counters = read_launches(ALL_KERNELS)
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    seen = {k: sum(k in n for n in names) / per for k in GRAPH_KERNELS[kind]}
    want = {k: depth if n == "depth" else n for k, (_, n) in GRAPH_KERNELS[kind].items()}
    counted = {k: counters[fn] / per for k, (fn, _) in GRAPH_KERNELS[kind].items()}
    others = {k: v for k, v in counters.items()
              if v and k not in {fn for fn, _ in GRAPH_KERNELS[kind].values()}}
    print(f"  {label}: device records a replay {seen}; launches a step {want}; counters a "
          f"replay {counted}", flush=True)
    check(seen == want == counted and not others,
          f"{label}: a replay's device record {seen}, counters {counted}, others {others}, "
          f"expected {want}")


def decode_turns(label, run, reset, per_run, check_launches):
    """``run(capture)`` in GRAPH_TURNS from ``reset()``: the tokens and the
    caches each leaves (``run`` returns them) equal the first turn's bit
    for bit, the launches counted each turn are ``check_launches``'s, and
    each turn's wall time, tok/s and peak memory are kept."""
    ref, out, order = None, {"eager": [], "captured": []}, []
    for mode in GRAPH_TURNS:
        reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launches(ALL_KERNELS)
        t0 = time.perf_counter()
        toks, caches = run(mode == "captured")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches(ALL_KERNELS)
        check_launches(launches, f"{label} {mode}")
        if ref is None:
            ref = (toks, [x.clone() for x in caches])
        else:
            check(torch.equal(toks, ref[0]), f"{label}: {mode} tokens differ from eager's")
            check(all(torch.equal(x, y) for x, y in zip(caches, ref[1])),
                  f"{label}: {mode} caches differ from eager's")
        out[mode].append({"wall_s": wall, "tok_s": per_run / wall,
                          "peak_bytes": torch.cuda.max_memory_allocated()})
        order.append(out[mode][-1])
    tps = " / ".join(f"{r['tok_s']:.1f}" for r in order)
    peaks = " / ".join(f"{r['peak_bytes'] / 2**30:.2f}" for r in order)
    print(f"  {label} tok/s in turns {' / '.join(GRAPH_TURNS)}: {tps} (the first captured "
          f"turn captures its graph); peak GiB {peaks}; tokens and caches equal in every "
          f"turn", flush=True)
    del ref
    return out


def step_logits(params, cfg, token, run, route, capture, n=3):
    """The logits of ``n`` decode steps at a device position from ``run``'s
    cache, as one loop (eager, or a captured graph replayed): the last
    step's logits, copied out."""
    def body(s):
        lg, _ = transformer_decode_step(params, cfg, s["token"], run, route=route, pos=s["pos"])
        s["logits"].copy_(lg)
        s["token"].copy_(lg.argmax(-1))
        s["pos"].add_(1)

    state = {"token": token.clone(), "pos": torch.full((), run.seq_len, dtype=torch.int32,
                                                       device=DEVICE),
             "logits": torch.zeros((token.shape[0], cfg.vocab_size), device=DEVICE)}
    return decode_graph.decode_loop(state, body, n, reads=(params, run.layers),
                                    opts=(cfg, route), capture=capture)["logits"].clone()


def graph_phase(sparse_params, sparse_cfg, smi):
    """The decode loops as captured CUDA graphs against the same steps
    eager, in turns (eager, captured, captured, eager) in this call: the
    serving cell on the sparse and the full model, bs 8 on the whole-model
    kernel (greedy at 1 and MEGA_STEPS tokens a launch, tempered at one),
    and the 48-request engine on the dense and the paged pool.  Tokens and
    caches equal, launch counts equal, logits compared, one profiled run
    of replays against the device's record, tok/s, busy shares and peak
    memory.  Returns the metrics."""
    full_params, meta = load_params_npz(FULL_WEIGHTS, device="cuda", dtype=torch.bfloat16)
    full_cfg = model_config_from_meta(meta).replace(dtype="bfloat16")
    models = {"sparse": (fuse_decode_params(sparse_params, sparse_cfg), sparse_cfg),
              "full": (fuse_decode_params(full_params, full_cfg), full_cfg)}
    none = {fn.__name__: 0 for fn in ALL_KERNELS}
    m = {}

    # the serving cell: GEN greedy steps at bs 64, sparse and full
    for name, (params, cfg) in models.items():
        L = cfg.depth
        ids = seeded_ids(BATCH, PROMPT, cfg.vocab_size, SEED, DEVICE)
        logits, cache = transformer_prefill(params, cfg, ids, MAX_LEN)
        first = logits[:, -1].argmax(-1)
        run = clone_cache(cache)
        del logits
        want = dict(none, **({"decode_select": L * GEN, "decode_attend": L * GEN}
                             if cfg.use_sparse_attn else {}))

        def launches_ok(launches, label, want=want):
            check(launches == want, f"{label}: launches {launches}, expected {want}")

        turns = decode_turns(
            f"{name} bs {BATCH} greedy", lambda cap: (
                greedy_decode(params, cfg, first, run, GEN, capture=cap),
                [x for lc in run.layers for x in lc]),
            lambda: copy_cache(run, cache), BATCH * GEN, launches_ok)
        # logits: three steps eager and captured from the same cache
        outs = {}
        for cap in (False, True):
            copy_cache(run, cache)
            outs[cap] = step_logits(params, cfg, first, run, None, cap)
        bit_equal = torch.equal(outs[True], outs[False])
        err, top = max_err(outs[True], outs[False]), outs[False].abs().max().item()
        same_argmax = torch.equal(outs[True].argmax(-1), outs[False].argmax(-1))
        print(f"  {name} bs {BATCH}: the third step's logits captured vs eager bit-equal: "
              f"{bit_equal} (max|err| {err:.6f}, tol {TOL_LOGITS_REL} x {top:.2f}; argmax "
              f"equal {same_argmax})", flush=True)
        check(bit_equal or (err <= TOL_LOGITS_REL * max(top, 1.0) and same_argmax),
              f"{name}: captured logits disagree with eager")
        # a profiled run of replays against the device's record (a 5-step
        # loop, captured first), the busy share of the turns' kept GEN-step
        # graph, and the eager steps' beside it
        copy_cache(run, cache)
        greedy_decode(params, cfg, first, run, 5)
        replayed_kernels(lambda: greedy_decode(params, cfg, first, run, 5),
                         "split" if cfg.use_sparse_attn else "full", L, 5, f"{name} bs {BATCH}")
        copy_cache(run, cache)
        _, wall, busy, _ = profile_run(lambda: greedy_decode(params, cfg, first, run, GEN),
                                       f"{name} bs {BATCH}: {GEN} replays", GEN)
        step_s = wall / GEN
        _, e_wall, e_busy, _ = profile_run(
            lambda: greedy_decode(params, cfg, first, run, 5, capture=False),
            f"{name} bs {BATCH}: 5 eager steps", 5)
        m[f"{name}_bs{BATCH}"] = {
            **turns,
            "logits_bit_equal": bit_equal, "logits_max_abs_err": err,
            "captured_device_busy": busy, "captured_step_ms_profiled": step_s * 1e3,
            "eager_device_busy": e_busy, "eager_step_ms_profiled": e_wall / 5 * 1e3}
        del run, cache
        torch.cuda.empty_cache()
    # the second captured turn of each: replays of the kept graph only
    sparse_tps = m[f"sparse_bs{BATCH}"]["captured"][1]["tok_s"]
    full_tps = m[f"full_bs{BATCH}"]["captured"][1]["tok_s"]
    m["sparse_over_full_captured"] = sparse_tps / full_tps
    print(f"  captured greedy tok/s at bs {BATCH} (replays only): sparse {sparse_tps:.1f}, full "
          f"{full_tps:.1f}, sparse_over_full {sparse_tps / full_tps:.3f} (the benchmark's own "
          f"turns in the full phase); {smi}", flush=True)

    # bs 8 on the whole-model kernel: greedy at 1 and MEGA_STEPS tokens a
    # launch, tempered at one (seeded noise, the same in every turn)
    params, cfg = models["sparse"]
    b = SMALL_BATCHES[0]
    ids = seeded_ids(b, PROMPT, cfg.vocab_size, SEED + b, DEVICE)
    logits, cache = transformer_prefill(params, cfg, ids, MAX_LEN)
    first = logits[:, -1].argmax(-1)
    run = clone_cache(cache)
    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    u = torch.rand((GEN - 1, b, cfg.vocab_size), generator=g, device=DEVICE)
    gumbel = -torch.log(-torch.log(u + 1e-20) + 1e-20)
    for label, launches_a_run, fn in (
            ("greedy, 1 token a launch", GEN, lambda cap: greedy_decode(
                params, cfg, first, run, GEN, capture=cap)),
            (f"greedy, {MEGA_STEPS} tokens a launch", GEN // MEGA_STEPS,
             lambda cap: greedy_decode(params, cfg, first, run, GEN, steps=MEGA_STEPS,
                                       capture=cap)),
            ("tempered 0.8, 1 token a launch", GEN - 1, lambda cap: sample_decode(
                params, cfg, first, run, gumbel, temperature=0.8, capture=cap))):
        want = dict(none, decode_step_mega=launches_a_run)

        def launches_ok(launches, lbl, want=want):
            check(launches == want, f"{lbl}: launches {launches}, expected {want}")

        m[f"mega_bs{b} {label}"] = decode_turns(
            f"bs {b} mega {label}", lambda cap, fn=fn: (fn(cap), [
                x for lc in run.layers for x in lc]), lambda: copy_cache(run, cache),
            b * GEN, launches_ok)
    copy_cache(run, cache)
    greedy_decode(params, cfg, first, run, 5)
    replayed_kernels(lambda: greedy_decode(params, cfg, first, run, 5), "mega", cfg.depth, 5,
                     f"bs {b} mega greedy")
    copy_cache(run, cache)                                      # the turns' kept graph
    busy = profile_run(lambda: greedy_decode(params, cfg, first, run, GEN),
                       f"bs {b} mega greedy: {GEN} replays", GEN)[2]
    m[f"mega_bs{b}_captured_device_busy"] = busy
    del run, cache, logits
    torch.cuda.empty_cache()

    # the 48-request engine, dense and paged, captured against eager
    L = cfg.depth
    reqs = serve_requests(SERVE_REQUESTS)
    for pool, kw, attend in (
            ("dense", {}, "decode_attend_fused_ragged"),
            ("paged", dict(paged_pool_pages=POOL_PAGES, page_tokens=PAGE_TOKENS),
             "decode_attend_fused_paged")):
        outs = {}
        for mode in (("eager", "captured") if pool == "dense" else ("captured", "eager")):
            toks, eng, wall, launches, steps, waves, windows, _ = run_engine(
                params, cfg, reqs, steps_per_sync=SERVE_SYNC, capture=mode == "captured", **kw)
            check_engine_launches(launches, L, steps, waves, attend, f"{pool} pool {mode}")
            new = sum(len(x) for x in toks)
            outs[mode] = toks
            m[f"engine_{pool}_{mode}"] = {"wall_s": wall, "new_tokens_per_s": new / wall,
                                         "ragged_steps": steps, "windows": windows}
            print(f"  engine {pool} {mode}: {new} new tokens in {wall:.3f}s = "
                  f"{new / wall:.1f} new tokens/s, {steps} ragged steps, {windows} windows; "
                  f"{smi}", flush=True)
            del eng
        same = all(np.array_equal(a, b) for a, b in zip(outs["eager"], outs["captured"]))
        print(f"  engine {pool}: every request's tokens captured = eager: {same}", flush=True)
        check(same, f"the {pool} engine's captured windows give other tokens than eager")
    # one profiled window of replays at 16 slots, and the eager window beside it
    eng = serve.ContinuousBatchingEngine(params, cfg, max_batch=SERVE_SLOTS, max_len=MAX_LEN,
                                         prefill_buckets=SERVE_BUCKETS)
    for p, n in reqs[:SERVE_SLOTS]:
        eng.add_request(p, max_new_tokens=n)
    eng._admit()
    args = eng._decode_args()
    serve.ragged_decode_multi(*args, SERVE_SYNC)                 # captures the window
    replayed_kernels(lambda: serve.ragged_decode_multi(*args, SERVE_SYNC), "ragged", L,
                     SERVE_SYNC, f"engine window, {SERVE_SLOTS} slots")
    _, wall, busy, _ = profile_run(lambda: serve.ragged_decode_multi(*args, SERVE_SYNC),
                                   f"engine window, {SERVE_SLOTS} slots: {SERVE_SYNC} replays",
                                   SERVE_SYNC)
    step_s = wall / SERVE_SYNC
    _, e_wall, e_busy, _ = profile_run(
        lambda: serve.ragged_decode_multi(*args, SERVE_SYNC, capture=False),
        f"engine window, {SERVE_SLOTS} slots: {SERVE_SYNC} eager steps", SERVE_SYNC)
    m["engine_window"] = {"captured_device_busy": busy, "captured_step_ms_profiled": step_s * 1e3,
                          "eager_device_busy": e_busy,
                          "eager_step_ms_profiled": e_wall / SERVE_SYNC * 1e3}
    del eng, full_params, models
    decode_graph.clear()
    torch.cuda.empty_cache()
    return m


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

    with torch.no_grad():
        stats = selection_stats(*layer0_prefill_inputs(params, cfg, training_forward)[3:],
                                cfg.nsa.selection_block_size)
    print(f"  layer 0 of the random-init model at {MICRO}x{SEQ}: rows per inverted list "
          f"{stats['rows_per_list']}, union blocks per 16 rows {stats['u16']}", flush=True)
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
        k_pos = max(v for k, v in errs.items() if "k_pos" in k)   # the net sum nearest its gate
        grad_errs[label + " k_pos"] = k_pos
        print(f"  gradients, kernels vs {label}: rel L2 max {errs[worst]:.3e} at {worst} "
              f"(tol {tol}), median {sorted(errs.values())[len(errs) // 2]:.3e} "
              f"over {len(errs)} tensors; k_pos (largest over the layers) {k_pos:.3e}",
              flush=True)
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
    from torch.autograd import DeviceType

    device = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and _dev_us(e) > 0]
    bwd_ms = sum(_dev_us(e) for e in device
                 if "nsa::" in e.key and any(k in e.key for k in BWD_KERNELS)) / 1e3
    device_ms = sum(_dev_us(e) for e in device) / 1e3
    print(f"  rows 4-5 (with the dkv pre-pass) in the micro-step: {bwd_ms:.3f} ms of "
          f"{device_ms:.3f} ms device time ({100 * bwd_ms / device_ms:.1f}%); {smi}", flush=True)
    return launches, {"train_s": train_s, "train_peak_bytes": peak,
                      "train_losses": losses, "measure_train_tok_s": tps,
                      "grad_rel_l2_max": grad_errs["plain path"],
                      "grad_rel_l2_max_bwd_only": grad_errs["kernel forward + plain backward"],
                      "k_pos_rel_l2": grad_errs["plain path k_pos"],
                      "k_pos_rel_l2_bwd_only": grad_errs["kernel forward + plain backward k_pos"],
                      "loss_kernels": lk, "loss_plain": lp,
                      "train_micro_step_device_busy": busy,
                      "train_micro_step_device_ms": device_ms, "train_rows45_ms": bwd_ms,
                      "train_init_selections": stats}


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
        flush = kernel_times.Flush()
        kernels = [*kernel_prefill(gen, flush, cfg, params),
                   *kernel_decode(gen, flush, cfg, lib.log),
                   *kernel_prefill_bwd(gen, flush, cfg, params, lib.log),
                   *kernel_decode_fused(gen, flush, cfg, params, SMALL_BATCHES[0], lib.log),
                   kernel_decode_mega(gen, flush, cfg, fuse_decode_params(params, cfg),
                                      SMALL_BATCHES[0], lib.log),
                   *kernel_decode_ragged(gen, flush, cfg, params, SERVE_SLOTS, lib.log),
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
        pre_err, pre_scale, flipped = prefill_logits_vs_plain(params, cfg, ids)
        print(f"  prefill logits kernels vs plain on the same selections max|err| {pre_err:.4f} "
              f"(tol {TOL_LOGITS_REL} x max|logit| {pre_scale:.2f}); on the plain path's own "
              f"selections {flipped} of {BATCH * PROMPT} positions differ by more", flush=True)
        check(pre_err <= TOL_LOGITS_REL * max(pre_scale, 1.0),
              "kernel-path prefill logits disagree with the plain path")
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
        torch.cuda.empty_cache()
        t0 = phase("full", t0)

        eval_launches, evaluated = eval_phase(params, cfg, meta.get("step", 0), smi)
        torch.cuda.empty_cache()
        t0 = phase("eval", t0)

        graphs = graph_phase(params, cfg, smi)
        del params
        torch.cuda.empty_cache()
        t0 = phase("graph", t0)

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
                         else launches)[k["name"].removesuffix("_trained")]
    print(json.dumps({"main": {
        "prefill_s": prefill_s, "decode_tok_s": BATCH * GEN / decode_s,
        "measure_decode_tok_s": tps, "measure_prefill_tok_s": prefill_tps, "peak_bytes": peak,
        "logits_max_abs_err": err, "decode_device_busy": busy, "small": small,
        "serve": served, "full": full, "eval": evaluated, "eval_launches": eval_launches,
        "graph": graphs, **train,
        "train_launches": train_launches, "phases_s": dict(PHASES)}}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)   # the card's name and power limit, as nvidia-smi gives them
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main()
