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
             time by op and the device's busy share of the wall time.  Then
             the ablation script's cell (``python -m
             nsa_tpu_torch.profile_decode``: the reference model from its
             seed, bs 64 x prompt 128, 50 greedy steps, 4096 rows) in full
             and under each ``NSA_ABLATE`` value: the captured loop against
             the same steps eager, tokens and every cache tensor bit for
             bit; launches (rows 2-3 once a layer a step in full and under
             ``no_emit``, never under ``no_fine``, ``no_compressed`` (row 11
             instead) or ``attn_only``); the ckv cache bit-unchanged over the
             run under ``no_emit`` and ``attn_only`` and changed otherwise;
             the script's ms a step.
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
             one micro-step.  Then the full-attention model the same way
             (training on the recomputed query chunks, row 13 in validation
             and generation only), its peak memory and ``measure_train``,
             and two gates on the committed full weights: the recomputed
             chunks' loss and every gradient bit for bit the kept chunks' at
             micro 1 x 4096, and the training path's loss within 2e-3 of the
             no-grad loss through row 13 on 4 validation windows, each with
             a dropped-chunk control that must fail.
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
14. cpt    - continuous pretraining (``train/continuous_pretrain.py``) from
             each committed export written as a port checkpoint at its
             step: 4 steps at the script's defaults (batch 8 x seq 512, lr
             3e-5, half QA bytes) with an eval point every 2 steps, in the
             train phase's working directory; the first logged loss equal
             to ``transformer_loss`` of the restored weights on the same
             batch, the final checkpoint at the export's step + 4, finite
             perplexities, launch counts (rows 1, 4, 5 sparse; row 13 in the
             full model's eval points).
15. compress - the six compressors no committed weights use (conv, attn,
             mean, shared_mlp, single, transformer) on the reference model
             from a seeded random init: prefill bs 8 x 2048 (row 1), 16
             captured greedy steps on the split route (rows 2-3), launch
             counts; the prefill logits and the first step's against the
             plain path, rows 2-3 on layer 0's inputs of that step under
             ``select_tolerance`` / ``attend_tolerance`` with their
             controls; one training micro-step at 2 x 4096 (rows 1, 4, 5),
             its loss and gradients against the plain path.
16. configs - the NSA configurations that JAX runs on its XLA path, at the
             reference widths from a seeded init (float32 masters, bf16
             compute): per-head selection and selection block = stride
             (compress 16, stride 16, selection block 16) each prefill 16 x
             3900 and 32 captured greedy steps (no kernel but row 11, a layer
             a step at stride = block), captured against eager bit for bit,
             the teacher-forced steps' logits against the full forward over
             the same ids within 2% of max |logit| with a control that
             drops each query's own block from the decode, row 11's blocks
             bit for bit its plain version, 4 engine requests on the dense
             pool (8 before the mesh phase; in float32 each request's
             tokens equal its own greedy_decode; in bf16 counted), and one
             training step at 4 x
             4096 in bf16 against the same step in float32 (loss within
             2e-3, every gradient within rel L2 0.1) with a control that
             zeroes layer 0's fine branch, its peak memory; non-causal
             attention the forward 16 x 3900 and the training step.  Then
             the hybrid route (rows 2 + 7) on the committed weights at the
             serving cell: launches, the split route's tokens stepped on
             both routes from one cache state (2% gate on the rows whose
             selections agree, with a dropped-block control), row 7's
             launch plan at bs 64, captured tok/s in turns (split, hybrid,
             hybrid, split); row 7 on its own operands at bs 64, its
             output gate with a control that leaves the FF out (at least
             twice the gate on every launch), and the element that sets its
             attention output's figure; and rows 6-7 with the FF outside
             (``NSA_NO_FF_FUSE``) at bs 8 against the FF inside, with a
             control that leaves layer 0's FF out.
17. long   - JAX's 16k path: ``python -m nsa_tpu_torch.eval.efficiency_16k``
             with its defaults (both committed weight files in bf16, bs 1,
             8, 16 x prompt 8,000, 15,000, gen 100, 16,384 rows), its rows,
             launch counts (rows 1, 2, 3, 12, 13, added to the kernels
             line's), sparse against full decode tok/s and prefill seconds a
             cell; rows 1 and 13 against their plain versions element by
             element at n_k 8,192 and 16,384 (b 1, seeded) and on the
             layer-0 operands of the sweep's bs 1 x prompt 15,000 prefill,
             each with its control (each row's first selected block left out;
             64 middle keys left out of the last 512 query rows); rows 2-3 at
             bs 16 and row 12 at bs 8 on a 16,384-row cache at t = 16,383 and
             16,382 (the kernels phase's harnesses, gates and controls); the
             incremental decode against the full forward at positions
             15,000-15,003 (bs 16) within 2% of max |logit| on both models,
             with a control (the split pair's plain versions without each
             query's own block; the full model's attention without the
             steps' own 64-key block) that must fail; captured decode
             against eager bit for bit at 16k (split bs 16, whole-model bs
             8, full bs 16); the cell's largest prefill (bs 16 x 16,384) of
             each model timed by events beside its row 1 or row 13
             launches; the phase's peak memory.
18. mesh   - the (data, heads) mesh (``nsa_tpu_torch/parallel``): 4 gloo
             ranks spawned on the one card (NCCL refuses two ranks on one
             device), each joined through a ``FileStore`` and loading the
             kernels built here, against the single process on the same
             weights and inputs.  A 2 x 2 mesh: the trained sparse
             weights' training step at 8 x 4096 (loss within 2e-3, every
             gradient within rel L2 0.1, a control without the FF's heads
             all-reduce that must fail the loss gate, and a step without
             copy_to_heads's backward all-reduce that must fail the
             gradient gate), prefill 16 x 3900
             and 32 greedy split-route steps (first step's logits within
             2% of max |logit|, the share of equal tokens, the gloo
             collectives' share of the eager steps), 4 engine requests of
             16 tokens at 8 a sync (equal, or a near-tie within 2% at the
             first parting); a 4 x 1 mesh: 10 whole-model decode steps at
             local bs 2 (logits 2%); the full weights' row-13 loss and
             training step on the 2 x 2 mesh (2e-3); which collectives
             gloo takes on CUDA tensors; each rank's launch counts run by
             run, the engine's exact (added to the kernels line as
             ``mesh_launches``), and in each run the first launch of
             every kernel of rows 1-5, 11 and 13 launched again on that
             rank's own operands (4 heads over 2 KV heads on the 2 x 2
             mesh) and held against its plain version under the kernels
             phase's rules, each with its control.
19. context - context parallelism (``nsa_tpu_torch/parallel/context.py``):
             4 gloo ranks on a seq mesh on the one card, each committed
             model at 2 x 4096 ids (1,024 rows a rank), float32: the loss,
             the whole logits and the gradients summed over the ranks
             against one process's XLA path (the context code on one rank)
             on the blocks the ranks selected (loss rel 1e-5, logits 2e-4
             of max |logit|, gradients rel L2 1e-3; the count of
             selections its own top-k makes otherwise), and against the
             model's plain path on its own selections (loss 1e-5, logits
             2%); two controls that must fail: every rank's own K/V only
             (logits) and a gather whose backward only slices (gradients);
             the bf16 loss against one process's kernel path (2e-3); no
             kernel launched on a rank; each rank's forward and forward +
             backward seconds and the gloo collectives' share.  Then, in
             the same world, ``parallel/scaling_bench.py``'s rank body on
             meshes over its first 1, 2 and 4 ranks and its rows (shared
             card: step times, no efficiency).
20. adapter - the adapter / distillation line in bf16: ``run_finetune``
             from the committed full-attention teacher on the QA pairs at
             bs 8 x seq 256 (4 steps of kl_output_only, one of each other
             mode; every loss finite; launches of rows 1, 4, 5, 13 a step),
             ``verify_gradient_flow``, one 'ce' step's loss (2e-3) and
             gradients (rel L2 0.1) against the plain path and the
             teacher's logits (2%), ``evaluate_qa_accuracy`` on 4 test
             questions x 32 tokens at fixed length 256, base and adapted;
             then a random checkpoint of Llama-3.2-1B's shape cut to 2
             layers, written as bf16 safetensors and converted by
             ``llama_import``: the teacher's forward (row 13) and one
             distillation step (rows 1, 4, 5) at G = 4, the first launch
             of each held against its plain version under the kernels
             phase's rules and controls.  Its launches join the kernels
             line's counts.

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
advanced indexing on contiguous ids (as the XLA decode branches pass them)
and on a strided view of info rows, a wrong-id control giving other bits, its launch
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
import dataclasses
import faulthandler
import functools
import inspect
import itertools
import json
import math
import os
import subprocess
import sys
import shutil
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
    prefill_bucket,
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
from nsa_tpu_torch.models import transformer as model_module  # noqa: E402
from nsa_tpu_torch.ops import nsa as nsa_layer  # noqa: E402
from nsa_tpu_torch.ops import attention as attention_module  # noqa: E402
from nsa_tpu_torch.ops.common import rms_norm  # noqa: E402
from nsa_tpu_torch.ops.nsa import _ckv_width, fuse_decode_layer  # noqa: E402
from nsa_tpu_torch import bench as port_bench  # noqa: E402
from nsa_tpu_torch import kernel_times  # noqa: E402
from nsa_tpu_torch import profile_decode as ablation_script  # noqa: E402
from nsa_tpu_torch.eval import efficiency_16k  # noqa: E402
from nsa_tpu_torch import serve  # noqa: E402
from nsa_tpu_torch.train import continuous_pretrain, pretrain  # noqa: E402
from nsa_tpu_torch.train.data import load_byte_corpus, load_cs441_qa_bytes  # noqa: E402
from nsa_tpu_torch.utils.checkpoint import (  # noqa: E402
    latest_checkpoint,
    load_params_npz,
    model_config_from_meta,
    restore_checkpoint,
    save_checkpoint,
    tree_items,
    tree_leaves,
    tree_to,
)
from nsa_tpu_torch.utils.metrics import MetricsLogger  # noqa: E402

TIME_LIMIT_S = 1100          # hard stop: dump the stacks and exit 1
# each phase's budget against its longest time on the H100 in the runs
# before the mesh phase: at least 10 s for the phases of a few seconds
# (device, weights, main, measure: 5.2 s at most), whose time is host noise;
# about 1.5 times it, to keep the sum under 1,000 s, for profile 36 s (24.2
# s with the ablation script), small 13 s (8.3 s), serve 36 s (24.1 s), full
# 19 s (12.4 s), cpt 42 s (27.8 s), compress 69 s (46.2 s) and long 45 s
# (29.3 s, its sweep cut to one timed run a cell); under 1.5 times for
# kernels 130 s (99.9 s: the plain flash attention at full size,
# flex_attention's compiles, forward and backward).  The mesh phase's 60 s
# (44.9 s in its first whole run) were paid for by the configs phase's
# depth (4 engine requests where it ran 8).  The context phase's 45 s (its
# longest run 44.7 s with scaling_bench in a spawn of its own; ~1.5 times
# the ~30 s with the bench's rank body in the phase's world) and the
# adapter phase's 27 s (18.1 s) were paid for by: configs 134 -> 118 s (1.5
# times its 78.7 s with 4 engine requests), graph 100 -> 80 s (73.6 s with
# the engine at 48 requests, now GRAPH_REQUESTS), train 150 -> 136 s
# (107.9 s with measure_train at 3 + 2 timed steps, now
# TRAIN_MEASURE_ITERS), eval 53 -> 45 s (35.1 s with the sweep at 3 timed
# runs a cell, now EVAL_SWEEP_ITERS) and build 72 -> 58 s (1.2 times its
# longest 48 s; 21.1-31.3 s in five later builds on the H100); 999 s in all
BUDGET_S = {"device": 10, "build": 58, "weights": 10, "kernels": 130, "main": 10,
            "measure": 10, "profile": 36, "small": 13, "serve": 36, "full": 19,
            "eval": 45, "graph": 80, "train": 136, "cpt": 42, "compress": 69,
            "configs": 118, "long": 45, "mesh": 60, "context": 45, "adapter": 27}
BATCH, PROMPT, GEN, MAX_LEN = 64, 3900, 100, 4096
SMALL_BATCHES = (8, 1)       # the small-batch cell: the whole-model decode route
FUSED_KERNELS = ("decode_select_emit", "decode_attend_fused")
MEGA_STEPS = _pick_mega_steps(GEN)   # tokens per launch in measure_decode: 25
# the training cell: the JAX trainer's settings (nsa_tpu/config.py:137-159)
MICRO, ACCUM, SEQ = 16, 4, 4096
TRAIN_STEPS, CKPT_STEP = 3, 2
# measure_train's timed steps after its warm-up, the sparse and the full
# model: cut from 3 and 2 to pay for the context and adapter phases
TRAIN_MEASURE_ITERS = (2, 1)
# synthetic corpus cut from the default 32,000,000 bytes to keep its
# generation (pure Python, ~2 s per MB) inside the phase budget; the train
# and cpt phases share one copy in their working directory
CORPUS_BYTES = 4_000_000
# the full model's training gates: the query chunk the controls drop (rows
# of one 128-row chunk, past the middle) and the windows of the loss gate
FULL_DROPPED_ROWS = (1920, 2048)
FULL_GATE_WINDOWS = 4
# continuous pretraining: steps, eval points, and the script's defaults for
# the sequence (batch 8) and an eval point's bytes
CPT_STEPS, CPT_EVAL_EVERY, CPT_SEQ, CPT_EVAL_MAX_TOKENS = 4, 2, 512, 200_000
# the cpt gates' control: the query rows whose attention the kernel path
# loses (row 1's fine and sliding outputs, row 13's output), past the middle
# of the 512-byte sequence
CPT_DROPPED_ROWS = (256, 320)
# the compressors that no committed weights use: prefill and split-route
# decode at bs 8 x prompt 2048, and one training micro-step at 2 x 4096
NEW_COMPRESSORS = ("conv", "attn", "mean", "shared_mlp", "single", "transformer")
COMPRESS_BATCH, COMPRESS_PROMPT, COMPRESS_GEN, COMPRESS_MICRO = 8, 2048, 16, 2
# The transformer compressor's key bias adds q.b_k to every logit of a
# query's row, which the softmax cancels: its gradient is zero in exact
# arithmetic and rounding noise on both paths, so the relative L2 of one
# noise against the other says nothing.  Its kernel-vs-plain difference is
# held, under TOL_GRAD_REL_L2, relative to the gradient of the same layer's
# query bias instead.
ZERO_GRAD_LEAF = "['b_k']"
# the configs phase: the NSA configurations JAX runs on its XLA path, at the
# reference widths (compress 16, stride 16, selection block 16 for the
# second); prefill CONFIG_BATCH x PROMPT into MAX_LEN rows, CONFIG_GEN
# captured greedy steps, an engine run of CONFIG_REQUESTS requests (prompts
# 256-3900, 16-32 new tokens), a training step at CONFIG_MICRO x SEQ; the
# hybrid route at the serving cell, the FF outside rows 6-7 at
# FF_OUTSIDE_BATCH over FF_STEPS teacher-forced steps
CONFIG_NSA = {"per_head": dict(query_heads_share_selected_kv=False),
              "stride_eq_block": dict(compress_block_sliding_stride=16),
              "non_causal": {}}
CONFIG_BATCH, CONFIG_GEN, CONFIG_REQUESTS, CONFIG_MICRO = 16, 32, 4, 4
CONFIG_PROMPT_MIN = 256
# The key compressor's output bias adds q.b2 to the logit of every compressed
# key of a query's softmax (and of the selection's), which cancels it but for
# the mem slots' share: its gradient is that share's alone, near zero where
# a query sees hundreds of compressed keys (every query when non-causal),
# and bf16 rounding noise dominates it.  Its difference from the float32
# gradient is held, under TOL_GRAD_REL_L2, relative to the gradient of the
# same layer's value-compressor output bias instead (as ZERO_GRAD_LEAF is).
SHIFT_GRAD_LEAF = "['k_compress']['b2']"
FF_OUTSIDE_BATCH, FF_STEPS = 8, 8
# The hybrid gate holds the row-steps whose every layer selected the same
# blocks on both routes: at least this share of them (62% on the H100), and
# every batch row in some step.  Row 7 is held on its own operands in every
# launch of the route's first HYBRID_HELD_STEPS steps at bs 64.
HYBRID_HELD_MIN, HYBRID_HELD_STEPS = 0.5, 4
# the long phase: JAX's 16k cell (scripts/efficiency_16k.py's defaults,
# python -m nsa_tpu_torch.eval.efficiency_16k); rows 1 and 13 at LONG_NK keys
# (JAX's STREAM_MIN_NK, where its streaming bodies start, and the cell's
# cache) at b 1, and on the layer-0 operands of the sweep cell LONG_OPERANDS
# (bs, prompt); the control of row 13 drops LONG_DROPPED_KEYS (the 64 keys
# before the middle) from the last LONG_CONTROL_ROWS query rows; rows 2-3 at
# LONG_SPLIT_BATCH and row 12 at LONG_MEGA_BATCH at the last position of the
# cache; the incremental gate at LONG_GATE_BATCH x LONG_GATE_PROMPT, then
# LONG_GATE_STEPS teacher-forced steps (positions 15,000-15,003); captured
# against eager over LONG_GRAPH_STEPS steps from that prefill
LONG_MAX_LEN, LONG_NK = 16384, (8192, 16384)
LONG_T = LONG_MAX_LEN - 1
LONG_OPERANDS = (1, 15000)
LONG_CONTROL_ROWS = 512
LONG_SPLIT_BATCH, LONG_MEGA_BATCH = 16, 8
LONG_GATE_BATCH, LONG_GATE_PROMPT, LONG_GATE_STEPS = 16, 15000, 4
LONG_GRAPH_STEPS = 25
# the sweep's timed runs a cell after its warm-up, cut from JAX's 3 to keep
# the phase inside its budget (its shapes are JAX's)
LONG_SWEEP_ITERS = 1
# the ablation script's cell (python -m nsa_tpu_torch.profile_decode)
ABLATE_KERNELS = {"": ("decode_select", "decode_attend"), "no_emit": ("decode_select",
                                                                      "decode_attend"),
                  "no_compressed": ("paged_gather",), "no_fine": (), "attn_only": ()}
DECODE_T = PROMPT + GEN - 1  # the last decode position of the cell
# the mesh phase: MESH_RANKS gloo ranks on the one card (NCCL refuses two
# ranks on one device), a 2 x 2 (data, heads) mesh for the sparse model's
# training step at MESH_TRAIN_BATCH x SEQ (accum 1), its prefill of
# MESH_BATCH x PROMPT and MESH_GEN greedy steps on the split route, and
# MESH_REQUESTS engine requests of MESH_NEW tokens at MESH_SYNC tokens a
# sync; a 4 x 1 mesh for MESH_MEGA_STEPS whole-model decode steps at
# MESH_MEGA_BATCH (local bs 2); the full model's training step on the 2 x 2
# mesh.  The ranks join within MESH_TIMEOUT_S or fail the phase.
MESH_RANKS, MESH_TIMEOUT_S = 4, 55
MESH_TRAIN_BATCH = 8
MESH_BATCH, MESH_GEN = 16, 32
MESH_REQUESTS, MESH_SYNC, MESH_NEW = 4, 8, 16
MESH_MEGA_BATCH, MESH_MEGA_STEPS = 8, 10
# the kernels whose first launch in each of a rank's runs is held against
# its plain version at the rank's own shapes (rows 1-5, 11, 13)
MESH_HELD_KERNELS = ("prefill_fwd", "prefill_bwd_dq", "prefill_bwd_dkv", "decode_select",
                     "decode_attend", "paged_gather", "flash_attention")
# the context phase: CONTEXT_RANKS gloo ranks on the one card on a seq mesh
# (parallel/context.py), each committed model at CONTEXT_BATCH x CONTEXT_SEQ
# (CONTEXT_SEQ / CONTEXT_RANKS rows a rank), the single process's figures
# beside them; then, in the same world, parallel/scaling_bench.py's rank
# body over its first SCALING_RANKS ranks (its defaults: seq 128, 2 rows a
# rank; SCALING_ITERS timed steps, cut from 5).
# The float32 gates: the loss rel TOL_CP_LOSS_REL, the logits within
# TOL_CP_LOGITS of max |logit|, the summed gradients rel L2 TOL_CP_GRAD_REL_L2;
# the bf16 loss against the kernel path within TOL_LOSS_REL.
CONTEXT_RANKS, CONTEXT_TIMEOUT_S = 4, 90
CONTEXT_BATCH, CONTEXT_SEQ = 2, 4096
SCALING_RANKS, SCALING_SEQ, SCALING_BATCH, SCALING_ITERS = (1, 2, 4), 128, 2, 3
TOL_CP_LOSS_REL, TOL_CP_LOGITS, TOL_CP_GRAD_REL_L2 = 1e-5, 2e-4, 1e-3
# the single process's two references: the float32 gates hold against the
# first, the same math in one process on the blocks the ranks selected (a
# matrix of another shape rounds apart, which flips a top-k near-tie at a
# few positions); against the second, whose branches 2-3 are row 1's plain
# version on its own selections, the loss gate and the repo's logits gate
CONTEXT_REFS = {"xla": "XLA path (the context code on one rank) on the ranks' selections",
                "plain": "plain path (row 1's plain version), its own selections"}
# the adapter phase: JAX's fine-tune defaults (scripts/finetune_cs441.py: bs
# 8 x seq 256), ADAPTER_KL_STEPS steps of kl_output_only and one of each
# other mode; QA accuracy on ADAPTER_QA test questions x ADAPTER_GEN tokens
# at fixed length ADAPTER_SEQ; LLAMA_CONFIG is Llama-3.2-1B's published
# config.json cut from 16 layers to 2 (its rope_scaling, which the converter
# ignores as JAX's does, kept), run at LLAMA_BATCH x ADAPTER_SEQ
ADAPTER_BATCH, ADAPTER_SEQ, ADAPTER_KL_STEPS = 8, 256, 4
ADAPTER_QA, ADAPTER_GEN = 4, 32
LLAMA_CONFIG = {"hidden_size": 2048, "intermediate_size": 8192, "num_attention_heads": 32,
                "num_key_value_heads": 8, "head_dim": 64, "vocab_size": 128256,
                "num_hidden_layers": 2, "rope_theta": 500000.0, "rms_norm_eps": 1e-5,
                "tie_word_embeddings": True, "max_position_embeddings": 131072,
                "hidden_act": "silu", "torch_dtype": "bfloat16",
                "rope_scaling": {"factor": 32.0, "high_freq_factor": 4.0,
                                 "low_freq_factor": 1.0,
                                 "original_max_position_embeddings": 8192,
                                 "rope_type": "llama3"}}
LLAMA_BATCH = 2
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
# the sweep's timed runs a cell after its warm-up, cut from JAX's 3 (its
# shapes are JAX's) to pay for the context and adapter phases
EVAL_SWEEP_ITERS = 1
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


def prefill_gate(name, args):
    """Row 1 on its arguments (rq, rk, v, sel_idx, sel_mask, sel_block,
    window, scale): both outputs against the plain version element by
    element (``fine_sliding_tolerance``), both log-sum-exps within TOL_LSE,
    and a control (the plain fine output with each row's first valid
    selected block left out, on 2 sequences) that must fail the rule.
    Returns (the kernel's outputs, the plain version's, the figures)."""
    rq, rk, v, sel_idx, sel_mask, Bs, window, scale = args
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
    print(f"  {name} {tuple(rq.shape)}: max |err| / bound fine {ratios[0]:.4f} sliding "
          f"{ratios[1]:.4f} (<= 1: 2^-7 |plain| + 2^-8 attention over |v|), lse max|err| "
          f"{lse[0]:.2e} {lse[1]:.2e} (tol {TOL_LSE}); each row's first selected block left "
          f"out: {control:.2f} (must be > 1)", flush=True)
    check(control > 1.0, f"{name}: the prefill rule passes a kernel that leaves out a block")
    check(all(torch.isfinite(x.float()).all().item() for x in got)
          and max(ratios) <= 1.0, f"{name}: outputs disagree with the plain version")
    check(max(lse) <= TOL_LSE, f"{name}: log-sum-exps disagree with the plain version")
    return got, want, {"ratio": max(ratios), "lse_err": max(lse), "control_ratio": control}


def check_prefill(name, inputs, flush, cfg, library=True, plain_iters=2):
    """Row 1 on one set of inputs: ``prefill_gate``; the union sizes per
    16- and 64-row tile; kernel, bound, plain (over ``plain_iters`` runs,
    none at 0) and (with ``library``) flex_attention times."""
    nsa = cfg.nsa
    G, d = cfg.num_grouped_queries, cfg.dim_head
    Bs, window, scale = nsa.selection_block_size, nsa.sliding_window_size, d ** -0.5
    rq, rk, v, sel_idx, sel_mask = inputs
    args = (rq, rk, v, sel_idx, sel_mask, Bs, window, scale)
    got, want, _ = prefill_gate(name, args)
    unions = {f"u{r}": union_sizes(sel_idx, sel_mask, Bs, r) for r in (16, 64)}
    print(f"  {name}: union blocks per 16 rows {unions['u16']}, per 64 rows {unions['u64']}",
          flush=True)
    flops = sum(needed_keys(sel_idx, sel_mask, cfg)) * G * 4 * d
    bms, by = bound_ms(nbytes(rq, rk, v, sel_idx, sel_mask, *got), flops)
    ms = timed_ms(lambda: nsa_prefill.prefill_fwd(*args), 10, flush)
    plain = timed_ms(lambda: nsa_prefill.fine_sliding_plain(*args), plain_iters, flush) \
        if plain_iters else None
    lib = None
    if library:
        t0 = time.perf_counter()
        run_lib = flex_prefill(*args)
        lib_err = max(max_err(x, y) for x, y in zip(run_lib()[:2], want[:2]))
        setup = time.perf_counter() - t0
        lib = timed_ms(run_lib, 10, flush)
    print(f"  {name} {ms:.4f} ms (bound {bms:.4f} ms by {by}: {ms / bms:.2f}x)"
          + (f", plain {plain:.3f} ms" if plain_iters else "")
          + (f", flex_attention (both branches) {lib:.4f} ms, its outputs vs plain max|err| "
             f"{lib_err:.5f} (block masks and compile {setup:.1f}s)" if library else ""),
          flush=True)
    return {"name": name, "route": "cuda", "source": "nsa_tpu_torch/csrc/nsa_prefill.cu",
            "replaces": "nsa_tpu/ops/pallas/nsa_prefill.py:315",
            "max_abs_err": max(max_err(x, y) for x, y in zip(got[:2], want[:2])), "ms": ms,
            "plain_ms": plain, "bound_ms": bms, "bound_by": by, "library_ms": lib,
            "unions": unions}


@contextlib.contextmanager
def first_launch_operands():
    """The wrappers of rows 1-5, 11 and 13 replaced where the model calls
    them, so that each one's first launch keeps its positional operands
    (tensors cloned) in the dict yielded, under the wrapper's name."""
    rec = {}
    sites = [(nsa_prefill, "prefill_fwd"), (nsa_prefill, "prefill_bwd_dq"),
             (nsa_prefill, "prefill_bwd_dkv"), (nsa_layer, "decode_select"),
             (nsa_layer, "decode_attend"), (nsa_layer, "paged_gather"),
             (model_module, "flash_attention")]
    real = [getattr(module, name) for module, name in sites]

    class Keeping:
        """A wrapper that keeps its first call's operands.  Rows 1, 4 and 5
        are replaced in their own module, where each wrapper counts its
        launch through its module's name: ``launches`` reads and writes
        the wrapper's own count."""

        def __init__(self, name, fn):
            self.name, self.fn = name, fn

        def __call__(self, *args, **kw):
            if self.name not in rec:
                rec[self.name] = [a.clone() if torch.is_tensor(a) else a for a in args]
            return self.fn(*args, **kw)

        @property
        def launches(self):
            return self.fn.launches

        @launches.setter
        def launches(self, n):
            self.fn.launches = n

    for (module, name), fn in zip(sites, real):
        setattr(module, name, Keeping(name, fn))
    try:
        yield rec
    finally:
        for (module, name), fn in zip(sites, real):
            setattr(module, name, fn)


def first_operands(kernel, run, *args):
    """The positional operands of ``kernel``'s first launch in ``run(*args)``
    (``first_launch_operands``)."""
    with first_launch_operands() as rec:
        run(*args)
    return rec[kernel]


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
                            first_operands("prefill_fwd", serving_prefill, params, cfg)[:5],
                            flush, cfg)
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


def prefill_bwd_gate(name, dq_args, deltas=None):
    """Rows 4 and 5 on row 4's arguments (rq, rk, v, sel_idx, sel_mask, fo,
    so, flse, slse, dfo, dso, sel_block, window, scale), row 5 reading
    ``deltas`` (fine, sliding) where given, else the plain version's: dq,
    dk, dv against the plain versions element by element
    (``prefill_bwd_tolerance``) with a control (the plain backward with each
    row's first selected block left out, on 2 sequences) that must fail the
    rule; d_gates and the deltas within TOL_BWD_F32; each kernel bit-equal
    on a second launch.  Returns (row 5's arguments, row 4's outputs and
    its plain version's, row 5's and its plain version's, the figures)."""
    sel, (flse, slse, dfo, dso), rest = dq_args[:5], dq_args[7:11], dq_args[11:]
    got_q = nsa_prefill.prefill_bwd_dq(*dq_args)
    want_q = nsa_prefill.prefill_bwd_dq_plain(*dq_args)
    terms = (flse, slse, *(want_q[2:4] if deltas is None else deltas), dfo, dso)
    dkv_args = (*sel, *terms, *rest)
    got_kv = nsa_prefill.prefill_bwd_dkv(*dkv_args)
    want_kv = nsa_prefill.prefill_bwd_dkv_plain(*dkv_args)
    again = (*nsa_prefill.prefill_bwd_dq(*dq_args), *nsa_prefill.prefill_bwd_dkv(*dkv_args))
    torch.cuda.synchronize()
    want = (want_q[0], *want_kv)
    tols = nsa_prefill.prefill_bwd_tolerance(*sel, *terms, *rest, want)
    ratios = {k: ((x.float() - y.float()).abs() / t).max().item()
              for k, x, y, t in zip(("dq", "dk", "dv"), (got_q[0], *got_kv), want, tols)}
    f32 = {k: max_err(x, y) / y.float().abs().max().item()
           for k, x, y in zip(("d_gates", "fine_delta", "sliding_delta"), got_q[1:], want_q[1:])}
    two = [x[:2] for x in sel]
    dropped = nsa_prefill.without_first_block(two[3], two[4], rest[0])
    wrong = (nsa_prefill.prefill_bwd_dq_plain(*two[:4], dropped,
                                              *[x[:2] for x in dq_args[5:11]], *rest)[0],
             *nsa_prefill.prefill_bwd_dkv_plain(*two[:4], dropped,
                                                *[x[:2] for x in terms], *rest))
    control = [((x.float() - y[:2].float()).abs() / t[:2]).max().item()
               for x, y, t in zip(wrong, want, tols)]
    del tols, wrong
    print(f"  {name} {tuple(sel[0].shape)}: max |err| / bound dq {ratios['dq']:.4f} dk "
          f"{ratios['dk']:.4f} dv {ratios['dv']:.4f} (<= 1: 2^-7 |plain| + 2^-8 of the sum over "
          f"absolute values); max |err| / max |plain| d_gates {f32['d_gates']:.2e} deltas "
          f"{f32['fine_delta']:.2e} {f32['sliding_delta']:.2e} (tol {TOL_BWD_F32}); each row's "
          f"first selected block left out: dq {control[0]:.2f} dk {control[1]:.2f} dv "
          f"{control[2]:.2f} (dq and dk or dv must be > 1)", flush=True)
    check(control[0] > 1.0 and max(control[1:]) > 1.0,
          f"{name}: the backward rule passes a kernel that leaves out a block")
    check(all(torch.isfinite(x.float()).all().item() for x in (*got_q, *got_kv))
          and max(ratios.values()) <= 1.0, f"{name}: dq, dk or dv disagree with the plain version")
    check(max(f32.values()) <= TOL_BWD_F32, f"{name}: d_gates or a delta disagrees")
    check(all(torch.equal(x, y) for x, y in zip((*got_q, *got_kv), again)),
          f"{name}: a backward kernel is not deterministic")
    return dkv_args, got_q, want_q, got_kv, want_kv, {
        "prefill_bwd_dq": {"ratio": ratios["dq"], "f32_err": max(f32.values()),
                           "control_ratio": control[0]},
        "prefill_bwd_dkv": {"ratio": max(ratios["dk"], ratios["dv"]),
                            "control_ratio": max(control[1:])}}


def check_prefill_bwd(name, inputs, gen, flush, cfg, log):
    """Rows 4 and 5 on one set of inputs at the training cell: the forward
    kernel's outputs, seeded cotangents; ``prefill_bwd_gate`` (row 5 on the
    plain deltas); the lists' and unions' sizes; kernel, plain, bound and
    flex_attention backward times."""
    nsa = cfg.nsa
    G, d = cfg.num_grouped_queries, cfg.dim_head
    Bs, window, scale = nsa.selection_block_size, nsa.sliding_window_size, d ** -0.5
    rq, rk, v, sel_idx, sel_mask = sel = inputs
    fo, so, flse, slse = nsa_prefill.prefill_fwd(*sel, Bs, window, scale)
    dfo = torch.randn(fo.shape, generator=gen, device=DEVICE).to(torch.bfloat16)
    dso = torch.randn(so.shape, generator=gen, device=DEVICE).to(torch.bfloat16)
    dq_args = (*sel, fo, so, flse, slse, dfo, dso, Bs, window, scale)
    dkv_args, got_q, want_q, got_kv, want_kv, _ = prefill_bwd_gate(name, dq_args)
    want = (want_q[0], *want_kv)
    stats = selection_stats(sel_idx, sel_mask, Bs)
    print(f"  {name}: rows per inverted list {stats['rows_per_list']}, union blocks per 16 "
          f"rows {stats['u16']}", flush=True)

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
                                first_operands("prefill_fwd", training_forward, params,
                                               cfg)[:5], gen,
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


def mega_selection_gate(mp, insp, start, after, plain, t, cfg, max_len=MAX_LEN):
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
    kw = dict(max_len=max_len, stride=stride, sel_block=Bs, num_sel=num_sel, n_slide=n_slide,
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


def kernel_decode_mega(gen, flush, cfg, packed, b, log, max_len=MAX_LEN, t_emit=DECODE_T,
                       profiled=True):
    """Row 12 at bs ``b``: the whole model's trained weights (packed);
    seeded tokens and caches at full length (``max_len`` rows); an emission
    step (``t_emit``) and the step before it.  The rows a step writes (kv row
    t, the ring's new row, the emitted ckv row) come from bf16 roundings of
    float32 sums that the two versions take in another order, so they are
    held within TOL_FUSED of the largest value; every other cache row, and
    the ring's shifted rows, must be bit-equal to what was there.  Two
    controls, the plain version with one emission chunk left out
    (``dropped_emission_chunk``) and with each
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
    registers and the time by phase and layer.  The time is the profiler's
    device time, or without ``profiled`` the event-timed one."""
    nsa = cfg.nsa
    L, kvh, d, stride = cfg.depth, cfg.kv_heads, cfg.dim_head, nsa.compress_block_sliding_stride
    Bc, Bs, window = nsa.compress_block_size, nsa.selection_block_size, nsa.sliding_window_size
    num_sel, n_slide = nsa.num_selected_blocks, -(-window // nsa.selection_block_size) + 1
    Wc = _ckv_width(max_len, stride, nsa.num_compress_per_fine)
    mp = packed["mega"]
    dev = DEVICE
    tkw = dict(sel_block=Bs, window=window, num_sel=num_sel, n_slide=n_slide, scale=d ** -0.5)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    kv, ckv, ring = randn(L, b, kvh, max_len, 2 * d), randn(L, b, kvh, Wc, 2 * d), \
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
    for t in (t_emit, t_emit - 1):           # an emission step, then one without
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
        sel_gate = mega_selection_gate(mp, insp, (kv, ckv, ring), caches[0],
                                       (infos, plain_sel, plain_att), t, cfg, max_len)
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
        timed[t] = (breakdown if profiled else event_timed)(
            f"decode_step_mega t={t}", lambda: transformer_decode_step_mega(
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
    amort = (times[t_emit] + (stride - 1) * times[t_emit - 1]) / stride
    amort_event = (timed[t_emit]["event_ms"]
                   + (stride - 1) * timed[t_emit - 1]["event_ms"]) / stride
    amort_plain = (plain_times[t_emit] + (stride - 1) * plain_times[t_emit - 1]) / stride

    # the bound of the amortised step: each layer's weights, the live ckv
    # rows, the kv rows the masks keep, the ring read and written, the row
    # written; the compressors at 1 step in `stride`
    num_cb = t_emit // stride
    dense = [mp[k] for k in ("attn_norm", "w_qkvg", "gate_b", "mem_kv", "w_out", "ff_norm",
                             "fw1", "fb1", "fw2", "fb2", "out_norm", "to_logits")]
    comp = [mp[k] for k in ("pos_kv", "b1k", "b1v", "b2c", "w1k", "w1v", "w2c")]
    rows = sum(attend_rows(info.reshape(b, kvh, -1)[..., num_sel + n_slide:
                                                    2 * num_sel + n_slide],
                           t_emit, Bs, n_slide, window, b * kvh) for info in emit_infos)
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
    print(f"  decode_step_mega bs {b}: device {times[t_emit]:.4f} ms emitting, "
          f"{times[t_emit - 1]:.4f} ms not, {amort:.4f} ms amortised over {stride} steps "
          f"(event-timed {amort_event:.4f}; bound {bms:.5f} ms, by {by}); plain "
          f"{amort_plain:.4f} ms", flush=True)
    plan = nsa_decode_mega.launch_plan(DEVICE, [
        L, b, kvh, cfg.num_grouped_queries, max_len, Wc, Bc, nsa.num_compressed_mem_kv,
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
            "ms_emit_step": times[t_emit], "ms_other_step": times[t_emit - 1],
            "event_ms": amort_event, "host_ms_other_step": timed[t_emit - 1]["host_ms"],
            "phase_us_emit_step": phases[t_emit], "phase_us_other_step": phases[t_emit - 1],
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


def event_timed(name, fn, flush):
    """``breakdown``'s keys without the profiler: "ms" is the event-timed
    median, with the host time of a call beside it."""
    ms = kernel_times.event_ms(fn, 30, flush)
    host = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    host_ms = sorted(host)[2]
    print(f"  {name}: event-timed {ms:.4f} ms; host {host_ms:.4f} ms a call", flush=True)
    return {"ms": ms, "event_ms": ms, "host_ms": host_ms}


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
    # the ids contiguous, as the XLA decode branches pass them, and as a
    # strided view of the info rows' first columns, which the wrapper takes
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


def split_kw(cfg, max_len=MAX_LEN):
    """The split pair's keyword arguments at a cache of ``max_len`` rows:
    (row 2's, row 3's)."""
    nsa = cfg.nsa
    Bs, window, num_sel = nsa.selection_block_size, nsa.sliding_window_size, \
        nsa.num_selected_blocks
    n_slide, scale = -(-window // Bs) + 1, cfg.dim_head ** -0.5
    return (dict(max_blocks=max_len // Bs, stride=nsa.compress_block_sliding_stride,
                 sel_block=Bs, num_sel=num_sel, n_slide=n_slide, scale=scale),
            dict(sel_block=Bs, window=window, num_sel=num_sel, n_slide=n_slide, scale=scale))


def select_gate(q, ckv, mem_kv, t, num_cb, cfg, label, max_len=MAX_LEN):
    """Row 2 against its plain version at position ``t`` (an int): c_out
    within TOL_OUT and element by element under ``select_tolerance``, with
    the plain c_out over all but the first 64 live rows as a control that
    must fail it; the selected ids equal but for ties; a second launch bit
    for bit.  Returns (c_k, info_k, c_p, info_p, figures)."""
    nsa, b, kvh = cfg.nsa, q.shape[0], q.shape[1]
    kw, akw = split_kw(cfg, max_len)
    pt = device_t(t)                              # the kernels read t on the device
    c_k, info_k = nsa_decode.decode_select(q, ckv, mem_kv, pt, num_cb, **kw)
    c_2, info_2 = nsa_decode.decode_select(q, ckv, mem_kv, pt, num_cb, **kw)
    c_p, info_p = nsa_decode.decode_select_plain(q, ckv, mem_kv, t, num_cb, **kw)
    _, scores = nsa_decode.select_scores_plain(q, ckv, mem_kv, num_cb, t, stride=kw["stride"],
                                               sel_block=kw["sel_block"], scale=kw["scale"])
    skw = dict(stride=kw["stride"], sel_block=kw["sel_block"], scale=kw["scale"])
    R = nsa_decode_ragged
    want, tol = R.select_tolerance(q, ckv, mem_kv, t, num_cb, **skw)
    # the control: c_out with the first 64 live rows left out
    moved, live = R.without_live_chunk(ckv, num_cb)
    wrong, _ = nsa_decode.select_scores_plain(q, moved, mem_kv, live, t,
                                              weights_dtype=torch.float32, **skw)
    torch.cuda.synchronize()
    err = max_err(c_k, c_p)
    ties = check_selection(info_k, info_p, scores, nsa.num_selected_blocks, akw["n_slide"],
                           label)
    ratio = ((c_k.float() - want.float()).abs() / tol).max().item()
    ratio_ctl = ((wrong.float() - want.float()).abs() / tol).max().item()
    same2 = torch.equal(c_2, c_k) and torch.equal(info_2, info_k)
    print(f"  {label} max|err| c_out {err:.5f} (tol {TOL_OUT}); worst |err| / "
          f"select_tolerance {ratio:.4f} (<= 1), the dropped-chunk control {ratio_ctl:.1f} (> 1); "
          f"ids equal on {b * kvh - ties}/{b * kvh} rows, {ties} rows differ only by ties within "
          f"{TIE}; a second launch bit-equal: {same2}", flush=True)
    check(err <= TOL_OUT and bool(torch.isfinite(c_k.float()).all()),
          f"{label} c_out disagrees")
    check(ratio <= 1.0, f"{label}: c_out breaks select_tolerance")
    check(ratio_ctl > 1.0, f"{label}: the dropped-chunk control passes select_tolerance")
    check(same2, f"{label}: a second launch gives other bits")
    return c_k, info_k, c_p, info_p, {"max_abs_err": err, "select_tolerance_ratio": ratio,
                                      "control_ratio": ratio_ctl, "tie_rows": ties}


def attend_gate(rq, kv, info, c_out, gates, t, cfg, label):
    """Row 3 against its plain version on the same ``info``, c_out and gates
    at position ``t`` (an int): the output within TOL_OUT and under
    ``attend_tolerance``, with each row's first selected block left out as a
    control that must fail it; a second launch bit for bit.  Returns
    (out_k, figures)."""
    _, akw = split_kw(cfg)
    pt, R = device_t(t), nsa_decode_ragged
    out_k = nsa_decode.decode_attend(rq, kv, info, c_out, gates, pt, **akw)
    out_2 = nsa_decode.decode_attend(rq, kv, info, c_out, gates, pt, **akw)
    out_p = nsa_decode.decode_attend_plain(rq, kv, info, c_out, gates, t, **akw)
    want, tol = R.attend_tolerance(rq, kv, info, c_out, gates, t, **akw)
    dropped = R.without_first_selected(info, akw["num_sel"], akw["n_slide"])
    wrong, _ = R.attend_tolerance(rq, kv, dropped, c_out, gates, t, **akw)
    torch.cuda.synchronize()
    err = max_err(out_k, out_p)
    ratio = ((out_k.float() - want.float()).abs() / tol).max().item()
    ratio_ctl = ((wrong.float() - want.float()).abs() / tol).max().item()
    same2 = torch.equal(out_2, out_k)
    print(f"  {label} max|err| {err:.5f} (tol {TOL_OUT}); worst |err| / "
          f"attend_tolerance {ratio:.4f} (<= 1), the dropped-block control {ratio_ctl:.1f} "
          f"(> 1); a second launch bit-equal: {same2}", flush=True)
    check(err <= TOL_OUT and torch.isfinite(out_k.float()).all().item(), f"{label} disagrees")
    check(ratio <= 1.0, f"{label}: the output breaks attend_tolerance")
    check(ratio_ctl > 1.0, f"{label}: the dropped-block control passes attend_tolerance")
    check(same2, f"{label}: a second launch gives other bits")
    return out_k, {"max_abs_err": err, "attend_tolerance_ratio": ratio,
                   "control_ratio": ratio_ctl}


def kernel_decode(gen, flush, cfg, log, b=BATCH, max_len=MAX_LEN, t=DECODE_T, suffix=""):
    """Rows 2 and 3 at the serving cell (bs 64, t = 3999, seeded inputs), or
    at ``b`` rows of a ``max_len``-row cache at position ``t`` (the labels
    ending in ``suffix``): ``select_gate`` and ``attend_gate``; each
    kernel's launch geometry and ptxas registers / spills, its time, its
    plain version's and its bound."""
    nsa = cfg.nsa
    kvh, g, d = cfg.kv_heads, cfg.num_grouped_queries, cfg.dim_head
    stride, Bs, window = nsa.compress_block_sliding_stride, nsa.selection_block_size, \
        nsa.sliding_window_size
    num_sel, M = nsa.num_selected_blocks, nsa.num_compressed_mem_kv
    kw, akw = split_kw(cfg, max_len)
    n_slide = akw["n_slide"]
    num_cb = t // stride
    Wc = _ckv_width(max_len, stride, nsa.num_compress_per_fine)
    dev = DEVICE

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    q, ckv, mem_kv = randn(b, kvh, g, d), randn(b, kvh, Wc, 2 * d), randn(2, kvh, M, d)
    pt = device_t(t)
    geometry = kernel_times.split_geometry(log)
    for name, x in geometry.items():
        print(f"  {name} launch: grid {x['grid']} of 256 threads, {x['blocks_per_sm']} block(s) "
              f"fit an SM, shared memory {x['smem_bytes']} B a block (card limit "
              f"{x['smem_optin']}); ptxas: {x['registers']} registers, spills (stores, loads) "
              f"{x['spill_bytes']}", flush=True)
    c_k, info_k, c_p, info_p, figures = select_gate(q, ckv, mem_kv, t, num_cb, cfg,
                                                    "decode_select" + suffix, max_len)
    vp = info_p[..., num_sel + n_slide:num_sel + n_slide + num_sel]
    rows_read = b * kvh * num_cb * 2 * d * 2
    bms, by = bound_ms(nbytes(q, mem_kv, c_k, info_k) + rows_read,
                       b * kvh * g * (num_cb + M) * 4 * d)
    sel = {"name": "decode_select" + suffix, "route": "cuda",
           "source": "nsa_tpu_torch/csrc/nsa_decode.cu",
           "replaces": "nsa_tpu/ops/pallas/nsa_decode.py:195",
           "max_abs_err": figures["max_abs_err"],
           "select_tolerance_ratio": figures["select_tolerance_ratio"],
           "control_ratio": figures["control_ratio"],
           "ms": timed_ms(lambda: nsa_decode.decode_select(q, ckv, mem_kv, pt, num_cb, **kw),
                          50, flush),
           "plain_ms": timed_ms(lambda: nsa_decode.decode_select_plain(
               q, ckv, mem_kv, t, num_cb, **kw), 10, flush),
           "bound_ms": bms, "bound_by": by, "library_ms": None,
           **geometry["decode_select"]}

    # attend: both versions get the same info, c_out and gates
    rq, kv = randn(b, kvh, g, d), randn(b, kvh, max_len, 2 * d)
    gates = torch.sigmoid(randn(b, kvh, g, 3).float()).to(torch.bfloat16)
    out_k, figures = attend_gate(rq, kv, info_p, c_p, gates, t, cfg, "decode_attend" + suffix)
    rows = attend_rows(vp, t, Bs, n_slide, window, b * kvh)
    bms, by = bound_ms(nbytes(rq, info_p, c_p, gates, out_k) + rows * 2 * d * 2,
                       rows * g * 4 * d)
    att = {"name": "decode_attend" + suffix, "route": "cuda",
           "source": "nsa_tpu_torch/csrc/nsa_decode.cu",
           "replaces": "nsa_tpu/ops/pallas/nsa_decode.py:325",
           "max_abs_err": figures["max_abs_err"],
           "attend_tolerance_ratio": figures["attend_tolerance_ratio"],
           "control_ratio": figures["control_ratio"],
           "ms": timed_ms(lambda: nsa_decode.decode_attend(rq, kv, info_p, c_p, gates, pt,
                                                           **akw), 50, flush),
           "plain_ms": timed_ms(lambda: nsa_decode.decode_attend_plain(
               rq, kv, info_p, c_p, gates, t, **akw), 10, flush),
           "bound_ms": bms, "bound_by": by, "library_ms": None,
           **geometry["decode_attend"]}
    return sel, att


def dropped_key_attention(q, k, v, keys, first_row=0):
    """Causal attention in the plain version's float32 numerics with keys
    keys[0] .. keys[1] - 1 left out of every query row past them: what a
    flash kernel that skipped one key tile of the late query tiles returns.
    Query rows from ``first_row`` on (q holds those rows)."""
    n, g = k.shape[2], q.shape[1] // k.shape[1]
    rows = torch.arange(first_row, first_row + q.shape[2], device=q.device)[:, None]
    cols = torch.arange(n, device=q.device)[None, :]
    valid = (rows >= cols) & ~((cols >= keys[0]) & (cols < keys[1]) & (rows >= keys[1]))
    kf, vf = (x.float().repeat_interleave(g, 1) for x in (k, v))
    s = ((q.float() * q.shape[-1] ** -0.5) @ kf.transpose(-1, -2)).masked_fill(~valid, -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True)).masked_fill(~valid, 0.0)
    return ((p @ vf) / p.sum(-1, keepdim=True)).to(q.dtype)


def flash_gate(name, q, k, v, dropped=FLASH_DROPPED_KEYS, control_rows=None):
    """Row 13 on causal q, k, v against its plain version, element by
    element (``flash_attention_tolerance``), with a control (the keys
    ``dropped`` left out of the later rows, on 2 sequences and, where
    ``control_rows`` is given, the last ``control_rows`` query rows) that
    must fail the rule.  Returns (the kernel's output, the plain
    version's, the figures)."""
    n = q.shape[2]
    got = flash.flash_attention(q, k, v)
    want = flash.flash_attention_plain(q, k, v)
    tol = flash.flash_attention_tolerance(q, k, v, want)
    torch.cuda.synchronize()
    err = max_err(got, want)
    ratio = ((got.float() - want.float()).abs() / tol).max().item()
    # the control: a wrong kernel's output on the first 2 sequences
    r0 = 0 if control_rows is None else n - control_rows
    wrong = dropped_key_attention(q[:2, :, r0:], k[:2], v[:2], dropped, r0)
    control = ((wrong.float() - want[:2, :, r0:].float()).abs() / tol[:2, :, r0:]).max().item()
    del tol, wrong
    print(f"  {name} {tuple(q.shape)} over {k.shape[1]} KV heads: max|err| {err:.5f}, max "
          f"|err| / bound {ratio:.4f} (<= 1: 2^-7 |plain| + 2^-8 attention over |v|); keys "
          f"{dropped[0]}..{dropped[1] - 1} left out of the later rows: {control:.2f} (must be "
          f"> 1)", flush=True)
    check(control > 1.0, f"{name}: the flash rule passes a kernel that leaves out a key tile")
    check(bool(torch.isfinite(got.float()).all()) and ratio <= 1.0,
          f"{name} disagrees with its plain version")
    return got, want, {"max_abs_err": err, "ratio": ratio, "control_ratio": control}


def kernel_flash(gen, flush, cfg, b=BATCH, n=PROMPT, inputs=None, dropped=FLASH_DROPPED_KEYS,
                 control_rows=None, name="flash_attention"):
    """Row 13 at the full-attention serving cell: seeded bf16 q [64, 8, 3900,
    64], k / v [64, 4, 3900, 64], causal, against its plain version; SDPA
    on the same inputs is the library yardstick.  Or at ``b`` x ``n``, or on
    ``inputs`` (q, k, v), with the control's keys ``dropped`` and, where
    ``control_rows`` is given, the control held on the last
    ``control_rows`` query rows only (its logits are dense)."""
    h, kvh, d = cfg.heads, cfg.kv_heads, cfg.dim_head
    if inputs is None:
        q = torch.randn((b, h, n, d), generator=gen, device=DEVICE).to(torch.bfloat16)
        k = torch.randn((b, kvh, n, d), generator=gen, device=DEVICE).to(torch.bfloat16)
        v = torch.randn((b, kvh, n, d), generator=gen, device=DEVICE).to(torch.bfloat16)
    else:
        q, k, v = inputs
        b, n = q.shape[0], q.shape[2]
    got, want, figures = flash_gate(name, q, k, v, dropped, control_rows)
    err = figures["max_abs_err"]

    def library():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)

    print(f"  {name}: the SDPA yardstick vs plain max|err| {max_err(library(), want):.5f}",
          flush=True)
    flops = 4 * b * h * d * (n * (n + 1) // 2)            # q.k and p.v per (row, key <= row)
    bms, by = bound_ms(nbytes(q, k, v, got), flops)
    ms = timed_ms(lambda: flash.flash_attention(q, k, v), 10, flush)
    plain = timed_ms(lambda: flash.flash_attention_plain(q, k, v), 2, flush)
    lib = timed_ms(library, 10, flush)
    print(f"  {name} {ms:.4f} ms (bound {bms:.4f} ms by {by}: {ms / bms:.2f}x), plain "
          f"{plain:.3f} ms, SDPA {lib:.4f} ms", flush=True)
    return {"name": name, "route": "cuda",
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
                    # the 1-byte prefill has no selectable block: JAX's XLA
                    # path, as JAX's use_fused_kernel takes it, and no row 1
                    want.update(prefill_fwd=0, decode_step_mega=EVAL_SEQ - 1)
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
                                            iters=EVAL_SWEEP_ITERS,
                                            csv_path=os.path.join(tmp, "efficiency.csv"),
                                            step=step, device=DEVICE,
                                            log=lambda line: print(f"  {line}; {smi}",
                                                                   flush=True))
                wall = time.perf_counter() - t0
                got = launches[f"{name} sweep"] = read_launches(ALL_KERNELS)
                runs = (1 + EVAL_SWEEP_ITERS) * len(EVAL_SWEEP_PROMPTS)  # warm-up + timed
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
# the engine's requests in the graph phase: one wave of its 16 slots (the
# serve phase runs all 48, captured, on both pools), cut from 48 to pay for
# the context and adapter phases
GRAPH_REQUESTS = 16
PROFILE_PAD_S = 0.05   # host idle seconds at each end of a profile_run window
REPLAYS_MARK = "counted replays"   # replayed_kernels' marked range


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
    of thousands of records may drop some), twice: a lead run, then after
    PROFILE_PAD_S of idle host the counted run inside the range
    REPLAYS_MARK.  Each kernel of the step (``GRAPH_KERNELS[kind]``) is held
    to the device records that start in the counted run's part of the
    window (after the midpoint of the pad, so that clock skew of less than
    half of it does not matter): its records a replay, the step's launches,
    and its wrapper's counter a replay (what the graph adds on each replay)
    are one number, and no other wrapper counts.  The lead run takes the
    window's first records, which the profiler can lose (on the H100, the
    first whole-model replay's even with the pad of ``profile_run``); its
    records a replay are printed beside the counted ones, unchecked."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    want = {k: depth if n == "depth" else n for k, (_, n) in GRAPH_KERNELS[kind].items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        run()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
        zero_launches(ALL_KERNELS)
        with record_function(REPLAYS_MARK):
            run()
            torch.cuda.synchronize()
        counters = read_launches(ALL_KERNELS)
        time.sleep(PROFILE_PAD_S)
    events = prof.events()
    marks = [e for e in events if e.name == REPLAYS_MARK and e.device_type == DeviceType.CPU]
    check(len(marks) == 1, f"{label}: {len(marks)} host records of the counted range")
    split = marks[0].time_range.start - PROFILE_PAD_S * 1e6 / 2     # microseconds
    device = [e for e in events if e.device_type == DeviceType.CUDA and e.name != REPLAYS_MARK]
    counted_run = [e.name for e in device if e.time_range.start >= split]
    lead_run = [e.name for e in device if e.time_range.start < split]
    seen = {k: sum(k in n for n in counted_run) / per for k in GRAPH_KERNELS[kind]}
    lead = {k: sum(k in n for n in lead_run) / per for k in GRAPH_KERNELS[kind]}
    counted = {k: counters[fn] / per for k, (fn, _) in GRAPH_KERNELS[kind].items()}
    others = {k: v for k, v in counters.items()
              if v and k not in {fn for fn, _ in GRAPH_KERNELS[kind].values()}}
    print(f"  {label}: {per} replays of the captured step, twice in one profile: device records "
          f"a replay in the counted run {seen} (the lead run's {lead}, unchecked); launches a "
          f"step {want}; counters a replay {counted}", flush=True)
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

    # the engine, dense and paged, captured against eager, on the serve
    # phase's first GRAPH_REQUESTS requests
    L = cfg.depth
    reqs = serve_requests(GRAPH_REQUESTS)
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


def expected_launches(cfg, tc, start, counted):
    """Kernel launches of ``run_pretrain`` over steps start .. num_batches-1,
    for each kernel of ``counted``.  The sparse model: a forward per
    micro-batch, validation and generation prefill, a backward per
    micro-batch, and the generation's decode steps (bs 1: the whole-model
    kernel).  The full model trains on the recomputed chunks, no kernel: row
    13 in the validation and generation prefills only (its decode is plain)."""
    steps = range(start, tc.num_batches)
    val = sum(s % tc.validate_every == 0 for s in steps)
    gen = sum(bool(tc.generate_every) and s % tc.generate_every == 0 and s > 0 for s in steps)
    micro = len(steps) * tc.grad_accum_every
    want = dict.fromkeys((fn.__name__ for fn in counted), 0)
    if not cfg.use_sparse_attn:
        want["flash_attention"] = cfg.depth * (val + gen)
        return want
    want.update(prefill_fwd=cfg.depth * (micro + val + gen), prefill_bwd_dq=cfg.depth * micro,
                prefill_bwd_dkv=cfg.depth * micro, decode_step_mega=gen * tc.generate_length)
    return want


def rel_l2(a, b):
    diff = (a.float() - b.float()).norm().item()
    ref = b.float().norm().item()
    return diff / ref if ref > 0 else diff


def run_and_resume(cfg, name, counted):
    """``run_pretrain`` at the training cell from a seeded random init in
    the working directory: ``TRAIN_STEPS`` steps with a checkpoint at
    ``CKPT_STEP``, then a resume that must start there from the saved
    params; launch counts read around exactly those two runs.  Returns
    (launches, losses, seconds, peak bytes, the train config)."""
    tc = TrainConfig(num_batches=TRAIN_STEPS, batch_size=MICRO, grad_accum_every=ACCUM,
                     seq_len=SEQ, log_every=1, validate_every=2, generate_every=2,
                     generate_length=16, ckpt_every=CKPT_STEP,
                     ckpt_dir=os.path.join("ckpt", name),
                     log_csv=os.path.join("ckpt", name, "log.csv"))
    log1, log2 = StepLog(tc.log_csv), StepLog(tc.log_csv)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counted:
        fn.launches = 0
    t0 = time.perf_counter()
    pretrain.run_pretrain(cfg, tc, train_data(), logger=log1, device=DEVICE)
    ckpt = latest_checkpoint(tc.ckpt_dir)
    check(ckpt is not None and ckpt.endswith(f"step_{CKPT_STEP:08d}"),
          f"{name}: no checkpoint at step {CKPT_STEP}: {ckpt}")
    check(os.path.isfile(os.path.join("ckpt_export", f"{name}.npz")),
          f"{name}: run_pretrain wrote no export")
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
        pretrain.run_pretrain(cfg, tc, train_data(), logger=log2, device=DEVICE)
    finally:
        pretrain.train_step = real_step
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counted}
    peak = torch.cuda.max_memory_allocated()
    check(first == [True] and log2.rows and log2.rows[0][0] == CKPT_STEP,
          f"{name}: resume did not start at step {CKPT_STEP} from the saved params")
    losses = [m.get("loss", m.get("valid_loss")) for _, m in log1.rows + log2.rows]
    check(len(losses) == 3 + 2 + 1 + 1 and all(math.isfinite(x) for x in losses),
          f"{name}: train losses not all finite: {losses}")
    print(f"  {name}: {TRAIN_STEPS} + {TRAIN_STEPS - CKPT_STEP} steps of {MICRO}x{ACCUM}x{SEQ} "
          f"in {seconds:.2f}s (corpus, checkpoints, validation and generation included); "
          f"peak memory {peak / 2**30:.2f} GiB; losses {losses}", flush=True)
    return launches, losses, seconds, peak, tc


def train_data():
    """The training corpus, cut to CORPUS_BYTES, cached in the working directory."""
    return DataConfig(path="enwik8.gz", synthetic_bytes=CORPUS_BYTES)


def train_phase(smi):
    """The training path at the cell, from a seeded random init, in the
    working directory: the sparse model (``train_sparse``), then the full
    model (``train_full``); returns the launch counts and metrics."""
    launches, metrics = train_sparse(smi)
    full_launches, full = train_full(smi)
    return launches, {**metrics, "full_train": full, "full_train_launches": full_launches}


def train_sparse(smi):
    """The sparse model: the run and its resume, one micro-batch's loss and
    gradients through the kernels against the plain path, ``measure_train``
    and a profiled micro-step."""
    cfg = nsa_tpu_torch.reference_model_config().replace(dtype="bfloat16")
    counted = (nsa_prefill.prefill_fwd, nsa_prefill.prefill_bwd_dq, nsa_prefill.prefill_bwd_dkv,
               nsa_decode.decode_select, nsa_decode.decode_attend,
               nsa_decode_fused.decode_select_emit, nsa_decode_fused.decode_attend_fused,
               nsa_decode_mega.decode_step_mega)
    launches, losses, train_s, peak, tc = run_and_resume(cfg, "smoke", counted)
    want = expected_launches(cfg, tc, 0, counted)
    for k, n in expected_launches(cfg, tc, CKPT_STEP, counted).items():
        want[k] += n
    print(f"  train launches {launches}; {smi}", flush=True)
    check(launches == want, f"train-path launches {launches}, expected {want}")

    # one micro-batch: loss and every gradient, kernels vs the plain path,
    # and vs the kernel forward with the plain backward (the two backward
    # kernels alone)
    params = pretrain.trainable(init_transformer(cfg, torch.Generator().manual_seed(SEED),
                                                 device="cpu"), DEVICE)
    ids = seeded_ids(MICRO, SEQ + 1, cfg.vocab_size, SEED + 1, DEVICE)
    with torch.no_grad():
        stats = selection_stats(*first_operands("prefill_fwd", training_forward, params,
                                                cfg)[3:5],
                                cfg.nsa.selection_block_size)
    print(f"  layer 0 of the random-init model at {MICRO}x{SEQ}: rows per inverted list "
          f"{stats['rows_per_list']}, union blocks per 16 rows {stats['u16']}", flush=True)
    lk, gk = loss_and_grads(params, cfg, ids)
    lp, gp = loss_and_grads(params, cfg, ids, use_kernels=False)
    kernel_bwd = nsa_prefill.prefill_bwd_dq, nsa_prefill.prefill_bwd_dkv
    nsa_prefill.prefill_bwd_dq = nsa_prefill.prefill_bwd_dq_plain
    nsa_prefill.prefill_bwd_dkv = nsa_prefill.prefill_bwd_dkv_plain
    try:
        _, gh = loss_and_grads(params, cfg, ids)
    finally:
        nsa_prefill.prefill_bwd_dq, nsa_prefill.prefill_bwd_dkv = kernel_bwd
    check(math.isfinite(lk) and abs(lk - lp) <= TOL_LOSS_REL * abs(lp),
          f"kernel-path loss {lk} disagrees with the plain path's {lp}")
    check(all(torch.isfinite(g).all().item() for g in gk), "kernel-path gradients not finite")
    print(f"  micro-batch {MICRO}x{SEQ} loss kernels {lk:.6f} plain {lp:.6f}", flush=True)
    worst_errs = {}
    for label, other, tol in (("plain path", gp, TOL_GRAD_REL_L2),
                              ("kernel forward + plain backward", gh, TOL_GRAD_BWD_REL_L2)):
        errs = grad_errs(params, gk, other)
        worst = max(errs, key=errs.get)
        worst_errs[label] = errs[worst]
        k_pos = max(v for k, v in errs.items() if "k_pos" in k)   # the net sum nearest its gate
        worst_errs[label + " k_pos"] = k_pos
        print(f"  gradients, kernels vs {label}: rel L2 max {errs[worst]:.3e} at {worst} "
              f"(tol {tol}), median {sorted(errs.values())[len(errs) // 2]:.3e} "
              f"over {len(errs)} tensors; k_pos (largest over the layers) {k_pos:.3e}",
              flush=True)
        check(errs[worst] <= tol, f"kernel-path gradients disagree with the {label}")
    del gk, gp, gh

    tps = measure_train(params, cfg, MICRO, ACCUM, SEQ, iters=TRAIN_MEASURE_ITERS[0], seed=SEED,
                        device=DEVICE)
    print(f"  measure_train micro {MICRO} accum {ACCUM} seq {SEQ}: {tps:.1f} tokens/s "
          f"(mean of {TRAIN_MEASURE_ITERS[0]} steps); {smi}", flush=True)

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
                      "grad_rel_l2_max": worst_errs["plain path"],
                      "grad_rel_l2_max_bwd_only": worst_errs["kernel forward + plain backward"],
                      "k_pos_rel_l2": worst_errs["plain path k_pos"],
                      "k_pos_rel_l2_bwd_only": worst_errs["kernel forward + plain backward k_pos"],
                      "loss_kernels": lk, "loss_plain": lp,
                      "train_micro_step_device_busy": busy,
                      "train_micro_step_device_ms": device_ms, "train_rows45_ms": bwd_ms,
                      "train_init_selections": stats}


def dropped_chunk_attention(q, k, v, causal=True, scale=None, chunk=128):
    """``full_attention_chunked`` with its query rows FULL_DROPPED_ROWS given
    zero attention: a wrong training attention, the full-model gates'
    control."""
    out = attention_module.full_attention_chunked(q, k, v, causal=causal, scale=scale,
                                                  chunk=chunk)
    keep = torch.ones(q.shape[2], 1, dtype=out.dtype, device=out.device)
    keep[slice(*FULL_DROPPED_ROWS)] = 0
    return out * keep


@contextlib.contextmanager
def training_attention(attention):
    """The full model's training attention swapped for ``attention``."""
    real = model_module.full_attention_chunked
    model_module.full_attention_chunked = attention
    try:
        yield
    finally:
        model_module.full_attention_chunked = real


@contextlib.contextmanager
def kept_chunks():
    """``full_attention_chunked``'s chunks kept for the backward: its
    ``torch.utils.checkpoint`` swapped for a pass-through."""
    real = attention_module.checkpoint
    attention_module.checkpoint = lambda fn, *args, **kw: fn(*args)
    try:
        yield
    finally:
        attention_module.checkpoint = real


def full_loss_and_grads(params, cfg, ids, attention, keep=False):
    """The training loss on ``ids`` and every gradient through ``attention``
    (its chunks kept for the backward when ``keep``); peak memory of the
    pass."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with training_attention(attention), kept_chunks() if keep else contextlib.nullcontext():
        loss = transformer_loss(params, cfg, ids)
        grads = torch.autograd.grad(loss, tree_leaves(params))
    torch.cuda.synchronize()
    return loss.detach(), grads, torch.cuda.max_memory_allocated()


def train_full(smi):
    """The full-attention model: the run and its resume from a seeded random
    init (training on the recomputed chunks, row 13 in validation and
    generation), ``measure_train``; then two gates on the committed full
    weights (float32 masters, bf16 compute) on validation bytes:
    1. at micro 1 x seq 4096 the recomputed chunks' loss and every gradient
       bit for bit those of the same chunks kept for the backward; the
       control, the query chunk FULL_DROPPED_ROWS dropped, must differ;
    2. the training path's loss on FULL_GATE_WINDOWS windows within
       TOL_LOSS_REL of the no-grad loss through row 13; the training path
       with the dropped chunk must fail it."""
    cfg = nsa_tpu_torch.reference_model_config(use_sparse_attn=False).replace(dtype="bfloat16")
    launches, losses, train_s, peak, tc = run_and_resume(cfg, "full", ALL_KERNELS)
    want = expected_launches(cfg, tc, 0, ALL_KERNELS)
    for k, n in expected_launches(cfg, tc, CKPT_STEP, ALL_KERNELS).items():
        want[k] += n
    print(f"  full train launches {launches}", flush=True)
    check(launches == want, f"full-model train launches {launches}, expected {want}")
    params = pretrain.trainable(init_transformer(cfg, torch.Generator().manual_seed(SEED),
                                                 device="cpu"), DEVICE)
    tps = measure_train(params, cfg, MICRO, ACCUM, SEQ, iters=TRAIN_MEASURE_ITERS[1], seed=SEED,
                        device=DEVICE)
    print(f"  full model measure_train micro {MICRO} accum {ACCUM} seq {SEQ}: {tps:.1f} "
          f"tokens/s (mean of {TRAIN_MEASURE_ITERS[1]} steps); run peak memory {peak / 2**30:.2f} GiB; {smi}",
          flush=True)
    del params

    weights, meta = load_params_npz(FULL_WEIGHTS, device=DEVICE, dtype=torch.float32)
    gcfg = model_config_from_meta(meta).replace(dtype="bfloat16")
    params = pretrain.trainable(weights)
    del weights
    val = load_byte_corpus(train_data())[1]
    starts = np.random.RandomState(SEED).randint(0, len(val) - SEQ - 1, FULL_GATE_WINDOWS)
    windows = torch.from_numpy(np.stack([val[i:i + SEQ + 1] for i in starts])
                               .astype(np.int64)).to(DEVICE)
    one = windows[:1]
    chunked = attention_module.full_attention_chunked
    l_re, g_re, peak_re = full_loss_and_grads(params, gcfg, one, chunked)
    l_kept, g_kept, peak_kept = full_loss_and_grads(params, gcfg, one, chunked, keep=True)
    l_ctl, g_ctl, _ = full_loss_and_grads(params, gcfg, one, dropped_chunk_attention)
    equal = bool(torch.equal(l_re, l_kept)) and all(torch.equal(a, b)
                                                    for a, b in zip(g_re, g_kept))
    worst = max(max_err(a, b) for a, b in zip(g_re, g_kept))
    ctl_equal = bool(torch.equal(l_ctl, l_kept)) and all(torch.equal(a, b)
                                                         for a, b in zip(g_ctl, g_kept))
    ctl_worst = max(max_err(a, b) for a, b in zip(g_ctl, g_kept))
    print(f"  gate 1, micro 1 x {SEQ}: recomputed loss {l_re.item():.6f} kept {l_kept.item():.6f};"
          f" loss and all {len(g_re)} gradients bit-equal: {equal} (largest |diff| {worst:.3e}, "
          f"bound 0); peak memory recomputed {peak_re / 2**30:.2f} GiB, kept "
          f"{peak_kept / 2**30:.2f} GiB; control (rows {FULL_DROPPED_ROWS} dropped): loss "
          f"{l_ctl.item():.6f}, largest gradient |diff| {ctl_worst:.3e}, bit-equal {ctl_equal}",
          flush=True)
    check(equal, "recomputed chunks give another loss or gradient than kept chunks")
    check(not ctl_equal, "the dropped-chunk control equals the kept chunks")
    del g_re, g_kept, g_ctl

    with torch.no_grad():
        l_flash = transformer_loss(params, gcfg, windows).item()
    l_train = transformer_loss(params, gcfg, windows).item()
    with training_attention(dropped_chunk_attention):
        l_wrong = transformer_loss(params, gcfg, windows).item()
    rel, rel_ctl = abs(l_train - l_flash) / l_flash, abs(l_wrong - l_flash) / l_flash
    print(f"  gate 2, {FULL_GATE_WINDOWS} x {SEQ} validation windows: training path "
          f"{l_train:.6f}, row 13 (no grad) {l_flash:.6f}, rel {rel:.3e} (tol {TOL_LOSS_REL}); "
          f"control (rows {FULL_DROPPED_ROWS} dropped) {l_wrong:.6f}, rel {rel_ctl:.3e} (> tol)",
          flush=True)
    check(math.isfinite(l_train) and rel <= TOL_LOSS_REL,
          "the full model's training loss disagrees with row 13's")
    check(rel_ctl > TOL_LOSS_REL, "the dropped-chunk control passes the training-loss gate")
    del params
    torch.cuda.empty_cache()
    return launches, {"train_s": train_s, "peak_bytes": peak, "losses": losses,
                      "measure_train_tok_s": tps, "recompute_bit_equal": equal,
                      "recompute_peak_bytes": peak_re, "kept_peak_bytes": peak_kept,
                      "control_grad_max_diff": ctl_worst, "loss_train_path": l_train,
                      "loss_row13": l_flash, "loss_rel": rel, "control_loss_rel": rel_ctl}


@contextlib.contextmanager
def kernel_rows_dropped(rows=CPT_DROPPED_ROWS):
    """The kernel path with query rows ``rows`` given zero attention: row
    1's fine and sliding outputs (forward and backward) and row 13's output,
    a kernel that lost those rows.  The plain path is left as it is.  The
    cpt gates' control."""
    real_fine, real_flash = nsa_layer.nsa_fine_sliding_attention, model_module.flash_attention

    def drop(x):
        keep = torch.ones(x.shape[2], 1, dtype=x.dtype, device=x.device)
        keep[slice(*rows)] = 0
        return x * keep

    def fine(*a, use_kernels=True, **k):
        outs = real_fine(*a, use_kernels=use_kernels, **k)
        return tuple(drop(o) for o in outs) if use_kernels else outs

    nsa_layer.nsa_fine_sliding_attention = fine
    model_module.flash_attention = lambda *a, **k: drop(real_flash(*a, **k))
    try:
        yield
    finally:
        nsa_layer.nsa_fine_sliding_attention = real_fine
        model_module.flash_attention = real_flash


def eval_logits_vs_plain(params, cfg, ids):
    """(largest |error|, largest plain logit) of the kernel path's logits on
    ``ids`` (no grad: rows 1 or 13) against the plain path's; the sparse
    model's plain path on the kernel path's selections
    (``prefill_logits_vs_plain``)."""
    with torch.no_grad():
        if cfg.use_sparse_attn:
            return prefill_logits_vs_plain(params, cfg, ids)[:2]
        got = transformer_forward(params, cfg, ids)
        want = transformer_forward(params, cfg, ids, use_kernels=False)
        return max_err(got, want), want.abs().max().item()


def loss_and_grads(params, cfg, ids, use_kernels=True):
    """The training loss on ``ids`` and every gradient."""
    loss = transformer_loss(params, cfg, ids, use_kernels=use_kernels)
    return loss.item(), torch.autograd.grad(loss, tree_leaves(params))


def grad_errs(params, got, want):
    """Relative L2 error of each gradient of ``got`` against ``want``, by key."""
    return {key: rel_l2(a, b) for (key, _), a, b in zip(tree_items(params), got, want)}


def cpt_eval_batches(qa_test, val):
    """The forwards of one CPT eval point: ``compute_ppl`` at batch 4 on the
    QA test bytes and on ``val``, each cut to the script's max tokens."""
    return sum(-(-len(ppl_windows(x[:CPT_EVAL_MAX_TOKENS], CPT_SEQ)[0]) // 4)
               for x in (qa_test, val))


def cpt_phase(smi):
    """Continuous pretraining from each committed export, in the working
    directory: the export written as a port checkpoint at its step (float32
    params), then ``run_continuous_pretrain`` for CPT_STEPS steps at the
    script's defaults (batch 8, seq 512, lr 3e-5, half QA, eval points of
    200,000 bytes) with an eval point every CPT_EVAL_EVERY steps, on the
    CORPUS_BYTES corpus.  Gates: the first logged loss equals
    ``transformer_loss`` of the restored weights on the same batch; the
    final checkpoint's step is the export's + CPT_STEPS; the eval points'
    perplexities are finite; launch counts exact.  Then the kernels at the
    run's shapes, on the restored weights: the sparse model's loss and
    every gradient on the first batch (rows 1, 4, 5 at 8 x 512) against the
    plain path (TOL_LOSS_REL, TOL_GRAD_REL_L2), and both models' logits on
    the first 4 x 512 eval batch (row 1 or 13) against the plain path
    (TOL_LOGITS_REL); each with the CPT_DROPPED_ROWS control
    (``kernel_rows_dropped``), which must fail it."""
    qa_test = load_cs441_qa_bytes(split="test")
    val = load_byte_corpus(train_data())[0][-2_000_000:]
    out = {}
    for name, path in (("sparse_mlp", WEIGHTS), ("full_attn", FULL_WEIGHTS)):
        weights, meta = load_params_npz(path, device="cpu", dtype=torch.float32)
        cfg = model_config_from_meta(meta)
        src = os.path.join("cpt", name)
        save_checkpoint(src, meta["step"], weights, model_cfg=cfg)
        del weights
        log = StepLog(os.path.join(src + "_cpt", "cpt_log.csv"))
        batches, real_step = [], continuous_pretrain.train_step

        def recording_step(params, optimizer, batch, model_cfg, accum):
            if not batches:
                batches.append(batch[0].clone())
            return real_step(params, optimizer, batch, model_cfg, accum)

        zero_launches(ALL_KERNELS)
        t0 = time.perf_counter()
        continuous_pretrain.train_step = recording_step
        try:
            _, loss, final = continuous_pretrain.run_continuous_pretrain(
                src, num_batches=CPT_STEPS, seq_len=CPT_SEQ, eval_every=CPT_EVAL_EVERY,
                eval_max_tokens=CPT_EVAL_MAX_TOKENS, data_cfg=train_data(), logger=log,
                device=DEVICE)
        finally:
            continuous_pretrain.train_step = real_step
        launches = read_launches(ALL_KERNELS)
        seconds = time.perf_counter() - t0
        # the restored weights' loss on the first batch, on the training path
        restored = pretrain.trainable(restore_checkpoint(
            latest_checkpoint(src), ("params",), DEVICE)[0]["params"])
        b0 = batches[0]
        if cfg.use_sparse_attn:
            lk, gk = loss_and_grads(restored, cfg, b0)
            lp, gp = loss_and_grads(restored, cfg, b0, use_kernels=False)
            with kernel_rows_dropped():
                lc, gc = loss_and_grads(restored, cfg, b0)
            errs, ctl_errs = grad_errs(restored, gk, gp), grad_errs(restored, gc, gp)
            worst, ctl_worst = max(errs, key=errs.get), max(ctl_errs, key=ctl_errs.get)
            rel, ctl_rel = abs(lk - lp) / abs(lp), abs(lc - lp) / abs(lp)
            ctl_fails = ctl_rel > TOL_LOSS_REL or ctl_errs[ctl_worst] > TOL_GRAD_REL_L2
            print(f"  cpt {name}: batch {tuple(b0.shape)} loss kernels {lk:.6f} plain {lp:.6f}, "
                  f"rel {rel:.3e} (tol {TOL_LOSS_REL}); gradients rel L2 max "
                  f"{errs[worst]:.3e} at {worst} (tol {TOL_GRAD_REL_L2}) over {len(errs)} "
                  f"tensors; control (rows {CPT_DROPPED_ROWS} dropped): loss rel {ctl_rel:.3e}, "
                  f"gradients rel L2 max {ctl_errs[ctl_worst]:.3e} at {ctl_worst}", flush=True)
            check(math.isfinite(lk) and rel <= TOL_LOSS_REL,
                  f"cpt {name}: kernel-path loss {lk} disagrees with the plain path's {lp}")
            check(all(torch.isfinite(g).all().item() for g in gk),
                  f"cpt {name}: kernel-path gradients not finite")
            check(errs[worst] <= TOL_GRAD_REL_L2, f"cpt {name}: kernel-path gradients disagree")
            check(ctl_fails, f"cpt {name}: the dropped-rows control passes the loss and "
                             f"gradient gates")
            del gk, gp, gc
            train_gate = {"loss_kernels": lk, "loss_plain": lp, "grad_rel_l2_max": errs[worst],
                          "control_loss_rel": ctl_rel,
                          "control_grad_rel_l2_max": ctl_errs[ctl_worst]}
        else:
            # the training forward has no kernel (the recomputed chunks)
            lk, train_gate = transformer_loss(restored, cfg, b0).item(), {}
        first = [lk]
        eval_ids = torch.from_numpy(np.stack(ppl_windows(qa_test[:CPT_EVAL_MAX_TOKENS],
                                                         CPT_SEQ)[0][:4])
                                    .astype(np.int64))[:, :-1].to(DEVICE)
        e_err, e_top = eval_logits_vs_plain(restored, cfg, eval_ids)
        with kernel_rows_dropped():
            c_err, _ = eval_logits_vs_plain(restored, cfg, eval_ids)
        e_tol = TOL_LOGITS_REL * max(e_top, 1.0)
        print(f"  cpt {name}: eval batch {tuple(eval_ids.shape)} logits kernels vs plain "
              f"max|err| {e_err:.4f} (tol {TOL_LOGITS_REL} x {e_top:.2f}); control (rows "
              f"{CPT_DROPPED_ROWS} dropped) {c_err:.4f}", flush=True)
        check(e_err <= e_tol, f"cpt {name}: kernel-path eval logits disagree with the plain path")
        check(c_err > e_tol, f"cpt {name}: the dropped-rows control passes the eval logits gate")
        del restored
        step0 = [m["cpt_loss"] for s, m in log.rows if s == 0 and "cpt_loss" in m]
        evals = [(s, m["ppl_id"], m["ppl_ood"]) for s, m in log.rows if "ppl_id" in m]
        _, final_meta = restore_checkpoint(final, (), device="cpu")
        points = CPT_STEPS // CPT_EVAL_EVERY
        forwards = points * cpt_eval_batches(qa_test, val)
        want = dict.fromkeys((fn.__name__ for fn in ALL_KERNELS), 0)
        if cfg.use_sparse_attn:
            want.update(prefill_fwd=cfg.depth * (CPT_STEPS + forwards),
                        prefill_bwd_dq=cfg.depth * CPT_STEPS, prefill_bwd_dkv=cfg.depth * CPT_STEPS)
        else:
            want["flash_attention"] = cfg.depth * forwards
        print(f"  cpt {name} (step {meta['step']}): {CPT_STEPS} steps in {seconds:.2f}s; first "
              f"logged loss {step0} vs transformer_loss of the restored weights on its batch "
              f"{first} (equal); last loss {loss:.6f}; eval points (step, ppl_id, ppl_ood) "
              f"{evals}; final checkpoint step {final_meta['step']}; launches {launches}; {smi}",
              flush=True)
        check(step0 == first, f"cpt {name}: the first logged loss {step0} is not the restored "
                              f"weights' {first}")
        check(final_meta["step"] == meta["step"] + CPT_STEPS and final_meta["continuous_pretrain"],
              f"cpt {name}: final checkpoint at step {final_meta['step']}")
        check([s for s, *_ in evals] == list(range(CPT_EVAL_EVERY, CPT_STEPS + 1,
                                                   CPT_EVAL_EVERY))
              and all(math.isfinite(x) for _, *p in evals for x in p),
              f"cpt {name}: eval points {evals}")
        check(launches == want, f"cpt {name}: launches {launches}, expected {want}")
        out[name] = {"seconds": seconds, "first_loss": first[0], "last_loss": loss,
                     "evals": evals, "launches": launches, **train_gate,
                     "eval_logits_err": e_err, "eval_logits_scale": e_top,
                     "eval_control_err": c_err}
        torch.cuda.empty_cache()
    return out


def compress_phase(smi):
    """Each compressor the trained exports do not use, on the reference
    model from a seeded random init (float32 masters, bf16 compute):
    prefill COMPRESS_BATCH x COMPRESS_PROMPT through row 1 into a
    MAX_LEN-row cache, then COMPRESS_GEN greedy steps on the split route
    (rows 2-3; the fused routes take only mlp), captured; launch counts read
    around exactly that run.  Gates: the prefill logits against the plain
    path on the kernel path's selections (TOL_LOGITS_REL), the first decode
    step's logits against the plain step's, rows 2-3 on layer 0's inputs
    of that step (``select_gate`` / ``attend_gate`` with their controls);
    one training micro-step at COMPRESS_MICRO x SEQ through rows 1, 4, 5,
    its loss (TOL_LOSS_REL) and every gradient (TOL_GRAD_REL_L2) against
    the plain path, its launches counted."""
    counted = ALL_KERNELS
    out = {}
    for kind in NEW_COMPRESSORS:
        t0 = time.perf_counter()
        cfg = nsa_tpu_torch.reference_model_config(compressor=kind).replace(dtype="bfloat16")
        params = pretrain.trainable(init_transformer(cfg, torch.Generator().manual_seed(SEED),
                                                     device="cpu"), DEVICE)
        stride = cfg.nsa.compress_block_sliding_stride
        ids = seeded_ids(COMPRESS_BATCH, COMPRESS_PROMPT, cfg.vocab_size, SEED, DEVICE)
        with torch.no_grad():
            zero_launches(counted)
            logits, cache = transformer_prefill(params, cfg, ids, MAX_LEN)
            first = logits[:, -1].argmax(-1)
            plain_cache = clone_cache(cache)
            with first_launch_operands() as rec:
                step0, cache = transformer_decode_step(params, cfg, first, cache)
            tokens = greedy_decode(params, cfg, step0.argmax(-1), cache, COMPRESS_GEN - 1)
            launches = read_launches(counted)
            want = dict.fromkeys((fn.__name__ for fn in counted), 0)
            want.update(prefill_fwd=cfg.depth, decode_select=cfg.depth * COMPRESS_GEN,
                        decode_attend=cfg.depth * COMPRESS_GEN)
            check(launches == want, f"{kind}: decode-path launches {launches}, expected {want}")
            check(tuple(tokens.shape) == (COMPRESS_BATCH, COMPRESS_GEN - 1)
                  and bool(torch.isfinite(logits).all()), f"{kind}: prefill or decode malformed")
            pre_err, pre_scale, flipped = prefill_logits_vs_plain(params, cfg, ids)
            plain0, _ = transformer_decode_step(params, cfg, first, plain_cache, use_kernels=False)
            err0, scale0 = max_err(step0, plain0), plain0.abs().max().item()
            del plain_cache
            print(f"  {kind}: decode launches {launches}; prefill logits vs plain on the same "
                  f"selections max|err| {pre_err:.4f} (tol {TOL_LOGITS_REL} x {pre_scale:.2f}), "
                  f"{flipped} positions differ by more on the plain path's own; first step's "
                  f"logits max|err| {err0:.4f} (tol {TOL_LOGITS_REL} x {scale0:.2f})", flush=True)
            check(pre_err <= TOL_LOGITS_REL * max(pre_scale, 1.0),
                  f"{kind}: kernel-path prefill logits disagree with the plain path")
            check(err0 <= TOL_LOGITS_REL * max(scale0, 1.0),
                  f"{kind}: kernel-path decode logits disagree with the plain path")
            q, ckv, mem_kv, t = rec["decode_select"][:4]
            t = int(t)
            _, _, c_p, info_p, sel = select_gate(q, ckv, mem_kv, t, t // stride, cfg,
                                                 f"{kind} decode_select")
            rq, kv, _, _, gates = rec["decode_attend"][:5]
            _, att = attend_gate(rq, kv, info_p, c_p, gates, t, cfg, f"{kind} decode_attend")
            del cache, rec, logits

        micro = seeded_ids(COMPRESS_MICRO, SEQ + 1, cfg.vocab_size, SEED + 1, DEVICE)
        leaves = tree_leaves(params)
        zero_launches(counted)
        loss_k = transformer_loss(params, cfg, micro)
        grads_k = torch.autograd.grad(loss_k, leaves)
        train_launches = read_launches(counted)
        loss_p = transformer_loss(params, cfg, micro, use_kernels=False)
        grads_p = torch.autograd.grad(loss_p, leaves)
        lk, lp = loss_k.item(), loss_p.item()
        named = {key: (a, b) for (key, _), a, b in zip(tree_items(params), grads_k, grads_p)}
        errs = {}
        for key, (a, b) in named.items():
            if key.endswith(ZERO_GRAD_LEAF):
                # zero in exact arithmetic: the difference against the
                # same layer's query bias, whose gradient is not
                sibling = named[key.removesuffix(ZERO_GRAD_LEAF) + "['b_q']"][1]
                errs[key] = (a.float() - b.float()).norm().item() / sibling.float().norm().item()
            else:
                errs[key] = rel_l2(a, b)
        worst = max(errs, key=errs.get)
        zero = [v for k, v in errs.items() if k.endswith(ZERO_GRAD_LEAF)]
        want = dict.fromkeys((fn.__name__ for fn in counted), 0)
        want.update(prefill_fwd=cfg.depth, prefill_bwd_dq=cfg.depth, prefill_bwd_dkv=cfg.depth)
        seconds = time.perf_counter() - t0
        print(f"  {kind}: micro-step {COMPRESS_MICRO}x{SEQ} loss kernels {lk:.6f} plain {lp:.6f}; "
              f"gradients rel L2 max {errs[worst]:.3e} at {worst} (tol {TOL_GRAD_REL_L2}) over "
              f"{len(errs)} tensors" + (f" ({len(zero)} key biases against their query bias's "
                                        f"gradient, max {max(zero):.3e})" if zero else "") +
              f"; launches {train_launches}; {seconds:.2f}s; {smi}", flush=True)
        check(train_launches == want, f"{kind}: micro-step launches {train_launches}, "
                                      f"expected {want}")
        check(math.isfinite(lk) and abs(lk - lp) <= TOL_LOSS_REL * abs(lp),
              f"{kind}: kernel-path loss {lk} disagrees with the plain path's {lp}")
        check(all(torch.isfinite(g).all().item() for g in grads_k),
              f"{kind}: kernel-path gradients not finite")
        check(errs[worst] <= TOL_GRAD_REL_L2, f"{kind}: kernel-path gradients disagree")
        out[kind] = {"seconds": seconds, "decode_launches": launches,
                     "train_launches": train_launches, "prefill_logits_err": pre_err,
                     "prefill_logits_scale": pre_scale, "step_logits_err": err0,
                     "decode_select": sel, "decode_attend": att, "loss_kernels": lk,
                     "loss_plain": lp, "grad_rel_l2_max": errs[worst]}
        del params, grads_k, grads_p, leaves
        decode_graph.clear()
        torch.cuda.empty_cache()
    return out


def config_model(name):
    """The reference widths with ``name``'s NSA settings (CONFIG_NSA), bf16
    compute, float32 masters from a seeded random init on the card."""
    base = nsa_tpu_torch.reference_model_config().replace(dtype="bfloat16")
    cfg = base.replace(nsa=dataclasses.replace(base.nsa, **CONFIG_NSA[name]),
                       causal=name != "non_causal")
    return cfg, pretrain.trainable(init_transformer(cfg, torch.Generator().manual_seed(SEED),
                                                    device="cpu"), DEVICE)


def no_launches(label, launches, **want):
    """Every counted kernel launched 0 times but ``want``'s."""
    want = {**dict.fromkeys(launches, 0), **want}
    check(launches == want, f"{label}: launches {launches}, expected {want}")


@contextlib.contextmanager
def dropped_diagonal_block():
    """The XLA decode branches, and the split pair's plain versions, with
    each query's own selection block (the last trailing block, the fine
    branch's diagonal) left out of the step: its id marked before the
    sequence start.  The control the incremental decode gates must fail."""
    real = nsa_layer.trailing_blocks

    def dropped(t, sel_block, n_slide, device):
        trail = real(t, sel_block, n_slide, device)
        return torch.cat([trail[..., :-1], torch.full_like(trail[..., -1:], -1)], dim=-1)

    nsa_layer.trailing_blocks = nsa_decode.trailing_blocks = dropped
    try:
        yield
    finally:
        nsa_layer.trailing_blocks = nsa_decode.trailing_blocks = real


@contextlib.contextmanager
def zeroed_fine_branch():
    """The XLA path's fine branch zeroed in the first layer that runs it (the
    layer's blocks, ``kb``, identify its chunks, recomputed ones too).  The
    control the training gates must fail."""
    real = nsa_layer.fine_attend_core
    first = []

    def zeroed(q, kb, *a, **k):
        out = real(q, kb, *a, **k)
        first.append(first[0] if first else kb.data_ptr())
        return out * 0 if kb.data_ptr() == first[0] else out

    nsa_layer.fine_attend_core = zeroed
    try:
        yield
    finally:
        nsa_layer.fine_attend_core = real


def teacher_forced(params, cfg, tokens, cache, **kw):
    """Eager decode steps from ``cache`` (written in place), each consuming
    its column of ``tokens`` (``kw``: transformer_decode_step's keywords):
    the logits [b, steps, vocab]."""
    outs = []
    for i in range(tokens.shape[1]):
        lg, cache = transformer_decode_step(params, cfg, tokens[:, i], cache, **kw)
        outs.append(lg)
    return torch.stack(outs, 1)


@contextlib.contextmanager
def recorded_selections():
    """The info rows of every ``decode_select`` call of the layer, kernel
    or plain, in call order (one a layer a step), in the list yielded."""
    rec, real = [], (nsa_layer.decode_select, nsa_layer.decode_select_plain)

    def recording(fn):
        def select(*a, **k):
            c_out, info = fn(*a, **k)
            rec.append(info)
            return c_out, info
        return select

    nsa_layer.decode_select, nsa_layer.decode_select_plain = map(recording, real)
    try:
        yield rec
    finally:
        nsa_layer.decode_select, nsa_layer.decode_select_plain = real


def paired_steps(params, cfg, tokens, cache, ref, variants, same_selections=False):
    """Decode steps consuming ``tokens`` from ``cache`` on the reference
    route (``ref``: transformer_decode_step's keywords), and before each
    step every variant (name: (a context manager factory, keywords)) from a
    copy of the same cache state, so the routes' caches never drift apart:
    for each variant, the largest ``rel_gate`` figure over the steps.

    With ``same_selections`` (routes whose layers select through
    ``decode_select``) a row is held only where every layer selected the
    same blocks on both routes: the routes round a layer's output at other
    points, which moves a later layer's query by a rounding and can flip a
    near tie among its selection scores, a discrete change the gate is not
    about.  Layer 0, whose inputs are the same bits on both routes, must
    select the same blocks.  Returns (figures, {name: (row-steps left out,
    row-steps whose layer 0 selected other blocks, the figure over every
    row, the steps held of each batch row [b])})."""
    spare = clone_cache(cache)
    worst = dict.fromkeys(variants, 0.0)
    every = dict.fromkeys(variants, 0.0)
    flipped = {name: [0, 0] for name in variants}
    held = {name: torch.zeros(tokens.shape[0], dtype=torch.long, device=tokens.device)
            for name in variants}
    cols = 2 * cfg.nsa.num_selected_blocks + \
        -(-cfg.nsa.sliding_window_size // cfg.nsa.selection_block_size) + 1

    def selections(rec):       # [b, layers, kvh * cols]
        return torch.stack([x.reshape(x.shape[0], -1, x.shape[-1])[..., :cols].flatten(1)
                            for x in rec], 1) if rec else None

    for i in range(tokens.shape[1]):
        got, sel = {}, {}
        spare = spare._replace(seq_len=cache.seq_len)
        for name, (ctx, kw) in variants.items():
            copy_cache(spare, cache)
            with ctx(), recorded_selections() as rec:
                got[name], _ = transformer_decode_step(params, cfg, tokens[:, i], spare, **kw)
            sel[name] = selections(rec)
        with recorded_selections() as rec:
            want, cache = transformer_decode_step(params, cfg, tokens[:, i], cache, **ref)
        sel_ref = selections(rec)
        scale = max(want.abs().max().item(), 1.0)
        for name, lg in got.items():
            err = (lg.float() - want.float()).abs().amax(-1)
            every[name] = max(every[name], err.max().item() / scale)
            if same_selections:
                equal = sel[name] == sel_ref                       # [b, layers, kvh * cols]
                same = equal.flatten(1).all(-1)
                flipped[name][0] += int((~same).sum())
                flipped[name][1] += int((~equal[:, 0].all(-1)).sum())
                held[name] += same.long()
                err = err[same]
            else:
                held[name] += 1
            worst[name] = max(worst[name], err.max().item() / scale if err.numel() else 0.0)
    return worst, {name: (*flipped[name], every[name], held[name].cpu()) for name in variants}


def rel_gate(got, want):
    """max |got - want| over max |want| (at least 1): the 2% gate's figure."""
    return max_err(got, want) / max(want.abs().max().item(), 1.0)


def config_train_gate(name, params, cfg, micro):
    """One training step's loss and every gradient in bf16 against the same
    step in float32 on the card, and the same with one layer's fine branch
    zeroed (the control); the bf16 step's peak memory and launches."""
    zero_launches(ALL_KERNELS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lb, gb = loss_and_grads(params, cfg, micro)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    no_launches(f"{name} training step", read_launches(ALL_KERNELS))
    lf, gf = loss_and_grads(params, cfg.replace(dtype="float32"), micro)
    with zeroed_fine_branch():
        lc, gc = loss_and_grads(params, cfg, micro)
    _, again = loss_and_grads(params, cfg, micro)
    repeat_equal = all(torch.equal(a, b) for a, b in zip(gb, again))
    del again
    keys = [k for k, _ in tree_items(params)]
    out = {"bf16_repeat_bit_equal": repeat_equal}
    for label, loss, grads in (("bf16", lb, gb), ("control", lc, gc)):
        errs = grad_errs(params, grads, gf)
        for i, key in enumerate(keys):
            if key.endswith(SHIFT_GRAD_LEAF):
                sibling = gf[keys.index(key.replace("['k_compress']", "['v_compress']"))]
                errs[key] = (grads[i].float() - gf[i].float()).norm().item() / \
                    sibling.float().norm().item()
        top = sorted(errs, key=errs.get, reverse=True)[:3]
        out[label] = {"loss": loss, "loss_rel": abs(loss - lf) / abs(lf),
                      "grad_rel_l2_max": errs[top[0]], "at": top[0],
                      "next": {k: errs[k] for k in top[1:]}}
    del gb, gf, gc
    b = out["bf16"]
    print(f"  {name}: training step {tuple(micro.shape)} bf16 loss {lb:.6f} float32 {lf:.6f} "
          f"(rel {b['loss_rel']:.2e}, tol {TOL_LOSS_REL}); gradients rel L2 max "
          f"{b['grad_rel_l2_max']:.3e} at {b['at']} (tol {TOL_GRAD_REL_L2}; next {b['next']}; "
          f"the bf16 step again bit for bit: {repeat_equal}); control (layer 0's "
          f"fine branch zeroed) loss rel {out['control']['loss_rel']:.2e}, gradients "
          f"{out['control']['grad_rel_l2_max']:.3e} at {out['control']['at']}; step "
          f"{step_s:.2f}s, peak {peak / 2**30:.2f} GiB", flush=True)
    check(math.isfinite(lb) and b["loss_rel"] <= TOL_LOSS_REL,
          f"{name}: bf16 training loss disagrees with float32's")
    check(b["grad_rel_l2_max"] <= TOL_GRAD_REL_L2, f"{name}: bf16 gradients disagree")
    check(out["control"]["loss_rel"] > TOL_LOSS_REL
          or out["control"]["grad_rel_l2_max"] > TOL_GRAD_REL_L2,
          f"{name}: the training gates pass a step with a fine branch zeroed")
    return {"loss_float32": lf, **out, "step_s": step_s, "peak_bytes": peak}


def config_decode(name, params, cfg, smi):
    """A decodable configuration: prefill, captured greedy decode, the
    incremental-vs-full gate with its control, captured vs eager, row 11's
    gather, the engine; launches counted around each path's run."""
    out = {}
    gathers = cfg.depth if cfg.nsa.num_compress_per_fine == 1 else 0  # row 11 a layer a step
    ids = seeded_ids(CONFIG_BATCH, PROMPT, cfg.vocab_size, SEED, DEVICE)
    with torch.inference_mode():
        zero_launches(ALL_KERNELS)
        t0 = time.perf_counter()
        logits, cache = transformer_prefill(params, cfg, ids, MAX_LEN)
        torch.cuda.synchronize()
        out["prefill_s"] = time.perf_counter() - t0
        no_launches(f"{name} prefill", read_launches(ALL_KERNELS))
        first = logits[:, -1].argmax(-1)
        run = clone_cache(cache)
        zero_launches(ALL_KERNELS)
        s_, e_ = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s_.record()
        tokens = greedy_decode(params, cfg, first, run, CONFIG_GEN)
        e_.record()
        launches = read_launches(ALL_KERNELS)
        decode_s = s_.elapsed_time(e_) / 1e3
        no_launches(f"{name} decode", launches, paged_gather=gathers * CONFIG_GEN)
        out.update(decode_s=decode_s, decode_tok_s=CONFIG_BATCH * CONFIG_GEN / decode_s,
                   decode_launches=launches)
        check(tuple(tokens.shape) == (CONFIG_BATCH, CONFIG_GEN) and bool(torch.isfinite(
            logits).all()), f"{name}: prefill or decode malformed")

        # captured against eager, from the prefill's cache
        caches = []
        for capture in (False, True):
            copy_cache(run, cache)
            toks = greedy_decode(params, cfg, first, run, CONFIG_GEN, capture=capture)
            caches.append((toks, [x.clone() for lc in run.layers for x in lc]))
        check(torch.equal(caches[0][0], caches[1][0]) and torch.equal(caches[0][0], tokens)
              and all(torch.equal(x, y) for x, y in zip(caches[0][1], caches[1][1])),
              f"{name}: captured decode differs from eager")
        del caches
        lg = []
        for capture in (False, True):
            copy_cache(run, cache)
            lg.append(step_logits(params, cfg, first, run, None, capture))
        check(torch.equal(lg[0], lg[1]), f"{name}: captured step logits differ from eager")

        # incremental decode against the full forward over the same ids
        copy_cache(run, cache)
        with first_launch_operands() as rec:
            inc = teacher_forced(params, cfg, tokens, run)
        check(torch.equal(inc[:, :-1].argmax(-1), tokens[:, 1:]),
              f"{name}: teacher-forced steps pick other tokens than the loop")
        full = transformer_forward(params, cfg, torch.cat([ids, tokens], 1))[:, PROMPT:]
        copy_cache(run, cache)
        with dropped_diagonal_block():
            ctrl = teacher_forced(params, cfg, tokens, run)
        out["incremental_vs_full"], out["control_dropped_diagonal"] = \
            rel_gate(inc, full), rel_gate(ctrl, full)
        del full, ctrl, inc
        if gathers:
            out["gather_bit_equal"] = gather_gate(f"{name} paged_gather",
                                                  *rec["paged_gather"])["bit_equal"]
        print(f"  {name}: prefill {CONFIG_BATCH}x{PROMPT} {out['prefill_s']:.3f}s; "
              f"{CONFIG_GEN} captured greedy steps {decode_s:.3f}s = {out['decode_tok_s']:.1f} "
              f"tok/s; launches { {k: v for k, v in launches.items() if v} }; captured = eager; "
              f"incremental vs full forward {out['incremental_vs_full']:.4f} of max|logit| "
              f"(tol {TOL_LOGITS_REL}), control (diagonal block dropped) "
              f"{out['control_dropped_diagonal']:.4f}" +
              (f"; row 11 bit for bit its plain version" if gathers else "") + f"; {smi}",
              flush=True)
        check(out["incremental_vs_full"] <= TOL_LOGITS_REL,
              f"{name}: incremental decode disagrees with the full forward")
        check(out["control_dropped_diagonal"] > TOL_LOGITS_REL,
              f"{name}: the incremental gate passes a decode without the diagonal block")
        del cache, run, logits

        # the engine on the dense pool, each request against its own
        # greedy_decode: in bf16 (the share of equal tokens: the two run
        # other matrix shapes, whose bf16 roundings differ, and a random
        # init's near-flat logits turn on them), and in float32 token for token
        rs = np.random.RandomState(SEED + 2)
        reqs = [(rs.randint(32, 127, size=rs.randint(CONFIG_PROMPT_MIN, PROMPT + 1)).astype(
                     np.int32), int(rs.randint(16, 33))) for _ in range(CONFIG_REQUESTS)]
        for dtype in ("bfloat16", "float32"):
            c = cfg.replace(dtype=dtype)
            got, _, wall, launches, steps, waves, _, _ = run_engine(params, c, reqs,
                                                                    steps_per_sync=SERVE_SYNC)
            no_launches(f"{name} engine {dtype}", launches, paged_gather=gathers * steps)
            equal = []
            for (p, n), toks in zip(reqs, got):
                lgp, c1 = transformer_prefill(params, c, torch.from_numpy(p)[None].to(DEVICE),
                                              MAX_LEN)
                own = greedy_decode(params, c, lgp[:, -1].argmax(-1), c1, n, capture=False)
                equal.append(np.array_equal(toks, own[0].cpu().numpy()))
            out[f"engine_{dtype}"] = {"s": wall, "steps": steps, "waves": waves,
                                      "new_tok_s": sum(len(t) for t in got) / wall,
                                      "requests_equal_own_greedy": sum(equal)}
            print(f"  {name}: engine {dtype}, {CONFIG_REQUESTS} requests on the dense pool, "
                  f"{steps} ragged steps, {waves} prefill waves, {wall:.3f}s, "
                  f"{out[f'engine_{dtype}']['new_tok_s']:.1f} new tok/s; {sum(equal)} of "
                  f"{len(reqs)} requests' tokens equal their own greedy_decode; launches "
                  f"{ {k: v for k, v in launches.items() if v} }", flush=True)
        check(all(equal), f"{name}: the float32 engine's tokens differ from the requests' own "
                          f"greedy_decode")
    decode_graph.clear()
    return out


@contextlib.contextmanager
def hybrid_dropped_block():
    """The hybrid route's plain attend with each (row, KV head)'s first
    valid selected block left out (``without_first_selected``).  The control
    the hybrid gate must fail."""
    real = nsa_layer.decode_attend_fused_plain

    def dropped(rq, kv, kv_new, info, *a, **k):
        return real(rq, kv, kv_new, nsa_decode_ragged.without_first_selected(
            info, k["num_sel"], k["n_slide"]), *a, **k)

    nsa_layer.decode_attend_fused_plain = dropped
    try:
        yield
    finally:
        nsa_layer.decode_attend_fused_plain = real


@contextlib.contextmanager
def held_attend_fused(rec):
    """Row 7 in the NSA layer wrapped so that each launch is held on its own
    operands against its plain version, as the kernels phase holds it at
    bs 8: the output within TOL_FUSED of the largest value, the kv cache it
    leaves bit for bit the plain version's (the old one with row t
    written), a second launch bit for bit, whose combined attention output
    is held element by element to ``attend_tolerance``; and the plain
    version with each (row, KV head)'s first selected block left out
    (``without_first_selected``), the control of the attention output; the
    plain version with the FF left out (a kernel that returned before its
    FF), the output gate's control, which perturbs the layer's own
    contribution to the output and not the residual stream that sets the
    gate's scale.  One dict of figures a launch, each over its bound, in
    ``rec``, with the element that sets the attention output's figure
    (``worst_element``)."""
    real = nsa_layer.decode_attend_fused

    def attend(rq, kv, kv_new, info, c_out, gates, x, w_out, t, ff=(), **k):
        before = kv.clone()
        out = real(rq, kv, kv_new, info, c_out, gates, x, w_out, t, ff, **k)
        args = (kv_new, info, c_out, gates, x, w_out, t, ff)
        kv_p, again, comb = before.clone(), before.clone(), torch.empty_like(rq)
        out_p = nsa_decode_fused.decode_attend_fused_plain(rq, kv_p, *args, **k)
        out_2 = real(rq, again, *args, attn_out=comb, **k)
        dropped = nsa_decode_ragged.without_first_selected(info, k["num_sel"], k["n_slide"])
        out_c = nsa_decode_fused.decode_attend_fused_plain(rq, before, kv_new, dropped,
                                                           *args[2:], **k)
        out_f = nsa_decode_fused.decode_attend_fused_plain(rq, before.clone(), *args[:-1], (),
                                                           **k)
        tkw = {n: v for n, v in k.items() if n != "eps"}
        want, tol = nsa_decode_ragged.attend_tolerance(rq, kv_p, info, c_out, gates, t, **tkw)
        wrong, _ = nsa_decode_ragged.attend_tolerance(rq, kv_p, dropped, c_out, gates, t, **tkw)
        gate = TOL_FUSED * out_p.float().abs().max().item()
        ratio = (comb.float() - want.float()).abs() / tol
        worst = int(ratio.argmax())
        got_w, want_w, tol_w = (z.flatten()[worst].float().item() for z in (comb, want, tol))
        rel_w = 2.0 ** -7 * abs(want_w)
        rec.append({"out": max_err(out, out_p) / gate,
                    "attend": ratio.max().item(),
                    "worst_element": {
                        "index (row, kv head, query, dim)": [int(i) for i in np.unravel_index(
                            worst, tuple(comb.shape))],
                        "kernel": got_w, "plain": want_w, "bound": tol_w,
                        "bound 2^-7 |plain|": rel_w, "bound 2^-15 |combine|": tol_w - rel_w,
                        "bf16 ulps of plain": abs(got_w - want_w) / 2.0 ** (
                            math.floor(math.log2(abs(want_w))) - 7) if want_w else None},
                    "control_ff": max_err(out_f, out_p) / gate if ff else None,
                    "control_out": max_err(out_c, out_p) / gate,
                    "control_attend": ((wrong.float() - want.float()).abs() / tol).max().item(),
                    "kv_equal": torch.equal(kv, kv_p) and torch.equal(again, kv),
                    "again_equal": torch.equal(out_2, out),
                    "finite": bool(torch.isfinite(out.float()).all())})
        del before, kv_p, again, ratio
        return out

    nsa_layer.decode_attend_fused = attend
    try:
        yield rec
    finally:
        nsa_layer.decode_attend_fused = real


@contextlib.contextmanager
def layer0_ff_left_out():
    """``NSA_NO_FF_FUSE`` with layer 0's FF left out of every step (the
    FF-outside route's first ``ff_apply_gelu`` call of each step returns
    zeros).  The control the FF-outside gate must fail."""
    real, calls = nsa_layer.ff_apply_gelu, [0]

    def ff(ffp, c, x):
        calls[0] += 1
        return torch.zeros_like(x) if calls[0] % c.depth == 1 else real(ffp, c, x)

    nsa_layer.ff_apply_gelu = ff
    try:
        with env_set("NSA_NO_FF_FUSE"):
            yield
    finally:
        nsa_layer.ff_apply_gelu = real


@contextlib.contextmanager
def env_set(name, value="1"):
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            del os.environ[name]
        else:
            os.environ[name] = old


def hybrid_route(params, cfg, smi):
    """The hybrid route (rows 2 + 7) at the serving cell on the committed
    weights: launches, the split route's tokens teacher-forced through both
    routes with a dropped-block control, row 7's plan at bs 64, tok/s in
    turns (split, hybrid, hybrid, split); then the FF outside rows 6-7 at
    bs 8 (``NSA_NO_FF_FUSE``) against the FF inside, with a control."""
    out = {}
    packed = fuse_decode_params(params, cfg)
    ids = seeded_ids(BATCH, PROMPT, cfg.vocab_size, SEED, DEVICE)
    logits, cache = transformer_prefill(packed, cfg, ids, MAX_LEN)
    first = logits[:, -1].argmax(-1)
    run = clone_cache(cache)
    tokens, _ = decode_run(packed, cfg, first, run, route="split")
    copy_cache(run, cache)
    zero_launches(ALL_KERNELS)
    hyb_tokens, _ = decode_run(packed, cfg, first, run, route="hybrid")
    launches = read_launches(ALL_KERNELS)
    no_launches("hybrid route", launches, decode_select=cfg.depth * GEN,
                decode_attend_fused=cfg.depth * GEN)
    out["launches"] = launches
    nsa = cfg.nsa
    rq = torch.empty((BATCH, cfg.kv_heads, cfg.num_grouped_queries, cfg.dim_head),
                     dtype=torch.bfloat16, device=DEVICE)
    out["row7_plan_bs64"] = nsa_decode_ragged.attend_plan(
        rq, cfg.dim, packed["layers"][0]["ff"]["decode_fused"]["w1"].shape[1],
        sel_block=nsa.selection_block_size, num_sel=nsa.num_selected_blocks,
        n_slide=-(-nsa.sliding_window_size // nsa.selection_block_size) + 1)
    copy_cache(run, cache)
    gate, flipped = paired_steps(packed, cfg, tokens, run, dict(route="split"), {
        "hybrid": (contextlib.nullcontext, dict(route="hybrid")),
        "control": (hybrid_dropped_block, dict(route="hybrid", use_kernels=False))},
        same_selections=True)
    out["hybrid_vs_split"], out["control_dropped_block"] = gate["hybrid"], gate["control"]
    out["rows_selection_flipped"] = {k: v[0] for k, v in flipped.items()}
    out["hybrid_vs_split_every_row"] = flipped["hybrid"][2]
    held_rows = flipped["hybrid"][3]
    out["held_share"] = held_rows.sum().item() / (BATCH * GEN)
    out["held_steps_per_row"] = {"min": int(held_rows.min()), "max": int(held_rows.max())}
    out["tokens_equal_share"] = (hyb_tokens == tokens).float().mean().item()
    print(f"  hybrid route bs {BATCH} prompt {PROMPT} gen {GEN}: launches "
          f"{ {k: v for k, v in launches.items() if v} }; each step of the split route's tokens "
          f"from the split route's cache state, logits {out['hybrid_vs_split']:.4f} of "
          f"max|logit| at most (tol {TOL_LOGITS_REL}) over the row-steps whose every layer "
          f"selected the same blocks on both routes: {100 * out['held_share']:.1f}% of them "
          f"(at least {100 * HYBRID_HELD_MIN:.0f}%; {flipped['hybrid'][0]} of {BATCH * GEN} "
          f"left out, {flipped['hybrid'][1]} in layer 0), each batch row in "
          f"{out['held_steps_per_row']['min']}-{out['held_steps_per_row']['max']} of {GEN} "
          f"steps (at least 1); {flipped['hybrid'][2]:.4f} over every row; control (each "
          f"row's first selected block dropped, plain) {out['control_dropped_block']:.4f} "
          f"({flipped['control'][0]} row-steps left out); its own greedy tokens equal the "
          f"split route's on {100 * out['tokens_equal_share']:.1f}%; row 7's plan at bs "
          f"{BATCH} {out['row7_plan_bs64']}", flush=True)
    check(out["hybrid_vs_split"] <= TOL_LOGITS_REL,
          "hybrid route logits disagree with the split route's")
    check(flipped["hybrid"][1] == 0,
          f"layer 0 of the hybrid route selects other blocks than the split route's in "
          f"{flipped['hybrid'][1]} row-steps: the same kernel on the same inputs")
    check(out["held_share"] >= HYBRID_HELD_MIN and out["held_steps_per_row"]["min"] >= 1,
          "the hybrid gate holds too few row-steps, or leaves a batch row out of every step")
    check(out["control_dropped_block"] > TOL_LOGITS_REL,
          "the hybrid gate passes an attend without a selected block")

    # row 7 at the path's own shapes: every launch of the route's first
    # HYBRID_HELD_STEPS steps, held on its own operands
    copy_cache(run, cache)
    rec = []
    with held_attend_fused(rec):
        teacher_forced(packed, cfg, tokens[:, :HYBRID_HELD_STEPS], run, route="hybrid")
    check(len(rec) == cfg.depth * HYBRID_HELD_STEPS,
          f"row 7 held on {len(rec)} launches, expected {cfg.depth * HYBRID_HELD_STEPS}")
    r7 = {"launches": len(rec)}
    for k in rec[0]:
        if k == "worst_element":
            continue
        v = [r[k] for r in rec]
        r7[k] = max(v) if k in ("out", "attend") else min(v) if k.startswith("control") \
            else all(v)
    r7["control_out_max"] = max(r["control_out"] for r in rec)
    r7["attend_worst_element"] = max(rec, key=lambda r: r["attend"])["worst_element"]
    out["row7_bs64"] = r7
    print(f"  row 7 on the hybrid route at bs {BATCH}, {len(rec)} launches (every layer, "
          f"{HYBRID_HELD_STEPS} steps), each on its own operands against its plain version: "
          f"output worst |err| / (TOL_FUSED x max) {r7['out']:.4f} (<= 1), attention output "
          f"worst |err| / attend_tolerance {r7['attend']:.4f} (<= 1), finite {r7['finite']}; "
          f"kv cache bit for bit the plain version's: {r7['kv_equal']}; a second launch "
          f"bit-equal: {r7['again_equal']}; the control (each row's first selected block left "
          f"out) at least {r7['control_attend']:.1f} of attend_tolerance (> 1), output "
          f"{r7['control_out']:.3f}-{r7['control_out_max']:.3f} of its gate (the largest > 1); the "
          f"output gate's control (the FF left out) at least {r7['control_ff']:.2f} of its gate "
          f"(>= 2 on every launch); the attention output's worst element "
          f"{r7['attend_worst_element']}", flush=True)
    check(r7["out"] <= 1.0 and r7["attend"] <= 1.0 and r7["finite"],
          "decode_attend_fused on the hybrid route disagrees with its plain version")
    check(r7["kv_equal"] and r7["again_equal"],
          "decode_attend_fused on the hybrid route: the kv cache differs from the plain "
          "version's, or a second launch gives other bits")
    check(r7["control_attend"] > 1.0 and r7["control_out_max"] > 1.0,
          "decode_attend_fused on the hybrid route: the dropped-block control passes")
    check(r7["control_ff"] >= 2.0,
          "decode_attend_fused on the hybrid route: the FF-left-out control fails the output "
          "gate by less than twice it on some launch")

    tps = {"split": [], "hybrid": []}
    for route in ("split", "hybrid", "hybrid", "split"):
        copy_cache(run, cache)
        _, sec = decode_run(packed, cfg, first, run, route=route)
        tps[route].append(BATCH * GEN / sec)
    out["tok_s"] = tps
    print(f"  hybrid route bs {BATCH}: captured tok/s in turns split / hybrid / hybrid / "
          f"split: {tps['split'][0]:.1f} / {tps['hybrid'][0]:.1f} / {tps['hybrid'][1]:.1f} / "
          f"{tps['split'][1]:.1f}; {smi}", flush=True)
    del run, cache, logits

    # the FF outside the fused pair (rows 6-7) at bs 8, teacher-forced on
    # the FF-inside route's greedy tokens
    b = FF_OUTSIDE_BATCH
    logits, cache = transformer_prefill(packed, cfg, ids[:b], MAX_LEN)
    run = clone_cache(cache)
    forced = greedy_decode(packed, cfg, logits[:, -1].argmax(-1), run, FF_STEPS, route="fused",
                           capture=False)
    copy_cache(run, cache)
    zero_launches(ALL_KERNELS)
    with env_set("NSA_NO_FF_FUSE"):
        greedy_decode(packed, cfg, forced[:, 0], run, FF_STEPS, route="fused", capture=False)
    counts = read_launches(ALL_KERNELS)
    no_launches("FF outside", counts, decode_select_emit=cfg.depth * FF_STEPS,
                decode_attend_fused=cfg.depth * FF_STEPS)
    copy_cache(run, cache)
    gate, _ = paired_steps(packed, cfg, forced, run, dict(route="fused"), {
        "outside": (lambda: env_set("NSA_NO_FF_FUSE"), dict(route="fused")),
        "control": (layer0_ff_left_out, dict(route="fused"))})
    out["ff_outside_vs_inside"], out["ff_outside_control"] = gate["outside"], gate["control"]
    print(f"  FF outside rows 6-7 (NSA_NO_FF_FUSE) bs {b}, {FF_STEPS} steps each from the FF "
          f"inside's cache state: "
          f"logits vs the FF inside {out['ff_outside_vs_inside']:.4f} of max|logit| (tol "
          f"{TOL_LOGITS_REL}), control (layer 0's FF left out) "
          f"{out['ff_outside_control']:.4f}; launches "
          f"{ {k: v for k, v in counts.items() if v} }; {smi}", flush=True)
    check(out["ff_outside_vs_inside"] <= TOL_LOGITS_REL,
          "FF-outside logits disagree with the FF inside the kernel")
    check(out["ff_outside_control"] > TOL_LOGITS_REL,
          "the FF-outside gate passes a step without layer 0's FF")
    decode_graph.clear()
    return out


def configs_phase(smi):
    """The NSA configurations that JAX runs on its XLA path (per-head
    selection, selection block = stride, non-causal) at the reference
    widths from a seeded init, and the hybrid and FF-outside decode routes
    on the committed weights."""
    out = {}
    for name in CONFIG_NSA:
        t0 = time.perf_counter()
        cfg, params = config_model(name)
        res = {}
        if name == "non_causal":
            with torch.inference_mode():
                ids = seeded_ids(CONFIG_BATCH, PROMPT, cfg.vocab_size, SEED, DEVICE)
                zero_launches(ALL_KERNELS)
                f0 = time.perf_counter()
                logits = transformer_forward(params, cfg, ids)
                torch.cuda.synchronize()
                res["forward_s"] = time.perf_counter() - f0
                no_launches(f"{name} forward", read_launches(ALL_KERNELS))
                check(tuple(logits.shape) == (CONFIG_BATCH, PROMPT, cfg.vocab_size)
                      and bool(torch.isfinite(logits).all()), f"{name}: forward malformed")
                print(f"  {name}: forward {CONFIG_BATCH}x{PROMPT} {res['forward_s']:.3f}s, "
                      f"finite logits", flush=True)
                del logits
        else:
            res.update(config_decode(name, params, cfg, smi))
        micro = seeded_ids(CONFIG_MICRO, SEQ + 1, cfg.vocab_size, SEED + 1, DEVICE)
        res["train"] = config_train_gate(name, params, cfg, micro)
        res["seconds"] = time.perf_counter() - t0
        out[name] = res
        del params
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with torch.inference_mode():
        params, meta = load_params_npz(WEIGHTS, device="cuda", dtype=torch.bfloat16)
        cfg = model_config_from_meta(meta).replace(dtype="bfloat16")
        out["hybrid"] = hybrid_route(params, cfg, smi)
    out["hybrid"]["seconds"] = time.perf_counter() - t0
    del params
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def dropped_own_block(lo, hi):
    """The full model's decode with keys ``lo`` .. ``hi`` - 1 (the block of
    64 that holds the steps' own positions) left out of every step's
    attention.  The control the full model's incremental gate must fail."""
    real = model_module._scores

    def dropped(q, k):
        out = real(q, k)
        out[..., lo:hi] = -1e30
        return out

    model_module._scores = dropped
    try:
        yield
    finally:
        model_module._scores = real


def long_sweep(sparse_cfg, full_cfg, smi, work):
    """JAX's 16k cell through its entry point (``python -m
    nsa_tpu_torch.eval.efficiency_16k``, its defaults, the committed
    weights): the rows, launch counts, and sparse against full a cell."""
    zero_launches(ALL_KERNELS)
    t0 = time.perf_counter()
    rows = efficiency_16k.main(["--csv", os.path.join(work, "efficiency_seq16k.csv"),
                                "--iters", str(LONG_SWEEP_ITERS)])
    wall = time.perf_counter() - t0
    launches = read_launches(ALL_KERNELS)
    sweep = {"batch_sizes": (1, 8, 16), "prompts": (8000, 15000), "gen": 100}
    runs = (1 + LONG_SWEEP_ITERS) * len(sweep["prompts"])    # warm-up + timed, each prompt
    small = [b for b in sweep["batch_sizes"] if use_mega_decode(sparse_cfg, b)]
    split = runs * (len(sweep["batch_sizes"]) - len(small)) * sweep["gen"] * sparse_cfg.depth
    want = {**dict.fromkeys(launches, 0),
            "prefill_fwd": runs * len(sweep["batch_sizes"]) * sparse_cfg.depth,
            "flash_attention": runs * len(sweep["batch_sizes"]) * full_cfg.depth,
            "decode_step_mega": runs * len(small) * sweep["gen"] // MEGA_STEPS,
            "decode_select": split, "decode_attend": split}
    print(f"  16k sweep (both models) in {wall:.1f}s; launches "
          f"{ {k: v for k, v in launches.items() if v} }; {smi}", flush=True)
    check(launches == want, f"16k sweep launches {launches}, expected {want}")
    check(len(rows) == 2 * len(sweep["batch_sizes"]) * len(sweep["prompts"])
          and all(r["max_len"] == LONG_MAX_LEN and r["decode_tokens_per_s"] > 0
                  and r["prefill_tokens_per_s"] > 0 for r in rows), "16k sweep rows malformed")
    check([r["prefill_bucket"] for r in rows] == [8192, 16384] * 6,
          "16k sweep buckets are not JAX's")
    by = {(r["model_type"], r["batch_size"], r["prompt_len"]): r for r in rows}
    cells = []
    for b in sweep["batch_sizes"]:
        for p in sweep["prompts"]:
            sp, fu = by[("sparse_mlp", b, p)], by[("full", b, p)]
            cell = {"bs": b, "prompt": p,
                    "sparse_decode_tok_s": sp["decode_tokens_per_s"],
                    "full_decode_tok_s": fu["decode_tokens_per_s"],
                    "sparse_over_full": sp["decode_tokens_per_s"] / fu["decode_tokens_per_s"],
                    "sparse_prefill_s": b * p / sp["prefill_tokens_per_s"],
                    "full_prefill_s": b * p / fu["prefill_tokens_per_s"]}
            cells.append(cell)
            print(f"  16k bs {b} prompt {p} (bucket {sp['prefill_bucket']}): decode tok/s "
                  f"sparse {cell['sparse_decode_tok_s']:.1f} full {cell['full_decode_tok_s']:.1f}"
                  f" ({cell['sparse_over_full']:.3f}x); prefill s sparse "
                  f"{cell['sparse_prefill_s']:.4f} full {cell['full_prefill_s']:.4f}; {smi}",
                  flush=True)
    return {"rows": rows, "cells": cells, "launches": launches, "wall_s": wall}


def long_incremental(name, params, cfg, control, control_kw, smi):
    """The incremental decode against the full forward over the same ids at
    positions 15,000-15,003, within 2% of max |logit|, and the same steps
    under ``control`` (with ``control_kw``), which must fail; returns the
    prefill's first token and cache (LONG_MAX_LEN rows) and the figures."""
    b, n = LONG_GATE_BATCH, LONG_GATE_PROMPT
    ids = seeded_ids(b, n, cfg.vocab_size, SEED + 3, DEVICE)
    tokens = seeded_ids(b, LONG_GATE_STEPS, cfg.vocab_size, SEED + 4, DEVICE)
    logits, cache = transformer_prefill(params, cfg, ids, LONG_MAX_LEN)
    first = logits[:, -1].argmax(-1)
    del logits
    run = clone_cache(cache)
    inc = teacher_forced(params, cfg, tokens, run)
    full = transformer_forward(params, cfg, torch.cat([ids, tokens], 1))[:, n:]
    copy_cache(run, cache)
    with control():
        ctrl = teacher_forced(params, cfg, tokens, run, **control_kw)
    out = {"incremental_vs_full": rel_gate(inc, full), "control": rel_gate(ctrl, full)}
    print(f"  {name} bs {b}: prefill {n} into {LONG_MAX_LEN} rows, {LONG_GATE_STEPS} "
          f"teacher-forced steps at positions {n}-{n + LONG_GATE_STEPS - 1} against the full "
          f"forward: {out['incremental_vs_full']:.4f} of max|logit| (tol {TOL_LOGITS_REL}), "
          f"control {out['control']:.4f}; {smi}", flush=True)
    check(bool(torch.isfinite(inc).all()) and out["incremental_vs_full"] <= TOL_LOGITS_REL,
          f"{name} at 16k: the incremental decode disagrees with the full forward")
    check(out["control"] > TOL_LOGITS_REL,
          f"{name} at 16k: the incremental gate passes the control")
    del run, inc, full, ctrl
    return first, cache, out


def long_graphs(label, params, cfg, first, cache, steps, want, n=LONG_GRAPH_STEPS):
    """Captured decode against eager over ``n`` steps from ``cache``
    (``decode_turns``: tokens, caches and launches equal)."""
    run_cache = clone_cache(cache)

    def run(capture):
        toks = greedy_decode(params, cfg, first, run_cache, n, steps=steps, capture=capture)
        return toks, [x for lc in run_cache.layers for x in lc]

    def check_launches(got, where):
        no_launches(where, got, **want)

    out = decode_turns(f"16k {label}", run, lambda: copy_cache(run_cache, cache),
                       first.shape[0] * n, check_launches)
    del run_cache
    return out


def kernel_share(params, cfg, module, name, label, smi):
    """The 16k cell's largest prefill (bs 16 x 16,384 seeded ids) timed by
    CUDA events, and the launches of the kernel ``module.name`` in it (row 1
    or 13, a layer each) timed the same way: how much of the prefill the
    kernel is, and how much the rest of the layers' work."""
    ids = seeded_ids(16, LONG_MAX_LEN, cfg.vocab_size, SEED, DEVICE)
    real, spans = getattr(module, name), []

    def timed(*a, **k):
        s_, e_ = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s_.record()
        out = real(*a, **k)
        e_.record()
        spans.append((s_, e_))
        return out

    timed.launches = 0      # the wrapper counts where the module looks it up
    transformer_prefill(params, cfg, ids, LONG_MAX_LEN)            # warm
    setattr(module, name, timed)
    try:
        s_, e_ = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s_.record()
        transformer_prefill(params, cfg, ids, LONG_MAX_LEN)
        e_.record()
        torch.cuda.synchronize()
    finally:
        setattr(module, name, real)
    total = s_.elapsed_time(e_)
    kernel = sum(a.elapsed_time(b) for a, b in spans)
    print(f"  {label} prefill 16x{LONG_MAX_LEN}: {total:.1f} ms, of which {name} "
          f"{kernel:.1f} ms in {len(spans)} launches ({100 * kernel / total:.1f}%); {smi}",
          flush=True)
    return {"prefill_ms": total, "kernel_ms": kernel, "launches": len(spans)}


def long_phase(smi, log):
    """JAX's 16k path on the card: the efficiency_16k sweep of both models,
    rows 1 and 13 at LONG_NK keys and on the sweep's own operands, rows 2-3
    and 12 at a 16,384-row cache, the incremental gate past position 15,000
    on both models, captured decode against eager; the phase's peak memory."""
    out, parts, t0 = {}, {}, time.perf_counter()

    def part(name):
        nonlocal t0
        parts[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sparse, meta = load_params_npz(WEIGHTS, device="cuda", dtype=torch.bfloat16)
    sparse_cfg = model_config_from_meta(meta).replace(dtype="bfloat16")
    full, meta = load_params_npz(FULL_WEIGHTS, device="cuda", dtype=torch.bfloat16)
    full_cfg = model_config_from_meta(meta).replace(dtype="bfloat16")
    with tempfile.TemporaryDirectory() as work:
        out["sweep"] = long_sweep(sparse_cfg, full_cfg, smi, work)
    torch.cuda.empty_cache()
    part("sweep")

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    flush = kernel_times.Flush()
    kernels = []
    for n in LONG_NK:
        kernels.append(check_prefill(f"prefill_fwd_n{n}", prefill_inputs(gen, sparse_cfg, 1, n),
                                     flush, sparse_cfg, library=False, plain_iters=0))
        kernels.append(kernel_flash(gen, flush, full_cfg, b=1, n=n,
                                    dropped=(n // 2 - 64, n // 2),
                                    control_rows=LONG_CONTROL_ROWS,
                                    name=f"flash_attention_n{n}"))
    ob, op = LONG_OPERANDS
    ids = seeded_ids(ob, prefill_bucket(op, LONG_MAX_LEN), sparse_cfg.vocab_size, SEED, DEVICE)

    def sweep_prefill(params, cfg):
        transformer_prefill(params, cfg, ids, LONG_MAX_LEN, true_len=op)

    kernels.append(check_prefill("prefill_fwd_sweep", first_operands(
        "prefill_fwd", sweep_prefill, sparse, sparse_cfg)[:5], flush, sparse_cfg, library=False,
        plain_iters=0))
    n = ids.shape[1]
    kernels.append(kernel_flash(gen, flush, full_cfg, inputs=first_operands(
        "flash_attention", sweep_prefill, full, full_cfg)[:3], dropped=(n // 2 - 64, n // 2),
        control_rows=LONG_CONTROL_ROWS, name="flash_attention_sweep"))
    del ids
    part("rows 1 and 13")
    kernels += kernel_decode(gen, flush, sparse_cfg, log, b=LONG_SPLIT_BATCH,
                             max_len=LONG_MAX_LEN, t=LONG_T, suffix="_16k")
    packed = fuse_decode_params(sparse, sparse_cfg)
    part("rows 2 and 3")
    mega = kernel_decode_mega(gen, flush, sparse_cfg, packed, LONG_MEGA_BATCH, log,
                              max_len=LONG_MAX_LEN, t_emit=LONG_T, profiled=False)
    kernels.append({**mega, "name": "decode_step_mega_16k"})
    del flush
    torch.cuda.empty_cache()
    out["kernels"] = kernels
    part("row 12")
    out["prefill_share"] = {
        "sparse": kernel_share(packed, sparse_cfg, nsa_prefill, "prefill_fwd", "sparse", smi),
        "full": kernel_share(full, full_cfg, model_module, "flash_attention", "full", smi)}
    part("prefill shares")

    # the incremental gate and captured against eager, both models
    first, cache, out["sparse_incremental"] = long_incremental(
        "sparse", packed, sparse_cfg, dropped_diagonal_block, dict(use_kernels=False), smi)
    depth = sparse_cfg.depth
    out["sparse_graphs_split"] = long_graphs(
        f"sparse bs {LONG_GATE_BATCH} (split)", packed, sparse_cfg, first, cache, 1,
        dict(decode_select=depth * LONG_GRAPH_STEPS, decode_attend=depth * LONG_GRAPH_STEPS))
    # the whole-model loop at MEGA_STEPS tokens a launch: a replay needs
    # two launches
    b8 = LONG_MEGA_BATCH
    small = first_rows(cache, b8)
    out["sparse_graphs_mega"] = long_graphs(
        f"sparse bs {b8} (whole-model, {MEGA_STEPS} tokens a launch)", packed, sparse_cfg,
        first[:b8].contiguous(), small, MEGA_STEPS, dict(decode_step_mega=2),
        n=2 * MEGA_STEPS)
    del cache, small, packed, sparse
    torch.cuda.empty_cache()
    part("sparse incremental and graphs")
    lo = LONG_GATE_PROMPT // 64 * 64
    first, cache, out["full_incremental"] = long_incremental(
        "full", full, full_cfg, lambda: dropped_own_block(lo, lo + 64), {}, smi)
    out["full_graphs"] = long_graphs(f"full bs {LONG_GATE_BATCH}", full, full_cfg, first,
                                     cache, 1, {})
    del cache, full
    decode_graph.clear()
    torch.cuda.empty_cache()
    part("full incremental and graphs")
    out["peak_bytes"], out["parts_s"] = torch.cuda.max_memory_allocated(), parts
    print(f"  long phase peak memory {out['peak_bytes'] / 2**30:.2f} GiB; seconds by part "
          f"{ {k: round(v, 1) for k, v in parts.items()} }; {smi}", flush=True)
    return out


def first_rows(cache, b):
    """The first ``b`` rows of a cache, as a cache of their own."""
    return cache._replace(layers=tuple(type(lc)(*(x[:b].clone() for x in lc))
                                       for lc in cache.layers))


def ablation_phase(smi):
    """The ablation script (``python -m nsa_tpu_torch.profile_decode``):
    its cell (the reference model from its seed, bs 64 x prompt 128, 50
    steps, 4096 rows) in full and under each ``NSA_ABLATE`` value: captured
    against eager bit for bit (tokens and every cache tensor), launches a
    step (rows 2-3 once a layer in full and under no_emit, none under the
    others), the ckv cache bit-unchanged under no_emit, and the script's ms
    a step."""
    A = ablation_script
    params, cfg = A.seeded_model(DEVICE)
    params = fuse_decode_params(params, cfg)
    first, cache = A.prefilled(params, cfg, A.BATCH, A.PROMPT, A.MAX_LEN, DEVICE)
    run = clone_cache(cache)
    out = {}
    for value in ("",) + nsa_layer.ABLATIONS:
        label = value or "full"
        res = {}
        with A.ablation(value):
            turns = []
            for capture in (False, True):
                copy_cache(run, cache)
                zero_launches(ALL_KERNELS)
                toks = greedy_decode(params, cfg, first, run, A.GEN, capture=capture)
                turns.append((toks, [x.clone() for lc in run.layers for x in lc],
                              read_launches(ALL_KERNELS)))
            ckv_same = all(torch.equal(a.ckv, b.ckv) for a, b in zip(run.layers, cache.layers))
            res["ms_per_step"] = A.step_ms(params, cfg, first, cache, A.GEN, A.ITERS,
                                           torch.device(DEVICE))
        want = {k: cfg.depth * A.GEN for k in ABLATE_KERNELS[value]}
        for toks, caches, launches in turns:
            no_launches(f"ablation {label}", launches, **want)
        same = torch.equal(turns[0][0], turns[1][0]) and all(
            torch.equal(x, y) for x, y in zip(turns[0][1], turns[1][1]))
        res.update(captured_equals_eager=same, launches=turns[1][2], ckv_unchanged=ckv_same)
        print(f"  ablation {label}: {res['ms_per_step']:.4f} ms a step "
              f"({A.BATCH / res['ms_per_step'] * 1e3:.0f} tok/s); captured = eager bit for bit: "
              f"{same}; launches {dict((k, v) for k, v in turns[1][2].items() if v)}; ckv "
              f"unchanged over the run: {ckv_same}; {smi}", flush=True)
        check(same, f"ablation {label}: captured decode differs from eager")
        if value in ("no_emit", "attn_only"):
            check(ckv_same, f"ablation {label}: the ckv cache changed")
        else:
            check(not ckv_same, f"ablation {label}: no compressed row was emitted")
        out[label] = res
    decode_graph.clear()
    del run, cache, params
    torch.cuda.empty_cache()
    return out

def grad_tree(params):
    """The params' gradients in the params' tree layout."""
    if isinstance(params, dict):
        return {k: grad_tree(v) for k, v in params.items()}
    if isinstance(params, list):
        return [grad_tree(v) for v in params]
    return params.grad


@contextlib.contextmanager
def timed_collectives():
    """Host seconds spent in ``torch.distributed``'s all_reduce and
    all_gather (the only collectives ``parallel/comm.py`` calls), each
    between two synchronisations of the card; yields a dict that adds up."""
    real = {n: getattr(torch.distributed, n) for n in ("all_reduce", "all_gather")}
    acc = {"seconds": 0.0, "calls": 0}

    def timed(fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(*a, **k)
            torch.cuda.synchronize()
            acc["seconds"] += time.perf_counter() - t0
            acc["calls"] += 1
            return res
        return run

    for n, fn in real.items():
        setattr(torch.distributed, n, timed(fn))
    try:
        yield acc
    finally:
        for n, fn in real.items():
            setattr(torch.distributed, n, fn)


def ff_without_heads_reduce(ffp, cfg, x):
    """The FF with its heads all-reduce of ``hid @ w2`` left out (each heads
    rank adds its partial sum)."""
    hid = rms_norm(x, ffp["norm_scale"], cfg.norm_eps)
    hid = F.gelu(hid @ ffp["w1"].to(hid.dtype) + ffp["b1"].to(hid.dtype))
    return hid @ ffp["w2"].to(hid.dtype) + ffp["b2"].to(hid.dtype)


@contextlib.contextmanager
def ff_heads_reduce_left_out():
    """The mesh gates' control: every FF block (the model's forward and the
    layer's decode step) without its heads all-reduce."""
    real = model_module.ff_apply_gelu, nsa_layer.ff_apply_gelu
    model_module.ff_apply_gelu = nsa_layer.ff_apply_gelu = ff_without_heads_reduce
    try:
        yield
    finally:
        model_module.ff_apply_gelu, nsa_layer.ff_apply_gelu = real


@contextlib.contextmanager
def copy_to_heads_reduce_left_out():
    """``comm.copy_to_heads`` with the plain identity as its backward: the
    gradient of a replicated input (the normed activations before q / k / v
    / gate and the FF's ``w1``) keeps only this rank's heads' part.  The
    loss stays right; the norm scales' gradients and everything upstream
    go wrong.  The control the mesh's gradient gate must fail."""
    from nsa_tpu_torch.parallel import comm

    real = comm._CopyToHeads.__dict__["backward"]
    comm._CopyToHeads.backward = staticmethod(lambda ctx, g: (g, None))
    try:
        yield
    finally:
        comm._CopyToHeads.backward = real


def gather_gate(name, kv, idx, Bs):
    """Row 11 on its operands: bit for bit its plain version, and the
    first id moved back one block (mod the blocks: before it lie the
    written rows, and block 0 moves to the last, which a cache not yet
    full holds as zeros) must give other bits."""
    got = paged_gather.paged_gather(kv, idx, Bs)
    want = paged_gather.paged_gather_plain(kv, idx, Bs)
    n = kv.shape[2] // Bs
    moved = idx.clone()
    moved[0, 0, 0] = (moved[0, 0, 0].clamp(0, n - 1) + n - 1) % n
    equal = torch.equal(got, want)
    control = torch.equal(paged_gather.paged_gather_plain(kv, moved, Bs), want)
    print(f"  {name} {tuple(idx.shape)} blocks of {Bs} rows from {tuple(kv.shape)}: bit for "
          f"bit its plain version {equal}; one id moved back a block gives the same bits "
          f"{control} (must be False)", flush=True)
    check(equal, f"{name} is not the blocks it was asked for")
    check(not control, f"{name}: the moved-id control gives the same bits")
    return {"bit_equal": equal, "control_equal": control}


def hold_first_launches(rec, cfg, label):
    """Each kernel's first launch kept in ``rec`` (``first_launch_operands``)
    launched again on the same operands and held against its plain version
    under the kernels phase's rules and controls: rows 1 (``prefill_gate``),
    4-5 (``prefill_bwd_gate``, row 5 on the deltas row 4 gave it), 2-3
    (``select_gate``, then ``attend_gate`` on the plain selection), 11
    (``gather_gate``) and 13 (``flash_gate``).  Returns {kernel: figures}."""
    held = {}
    if "prefill_fwd" in rec:
        held["prefill_fwd"] = prefill_gate(f"{label} prefill_fwd", rec["prefill_fwd"])[-1]
    if "prefill_bwd_dq" in rec:
        held.update(prefill_bwd_gate(f"{label} prefill_bwd", rec["prefill_bwd_dq"],
                                     rec["prefill_bwd_dkv"][7:9])[-1])
    if "decode_select" in rec:
        q, ckv, mem_kv, t = rec["decode_select"][:4]
        t = int(t)
        *_, c_p, info_p, held["decode_select"] = select_gate(
            q, ckv, mem_kv, t, t // cfg.nsa.compress_block_sliding_stride, cfg,
            f"{label} decode_select")
        rq, kv, _, _, gates = rec["decode_attend"][:5]
        held["decode_attend"] = attend_gate(rq, kv, info_p, c_p, gates, t, cfg,
                                            f"{label} decode_attend")[1]
    if "paged_gather" in rec:
        held["paged_gather"] = gather_gate(f"{label} paged_gather", *rec["paged_gather"])
    if "flash_attention" in rec:
        q = rec["flash_attention"][0]
        n = q.shape[2]
        # the control's key tile: FLASH_DROPPED_KEYS, or for a sequence that
        # ends before them the 64-key tile before its middle
        lo = (n // 2 - 64) // 64 * 64
        dropped = FLASH_DROPPED_KEYS if n > FLASH_DROPPED_KEYS[1] else (lo, lo + 64)
        held["flash_attention"] = flash_gate(f"{label} flash_attention",
                                             *rec["flash_attention"][:3], dropped=dropped)[-1]
    return held


def mesh_inputs(vocab, device):
    """The mesh phase's token inputs, the same from its seeds in the parent
    and in every rank: the training batch [1, MESH_TRAIN_BATCH, SEQ + 1],
    the decode prompts [MESH_BATCH, PROMPT] and the whole-model prompts
    [MESH_MEGA_BATCH, PROMPT]."""
    return (seeded_ids(MESH_TRAIN_BATCH, SEQ + 1, vocab, SEED + 3, device)[None],
            seeded_ids(MESH_BATCH, PROMPT, vocab, SEED, device),
            seeded_ids(MESH_MEGA_BATCH, PROMPT, vocab, SEED + 4, device))


def wait_for(path, timeout_s):
    """Wait until ``path`` exists (written whole: its writer renames it into
    place) or raise."""
    deadline = time.monotonic() + timeout_s
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} did not appear within {timeout_s}s")
        time.sleep(0.1)


def mesh_requests():
    """The mesh engine's requests: the serving cell's first MESH_REQUESTS
    prompts, MESH_NEW new tokens each."""
    return [(prompt, MESH_NEW) for prompt, _ in serve_requests(MESH_REQUESTS, SEED)]


def mesh_engine(params, cfg, reqs, mesh=None):
    """The tokens of ``reqs`` through an engine of MESH_REQUESTS slots at
    MESH_SYNC tokens a sync, over ``mesh`` (eager) or in one process."""
    eng = serve.ContinuousBatchingEngine(
        params, cfg, max_batch=MESH_REQUESTS, max_len=MAX_LEN, prefill_buckets=SERVE_BUCKETS,
        steps_per_sync=MESH_SYNC, mesh=mesh, capture=mesh is None)
    rids = [eng.add_request(p, max_new_tokens=n) for p, n in reqs]
    done = eng.run()
    return [done[r].tolist() for r in rids]


def gloo_cuda_collectives(dev):
    """Which collectives this gloo world takes on CUDA tensors: each one's
    result checked, or the error it raised (``parallel/comm.py`` stages
    all_gather through the host under gloo)."""
    dist = torch.distributed
    world, rank = dist.get_world_size(), dist.get_rank()
    x = torch.full((4,), float(rank + 1), device=dev)
    total = float(sum(range(1, world + 1)))

    def all_reduce():
        y = x.clone()
        dist.all_reduce(y)
        return bool((y == total).all())

    def broadcast():
        y = x.clone()
        dist.broadcast(y, src=0)
        return bool((y == 1).all())

    def all_gather():
        ys = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(ys, x)
        return [float(y[0]) for y in ys] == [float(r + 1) for r in range(world)]

    def reduce_scatter():
        y = torch.empty(1, device=dev)
        dist.reduce_scatter_tensor(y, torch.full((world,), float(rank + 1), device=dev))
        return float(y[0]) == total

    out = {}
    for fn in (all_reduce, broadcast, all_gather, reduce_scatter):
        try:
            out[fn.__name__] = "ok" if fn() else "wrong result"
        except (RuntimeError, ValueError, NotImplementedError) as e:
            out[fn.__name__] = f"{type(e).__name__}: {str(e).splitlines()[0][:80]}"
    return out


def mesh_rank(work):
    """One of the mesh phase's ranks, on the one card with gloo: every run
    the phase holds, each with its launch counts, its seconds and its
    kernels held at the rank's shapes (``hold_first_launches``).  The inputs
    come from the seeds (``mesh_inputs``); the single process's gradients,
    which the parent computes while the ranks start, from ``work``."""
    from nsa_tpu_torch.parallel import comm, sharding
    from nsa_tpu_torch.parallel import train_step as pstep
    from nsa_tpu_torch.parallel.mesh import make_mesh, rank_device

    entered = time.perf_counter()
    dev = rank_device(DEVICE)
    runtime.require_built()             # the parent built the kernels; a rank only loads them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(2, 2)
    out = {"coords": mesh.coords, "launches": {}, "s": {}, "held": {},
           "gloo_cuda": gloo_cuda_collectives(dev),
           "marks": {"started": entered, "on the card with its groups": time.perf_counter()}}
    full, meta = load_params_npz(WEIGHTS, device="cpu", dtype=torch.float32)
    cfg = model_config_from_meta(meta).replace(dtype="bfloat16")
    lcfg = sharding.local_config(cfg, mesh)

    def counted(label, fn):
        """fn()'s result, its launches and seconds; then the first launch
        of each kernel it ran held at this rank's shapes (not counted)."""
        zero_launches(ALL_KERNELS)
        t0 = time.perf_counter()
        with first_launch_operands() as rec:
            res = fn()
        torch.cuda.synchronize()
        out["s"][label] = time.perf_counter() - t0
        out["launches"][label] = read_launches(ALL_KERNELS)
        print(f"{label} {out['s'][label]:.2f}s", flush=True)   # into the rank's log
        out["held"][label] = hold_first_launches(rec, lcfg, label)
        return res

    # (a) the sparse model's training step on the 2 x 2 mesh, after two
    # controls: a forward without the FF's heads all-reduce, and a step
    # without copy_to_heads's backward all-reduce
    params = pstep.shard_trainable(full, mesh, cfg, dev)
    out["marks"]["weights sharded"] = time.perf_counter()
    batch, decode_ids, mega_ids = mesh_inputs(cfg.vocab_size, dev)
    with torch.no_grad(), mesh, ff_heads_reduce_left_out():
        local = sharding.shard_batch(batch[0], mesh)
        out["train_control_loss"] = comm.mean_over_batch(
            transformer_loss(params, lcfg, local)).item()
    out["marks"]["control forward"] = time.perf_counter()
    cparams = pstep.shard_trainable(full, mesh, cfg, dev)
    del full
    with copy_to_heads_reduce_left_out():
        out["grad_control_loss"] = float(pstep.sharded_train_step(
            cparams, pretrain.make_optimizer(TrainConfig(), cparams), batch, cfg, 1, mesh))
    control_grads = grad_tree(cparams)
    del cparams
    out["marks"]["control step"] = time.perf_counter()
    opt = pretrain.make_optimizer(TrainConfig(), params)
    out["train_loss"] = counted("train", lambda: float(pstep.sharded_train_step(
        params, opt, batch, cfg, 1, mesh)))
    out["marks"]["train step"] = time.perf_counter()
    if mesh.coord("data") == 0:
        # each heads rank holds the same slices of the single process's
        # gradients against its own and the control's: squared norms of the
        # difference and of the reference, leaf by leaf (no gather)
        grads = os.path.join(work, "grads.pt")
        wait_for(grads, MESH_TIMEOUT_S)
        want = tree_leaves(sharding.shard_params(torch.load(grads, weights_only=True), mesh,
                                                 cfg))
        for key, got in (("grad_sq", grad_tree(params)), ("control_grad_sq", control_grads)):
            out[key] = {k: ((g.float() - w.to(dev)).square().sum().item(),
                            w.square().sum().item())
                        for (k, g), w in zip(tree_items(got), want)}
        del want
    del params, opt, control_grads
    torch.cuda.empty_cache()
    out["marks"]["gradients held"] = time.perf_counter()

    # (b) prefill and greedy decode on the split route
    bparams, _ = load_params_npz(WEIGHTS, device=dev, dtype=torch.bfloat16)
    with mesh:                           # packed from the rank's own shard
        local = fuse_decode_params(sharding.shard_params(bparams, mesh, cfg), lcfg)
    ids = sharding.shard_batch(decode_ids, mesh)

    def decode():
        with torch.no_grad(), mesh:
            logits, cache = transformer_prefill(local, lcfg, ids, MAX_LEN)
            first = logits[:, -1].argmax(-1)
            with ff_heads_reduce_left_out():
                control, _ = transformer_decode_step(local, lcfg, first, clone_cache(cache))
            out["decode_control_logits"] = control.float().cpu()
            step0, cache = transformer_decode_step(local, lcfg, first, cache)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with timed_collectives() as coll:
                toks = greedy_decode(local, lcfg, step0.argmax(-1), cache, MESH_GEN - 1,
                                     capture=False)
            torch.cuda.synchronize()
            out["decode_s"], out["decode_collectives"] = time.perf_counter() - t0, coll
        return step0, torch.cat([first[:, None], toks], 1)

    step0, toks = counted("decode", decode)
    out["decode_logits"], out["decode_tokens"] = step0.float().cpu(), toks.cpu()
    del local
    torch.cuda.empty_cache()

    # (c) the serving engine on the mesh
    reqs = mesh_requests()
    out["engine_tokens"] = counted("engine", lambda: mesh_engine(bparams, cfg, reqs, mesh))

    # (d) the data-only 4 x 1 mesh on the whole-model kernel (row 12)
    dmesh = make_mesh(4, 1)
    dlocal = fuse_decode_params(sharding.shard_params(bparams, dmesh, cfg), cfg)
    mids = sharding.shard_batch(mega_ids, dmesh)

    def mega():
        with torch.no_grad(), dmesh:
            logits, cache = transformer_prefill(dlocal, cfg, mids, MAX_LEN)
            step0, cache = transformer_decode_step(dlocal, cfg, logits[:, -1].argmax(-1), cache)
            greedy_decode(dlocal, cfg, step0.argmax(-1), cache, MESH_MEGA_STEPS - 1,
                          capture=False)
        return step0

    out["mega_logits"] = counted("mega", mega).float().cpu()
    del bparams, dlocal
    torch.cuda.empty_cache()

    # (e) the full model on the 2 x 2 mesh: row 13's loss, then a training step
    ffull, fmeta = load_params_npz(FULL_WEIGHTS, device="cpu", dtype=torch.float32)
    fcfg = model_config_from_meta(fmeta).replace(dtype="bfloat16")
    fparams = pstep.shard_trainable(ffull, mesh, fcfg, dev)
    del ffull

    def full_eval():
        with torch.no_grad(), mesh:
            local = sharding.shard_batch(batch[0], mesh)
            return comm.mean_over_batch(transformer_loss(
                fparams, sharding.local_config(fcfg, mesh), local)).item()

    out["full_eval_loss"] = counted("full_eval", full_eval)
    with ff_heads_reduce_left_out():
        out["full_control_loss"] = full_eval()
    fopt = pretrain.make_optimizer(TrainConfig(), fparams)
    out["full_train_loss"] = counted("full_train", lambda: float(pstep.sharded_train_step(
        fparams, fopt, batch, fcfg, 1, mesh)))
    out["marks"]["done"] = time.perf_counter()
    return out


def mesh_refs(work):
    """The single process's figures for the mesh phase on the same inputs
    and weights, its gradients written to ``work`` for the ranks; returns
    them, with the seconds of each part under ``"s"``."""
    refs, laps, t0 = {}, {}, time.perf_counter()

    def lap(label):
        nonlocal t0
        torch.cuda.synchronize()
        laps[label] = time.perf_counter() - t0
        t0 = time.perf_counter()

    full, meta = load_params_npz(WEIGHTS, device="cpu", dtype=torch.float32)
    cfg = model_config_from_meta(meta).replace(dtype="bfloat16")
    params = pretrain.trainable(full, DEVICE)
    batch, ids, mids = mesh_inputs(cfg.vocab_size, DEVICE)
    opt = pretrain.make_optimizer(TrainConfig(), params)
    with torch.no_grad():
        refs["train_control_ref"] = transformer_loss(params, cfg, batch[0]).item()
    refs["train_loss"] = float(pretrain.train_step(params, opt, batch, cfg, 1))
    save_atomic(tree_to(grad_tree(params), "cpu"), os.path.join(work, "grads.pt"))
    del params, opt, full
    lap("train")

    bparams, _ = load_params_npz(WEIGHTS, device=DEVICE, dtype=torch.bfloat16)
    with torch.inference_mode():
        logits, cache = transformer_prefill(bparams, cfg, ids, MAX_LEN)
        first = logits[:, -1].argmax(-1)
        step0, cache = transformer_decode_step(bparams, cfg, first, cache, route="split")
        toks = greedy_decode(bparams, cfg, step0.argmax(-1), cache, MESH_GEN - 1, route="split")
        refs.update(decode_logits=step0.float().cpu(),
                    decode_tokens=torch.cat([first[:, None], toks], 1).cpu())
        del logits, cache
        logits, cache = transformer_prefill(bparams, cfg, mids, MAX_LEN)
        step0, _ = transformer_decode_step(bparams, cfg, logits[:, -1].argmax(-1), cache)
        refs["mega_logits"] = step0.float().cpu()
        del logits, cache
    lap("decode")
    refs["engine_tokens"] = mesh_engine(bparams, cfg, mesh_requests())
    del bparams
    lap("engine")

    ffull, fmeta = load_params_npz(FULL_WEIGHTS, device="cpu", dtype=torch.float32)
    fcfg = model_config_from_meta(fmeta).replace(dtype="bfloat16")
    fparams = pretrain.trainable(ffull, DEVICE)
    with torch.no_grad():
        refs["full_eval_loss"] = transformer_loss(fparams, fcfg, batch[0]).item()
    refs["full_train_loss"] = float(pretrain.train_step(
        fparams, pretrain.make_optimizer(TrainConfig(), fparams), batch, fcfg, 1))
    del fparams, ffull
    decode_graph.clear()
    torch.cuda.empty_cache()
    lap("full")
    refs["s"] = laps
    return refs


def engine_partings(params, cfg, reqs, got, want):
    """Where a request's tokens over the mesh part from the single
    process's, the gap between the two tokens' logits at the parting (the
    single process's forward over the prompt and the common prefix),
    relative to the largest |logit| there; an empty list where all agree."""
    gaps = []
    for (prompt, _), a, b in zip(reqs, got, want):
        j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            continue
        ids = torch.from_numpy(np.concatenate([prompt, np.asarray(b[:j], np.int32)]))
        with torch.inference_mode():
            logits = transformer_forward(params, cfg, ids[None].to(DEVICE).long())[0, -1]
        gaps.append((logits[b[j]] - logits[a[j]]).item() / logits.abs().max().item())
    return gaps


def mesh_grad_errs(ranks, cfg, sq="grad_sq"):
    """Each gradient's relative L2 error over the whole leaf from the heads
    ranks' squared norms of their slices under ``sq`` (a replicated leaf's
    from one)."""
    from nsa_tpu_torch.parallel.sharding import param_spec

    errs = {}
    shapes = load_params_npz(WEIGHTS, device="cpu")[0]
    for leaf_key, leaf in tree_items(shapes):
        path = tuple(int(k) if k.isdigit() else k.strip("'")
                     for k in leaf_key.strip("[]").split("]["))
        split = "heads" in param_spec(path, leaf, cfg.nsa.compressor)
        parts = [r[sq][leaf_key] for r in (ranks if split else ranks[:1])]
        diff, ref = sum(p[0] for p in parts), sum(p[1] for p in parts)
        errs[leaf_key] = math.sqrt(diff / ref) if ref > 0 else math.sqrt(diff)
    return errs


def mesh_expected_launches(cfg, label):
    """A mesh rank's launches in one of its runs."""
    none = {fn.__name__: 0 for fn in ALL_KERNELS}
    d = cfg.depth
    want = {"train": {"prefill_fwd": d, "prefill_bwd_dq": d, "prefill_bwd_dkv": d},
            # the MESH_GEN steps and the control's step
            "decode": {"prefill_fwd": d, "decode_select": d * (MESH_GEN + 1),
                       "decode_attend": d * (MESH_GEN + 1)},
            "mega": {"prefill_fwd": d, "decode_step_mega": MESH_MEGA_STEPS},
            # one prefill wave, then windows of MESH_SYNC steps until every
            # request has its MESH_NEW tokens (the first from the prefill)
            "engine": {"prefill_fwd": d,
                       "paged_gather": d * MESH_SYNC * -(-(MESH_NEW - 1) // MESH_SYNC)},
            "full_eval": {"flash_attention": d},
            "full_train": {}}
    return {**none, **want[label]}


def start_bytecode_cache():
    """Start a process that imports what the mesh phase's ranks import
    (this script, ``torch.distributed``, what an optimizer's step reaches)
    and writes the bytecode into a fresh cache directory
    (``PYTHONPYCACHEPREFIX``); returns
    (the process, the directory).  Where no bytecode is written
    (``PYTHONDONTWRITEBYTECODE``, as on the H100's machine) every process
    compiles torch from source: there ~10 s for ``import torch`` and ~12 s
    more for ``torch._dynamo``, which a process's first optimizer imports
    (torch.optim keeps dynamo out of its methods).  Started with the script,
    it runs beside the build; the ranks then start on compiled bytecode."""
    prefix = tempfile.mkdtemp(prefix="pycache_")
    env = {**os.environ, "PYTHONPYCACHEPREFIX": prefix}
    env.pop("PYTHONDONTWRITEBYTECODE", None)
    # an optimizer's step imports the rest of what torch.optim reaches
    code = (f"import sys; sys.path.insert(0, {HERE!r}); import chip_smoke, torch, "
            f"torch.distributed; p = torch.zeros(1, requires_grad=True); p.sum().backward(); "
            f"o = torch.optim.Adam([p]); o.step(); o.zero_grad()")
    with open(os.path.join(prefix, "imports.log"), "w") as log:
        proc = subprocess.Popen([sys.executable, "-c", code], cwd=HERE, env=env,
                                stdout=log, stderr=subprocess.STDOUT)
    return proc, prefix


@contextlib.contextmanager
def bytecode_cache(bytecode):
    """The processes started inside read and write the cache of
    ``start_bytecode_cache`` (its process finished first, or it raises)."""
    proc, prefix = bytecode
    if proc.wait(timeout=MESH_TIMEOUT_S):
        with open(os.path.join(prefix, "imports.log")) as f:
            raise RuntimeError(f"the bytecode cache's imports failed: {f.read()[-2000:]}")
    saved = {k: os.environ.get(k) for k in ("PYTHONPYCACHEPREFIX", "PYTHONDONTWRITEBYTECODE")}
    os.environ["PYTHONPYCACHEPREFIX"] = prefix
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def mesh_phase(smi, bytecode):
    """The (data, heads) mesh on the one card (``nsa_tpu_torch/parallel``):
    MESH_RANKS gloo ranks against the single process on the same weights
    and inputs (see MESH_RANKS), started on the compiled bytecode in ``bytecode``
    (``start_bytecode_cache``); returns the phase's figures and each rank's
    launch counts."""
    from nsa_tpu_torch.parallel.mesh import run_ranks

    refs = {}

    def single_process():          # on the card while the ranks start
        t = time.perf_counter()
        refs.update(mesh_refs(work))
        refs["seconds"] = time.perf_counter() - t

    with tempfile.TemporaryDirectory() as work, bytecode_cache(bytecode):
        t0 = time.perf_counter()
        ranks = run_ranks(mesh_rank, MESH_RANKS, "gloo", (work,), timeout_s=MESH_TIMEOUT_S,
                          workdir=work, meanwhile=single_process)
        ranks_s = time.perf_counter() - t0
    refs_s = refs["seconds"]
    _, meta = load_params_npz(WEIGHTS, device="cpu")
    cfg = model_config_from_meta(meta).replace(dtype="bfloat16")
    marks = {k: round(max(r["marks"][k] for r in ranks) - t0, 2) for k in ranks[0]["marks"]}
    print(f"  mesh: {MESH_RANKS} gloo ranks on one card {ranks_s:.2f}s, the last rank's "
          f"seconds from the spawn: {marks}; meanwhile the single process's figures "
          f"{refs_s:.2f}s "
          f"{ {k: round(v, 2) for k, v in refs['s'].items()} }; {smi}", flush=True)
    out = {"refs_s": refs_s, "ranks_s": ranks_s, "rank_marks_s": marks, "ranks": [],
           "gloo_cuda_collectives": ranks[0]["gloo_cuda"]}
    print(f"  gloo on CUDA tensors: {ranks[0]['gloo_cuda']}", flush=True)

    # the 2 x 2 training step, its gradients and the control
    ref = refs["train_loss"]
    losses = [r["train_loss"] for r in ranks]
    heads_ranks = [r for r in ranks if r["coords"][0] == 0]
    errs = mesh_grad_errs(heads_ranks, cfg)
    worst = max(errs, key=errs.get)
    cerrs = mesh_grad_errs(heads_ranks, cfg, "control_grad_sq")
    cworst = max(cerrs, key=cerrs.get)
    control = ranks[0]["train_control_loss"]
    ctrl_ref = refs["train_control_ref"]
    print(f"  mesh 2x2 train step {MESH_TRAIN_BATCH}x{SEQ}: loss {losses[0]:.6f} (ranks "
          f"{len(set(losses))} value(s)) vs one process {ref:.6f}, rel "
          f"{abs(losses[0] - ref) / abs(ref):.3e} (tol {TOL_LOSS_REL}); gradients rel L2 max "
          f"{errs[worst]:.3e} at {worst} (tol {TOL_GRAD_REL_L2}), median "
          f"{sorted(errs.values())[len(errs) // 2]:.3e} over {len(errs)}; control (the FF's "
          f"heads all-reduce left out) loss {control:.6f} vs {ctrl_ref:.6f}, rel "
          f"{abs(control - ctrl_ref) / abs(ctrl_ref):.3e}; control (copy_to_heads's backward "
          f"all-reduce left out) loss {ranks[0]['grad_control_loss']:.6f}, gradients rel L2 max "
          f"{cerrs[cworst]:.3e} at {cworst} (must be > {TOL_GRAD_REL_L2}), median "
          f"{sorted(cerrs.values())[len(cerrs) // 2]:.3e}", flush=True)
    check(len(set(losses)) == 1 and abs(losses[0] - ref) <= TOL_LOSS_REL * abs(ref),
          "the mesh training step's loss disagrees with one process's")
    check(errs[worst] <= TOL_GRAD_REL_L2, "the mesh training step's gradients disagree")
    check(abs(control - ctrl_ref) > TOL_LOSS_REL * abs(ctrl_ref),
          "the mesh loss gate passes a forward without the FF's heads all-reduce")
    check(cerrs[cworst] > TOL_GRAD_REL_L2,
          "the mesh gradient gate passes a step without copy_to_heads's backward all-reduce")
    out.update(train_loss=losses[0], train_loss_ref=ref, grad_rel_l2_max=errs[worst],
               train_control_rel=abs(control - ctrl_ref) / abs(ctrl_ref),
               grad_control_rel_l2_max=cerrs[cworst])

    # prefill + decode on the split route, the first step's logits
    half = MESH_BATCH // 2
    err = agree = 0.0
    control = math.inf
    for r in ranks:
        rows = slice(r["coords"][0] * half, (r["coords"][0] + 1) * half)
        want = refs["decode_logits"][rows]
        scale = max(want.abs().max().item(), 1.0)
        err = max(err, max_err(r["decode_logits"], want) / scale)
        control = min(control, max_err(r["decode_control_logits"], want) / scale)
        agree += (r["decode_tokens"] == refs["decode_tokens"][rows]).float().mean().item()
    agree /= len(ranks)
    coll = [r["decode_collectives"] for r in ranks]
    share = [c["seconds"] / r["decode_s"] for c, r in zip(coll, ranks)]
    print(f"  mesh 2x2 prefill {MESH_BATCH}x{PROMPT} + {MESH_GEN} greedy steps (split route, "
          f"eager): first step's logits max|err| {err:.4f} of max|logit| (tol "
          f"{TOL_LOGITS_REL}; control without the FF's heads all-reduce {control:.4f}); "
          f"tokens equal one process's {100 * agree:.1f}%; "
          f"{MESH_GEN - 1} steps {ranks[0]['decode_s']:.3f}s on rank 0 "
          f"({(MESH_GEN - 1) / ranks[0]['decode_s']:.1f} steps/s), gloo collectives "
          f"{coll[0]['calls']} calls {coll[0]['seconds']:.3f}s = "
          f"{100 * min(share):.1f}-{100 * max(share):.1f}% of the steps' time over the ranks; "
          f"{smi}", flush=True)
    check(err <= TOL_LOGITS_REL, "the mesh decode's logits disagree with one process's")
    check(control > TOL_LOGITS_REL, "the mesh decode gate passes a step without the FF's "
                                    "heads all-reduce")
    out.update(decode_logits_rel=err, decode_control_rel=control, decode_tokens_equal=agree,
               decode_s=[r["decode_s"] for r in ranks], collective_share=share,
               collective_calls=coll[0]["calls"])

    # the engine
    reqs = mesh_requests()
    bparams, _ = load_params_npz(WEIGHTS, device=DEVICE, dtype=torch.bfloat16)
    gaps = {}
    for r in ranks:
        check(r["engine_tokens"] == ranks[0]["engine_tokens"], "the ranks' engines disagree")
    gaps = engine_partings(bparams, cfg, reqs, ranks[0]["engine_tokens"], refs["engine_tokens"])
    del bparams
    equal = MESH_REQUESTS - len(gaps)
    print(f"  mesh 2x2 engine, {MESH_REQUESTS} requests at {MESH_SYNC} tokens a sync: {equal} of "
          f"{MESH_REQUESTS} token for token one process's; at each parting the two tokens' "
          f"logits apart by {[round(g, 5) for g in gaps]} of max|logit| (tol {TOL_LOGITS_REL})",
          flush=True)
    check(all(abs(g) <= TOL_LOGITS_REL for g in gaps),
          "the mesh engine parts from one process's tokens on other than a near-tie")
    out.update(engine_equal=equal, engine_parting_gaps=gaps)

    # the data-only mesh on row 12: rank i holds rows 2i, 2i + 1; the
    # control holds each rank's logits against the next rank's rows
    merr, mctrl, local = 0.0, math.inf, MESH_MEGA_BATCH // MESH_RANKS
    for i, r in enumerate(ranks):
        for j in (i, (i + 1) % MESH_RANKS):
            want = refs["mega_logits"][j * local:(j + 1) * local]
            e = max_err(r["mega_logits"], want) / max(want.abs().max().item(), 1.0)
            merr, mctrl = (max(merr, e), mctrl) if j == i else (merr, min(mctrl, e))
    print(f"  mesh 4x1 (data only) prefill {MESH_MEGA_BATCH}x{PROMPT} (local bs 2) + "
          f"{MESH_MEGA_STEPS} steps on the whole-model kernel: first step's logits max|err| "
          f"{merr:.4f} of max|logit| (tol {TOL_LOGITS_REL}; control, another rank's rows, "
          f"{mctrl:.4f})", flush=True)
    check(merr <= TOL_LOGITS_REL, "the data-only mesh's logits disagree with one process's")
    check(mctrl > TOL_LOGITS_REL, "the data-only mesh's gate passes another rank's rows")
    out.update(mega_logits_rel=merr, mega_control_rel=mctrl)

    # the full model
    for key in ("full_eval_loss", "full_train_loss"):
        got = [r[key] for r in ranks]
        rel = abs(got[0] - refs[key]) / abs(refs[key])
        print(f"  mesh 2x2 full model {key.replace('_', ' ')}: {got[0]:.6f} vs one process "
              f"{refs[key]:.6f}, rel {rel:.3e} (tol {TOL_LOSS_REL})", flush=True)
        check(len(set(got)) == 1 and rel <= TOL_LOSS_REL,
              f"the mesh full model's {key} disagrees with one process's")
        out[key + "_rel"] = rel
    ctrl = abs(ranks[0]["full_control_loss"] - refs["full_eval_loss"]) / refs["full_eval_loss"]
    print(f"  mesh 2x2 full model control (the FF's heads all-reduce left out): loss rel "
          f"{ctrl:.3e}", flush=True)
    check(ctrl > TOL_LOSS_REL, "the mesh full model's loss gate passes a forward without "
                               "the FF's heads all-reduce")
    out["full_control_rel"] = ctrl

    # each rank's launches, run by run
    for i, r in enumerate(ranks):
        for label, got in r["launches"].items():
            want = mesh_expected_launches(cfg, label)
            check(got == want, f"rank {i} {label} launches {got}, expected {want}")
            launched = {k for k, n in got.items() if n and k in MESH_HELD_KERNELS}
            check(set(r["held"][label]) == launched,
                  f"rank {i} {label}: held {sorted(r['held'][label])}, launched {sorted(launched)}")
            held = short_figures(r["held"][label])
            print(f"  rank {i} {r['coords']} {label}: launches "
                  f"{ {k: v for k, v in got.items() if v} }; the first launch of each at this "
                  f"rank's shapes against its plain version {held}", flush=True)
        print(f"  rank {i} {r['coords']}: seconds { {k: round(v, 3) for k, v in r['s'].items()} }",
              flush=True)
        out["ranks"].append({"coords": r["coords"], "launches": r["launches"], "s": r["s"],
                             "held": r["held"]})
    return out



def context_inputs(vocab, device):
    """The context phase's token ids [CONTEXT_BATCH, CONTEXT_SEQ + 1], the
    same from their seed in the parent and in every rank."""
    return seeded_ids(CONTEXT_BATCH, CONTEXT_SEQ + 1, vocab, SEED + 5, device)


def context_model(path):
    """The committed weights at ``path`` as float32 leaves on the CPU and
    their config in float32."""
    full, meta = load_params_npz(path, device="cpu", dtype=torch.float32)
    return full, model_config_from_meta(meta).replace(dtype="float32")


@contextlib.contextmanager
def seq_gather_backward_only_slices():
    """The context phase's gradient control: ``gather_from_seq`` with a
    backward that keeps this rank's slice of the gradient and drops the
    other ranks' parts (the heads axis's gather backward)."""
    from nsa_tpu_torch.parallel import comm

    real = comm._GatherFromSeq.__dict__["backward"]
    comm._GatherFromSeq.backward = staticmethod(
        lambda ctx, g: (comm._local_slice(g, ctx.group, ctx.dim), None, None))
    try:
        yield
    finally:
        comm._GatherFromSeq.backward = real


@contextlib.contextmanager
def seq_local_kv_only():
    """The context phase's logits control: every layer's K/V gather keeps
    this rank's own rows and zeros for the other ranks'."""
    from nsa_tpu_torch.parallel import context

    real = context.gather_from_seq

    def local_only(x, dim, mesh):
        full = real(x, dim, mesh)
        keep = torch.zeros(full.shape[dim], dtype=full.dtype, device=full.device)
        n, r = x.shape[dim], mesh.coord(context.AXIS_SEQ)
        keep[r * n:(r + 1) * n] = 1
        return full * keep.view([-1 if i == dim else 1 for i in range(full.dim())])

    context.gather_from_seq = local_only
    try:
        yield
    finally:
        context.gather_from_seq = real


@contextlib.contextmanager
def cp_selections(given=None):
    """``select_blocks`` in the context code recorded (its indices, in call
    order: one a layer a forward, in the list yielded) or, with ``given``
    (one [b, Hs, n, S] index tensor a layer), made to pick those blocks:
    the scores at the given ids become the straight-through gates and the
    mask, as ``select_blocks`` makes them from its own top-k."""
    from nsa_tpu_torch.ops.selection import SCORE_EPS, Selection
    from nsa_tpu_torch.parallel import context

    real, rec = context.select_blocks, []

    def select(scores, num_selected_blocks, use_diff_topk):
        if given is None:
            sel = real(scores, num_selected_blocks, use_diff_topk)
            rec.append(sel.indices.cpu())
            return sel
        idx = given[len(rec) % len(given)].to(scores.device)
        rec.append(idx)
        vals = scores.gather(-1, idx.long())
        gates = vals + (1.0 - vals).detach() if use_diff_topk else None
        return Selection(indices=idx, scores=vals, mask=vals > SCORE_EPS, gates=gates)

    context.select_blocks = select
    try:
        yield rec
    finally:
        context.select_blocks = real


def save_atomic(obj, path):
    torch.save(obj, path + ".tmp")
    os.replace(path + ".tmp", path)


def context_rank(work):
    """One rank of the context phase on the one card with gloo: each
    committed model's float32 logits, loss and summed gradients over the
    seq mesh, the two controls, the bf16 loss, the seconds of its forward +
    backward and of the collectives in it, and its kernel launches (none:
    JAX's context parallelism runs on its XLA path).  Each held against
    the single process's figures that the parent writes to ``work``."""
    from nsa_tpu_torch.parallel import context, scaling_bench
    from nsa_tpu_torch.parallel.mesh import make_seq_mesh, rank_device

    dev = rank_device(DEVICE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_seq_mesh()
    out = {"coord": mesh.coord(context.AXIS_SEQ), "models": {}}
    kept = {}
    zero_launches(ALL_KERNELS)
    for name, path in (("sparse", WEIGHTS), ("full", FULL_WEIGHTS)):
        full, cfg = context_model(path)
        params = pretrain.trainable(full, dev)
        ids = context_inputs(cfg.vocab_size, dev)
        res = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad(), cp_selections() as sel:
            logits = context.context_parallel_forward(params, cfg, ids[:, :-1], mesh)
        torch.cuda.synchronize()
        res["forward_s"] = time.perf_counter() - t0
        # this rank's selections, for the single process's XLA path
        save_atomic(sel, os.path.join(work, f"sel_{name}_{out['coord']}.pt"))
        with timed_collectives() as coll:
            t0 = time.perf_counter()
            loss = context.context_parallel_value_and_grad(params, cfg, ids, mesh)
            torch.cuda.synchronize()
            res["fwd_bwd_s"] = time.perf_counter() - t0
        res.update(loss=float(loss), collective_s=coll["seconds"], collective_calls=coll["calls"])
        with torch.no_grad(), seq_local_kv_only():
            control_logits = context._cp_forward_local(
                params, cfg, context._local(ids[:, :-1], mesh), mesh)
        cparams = pretrain.trainable(full, dev)
        with seq_gather_backward_only_slices():
            context.context_parallel_value_and_grad(cparams, cfg, ids, mesh)
        with torch.no_grad():
            res["bf16_loss"] = float(context.context_parallel_loss(
                params, cfg.replace(dtype="bfloat16"), ids, mesh))
        n_loc = (ids.shape[1] - 1) // mesh.size(context.AXIS_SEQ)
        kept[name] = (logits.cpu(), control_logits.cpu(), n_loc,
                      [p.grad.cpu() for p in tree_leaves(params)],
                      [p.grad.cpu() for p in tree_leaves(cparams)],
                      [k for k, _ in tree_items(params)])
        out["models"][name] = res
        del params, cparams, full, logits, control_logits
        torch.cuda.empty_cache()
    out["launches"] = read_launches(ALL_KERNELS)
    # held against the single process's figures, which it writes meanwhile
    for name, (logits, control_logits, n_loc, grads, cgrads, keys) in kept.items():
        for kind in CONTEXT_REFS:
            ref_path = os.path.join(work, f"context_{name}_{kind}.pt")
            wait_for(ref_path, CONTEXT_TIMEOUT_S)
            ref = torch.load(ref_path, weights_only=True)
            scale = max(ref["logits"].abs().max().item(), 1.0)
            err = (logits - ref["logits"]).abs().amax(-1) / scale      # [b, n] a position
            fig = {"logits_rel": err.max().item(),
                   "positions_over": int((err > TOL_CP_LOGITS).sum()),
                   "worst_position": [int(i) for i in divmod(int(err.argmax()), err.shape[1])]}
            mine = ref["logits"][:, out["coord"] * n_loc:(out["coord"] + 1) * n_loc]
            fig["control_logits_rel"] = max_err(control_logits, mine) / scale
            want = tree_leaves(ref["grads"])
            for key, got in (("grad_sq", grads), ("control_grad_sq", cgrads)):
                fig[key] = {k: ((g.float() - w).square().sum().item(), w.square().sum().item())
                            for k, g, w in zip(keys, got, want)}
            out["models"][name][kind] = fig
    # scaling_bench's rank body in this world: meshes over its first ranks
    t0 = time.perf_counter()
    out["scaling"] = scaling_bench._bench_rank(SCALING_RANKS, SCALING_SEQ, SCALING_BATCH,
                                               SCALING_ITERS, DEVICE)
    out["scaling_s"] = time.perf_counter() - t0
    return out


def context_refs(work):
    """The single process's figures for the context phase on the same ids,
    each model's float32 logits and gradients written to ``work`` for the
    ranks: the model's plain path ("plain": ``transformer_forward`` /
    ``transformer_loss`` with ``use_kernels=False``, row 1's plain version
    for branches 2-3) and JAX's XLA path in one process ("xla": the context
    code on a one-rank seq mesh, which gathers nothing) on the blocks the
    ranks selected, with the count of selections its own top-k makes
    otherwise; and its bf16 kernel-path loss.  Returns the losses."""
    from nsa_tpu_torch.parallel import context

    one = context.Mesh((context.AXIS_SEQ,), (1,), (0,))
    refs = {"sparse": {}, "full": {}}
    # the plain path first: the ranks' selections come while it runs
    for kind, (name, path) in itertools.product(("plain", "xla"), (("sparse", WEIGHTS),
                                                                    ("full", FULL_WEIGHTS))):
        full, cfg = context_model(path)
        ids = context_inputs(cfg.vocab_size, DEVICE)
        params = pretrain.trainable(full, DEVICE)
        if kind == "plain":
            with torch.no_grad():
                logits = transformer_forward(params, cfg, ids[:, :-1], use_kernels=False)
            loss = transformer_loss(params, cfg, ids, use_kernels=False)
            loss.backward()
        else:
            given = None
            if cfg.use_sparse_attn:
                # the ranks' selections, layer by layer over the sequence,
                # and how many (row, head, position) this process's own
                # top-k picks other blocks for
                files = [os.path.join(work, f"sel_{name}_{r}.pt")
                         for r in range(CONTEXT_RANKS)]
                for f in files:
                    wait_for(f, CONTEXT_TIMEOUT_S)
                ranks = [torch.load(f, weights_only=True) for f in files]
                given = [torch.cat(layer, dim=2) for layer in zip(*ranks)]
                with torch.no_grad(), cp_selections() as own:
                    context.context_parallel_forward(params, cfg, ids[:, :-1], one)
                refs[name]["selections_differ"] = sum(
                    int((a.sort(-1).values != b.sort(-1).values).any(-1).sum())
                    for a, b in zip(own, given))
                refs[name]["selections"] = sum(a[..., 0].numel() for a in given)
            with torch.no_grad(), cp_selections(given):
                logits = context.context_parallel_forward(params, cfg, ids[:, :-1], one)
            with cp_selections(given):
                loss = context.context_parallel_value_and_grad(params, cfg, ids, one)
        save_atomic({"logits": logits.cpu(), "grads": tree_to(grad_tree(params), "cpu")},
                    os.path.join(work, f"context_{name}_{kind}.pt"))
        refs[name][kind] = loss.item()
        del params, logits, loss
        torch.cuda.empty_cache()
        if kind == "plain":
            with torch.no_grad():
                refs[name]["bf16"] = transformer_loss(tree_to(full, DEVICE),
                                                      cfg.replace(dtype="bfloat16"), ids).item()
            torch.cuda.empty_cache()
    return refs


def context_phase(smi, bytecode):
    """Context parallelism on the one card (``nsa_tpu_torch/parallel/
    context.py``): CONTEXT_RANKS gloo ranks on a seq mesh against the single
    process on the same weights and ids, then ``scaling_bench`` over their
    first SCALING_RANKS ranks; returns the phase's figures."""
    from nsa_tpu_torch.parallel import scaling_bench
    from nsa_tpu_torch.parallel.mesh import run_ranks

    refs = {}

    def single_process():          # on the card while the ranks start
        t = time.perf_counter()
        refs.update(context_refs(work))
        refs["seconds"] = time.perf_counter() - t

    with tempfile.TemporaryDirectory() as work, bytecode_cache(bytecode):
        t0 = time.perf_counter()
        ranks = run_ranks(context_rank, CONTEXT_RANKS, "gloo", (work,),
                          timeout_s=CONTEXT_TIMEOUT_S, workdir=work, meanwhile=single_process)
        ranks_s = time.perf_counter() - t0
    scaling = scaling_bench.scaling_rows(SCALING_RANKS, SCALING_SEQ, SCALING_BATCH,
                                         ranks[0]["scaling"], DEVICE)
    scaling_s = ranks[0]["scaling_s"]
    print(f"  context: {CONTEXT_RANKS} gloo ranks on a seq mesh on one card {ranks_s:.2f}s "
          f"(the single process's figures meanwhile {refs['seconds']:.2f}s); "
          f"{CONTEXT_BATCH} x {CONTEXT_SEQ} ids, {CONTEXT_SEQ // CONTEXT_RANKS} rows a rank; "
          f"{smi}", flush=True)
    out = {"ranks_s": ranks_s, "refs_s": refs["seconds"], "models": {}}
    for r in ranks:
        check(not any(r["launches"].values()), f"context rank {r['coord']} launched kernels "
                                               f"{r['launches']}: its path is JAX's XLA path")
        check(sorted(r["scaling"]) == [n for n in SCALING_RANKS if r["coord"] < n],
              f"context rank {r['coord']}: scaling_bench ran the sizes {sorted(r['scaling'])}")
    for name in ("sparse", "full"):
        got = [r["models"][name] for r in ranks]
        ref = refs[name]
        figs = {}
        for kind in CONTEXT_REFS:
            loss_rel = max(abs(g["loss"] - ref[kind]) / abs(ref[kind]) for g in got)
            logits_rel = max(g[kind]["logits_rel"] for g in got)
            over = sum(g[kind]["positions_over"] for g in got) // len(got)
            errs = seq_grad_errs(got[0][kind]["grad_sq"])
            worst = max(errs, key=errs.get)
            figs[kind] = {"loss_rel": loss_rel, "logits_rel": logits_rel,
                          "positions_over": over, "grad_rel_l2_max": errs[worst]}
            print(f"  context {name} float32 vs one process's {CONTEXT_REFS[kind]}: loss "
                  f"{got[0]['loss']:.6f} vs {ref[kind]:.6f}, rel max {loss_rel:.3e} over the "
                  f"ranks; logits max|err| {logits_rel:.3e} of max|logit| at (row, position) "
                  f"{got[0][kind]['worst_position']}, {over} of {CONTEXT_BATCH * CONTEXT_SEQ} "
                  f"positions over {TOL_CP_LOGITS}; summed gradients rel L2 max "
                  f"{errs[worst]:.3e} at {worst}, median "
                  f"{sorted(errs.values())[len(errs) // 2]:.3e} over {len(errs)}", flush=True)
        xla = got[0]["xla"]
        control_logits = max(g["xla"]["control_logits_rel"] for g in got)
        cerrs = seq_grad_errs(xla["control_grad_sq"])
        cworst = max(cerrs, key=cerrs.get)
        same = all(g["xla"]["grad_sq"] == xla["grad_sq"] for g in got)
        bf16_rel = max(abs(g["bf16_loss"] - ref["bf16"]) / abs(ref["bf16"]) for g in got)
        share = [g["collective_s"] / g["fwd_bwd_s"] for g in got]
        if "selections" in ref:
            print(f"  context {name}: the one-process XLA path's own top-k picks other blocks "
                  f"than the ranks at {ref['selections_differ']} of {ref['selections']} "
                  f"(layer, row, KV head, position)", flush=True)
        print(f"  context {name}: the gates against the XLA path: loss (tol {TOL_CP_LOSS_REL}), "
              f"logits (tol {TOL_CP_LOGITS}; control, each rank's own K/V only: "
              f"{control_logits:.3e}), gradients (tol {TOL_CP_GRAD_REL_L2}, equal on every rank "
              f"{same}; control, the gather's backward only slicing: {cerrs[cworst]:.3e} at "
              f"{cworst}); against the plain path: loss (tol {TOL_CP_LOSS_REL}), logits (tol "
              f"{TOL_LOGITS_REL}); bf16 loss {got[0]['bf16_loss']:.6f} vs one process's kernel "
              f"path {ref['bf16']:.6f}, rel {bf16_rel:.3e} (tol {TOL_LOSS_REL})", flush=True)
        print(f"  context {name} seconds a rank: forward {[round(g['forward_s'], 3) for g in got]}, "
              f"forward + backward {[round(g['fwd_bwd_s'], 3) for g in got]}, gloo collectives "
              f"{got[0]['collective_calls']} calls, {100 * min(share):.1f}-{100 * max(share):.1f}% "
              f"of the forward + backward; {smi}", flush=True)
        x, pl = figs["xla"], figs["plain"]
        check(x["loss_rel"] <= TOL_CP_LOSS_REL and pl["loss_rel"] <= TOL_CP_LOSS_REL,
              f"context {name}: the loss disagrees")
        check(x["logits_rel"] <= TOL_CP_LOGITS and pl["logits_rel"] <= TOL_LOGITS_REL,
              f"context {name}: the logits disagree")
        check(control_logits > TOL_CP_LOGITS, f"context {name}: the logits gate passes ranks "
                                              f"that see only their own K/V")
        check(x["grad_rel_l2_max"] <= TOL_CP_GRAD_REL_L2 and same,
              f"context {name}: the summed gradients disagree")
        check(cerrs[cworst] > TOL_CP_GRAD_REL_L2, f"context {name}: the gradient gate passes a "
                                                  f"gather whose backward only slices")
        check(bf16_rel <= TOL_LOSS_REL, f"context {name}: the bf16 loss disagrees")
        out["models"][name] = {
            **figs, "selections_differ": ref.get("selections_differ"),
            "control_logits_rel": control_logits,
            "control_grad_rel_l2_max": cerrs[cworst], "bf16_loss_rel": bf16_rel,
            "forward_s": [g["forward_s"] for g in got],
            "fwd_bwd_s": [g["fwd_bwd_s"] for g in got], "collective_share": share}
    print(f"  scaling_bench {SCALING_RANKS} ranks (seq {SCALING_SEQ}, {SCALING_BATCH} rows a "
          f"rank, {SCALING_ITERS} timed steps; its rank body in the same world, over its first "
          f"ranks) {scaling_s:.2f}s: "
          f"{[(r['n_devices'], r['step_ms'], r['tokens_per_s']) for r in scaling]} "
          f"(ranks, step ms, tok/s); {scaling[0]['metric_validity']}", flush=True)
    check(all(r["metric_validity"] == "shared_card" and r["weak_scaling_efficiency"] == ""
              for r in scaling), "scaling_bench gave an efficiency on ranks sharing one card")
    out.update(scaling=scaling, scaling_s=scaling_s)
    return out


def seq_grad_errs(sq):
    """Each gradient's relative L2 error from its (squared difference,
    squared reference) sums."""
    return {k: math.sqrt(d / r) if r > 0 else math.sqrt(d) for k, (d, r) in sq.items()}


def write_random_llama(path, gen):
    """A random checkpoint of LLAMA_CONFIG's shape in the HF layout:
    ``config.json`` and one bf16 ``model.safetensors`` (tied embeddings, so
    no ``lm_head``), the weights N(0, 0.02) and the norms ones, drawn on the
    card from ``gen``."""
    from nsa_tpu_torch.models.llama_import import write_safetensors

    c = LLAMA_CONFIG
    d, inter, dh = c["hidden_size"], c["intermediate_size"], c["head_dim"]
    q, kv = c["num_attention_heads"] * dh, c["num_key_value_heads"] * dh

    def w(*shape):
        return (torch.randn(shape, generator=gen, device=DEVICE) * 0.02).to(torch.bfloat16).cpu()

    def ones():
        return torch.ones(d, dtype=torch.bfloat16)

    sd = {"model.embed_tokens.weight": w(c["vocab_size"], d), "model.norm.weight": ones()}
    for i in range(c["num_hidden_layers"]):
        p = f"model.layers.{i}."
        sd.update({p + "input_layernorm.weight": ones(),
                   p + "post_attention_layernorm.weight": ones(),
                   p + "self_attn.q_proj.weight": w(q, d), p + "self_attn.k_proj.weight": w(kv, d),
                   p + "self_attn.v_proj.weight": w(kv, d), p + "self_attn.o_proj.weight": w(d, q),
                   p + "mlp.gate_proj.weight": w(inter, d), p + "mlp.up_proj.weight": w(inter, d),
                   p + "mlp.down_proj.weight": w(d, inter)})
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({**c, "architectures": ["LlamaForCausalLM"], "model_type": "llama"}, f)
    write_safetensors(os.path.join(path, "model.safetensors"), sd)
    return sum(t.numel() for t in sd.values())


def short_figures(held):
    """``hold_first_launches``'s figures with their floats to 4 digits."""
    return {k: {f: float(f"{x:.4g}") if isinstance(x, float) else x for f, x in v.items()}
            for k, v in held.items()}


def adapter_expected(depth, steps, hidden_steps=0):
    """Launches of ``steps`` distillation steps, ``hidden_steps`` of them
    with the teacher's hiddens: the teacher's forward on row 13 (again for
    the hiddens), the student's on row 1, its backward on rows 4 and 5."""
    return {**{fn.__name__: 0 for fn in ALL_KERNELS},
            "flash_attention": depth * (steps + hidden_steps), "prefill_fwd": depth * steps,
            "prefill_bwd_dq": depth * steps, "prefill_bwd_dkv": depth * steps}


def adapter_phase(smi):
    """The adapter / distillation line on the card, bf16 (see ADAPTER_*):
    fine-tuning from the committed full-attention teacher in every mode,
    the gradient flow, one step's loss and gradients against the plain
    path, QA accuracy base and adapted, and a random checkpoint of
    Llama-3.2-1B's shape through ``llama_import`` with a distillation step
    at G = 4; returns (the launches over the phase, its figures)."""
    from nsa_tpu_torch.eval import finetune_eval
    from nsa_tpu_torch.models import adapter as adapter_module
    from nsa_tpu_torch.models import llama_import
    from nsa_tpu_torch.train import finetune
    from nsa_tpu_torch.train.data import load_cs441_qa_pairs

    out, total = {"losses": {}, "launches": {}, "s": {}}, {fn.__name__: 0 for fn in ALL_KERNELS}
    teacher, meta = load_params_npz(FULL_WEIGHTS, device=DEVICE, dtype=torch.float32)
    cfg_t = model_config_from_meta(meta).replace(dtype="bfloat16")
    cfg_s = cfg_t.replace(use_sparse_attn=True)
    train_pairs, test_pairs = (load_cs441_qa_pairs(split=s) for s in ("train", "test"))
    d = cfg_t.depth
    logger = MetricsLogger()

    def counted(label, want, fn):
        zero_launches(ALL_KERNELS)
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out["s"][label] = time.perf_counter() - t0
        got = read_launches(ALL_KERNELS)
        out["launches"][label] = {k: v for k, v in got.items() if v}
        if want is not None:
            check(got == want, f"adapter {label}: launches {got}, expected {want}")
        for k, v in got.items():
            total[k] += v
        return res

    # 1. run_finetune in every mode from the committed teacher
    adapters, loss = counted(
        "kl_output_only", adapter_expected(d, ADAPTER_KL_STEPS),
        lambda: finetune.run_finetune(teacher, cfg_t, cfg_s, train_pairs,
                                      num_steps=ADAPTER_KL_STEPS, batch_size=ADAPTER_BATCH,
                                      seq_len=ADAPTER_SEQ, seed=SEED, logger=logger))
    out["losses"]["kl_output_only"] = loss
    for mode in adapter_module.MODES[1:]:
        hidden = int(mode in ("mse_hidden", "mixed"))
        _, out["losses"][mode] = counted(
            mode, adapter_expected(d, 1, hidden),
            lambda mode=mode: finetune.run_finetune(
                teacher, cfg_t, cfg_s, train_pairs, num_steps=1, batch_size=ADAPTER_BATCH,
                seq_len=ADAPTER_SEQ, mode=mode, seed=SEED, logger=logger, adapters=adapters))
    print(f"  adapter run_finetune from {os.path.relpath(FULL_WEIGHTS, HERE)} on "
          f"{len(train_pairs)} QA pairs, bs {ADAPTER_BATCH} x seq {ADAPTER_SEQ}, bf16: losses "
          f"{ {k: round(v, 5) for k, v in out['losses'].items()} } ({ADAPTER_KL_STEPS} steps of "
          f"kl_output_only, one of each other mode); seconds "
          f"{ {k: round(v, 2) for k, v in out['s'].items()} }; launches "
          f"{out['launches']['kl_output_only']} (kl_output_only); {smi}", flush=True)
    check(all(math.isfinite(v) for v in out["losses"].values()), "adapter: a loss is not finite")

    # 2. the gradient flow; 3. one step's loss and gradients against the plain path
    ids_np, mask_np = finetune.qa_to_tokens(train_pairs[:ADAPTER_BATCH], ADAPTER_SEQ + 1)
    ids = torch.from_numpy(ids_np).long().to(DEVICE)
    mask = torch.from_numpy(mask_np).to(DEVICE)
    ok, info = counted("gradient_flow", adapter_expected(d, 1), lambda: (
        adapter_module.verify_gradient_flow(adapters, teacher, cfg_s, cfg_t, ids[:, :-1])))
    print(f"  adapter verify_gradient_flow: {ok}, adapters' gradient norms "
          f"{[round(n, 5) for n in info['adapter_grad_norms']]}, the teacher's "
          f"{info['teacher_grad_norm']}", flush=True)
    check(ok, f"adapter: the gradients do not flow as they should: {info}")
    leaves = tree_leaves(adapters)

    def step(use_kernels, mode):
        loss = adapter_module.distillation_step_loss(
            adapters, teacher, cfg_s, cfg_t, ids[:, :-1], label_mask=mask[:, 1:], mode=mode,
            use_kernels=use_kernels)
        return loss.item(), torch.autograd.grad(loss, leaves)

    # the train gates on the student's cross-entropy ('ce'): a loss of the
    # training phase's kind, whose rounding the gates were set for
    kloss, kgrads = counted("step_kernels", adapter_expected(d, 1), lambda: step(True, "ce"))
    ploss, pgrads = step(False, "ce")
    errs = {key: rel_l2(a, b) for (key, _), a, b in zip(tree_items(adapters), kgrads, pgrads)}
    worst = max(errs, key=errs.get)
    rel = abs(kloss - ploss) / abs(ploss)
    del kgrads, pgrads
    # the teacher's logits (row 13) under the logits gate; and, for the
    # record, the kl_output_only step: the KL of two close models is a
    # small difference of sums, which bf16 rounding moves further
    with torch.no_grad():
        tk = counted("teacher_kernels", {**adapter_expected(d, 0), "flash_attention": d},
                     lambda: transformer_forward(teacher, cfg_t, ids[:, :-1]))
        tp = transformer_forward(teacher, cfg_t, ids[:, :-1], use_kernels=False)
    t_err = max_err(tk, tp) / max(tp.abs().max().item(), 1.0)
    del tk, tp
    kl_k, kl_kg = counted("step_kl_kernels", adapter_expected(d, 1),
                          lambda: step(True, "kl_output_only"))
    kl_p, kl_pg = step(False, "kl_output_only")
    kl_errs = [rel_l2(a, b) for a, b in zip(kl_kg, kl_pg)]
    del kl_kg, kl_pg
    print(f"  adapter step ('ce'), kernels vs plain: loss {kloss:.6f} vs {ploss:.6f}, rel "
          f"{rel:.3e} (tol {TOL_LOSS_REL}); gradients rel L2 max {errs[worst]:.3e} at {worst} "
          f"(tol {TOL_GRAD_REL_L2}), median {sorted(errs.values())[len(errs) // 2]:.3e} over "
          f"{len(errs)}; the teacher's logits (row 13) max|err| {t_err:.4f} of max|logit| (tol "
          f"{TOL_LOGITS_REL}); kl_output_only step, not gated: {kl_k:.6f} vs {kl_p:.6f}, rel "
          f"{abs(kl_k - kl_p) / abs(kl_p):.3e}, gradients rel L2 max {max(kl_errs):.3e}",
          flush=True)
    check(rel <= TOL_LOSS_REL, "adapter: the kernel path's loss disagrees with the plain path")
    check(errs[worst] <= TOL_GRAD_REL_L2, "adapter: the kernel path's gradients disagree")
    check(t_err <= TOL_LOGITS_REL, "adapter: the teacher's logits disagree with the plain path")
    out.update(step_loss_rel=rel, step_grad_rel_l2_max=errs[worst], teacher_logits_rel=t_err,
               kl_step_loss_rel=abs(kl_k - kl_p) / abs(kl_p), kl_step_grad_rel_l2_max=max(kl_errs))

    # 4. QA accuracy, base and adapted, at a fixed length
    base_fn = finetune_eval.model_forward_fn(
        lambda x: transformer_forward(teacher, cfg_t, x), teacher)
    qa = counted("qa", None, lambda: finetune_eval.evaluate_qa_accuracy(
        adapters, teacher, cfg_s, test_pairs, gen_len=ADAPTER_GEN, max_samples=ADAPTER_QA,
        compare_base=base_fn, fixed_len=ADAPTER_SEQ))
    got = out["launches"]["qa"]
    print(f"  adapter evaluate_qa_accuracy, {qa['num_samples']} questions x {ADAPTER_GEN} "
          f"tokens at fixed length {ADAPTER_SEQ}: adapted {qa['accuracy']:.3f} "
          f"{tuple(round(float(x), 3) for x in qa['accuracy_ci95'])}, base "
          f"{qa['base_accuracy']:.3f} "
          f"{tuple(round(float(x), 3) for x in qa['base_accuracy_ci95'])}; "
          f"{out['s']['qa']:.2f}s; "
          f"launches {got}; predictions {[r['pred'] for r in qa['results']]}", flush=True)
    check(qa["num_samples"] == ADAPTER_QA and got.get("prefill_fwd", 0) >= d * ADAPTER_QA
          and got.get("flash_attention", 0) >= d * ADAPTER_QA
          and not got.get("prefill_bwd_dq") and not got.get("prefill_bwd_dkv"),
          f"adapter QA: {qa['num_samples']} questions, launches {got}")
    out["qa"] = {k: qa[k] for k in ("accuracy", "accuracy_ci95", "base_accuracy",
                                    "base_accuracy_ci95", "num_samples")}
    del adapters, teacher
    torch.cuda.empty_cache()

    # 5. a random checkpoint of Llama-3.2-1B's shape, cut to 2 layers
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    with tempfile.TemporaryDirectory() as ckpt:
        t0 = time.perf_counter()
        n_params = write_random_llama(ckpt, gen)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        lparams, lcfg = llama_import.convert_llama_checkpoint(ckpt, device=DEVICE)
        convert_s = time.perf_counter() - t0
    lcfg = lcfg.replace(dtype="bfloat16")
    scfg = lcfg.replace(use_sparse_attn=True)
    c = LLAMA_CONFIG
    check((lcfg.heads, lcfg.kv_heads, lcfg.dim_head, lcfg.dim, lcfg.vocab_size, lcfg.depth,
           lcfg.rope_theta, lcfg.ff_kind)
          == (c["num_attention_heads"], c["num_key_value_heads"], c["head_dim"],
              c["hidden_size"], c["vocab_size"], c["num_hidden_layers"], c["rope_theta"],
              "swiglu") and torch.equal(lparams["to_logits"].T, lparams["token_emb"]),
          f"llama_import: config {lcfg}")
    lids = seeded_ids(LLAMA_BATCH, ADAPTER_SEQ + 1, lcfg.vocab_size, SEED + 6, DEVICE)
    ladapters = pretrain.trainable(adapter_module.init_adapters(
        torch.Generator().manual_seed(SEED), scfg, lparams))

    def llama_run():
        with torch.no_grad():
            logits = transformer_forward(lparams, lcfg, lids[:, :-1])
        opt = finetune.make_finetune_optimizer(ladapters, 1e-4, 1)
        loss = finetune.finetune_step(ladapters, opt, lparams, lids,
                                      torch.ones_like(lids, dtype=torch.bool), scfg, lcfg)
        return logits, loss.item()

    with first_launch_operands() as rec:
        llogits, lloss = counted("llama", None, llama_run)
    want = adapter_expected(lcfg.depth, 1)
    want["flash_attention"] += lcfg.depth            # the teacher's forward before the step
    check(out["launches"]["llama"] == {k: v for k, v in want.items() if v},
          f"adapter llama launches {out['launches']['llama']}, expected {want}")
    held = hold_first_launches(rec, scfg, "llama G=4")
    check(set(held) == {"prefill_fwd", "prefill_bwd_dq", "prefill_bwd_dkv", "flash_attention"},
          f"llama: held {sorted(held)}")
    print(f"  adapter llama_import: a random checkpoint of Llama-3.2-1B's shape cut to "
          f"{lcfg.depth} layers ({n_params:,} parameters, bf16 safetensors written in "
          f"{write_s:.2f}s, read and converted in {convert_s:.2f}s): heads {lcfg.heads}/"
          f"{lcfg.kv_heads} (G {lcfg.num_grouped_queries}), dim {lcfg.dim}, vocab "
          f"{lcfg.vocab_size}; the teacher's logits {tuple(llogits.shape)} finite "
          f"{bool(torch.isfinite(llogits).all())}; one distillation step's loss {lloss:.6f}; "
          f"{out['s']['llama']:.2f}s; launches {out['launches']['llama']}; the first launch "
          f"of each against its plain version {short_figures(held)}; {smi}", flush=True)
    check(tuple(llogits.shape) == (LLAMA_BATCH, ADAPTER_SEQ, lcfg.vocab_size)
          and bool(torch.isfinite(llogits).all()) and math.isfinite(lloss),
          "llama: the teacher's logits or the step's loss are not finite")
    out.update(llama={"params": n_params, "write_s": write_s, "convert_s": convert_s,
                      "loss": lloss, "held": held})
    del lparams, ladapters, llogits
    torch.cuda.empty_cache()
    out["total_launches"] = total
    return total, out


def main():
    faulthandler.dump_traceback_later(TIME_LIMIT_S, exit=True)
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on a GPU", file=sys.stderr)
        sys.exit(1)
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    bytecode = start_bytecode_cache()   # for the mesh phase's ranks, beside the build
    try:
        run_phases(t0, kind, count, bytecode)
    finally:
        if bytecode[0].poll() is None:
            bytecode[0].kill()
        bytecode[0].wait()
        shutil.rmtree(bytecode[1], ignore_errors=True)


def run_phases(t0, kind, count, bytecode):
    """Every phase after the device check; prints the result lines."""
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
        ablations = ablation_phase(smi)
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

    here = os.getcwd()
    with tempfile.TemporaryDirectory() as work:
        # the corpus cache, checkpoints and exports land here, never in the tree
        os.chdir(work)
        try:
            train_launches, train = train_phase(smi)
            torch.cuda.empty_cache()
            t0 = phase("train", t0)
            cpt = cpt_phase(smi)
            t0 = phase("cpt", t0)
        finally:
            os.chdir(here)

    compressors = compress_phase(smi)
    t0 = phase("compress", t0)

    configs = configs_phase(smi)
    t0 = phase("configs", t0)

    with torch.inference_mode():
        long = long_phase(smi, lib.log)
    t0 = phase("long", t0)

    mesh = mesh_phase(smi, bytecode)
    t0 = phase("mesh", t0)

    seq_parallel = context_phase(smi, bytecode)
    t0 = phase("context", t0)

    adapter_launches, adapter = adapter_phase(smi)
    t0 = phase("adapter", t0)

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
        # and the long phase's 16k sweep (rows 1, 2, 3, 12, 13)
        k["long_launches"] = long["sweep"]["launches"][k["name"].removesuffix("_trained")]
        k["launches"] += k["long_launches"]
        # and each mesh rank's, over the phase's runs
        k["mesh_launches"] = [sum(g[k["name"].removesuffix("_trained")]
                                  for g in r["launches"].values()) for r in mesh["ranks"]]
        k["launches"] += sum(k["mesh_launches"])
        # and the adapter phase's (rows 1, 4, 5 and 13)
        k["adapter_launches"] = adapter_launches[k["name"].removesuffix("_trained")]
        k["launches"] += k["adapter_launches"]
    print(json.dumps({"main": {
        "prefill_s": prefill_s, "decode_tok_s": BATCH * GEN / decode_s,
        "measure_decode_tok_s": tps, "measure_prefill_tok_s": prefill_tps, "peak_bytes": peak,
        "logits_max_abs_err": err, "decode_device_busy": busy, "small": small,
        "serve": served, "full": full, "eval": evaluated, "eval_launches": eval_launches,
        "graph": graphs, **train,
        "train_launches": train_launches, "cpt": cpt, "compress": compressors,
        "configs": configs, "ablation": ablations, "long": long, "mesh": mesh,
        "context": seq_parallel, "adapter": adapter, "phases_s": dict(PHASES)}}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)   # the card's name and power limit, as nvidia-smi gives them
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main()
