"""The whole-model decode step in one kernel
(``nsa_tpu/ops/pallas/nsa_megakernel.py``: ``decode_step_mega``).

``decode_step_mega`` runs an entire decode step at small batch — the token
embedding, every layer (RMSNorm, the fused q|k|v|gate projection, rotary,
the ring shift and, on 1 step in ``stride``, the compressed-block
emission, compressed attention and selection, the kv row write, fine and
sliding attention under the gate, ``w_out``, the residual and the FF), the
final RMSNorm and the LM head — in one launch of the CUDA kernel
``csrc/nsa_decode_mega.cu``.  With ``greedy=True`` the argmax is taken in
the kernel too, and ``steps`` tokens are decoded per launch, each feeding
the next.

The per-layer semantics are those of the fused pair
(``nsa_decode_fused.py``), which the plain version reuses layer by layer:
``decode_step_mega_plain`` walks the layers with
``decode_select_emit_plain``, ``decode_attend_fused_plain`` (the FF
included) and adds the embedding, the final norm, the LM head and the
argmax.  It rounds where JAX's megakernel rounds: the fused projection is
cast to the model dtype before rotary and the gates; rotary and the gate
sigmoid are computed in float32 and rounded; ``mem_kv`` stays float32; the
logits are rounded to the model dtype before the float32 cast and the
argmax, whose ties go to the lowest index.

The wrapper runs the plain version for CPU tensors only; on CUDA tensors
it launches the kernel or raises, also when its launch plan (``mega_plan``:
one block per SM, each holding its 8-column tiles of every product in
shared memory beside its work space) does not fit the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple, Union

import torch

from ..common import rms_norm
from ..rotary import apply_rotary, rope_frequencies
from . import runtime
from .nsa_decode import INFO_WIDTH, select_scores_plain
from .nsa_decode_fused import EMIT_COLS, decode_attend_fused_plain, decode_select_emit_plain
from .nsa_decode_ragged import EMIT_ALIGN, STATIC_SMEM, check_plan, emit_tc_smem_bytes

MAX_BATCH = 16      # the kernel's batch limit (JAX's megakernel asserts b <= 16): one row tile
MAX_DEPTH = 16      # layers the kernel's cache pointer table holds
# the kernel's weight tiles (csrc/decode_tc_common.cuh): 8 columns, loaded in
# boxes of 64 rows; product widths must be multiples of the first, depths of
# the second
TILE_COLS, BOX_ROWS = 8, 64
# what phase_ns's marks close, layer by layer (csrc/nsa_decode_mega.cu)
PHASE_NAMES = ("norm+qkvg", "select+attend+emission", "w_out+ring", "norm+ff1", "ff2")

# stacked per-layer weights of pack_mega_params, in the kernel's order
LAYER_LEAVES = ("attn_norm", "w_qkvg", "gate_b", "mem_kv", "pos_kv", "b1k", "b1v", "b2c",
                "w1k", "w1v", "w2c", "w_out", "ff_norm", "fw1", "fb1", "fw2", "fb2")

Caches = Union[torch.Tensor, Sequence[torch.Tensor]]


def phase_marks(depth: int, steps: int) -> int:
    """Timestamps ``phase_ns`` receives: the start, then after each of the
    5 phases of every layer and the LM head of every step."""
    return 1 + steps * (5 * depth + 1)


def _layers(x: Caches):
    """Per-layer cache tensors: the views of a stacked [L, ...] tensor, or
    the given sequence (a ``ModelCache``'s own tensors)."""
    return list(x.unbind(0)) if isinstance(x, torch.Tensor) else list(x)


def decode_step_mega_plain(mp: dict, kv: Caches, ckv: Caches, ring: Caches,
                           token: torch.Tensor, t, *, steps: int = 1,
                           greedy: bool = False, heads: int, stride: int, sel_block: int,
                           num_sel: int, n_slide: int, window: int, scale: float,
                           eps: float, theta: float):
    """The plain PyTorch version of ``decode_step_mega`` (``t`` an int or a
    0-d tensor)."""
    kvs, ckvs, rings = _layers(kv), _layers(ckv), _layers(ring)
    b, kvh, max_len, d2 = kvs[0].shape
    d = d2 // 2
    g = heads // kvh
    din, dkv = heads * d, kvh * d
    mdt = mp["token_emb"].dtype
    skw = dict(max_blocks=max_len // sel_block, stride=stride, sel_block=sel_block,
               num_sel=num_sel, n_slide=n_slide, scale=scale)
    akw = dict(sel_block=sel_block, window=window, num_sel=num_sel, n_slide=n_slide,
               scale=scale, eps=eps)
    tok, picked = token.long(), []
    for s in range(steps):
        ts = t + s
        pos = torch.as_tensor(ts, device=token.device).reshape(1)
        x = mp["token_emb"][tok]                                   # [b, dim]
        for l in range(len(kvs)):
            normed = rms_norm(x, mp["attn_norm"][l, 0], eps)
            proj = (normed.float() @ mp["w_qkvg"][l].float()).to(mdt)
            q = proj[:, :din].reshape(b, kvh, g, d)
            k_u = proj[:, din:din + dkv].reshape(b, kvh, 1, d)
            v_u = proj[:, din + dkv:din + 2 * dkv].reshape(b, kvh, 1, d)
            gates = torch.sigmoid(proj[:, din + 2 * dkv:].float()
                                  + mp["gate_b"][l, 0].float()).to(mdt)
            rq = apply_rotary(q.reshape(b, heads, 1, d), pos, theta).reshape(b, kvh, g, d)
            rk = apply_rotary(k_u, pos, theta)
            c_out, info = decode_select_emit_plain(
                q.contiguous(), ckvs[l], rings[l], torch.cat([k_u, v_u], -1).to(rings[l].dtype),
                mp["mem_kv"][l], mp["pos_kv"][l], mp["w1k"][l], mp["b1k"][l], mp["w1v"][l],
                mp["b1v"][l], mp["w2c"][l], mp["b2c"][l], ts, ts // stride, **skw)
            ff = (mp["ff_norm"][l, 0], mp["fw1"][l], mp["fb1"][l, 0], mp["fw2"][l],
                  mp["fb2"][l, 0])
            x = decode_attend_fused_plain(
                rq, kvs[l], torch.cat([rk, v_u], -1).to(kvs[l].dtype), info, c_out,
                gates.reshape(b, kvh, g, 3), x[:, None], mp["w_out"][l], ts, ff, **akw)[:, 0]
        normed = rms_norm(x, mp["out_norm"][0], eps)
        logits = (normed.float() @ mp["to_logits"].float()).to(mdt).float()
        if greedy:
            tok = logits.argmax(-1)            # ties: the first maximal index
            picked.append(tok.to(torch.int32))
    if greedy:
        return logits, torch.stack(picked, 1), kv, ckv, ring
    return logits, kv, ckv, ring


def layer_select_emit_plain(mp: dict, l: int, q: torch.Tensor, ckv: torch.Tensor,
                            ring: torch.Tensor, kv_new: torch.Tensor, t: int, *, max_len: int,
                            stride: int, sel_block: int, num_sel: int, n_slide: int,
                            scale: float):
    """Layer ``l``'s selection, compressed attention and emission as the
    plain version takes them, on given inputs: q [b, kvh, g, d] unrotated,
    ckv and ring as they were before the step (left unchanged), kv_new [b,
    kvh, 1, 2d] the new unrotated k || v.  Fed the kernel's own q and new
    row (``inspect``), it holds each layer's selection to the plain one.
    Returns (c_out, info [b, kvh, INFO_WIDTH], ckv after the step, the
    selection scores [b, kvh, blocks])."""
    b, kvh = q.shape[:2]
    after = ckv.clone()
    num_cb = t // stride
    c_out, info = decode_select_emit_plain(
        q, after, ring.clone(), kv_new, mp["mem_kv"][l], mp["pos_kv"][l], mp["w1k"][l],
        mp["b1k"][l], mp["w1v"][l], mp["b1v"][l], mp["w2c"][l], mp["b2c"][l], t, num_cb,
        max_blocks=max_len // sel_block, stride=stride, sel_block=sel_block, num_sel=num_sel,
        n_slide=n_slide, scale=scale)
    _, scores = select_scores_plain(q, ckv, mp["mem_kv"][l], num_cb, t, stride=stride,
                                    sel_block=sel_block, scale=scale)
    return c_out, info.reshape(b, kvh, INFO_WIDTH), after, scores


# the products' order in the kernel's plan, and the order in which their
# tiles are dealt to the blocks (ff w2's, the largest, first)
QKVG, WOUT, FW1, FW2, HEAD = range(5)
PLACEMENT = (FW2, WOUT, HEAD, QKVG, FW1)
PLAN_KEYS = ("grid", "blocks_per_sm", "slice_bytes", "slice_total", "work_bytes",
             "smem_bytes", "smem_optin")
# the bodies' warps, rows of a selection chunk or an attention tile, the
# staged row's stride in bf16, and select_body's ring slots a warp
_WARPS, _CHUNK_ROWS, _FULL_ROW, _SEL_DEPTH = 8, 16, 136, 2


def _select_smem(g: int, Wc: int, M: int, Wf: int, d: int = 64) -> int:
    """select_body's shared memory in the whole-model kernel, float32 mem
    slots (select_smem_bytes, csrc/decode_common.cuh)."""
    return (2 * _WARPS * _SEL_DEPTH * _CHUNK_ROWS * _FULL_ROW + 4 * 2 * M * d
            + 4 * (g * d + g * Wc + Wf))


def _attend_smem(g: int, J: int, d: int = 64) -> int:
    """attend_body's shared memory (attend_smem_bytes, csrc/decode_common.cuh)."""
    return 2 * -(-J // _CHUNK_ROWS) * _CHUNK_ROWS * _FULL_ROW + 4 * (2 * g * d + 3 * g) + 4 * 2 * J


def mega_plan(*, kvh: int, g: int, dim: int, hid4: int, vocab: int, Wc: int, M: int, Bc: int,
              sel_block: int, stride: int, num_sel: int, n_slide: int, grid: int,
              smem_optin: int, d: int = 64) -> dict:
    """The whole-model kernel's launch plan at one block per SM (``grid``
    SMs): the q|k|v|gate, w_out, ff w1, ff w2 and LM-head products in
    8-column tiles, tile i of a product on block (off + i) % grid, the
    products' tiles dealt in turn (``PLACEMENT``); the largest block's and
    all blocks' tile bytes, the work space a block (the largest of the
    selection, the attention, the emission, the ring shift and the staged
    rows of a product), the dynamic shared memory a block (1024 bytes of
    alignment slack, the tiles, the work space, each on a 1024-byte
    boundary for the emission's swizzled boxes), and ``fits`` when that and
    the kernel's static shared memory stay within ``smem_optin``.  The same
    arithmetic as ``make_mega_plan`` in csrc/nsa_decode_mega.cu."""
    h = kvh * g
    P = h * d + 2 * kvh * d + 3 * h
    rows = (dim, h * d, dim, hid4, dim)
    tiles = (P // TILE_COLS, dim // TILE_COLS, hid4 // TILE_COLS, dim // TILE_COLS,
             vocab // TILE_COLS)
    off, nxt = [0] * 5, 0
    for q in PLACEMENT:
        off[q] = nxt % grid
        nxt += tiles[q]
    per_block = []
    for blk in range(grid):
        total = 0
        for q in range(5):
            i0 = (blk - off[q]) % grid
            count = (tiles[q] - i0 + grid - 1) // grid if i0 < tiles[q] else 0
            total += count * rows[q] * 2 * TILE_COLS
        per_block.append(total)
    J = (num_sel + n_slide) * sel_block
    stage = 16 * (max(dim, h * d, hid4) + 8) * 2 + 4 * _WARPS * max(kvh, 1) * 128
    work = max(_select_smem(g, Wc, M, Wc // (sel_block // stride), d), _attend_smem(g, J, d),
               emit_tc_smem_bytes(Bc, d), Bc * 2 * d * 2, stage)
    work = -(-work // 16) * 16
    slice_bytes = max(per_block)
    smem = EMIT_ALIGN + -(-slice_bytes // EMIT_ALIGN) * EMIT_ALIGN + work
    return {"grid": grid, "slice_bytes": slice_bytes, "slice_total": sum(per_block),
            "work_bytes": work, "smem_bytes": smem, "smem_optin": smem_optin,
            "fits": smem + STATIC_SMEM <= smem_optin}


@functools.lru_cache(maxsize=None)
def _device_plan(device: int, ints: tuple) -> dict:
    out = (ctypes.c_int * len(PLAN_KEYS))()
    with torch.cuda.device(device):
        runtime.library().call("nsa_decode_mega_plan", (ctypes.c_int * len(ints))(*ints),
                               len(ints), ctypes.addressof(out))
    plan = dict(zip(PLAN_KEYS, out))
    return {**plan, "fits": plan["blocks_per_sm"] >= 1}


@functools.lru_cache(maxsize=None)
def _inv_freq(d: int, theta: float, device: str) -> torch.Tensor:
    """rotary's inverse frequencies, once per device: the plain version's
    ``rope_frequencies`` values, so both rotate by the same angles."""
    return rope_frequencies(d, theta, torch.device(device))


def launch_plan(device, ints) -> dict:
    """The kernel's plan on ``device`` for the C entry's ints (see
    ``decode_step_mega``; the plan does not depend on steps or greedy),
    as its C entry computes it: ``PLAN_KEYS``, and ``fits`` (at least one
    block an SM)."""
    index = torch.device(device).index
    return dict(_device_plan(torch.cuda.current_device() if index is None else index,
                             tuple(int(x) for x in ints)))


def _scratch(device, spec):
    """One allocation carved into the kernel's scratch buffers: spec is a
    list of (numel, dtype); each buffer starts on a 256-byte boundary."""
    offs, total = [], 0
    for numel, dtype in spec:
        offs.append(total)
        total += -(-numel * torch.empty((), dtype=dtype).element_size() // 256) * 256
    buf = torch.empty(total, dtype=torch.uint8, device=device)
    return [buf[o:o + n * torch.empty((), dtype=dt).element_size()].view(dt)
            for o, (n, dt) in zip(offs, spec)]


def decode_step_mega(mp: dict, kv: Caches, ckv: Caches, ring: Caches, token: torch.Tensor,
                     t, *, steps: int = 1, greedy: bool = False, heads: int,
                     stride: int, sel_block: int, num_sel: int, n_slide: int, window: int,
                     scale: float, eps: float, theta: float,
                     phase_ns: Optional[torch.Tensor] = None,
                     inspect: Optional[dict] = None) -> Tuple[torch.Tensor, ...]:
    """Whole-model decode at position ``t`` (an int, or a 0-d int32 tensor
    on the caches' device, which the kernel reads there: the caller then
    keeps ``t + steps <= max_len``) -> (logits [b, vocab] float32,
    kv, ckv, ring), or with ``greedy=True`` (logits, tokens [b, steps]
    int32, kv, ckv, ring): ``tokens[:, i]`` is the token sampled after
    consuming position ``t + i``, and the logits are the last step's.

    ``mp`` from ``pack_mega_params``; token [b] int.  kv [L, b, kvh,
    max_len, 2d], ckv [L, b, kvh, Wc, 2d] and ring [L, b, kvh, Bc, 2d] are
    stacked tensors or sequences of L per-layer tensors (a ``ModelCache``'s
    own); they are updated in place and returned as given.  ``steps > 1``
    only when greedy.  ``phase_ns``, an int64 CUDA tensor of at least
    ``phase_marks(L, steps)`` values, receives the card's global timer (ns)
    at the kernel's start and after each of its grid syncs (where the time
    goes; not written on the CPU).  ``inspect``, a dict, receives on the
    card the kernel's own intermediates of every layer of the last step:
    ``q``, ``rq`` and ``c_out`` [L, b, kvh, g, d], ``gates`` [L, b, kvh, g,
    3], ``info`` [L, b, kvh * INFO_WIDTH] and ``attn_out`` [L, b, kvh, g, d],
    the attention output rounded as ``w_out`` takes it (for the checks that
    hold each layer's selection and attention to their plain versions)."""
    kw = dict(heads=heads, stride=stride, sel_block=sel_block, num_sel=num_sel,
              n_slide=n_slide, window=window, scale=scale, eps=eps, theta=theta)
    kvs, ckvs, rings = _layers(kv), _layers(ckv), _layers(ring)
    L = len(kvs)
    b, kvh, max_len, d2 = kvs[0].shape
    if steps < 1 or (steps > 1 and not greedy):
        raise ValueError(f"steps must be 1, or more with greedy=True; got {steps}")
    if not (len(ckvs) == len(rings) == L == mp["w_qkvg"].shape[0]) or b > MAX_BATCH or (
            isinstance(t, int) and not 0 <= t <= max_len - steps):
        raise ValueError(f"decode_step_mega takes {mp['w_qkvg'].shape[0]} layers of kv, ckv "
                         f"and ring, b <= {MAX_BATCH} and t + steps <= max_len; got "
                         f"{L}/{len(ckvs)}/{len(rings)} layers, b={b}, t={t}, steps={steps}, "
                         f"max_len={max_len}")
    leaves = [mp[k] for k in ("token_emb", "to_logits", "out_norm", *LAYER_LEAVES)]
    if runtime.on_cpu(token, *kvs, *ckvs, *rings, *leaves):
        return decode_step_mega_plain(mp, kv, ckv, ring, token, t, steps=steps, greedy=greedy,
                                      **kw)
    d = d2 // 2
    g = heads // kvh
    Wc, Bc = ckvs[0].shape[2], rings[0].shape[2]
    vocab, dim = mp["token_emb"].shape
    M, hid, hid4 = mp["mem_kv"].shape[3], mp["w1k"].shape[3], mp["fw1"].shape[2]
    P = mp["w_qkvg"].shape[2]
    npf = sel_block // stride
    if d != 64 or g not in (1, 2, 4, 8) or L > MAX_DEPTH or npf < 2 or Wc % npf \
            or max_len % sel_block or 2 * num_sel + n_slide > INFO_WIDTH \
            or P % TILE_COLS or vocab % TILE_COLS or dim % BOX_ROWS or hid4 % BOX_ROWS \
            or hid % EMIT_COLS:
        raise ValueError(
            f"decode_step_mega kernel takes dim_head 64, g in 1/2/4/8, <= {MAX_DEPTH} layers, "
            f"sel_block/stride >= 2 dividing the ckv width, projection and vocab widths "
            f"divisible by its {TILE_COLS}-column tiles, model and FF widths by its "
            f"{BOX_ROWS}-row boxes and a compressor width by {EMIT_COLS}; got d={d}, g={g}, "
            f"L={L}, npf={npf}, Wc={Wc}, P={P}, hid={hid}, hid4={hid4}, dim={dim}, "
            f"vocab={vocab}")
    bf, f32 = torch.bfloat16, torch.float32
    for name, x, shape in (("kv", kvs, (b, kvh, max_len, 2 * d)),
                           ("ckv", ckvs, (b, kvh, Wc, 2 * d)),
                           ("ring", rings, (b, kvh, Bc, 2 * d))):
        for l, xl in enumerate(x):
            runtime.check(f"{name}[{l}]", xl, bf, shape)
    h = heads
    shapes = {
        "token_emb": (vocab, dim), "to_logits": (dim, vocab), "out_norm": (1, dim),
        "attn_norm": (L, 1, dim), "w_qkvg": (L, dim, P), "gate_b": (L, 1, 3 * h),
        "mem_kv": (L, 2, kvh, M, d), "pos_kv": (L, kvh, Bc, 2 * d), "b1k": (L, kvh, hid),
        "b1v": (L, kvh, hid), "b2c": (L, kvh, 2 * d), "w1k": (L, kvh, Bc * d, hid),
        "w1v": (L, kvh, Bc * d, hid), "w2c": (L, kvh, hid, 2 * d), "w_out": (L, h * d, dim),
        "ff_norm": (L, 1, dim), "fw1": (L, dim, hid4), "fb1": (L, 1, hid4),
        "fw2": (L, hid4, dim), "fb2": (L, 1, dim),
    }
    weights = [runtime.check(k, mp[k], f32 if k == "mem_kv" else bf, shapes[k])
               for k in ("token_emb", "to_logits", "out_norm", *LAYER_LEAVES)]
    if P != h * d + 2 * kvh * d + 3 * h:
        raise ValueError(f"w_qkvg has {P} columns, the heads need {h * d + 2 * kvh * d + 3 * h}")
    dev = kvs[0].device
    inv_freq = _inv_freq(d, float(theta), str(dev))
    tok_in = token.to(device=dev, dtype=torch.int32).contiguous()
    pos = runtime.device_position(t, kvs[0])
    logits = torch.empty((b, vocab), dtype=f32, device=dev)
    tokens = torch.empty((b, steps), dtype=torch.int32, device=dev)
    ints = [L, b, kvh, g, max_len, Wc, Bc, M, hid, dim, vocab, hid4, steps, int(greedy),
            stride, sel_block, num_sel, n_slide, window, INFO_WIDTH]
    check_plan("decode_step_mega", launch_plan(dev, ints[:12] + [1, 0] + ints[14:]))
    nchunks = hid // EMIT_COLS
    scratch = _scratch(dev, [
        (b * P, bf),                       # proj: the fused projection, rounded
        (L * b * h * d, bf), (L * b * h * d, bf),       # q and rq of every layer
        (L * b * h * 3, bf),               # gates of every layer
        (b * kvh * 2 * d, bf), (b * kvh * 2 * d, bf),   # the new row: unrotated, rotated
        (L * b * h * d, bf),               # c_out of every layer
        (L * b * kvh * INFO_WIDTH, torch.int32),        # info of every layer
        (kvh * nchunks * b * 2 * d, f32),  # the emission's partial sums
        (L * b * h * d, bf),               # comb: every layer's attention output, rounded
        (b * dim, bf), (b * dim, bf),      # x (the residual stream), y (x + attention)
        (b * hid4, bf),                    # the FF's hidden row
    ])
    ptrs = ([x.data_ptr() for x in (*kvs, *ckvs, *rings)] + weights
            + [inv_freq.data_ptr(), tok_in.data_ptr(), pos.data_ptr(), logits.data_ptr(),
               tokens.data_ptr()]
            + [x.data_ptr() for x in scratch])
    if phase_ns is not None:
        runtime.check("phase_ns", phase_ns, torch.int64, (None,))
        if phase_ns.numel() < phase_marks(L, steps) or phase_ns.device != dev:
            raise ValueError(f"phase_ns needs {phase_marks(L, steps)} int64 values on {dev}")
    ptrs.append(0 if phase_ns is None else phase_ns.data_ptr())
    with torch.cuda.device(dev):
        runtime.library().call(
            "nsa_decode_mega", (ctypes.c_void_p * len(ptrs))(*ptrs), len(ptrs),
            (ctypes.c_int * len(ints))(*ints), len(ints), scale, eps,
            runtime.stream_of(kvs[0]),
        )
    decode_step_mega.launches += 1
    if inspect is not None:
        inspect.update(q=scratch[1].view(L, b, kvh, g, d), rq=scratch[2].view(L, b, kvh, g, d),
                       gates=scratch[3].view(L, b, kvh, g, 3),
                       c_out=scratch[6].view(L, b, kvh, g, d),
                       info=scratch[7].view(L, b, kvh * INFO_WIDTH),
                       attn_out=scratch[9].view(L, b, kvh, g, d))
    if greedy:
        return logits, tokens, kv, ckv, ring
    return logits, kv, ckv, ring


decode_step_mega.launches = 0
