"""The emitted-row gate of the select-emit kernels and its control, on the
plain versions, and the refusals of the launch plans of the ragged
select-emit (row 8) and the whole-model decode kernel (row 12).

The kernels' emission (``csrc/decode_tc_common.cuh``) takes each 64-column
chunk of the compressor's hidden row as one work item: the chunk's share of
the emitted row is a float32 partial, and the partials are added in chunk
order, + b2, rounded to bf16.  The plain version takes one float32 product.
``chip_smoke.py`` holds the kernels' emitted rows to 2^-6 of the largest
value (TOL_FUSED) and requires the plain version with one hidden chunk left
out (``emission_plain(..., drop_chunk=c)``) to fail that gate.  Here, on
the CPU, in bf16: the plain emission summed in the kernels' chunk order
passes the gate, and the dropped-chunk control fails it.  Inputs come from
numpy seeds; no JAX.

Row 12's selection gate: ``chip_smoke.py`` feeds each layer's own query
and new row of the whole-model kernel (``inspect``) to
``layer_select_emit_plain`` and holds the kernel's selection to it with
``selection_faults`` (ids equal except ties), with ``with_next_ranked`` (a
selection one rank short) as the control that must fail.  Here: fed the
plain step's own inputs of each layer, ``layer_select_emit_plain`` gives
that step's selection, compressed output and emitted row bit for bit, the
gate passes it and fails the control, and a swap of two tied blocks passes.
"""

import numpy as np
import pytest
import torch

from nsa_tpu_torch import tiny_test_config
from nsa_tpu_torch.models.transformer import (_mega_kw, init_transformer, pack_mega_params,
                                              transformer_decode_step_mega)
from nsa_tpu_torch.ops.cuda import nsa_decode, nsa_decode_fused, nsa_decode_mega, nsa_decode_ragged
from nsa_tpu_torch.ops.cuda.nsa_decode import INFO_WIDTH, selection_faults, with_next_ranked
from nsa_tpu_torch.ops.cuda.nsa_decode_fused import EMIT_COLS, emission_plain
from nsa_tpu_torch.ops.nsa import _ckv_width

TOL = 2.0 ** -6             # chip_smoke.py's TOL_FUSED, of the largest value
OPTIN = 232448              # an H100's shared memory a block (227 KB)


def emission_case(seed, b=4, kvh=2, Bc=16, d=64, hid=256):
    """Seeded compressor weights at the reference model's scale and a
    shifted ring; t = 7 reaches before position 0, the others do not."""
    rng = np.random.default_rng(seed)

    def bf(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * scale) \
            .to(torch.bfloat16)

    def f32(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * scale)

    K = Bc * d
    shifted, pos_kv = bf(b, kvh, Bc, 2 * d), bf(kvh, Bc, 2 * d, scale=0.1)
    w1k, w1v = bf(kvh, K, hid, scale=K ** -0.5), bf(kvh, K, hid, scale=K ** -0.5)
    b1k, b1v = f32(kvh, hid, scale=0.1), f32(kvh, hid, scale=0.1)
    w2, b2 = bf(kvh, hid, 2 * d, scale=hid ** -0.5), f32(kvh, 2 * d, scale=0.1)
    t = torch.tensor([15, 7, 3999, 31][:b])
    return shifted, t, pos_kv, w1k, b1k, w1v, b1v, w2, b2


def emission_by_chunks(shifted, t, pos_kv, w1k, b1k, w1v, b1v, w2, b2):
    """The emission in the kernels' order: the hidden row rounded to bf16
    as the plain version rounds it, then each 64-column chunk's share of the
    emitted row in float32, the chunks added in order, + b2, rounded."""
    b, kvh, Bc, d2 = shifted.shape
    d = d2 // 2
    row_pos = torch.arange(Bc) + (t[:, None] + 1 - Bc)
    win = shifted.masked_fill((row_pos < 0).reshape(b, 1, Bc, 1), 0.0) + pos_kv[None]
    halves = []
    for half, (w1, b1) in enumerate(((w1k, b1k), (w1v, b1v))):
        x = win[..., half * d:(half + 1) * d].reshape(b, kvh, Bc * d).float()
        hid = torch.relu(torch.einsum("bhi,hio->bho", x, w1.float()) + b1[None]) \
            .to(torch.bfloat16).float()
        w = w2[..., half * d:(half + 1) * d].float()
        out = torch.zeros(b, kvh, d)
        for c in range(0, hid.shape[-1], EMIT_COLS):
            out = out + torch.einsum("bho,hoe->bhe", hid[..., c:c + EMIT_COLS],
                                     w[:, c:c + EMIT_COLS])
        halves.append((out + b2[None, :, half * d:(half + 1) * d]).to(torch.bfloat16))
    return torch.cat(halves, -1)


def gate(got, want):
    """(max |got - want|, the gate's bound: 2^-6 of the largest |want|)."""
    return (got.float() - want.float()).abs().max().item(), TOL * want.float().abs().max().item()


@pytest.mark.parametrize("seed,Bc,hid", [(0, 16, 256), (1, 16, 1024), (2, 4, 128)])
def test_emitted_row_gate_passes_the_kernels_chunk_order(seed, Bc, hid):
    args = emission_case(seed, Bc=Bc, hid=hid)
    want = emission_plain(*args, torch.bfloat16)
    err, bound = gate(emission_by_chunks(*args), want)
    assert err <= bound


@pytest.mark.parametrize("seed,Bc,hid", [(0, 16, 256), (1, 16, 1024), (2, 4, 128)])
def test_emitted_row_gate_fails_a_dropped_chunk(seed, Bc, hid):
    args = emission_case(seed, Bc=Bc, hid=hid)
    want = emission_plain(*args, torch.bfloat16)
    for chunk in (0, hid // EMIT_COLS - 1):
        err, bound = gate(emission_plain(*args, torch.bfloat16, drop_chunk=chunk), want)
        assert err > bound, (chunk, err, bound)


def test_dropped_chunk_reaches_the_ragged_plain_version(monkeypatch):
    """The control runs through ``decode_select_emit_ragged_plain`` by
    patching ``emission_plain``: only the emitting rows' slots change."""
    shifted, t, pos_kv, w1k, b1k, w1v, b1v, w2, b2 = emission_case(3)
    b, kvh, Bc, d2 = shifted.shape
    rng = np.random.default_rng(4)
    bf = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)) \
        .to(torch.bfloat16)
    q, ckv, kv_new = bf(b, kvh, 2, 64), bf(b, kvh, 520, d2), bf(b, kvh, 1, d2)
    mem_kv = bf(2, kvh, 1, 64)
    ring = torch.cat([bf(b, kvh, 1, d2), shifted[:, :, :-1]], 2)
    tv = torch.tensor([15, 7, 3998, 31], dtype=torch.int32)      # 3998 does not emit
    kw = dict(max_blocks=256, stride=8, sel_block=16, num_sel=4, n_slide=5, scale=0.125)
    outs = []
    for drop in (None, 0):
        if drop is not None:
            real = nsa_decode_fused.emission_plain
            monkeypatch.setattr(nsa_decode_ragged, "emission_plain",
                                lambda *a, **k: real(*a, drop_chunk=drop, **k))
        c, r = ckv.clone(), ring.clone()
        nsa_decode_ragged.decode_select_emit_ragged_plain(
            q, c, r, kv_new, mem_kv, pos_kv, w1k, b1k, w1v, b1v, w2, b2, tv, tv // 8, **kw)
        outs.append(c)
    emit = nsa_decode_ragged.ragged_emits(tv, tv // 8, 8)
    slot = (tv // 8).long()
    rows = torch.arange(b)
    err, bound = gate(outs[1][rows, :, slot][emit], outs[0][rows, :, slot][emit])
    assert err > bound
    assert torch.equal(outs[1][rows, :, slot][~emit], outs[0][rows, :, slot][~emit])


def test_emit_plan_refuses_a_window_that_does_not_fit():
    plan = nsa_decode_ragged.emit_plan(16, 4, 16, 1024, OPTIN)
    assert plan["fits"] and plan["blocks"] == 4 * 2 * 1024 // EMIT_COLS
    assert nsa_decode_ragged.check_plan("row 8", plan) is plan
    big = nsa_decode_ragged.emit_plan(16, 4, 128, 1024, OPTIN)    # a 16 x 8192 window tile
    assert not big["fits"] and big["smem_bytes"] > OPTIN
    with pytest.raises(ValueError, match="shared memory"):
        nsa_decode_ragged.check_plan("row 8", big)


REFERENCE = dict(kvh=4, g=2, dim=512, hid4=2048, vocab=256, Wc=520, M=1, Bc=16, sel_block=16,
                 stride=8, num_sel=4, n_slide=5, grid=132, smem_optin=OPTIN)


def test_mega_plan_reads_every_weight_tile_once_and_fits():
    plan = nsa_decode_mega.mega_plan(**REFERENCE)
    kvh, g, dim, hid4, vocab = 4, 2, 512, 2048, 256
    P = kvh * g * 64 + 2 * kvh * 64 + 3 * kvh * g
    weights = dim * P + kvh * g * 64 * dim + 2 * dim * hid4 + dim * vocab
    assert plan["slice_total"] == 2 * weights
    assert plan["fits"] and plan["smem_bytes"] + nsa_decode_ragged.STATIC_SMEM <= OPTIN
    assert plan["slice_bytes"] >= plan["slice_total"] / plan["grid"]


@pytest.mark.parametrize("change", [dict(hid4=16384), dict(grid=16), dict(smem_optin=100_000)])
def test_mega_plan_refuses_what_does_not_fit(change):
    plan = nsa_decode_mega.mega_plan(**{**REFERENCE, **change})
    assert not plan["fits"]
    with pytest.raises(ValueError, match="shared memory"):
        nsa_decode_ragged.check_plan("decode_step_mega", plan)


SEL_KEYS = ("stride", "sel_block", "num_sel", "n_slide", "scale")


@pytest.mark.parametrize("seed,t", [(0, 41), (1, 40)])       # 41 emits (stride 2), 40 not
def test_layer_select_emit_plain_gives_the_plain_steps_own(monkeypatch, seed, t):
    """Two layers of the tiny model, seeded caches of 64 rows, b = 3: each
    layer's selection, compressed output and ckv after the step, from the
    step's own query and new row, bit for bit; the selection gate passes
    it and fails the selection one rank short."""
    cfg = tiny_test_config()
    mp = pack_mega_params(init_transformer(cfg, torch.Generator().manual_seed(seed),
                                           device="cpu"), cfg)
    kw = _mega_kw(cfg)
    nsa, L, b, kvh, d, max_len = cfg.nsa, cfg.depth, 3, cfg.kv_heads, cfg.dim_head, 64
    Wc = _ckv_width(max_len, nsa.compress_block_sliding_stride, nsa.num_compress_per_fine)
    rng = np.random.default_rng(seed)
    kv, ckv, ring = (torch.from_numpy(rng.standard_normal((L, b, kvh, n, 2 * d))
                                      .astype(np.float32))
                     for n in (max_len, Wc, nsa.compress_block_size))
    token = torch.from_numpy(rng.integers(0, cfg.vocab_size, b))
    seen, real = [], nsa_decode_mega.decode_select_emit_plain

    def recording(q, ckv_l, ring_l, kv_new, *a, **k):
        out = real(q, ckv_l, ring_l, kv_new, *a, **k)
        seen.append((q.clone(), kv_new.clone(), *out))
        return out

    monkeypatch.setattr(nsa_decode_mega, "decode_select_emit_plain", recording)
    after = [x.clone() for x in (kv, ckv, ring)]
    transformer_decode_step_mega(mp, cfg, token, *after, t, use_kernels=False)
    monkeypatch.undo()
    assert len(seen) == L
    sel = {k: kw[k] for k in SEL_KEYS}
    for l, (q, kv_new, c_step, info_step) in enumerate(seen):
        c_out, info, ckv_l, scores = nsa_decode_mega.layer_select_emit_plain(
            mp, l, q, ckv[l], ring[l], kv_new, t, max_len=max_len, **sel)
        info_step = info_step.reshape(b, kvh, INFO_WIDTH)
        assert torch.equal(c_out, c_step) and torch.equal(info, info_step)
        assert torch.equal(ckv_l, after[1][l])
        gate = dict(num_sel=kw["num_sel"], n_slide=kw["n_slide"], tie=1e-6)
        assert selection_faults(info, info_step, scores, **gate) == ([], 0)
        faults, _ = selection_faults(with_next_ranked(info, scores, kw["num_sel"]), info_step,
                                     scores, **gate)
        assert faults, l


def test_selection_gate_lets_tied_blocks_swap():
    """Blocks 1 and 3 tie: picking 3 for 1 is no fault (one row differs by
    a tie); picking 2 for 1 is one."""
    num_sel, n_slide = 2, 1
    scores = torch.tensor([[[0.1, 0.5, 0.2, 0.5, 0.9]]])
    info = torch.zeros(1, 1, INFO_WIDTH, dtype=torch.int32)
    info[..., :3] = torch.tensor([4, 1, 4])
    info[..., 3:5] = 1
    tied, wrong = info.clone(), info.clone()
    tied[..., 1], wrong[..., 1] = 3, 2
    gate = dict(num_sel=num_sel, n_slide=n_slide, tie=1e-6)
    assert selection_faults(tied, info, scores, **gate) == ([], 1)
    assert selection_faults(wrong, info, scores, **gate)[0]
    assert torch.equal(with_next_ranked(info, scores, num_sel)[..., :2],
                       torch.tensor([[[4, 3]]], dtype=torch.int32))
