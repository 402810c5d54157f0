"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: they need an NVIDIA GPU with the CUDA toolkit (``nvcc``)
and skip elsewhere; whether a card exists is decided inside the fixture, so
every worker collects the same tests.  This file imports neither JAX nor
nsa_tpu (the card's machine has neither).  Run there with

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda_kernels.py

(``--noconftest`` because tests/conftest.py configures JAX.)

Shapes are small but keep the kernels' dim_head of 64.  Tolerances are
stated in bf16: the plain decode versions round softmax weights and outputs
to bf16 (unit roundoff 2^-9) where the kernels keep float32, so outputs
agree to 0.03 absolute on values of order 1-5; log-sum-exps are float32
both ways (1e-3).  The prefill forward kernel rounds its softmax weights to
bf16 for P.V where its plain version keeps them float32, and both round the
outputs once: element by element, 2^-7 of the plain output plus 2^-8 of
the same branch's attention over |v|
(``nsa_prefill.fine_sliding_tolerance``: each term twice its source).  The
backward kernels round P to bf16 for dV = P^T.dO and keep dS as a bf16
pair for dQ and dK, where the plain versions keep float32: dq, dk, dv
element by element within 2^-7 of the plain value plus 2^-8 of the same
sum over absolute values (``nsa_prefill.prefill_bwd_tolerance``), with a
dropped-block control that must fail; d_gates and the deltas stay float32
(1e-4 of the largest value: sum order and exp2).  The fused decode kernels and their
plain versions round at the same points (the emitted ckv row, the combined
attention output, the layer's y, the FF's hidden row and output) from
float32 sums taken in another order, so a rounding can flip by one ulp and
carry one more ulp downstream: 2^-6 of the largest value (two bf16 ulps);
the ring shift and the kv row write are copies, bit-equal.  The ragged
and paged decode kernels are held to the same 2^-6; the paged attend
kernel equals the ragged one bit for bit on the same logical cache, and
the block gather is a copy.  The attend kernels' rounded attention output
is held element by element (``nsa_decode_ragged.attend_tolerance``: 2^-7
of |plain| for its two bf16 roundings plus 2^-15 of the same combine over
absolute values for float32 sums in another order), with a control that
leaves each row's first selected block out and must fail; the split
route's select kernel's c_out is held the same way
(``nsa_decode_ragged.select_tolerance``: 2^-7 of |plain| plus 2^-15 of the
same softmax's sum over |v|), with a control that leaves the first 64
live rows out.  The flash
attention kernel rounds its softmax weights to bf16 for the P.V product,
where its plain version keeps them float32, and both round the output
once: element by element, 2^-7 of the plain output plus 2^-8 of the same
attention over |v|
(``flash.flash_attention_tolerance``: each term twice its source).
The decode loops captured as CUDA graphs (``models/decode_graph.py``) run
the same kernels and ops as their eager steps, in the same order: tokens,
caches, logits and launch counts are held to the eager steps' bit for bit.
"""

import dataclasses
import gc

import numpy as np
import pytest
import torch

from nsa_tpu_torch import reference_model_config, serve
from nsa_tpu_torch.eval.efficiency import clone_cache, copy_cache
from nsa_tpu_torch.models import decode_graph
from nsa_tpu_torch.models.transformer import (
    _sample_from_logits,
    fuse_decode_params,
    greedy_decode,
    init_transformer,
    sample_decode,
    stack_decode_caches,
    transformer_decode_step,
    transformer_decode_step_mega,
    transformer_forward,
    transformer_loss,
    transformer_prefill,
)
from nsa_tpu_torch.models.transformer import transformer_decode_step_ragged
from nsa_tpu_torch.ops.cuda import (
    flash,
    nsa_decode,
    nsa_decode_fused,
    nsa_decode_mega,
    nsa_decode_ragged,
    nsa_prefill,
    paged_gather,
)
from nsa_tpu_torch.ops import nsa as nsa_layer
from nsa_tpu_torch.ops.nsa import _ckv_width
from nsa_tpu_torch.train.pretrain import trainable
from nsa_tpu_torch.utils.checkpoint import tree_leaves, tree_to

pytestmark = pytest.mark.gpu

TOL_OUT, TOL_LSE = 0.03, 1e-3


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.Generator(device="cuda").manual_seed(0)


def randn(gen, *shape):
    return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)


def max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


def check_prefill_kernel(rq, rk, v, sel_idx, sel_mask, Bs, window, scale=0.125):
    """One launch of the forward kernel against its plain version: both
    outputs within ``fine_sliding_tolerance`` element by element, both
    log-sum-exps within TOL_LSE."""
    args = (rq, rk, v, sel_idx, sel_mask, Bs, window, scale)
    before = nsa_prefill.prefill_fwd.launches
    got = nsa_prefill.prefill_fwd(*args)
    want = nsa_prefill.fine_sliding_plain(*args)
    torch.cuda.synchronize()
    assert nsa_prefill.prefill_fwd.launches == before + 1
    tols = nsa_prefill.fine_sliding_tolerance(*args, want)
    for x, y, tol in zip(got[:2], want[:2], tols):
        assert x.dtype == torch.bfloat16 and torch.isfinite(x.float()).all()
        assert ((x.float() - y.float()).abs() <= tol).all()
    assert max_err(got[2], want[2]) <= TOL_LSE and max_err(got[3], want[3]) <= TOL_LSE


@pytest.mark.parametrize("G,n,S", [(2, 300, 4), (1, 77, 2), (4, 130, 16)])
def test_prefill_kernel_matches_plain(gen, G, n, S):
    b, kvh, d, Bs, window = 2, 2, 64, 16, 64
    rq, rk, v = randn(gen, b, kvh * G, n, d), randn(gen, b, kvh, n, d), randn(gen, b, kvh, n, d)
    W = -(-n // Bs)
    sel_idx = torch.randint(0, W, (b, kvh, n, S), generator=gen, device="cuda",
                            dtype=torch.int32)
    sel_mask = torch.rand((b, kvh, n, S), generator=gen, device="cuda") < 0.7
    check_prefill_kernel(rq, rk, v, sel_idx, sel_mask, Bs, window)


def selections(gen, pattern, b, kvh, n, S, Bs):
    """Selections from the whole range (future blocks, the row's own block,
    duplicates, invalid slots) at random, shared by each 16-row group (the
    fewest union blocks), spread so no two rows of a tile share a block (the
    most), or blocks 0 .. S-1 for every row (a sink: the longest lists of
    rows per block)."""
    W = -(-n // Bs)
    shape = (b, kvh, n, S)
    if pattern == "shared":
        sel_idx = torch.randint(0, W, (b, kvh, -(-n // 16), S), generator=gen, device="cuda",
                                dtype=torch.int32).repeat_interleave(16, dim=2)[:, :, :n].contiguous()
        sel_mask = torch.ones(shape, dtype=torch.bool, device="cuda")
    elif pattern == "distinct":
        rows = torch.arange(n, device="cuda")[:, None]
        slots = torch.arange(S, device="cuda")[None, :]
        sel_idx = ((rows * S + slots) % W).to(torch.int32).expand(shape).contiguous()
        sel_mask = torch.ones(shape, dtype=torch.bool, device="cuda")
    elif pattern == "sink":
        sel_idx = torch.arange(S, dtype=torch.int32, device="cuda").expand(shape).contiguous()
        sel_mask = torch.ones(shape, dtype=torch.bool, device="cuda")
    else:
        sel_idx = torch.randint(0, W, shape, generator=gen, device="cuda", dtype=torch.int32)
        sel_mask = torch.rand(shape, generator=gen, device="cuda") < 0.7
    return sel_idx, sel_mask


@pytest.mark.parametrize("pattern,G,n,S,Bs,window", [
    ("shared", 2, 300, 4, 16, 64),       # every row of a 16-row block selects the same blocks
    ("distinct", 2, 300, 4, 16, 64),     # every row selects other blocks than its neighbours
    ("random", 8, 200, 16, 16, 64),      # the widest tile: 16 rows x 8 heads, 16 slots
    ("random", 2, 120, 2, 4, 8),         # the tiny config's blocks: 4 to a 16-key sub-tile
    ("random", 2, 77, 4, 16, 64),
    ("random", 2, 3900, 4, 16, 64),
    ("random", 1, 150, 3, 24, 20),       # a block size that is no divisor of 16
])
def test_prefill_kernel_selection_patterns_match_plain(gen, pattern, G, n, S, Bs, window):
    b, kvh, d = 2, 2, 64
    rq, rk, v = randn(gen, b, kvh * G, n, d), randn(gen, b, kvh, n, d), randn(gen, b, kvh, n, d)
    check_prefill_kernel(rq, rk, v, *selections(gen, pattern, b, kvh, n, S, Bs), Bs, window)


def check_prefill_backward(gen, rq, rk, v, sel_idx, sel_mask, Bs, window, scale=0.125):
    """Both backward kernels against their plain versions on the forward
    kernel's outputs and seeded cotangents: dq, dk, dv element by element
    within ``prefill_bwd_tolerance``, d_gates and the deltas within 1e-4 of
    their largest value; the plain backward with each row's first selected
    block left out fails the rule on dq and on dk or dv; a second launch of
    each kernel is bit-equal; each call counts one launch."""
    sel = (rq, rk, v, sel_idx, sel_mask)
    fo, so, flse, slse = nsa_prefill.prefill_fwd(*sel, Bs, window, scale)
    dfo, dso = randn(gen, *fo.shape), randn(gen, *so.shape)
    dq_args = (*sel, fo, so, flse, slse, dfo, dso, Bs, window, scale)
    before = (nsa_prefill.prefill_bwd_dq.launches, nsa_prefill.prefill_bwd_dkv.launches)
    got_q = nsa_prefill.prefill_bwd_dq(*dq_args)
    want_q = nsa_prefill.prefill_bwd_dq_plain(*dq_args)
    # the dkv kernel and its plain version read the same (plain) deltas
    terms = (flse, slse, want_q[2], want_q[3], dfo, dso)
    dkv_args = (*sel, *terms, Bs, window, scale)
    got_kv = nsa_prefill.prefill_bwd_dkv(*dkv_args)
    want_kv = nsa_prefill.prefill_bwd_dkv_plain(*dkv_args)
    assert (nsa_prefill.prefill_bwd_dq.launches,
            nsa_prefill.prefill_bwd_dkv.launches) == (before[0] + 1, before[1] + 1)
    again_q = nsa_prefill.prefill_bwd_dq(*dq_args)
    again_kv = nsa_prefill.prefill_bwd_dkv(*dkv_args)
    torch.cuda.synchronize()
    assert (nsa_prefill.prefill_bwd_dq.launches,
            nsa_prefill.prefill_bwd_dkv.launches) == (before[0] + 2, before[1] + 2)
    want = (want_q[0], *want_kv)
    tols = nsa_prefill.prefill_bwd_tolerance(*sel, *terms, Bs, window, scale, want)
    for x, y, tol in zip((got_q[0], *got_kv), want, tols):
        assert x.dtype == torch.bfloat16 and torch.isfinite(x.float()).all()
        assert ((x.float() - y.float()).abs() <= tol).all()
    for x, y in zip(got_q[1:], want_q[1:]):
        assert max_err(x, y) <= 1e-4 * y.float().abs().max().item()
    assert all(torch.equal(x, y) for x, y in zip((*got_q, *got_kv), (*again_q, *again_kv)))
    dropped = nsa_prefill.without_first_block(sel_idx, sel_mask, Bs)
    assert bool((dropped != sel_mask).any())
    wrong = (nsa_prefill.prefill_bwd_dq_plain(rq, rk, v, sel_idx, dropped, *dq_args[5:])[0],
             *nsa_prefill.prefill_bwd_dkv_plain(rq, rk, v, sel_idx, dropped, *dkv_args[5:]))
    r = [((x.float() - y.float()).abs() / t).max().item() for x, y, t in zip(wrong, want, tols)]
    assert r[0] > 1.0 and max(r[1:]) > 1.0


@pytest.mark.parametrize("G,n,S", [(2, 300, 4), (1, 77, 2), (4, 130, 16), (8, 64, 3)])
def test_prefill_backward_kernels_match_plain(gen, G, n, S):
    """Random selections with duplicates, own-block and future slots."""
    b, kvh, d, Bs, window = 2, 2, 64, 16, 64
    rq, rk, v = randn(gen, b, kvh * G, n, d), randn(gen, b, kvh, n, d), randn(gen, b, kvh, n, d)
    sel_idx = torch.randint(0, -(-n // Bs), (b, kvh, n, S), generator=gen, device="cuda",
                            dtype=torch.int32)
    sel_mask = torch.rand((b, kvh, n, S), generator=gen, device="cuda") < 0.7
    check_prefill_backward(gen, rq, rk, v, sel_idx, sel_mask, Bs, window)


@pytest.mark.parametrize("pattern,G,n,S,Bs,window", [
    ("shared", 2, 300, 4, 16, 64),
    ("distinct", 2, 300, 4, 16, 64),
    ("sink", 2, 1200, 4, 16, 64),        # lists of ~1200 rows: key tiles split over work items
    ("random", 8, 200, 16, 16, 64),      # 2 rows x 8 heads a row tile, 16 slots
    ("random", 2, 120, 2, 4, 8),         # the tiny config's blocks: 4 to a key tile
    ("random", 1, 150, 3, 24, 20),       # own-block rows past the band; tiles over two blocks
    ("random", 2, 77, 4, 16, 64),
    ("random", 2, 4096, 4, 16, 64),
])
def test_prefill_backward_selection_patterns_match_plain(gen, pattern, G, n, S, Bs, window):
    b, kvh, d = 2, 2, 64
    rq, rk, v = randn(gen, b, kvh * G, n, d), randn(gen, b, kvh, n, d), randn(gen, b, kvh, n, d)
    check_prefill_backward(gen, rq, rk, v, *selections(gen, pattern, b, kvh, n, S, Bs), Bs,
                           window)


def test_model_loss_grads_kernels_match_plain(gen, monkeypatch):
    """Two layers at the reference widths, random float32 weights from a
    seed, bf16 compute: the loss and every gradient through the kernels
    against the plain path, and against the kernel forward with the plain
    backward; relative L2 per tensor with chip_smoke.py's tolerances and
    reasons (0.1 and 0.05)."""
    cfg = reference_model_config().replace(depth=2, dtype="bfloat16")
    params = trainable(init_transformer(cfg, torch.Generator().manual_seed(0), device="cpu"),
                       "cuda")
    ids = torch.randint(0, 256, (2, 513), generator=gen, device="cuda")

    def loss_and_grads(use_kernels):
        loss = transformer_loss(params, cfg, ids, use_kernels=use_kernels)
        return loss.item(), torch.autograd.grad(loss, tree_leaves(params))

    lk, gk = loss_and_grads(True)
    lp, gp = loss_and_grads(False)
    monkeypatch.setattr(nsa_prefill, "prefill_bwd_dq", nsa_prefill.prefill_bwd_dq_plain)
    monkeypatch.setattr(nsa_prefill, "prefill_bwd_dkv", nsa_prefill.prefill_bwd_dkv_plain)
    _, gh = loss_and_grads(True)
    assert abs(lk - lp) <= 2e-3 * abs(lp)
    for a, b, c in zip(gk, gp, gh):
        assert torch.isfinite(a).all()
        assert (a - b).norm() <= 0.1 * b.norm() + 1e-12
        assert (a - c).norm() <= 0.05 * c.norm() + 1e-12


@pytest.mark.parametrize("t", [0, 9, 200, 1023])
def test_decode_kernels_match_plain(gen, t):
    b, kvh, g, d, M = 3, 2, 2, 64, 1
    stride, Bs, window, num_sel, max_len = 8, 16, 64, 4, 1024
    n_slide = -(-window // Bs) + 1
    Wc = _ckv_width(max_len, stride, Bs // stride)
    q, ckv, mem_kv = randn(gen, b, kvh, g, d), randn(gen, b, kvh, Wc, 2 * d), randn(gen, 2, kvh, M, d)
    kw = dict(max_blocks=max_len // Bs, stride=stride, sel_block=Bs, num_sel=num_sel,
              n_slide=n_slide, scale=0.125)
    num_cb = t // stride
    c_k, info_k = nsa_decode.decode_select(q, ckv, mem_kv, t, num_cb, **kw)
    c_2, info_2 = nsa_decode.decode_select(q, ckv, mem_kv, t, num_cb, **kw)
    c_p, info_p = nsa_decode.decode_select_plain(q, ckv, mem_kv, t, num_cb, **kw)
    skw = dict(stride=stride, sel_block=Bs, scale=0.125)
    want, tol = nsa_decode_ragged.select_tolerance(q, ckv, mem_kv, t, num_cb, **skw)
    moved, live = nsa_decode_ragged.without_live_chunk(ckv, num_cb)
    wrong, _ = nsa_decode.select_scores_plain(q, moved, mem_kv, live, t,
                                              weights_dtype=torch.float32, **skw)
    torch.cuda.synchronize()
    assert max_err(c_k, c_p) <= TOL_OUT
    assert torch.equal(info_k, info_p)   # random scores: no ties
    assert ((c_k.float() - want.float()).abs() <= tol).all()
    if num_cb:                           # the control: the first 64 live rows left out
        assert ((wrong.float() - want.float()).abs() > tol).any()
    assert torch.equal(c_2, c_k) and torch.equal(info_2, info_k)

    rq, kv = randn(gen, b, kvh, g, d), randn(gen, b, kvh, max_len, 2 * d)
    gates = torch.rand((b, kvh, g, 3), generator=gen, device="cuda").to(torch.bfloat16)
    akw = dict(sel_block=Bs, window=window, num_sel=num_sel, n_slide=n_slide, scale=0.125)
    out_k = nsa_decode.decode_attend(rq, kv, info_p, c_p, gates, t, **akw)
    out_2 = nsa_decode.decode_attend(rq, kv, info_p, c_p, gates, t, **akw)
    out_p = nsa_decode.decode_attend_plain(rq, kv, info_p, c_p, gates, t, **akw)
    want, tol = nsa_decode_ragged.attend_tolerance(rq, kv, info_p, c_p, gates, t, **akw)
    dropped = nsa_decode_ragged.without_first_selected(info_p, num_sel, n_slide)
    wrong, _ = nsa_decode_ragged.attend_tolerance(rq, kv, dropped, c_p, gates, t, **akw)
    torch.cuda.synchronize()
    assert max_err(out_k, out_p) <= TOL_OUT
    assert ((out_k.float() - want.float()).abs() <= tol).all()
    if info_p[..., num_sel + n_slide:2 * num_sel + n_slide].any():   # the control
        assert ((wrong.float() - want.float()).abs() > tol).any()
    assert torch.equal(out_2, out_k)


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    q = randn(gen, 2, 2, 2, 32)          # dim_head 32
    ckv = randn(gen, 2, 2, 40, 64)
    mem = randn(gen, 2, 2, 1, 32)
    with pytest.raises(ValueError):
        nsa_decode.decode_select(q, ckv, mem, 5, 0, max_blocks=8, stride=8, sel_block=16,
                                 num_sel=4, n_slide=5, scale=0.1)
    with pytest.raises(ValueError):   # a mix of devices
        nsa_decode.decode_select(q.cpu(), ckv, mem, 5, 0, max_blocks=8, stride=8,
                                 sel_block=16, num_sel=4, n_slide=5, scale=0.1)


def test_model_decode_step_kernels_match_plain(gen):
    """Two layers at the reference widths, random weights from a seed, on
    the split route (bs 4 would take the fused route by default)."""
    cfg = reference_model_config().replace(depth=2, dtype="bfloat16")
    params = tree_to(init_transformer(cfg, torch.Generator().manual_seed(0), device="cuda"),
                     dtype=torch.bfloat16)
    ids = torch.randint(0, 256, (4, 200), generator=gen, device="cuda")
    with torch.inference_mode():
        logits, cache = transformer_prefill(params, cfg, ids, 256)
        token = logits[:, -1].argmax(-1)
        plain = clone_cache(cache)
        got, _ = transformer_decode_step(params, cfg, token, cache, route="split")
        want, _ = transformer_decode_step(params, cfg, token, plain, use_kernels=False,
                                          route="split")
    assert torch.isfinite(got).all()
    assert max_err(got, want) <= 0.02 * max(want.abs().max().item(), 1.0)


TOL_FUSED = 2.0 ** -6


def fused_weights(gen, kvh, Bc, d, hid):
    """Packed compressor weights at trained-like scales (fan-in uniform)."""
    def uni(*shape, fan_in):
        return ((torch.rand(shape, generator=gen, device="cuda") * 2 - 1) * fan_in ** -0.5)

    return (randn(gen, kvh, Bc, 2 * d) * 0.1,
            uni(kvh, Bc * d, hid, fan_in=Bc * d).to(torch.bfloat16), uni(kvh, hid, fan_in=Bc * d),
            uni(kvh, Bc * d, hid, fan_in=Bc * d).to(torch.bfloat16), uni(kvh, hid, fan_in=Bc * d),
            uni(kvh, hid, 2 * d, fan_in=hid).to(torch.bfloat16), uni(kvh, 2 * d, fan_in=hid))


@pytest.mark.parametrize("t", [7, 199, 200, 1023])
def test_decode_select_emit_kernel_matches_plain(gen, t, monkeypatch):
    """t = 7 and 199 emit (stride 8), t = 7 over a window that starts
    before position 0; t = 200 and 1023 do not.  The emitted row within
    2^-6 of its largest value, where the plain version with one hidden
    chunk left out must fail; a second launch bit for bit the first."""
    b, kvh, g, d, M, Bc, hid = 3, 2, 2, 64, 1, 16, 128
    stride, Bs, window, num_sel, max_len = 8, 16, 64, 4, 1024
    n_slide = -(-window // Bs) + 1
    Wc = _ckv_width(max_len, stride, Bs // stride)
    q, ckv, mem_kv = randn(gen, b, kvh, g, d), randn(gen, b, kvh, Wc, 2 * d), randn(gen, 2, kvh, M, d)
    ring, kv_new = randn(gen, b, kvh, Bc, 2 * d), randn(gen, b, kvh, 1, 2 * d)
    weights = fused_weights(gen, kvh, Bc, d, hid)
    kw = dict(max_blocks=max_len // Bs, stride=stride, sel_block=Bs, num_sel=num_sel,
              n_slide=n_slide, scale=0.125)
    caches = [(ckv.clone(), ring.clone()) for _ in range(4)]
    before = nsa_decode_fused.decode_select_emit.launches
    c_k, info_k = nsa_decode_fused.decode_select_emit(q, caches[0][0], caches[0][1], kv_new,
                                                      mem_kv, *weights, t, t // stride, **kw)
    c_2, info_2 = nsa_decode_fused.decode_select_emit(q, caches[2][0], caches[2][1], kv_new,
                                                      mem_kv, *weights, t, t // stride, **kw)
    c_p, info_p = nsa_decode_fused.decode_select_emit_plain(
        q, caches[1][0], caches[1][1], kv_new, mem_kv, *weights, t, t // stride, **kw)
    real = nsa_decode_fused.emission_plain      # the control: one hidden chunk left out
    monkeypatch.setattr(nsa_decode_fused, "emission_plain",
                        lambda *a, **k: real(*a, drop_chunk=0, **k))
    nsa_decode_fused.decode_select_emit_plain(q, caches[3][0], caches[3][1], kv_new, mem_kv,
                                              *weights, t, t // stride, **kw)
    torch.cuda.synchronize()
    assert nsa_decode_fused.decode_select_emit.launches == before + 2
    assert max_err(c_k, c_p) <= TOL_OUT
    assert torch.equal(info_k, info_p)   # random scores: no ties
    assert torch.equal(caches[0][1], caches[1][1])
    assert torch.equal(caches[0][1][:, :, -1:], kv_new)
    assert torch.equal(c_2, c_k) and torch.equal(info_2, info_k)
    assert torch.equal(caches[2][0], caches[0][0]) and torch.equal(caches[2][1], caches[0][1])
    slot = t // stride
    for ckv_k in (caches[0][0], caches[1][0]):     # no other row changes
        assert torch.equal(torch.cat([ckv_k[:, :, :slot], ckv_k[:, :, slot + 1:]], 2),
                           torch.cat([ckv[:, :, :slot], ckv[:, :, slot + 1:]], 2))
    row_k, row_p = caches[0][0][:, :, slot], caches[1][0][:, :, slot]
    if (t + 1) % stride:
        assert torch.equal(row_k, ckv[:, :, slot]) and torch.equal(row_p, ckv[:, :, slot])
    else:
        assert not torch.equal(row_p, ckv[:, :, slot])
        bound = TOL_FUSED * row_p.float().abs().max().item()
        assert max_err(row_k, row_p) <= bound
        assert max_err(caches[3][0][:, :, slot], row_p) > bound


def attend_fused_inputs(gen, t, b, with_ff, kvh=2, g=2, dim=256, hid4=512, max_len=1024):
    """Inputs of the one-position attend at b rows: info and c_out from the
    plain select at t, seeded activations and weights."""
    d, stride, Bs, window, num_sel = 64, 8, 16, 64, 4
    n_slide = -(-window // Bs) + 1
    Wc = _ckv_width(max_len, stride, Bs // stride)
    q, ckv, mem_kv = randn(gen, b, kvh, g, d), randn(gen, b, kvh, Wc, 2 * d), randn(gen, 2, kvh, 1, d)
    skw = dict(max_blocks=max_len // Bs, stride=stride, sel_block=Bs, num_sel=num_sel,
               n_slide=n_slide, scale=0.125)
    c_out, info = nsa_decode.decode_select_plain(q, ckv, mem_kv, t, t // stride, **skw)
    info = info.reshape(b, -1)
    rq, kv, kv_new = randn(gen, b, kvh, g, d), randn(gen, b, kvh, max_len, 2 * d), \
        randn(gen, b, kvh, 1, 2 * d)
    gates = torch.rand((b, kvh, g, 3), generator=gen, device="cuda").to(torch.bfloat16)
    x = randn(gen, b, 1, dim)
    w_out = (randn(gen, kvh * g * d, dim) * (kvh * g * d) ** -0.5).to(torch.bfloat16)
    ff = ()
    if with_ff:
        ff = (1.0 + 0.1 * torch.randn(dim, generator=gen, device="cuda"),
              (randn(gen, dim, hid4) * dim ** -0.5).to(torch.bfloat16),
              0.1 * torch.randn(hid4, generator=gen, device="cuda"),
              (randn(gen, hid4, dim) * hid4 ** -0.5).to(torch.bfloat16),
              0.1 * torch.randn(dim, generator=gen, device="cuda"))
    akw = dict(sel_block=Bs, window=window, num_sel=num_sel, n_slide=n_slide, scale=0.125)
    return rq, kv, (kv_new, info, c_out, gates, x, w_out), ff, akw


@pytest.mark.parametrize("with_ff", [True, False])
@pytest.mark.parametrize("t,b", [(0, 1), (200, 3), (1023, 9)])
def test_decode_attend_fused_kernel_matches_plain(gen, t, b, with_ff):
    """The output within 2^-6 of its largest value; the rounded attention
    output (``attn_out``) within ``attend_tolerance`` element by element,
    where each row's first selected block left out must fail (where a row
    has one); a second launch bit for bit the first."""
    rq, kv, args, ff, akw = attend_fused_inputs(gen, t, b, with_ff)
    kv_new, info, c_out, gates = args[:4]
    kv_k, kv_p, kv_2 = kv.clone(), kv.clone(), kv.clone()
    comb, comb_2 = torch.empty_like(rq), torch.empty_like(rq)
    before = nsa_decode_fused.decode_attend_fused.launches
    out_k = nsa_decode_fused.decode_attend_fused(rq, kv_k, *args, t, ff, attn_out=comb, **akw)
    out_2 = nsa_decode_fused.decode_attend_fused(rq, kv_2, *args, t, ff, attn_out=comb_2, **akw)
    out_p = nsa_decode_fused.decode_attend_fused_plain(rq, kv_p, *args, t, ff, **akw)
    torch.cuda.synchronize()
    assert nsa_decode_fused.decode_attend_fused.launches == before + 2
    assert out_k.shape == (b, 1, args[4].shape[-1]) and torch.isfinite(out_k.float()).all()
    assert max_err(out_k, out_p) <= TOL_FUSED * out_p.float().abs().max().item()
    assert torch.equal(kv_k, kv_p) and torch.equal(kv_k[:, :, t], kv_new[:, :, 0])
    assert torch.equal(torch.cat([kv_k[:, :, :t], kv_k[:, :, t + 1:]], 2),
                       torch.cat([kv[:, :, :t], kv[:, :, t + 1:]], 2))
    assert torch.equal(out_2, out_k) and torch.equal(comb_2, comb) and torch.equal(kv_2, kv_k)
    want, tol = nsa_decode_ragged.attend_tolerance(rq, kv_p, info, c_out, gates, t, **akw)
    assert ((comb.float() - want.float()).abs() <= tol).all()
    dropped = nsa_decode_ragged.without_first_selected(info, akw["num_sel"], akw["n_slide"])
    if bool((dropped != info).any()):
        wrong, _ = nsa_decode_ragged.attend_tolerance(rq, kv_p, dropped, c_out, gates, t, **akw)
        assert not ((wrong.float() - want.float()).abs() <= tol).all()


@pytest.mark.parametrize("with_ff", [True, False])
@pytest.mark.parametrize("t", [199, 200])
def test_fused_pair_is_the_ragged_pair_at_one_position(gen, t, with_ff):
    """Rows 6-7 and rows 8-9 with every row at t (199 emits, 200 does not)
    give the same bits: c_out, info, ckv, ring, the output, the rounded
    attention output and the kv cache."""
    b, kvh, g, d, M, Bc, hid = 5, 2, 2, 64, 1, 16, 1024
    stride, Bs, window, num_sel, max_len = 8, 16, 64, 4, 1024
    n_slide = -(-window // Bs) + 1
    Wc = _ckv_width(max_len, stride, Bs // stride)
    q, ckv, mem_kv = randn(gen, b, kvh, g, d), randn(gen, b, kvh, Wc, 2 * d), randn(gen, 2, kvh, M, d)
    ring, kv_new = randn(gen, b, kvh, Bc, 2 * d), randn(gen, b, kvh, 1, 2 * d)
    weights = fused_weights(gen, kvh, Bc, d, hid)
    kw = dict(max_blocks=max_len // Bs, stride=stride, sel_block=Bs, num_sel=num_sel,
              n_slide=n_slide, scale=0.125)
    tv = torch.full((b,), t, dtype=torch.int32, device="cuda")
    rq, kv, args, ff, akw = attend_fused_inputs(gen, t, b, with_ff)
    runs = []
    for ragged in (False, True):
        c, r, kv_x, comb = ckv.clone(), ring.clone(), kv.clone(), torch.empty_like(rq)
        if ragged:
            sel = nsa_decode_ragged.decode_select_emit_ragged(q, c, r, kv_new, mem_kv, *weights,
                                                              tv, tv // stride, **kw)
            out = nsa_decode_ragged.decode_attend_fused_ragged(rq, kv_x, *args, tv, ff,
                                                               attn_out=comb, **akw)
        else:
            sel = nsa_decode_fused.decode_select_emit(q, c, r, kv_new, mem_kv, *weights, t,
                                                      t // stride, **kw)
            out = nsa_decode_fused.decode_attend_fused(rq, kv_x, *args, t, ff, attn_out=comb,
                                                       **akw)
        runs.append((*sel, c, r, out, comb, kv_x))
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(*runs))
    assert torch.equal(runs[0][2], ckv) == bool((t + 1) % stride)


def test_fused_wrappers_refuse_what_the_kernels_do_not_take(gen):
    b, kvh, g, d, Bc = 2, 2, 2, 64, 16
    q, ring, kv_new = randn(gen, b, kvh, g, d), randn(gen, b, kvh, Bc, 2 * d), \
        randn(gen, b, kvh, 1, 2 * d)
    ckv = randn(gen, b, kvh, 136, 2 * d)
    weights = list(fused_weights(gen, kvh, Bc, d, 128))
    kw = dict(max_blocks=64, stride=8, sel_block=16, num_sel=4, n_slide=5, scale=0.125)
    with pytest.raises(TypeError):         # float32 biases only
        nsa_decode_fused.decode_select_emit(q, ckv, ring, kv_new, randn(gen, 2, kvh, 1, d),
                                            *weights[:2], weights[2].bfloat16(), *weights[3:],
                                            15, 1, **kw)
    weights[1] = weights[1][..., :100].contiguous()    # compressor width not a multiple of 64
    with pytest.raises(ValueError):
        nsa_decode_fused.decode_select_emit(q, ckv, ring, kv_new, randn(gen, 2, kvh, 1, d),
                                            *weights, 15, 1, **kw)


def test_model_decode_step_fused_route_matches_plain(gen):
    """Two layers at the reference widths at bs 4 on the fused route, random
    weights from a seed, across an emission step: kernels against the
    plain versions, within chip_smoke.py's 2% of the logits' scale."""
    cfg = reference_model_config().replace(depth=2, dtype="bfloat16")
    params = tree_to(init_transformer(cfg, torch.Generator().manual_seed(0), device="cuda"),
                     dtype=torch.bfloat16)
    packed = fuse_decode_params(params, cfg)
    ids = torch.randint(0, 256, (4, 199), generator=gen, device="cuda")
    before = (nsa_decode_fused.decode_select_emit.launches,
              nsa_decode_fused.decode_attend_fused.launches, nsa_decode.decode_select.launches)
    with torch.inference_mode():
        logits, cache = transformer_prefill(params, cfg, ids, 256)
        token = logits[:, -1].argmax(-1)
        plain = clone_cache(cache)
        for _ in range(2):     # t = 199 emits, t = 200 does not
            got, cache = transformer_decode_step(packed, cfg, token, cache, route="fused")
            want, plain = transformer_decode_step(packed, cfg, token, plain, use_kernels=False,
                                                  route="fused")
            assert torch.isfinite(got).all()
            assert max_err(got, want) <= 0.02 * max(want.abs().max().item(), 1.0)
            token = want.argmax(-1)
    assert (nsa_decode_fused.decode_select_emit.launches,
            nsa_decode_fused.decode_attend_fused.launches,
            nsa_decode.decode_select.launches) == (before[0] + 4, before[1] + 4, before[2])


def check_mega_selections(mp, cfg, insp, pre, post, t):
    """Each layer's selection of a whole-model kernel step against the plain
    select-emit on the kernel's own query and new row of that layer (the
    caches ``pre`` as they were before the step, ``post`` after it)."""
    nsa = cfg.nsa
    Bs, stride = nsa.selection_block_size, nsa.compress_block_sliding_stride
    num_sel, n_slide = nsa.num_selected_blocks, -(-nsa.sliding_window_size // Bs) + 1
    b, kvh = insp["q"].shape[1:3]
    gate = dict(num_sel=num_sel, n_slide=n_slide, tie=1e-6)
    slot = min(t // stride, post[1].shape[3] - 1)
    for l in range(cfg.depth):
        c_p, info_p, ckv_p, scores = nsa_decode_mega.layer_select_emit_plain(
            mp, l, insp["q"][l], pre[1][l], pre[2][l], post[2][l][..., -1:, :], t,
            max_len=pre[0].shape[3], stride=stride, sel_block=Bs, num_sel=num_sel,
            n_slide=n_slide, scale=cfg.dim_head ** -0.5)
        info_k = insp["info"][l].reshape(b, kvh, -1)
        assert nsa_decode.selection_faults(info_k, info_p, scores, **gate)[0] == [], (t, l)
        wrong = nsa_decode.with_next_ranked(info_k, scores, num_sel)
        assert nsa_decode.selection_faults(wrong, info_p, scores, **gate)[0], (t, l)
        assert max_err(insp["c_out"][l], c_p) <= TOL_FUSED * c_p.float().abs().max().item()
        row_k, row_p = post[1][l][..., slot, :], ckv_p[..., slot, :]
        assert max_err(row_k, row_p) <= TOL_FUSED * row_p.float().abs().max().item(), (t, l)


@pytest.mark.parametrize("b", [1, 3, 8, 9, 16])
def test_decode_step_mega_kernel_matches_plain(gen, b):
    """Two layers at the reference widths, random weights from a seed, at
    t = 199 (emits) and 200: the whole-model kernel against its plain
    version, logits within 2^-6 of the largest, the in-kernel argmax
    equal except at near-ties, and every cache row but the step's own
    bit-equal (b 1 to 16 rows of the kernel's one 16-row tile); each
    layer's selection against the plain one on the kernel's own query and
    new row (``inspect``), ids equal except ties, a selection one rank short
    failing that gate, c_out and the emitted row within 2^-6 of the
    largest; then one launch of 4 greedy tokens against 4 launches of one,
    bit for bit."""
    cfg = reference_model_config().replace(depth=2, dtype="bfloat16")
    params = tree_to(init_transformer(cfg, torch.Generator().manual_seed(0), device="cuda"),
                     dtype=torch.bfloat16)
    mp = fuse_decode_params(params, cfg)["mega"]
    ids = torch.randint(0, 256, (b, 199), generator=gen, device="cuda")
    with torch.inference_mode():
        logits, cache = transformer_prefill(params, cfg, ids, 256)
        first = logits[:, -1].argmax(-1)
        start = stack_decode_caches(cache)
        kern, plain = [x.clone() for x in start], [x.clone() for x in start]
        token = first
        before = nsa_decode_mega.decode_step_mega.launches
        for t in (199, 200):
            pre, insp = [x.clone() for x in kern], {}
            got, tok_k, *_ = transformer_decode_step_mega(mp, cfg, token, *kern, t, greedy=True,
                                                          inspect=insp)
            want, tok_p, *_ = transformer_decode_step_mega(mp, cfg, token, *plain, t, greedy=True,
                                                           use_kernels=False)
            check_mega_selections(mp, cfg, insp, pre, kern, t)
            top = want.abs().max().item()
            assert torch.isfinite(got).all() and max_err(got, want) <= TOL_FUSED * top
            top2 = want.topk(2, dim=-1).values
            near = top2[:, 0] - top2[:, 1] <= TOL_FUSED * top
            assert bool(((tok_k == tok_p)[:, 0] | near).all())
            assert torch.equal(tok_k[:, 0].long(), got.argmax(-1))
            token = tok_p[:, 0]
        assert nsa_decode_mega.decode_step_mega.launches == before + 2
        ring = start[2]
        for name, x, y, rows in (("kv", kern[0], plain[0], (199, 200)),
                                 ("ckv", kern[1], plain[1], (199 // 8,))):
            keep = [i for i in range(x.shape[3]) if i not in rows]
            assert torch.equal(x[:, :, :, keep], y[:, :, :, keep]), name
            assert torch.equal(x[:, :, :, keep], start[0 if name == "kv" else 1][:, :, :, keep])
            assert max_err(x, y) <= TOL_FUSED * y.float().abs().max().item(), name
        assert torch.equal(kern[2][..., :-2, :], ring[..., 2:, :])
        assert max_err(kern[2], plain[2]) <= TOL_FUSED * plain[2].float().abs().max().item()

        single, multi = [x.clone() for x in start], [x.clone() for x in start]
        token, toks = first, []
        for i in range(4):
            lg1, nxt, *_ = transformer_decode_step_mega(mp, cfg, token, *single, 199 + i,
                                                        greedy=True)
            toks.append(nxt)
            token = nxt[:, 0]
        lg4, toks4, *_ = transformer_decode_step_mega(mp, cfg, first, *multi, 199, greedy=True,
                                                      steps=4)
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(toks, 1), toks4) and torch.equal(lg1, lg4)
    assert all(torch.equal(x, y) for x, y in zip(single, multi))


def test_mega_wrapper_refuses_what_the_kernel_does_not_take(gen):
    cfg = reference_model_config().replace(depth=2, dtype="bfloat16")
    params = tree_to(init_transformer(cfg, torch.Generator().manual_seed(0), device="cuda"),
                     dtype=torch.bfloat16)
    mp = fuse_decode_params(params, cfg)["mega"]
    with torch.inference_mode():
        _, cache = transformer_prefill(params, cfg, torch.zeros(2, 20, dtype=torch.long,
                                                                device="cuda"), 256)
        kv, ckv, ring = stack_decode_caches(cache)
        token = torch.zeros(2, dtype=torch.long, device="cuda")
        with pytest.raises(ValueError, match="steps"):      # several tokens only when greedy
            transformer_decode_step_mega(mp, cfg, token, kv, ckv, ring, 20, steps=2)
        with pytest.raises(ValueError):                     # past the cache's end
            transformer_decode_step_mega(mp, cfg, token, kv, ckv, ring, 255, steps=2,
                                         greedy=True)
        with pytest.raises(TypeError):                      # bf16 caches only
            transformer_decode_step_mega(mp, cfg, token, kv.float(), ckv, ring, 20)
        before = nsa_decode_mega.decode_step_mega.launches
        L, dim = mp["fw1"].shape[:2]
        for hid4 in (2000, 16384):     # not a multiple of 64; a plan that does not fit
            wide = dict(mp, fw1=torch.zeros(L, dim, hid4, dtype=torch.bfloat16, device="cuda"),
                        fb1=torch.zeros(L, 1, hid4, dtype=torch.bfloat16, device="cuda"),
                        fw2=torch.zeros(L, hid4, dim, dtype=torch.bfloat16, device="cuda"))
            with pytest.raises(ValueError, match="64-row boxes" if hid4 == 2000 else
                               "shared memory"):
                transformer_decode_step_mega(wide, cfg, token, kv, ckv, ring, 20)
        assert nsa_decode_mega.decode_step_mega.launches == before


def test_mega_plan_on_the_card_is_the_python_plan(gen):
    """The C entry's launch plan equals ``mega_plan``, whether it fits or
    not, at G 1, 2, 4, 8 over model, FF and vocabulary widths and
    compression windows, on this card's SM count and limit; the reference
    model's fits."""
    nsa = reference_model_config().nsa
    seen = set()
    for kvh, g in ((4, 2), (8, 1), (2, 4), (1, 8)):
        for dim, hid4, vocab, Bc in ((512, 2048, 256, 16), (256, 1024, 256, 16),
                                     (1024, 4096, 1024, 16), (512, 8192, 256, 16),
                                     (512, 16384, 256, 16), (512, 2048, 32768, 16),
                                     (512, 2048, 256, 64), (512, 2048, 256, 128)):
            ints = [6, 8, kvh, g, 4096, 512, Bc, nsa.num_compressed_mem_kv, 1024, dim, vocab,
                    hid4, 1, 0, nsa.compress_block_sliding_stride, nsa.selection_block_size,
                    nsa.num_selected_blocks, 5, nsa.sliding_window_size, nsa_decode.INFO_WIDTH]
            dev = nsa_decode_mega.launch_plan("cuda", ints)
            want = nsa_decode_mega.mega_plan(
                kvh=kvh, g=g, dim=dim, hid4=hid4, vocab=vocab, Wc=512,
                M=nsa.num_compressed_mem_kv, Bc=Bc, sel_block=nsa.selection_block_size,
                stride=nsa.compress_block_sliding_stride, num_sel=nsa.num_selected_blocks,
                n_slide=5, grid=dev["grid"], smem_optin=dev["smem_optin"])
            case = (kvh, g, dim, hid4, vocab, Bc)
            assert dev["fits"] == want["fits"], case
            assert {k: dev[k] for k in want if k != "fits"} == {k: want[k] for k in want
                                                                if k != "fits"}, case
            seen.add(want["fits"])
            if (dim, hid4, vocab, Bc) == (512, 2048, 256, 16):
                assert want["fits"], case
    assert seen == {True, False}


def test_emit_plan_on_the_card_is_the_python_plan(gen):
    """The C entry's emission plan equals ``emit_plan``, whether it fits
    or not, over batch, KV heads, compression windows and widths."""
    device, seen = torch.cuda.current_device(), set()
    for b in (1, 16, 17, 40):
        for kvh in (1, 4, 8):
            for Bc in (4, 16, 32, 64, 128):
                for hid in (512, 1024, 2048):
                    dev = nsa_decode_ragged._device_emit_plan(device, b, kvh, Bc, hid)
                    want = nsa_decode_ragged.emit_plan(b, kvh, Bc, hid, dev["smem_optin"])
                    assert dev == want, (b, kvh, Bc, hid)
                    seen.add(want["fits"])
    assert seen == {True, False}


RAGGED_T = [7, 199, 200, 1023, 0, 3]     # 7, 199, 1023 emit (stride 8); 0 and 3 before Bc


@pytest.mark.parametrize("uniform", [False, True])
def test_decode_select_emit_ragged_kernel_matches_plain(gen, uniform):
    """Mixed positions against the plain version; at one position for every
    row, against the scalar kernel too."""
    b, kvh, g, d, M, Bc, hid = 6, 2, 2, 64, 1, 16, 128
    stride, Bs, window, num_sel, max_len = 8, 16, 64, 4, 1024
    n_slide = -(-window // Bs) + 1
    Wc = _ckv_width(max_len, stride, Bs // stride)
    q, ckv, mem_kv = randn(gen, b, kvh, g, d), randn(gen, b, kvh, Wc, 2 * d), randn(gen, 2, kvh, M, d)
    ring, kv_new = randn(gen, b, kvh, Bc, 2 * d), randn(gen, b, kvh, 1, 2 * d)
    weights = fused_weights(gen, kvh, Bc, d, hid)
    kw = dict(max_blocks=max_len // Bs, stride=stride, sel_block=Bs, num_sel=num_sel,
              n_slide=n_slide, scale=0.125)
    ts = [199] * b if uniform else RAGGED_T
    t = torch.tensor(ts, dtype=torch.int32, device="cuda")
    caches = [(ckv.clone(), ring.clone()) for _ in range(3)]
    before = nsa_decode_ragged.decode_select_emit_ragged.launches
    c_k, info_k = nsa_decode_ragged.decode_select_emit_ragged(
        q, *caches[0], kv_new, mem_kv, *weights, t, t // stride, **kw)
    c_p, info_p = nsa_decode_ragged.decode_select_emit_ragged_plain(
        q, *caches[1], kv_new, mem_kv, *weights, t, t // stride, **kw)
    torch.cuda.synchronize()
    assert nsa_decode_ragged.decode_select_emit_ragged.launches == before + 1
    assert max_err(c_k, c_p) <= TOL_OUT
    assert torch.equal(info_k, info_p)   # random scores: no ties
    assert torch.equal(caches[0][1], caches[1][1])
    for i, ti in enumerate(ts):
        slot = ti // stride
        for ckv_x in (caches[0][0], caches[1][0]):     # no other row changes
            assert torch.equal(torch.cat([ckv_x[i, :, :slot], ckv_x[i, :, slot + 1:]], 1),
                               torch.cat([ckv[i, :, :slot], ckv[i, :, slot + 1:]], 1))
        row_k, row_p = caches[0][0][i, :, slot], caches[1][0][i, :, slot]
        if (ti + 1) % stride:
            assert torch.equal(row_k, ckv[i, :, slot]) and torch.equal(row_p, ckv[i, :, slot])
        else:
            assert max_err(row_k, row_p) <= TOL_FUSED * row_p.float().abs().max().item()
    if uniform:
        c_s, info_s = nsa_decode_fused.decode_select_emit(q, *caches[2], kv_new, mem_kv,
                                                          *weights, ts[0], ts[0] // stride, **kw)
        torch.cuda.synchronize()
        assert torch.equal(info_s, info_k) and torch.equal(caches[2][1], caches[0][1])
        assert max_err(c_s, c_k) <= TOL_FUSED * c_s.float().abs().max().item()
        assert max_err(caches[2][0], caches[0][0]) <= TOL_FUSED * caches[2][0].float().abs().max()


def emitting_positions(b, n_emit, gen):
    """b positions below 1024 of which exactly n_emit complete a compressed
    block (stride 8), the first of them t = 7 (a window that starts before
    position 0), in a seeded order."""
    ts = [7 + 8 * (13 * i % 127) if i < n_emit else 2 + 8 * (11 * i % 127) for i in range(b)]
    order = torch.randperm(b, generator=gen, device="cuda").cpu()
    return torch.tensor(ts, dtype=torch.int32)[order].cuda()


@pytest.mark.parametrize("b,n_emit,G", [(16, 0, 2), (16, 1, 2), (16, 5, 1), (16, 16, 4),
                                        (17, 17, 8), (40, 33, 2)])
def test_decode_select_emit_ragged_emission_cases(gen, b, n_emit, G, monkeypatch):
    """The tensor-core emission at the reference compressor (Bc 16, 1024
    hidden columns) with 0, 1, 5 and 16 of 16 rows emitting, all 17 of 17
    (a second 16-row tile) and 33 of 40; G 1, 2, 4, 8: emitted rows within
    2^-6 of the largest value, every other ckv row untouched, the ring
    bit-equal, a second launch bit-equal, and the plain version with one
    hidden chunk left out failing the emitted-row gate."""
    kvh, d, M, Bc, hid = 2, 64, 1, 16, 1024
    stride, Bs, window, num_sel, max_len = 8, 16, 64, 4, 1024
    n_slide = -(-window // Bs) + 1
    Wc = _ckv_width(max_len, stride, Bs // stride)
    q, ckv, mem_kv = randn(gen, b, kvh, G, d), randn(gen, b, kvh, Wc, 2 * d), randn(gen, 2, kvh, M, d)
    ring, kv_new = randn(gen, b, kvh, Bc, 2 * d), randn(gen, b, kvh, 1, 2 * d)
    weights = fused_weights(gen, kvh, Bc, d, hid)
    kw = dict(max_blocks=max_len // Bs, stride=stride, sel_block=Bs, num_sel=num_sel,
              n_slide=n_slide, scale=0.125)
    t = emitting_positions(b, n_emit, gen)
    num_cb = t // stride
    emit = nsa_decode_ragged.ragged_emits(t, num_cb, stride)
    assert int(emit.sum()) == n_emit
    runs = []
    for use_kernel in (True, True, False, False):
        c, r = ckv.clone(), ring.clone()
        if use_kernel:
            out = nsa_decode_ragged.decode_select_emit_ragged(q, c, r, kv_new, mem_kv, *weights, t,
                                                              num_cb, **kw)
        else:
            if len(runs) == 3:            # the control: one hidden chunk left out
                real = nsa_decode_fused.emission_plain
                monkeypatch.setattr(nsa_decode_ragged, "emission_plain",
                                    lambda *a, **k: real(*a, drop_chunk=hid // 128, **k))
            out = nsa_decode_ragged.decode_select_emit_ragged_plain(
                q, c, r, kv_new, mem_kv, *weights, t, num_cb, **kw)
        runs.append((*out, c, r))
    torch.cuda.synchronize()
    (c_k, info_k, ckv_k, ring_k), second, (c_p, info_p, ckv_p, ring_p), control = runs
    assert all(torch.equal(x, y) for x, y in zip(runs[0], second))
    assert max_err(c_k, c_p) <= TOL_OUT and torch.equal(info_k, info_p)
    assert torch.equal(ring_k, ring_p)
    rows = torch.arange(b, device="cuda")
    slot = num_cb.long().clamp(max=Wc - 1)
    others = (torch.arange(Wc, device="cuda")[None] != slot[:, None])[:, None, :, None] \
        .expand_as(ckv)
    assert torch.equal(ckv_k[others], ckv[others])
    assert torch.equal(ckv_k[rows, :, slot][~emit], ckv[rows, :, slot][~emit])
    if n_emit:
        row_k, row_p = ckv_k[rows, :, slot][emit], ckv_p[rows, :, slot][emit]
        bound = TOL_FUSED * row_p.float().abs().max().item()
        assert max_err(row_k, row_p) <= bound
        assert max_err(control[2][rows, :, slot][emit], row_p) > bound


def test_select_emit_ragged_refuses_a_window_that_does_not_fit(gen):
    """A 128-row compression window needs a 16 x 8192 tile: the ragged and
    the one-position wrappers raise before launching, as the plan says; the
    reference window fits and its plan is the pure-Python one."""
    b, kvh, d, Bc, hid = 2, 2, 64, 128, 128
    q, ring, kv_new = randn(gen, b, kvh, 2, d), randn(gen, b, kvh, Bc, 2 * d), \
        randn(gen, b, kvh, 1, 2 * d)
    ckv = randn(gen, b, kvh, 136, 2 * d)
    weights = fused_weights(gen, kvh, Bc, d, hid)
    t = torch.full((b,), 127, dtype=torch.int32, device="cuda")
    kw = dict(max_blocks=64, stride=64, sel_block=128, num_sel=4, n_slide=2, scale=0.125)
    before = (nsa_decode_ragged.decode_select_emit_ragged.launches,
              nsa_decode_fused.decode_select_emit.launches)
    with pytest.raises(ValueError, match="shared memory"):
        nsa_decode_ragged.decode_select_emit_ragged(q, ckv, ring, kv_new, randn(gen, 2, kvh, 1, d),
                                                    *weights, t, t // 64, **kw)
    with pytest.raises(ValueError, match="shared memory"):     # row 6 takes row 8's plan
        nsa_decode_fused.decode_select_emit(q, ckv, ring, kv_new, randn(gen, 2, kvh, 1, d),
                                            *weights, 127, 127 // 64, **kw)
    assert (nsa_decode_ragged.decode_select_emit_ragged.launches,
            nsa_decode_fused.decode_select_emit.launches) == before
    small = randn(gen, b, kvh, 16, 2 * d)
    dev = nsa_decode_ragged.device_emit_plan(q, small, weights[1])
    assert dev["fits"]
    assert dev == nsa_decode_ragged.emit_plan(b, kvh, 16, hid, dev["smem_optin"])


def test_decode_attend_ragged_and_paged_kernels_match_plain(gen):
    """Mixed positions, the FF inside; the paged kernel under a permuted
    table of 64-row pages bit for bit the ragged kernel."""
    b, kvh, g, d, stride, Bs, window, num_sel, max_len, page = 6, 2, 2, 64, 8, 16, 64, 4, 1024, 64
    dim, hid4 = 256, 512
    n_slide = -(-window // Bs) + 1
    Wc = _ckv_width(max_len, stride, Bs // stride)
    t = torch.tensor(RAGGED_T, dtype=torch.int32, device="cuda")
    q, ckv, mem_kv = randn(gen, b, kvh, g, d), randn(gen, b, kvh, Wc, 2 * d), randn(gen, 2, kvh, 1, d)
    skw = dict(max_blocks=max_len // Bs, stride=stride, sel_block=Bs, num_sel=num_sel,
               n_slide=n_slide, scale=0.125)
    c_out, info = nsa_decode.decode_select_plain(q, ckv, mem_kv, t, t // stride, **skw)
    info = info.reshape(b, -1)
    rq, kv, kv_new = randn(gen, b, kvh, g, d), randn(gen, b, kvh, max_len, 2 * d), \
        randn(gen, b, kvh, 1, 2 * d)
    gates = torch.rand((b, kvh, g, 3), generator=gen, device="cuda").to(torch.bfloat16)
    x = randn(gen, b, 1, dim)
    w_out = (randn(gen, kvh * g * d, dim) * (kvh * g * d) ** -0.5).to(torch.bfloat16)
    ff = (1.0 + 0.1 * torch.randn(dim, generator=gen, device="cuda"),
          (randn(gen, dim, hid4) * dim ** -0.5).to(torch.bfloat16),
          0.1 * torch.randn(hid4, generator=gen, device="cuda"),
          (randn(gen, hid4, dim) * hid4 ** -0.5).to(torch.bfloat16),
          0.1 * torch.randn(dim, generator=gen, device="cuda"))
    akw = dict(sel_block=Bs, window=window, num_sel=num_sel, n_slide=n_slide, scale=0.125)
    args = (kv_new, info, c_out, gates, x, w_out, t, ff)
    kv_k, kv_p = kv.clone(), kv.clone()
    before = (nsa_decode_ragged.decode_attend_fused_ragged.launches,
              nsa_decode_ragged.decode_attend_fused_paged.launches)
    out_k = nsa_decode_ragged.decode_attend_fused_ragged(rq, kv_k, *args, **akw)
    out_p = nsa_decode_ragged.decode_attend_fused_ragged_plain(rq, kv_p, *args, **akw)
    n_pg = max_len // page
    table = torch.randperm(b * n_pg, generator=gen, device="cuda").reshape(b, n_pg).int()
    pool = randn(gen, b * n_pg + 1, kvh, page, 2 * d)
    pool[table.reshape(-1).long()] = kv.reshape(b, kvh, n_pg, page, 2 * d).transpose(1, 2) \
        .reshape(-1, kvh, page, 2 * d)
    out_g = nsa_decode_ragged.decode_attend_fused_paged(rq, pool, table, *args, **akw)
    torch.cuda.synchronize()
    assert (nsa_decode_ragged.decode_attend_fused_ragged.launches,
            nsa_decode_ragged.decode_attend_fused_paged.launches) == (before[0] + 1,
                                                                      before[1] + 1)
    assert torch.isfinite(out_k.float()).all()
    assert max_err(out_k, out_p) <= TOL_FUSED * out_p.float().abs().max().item()
    assert torch.equal(kv_k, kv_p)
    for i, ti in enumerate(RAGGED_T):
        assert torch.equal(kv_k[i, :, ti], kv_new[i, :, 0])
    assert torch.equal(out_g, out_k)
    logical = pool[table.long()].transpose(1, 2).reshape(b, kvh, max_len, 2 * d)
    assert torch.equal(logical, kv_k)


def ragged_attend_case(gen, b, kvh, G, dim, hid4, with_ff, max_len=1024):
    """Inputs of the ragged attend kernels at b rows: RAGGED_T's positions
    first, then seeded ones; info and c_out from the plain select."""
    d, stride, Bs, window, num_sel = 64, 8, 16, 64, 4
    n_slide = -(-window // Bs) + 1
    Wc = _ckv_width(max_len, stride, Bs // stride)
    rest = torch.randint(0, max_len, (max(b - len(RAGGED_T), 0),), generator=gen,
                         device="cuda")
    t = torch.cat([torch.tensor(RAGGED_T[:b], device="cuda"), rest]).int()
    q, ckv, mem_kv = randn(gen, b, kvh, G, d), randn(gen, b, kvh, Wc, 2 * d), \
        randn(gen, 2, kvh, 1, d)
    c_out, info = nsa_decode.decode_select_plain(
        q, ckv, mem_kv, t, t // stride, max_blocks=max_len // Bs, stride=stride, sel_block=Bs,
        num_sel=num_sel, n_slide=n_slide, scale=0.125, weights_dtype=torch.float32)
    ff = ()
    if with_ff:
        ff = (1.0 + 0.1 * torch.randn(dim, generator=gen, device="cuda"),
              (randn(gen, dim, hid4) * dim ** -0.5).to(torch.bfloat16),
              0.1 * torch.randn(hid4, generator=gen, device="cuda"),
              (randn(gen, hid4, dim) * hid4 ** -0.5).to(torch.bfloat16),
              0.1 * torch.randn(dim, generator=gen, device="cuda"))
    akw = dict(sel_block=Bs, window=window, num_sel=num_sel, n_slide=n_slide, scale=0.125)
    gates = torch.rand((b, kvh, G, 3), generator=gen, device="cuda").to(torch.bfloat16)
    w_out = (randn(gen, kvh * G * d, dim) * (kvh * G * d) ** -0.5).to(torch.bfloat16)
    return (randn(gen, b, kvh, G, d), randn(gen, b, kvh, max_len, 2 * d),
            (randn(gen, b, kvh, 1, 2 * d), info.reshape(b, -1), c_out, gates,
             randn(gen, b, 1, dim), w_out, t, ff), akw)


@pytest.mark.parametrize("b,kvh,G,dim,hid4,with_ff,page", [
    (1, 4, 2, 512, 2048, True, 64),       # the engine's widths, one row
    (5, 2, 1, 256, 512, True, 16),
    (16, 4, 2, 512, 2048, True, 64),      # the engine's cell
    (17, 2, 4, 256, 1024, False, 16),     # a ragged second row tile, no FF
    (40, 4, 8, 512, 2048, True, 64),      # three row tiles, more items than SMs
    (16, 4, 8, 512, 2048, False, 16),
])
def test_decode_attend_ragged_persistent_kernel_cases(gen, b, kvh, G, dim, hid4, with_ff, page):
    """The one-launch attend kernels against their plain versions: the
    output within 2^-6 of its largest value, the rounded attention output
    within ``attend_tolerance`` element by element (each row's first selected
    block left out must fail it), the kv rows written; the paged kernel
    under a permuted table of ``page``-row pages bit for bit the ragged one;
    a second launch bit for bit the first."""
    rq, kv, args, akw = ragged_attend_case(gen, b, kvh, G, dim, hid4, with_ff)
    kv_new, info, c_out, gates, x, w_out, t, ff = args
    kv_k, kv_p, kv_2 = kv.clone(), kv.clone(), kv.clone()
    comb, comb_2 = torch.empty_like(rq), torch.empty_like(rq)
    before = nsa_decode_ragged.decode_attend_fused_ragged.launches
    out_k = nsa_decode_ragged.decode_attend_fused_ragged(rq, kv_k, *args, attn_out=comb, **akw)
    out_2 = nsa_decode_ragged.decode_attend_fused_ragged(rq, kv_2, *args, attn_out=comb_2,
                                                         **akw)
    out_p = nsa_decode_ragged.decode_attend_fused_ragged_plain(rq, kv_p, *args, **akw)
    torch.cuda.synchronize()
    assert nsa_decode_ragged.decode_attend_fused_ragged.launches == before + 2
    assert out_k.shape == (b, 1, dim) and torch.isfinite(out_k.float()).all()
    assert max_err(out_k, out_p) <= TOL_FUSED * out_p.float().abs().max().item()
    assert torch.equal(kv_k, kv_p)
    assert torch.equal(out_2, out_k) and torch.equal(comb_2, comb) and torch.equal(kv_2, kv_k)
    want, tol = nsa_decode_ragged.attend_tolerance(rq, kv_p, info, c_out, gates, t, **akw)
    assert ((comb.float() - want.float()).abs() <= tol).all()
    dropped = nsa_decode_ragged.without_first_selected(info, akw["num_sel"], akw["n_slide"])
    if bool((dropped != info).any()):
        wrong, _ = nsa_decode_ragged.attend_tolerance(rq, kv_p, dropped, c_out, gates, t, **akw)
        assert not ((wrong.float() - want.float()).abs() <= tol).all()

    max_len = kv.shape[2]
    n_pg = max_len // page
    table = torch.randperm(b * n_pg, generator=gen, device="cuda").reshape(b, n_pg).int()
    pool = randn(gen, b * n_pg + 1, kvh, page, kv.shape[3])
    pool[table.reshape(-1).long()] = kv.reshape(b, kvh, n_pg, page, -1).transpose(1, 2) \
        .reshape(-1, kvh, page, kv.shape[3])
    trash = pool[-1].clone()
    comb_g = torch.empty_like(rq)
    out_g = nsa_decode_ragged.decode_attend_fused_paged(rq, pool, table, *args, attn_out=comb_g,
                                                        **akw)
    torch.cuda.synchronize()
    assert torch.equal(out_g, out_k) and torch.equal(comb_g, comb)
    assert torch.equal(pool[table.long()].transpose(1, 2).reshape(b, kvh, max_len, -1), kv_k)
    assert torch.equal(pool[-1], trash)


def test_attend_ragged_refuses_slices_that_do_not_fit(gen):
    """An FF whose hidden rows do not fit a block's shared memory: the
    ragged and the one-position wrappers raise with the sizes, and nothing
    runs."""
    rq, kv, args, akw = ragged_attend_case(gen, 2, 2, 2, 256, 16384, True)
    plan = nsa_decode_ragged.attend_plan(rq, 256, 16384, sel_block=16, num_sel=4, n_slide=5)
    assert plan["blocks_per_sm"] == 0 and plan["smem_bytes"] > plan["smem_optin"]
    kv_k = kv.clone()
    before = (nsa_decode_ragged.decode_attend_fused_ragged.launches,
              nsa_decode_fused.decode_attend_fused.launches)
    with pytest.raises(ValueError, match="shared memory"):
        nsa_decode_ragged.decode_attend_fused_ragged(rq, kv_k, *args, **akw)
    with pytest.raises(ValueError, match="shared memory"):     # row 7 takes row 9's plan
        nsa_decode_fused.decode_attend_fused(rq, kv_k, *args[:6], int(args[6][0]), args[7],
                                             **akw)
    torch.cuda.synchronize()
    assert (nsa_decode_ragged.decode_attend_fused_ragged.launches,
            nsa_decode_fused.decode_attend_fused.launches) == before
    assert torch.equal(kv_k, kv)
    engine = nsa_decode_ragged.attend_plan(randn(gen, 16, 4, 2, 64), 512, 2048, sel_block=16,
                                           num_sel=4, n_slide=5)
    assert engine["blocks_per_sm"] >= 1 and engine["grid"] == torch.cuda.get_device_properties(
        0).multi_processor_count


@pytest.mark.parametrize("b, L, D, dtype, S, ids", [
    (5, 1024, 128, torch.bfloat16, 9, "random"),
    (16, 4096, 128, torch.bfloat16, 9, "random"),      # the engine cell
    (64, 4096, 128, torch.bfloat16, 9, "random"),      # the serving batch
    (5, 1024, 64, torch.float32, 9, "random"),         # 256-byte rows
    (5, 1024, 64, torch.bfloat16, 9, "random"),        # 128-byte rows
    (5, 1024, 256, torch.float32, 9, "random"),        # 1,024 vectors a block: 4 rounds
    (5, 1024, 24, torch.bfloat16, 9, "random"),        # 48 vectors a block: threads left idle
    (5, 1024, 128, torch.bfloat16, 1, "random"),
    (5, 1024, 128, torch.bfloat16, 9, "ends"),         # 0, the last block, and past both (clamped)
    (16, 4096, 128, torch.bfloat16, 9, "info view"),   # the split route's strided id rows
], ids=["small", "engine", "b64", "f32-d64", "bf16-d64", "f32-d256", "bf16-d24", "S1", "ends",
        "info-view"])
def test_paged_gather_kernel_matches_plain(gen, b, L, D, dtype, S, ids):
    """One launch, bit for bit the plain version and advanced indexing (on
    the clamped ids); the same call on ids with one id moved one block on
    gives other bits."""
    kvh, Bs = 4, 16
    nb = L // Bs
    cache = torch.randn((b, kvh, L, D), generator=gen, device="cuda").to(dtype)
    if ids == "ends":
        pick = torch.tensor([-2, 0, nb - 1, nb + 3], dtype=torch.int32, device="cuda")
        idx = pick[torch.randint(0, 4, (b, kvh, S), generator=gen, device="cuda")]
        idx[0, 0, :4] = pick
    elif ids == "info view":
        info = torch.randint(0, nb, (b, kvh, nsa_decode.INFO_WIDTH), generator=gen,
                             device="cuda", dtype=torch.int32)
        idx = info[..., :S]
        assert not idx.is_contiguous()
    else:
        idx = torch.randint(0, nb, (b, kvh, S), generator=gen, device="cuda", dtype=torch.int32)
    before = paged_gather.paged_gather.launches
    got = paged_gather.paged_gather(cache, idx, Bs)
    torch.cuda.synchronize()
    assert paged_gather.paged_gather.launches == before + 1
    assert torch.equal(got, paged_gather.paged_gather_plain(cache, idx, Bs))
    blocks = cache.view(b, kvh, nb, Bs, D)
    bi = torch.arange(b, device="cuda")[:, None, None]
    hi = torch.arange(kvh, device="cuda")[None, :, None]
    lib = blocks[bi, hi, idx.long().clamp(0, nb - 1)].reshape(got.shape)
    assert torch.equal(got, lib)
    wrong = idx.clone()
    wrong[0, 0, 0] = (wrong[0, 0, 0].clamp(0, nb - 1) + 1) % nb
    assert not torch.equal(got, paged_gather.paged_gather_plain(cache, wrong, Bs))


def test_paged_gather_refuses_what_it_cannot_take(gen):
    cache = randn(gen, 2, 4, 256, 128)
    idx = torch.zeros((2, 4, 9), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):
        paged_gather.paged_gather(cache, idx.transpose(1, 2).contiguous().transpose(1, 2), 16)
    with pytest.raises(ValueError):
        paged_gather.paged_gather(cache, idx.long(), 16)
    with pytest.raises(ValueError):
        paged_gather.paged_gather(cache, idx, 24)


@pytest.mark.parametrize("route", [None, "split"])
def test_model_ragged_step_kernels_match_plain(gen, route):
    """Two layers at the reference widths, 4 rows at mixed positions from
    their own prefills, two ragged steps across emissions: kernels against
    the plain versions within chip_smoke.py's 2% of the logits' scale."""
    cfg = reference_model_config().replace(depth=2, dtype="bfloat16")
    params = tree_to(init_transformer(cfg, torch.Generator().manual_seed(0), device="cuda"),
                     dtype=torch.bfloat16)
    packed = fuse_decode_params(params, cfg)
    lens = [199, 40, 7, 130]
    ids = torch.randint(0, 256, (4, 200), generator=gen, device="cuda")
    counted = (nsa_decode_ragged.decode_select_emit_ragged, paged_gather.paged_gather,
               nsa_decode_fused.decode_select_emit, nsa_decode.decode_select)
    before = [fn.launches for fn in counted]
    with torch.inference_mode():
        logits, cache = transformer_prefill(params, cfg, ids, 256, true_len=torch.tensor(
            lens, device="cuda"))
        layers, plain = cache.layers, clone_cache(cache).layers
        token = logits[torch.arange(4), torch.tensor(lens) - 1].argmax(-1)
        seq = torch.tensor(lens, dtype=torch.int32, device="cuda")
        for _ in range(2):
            got, layers = transformer_decode_step_ragged(packed, cfg, token, layers, seq,
                                                         route=route)
            want, plain = transformer_decode_step_ragged(packed, cfg, token, plain, seq,
                                                         use_kernels=False, route=route)
            assert torch.isfinite(got).all()
            assert max_err(got, want) <= 0.02 * max(want.abs().max().item(), 1.0)
            token, seq = want.argmax(-1), seq + 1
    ran = [fn.launches - n for fn, n in zip(counted, before)]
    assert ran == ([0, 4, 0, 0] if route == "split" else [4, 0, 0, 0])


@pytest.mark.parametrize("G,n,n_k,causal", [(2, 300, 170, True), (1, 77, 300, False),
                                            (4, 130, 200, True)])
def test_flash_attention_kernel_other_key_lengths_match_plain(gen, G, n, n_k, causal):
    """n_k != n: query row r at key position r, as the wrapper takes it."""
    b, kvh, d = 2, 2, 64
    q, k, v = randn(gen, b, kvh * G, n, d), randn(gen, b, kvh, n_k, d), randn(gen, b, kvh, n_k, d)
    got = flash.flash_attention(q, k, v, causal=causal)
    want = flash.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    tol = flash.flash_attention_tolerance(q, k, v, want, causal=causal)
    assert ((got.float() - want.float()).abs() <= tol).all()


@pytest.mark.parametrize("G,n,causal", [(2, 300, True), (2, 300, False), (2, 3900, True),
                                        (2, 3900, False), (1, 300, True), (4, 130, True)])
def test_flash_attention_kernel_matches_plain(gen, G, n, causal):
    b, kvh, d = 2, 2, 64
    q, k, v = randn(gen, b, kvh * G, n, d), randn(gen, b, kvh, n, d), randn(gen, b, kvh, n, d)
    before = flash.flash_attention.launches
    got = flash.flash_attention(q, k, v, causal=causal)
    want = flash.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash.flash_attention.launches == before + 1
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    tol = flash.flash_attention_tolerance(q, k, v, want, causal=causal)
    assert ((got.float() - want.float()).abs() <= tol).all()


def test_flash_wrapper_refuses_what_the_kernel_does_not_take(gen):
    q, k = randn(gen, 1, 4, 64, 64), randn(gen, 1, 2, 64, 64)
    with pytest.raises(ValueError):
        flash.flash_attention(randn(gen, 1, 4, 64, 32), randn(gen, 1, 2, 64, 32),
                              randn(gen, 1, 2, 64, 32))
    with pytest.raises(ValueError):
        flash.flash_attention(randn(gen, 1, 6, 64, 64), k, k)       # 3 heads per KV head
    with pytest.raises(TypeError):
        flash.flash_attention(q.float(), k.float(), k.float())
    with pytest.raises(NotImplementedError):
        flash.flash_attention(q.requires_grad_(), k, k)


def test_full_model_prefill_and_decode_kernels_match_plain(gen):
    """The full-attention model at the reference widths, two layers: the
    prefill through the flash kernel against its plain version, then one
    decode step from each cache, within chip_smoke.py's 2% of the logits'
    scale."""
    cfg = reference_model_config(use_sparse_attn=False).replace(depth=2, dtype="bfloat16")
    params = tree_to(init_transformer(cfg, torch.Generator().manual_seed(0), device="cuda"),
                     dtype=torch.bfloat16)
    ids = torch.randint(0, 256, (3, 333), generator=gen, device="cuda")
    before = flash.flash_attention.launches
    with torch.inference_mode():
        got, cache = transformer_prefill(params, cfg, ids, 384)
        want, plain = transformer_forward(params, cfg, ids, return_cache_max_len=384,
                                          use_kernels=False)
        assert flash.flash_attention.launches == before + cfg.depth
        assert max_err(got, want) <= 0.02 * want.abs().max().item()
        token = want[:, -1].argmax(-1)
        step, _ = transformer_decode_step(params, cfg, token, cache)
        step_p, _ = transformer_decode_step(params, cfg, token, plain)
    assert torch.isfinite(step).all()
    assert max_err(step, step_p) <= 0.02 * step_p.abs().max().item()


# ---- decode loops as captured CUDA graphs (models/decode_graph.py) ------------

# name: (sparse model, batch, route, tokens a launch, temperature); gen_len 12
# from position 195 crosses the emission at t = 199
DECODE_LOOPS = {"split": (True, 9, None, 1, 0.0), "fused": (True, 4, "fused", 1, 0.0),
                "mega": (True, 4, None, 4, 0.0), "mega_sample": (True, 4, None, 1, 0.8),
                "full": (False, 9, None, 1, 0.0)}
LOOP_PROMPT, LOOP_GEN, LOOP_MAX_LEN = 195, 12, 256


def decode_model(sparse):
    cfg = reference_model_config(use_sparse_attn=sparse).replace(depth=2, dtype="bfloat16")
    params = tree_to(init_transformer(cfg, torch.Generator().manual_seed(0), device="cuda"),
                     dtype=torch.bfloat16)
    return fuse_decode_params(params, cfg), cfg


def launch_counts():
    return [fn.launches for fn in decode_graph.COUNTED]


@pytest.mark.parametrize("name", list(DECODE_LOOPS))
def test_decode_loop_captured_equals_eager(gen, name):
    """Each decode entry point eager, captured (the warm-up step, the
    capture, replays), then replayed from the kept graph, from copies of
    one prefilled cache: the tokens and every cache tensor bit for bit, and
    the same launches counted each time (a replay adds one eager step's)."""
    sparse, b, route, steps, temperature = DECODE_LOOPS[name]
    params, cfg = decode_model(sparse)
    ids = torch.randint(0, 256, (b, LOOP_PROMPT), generator=gen, device="cuda")
    gumbel = torch.rand((LOOP_GEN, b, cfg.vocab_size), generator=gen, device="cuda")
    decode_graph.clear()          # no graph kept from another test
    runs = []
    with torch.inference_mode():
        logits, cache = transformer_prefill(params, cfg, ids, LOOP_MAX_LEN)
        first = logits[:, -1].argmax(-1)
        run = clone_cache(cache)
        for capture in (False, True, True):
            copy_cache(run, cache)
            graphs, before = decode_graph.graph_count(), launch_counts()
            if temperature > 0:
                toks = sample_decode(params, cfg, first, run, gumbel[:LOOP_GEN - 1],
                                     temperature=temperature, route=route, capture=capture)
            else:
                toks = greedy_decode(params, cfg, first, run, LOOP_GEN, route=route,
                                     steps=steps, capture=capture)
            torch.cuda.synchronize()
            ran = [a - b for a, b in zip(launch_counts(), before)]
            runs.append((toks, [x.clone() for lc in run.layers for x in lc], ran,
                         decode_graph.graph_count() - graphs))
    (toks_e, cache_e, ran_e, _), *captured = runs
    assert toks_e.shape == (b, LOOP_GEN) and (sum(ran_e) > 0) == sparse   # the full model: none
    for toks_c, cache_c, ran_c, _ in captured:
        assert torch.equal(toks_c, toks_e)
        assert all(torch.equal(x, y) for x, y in zip(cache_c, cache_e))
        assert ran_c == ran_e
    assert runs[1][3] >= 1 and runs[2][3] == 0      # the third run replays the second's graph


@pytest.mark.parametrize("name", ["split", "fused", "mega", "full"])
def test_captured_decode_step_logits_equal_eager(gen, name):
    """transformer_decode_step at a device position, three steps eager and
    three as one captured graph replayed: the last logits bit for bit (the
    same kernels and ops in the same order)."""
    sparse, b, route, _, _ = DECODE_LOOPS[name]
    params, cfg = decode_model(sparse)
    ids = torch.randint(0, 256, (b, LOOP_PROMPT), generator=gen, device="cuda")
    out = {}
    with torch.inference_mode():
        logits, cache = transformer_prefill(params, cfg, ids, LOOP_MAX_LEN)
        run = clone_cache(cache)

        def body(s):
            lg, _ = transformer_decode_step(params, cfg, s["token"], run, route=route,
                                            pos=s["pos"])
            s["logits"].copy_(lg)
            s["token"].copy_(lg.argmax(-1))
            s["pos"].add_(1)

        for capture in (False, True):
            copy_cache(run, cache)
            state = {"token": logits[:, -1].argmax(-1),
                     "pos": torch.full((), LOOP_PROMPT, dtype=torch.int32, device="cuda"),
                     "logits": torch.zeros_like(logits[:, -1])}
            out[capture] = decode_graph.decode_loop(state, body, 3, reads=(params, run.layers),
                                                    opts=(cfg, route),
                                                    capture=capture)["logits"].clone()
    assert torch.isfinite(out[False]).all()
    assert torch.equal(out[True], out[False])


@pytest.mark.parametrize("name", ["split", "fused", "mega", "mega_sample", "full"])
def test_decode_step_makes_no_host_sync(gen, name):
    """The step each loop captures, run once eagerly (the warm-up) under
    ``set_sync_debug_mode("error")``: no ``.item()``, ``int(tensor)``,
    ``bool(tensor)`` or ``.cpu()`` inside it."""
    sparse, b, route, steps, temperature = DECODE_LOOPS[name]
    params, cfg = decode_model(sparse)
    ids = torch.randint(0, 256, (b, LOOP_PROMPT), generator=gen, device="cuda")
    with torch.inference_mode():
        logits, cache = transformer_prefill(params, cfg, ids, LOOP_MAX_LEN)
        first = logits[:, -1].argmax(-1)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            toks = greedy_decode(params, cfg, first, cache, steps, route=route, steps=steps,
                                 capture=False)
            if temperature > 0:    # the tempered loop's sampling too
                _sample_from_logits(logits[:, -1], temperature, 0.9,
                                    torch.rand_like(logits[:, -1]))
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert toks.shape == (b, steps)


@pytest.mark.parametrize("kind", ["dense", "paged", "split", "tempered"])
def test_engine_window_captured_equals_eager(gen, kind):
    """The serving engine's multi-token window captured against eager:
    every request's tokens equal (at a fixed seed when tempered: the device
    generator is registered with the graph) and the same launches counted;
    no host sync inside a captured window."""
    params, cfg = decode_model(True)
    rs = np.random.RandomState(0)
    reqs = [(rs.randint(32, 127, size=rs.randint(20, 120)).astype(np.int32),
             int(rs.randint(6, 20))) for _ in range(6)]
    kw = dict(max_batch=4, max_len=LOOP_MAX_LEN, prefill_buckets=(64, 128), steps_per_sync=4)
    kw.update({"paged": dict(paged_pool_pages=16, page_tokens=64), "split": dict(route="split"),
               "tempered": dict(temperature=0.8), "dense": {}}[kind])
    real = serve.ragged_decode_multi

    def no_sync_window(*a, **k):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    outs = {}
    try:
        serve.ragged_decode_multi = no_sync_window
        for capture in (False, True):
            before = launch_counts()
            eng = serve.ContinuousBatchingEngine(params, cfg, capture=capture, **kw)
            rids = [eng.add_request(p, max_new_tokens=n) for p, n in reqs]
            with torch.inference_mode():
                done = eng.run()
            torch.cuda.synchronize()
            outs[capture] = ([done[r] for r in rids],
                             [a - b for a, b in zip(launch_counts(), before)])
    finally:
        serve.ragged_decode_multi = real
    for got, want in zip(outs[True][0], outs[False][0]):
        assert np.array_equal(got, want)
    assert outs[True][1] == outs[False][1]


def test_tempered_engines_in_turn_give_the_seeds_tokens(gen):
    """Two captured tempered engines built in turn with one seed, the first
    dropped before the second is made: the same tokens.  Each engine's
    window graph draws from that engine's own device generator: a graph
    kept from the first engine, whose generator is gone (and whose id and
    cache addresses the second engine's may reuse), is not replayed."""
    params, cfg = decode_model(True)
    rs = np.random.RandomState(1)
    reqs = [(rs.randint(32, 127, size=rs.randint(20, 120)).astype(np.int32),
             int(rs.randint(6, 20))) for _ in range(6)]
    decode_graph.clear()
    outs = []
    for _ in range(2):
        eng = serve.ContinuousBatchingEngine(params, cfg, max_batch=4, max_len=LOOP_MAX_LEN,
                                             prefill_buckets=(64, 128), steps_per_sync=4,
                                             temperature=0.8, seed=5)
        rids = [eng.add_request(p, max_new_tokens=n) for p, n in reqs]
        with torch.inference_mode():
            done = eng.run()
        outs.append([done[r] for r in rids])
        del eng, done
        gc.collect()
    assert decode_graph.graph_count() == 2            # one window graph each
    for a, b in zip(*outs):
        assert np.array_equal(a, b)


# ---- the configurations on JAX's XLA decode branches, and the hybrid route ----

# name: (NSA overrides of the reference widths, route); b 9 (the split
# route's batch there), 12 steps from 195 cross the emissions at t = 199
# (stride 8) and t = 207 (stride 16)
CONFIG_LOOPS = {"per_head": (dict(query_heads_share_selected_kv=False), None),
                "stride_eq_block": (dict(compress_block_sliding_stride=16), None),
                "hybrid": ({}, "hybrid")}


def config_model(name):
    overrides, route = CONFIG_LOOPS[name]
    cfg = reference_model_config().replace(depth=2, dtype="bfloat16")
    cfg = cfg.replace(nsa=dataclasses.replace(cfg.nsa, **overrides))
    params = tree_to(init_transformer(cfg, torch.Generator().manual_seed(0), device="cuda"),
                     dtype=torch.bfloat16)
    return fuse_decode_params(params, cfg), cfg, route


def config_launches(name, cfg, steps):
    """Each counted wrapper's launches on ``name``'s decode path: row 11 a
    layer a step at stride == block, none per head, rows 2 and 7 a layer a
    step on the hybrid route."""
    want = [0] * len(decode_graph.COUNTED)
    per_step = {"per_head": (), "stride_eq_block": (paged_gather.paged_gather,),
                "hybrid": (nsa_decode.decode_select, nsa_decode_fused.decode_attend_fused)}[name]
    for fn in per_step:
        want[decode_graph.COUNTED.index(fn)] = cfg.depth * steps
    return want


@pytest.mark.parametrize("name", list(CONFIG_LOOPS))
def test_config_decode_loops_captured_equal_eager(gen, name):
    """greedy_decode on each new path eager (under ``set_sync_debug_mode(
    "error")``: no host sync in the step), captured and replayed from copies
    of one prefilled cache: tokens and every cache tensor bit for bit, the
    launches each path makes and no other."""
    params, cfg, route = config_model(name)
    b = 9
    ids = torch.randint(0, 256, (b, LOOP_PROMPT), generator=gen, device="cuda")
    decode_graph.clear()
    runs = []
    with torch.inference_mode():
        logits, cache = transformer_prefill(params, cfg, ids, LOOP_MAX_LEN)
        first = logits[:, -1].argmax(-1)
        run = clone_cache(cache)
        for capture in (False, True, True):
            copy_cache(run, cache)
            before = launch_counts()
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("default" if capture else "error")
            try:
                toks = greedy_decode(params, cfg, first, run, LOOP_GEN, route=route,
                                     capture=capture)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            runs.append((toks, [x.clone() for lc in run.layers for x in lc],
                         [a - b for a, b in zip(launch_counts(), before)]))
    toks_e, cache_e, ran_e = runs[0]
    assert ran_e == config_launches(name, cfg, LOOP_GEN)
    for toks_c, cache_c, ran_c in runs[1:]:
        assert torch.equal(toks_c, toks_e)
        assert all(torch.equal(x, y) for x, y in zip(cache_c, cache_e))
        assert ran_c == ran_e


@pytest.mark.parametrize("name", list(CONFIG_LOOPS))
def test_config_decode_steps_kernels_match_plain(gen, name, monkeypatch):
    """Three steps of each new path through the kernels against the plain
    versions from copies of one cache, teacher-forced on the plain tokens,
    within chip_smoke.py's 2% of the logits' scale; row 11's gathered
    blocks on the path bit for bit ``paged_gather_plain``; the hybrid
    route's logits against the split route's within the same 2%."""
    params, cfg, route = config_model(name)
    b = 16
    ids = torch.randint(0, 256, (b, LOOP_PROMPT), generator=gen, device="cuda")
    gathers = []
    real = nsa_layer.paged_gather
    monkeypatch.setattr(nsa_layer, "paged_gather", lambda kv, idx, Bs: gathers.append(
        (real(kv, idx, Bs), paged_gather.paged_gather_plain(kv, idx, Bs))) or gathers[-1][0])
    with torch.inference_mode():
        logits, cache = transformer_prefill(params, cfg, ids, LOOP_MAX_LEN)
        token = logits[:, -1].argmax(-1)
        plain, split = clone_cache(cache), clone_cache(cache)
        for _ in range(3):
            got, cache = transformer_decode_step(params, cfg, token, cache, route=route)
            want, plain = transformer_decode_step(params, cfg, token, plain, route=route,
                                                  use_kernels=False)
            assert torch.isfinite(got).all()
            assert max_err(got, want) <= 0.02 * max(want.abs().max().item(), 1.0)
            if route == "hybrid":
                other, split = transformer_decode_step(params, cfg, token, split, route="split")
                assert max_err(got, other) <= 0.02 * max(other.abs().max().item(), 1.0)
            token = want.argmax(-1)
    assert len(gathers) == (3 * cfg.depth if name == "stride_eq_block" else 0)
    assert all(torch.equal(k, p) for k, p in gathers)


def mesh_kernel_rank(ids):
    """One of 4 gloo ranks on cuda:0 (``test_mesh_kernel_path``): the 2 x 2
    mesh's training step and one decode step on the kernels, with the
    kernels' launches."""
    from nsa_tpu_torch.ops.cuda import runtime
    from nsa_tpu_torch.parallel import sharding
    from nsa_tpu_torch.parallel import train_step as pstep
    from nsa_tpu_torch.parallel.mesh import make_mesh, rank_device
    from nsa_tpu_torch.train.pretrain import make_optimizer
    from nsa_tpu_torch.config import TrainConfig

    dev = rank_device("cuda")
    runtime.require_built()
    cfg = reference_model_config().replace(depth=2, dtype="bfloat16")
    mesh = make_mesh(2, 2)
    full = init_transformer(cfg, torch.Generator().manual_seed(0), device="cpu")
    params = pstep.shard_trainable(full, mesh, cfg, dev)
    opt = make_optimizer(TrainConfig(), params)
    counted = (nsa_prefill.prefill_fwd, nsa_prefill.prefill_bwd_dq, nsa_prefill.prefill_bwd_dkv,
               nsa_decode.decode_select, nsa_decode.decode_attend)
    ids = ids.to(dev)
    loss = float(pstep.sharded_train_step(params, opt, ids[None], cfg, 1, mesh))
    lcfg = sharding.local_config(cfg, mesh)
    local = tree_to(sharding.shard_params(full, mesh, cfg), dev, torch.bfloat16)
    with torch.inference_mode(), mesh:
        logits, cache = transformer_prefill(local, lcfg, sharding.shard_batch(ids[:, :-1], mesh),
                                            1024)
        step, _ = transformer_decode_step(local, lcfg, logits[:, -1].argmax(-1), cache)
    torch.cuda.synchronize()
    return loss, step.float().cpu(), mesh.coords, {fn.__name__: fn.launches for fn in counted}


def test_mesh_kernel_path(gen, tmp_path):
    """The 2 x 2 (data, heads) mesh on the one card, 4 gloo ranks on cuda:0
    (NCCL refuses two ranks on one device): the training step's loss within
    2e-3 of the single process's (bf16 sums over heads in another order,
    chip_smoke.py's loss gate) and the first decode step's logits within
    2% of max |logit| (the logits gate), each rank launching rows 1, 4, 5
    once a layer and rows 2-3 once a layer (2 heads of each rank's 4 at
    2 KV heads)."""
    from nsa_tpu_torch.config import TrainConfig
    from nsa_tpu_torch.ops.cuda import runtime
    from nsa_tpu_torch.parallel.mesh import run_ranks
    from nsa_tpu_torch.train.pretrain import make_optimizer, train_step

    runtime.library()                    # built once here; the ranks only load it
    cfg = reference_model_config().replace(depth=2, dtype="bfloat16")
    ids = torch.randint(0, 256, (4, 513), generator=gen, device="cuda")
    full = init_transformer(cfg, torch.Generator().manual_seed(0), device="cpu")
    params = trainable(full, "cuda")
    want_loss = float(train_step(params, make_optimizer(TrainConfig(), params), ids[None], cfg, 1))
    with torch.inference_mode():
        bf = tree_to(full, "cuda", torch.bfloat16)
        logits, cache = transformer_prefill(bf, cfg, ids[:, :-1], 1024)
        want, _ = transformer_decode_step(bf, cfg, logits[:, -1].argmax(-1), cache,
                                          route="split")
    results = run_ranks(mesh_kernel_rank, 4, "gloo", (ids.cpu(),), timeout_s=300,
                        workdir=str(tmp_path))
    for loss, step, (data, _), launches in results:
        assert abs(loss - want_loss) <= 2e-3 * abs(want_loss)
        rows = want[2 * data:2 * data + 2].float().cpu()
        assert max_err(step, rows) <= 0.02 * max(rows.abs().max().item(), 1.0)
        assert launches == {"prefill_fwd": 2 * cfg.depth, "prefill_bwd_dq": cfg.depth,
                            "prefill_bwd_dkv": cfg.depth, "decode_select": cfg.depth,
                            "decode_attend": cfg.depth}
