"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: they need an NVIDIA GPU with the CUDA toolkit (``nvcc``)
and skip elsewhere; whether a card exists is decided inside the fixture, so
every worker collects the same tests.  This file imports neither JAX nor
nsa_tpu (the card's machine has neither).  Run there with

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda_kernels.py

(``--noconftest`` because tests/conftest.py configures JAX.)

Shapes are small but keep the kernels' dim_head of 64.  Tolerances are
stated in bf16: the plain versions round softmax weights and outputs to
bf16 (unit roundoff 2^-9) where the kernels keep float32, so outputs agree
to 0.03 absolute on values of order 1-5; log-sum-exps are float32 both
ways (1e-3).  The backward kernels and their plain versions both compute in
float32 and round dq, dk, dv to bf16 at the end: one bf16 ulp of the
largest value (2^-7 of it); d_gates and the deltas stay float32 (1e-4 of
the largest value: sum order and expf).  The fused decode kernels and their
plain versions round at the same points (the emitted ckv row, the combined
attention output, the layer's y, the FF's hidden row and output) from
float32 sums taken in another order, so a rounding can flip by one ulp and
carry one more ulp downstream: 2^-6 of the largest value (two bf16 ulps);
the ring shift and the kv row write are copies, bit-equal.  The ragged
and paged decode kernels are held to the same 2^-6; the paged attend
kernel equals the ragged one bit for bit on the same logical cache, and
the block gather is a copy.  The flash attention kernel rounds its softmax
weights to bf16 for the P.V product, where its plain version keeps them
float32, and both round the output once: element by element, 2^-7 of the
plain output plus 2^-8 of the same attention over |v|
(``flash.flash_attention_tolerance``: each term twice its source).
"""

import pytest
import torch

from nsa_tpu_torch import reference_model_config
from nsa_tpu_torch.eval.efficiency import clone_cache
from nsa_tpu_torch.models.transformer import (
    fuse_decode_params,
    init_transformer,
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


@pytest.mark.parametrize("G,n,S", [(2, 300, 4), (1, 77, 2), (4, 130, 16)])
def test_prefill_kernel_matches_plain(gen, G, n, S):
    b, kvh, d, Bs, window = 2, 2, 64, 16, 64
    rq, rk, v = randn(gen, b, kvh * G, n, d), randn(gen, b, kvh, n, d), randn(gen, b, kvh, n, d)
    W = -(-n // Bs)
    sel_idx = torch.randint(0, W, (b, kvh, n, S), generator=gen, device="cuda",
                            dtype=torch.int32)
    sel_mask = torch.rand((b, kvh, n, S), generator=gen, device="cuda") < 0.7
    args = (rq, rk, v, sel_idx, sel_mask, Bs, window, 0.125)
    before = nsa_prefill.prefill_fwd.launches
    got = nsa_prefill.prefill_fwd(*args)
    want = nsa_prefill.fine_sliding_plain(*args)
    torch.cuda.synchronize()
    assert nsa_prefill.prefill_fwd.launches == before + 1
    assert max_err(got[0], want[0]) <= TOL_OUT and max_err(got[1], want[1]) <= TOL_OUT
    assert max_err(got[2], want[2]) <= TOL_LSE and max_err(got[3], want[3]) <= TOL_LSE


@pytest.mark.parametrize("G,n,S", [(2, 300, 4), (1, 77, 2), (4, 130, 16), (8, 64, 3)])
def test_prefill_backward_kernels_match_plain(gen, G, n, S):
    """Random selections with duplicates, own-block and future slots."""
    b, kvh, d, Bs, window, scale = 2, 2, 64, 16, 64, 0.125
    rq, rk, v = randn(gen, b, kvh * G, n, d), randn(gen, b, kvh, n, d), randn(gen, b, kvh, n, d)
    sel_idx = torch.randint(0, -(-n // Bs), (b, kvh, n, S), generator=gen, device="cuda",
                            dtype=torch.int32)
    sel_mask = torch.rand((b, kvh, n, S), generator=gen, device="cuda") < 0.7
    sel = (rq, rk, v, sel_idx, sel_mask)
    fo, so, flse, slse = nsa_prefill.prefill_fwd(*sel, Bs, window, scale)
    dfo, dso = randn(gen, b, kvh * G, n, d), randn(gen, b, kvh * G, n, d)
    dq_args = (*sel, fo, so, flse, slse, dfo, dso, Bs, window, scale)
    before = (nsa_prefill.prefill_bwd_dq.launches, nsa_prefill.prefill_bwd_dkv.launches)
    got_q = nsa_prefill.prefill_bwd_dq(*dq_args)
    want_q = nsa_prefill.prefill_bwd_dq_plain(*dq_args)
    dkv_args = (*sel, flse, slse, want_q[2], want_q[3], dfo, dso, Bs, window, scale)
    got_kv = nsa_prefill.prefill_bwd_dkv(*dkv_args)
    want_kv = nsa_prefill.prefill_bwd_dkv_plain(*dkv_args)
    again = nsa_prefill.prefill_bwd_dkv(*dkv_args)
    torch.cuda.synchronize()
    assert (nsa_prefill.prefill_bwd_dq.launches,
            nsa_prefill.prefill_bwd_dkv.launches) == (before[0] + 1, before[1] + 2)
    for x, y, tol in zip((*got_q, *got_kv), (*want_q, *want_kv),
                         (2.0 ** -7, 1e-4, 1e-4, 1e-4, 2.0 ** -7, 2.0 ** -7)):
        assert max_err(x, y) <= tol * y.float().abs().max().item()
    assert torch.equal(got_kv[0], again[0]) and torch.equal(got_kv[1], again[1])


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
    c_k, info_k = nsa_decode.decode_select(q, ckv, mem_kv, t, t // stride, **kw)
    c_p, info_p = nsa_decode.decode_select_plain(q, ckv, mem_kv, t, t // stride, **kw)
    torch.cuda.synchronize()
    assert max_err(c_k, c_p) <= TOL_OUT
    assert torch.equal(info_k, info_p)   # random scores: no ties

    rq, kv = randn(gen, b, kvh, g, d), randn(gen, b, kvh, max_len, 2 * d)
    gates = torch.rand((b, kvh, g, 3), generator=gen, device="cuda").to(torch.bfloat16)
    akw = dict(sel_block=Bs, window=window, num_sel=num_sel, n_slide=n_slide, scale=0.125)
    out_k = nsa_decode.decode_attend(rq, kv, info_p, c_p, gates, t, **akw)
    out_p = nsa_decode.decode_attend_plain(rq, kv, info_p, c_p, gates, t, **akw)
    torch.cuda.synchronize()
    assert max_err(out_k, out_p) <= TOL_OUT


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
def test_decode_select_emit_kernel_matches_plain(gen, t):
    """t = 7 and 199 emit (stride 8), t = 7 over a window that starts
    before position 0; t = 200 and 1023 do not."""
    b, kvh, g, d, M, Bc, hid = 3, 2, 2, 64, 1, 16, 128
    stride, Bs, window, num_sel, max_len = 8, 16, 64, 4, 1024
    n_slide = -(-window // Bs) + 1
    Wc = _ckv_width(max_len, stride, Bs // stride)
    q, ckv, mem_kv = randn(gen, b, kvh, g, d), randn(gen, b, kvh, Wc, 2 * d), randn(gen, 2, kvh, M, d)
    ring, kv_new = randn(gen, b, kvh, Bc, 2 * d), randn(gen, b, kvh, 1, 2 * d)
    weights = fused_weights(gen, kvh, Bc, d, hid)
    kw = dict(max_blocks=max_len // Bs, stride=stride, sel_block=Bs, num_sel=num_sel,
              n_slide=n_slide, scale=0.125)
    caches = [(ckv.clone(), ring.clone()) for _ in range(2)]
    before = nsa_decode_fused.decode_select_emit.launches
    c_k, info_k = nsa_decode_fused.decode_select_emit(q, caches[0][0], caches[0][1], kv_new,
                                                      mem_kv, *weights, t, t // stride, **kw)
    c_p, info_p = nsa_decode_fused.decode_select_emit_plain(
        q, caches[1][0], caches[1][1], kv_new, mem_kv, *weights, t, t // stride, **kw)
    torch.cuda.synchronize()
    assert nsa_decode_fused.decode_select_emit.launches == before + 1
    assert max_err(c_k, c_p) <= TOL_OUT
    assert torch.equal(info_k, info_p)   # random scores: no ties
    assert torch.equal(caches[0][1], caches[1][1])
    assert torch.equal(caches[0][1][:, :, -1:], kv_new)
    slot = t // stride
    for ckv_k in (caches[0][0], caches[1][0]):     # no other row changes
        assert torch.equal(torch.cat([ckv_k[:, :, :slot], ckv_k[:, :, slot + 1:]], 2),
                           torch.cat([ckv[:, :, :slot], ckv[:, :, slot + 1:]], 2))
    row_k, row_p = caches[0][0][:, :, slot], caches[1][0][:, :, slot]
    if (t + 1) % stride:
        assert torch.equal(row_k, ckv[:, :, slot]) and torch.equal(row_p, ckv[:, :, slot])
    else:
        assert not torch.equal(row_p, ckv[:, :, slot])
        assert max_err(row_k, row_p) <= TOL_FUSED * row_p.float().abs().max().item()


@pytest.mark.parametrize("with_ff", [True, False])
@pytest.mark.parametrize("t,b", [(0, 1), (200, 3), (1023, 9)])
def test_decode_attend_fused_kernel_matches_plain(gen, t, b, with_ff):
    """b = 9 takes two passes of the kernels' 8-row batch groups."""
    kvh, g, d, stride, Bs, window, num_sel, max_len = 2, 2, 64, 8, 16, 64, 4, 1024
    dim, hid4 = 256, 512
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
    kv_k, kv_p = kv.clone(), kv.clone()
    before = nsa_decode_fused.decode_attend_fused.launches
    out_k = nsa_decode_fused.decode_attend_fused(rq, kv_k, kv_new, info, c_out, gates, x, w_out,
                                                 t, ff, **akw)
    out_p = nsa_decode_fused.decode_attend_fused_plain(rq, kv_p, kv_new, info, c_out, gates, x,
                                                       w_out, t, ff, **akw)
    torch.cuda.synchronize()
    assert nsa_decode_fused.decode_attend_fused.launches == before + 1
    assert out_k.shape == (b, 1, dim) and torch.isfinite(out_k.float()).all()
    assert max_err(out_k, out_p) <= TOL_FUSED * out_p.float().abs().max().item()
    assert torch.equal(kv_k, kv_p) and torch.equal(kv_k[:, :, t], kv_new[:, :, 0])
    assert torch.equal(torch.cat([kv_k[:, :, :t], kv_k[:, :, t + 1:]], 2),
                       torch.cat([kv[:, :, :t], kv[:, :, t + 1:]], 2))


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


@pytest.mark.parametrize("b", [3, 9])
def test_decode_step_mega_kernel_matches_plain(gen, b):
    """Two layers at the reference widths, random weights from a seed, at
    t = 199 (emits) and 200: the whole-model kernel against its plain
    version, logits within 2^-6 of the largest, the in-kernel argmax
    equal except at near-ties, and every cache row but the step's own
    bit-equal (b = 9 takes two of the kernel's 8-row groups); then one
    launch of 4 greedy tokens against 4 launches of one, bit for bit."""
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
            got, tok_k, *_ = transformer_decode_step_mega(mp, cfg, token, *kern, t, greedy=True)
            want, tok_p, *_ = transformer_decode_step_mega(mp, cfg, token, *plain, t, greedy=True,
                                                           use_kernels=False)
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


def test_paged_gather_kernel_matches_plain(gen):
    b, kvh, L, Bs, S = 5, 4, 1024, 16, 9
    cache = randn(gen, b, kvh, L, 128)
    idx = torch.randint(0, L // Bs, (b, kvh, S), generator=gen, device="cuda").int()
    before = paged_gather.paged_gather.launches
    got = paged_gather.paged_gather(cache, idx, Bs)
    torch.cuda.synchronize()
    assert paged_gather.paged_gather.launches == before + 1
    assert torch.equal(got, paged_gather.paged_gather_plain(cache, idx, Bs))


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
