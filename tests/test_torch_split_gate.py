"""The element-by-element rules that hold the split route's decode kernels
(rows 2 and 3: ``decode_select``, ``decode_attend``) to their plain
versions, on the CPU, at a small size and at the reference model's widths.

``select_tolerance`` holds row 2's c_out: 2^-7 of |plain| (float32 softmax
weights, rounded once to bf16 as the kernel rounds) plus 2^-15 of the same
softmax's weighted sum over |v|.  A c_out whose float32 weights are summed
at another precision passes it; one with the first 64 live rows left out
(``without_live_chunk``, the kernels-phase control) fails it, and so does
the XLA path's c_out (``decode_select_plain``), whose weights are rounded
to bf16 before P.V: the rule tells a kernel that rounded its weights from
one that did not.  ``attend_tolerance`` holds row 3's output on the split
route's own inputs (the dense cache, the plain selection's info row and
c_out): the combine with its weights summed at another precision passes,
and the plain version with each row's first selected block left out
(``without_first_selected``) fails.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from nsa_tpu_torch.ops.cuda import nsa_decode, nsa_decode_ragged
from nsa_tpu_torch.ops.nsa import _ckv_width

# (b, kvh, g, max_len, t): a small cache, and the reference model's widths
# at the serving cell's last position (4 KV heads, G 2, 4096 rows, t 3999)
SIZES = {"small": (3, 2, 2, 1024, 1000), "reference": (2, 4, 2, 4096, 3999)}
D, M, STRIDE, BS, WINDOW, NUM_SEL = 64, 1, 8, 16, 64, 4
N_SLIDE = -(-WINDOW // BS) + 1
SCALE = D ** -0.5


def bf16(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)


def split_inputs(size, seed=0):
    b, kvh, g, max_len, t = SIZES[size]
    rng = np.random.default_rng(seed)
    Wc = _ckv_width(max_len, STRIDE, BS // STRIDE)
    q, ckv, mem_kv = bf16(rng, b, kvh, g, D), bf16(rng, b, kvh, Wc, 2 * D), bf16(rng, 2, kvh, M, D)
    rq, kv = bf16(rng, b, kvh, g, D), bf16(rng, b, kvh, max_len, 2 * D)
    gates = torch.sigmoid(bf16(rng, b, kvh, g, 3).float()).to(torch.bfloat16)
    return dict(q=q, ckv=ckv, mem_kv=mem_kv, rq=rq, kv=kv, gates=gates, t=t, num_cb=t // STRIDE,
                max_blocks=max_len // BS)


def worst(got, want, tol):
    return ((got.float() - want.float()).abs() / tol).max().item()


def select_rule(x):
    return nsa_decode_ragged.select_tolerance(x["q"], x["ckv"], x["mem_kv"], x["t"], x["num_cb"],
                                              stride=STRIDE, sel_block=BS, scale=SCALE)


def c_out(x, ckv=None, num_cb=None, weights_dtype=torch.float32):
    ckv = x["ckv"] if ckv is None else ckv
    num_cb = x["num_cb"] if num_cb is None else num_cb
    c, _ = nsa_decode.select_scores_plain(x["q"], ckv, x["mem_kv"], num_cb, x["t"],
                                          stride=STRIDE, sel_block=BS, scale=SCALE,
                                          weights_dtype=weights_dtype)
    return c


@pytest.mark.parametrize("size", sorted(SIZES))
def test_select_tolerance_holds_float32_weights_summed_otherwise(size):
    x = split_inputs(size)
    want, tol = select_rule(x)
    assert want.dtype == torch.bfloat16 and want.shape == x["q"].shape
    assert torch.isfinite(want.float()).all() and (tol > 0).all()
    assert worst(c_out(x, weights_dtype=torch.float64), want, tol) <= 1.0


@pytest.mark.parametrize("size", sorted(SIZES))
def test_select_tolerance_fails_the_dropped_chunk_control(size):
    x = split_inputs(size)
    want, tol = select_rule(x)
    moved, live = nsa_decode_ragged.without_live_chunk(x["ckv"], x["num_cb"])
    assert live == x["num_cb"] - 64 and moved.shape == x["ckv"].shape
    assert torch.equal(moved[:, :, :live], x["ckv"][:, :, 64:x["num_cb"]])
    assert worst(c_out(x, moved, live), want, tol) > 1.0


@pytest.mark.parametrize("size", sorted(SIZES))
def test_select_tolerance_tells_bf16_weights_from_float32(size):
    """The XLA path (``decode_select_plain``: weights rounded to bf16 before
    P.V) agrees with the float32-weight c_out to the old 0.03 but breaks
    ``select_tolerance``; its selection is the same."""
    x = split_inputs(size)
    want, tol = select_rule(x)
    kw = dict(max_blocks=x["max_blocks"], stride=STRIDE, sel_block=BS, num_sel=NUM_SEL,
              n_slide=N_SLIDE, scale=SCALE)
    c_x, info_x = nsa_decode.decode_select_plain(x["q"], x["ckv"], x["mem_kv"], x["t"],
                                                 x["num_cb"], **kw)
    c_f, info_f = nsa_decode.decode_select_plain(x["q"], x["ckv"], x["mem_kv"], x["t"],
                                                 x["num_cb"], weights_dtype=torch.float32, **kw)
    assert torch.equal(c_f, want) and torch.equal(info_x, info_f)
    assert (c_x.float() - want.float()).abs().max().item() <= 0.03
    assert worst(c_x, want, tol) > 1.0


def attend_case(size):
    x = split_inputs(size)
    kw = dict(max_blocks=x["max_blocks"], stride=STRIDE, sel_block=BS, num_sel=NUM_SEL,
              n_slide=N_SLIDE, scale=SCALE)
    c, info = nsa_decode.decode_select_plain(x["q"], x["ckv"], x["mem_kv"], x["t"], x["num_cb"],
                                             **kw)
    akw = dict(sel_block=BS, window=WINDOW, num_sel=NUM_SEL, n_slide=N_SLIDE, scale=SCALE)
    return x, c, info, akw


@pytest.mark.parametrize("size", sorted(SIZES))
def test_attend_tolerance_on_the_split_route(size):
    x, c, info, akw = attend_case(size)
    want, tol = nsa_decode_ragged.attend_tolerance(x["rq"], x["kv"], info, c, x["gates"], x["t"],
                                                   **akw)
    assert want.shape == x["rq"].shape and torch.isfinite(want.float()).all()
    other = nsa_decode.attend_combined_plain(x["rq"], x["kv"], info, c, x["gates"], x["t"],
                                             weights_dtype=torch.float64, **akw)
    assert worst(other.to(torch.bfloat16), want, tol) <= 1.0
    # the XLA path's output (bf16 weights) stays within the old 0.03
    xla = nsa_decode.decode_attend_plain(x["rq"], x["kv"], info, c, x["gates"], x["t"], **akw)
    assert (xla.float() - want.float()).abs().max().item() <= 0.03


@pytest.mark.parametrize("size", sorted(SIZES))
def test_attend_tolerance_fails_the_dropped_block_control_on_the_split_route(size):
    x, c, info, akw = attend_case(size)
    v0 = NUM_SEL + N_SLIDE
    assert info[..., v0:v0 + NUM_SEL].any()
    want, tol = nsa_decode_ragged.attend_tolerance(x["rq"], x["kv"], info, c, x["gates"], x["t"],
                                                   **akw)
    dropped = nsa_decode_ragged.without_first_selected(info, NUM_SEL, N_SLIDE)
    wrong, _ = nsa_decode_ragged.attend_tolerance(x["rq"], x["kv"], dropped, c, x["gates"],
                                                  x["t"], **akw)
    assert worst(wrong, want, tol) > 1.0
