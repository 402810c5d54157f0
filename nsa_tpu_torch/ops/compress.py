"""KV compression: the overlapping window split and the compressor zoo
(``nsa_tpu/ops/compress.py``).

Every compressor maps windows ``[b, h, w, n, d] -> [b, h, w, d]``:

* ``mlp``        GroupedMLP, a per-head two-layer MLP over the flattened window;
* ``conv``       a grouped Conv1d, one d x d x n kernel per head;
* ``attn``       attention pooling over the window, identity-initialised logits;
* ``mean``       the parameter-free mean over the window;
* ``shared_mlp`` one two-layer MLP shared by every head;
* ``single``     one projection of the flattened window;
* ``transformer`` a two-layer pre-norm transformer over the window's tokens,
                 heads mixed into one width ``h * d``, last-token readout.

Parameters keep the JAX package's layout and distributions (fan-in uniform
weights; see ``init_compressor``), and each kind rounds where JAX's does.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

TRANSFORMER_LAYERS = 2


def split_compress_windows(kv: torch.Tensor, block_size: int, stride: int) -> torch.Tensor:
    """[b, h, n, d] -> [b, h, w, block_size, d] overlapping windows.

    ``n`` must be divisible by ``stride``; window ``i`` covers positions
    ``[i*stride - (block - stride), i*stride + stride)`` with left zero
    padding, so window ``i`` ends at position ``(i+1)*stride - 1``.
    """
    b, h, n, d = kv.shape
    if n % stride:
        raise ValueError(f"length {n} is not a multiple of the stride {stride}")
    pad = block_size - stride
    if pad:
        kv = F.pad(kv, (0, 0, pad, 0))
    return kv.unfold(2, block_size, stride).transpose(-1, -2)


def init_compressor(nsa, kv_heads: int, dim_head: int, generator: torch.Generator) -> dict:
    """One compressor's parameters (called twice: K and V) on the CPU, in
    ``nsa_tpu.ops.compress.init_compressor``'s layout and distributions (the
    numbers differ from JAX's for the same seed)."""
    block, kind = nsa.compress_block_size, nsa.compressor

    def uniform(shape, fan_in):
        bound = 1.0 / fan_in ** 0.5
        return (torch.rand(shape, generator=generator) * 2 - 1) * bound

    dim_in = dim_head * block
    hidden = int(dim_in * nsa.compress_mlp_expand_factor)
    if kind == "mean":
        return {}
    if kind == "mlp":
        return {"w1": uniform((kv_heads, dim_in, hidden), dim_in),
                "b1": uniform((kv_heads, hidden), dim_in),
                "w2": uniform((kv_heads, hidden, dim_head), hidden),
                "b2": uniform((kv_heads, dim_head), hidden)}
    if kind == "conv":          # w [h, d_out, d_in, block]
        return {"w": uniform((kv_heads, dim_head, dim_head, block), dim_in),
                "b": uniform((kv_heads, dim_head), dim_in)}
    if kind == "attn":
        return {"w_logits": torch.eye(dim_head)}
    if kind == "shared_mlp":
        return {"w1": uniform((dim_in, hidden), dim_in), "b1": uniform((hidden,), dim_in),
                "w2": uniform((hidden, dim_head), hidden), "b2": uniform((dim_head,), hidden)}
    if kind == "single":
        return {"w": uniform((dim_in, dim_head), dim_in)}
    if kind == "transformer":
        dim = kv_heads * dim_head
        ff = dim * 4
        layers = []
        for _ in range(TRANSFORMER_LAYERS):
            layer = {"norm1": torch.ones(dim), "norm2": torch.ones(dim)}
            for name in ("q", "k", "v", "o"):
                layer[f"w_{name}"] = uniform((dim, dim), dim)
                layer[f"b_{name}"] = torch.zeros(dim) if name == "o" else uniform((dim,), dim)
            layer.update({"w_f1": uniform((dim, ff), dim), "b_f1": torch.zeros(ff),
                          "w_f2": uniform((ff, dim), ff), "b_f2": torch.zeros(dim)})
            layers.append(layer)
        return {"layers": layers}
    raise ValueError(f"unknown compressor {kind!r}")


def apply_compressor(params: Dict[str, torch.Tensor], kind: str, kv: torch.Tensor) -> torch.Tensor:
    """Compress windows: [b, h, w, n, d] -> [b, h, w, d] in kv's dtype.

    Rounding as in the JAX package: ``mlp`` and ``conv`` take their products
    in float32 from operands in the working dtype (``_ProductF32``), add
    their biases in float32 and round each layer's output once to the
    working dtype;
    ``shared_mlp`` and ``single`` stay in the working dtype; ``attn`` takes
    its softmax over the window axis of float32 logits, one weight per
    output dim."""
    b, h, w, n, d = kv.shape
    dtype = kv.dtype
    if kind == "mean":
        return kv.mean(dim=-2)
    if kind == "mlp":
        hid = _per_head_f32(kv.reshape(b, h, w, n * d), params["w1"].to(dtype))
        hid = torch.relu(hid + params["b1"].float()[None, :, None, :]).to(dtype)
        out = _per_head_f32(hid, params["w2"].to(dtype))
        return (out + params["b2"].float()[None, :, None, :]).to(dtype)
    if kind == "conv":
        # w [h, d_out, d_in, n] as [h, (n d_in), d_out], the flattened window's order
        wt = params["w"].to(dtype).permute(0, 3, 2, 1).reshape(h, n * d, -1)
        out = _per_head_f32(kv.reshape(b, h, w, n * d), wt)
        return (out + params["b"].float()[None, :, None, :]).to(dtype)
    if kind == "attn":
        logits = torch.einsum("bhwnd,de->bhwne", kv.float(), params["w_logits"].to(dtype).float())
        weights = torch.softmax(logits, dim=-2).to(dtype)
        return torch.einsum("bhwnd,bhwnd->bhwd", kv, weights)
    if kind == "shared_mlp":
        flat = kv.reshape(b, h, w, n * d)
        hid = torch.relu(flat @ params["w1"].to(dtype) + params["b1"].to(dtype))
        return hid @ params["w2"].to(dtype) + params["b2"].to(dtype)
    if kind == "single":
        return kv.reshape(b, h, w, n * d) @ params["w"].to(dtype)
    if kind == "transformer":
        return _compress_transformer(params, kv)
    raise ValueError(f"unknown compressor {kind!r}")


class _ProductF32(torch.autograd.Function):
    """``a @ b`` for [h, m, k] x [h, k, n] operands in the working dtype as a
    float32 product: each term exact, summed in float32 (JAX's
    ``preferred_element_type=float32``), the rounding left to the caller.
    On the card a bf16 product with a float32 output (the tensor cores); on
    the CPU the same values in float32.  The backward takes the cotangent in
    the operands' dtype, as a product in that dtype would."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if a.is_cuda and a.dtype != torch.float32:
            return torch.bmm(a, b, out_dtype=torch.float32)
        return torch.bmm(a.float(), b.float())

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        return (g @ b.transpose(1, 2) if ctx.needs_input_grad[0] else None,
                a.transpose(1, 2) @ g if ctx.needs_input_grad[1] else None)


def _per_head_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[b, h, w, i] x [h, i, o] -> [b, h, w, o] float32 (``_ProductF32``)."""
    b, h, nw, i = x.shape
    out = _ProductF32.apply(x.transpose(0, 1).reshape(h, b * nw, i), w)
    return out.reshape(h, b, nw, -1).transpose(0, 1)


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    return (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
            * scale.float()).to(x.dtype)


def _linear(x: torch.Tensor, p: dict, name: str) -> torch.Tensor:
    return x @ p[f"w_{name}"].to(x.dtype) + p[f"b_{name}"].to(x.dtype)


def _compress_transformer(params, kv: torch.Tensor) -> torch.Tensor:
    """The window's tokens [(b w), n, h d] through pre-norm attention + GELU
    FF layers (its own RMS norm, eps 1e-6; exact GELU; float32 logits,
    softmax weights in the working dtype), the last layer's FF on the last
    token only, which is the output."""
    b, h, w, n, d = kv.shape
    x = kv.permute(0, 2, 3, 1, 4).reshape(b * w, n, h * d)

    def attn(p, inp):
        bw = inp.shape[0]

        def heads(t):
            return t.reshape(bw, n, h, d).transpose(1, 2)

        q, k, v = (heads(_linear(inp, p, name)) for name in ("q", "k", "v"))
        sim = torch.einsum("bhid,bhjd->bhij", q.float(), k.float()) * d ** -0.5
        o = torch.softmax(sim, dim=-1).to(inp.dtype) @ v
        return _linear(o.transpose(1, 2).reshape(bw, n, h * d), p, "o")

    def ff(p, inp):
        return _linear(F.gelu(_linear(inp, p, "f1")), p, "f2")

    *layers, last = params["layers"]
    for p in layers:
        x = x + attn(p, _rms(x, p["norm1"]))
        x = x + ff(p, _rms(x, p["norm2"]))
    x = x + attn(last, _rms(x, last["norm1"]))
    tok = x[:, -1]
    tok = tok + ff(last, _rms(tok, last["norm2"]))
    return tok.reshape(b, w, h, d).transpose(1, 2)
