"""Byte-level GPT with native sparse or full attention
(``nsa_tpu/models/transformer.py``).

token embed -> depth x (attention + prenorm FF) -> RMSNorm -> logits.  The
FF is the byte-GPT's GELU block with biases or, for ``ff_kind ==
"swiglu"`` (the HF Llama teacher of ``models/llama_import.py``), Llama's
SwiGLU block without biases.
The model is plain functions over a params dict in the JAX package's layout
(see ``utils/checkpoint.py``); the decode cache is a ``ModelCache``
threaded through ``transformer_decode_step``.

The sparse model's decode step takes one of three routes, as in the JAX
package: at b <= 8 the whole-model kernel ``decode_step_mega`` (one launch
for all layers, JAX's default there, ``use_mega_decode``); with
``NSA_MEGA_DECODE=0`` the fused pair ``decode_select_emit`` +
``decode_attend_fused`` per layer; above b = 8 the split pair
``decode_select`` + ``decode_attend`` per layer (the hybrid route,
``decode_select`` + ``decode_attend_fused``, under
``NSA_HYBRID_DECODE``).  The serving engine's ragged step
(``transformer_decode_step_ragged``, one position per row) takes the
ragged fused pair per layer.  The configurations the kernels do not take
(per-head selection, ``selection_block_size == stride``) decode on JAX's
XLA branches per layer at every batch size, and train on its XLA path
(``ops/nsa.py``).

The full-attention baseline (``use_sparse_attn=False``) runs its prefill
and forward attention through the ``flash_attention`` kernel
(``ops/cuda/flash.py``), trains through the plain chunked attention with
each query chunk recomputed in the backward (the kernel has no backward),
and decodes over a ``KVDecodeCache`` with plain PyTorch attention, as JAX
leaves its decode to XLA.

The decode loops (``greedy_decode``, ``sample_decode``) run their
steps at a position held on the device; on the card each loop is a
captured CUDA graph of one step, replayed (``models/decode_graph.py``), as
JAX runs its decode as one jitted scan.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Tuple, Union

import torch

from ..config import ModelConfig
from ..ops.attention import full_attention_chunked
from ..ops.common import mask_value, merge_heads, rms_norm, round_up_mult, split_heads
from ..ops.cuda.flash import flash_attention, flash_attention_plain
from ..ops.cuda.nsa_decode_mega import MAX_BATCH, decode_step_mega, decode_step_mega_plain
from ..ops.nsa import (
    DECODE_ENV as LAYER_DECODE_ENV,
    NSADecodeCache,
    _fused_decode_applies,
    ff_apply_gelu,
    ff_apply_swiglu,
    fuse_decode_layer,
    init_decode_cache,
    init_sparse_attention,
    sparse_attention_decode,
    sparse_attention_forward,
)
from ..ops.rotary import rotate_at_row_offsets, rotate_qk
from ..parallel.comm import copy_to_heads, reduce_from_heads
from ..parallel.mesh import heads_parallel
from ..utils.checkpoint import tree_to
from . import decode_graph

# the environment switches a decode step reads as it runs: the layer's and
# the whole-model route's (``use_mega_decode``); every captured decode loop
# is keyed on them
DECODE_ENV = LAYER_DECODE_ENV + ("NSA_MEGA_DECODE", "NSA_MEGA_MAX_B")
decode_graph.key_env(DECODE_ENV)


class KVDecodeCache(NamedTuple):
    """Full-attention layer cache: rotated K and V packed on the feature
    axis (``[..., :d]`` key, ``[..., d:]`` value), so one write a step
    serves both.  The decode step writes it in place."""

    kv: torch.Tensor      # [b, kvh, max_len, 2d]


LayerCache = Union[NSADecodeCache, KVDecodeCache]


class ModelCache(NamedTuple):
    layers: Tuple[LayerCache, ...]
    seq_len: int          # tokens cached = the next token's position


def _compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


FF_KINDS = ("gelu", "swiglu")


def _check_model(cfg: ModelConfig) -> None:
    if cfg.ff_kind not in FF_KINDS:
        raise ValueError(f"ff_kind must be one of {FF_KINDS}, got {cfg.ff_kind!r}")


def _ff_apply(ffp, cfg: ModelConfig, x):
    """The layer's prenorm FF block (``nsa_tpu.models.transformer._ff_apply``):
    ``ff_apply_gelu`` or, for ``ff_kind == "swiglu"``, ``ff_apply_swiglu``."""
    if cfg.ff_kind == "swiglu":
        return ff_apply_swiglu(ffp, cfg, x)
    return ff_apply_gelu(ffp, cfg, x)


def _decode_ff(layer: dict, cfg: ModelConfig):
    """The FF params a layer's decode step folds in: the gelu FF's, or None
    for swiglu, which the step applies after the attention (JAX's
    ``ffp = None``)."""
    return layer["ff"] if cfg.ff_kind == "gelu" else None


def init_transformer(cfg: ModelConfig, generator: torch.Generator, device="cuda") -> dict:
    """Random parameters in ``init_transformer``'s layout and distributions
    (the numbers differ from JAX's for the same seed).  For ``ff_kind ==
    "swiglu"`` the FF holds ``w1``, ``w3`` [dim, hidden] and ``w2``, without
    biases, the leaves its FF reads (JAX's init makes the gelu leaves for
    every kind; its swiglu models come from ``llama_import``)."""
    _check_model(cfg)
    hidden = int(cfg.dim * cfg.ff_expansion_factor)

    def uniform(shape, fan_in):
        bound = 1.0 / fan_in ** 0.5
        return (torch.rand(shape, generator=generator) * 2 - 1) * bound

    layers = []
    for _ in range(cfg.depth):
        if cfg.use_sparse_attn:
            attn = init_sparse_attention(cfg, generator, device)
        else:
            attn = tree_to({
                "norm_scale": torch.ones(cfg.dim),
                "w_q": uniform((cfg.dim, cfg.dim_inner), cfg.dim),
                "w_k": uniform((cfg.dim, cfg.dim_kv_inner), cfg.dim),
                "w_v": uniform((cfg.dim, cfg.dim_kv_inner), cfg.dim),
                "w_out": uniform((cfg.dim_inner, cfg.dim), cfg.dim_inner),
            }, device)
        if cfg.ff_kind == "swiglu":
            ff = {
                "norm_scale": torch.ones(cfg.dim),
                "w1": uniform((cfg.dim, hidden), cfg.dim),
                "w3": uniform((cfg.dim, hidden), cfg.dim),
                "w2": uniform((hidden, cfg.dim), hidden),
            }
        else:
            ff = {
                "norm_scale": torch.ones(cfg.dim),
                "w1": uniform((cfg.dim, hidden), cfg.dim),
                "b1": uniform((hidden,), cfg.dim),
                "w2": uniform((hidden, cfg.dim), hidden),
                "b2": uniform((cfg.dim,), hidden),
            }
        layers.append({"attn": attn, "ff": tree_to(ff, device)})
    top = {
        "token_emb": torch.randn((cfg.vocab_size, cfg.dim), generator=generator),
        "norm_scale": torch.ones(cfg.dim),
        "to_logits": uniform((cfg.dim, cfg.vocab_size), cfg.dim),
    }
    return {**tree_to(top, device), "layers": layers}


def _logits(params, cfg: ModelConfig, x):
    x = rms_norm(x, params["norm_scale"], cfg.norm_eps)
    return (x @ params["to_logits"].to(x.dtype)).float()


def _full_attn_forward(params, cfg: ModelConfig, x, *, return_cache_max_len=None,
                       use_kernels: bool = True):
    """The full-attention layer over x [b, n, dim]: rotary q and k, then the
    attention, then the output projection; with ``return_cache_max_len``
    also the layer's ``KVDecodeCache`` holding rows 0..n-1.

    The attention is ``flash_attention`` (its plain version when
    ``use_kernels`` is False) unless autograd needs its gradient: the kernel
    has no backward (nor has JAX's), so training takes
    ``full_attention_chunked`` over chunks of ``max(attn_chunk_size, 128)``
    query rows, each recomputed in the backward, as JAX trains the model."""
    b, n, _ = x.shape
    d = cfg.dim_head
    normed = copy_to_heads(rms_norm(x, params["norm_scale"], cfg.norm_eps))
    q = split_heads(normed @ params["w_q"].to(x.dtype), d)
    k = split_heads(normed @ params["w_k"].to(x.dtype), d)
    v = split_heads(normed @ params["w_v"].to(x.dtype), d).contiguous()
    q, k = rotate_qk(q, k, cfg.rope_theta)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        out = full_attention_chunked(q, k, v, causal=cfg.causal,
                                     chunk=max(cfg.attn_chunk_size, 128))
    else:
        attn = flash_attention if use_kernels else flash_attention_plain
        out = attn(q.contiguous(), k.contiguous(), v, causal=cfg.causal)
    out = reduce_from_heads(merge_heads(out) @ params["w_out"].to(x.dtype))
    if return_cache_max_len is None:
        return out
    kv = x.new_zeros((b, cfg.kv_heads, return_cache_max_len, 2 * d))
    kv[:, :, :n, :d] = k
    kv[:, :, :n, d:] = v
    return out, KVDecodeCache(kv=kv)


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """float32 q [b, kvh, g, d] . k [b, kvh, L, d]^T, k a strided view of
    the cache.  On the card a bf16 product goes to ``bmm`` with a float32
    output, which reads the view in place; copying it would move the whole
    cache a second time every step."""
    if q.dtype == torch.float32:
        return q @ k.transpose(-1, -2)
    if q.is_cuda:
        out = torch.bmm(q.flatten(0, 1), k.flatten(0, 1).transpose(1, 2),
                        out_dtype=torch.float32)
        return out.unflatten(0, q.shape[:2])
    return q.float() @ k.float().transpose(-1, -2)


def _full_qkv_weight(params, dtype) -> torch.Tensor:
    """The full-attention layer's fused q|k|v projection [dim, (h + 2 kvh) d]."""
    return torch.cat([params["w_q"], params["w_k"], params["w_v"]], dim=1).to(dtype)


def _full_attn_decode(params, cfg: ModelConfig, x, cache: KVDecodeCache, t):
    """One full-attention decode step over x [b, 1, dim] at position ``t``:
    an int or a 0-d int tensor on x's device (every row there), or a [b]
    tensor of per-row positions (the ragged step).  Writes the rotated k
    and v at row t[i] of the cache in place and returns x + attn_out,
    attending over every row under the mask ``row <= t[i]``, as JAX does:
    the same shapes at every position, so a captured step replays it."""
    b = x.shape[0]
    if not (torch.is_tensor(t) and t.dim() == 1):
        t = (t if torch.is_tensor(t) else decode_graph.device_scalar(t, x.device)).expand(b)
    d, kvh, g, heads = cfg.dim_head, cfg.kv_heads, cfg.num_grouped_queries, cfg.heads
    normed = copy_to_heads(rms_norm(x, params["norm_scale"], cfg.norm_eps))
    w = params.get("w_qkv")
    if w is None:
        w = _full_qkv_weight(params, x.dtype)
    proj = (normed @ w)[:, 0]
    q = proj[:, :cfg.dim_inner].reshape(b, heads, d)
    k = proj[:, cfg.dim_inner:cfg.dim_inner + cfg.dim_kv_inner].reshape(b, kvh, d)
    v = proj[:, cfg.dim_inner + cfg.dim_kv_inner:].reshape(b, kvh, d)
    qk = torch.cat([q, k], dim=1)[:, :, None]
    rot = rotate_at_row_offsets(qk, t, cfg.rope_theta)[:, :, 0]
    kv_row = torch.cat([rot[:, heads:], v], dim=-1)              # [b, kvh, 2d]
    kv = cache.kv
    rows = torch.arange(b, device=x.device)[:, None]
    kv[rows, torch.arange(kvh, device=x.device)[None, :], t.long()[:, None]] = kv_row
    sim = _scores(rot[:, :heads].reshape(b, kvh, g, d), kv[..., :d]) * d ** -0.5
    valid = torch.arange(kv.shape[2], device=x.device) <= t[:, None]
    sim = sim.masked_fill(~valid[:, None, None, :], mask_value(torch.float32))
    attn = torch.softmax(sim, dim=-1).to(x.dtype)
    out = (attn @ kv[..., d:]).reshape(b, 1, heads * d)
    return x + reduce_from_heads(out @ params["w_out"].to(x.dtype))


def init_layer_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.float32,
                     device="cuda") -> LayerCache:
    """An empty cache of one layer for decoding from scratch: the structured
    sparse cache, or the full model's ``KVDecodeCache``."""
    if cfg.use_sparse_attn:
        return init_decode_cache(cfg, batch, max_len, dtype, device)
    return KVDecodeCache(kv=torch.zeros((batch, cfg.kv_heads, max_len, 2 * cfg.dim_head),
                                        dtype=dtype, device=device))


def transformer_forward(
    params, cfg: ModelConfig, ids: torch.Tensor, *,
    return_cache_max_len: Optional[int] = None, use_kernels: bool = True,
    true_len=None,
):
    """Forward over token ids [b, n] -> float32 logits [b, n, vocab]; with
    ``return_cache_max_len`` also the ``ModelCache`` (prefill), whose
    ``seq_len`` is the largest true length.  ``use_kernels`` and
    ``true_len`` as in ``sparse_attention_forward``; the full model's
    attention is causal, so its rows up to each true length need no
    ``true_len`` (JAX ignores it there too)."""
    _check_model(cfg)
    x = params["token_emb"][ids].to(_compute_dtype(cfg))
    caches = []
    for layer in params["layers"]:
        if cfg.use_sparse_attn:
            res = sparse_attention_forward(
                layer["attn"], cfg, x, return_cache_max_len=return_cache_max_len,
                use_kernels=use_kernels, true_len=true_len,
            )
        else:
            res = _full_attn_forward(layer["attn"], cfg, x,
                                     return_cache_max_len=return_cache_max_len,
                                     use_kernels=use_kernels)
        if return_cache_max_len is None:
            attn_out = res
        else:
            attn_out, lc = res
            caches.append(lc)
        x = x + attn_out
        x = x + _ff_apply(layer["ff"], cfg, x)
    logits = _logits(params, cfg, x)
    if return_cache_max_len is None:
        return logits
    # per-row true lengths: the serving engine tracks each slot's length
    # itself, so the scalar position is only their upper bound
    seq_len = ids.shape[1] if true_len is None else int(torch.as_tensor(true_len).max())
    return logits, ModelCache(layers=tuple(caches), seq_len=seq_len)


def transformer_loss(params, cfg: ModelConfig, ids: torch.Tensor, *,
                     use_kernels: bool = True) -> torch.Tensor:
    """Mean next-token cross-entropy over ids [b, n + 1] (inputs
    ``ids[:, :-1]``, labels ``ids[:, 1:]``), in float32."""
    logits = transformer_forward(params, cfg, ids[:, :-1], use_kernels=use_kernels)
    return torch.nn.functional.cross_entropy(
        logits.flatten(0, 1), ids[:, 1:].flatten().long())


def transformer_prefill(params, cfg: ModelConfig, ids: torch.Tensor, max_len: int, *,
                        true_len=None):
    """Prefill: forward over the prompt, building the decode cache;
    ``true_len`` marks the real lengths of right-padded prompts (see
    ``sparse_attention_forward``)."""
    return transformer_forward(params, cfg, ids, return_cache_max_len=max_len,
                               true_len=true_len)


def _mega_applies(cfg: ModelConfig) -> bool:
    """The configurations the whole-model decode kernel takes: the sparse
    model with the gelu FF and the fused route's NSA settings."""
    return cfg.use_sparse_attn and cfg.ff_kind == "gelu" and _fused_decode_applies(cfg)


def use_mega_decode(cfg: ModelConfig, batch: int) -> bool:
    """Whether the decode step takes the whole-model kernel
    (``nsa_tpu.models.transformer.use_mega_decode``): sparse attention, the
    gelu FF, the ``mlp`` compressor, shared selection,
    ``num_compress_per_fine > 1`` and selected blocks, at ``batch`` <= 8.
    ``NSA_MEGA_DECODE=0`` opts out; ``NSA_MEGA_MAX_B`` moves the cutover,
    never above 16.  JAX's further conditions, ``attn_impl == "pallas"``
    and the ``NSA_SCOPED_VMEM_KIB`` opt-in for b 9-16, are TPU compiler
    matters (which kernel implementation, how much VMEM) with no
    counterpart here.  Under a heads axis above 1 it is false: the kernel
    folds every layer's ``w_out`` and FF in (see ``decode_route``)."""
    if os.environ.get("NSA_MEGA_DECODE", "") == "0" or heads_parallel():
        return False
    max_b = int(os.environ.get("NSA_MEGA_MAX_B", "8"))
    return _mega_applies(cfg) and batch <= min(max_b, MAX_BATCH)


def pack_mega_params(params: dict, cfg: ModelConfig) -> dict:
    """Stack the per-layer weights into the ``[L, ...]`` tensors the
    whole-model decode kernel reads (``nsa_tpu.models.transformer.
    pack_mega_params``, same names and shapes; per-layer vectors keep their
    singleton middle dim).  Every weight is in the compute dtype except
    ``mem_kv``, which stays float32 as in JAX.  JAX's ``pswap``, a lane
    permutation that Mosaic needs for rotary, has no counterpart: the kernel
    reads the rotary pairs directly."""
    if not _mega_applies(cfg):
        raise ValueError("the whole-model decode takes the sparse model with the gelu FF, "
                         "shared selection, selected blocks and the mlp compressor")
    dtype = _compute_dtype(cfg)
    layers = params["layers"]

    def stack(fn, dt=dtype):
        return torch.stack([fn(layer["attn"], layer["ff"]).to(dt) for layer in layers])

    def cat(a, b):
        return torch.cat([a, b], dim=-1)

    return {
        "token_emb": params["token_emb"].to(dtype).contiguous(),
        "to_logits": params["to_logits"].to(dtype).contiguous(),
        "out_norm": params["norm_scale"][None].to(dtype),
        "attn_norm": stack(lambda a, f: a["norm_scale"][None]),
        "w_qkvg": stack(lambda a, f: torch.cat([a["w_q"], a["w_k"], a["w_v"], a["gate_w"]],
                                               dim=1)),
        "gate_b": stack(lambda a, f: a["gate_b"][None]),
        "mem_kv": stack(lambda a, f: a["mem_kv"], torch.float32),
        "pos_kv": stack(lambda a, f: cat(a["k_pos"], a["v_pos"])),
        "b1k": stack(lambda a, f: a["k_compress"]["b1"]),
        "b1v": stack(lambda a, f: a["v_compress"]["b1"]),
        "b2c": stack(lambda a, f: cat(a["k_compress"]["b2"], a["v_compress"]["b2"])),
        "w1k": stack(lambda a, f: a["k_compress"]["w1"]),
        "w1v": stack(lambda a, f: a["v_compress"]["w1"]),
        "w2c": stack(lambda a, f: cat(a["k_compress"]["w2"], a["v_compress"]["w2"])),
        "w_out": stack(lambda a, f: a["w_out"]),
        "ff_norm": stack(lambda a, f: f["norm_scale"][None]),
        "fw1": stack(lambda a, f: f["w1"]),
        "fb1": stack(lambda a, f: f["b1"][None]),
        "fw2": stack(lambda a, f: f["w2"]),
        "fb2": stack(lambda a, f: f["b2"][None]),
    }


def fuse_decode_params(params: dict, cfg: ModelConfig) -> dict:
    """Pack the decode weights ONCE, outside the step loop
    (``nsa_tpu.models.transformer.fuse_decode_params``): every layer's
    fused q|k|v|gate projection, packed compressors, ``mem_kv``, ``w_out``
    and FF in the compute dtype (``fuse_decode_layer``), and, where the
    whole-model decode applies, its stacked weights under ``"mega"``
    (``pack_mega_params``).  Returns a new params dict that the decode step
    reads the packed weights from; packing again is a no-op.  The
    full-attention model gets every layer's fused q|k|v projection in the
    compute dtype under ``"w_qkv"``: JAX returns its params unchanged there
    because XLA hoists the step's concatenation out of the jitted loop,
    which an eager step would pay in every layer at every step."""
    dtype = _compute_dtype(cfg)
    if not cfg.use_sparse_attn:
        if all("w_qkv" in layer["attn"] for layer in params["layers"]):
            return params
        return {**params, "layers": [
            {**layer, "attn": {**layer["attn"], "w_qkv": _full_qkv_weight(layer["attn"], dtype)}}
            for layer in params["layers"]]}
    if all("decode_fused" in layer["attn"] for layer in params["layers"]):
        return params
    packed = {**params, "layers": [fuse_decode_layer(layer, dtype, cfg.nsa.compressor,
                                                     pack_ff=cfg.ff_kind == "gelu")
                                   for layer in params["layers"]]}
    if _mega_applies(cfg) and not heads_parallel():
        packed["mega"] = pack_mega_params(params, cfg)
    return packed


def stack_decode_caches(cache: ModelCache):
    """``ModelCache`` -> stacked (kv [L, ...], ckv [L, ...], ring [L, ...])
    copies (``nsa_tpu.models.transformer.stack_decode_caches``).  The
    whole-model decode also runs on a ``ModelCache``'s own per-layer tensors
    in place, which needs no copy."""
    return tuple(torch.stack([getattr(lc, f) for lc in cache.layers])
                 for f in ("kv", "ckv", "ring"))


def _mega_kw(cfg: ModelConfig) -> dict:
    nsa = cfg.nsa
    Bs = nsa.selection_block_size
    return dict(heads=cfg.heads, stride=nsa.compress_block_sliding_stride, sel_block=Bs,
                num_sel=nsa.num_selected_blocks, n_slide=-(-nsa.sliding_window_size // Bs) + 1,
                window=nsa.sliding_window_size, scale=cfg.dim_head ** -0.5,
                eps=cfg.norm_eps, theta=cfg.rope_theta)


def transformer_decode_step_mega(mp: dict, cfg: ModelConfig, token: torch.Tensor, kv, ckv,
                                 ring, t: int, greedy: bool = False, steps: int = 1, *,
                                 use_kernels: bool = True, phase_ns=None, inspect=None):
    """Whole-model decode through ``decode_step_mega``: (logits [b, vocab]
    float32, kv, ckv, ring), or with ``greedy=True`` (logits, tokens [b,
    steps], kv, ckv, ring) with the argmax taken in the kernel, ``steps``
    tokens per launch.  ``mp`` from ``pack_mega_params``; the caches
    stacked (``stack_decode_caches``) or per layer, updated in place.
    ``use_kernels=False`` runs the plain version on any device;
    ``phase_ns`` and ``inspect`` as in ``decode_step_mega``."""
    if not use_kernels:
        return decode_step_mega_plain(mp, kv, ckv, ring, token, t, steps=steps, greedy=greedy,
                                      **_mega_kw(cfg))
    return decode_step_mega(mp, kv, ckv, ring, token, t, steps=steps, greedy=greedy,
                            phase_ns=phase_ns, inspect=inspect, **_mega_kw(cfg))


def _mega_route(cfg: ModelConfig, b: int, route: Optional[str]) -> bool:
    """Whether a decode step of ``b`` rows takes the whole-model kernel:
    ``route`` None follows ``use_mega_decode``, "mega" forces it, "fused",
    "split" and "hybrid" force a per-layer route."""
    if route not in (None, "mega", "fused", "split", "hybrid"):
        raise ValueError(f"route must be None, 'mega', 'fused', 'split' or 'hybrid', "
                         f"got {route!r}")
    if route == "mega" and not _mega_applies(cfg):
        raise ValueError("the mega decode route needs the sparse model with the gelu FF, "
                         "shared selection, selected blocks and the mlp compressor")
    if route == "mega" and heads_parallel():
        raise ValueError("the mega decode route folds every layer's w_out and FF into one "
                         "kernel, which a heads axis above 1 cannot split")
    return route == "mega" or (route is None and use_mega_decode(cfg, b))


def cache_tensors(cache: ModelCache):
    """A ``ModelCache``'s per-layer (kv, ckv, ring) tensors, which the
    whole-model decode updates in place."""
    return tuple([getattr(lc, f) for lc in cache.layers] for f in ("kv", "ckv", "ring"))


def transformer_decode_step(
    params, cfg: ModelConfig, token: torch.Tensor, cache: ModelCache, *,
    use_kernels: bool = True, route: Optional[str] = None,
    pos: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ModelCache]:
    """One token step. token: [b] int -> float32 logits [b, vocab], cache.

    The cache's tensors are updated in place; the returned cache's
    ``seq_len`` is the host's count, one more.  ``pos``, a 0-d int32 tensor
    on the params' device holding ``cache.seq_len``, is the position the
    step reads instead (on the device, as a captured step replays it;
    ``models/decode_graph.py``).  ``route``: None takes the
    whole-model kernel where ``use_mega_decode`` holds, else the layer's
    default (fused at b <= 8, split above, JAX's XLA branches at every b
    for the configurations the kernels do not take); "mega", "fused",
    "split" or "hybrid" forces one (see ``sparse_attention_decode``).
    ``use_kernels=False`` runs the route's plain versions (see
    ``sparse_attention_decode``).  Params packed by ``fuse_decode_params``
    save the per-step packing.  The full-attention model has one route,
    plain PyTorch attention over its ``KVDecodeCache``: ``route`` must be
    None and ``use_kernels`` changes nothing.
    """
    _check_model(cfg)
    t = cache.seq_len if pos is None else pos
    done = ModelCache(layers=cache.layers, seq_len=cache.seq_len + 1)
    if not cfg.use_sparse_attn:
        return _full_decode_layers(params, cfg, token, cache.layers, t, route), done
    if _mega_route(cfg, token.shape[0], route):
        mp = params.get("mega") or pack_mega_params(params, cfg)
        logits = transformer_decode_step_mega(mp, cfg, token, *cache_tensors(cache), t,
                                              use_kernels=use_kernels)[0]
        return logits, done
    x = params["token_emb"][token][:, None].to(_compute_dtype(cfg))   # [b, 1, dim]
    if pos is None:             # one device position for every layer
        t = decode_graph.device_scalar(t, x.device)
    for layer, lc in zip(params["layers"], cache.layers):
        ffp = _decode_ff(layer, cfg)
        x, _ = sparse_attention_decode(
            layer["attn"], cfg, x, lc, t, ff_params=ffp, use_kernels=use_kernels,
            route=route,
        )
        if ffp is None:
            x = x + _ff_apply(layer["ff"], cfg, x)
    return _logits(params, cfg, x)[:, 0], done


def transformer_decode_step_ragged(
    params, cfg: ModelConfig, tokens: torch.Tensor, layer_caches, seq_lens: torch.Tensor,
    page_table: Optional[torch.Tensor] = None, *, use_kernels: bool = True,
    route: Optional[str] = None,
) -> Tuple[torch.Tensor, Tuple[NSADecodeCache, ...]]:
    """One ragged token step over a slot pool
    (``nsa_tpu.models.transformer.transformer_decode_step_ragged``): row i
    decodes at its own position ``seq_lens[i]``.  tokens [b] int, seq_lens
    [b] int tensors on the params' device; ``layer_caches`` a tuple of
    per-layer caches with leading [b], written in place.  Returns (logits
    [b, vocab] float32, layer_caches).  Nothing is read back to the host.

    With ``page_table`` ([b, max_pages] int32, shared by every layer) each
    layer's kv leaf is a page pool (the paged serving engine).  ``route``:
    None or "fused" takes the ragged fused pair, "split" JAX's XLA branches
    with the block-gather kernel (its ``NSA_NO_FUSED_DECODE=1``); the
    whole-model kernel takes one position only and never runs here.
    ``use_kernels=False`` runs the plain versions.  The full-attention
    model takes no page table and no route."""
    _check_model(cfg)
    if not cfg.use_sparse_attn:
        if page_table is not None:
            raise NotImplementedError("paged KV serving is sparse-attention only")
        t = seq_lens.to(device=params["token_emb"].device, dtype=torch.int32)
        return _full_decode_layers(params, cfg, tokens, layer_caches, t, route), \
            tuple(layer_caches)
    if route not in (None, "fused", "split"):
        raise ValueError(f"the ragged step's route must be None, 'fused' or 'split', "
                         f"got {route!r}")
    x = params["token_emb"][tokens][:, None].to(_compute_dtype(cfg))    # [b, 1, dim]
    t = seq_lens.to(device=x.device, dtype=torch.int32)
    new_layers = []
    for layer, lc in zip(params["layers"], layer_caches):
        ffp = _decode_ff(layer, cfg)
        x, lc = sparse_attention_decode(
            layer["attn"], cfg, x, lc, t, ff_params=ffp, use_kernels=use_kernels,
            route=route, page_table=page_table,
        )
        if ffp is None:
            x = x + _ff_apply(layer["ff"], cfg, x)
        new_layers.append(lc)
    return _logits(params, cfg, x)[:, 0], tuple(new_layers)


def _full_decode_layers(params, cfg: ModelConfig, tokens, layer_caches, t, route):
    """The full-attention model's decode step through every layer, caches
    written in place; returns float32 logits [b, vocab]."""
    if route is not None:
        raise ValueError(f"the full-attention model has one decode route, got {route!r}")
    x = params["token_emb"][tokens][:, None].to(_compute_dtype(cfg))    # [b, 1, dim]
    for layer, lc in zip(params["layers"], layer_caches):
        x = _full_attn_decode(layer["attn"], cfg, x, lc, t)
        x = x + _ff_apply(layer["ff"], cfg, x)
    return _logits(params, cfg, x)[:, 0]


def default_max_len(cfg: ModelConfig, need: int) -> int:
    """Cache length for ``need`` tokens: a multiple of 128 and, for the
    sparse model, of the compression stride and the selection block."""
    if not cfg.use_sparse_attn:
        return round_up_mult(need, 128)
    nsa = cfg.nsa
    return round_up_mult(need, max(nsa.compress_block_sliding_stride,
                                   nsa.selection_block_size, 128))


def _check_room(cache: ModelCache, gen_len: int) -> None:
    """The loop's range check, on the host at its start: the steps read
    their positions on the device and check nothing."""
    max_len = cache.layers[0].kv.shape[2]
    if not 0 <= cache.seq_len <= max_len - gen_len:
        raise ValueError(f"{gen_len} decode steps from position {cache.seq_len} do not fit "
                         f"the cache of {max_len}")


def greedy_decode(params, cfg: ModelConfig, token: torch.Tensor, cache: ModelCache,
                  gen_len: int, *, route: Optional[str] = None, steps: int = 1,
                  capture: bool = True) -> torch.Tensor:
    """``gen_len`` greedy decode steps from ``token`` [b], each consuming the
    token it emits; returns the consumed tokens [b, gen_len].  The cache's
    tensors are updated in place.  The decode weights are packed once first
    (``fuse_decode_params``).  ``route`` as in ``transformer_decode_step``;
    on the whole-model kernel the argmax is taken in the kernel, ``steps``
    tokens per launch (a divisor of ``gen_len``).

    The steps read their position and token on the device and feed the
    argmax back there: on the card the loop is a captured CUDA graph of one
    step (one launch on the whole-model kernel), replayed
    (``models/decode_graph.py``), as JAX jits its decode scan.
    ``capture=False`` runs the same steps eagerly on the card; on the CPU
    they always run eagerly."""
    params = fuse_decode_params(params, cfg)
    b, dev = token.shape[0], token.device
    _check_room(cache, gen_len)
    mega = _mega_route(cfg, b, route)
    if mega and gen_len % steps:
        raise ValueError(f"steps {steps} must divide gen_len {gen_len}")
    per = steps if mega else 1
    state = {"token": token.to(torch.int32 if mega else torch.long).clone(),
             "pos": decode_graph.device_scalar(cache.seq_len, dev),
             "i": decode_graph.device_scalar(0, dev, torch.long),
             "hist": torch.zeros((b, gen_len), dtype=torch.long, device=dev)}

    def mega_step(s):
        kv, ckv, ring = cache_tensors(cache)
        _, toks, *_ = transformer_decode_step_mega(params["mega"], cfg, s["token"], kv, ckv, ring,
                                                   s["pos"], greedy=True, steps=steps)
        consumed = torch.cat([s["token"][:, None], toks[:, :-1]], dim=1).long()
        s["hist"].index_copy_(1, s["i"] + torch.arange(steps, device=dev), consumed)
        s["token"].copy_(toks[:, -1])
        s["pos"].add_(steps)
        s["i"].add_(steps)

    def layer_step(s):
        s["hist"].index_copy_(1, s["i"].reshape(1), s["token"][:, None])
        logits, _ = transformer_decode_step(params, cfg, s["token"], cache, route=route,
                                            pos=s["pos"])
        s["token"].copy_(logits.argmax(-1))
        s["pos"].add_(1)
        s["i"].add_(1)

    out = decode_graph.decode_loop(state, mega_step if mega else layer_step, gen_len // per,
                                   reads=(params, cache.layers), opts=(cfg, route, steps),
                                   capture=capture)
    return out["hist"].to(token.dtype, copy=True)


def transformer_greedy(
    params, cfg: ModelConfig, prompt: torch.Tensor, gen_len: int,
    max_len: Optional[int] = None, *, route: Optional[str] = None,
) -> torch.Tensor:
    """Greedy generation: prefill, then ``gen_len`` decode steps.
    prompt [b, n] -> tokens [b, gen_len], the first from the prefill;
    ``route`` as in ``greedy_decode``."""
    b, n = prompt.shape
    if gen_len == 0:
        return prompt.new_zeros((b, 0))
    max_len = default_max_len(cfg, n + gen_len) if max_len is None else max_len
    logits, cache = transformer_prefill(params, cfg, prompt, max_len)
    return greedy_decode(params, cfg, logits[:, -1].argmax(-1), cache, gen_len, route=route)


def top_k_filter(logits: torch.Tensor, filter_thres: float) -> torch.Tensor:
    """Keep the ``ceil((1 - filter_thres) * vocab)`` largest logits (at
    least one, ties at the k-th value kept), -inf elsewhere."""
    vocab = logits.shape[-1]
    k = max(1, -int(-((1.0 - filter_thres) * vocab) // 1))        # ceil, as JAX
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, float("-inf"))


def _sample_from_logits(logits: torch.Tensor, temperature: float, filter_thres: float,
                        gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Greedy (temperature <= 0) or top-k + Gumbel-max sampling
    (``nsa_tpu.models.transformer._sample_from_logits``); ``gumbel`` is the
    noise, logits' shape, which JAX draws from its key inside."""
    if temperature <= 0:
        return logits.argmax(-1)
    return (top_k_filter(logits, filter_thres) / temperature + gumbel).argmax(-1)


def sample_decode(params, cfg: ModelConfig, token: torch.Tensor, cache: ModelCache,
                  gumbel: torch.Tensor, *, temperature: float, filter_thres: float = 0.9,
                  route: Optional[str] = None, capture: bool = True) -> torch.Tensor:
    """Tempered decode steps from ``token`` [b], one a row of ``gumbel``
    [n, b, vocab]: step i samples its token by the top-k filter and
    Gumbel-max over its logits with noise ``gumbel[i]``, indexed on the
    device by the step counter.  Returns the consumed tokens and the last
    one sampled, [b, n + 1] (``token`` first).  ``route`` as in
    ``transformer_decode_step`` (the whole-model kernel's logits at b <= 8,
    one token a launch); the cache is updated in place; ``capture`` as in
    ``greedy_decode``."""
    params = fuse_decode_params(params, cfg)
    b, dev, n = token.shape[0], token.device, gumbel.shape[0]
    _check_room(cache, n)
    hist = torch.zeros((b, n + 1), dtype=torch.long, device=dev)
    hist[:, 0] = token
    state = {"token": token.to(torch.long).clone(),
             "pos": decode_graph.device_scalar(cache.seq_len, dev),
             "i": decode_graph.device_scalar(0, dev, torch.long), "hist": hist,
             "gumbel": gumbel.to(dev).clone()}

    def step(s):
        logits, _ = transformer_decode_step(params, cfg, s["token"], cache, route=route,
                                            pos=s["pos"])
        noise = s["gumbel"].index_select(0, s["i"].reshape(1))[0]
        tok = _sample_from_logits(logits, temperature, filter_thres, noise)
        s["i"].add_(1)
        s["hist"].index_copy_(1, s["i"].reshape(1), tok[:, None])
        s["token"].copy_(tok)
        s["pos"].add_(1)

    out = decode_graph.decode_loop(
        state, step, n, reads=(params, cache.layers),
        opts=(cfg, route, float(temperature), float(filter_thres)), capture=capture)
    return out["hist"].to(token.dtype, copy=True)


def transformer_sample(
    params, cfg: ModelConfig, prompt: torch.Tensor, gen_len: int, *,
    temperature: float = 0.0, filter_thres: float = 0.9,
    gumbel: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None,
    max_len: Optional[int] = None, route: Optional[str] = None,
) -> torch.Tensor:
    """Autoregressive generation (``nsa_tpu.models.transformer.
    transformer_sample``): prefill, then decode steps. prompt [b, n] ->
    [b, gen_len] sampled ids, the first from the prefill.

    Greedy (temperature <= 0) is ``transformer_greedy``: on the whole-model
    kernel its argmax runs in the kernel.  Tempered sampling takes the
    top-k filter and Gumbel-max over each step's logits (``sample_decode``).
    JAX draws its noise from a key; here ``gumbel`` [gen_len, b, vocab]
    passes it in (row i samples token i), or ``generator`` draws it
    (default: a fresh generator seeded 0 on the prompt's device).
    ``route`` as in ``greedy_decode``."""
    b, n = prompt.shape
    if temperature <= 0 or gen_len == 0:
        return transformer_greedy(params, cfg, prompt, gen_len, max_len, route=route)
    if gumbel is None:
        if generator is None:
            generator = torch.Generator(device=prompt.device).manual_seed(0)
        u = torch.rand((gen_len, b, cfg.vocab_size), generator=generator,
                       device=generator.device).to(prompt.device)
        gumbel = -torch.log(-torch.log(u + 1e-20) + 1e-20)          # JAX's form
    max_len = default_max_len(cfg, n + gen_len) if max_len is None else max_len
    params = fuse_decode_params(params, cfg)
    logits, cache = transformer_prefill(params, cfg, prompt, max_len)
    first = _sample_from_logits(logits[:, -1], temperature, filter_thres, gumbel[0])
    return sample_decode(params, cfg, first, cache, gumbel[1:], temperature=temperature,
                         filter_thres=filter_thres, route=route)
