"""Byte-level GPT with native sparse attention
(``nsa_tpu/models/transformer.py``).

token embed -> depth x (NSA attention + prenorm GELU FF) -> RMSNorm ->
logits.  The model is plain functions over a params dict in the JAX
package's layout (see ``utils/checkpoint.py``); the decode cache is a
``ModelCache`` threaded through ``transformer_decode_step``.  The decode
step takes the fused pair ``decode_select_emit`` + ``decode_attend_fused``
at b <= 8 and ``decode_select`` + ``decode_attend`` above, per layer (JAX's
``NSA_MEGA_DECODE=0`` route: its whole-model decode kernel is not ported
yet).  The full-attention baseline model is not ported yet (``ROADMAP.md``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..config import ModelConfig
from ..ops.common import rms_norm, round_up_mult
from ..ops.nsa import (
    NSADecodeCache,
    ff_apply_gelu,
    fuse_decode_layer,
    init_sparse_attention,
    sparse_attention_decode,
    sparse_attention_forward,
)
from ..utils.checkpoint import tree_to


class ModelCache(NamedTuple):
    layers: Tuple[NSADecodeCache, ...]
    seq_len: int          # tokens cached = the next token's position


def _compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _check_model(cfg: ModelConfig) -> None:
    if not cfg.use_sparse_attn or cfg.ff_kind != "gelu":
        raise NotImplementedError(
            "the port implements the sparse-attention model with the gelu FF; "
            "the full-attention baseline and swiglu wait (see ROADMAP.md)"
        )


def init_transformer(cfg: ModelConfig, generator: torch.Generator, device="cuda") -> dict:
    """Random parameters in ``init_transformer``'s layout and distributions
    (the numbers differ from JAX's for the same seed)."""
    _check_model(cfg)
    hidden = int(cfg.dim * cfg.ff_expansion_factor)

    def uniform(shape, fan_in):
        bound = 1.0 / fan_in ** 0.5
        return (torch.rand(shape, generator=generator) * 2 - 1) * bound

    layers = []
    for _ in range(cfg.depth):
        attn = init_sparse_attention(cfg, generator, device)
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


def transformer_forward(
    params, cfg: ModelConfig, ids: torch.Tensor, *,
    return_cache_max_len: Optional[int] = None, use_kernels: bool = True,
):
    """Forward over token ids [b, n] -> float32 logits [b, n, vocab]; with
    ``return_cache_max_len`` also the ``ModelCache`` (prefill).
    ``use_kernels`` as in ``sparse_attention_forward``."""
    _check_model(cfg)
    x = params["token_emb"][ids].to(_compute_dtype(cfg))
    caches = []
    for layer in params["layers"]:
        res = sparse_attention_forward(
            layer["attn"], cfg, x, return_cache_max_len=return_cache_max_len,
            use_kernels=use_kernels,
        )
        if return_cache_max_len is None:
            attn_out = res
        else:
            attn_out, lc = res
            caches.append(lc)
        x = x + attn_out
        x = x + ff_apply_gelu(layer["ff"], cfg, x)
    logits = _logits(params, cfg, x)
    if return_cache_max_len is None:
        return logits
    return logits, ModelCache(layers=tuple(caches), seq_len=ids.shape[1])


def transformer_loss(params, cfg: ModelConfig, ids: torch.Tensor, *,
                     use_kernels: bool = True) -> torch.Tensor:
    """Mean next-token cross-entropy over ids [b, n + 1] (inputs
    ``ids[:, :-1]``, labels ``ids[:, 1:]``), in float32."""
    logits = transformer_forward(params, cfg, ids[:, :-1], use_kernels=use_kernels)
    return torch.nn.functional.cross_entropy(
        logits.flatten(0, 1), ids[:, 1:].flatten().long())


def transformer_prefill(params, cfg: ModelConfig, ids: torch.Tensor, max_len: int):
    """Prefill: forward over the prompt, building the decode cache."""
    return transformer_forward(params, cfg, ids, return_cache_max_len=max_len)


def fuse_decode_params(params: dict, cfg: ModelConfig) -> dict:
    """Pack every layer's decode weights ONCE, outside the step loop
    (``nsa_tpu.models.transformer.fuse_decode_params``): the fused q|k|v|gate
    projection, the packed compressors, ``mem_kv``, ``w_out`` and the FF in
    the compute dtype (``fuse_decode_layer``).  Returns a new params dict
    that the decode step reads the packed weights from; packing again is a
    no-op."""
    if all("decode_fused" in layer["attn"] for layer in params["layers"]):
        return params
    dtype = _compute_dtype(cfg)
    return {**params, "layers": [fuse_decode_layer(layer, dtype) for layer in params["layers"]]}


def transformer_decode_step(
    params, cfg: ModelConfig, token: torch.Tensor, cache: ModelCache, *,
    use_kernels: bool = True, route: Optional[str] = None,
) -> Tuple[torch.Tensor, ModelCache]:
    """One token step. token: [b] int -> float32 logits [b, vocab], cache.

    The cache's tensors are updated in place.  ``use_kernels`` and
    ``route`` as in ``sparse_attention_decode``; params packed by
    ``fuse_decode_params`` save the per-step packing.
    """
    _check_model(cfg)
    x = params["token_emb"][token][:, None].to(_compute_dtype(cfg))   # [b, 1, dim]
    t = cache.seq_len
    new_layers = []
    for layer, lc in zip(params["layers"], cache.layers):
        x, lc = sparse_attention_decode(
            layer["attn"], cfg, x, lc, t, ff_params=layer["ff"], use_kernels=use_kernels,
            route=route,
        )
        new_layers.append(lc)
    logits = _logits(params, cfg, x)[:, 0]
    return logits, ModelCache(layers=tuple(new_layers), seq_len=t + 1)


def default_max_len(cfg: ModelConfig, need: int) -> int:
    """Cache length for ``need`` tokens: a multiple of the compression
    stride, the selection block and 128."""
    nsa = cfg.nsa
    return round_up_mult(need, max(nsa.compress_block_sliding_stride,
                                   nsa.selection_block_size, 128))


def greedy_decode(params, cfg: ModelConfig, token: torch.Tensor, cache: ModelCache,
                  gen_len: int, *, route: Optional[str] = None) -> torch.Tensor:
    """``gen_len`` greedy decode steps from ``token`` [b], each consuming the
    token it emits; returns the consumed tokens [b, gen_len].  The decode
    weights are packed once first (``fuse_decode_params``)."""
    params = fuse_decode_params(params, cfg)
    tokens = []
    for _ in range(gen_len):
        tokens.append(token)
        logits, cache = transformer_decode_step(params, cfg, token, cache, route=route)
        token = logits.argmax(-1)
    return torch.stack(tokens, dim=1)


def transformer_greedy(
    params, cfg: ModelConfig, prompt: torch.Tensor, gen_len: int,
    max_len: Optional[int] = None, *, route: Optional[str] = None,
) -> torch.Tensor:
    """Greedy generation: prefill, then ``gen_len`` decode steps.
    prompt [b, n] -> tokens [b, gen_len], the first from the prefill;
    ``route`` as in ``sparse_attention_decode``."""
    b, n = prompt.shape
    if gen_len == 0:
        return prompt.new_zeros((b, 0))
    max_len = default_max_len(cfg, n + gen_len) if max_len is None else max_len
    logits, cache = transformer_prefill(params, cfg, prompt, max_len)
    return greedy_decode(params, cfg, logits[:, -1].argmax(-1), cache, gen_len, route=route)
