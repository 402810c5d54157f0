"""Causal (or not) GQA softmax attention forward, the flash recurrence
(``nsa_tpu/ops/pallas/flash.py::flash_attention``): the attention of the
full-attention baseline model's prefill and forward.

q [b, h, n, d], k / v [b, kvh, n_k, d] -> [b, h, n, d] in q's dtype.  Query
row r sits at key position r (the first keys; the same as ``full_attention``
when n == n_k).  Logits, softmax weights and the accumulator are float32;
masked columns get exactly zero weight; the row sum is clamped at 1e-30.

The wrapper launches the CUDA kernel (``csrc/flash_attention.cu``) for CUDA
tensors and runs the plain PyTorch version for CPU tensors.  The TPU
kernel's knobs ``block_q``, ``block_k``, ``interpret`` and ``stream`` have
no counterpart: its streaming variant only chose where K/V live in VMEM,
and the CUDA kernel streams K/V tiles through shared memory at every length.
JAX's flash kernel has no backward; neither has this one, so the wrapper
raises on a CUDA input that requires grad.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..attention import attention_by_query_chunks
from . import runtime

KERNEL_DIM = 64                 # the head dim the kernel takes (csrc kD)
KERNEL_GROUPS = (1, 2, 4)       # query heads per KV head the kernel takes
PLAIN_CHUNK = 256               # query rows a step of the plain version
# The kernel against its plain version, element by element.  The kernel
# rounds its float32 softmax weights to bf16 for P.V (the plain version, like
# the TPU kernel, keeps them float32; both sum the row's weights in float32),
# which moves an output by at most 2^-9 of sum_j p_j |v_j| / l: the same
# attention taken over |v|.  Both round the output to bf16 once, half an ulp
# each, at most 2^-8 of the output together.  Each term is taken twice, to
# cover float32 sum order and the fast exponential.
TOL_OUT_REL = 2.0 ** -7
TOL_ABS_V_REL = 2.0 ** -8


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, scale: Optional[float] = None) -> torch.Tensor:
    """The plain PyTorch version of ``flash_attention``, in the TPU kernel's
    numerics (``attention_by_query_chunks``), ``PLAIN_CHUNK`` query rows at
    a time: at the serving cell the whole [64, 8, 3900, 3900] logits would
    be 31 GB in float32."""
    return attention_by_query_chunks(q, k, v, causal=causal, scale=scale, chunk=PLAIN_CHUNK)


def flash_attention_tolerance(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              want: torch.Tensor, causal: bool = True,
                              scale: Optional[float] = None) -> torch.Tensor:
    """The float32 bound, element by element, on |``flash_attention`` -
    ``flash_attention_plain``| on the same bf16 inputs, ``want`` being the
    plain version's output: ``TOL_OUT_REL`` |want| + ``TOL_ABS_V_REL``
    times the attention over |v| (see ``TOL_OUT_REL``)."""
    abs_v = attention_by_query_chunks(q.float(), k.float(), v.float().abs(), causal=causal,
                                      scale=scale, chunk=PLAIN_CHUNK)
    return TOL_OUT_REL * want.float().abs() + TOL_ABS_V_REL * abs_v


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: Optional[float] = None) -> torch.Tensor:
    """q [b, h, n, d]; k, v [b, kvh, n_k, d] -> [b, h, n, d]."""
    if runtime.on_cpu(q, k, v):
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise NotImplementedError("flash_attention has no backward (nor has JAX's); train the "
                                  "full-attention model on the plain chunked attention")
    b, h, n, d = q.shape
    kvh, n_k = k.shape[1], k.shape[2]
    if d != KERNEL_DIM or h % kvh or h // kvh not in KERNEL_GROUPS:
        raise ValueError(f"flash_attention kernel takes dim_head {KERNEL_DIM} and "
                         f"{KERNEL_GROUPS} query heads per KV head; got q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    scale = d ** -0.5 if scale is None else scale
    ptrs = [runtime.check("q", q, torch.bfloat16, (b, h, n, d)),
            runtime.check("k", k, torch.bfloat16, (b, kvh, n_k, d)),
            runtime.check("v", v, torch.bfloat16, (b, kvh, n_k, d))]
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        runtime.library().call("nsa_flash_attention", *ptrs, out.data_ptr(), b, kvh, h // kvh,
                               n, n_k, int(causal), scale, runtime.stream_of(q))
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
