"""The block gather of the ragged split decode route
(``nsa_tpu/ops/pallas/paged_gather.py``): S blocks of ``block_size`` rows
per (batch row, KV head) out of a dense cache.  Despite the name, the TPU
kernel reads a dense [b, kvh, L, D] cache, one DMA per block.

The wrapper launches the CUDA kernel (``csrc/paged_gather.cu``) for CUDA
tensors and runs the plain PyTorch version beside it for CPU tensors.  Both
clamp a block id to the cache's last block.
"""

from __future__ import annotations

import torch

from . import runtime


def paged_gather_plain(cache: torch.Tensor, indices: torch.Tensor,
                       block_size: int) -> torch.Tensor:
    """The plain PyTorch version of ``paged_gather``."""
    b, kvh, L, D = cache.shape
    S = indices.shape[-1]
    blocks = cache.reshape(b, kvh, L // block_size, block_size, D)
    idx = indices.long().clamp(0, L // block_size - 1)
    bi = torch.arange(b, device=cache.device)[:, None, None]
    hi = torch.arange(kvh, device=cache.device)[None, :, None]
    return blocks[bi, hi, idx].reshape(b, kvh, S * block_size, D)


def paged_gather(cache: torch.Tensor, indices: torch.Tensor, block_size: int) -> torch.Tensor:
    """cache [b, kvh, L, D]; indices [b, kvh, S] int32 block ids ->
    [b, kvh, S * block_size, D], block s of (i, h) = rows ``indices[i, h, s]
    * block_size`` onward of ``cache[i, h]``.  ``indices`` may be a strided
    view (the first S columns of a wider id table): only its last dimension
    must be unit-stride."""
    if runtime.on_cpu(cache, indices):
        return paged_gather_plain(cache, indices, block_size)
    b, kvh, L, D = cache.shape
    S = indices.shape[-1]
    row_bytes = D * cache.element_size()
    if L % block_size or row_bytes % 16:
        raise ValueError(f"paged_gather kernel takes a cache length divisible by the block "
                         f"size and rows of a multiple of 16 bytes; got L={L}, "
                         f"block_size={block_size}, row bytes={row_bytes}")
    ptr = runtime.check("cache", cache, cache.dtype, (b, kvh, L, D))
    if indices.dtype != torch.int32 or tuple(indices.shape) != (b, kvh, S):
        raise ValueError(f"indices: {indices.dtype} {tuple(indices.shape)}, the kernel takes "
                         f"int32 {(b, kvh, S)}")
    if indices.stride(-1) != 1 and S > 1:
        raise ValueError(f"indices: strides {indices.stride()}, the last must be 1")
    if b > 65535 or kvh > 65535:
        raise ValueError(f"paged_gather kernel takes at most 65535 rows and heads; got {b}, {kvh}")
    out = torch.empty((b, kvh, S * block_size, D), dtype=cache.dtype, device=cache.device)
    with torch.cuda.device(cache.device):
        runtime.library().call("nsa_paged_gather", ptr, indices.data_ptr(), out.data_ptr(), b,
                               kvh, L, S, block_size, row_bytes, indices.stride(0),
                               indices.stride(1), runtime.stream_of(cache))
    paged_gather.launches += 1
    return out


paged_gather.launches = 0
