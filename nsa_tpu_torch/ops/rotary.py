"""Rotary position embeddings (``nsa_tpu/ops/rotary.py``).

Interleaved pairs: ``(x[..., 2i], x[..., 2i+1])`` rotate together by
``position * inv_freq[i]``.  Compression inputs are never rotated; that
rule lives at the call sites in :mod:`nsa_tpu_torch.ops.nsa`.
"""

from __future__ import annotations

import torch


def rope_frequencies(dim_head: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    """Per-pair inverse frequencies, shape [dim_head // 2], float32."""
    exponent = torch.arange(0, dim_head, 2, dtype=torch.float32, device=device) / dim_head
    return 1.0 / (theta ** exponent)


def apply_rotary(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0):
    """Rotate the last dim of ``x`` ([..., n, d]) at integer ``positions`` ([n])."""
    d = x.shape[-1]
    angles = positions.float()[:, None] * rope_frequencies(d, theta, x.device)
    cos, sin = torch.cos(angles), torch.sin(angles)
    xf = x.float().reshape(*x.shape[:-1], d // 2, 2)
    x0, x1 = xf[..., 0], xf[..., 1]
    out = torch.stack([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def rotate_at_offset(x: torch.Tensor, offset, theta: float = 10000.0):
    """Rotate [..., n, d] starting at absolute position ``offset``: an int,
    or a 0-d int tensor on x's device (a device position: the same angles
    with no host sync)."""
    n = x.shape[-2]
    positions = torch.arange(n, device=x.device) + offset
    return apply_rotary(x, positions, theta)


def rotate_at_row_offsets(x: torch.Tensor, offsets: torch.Tensor, theta: float = 10000.0):
    """Rotate x [b, H, 1, d] with per-row absolute positions ``offsets``
    [b], a tensor on x's device (the ragged decode step: every slot of the
    serving pool rotates at its own position)."""
    b, H, n, d = x.shape
    if n != 1 or tuple(offsets.shape) != (b,):
        raise ValueError(f"x {tuple(x.shape)} must be [b, H, 1, d] and offsets [b]")
    angles = offsets.float()[:, None] * rope_frequencies(d, theta, x.device)   # [b, d/2]
    cos, sin = torch.cos(angles)[:, None, None], torch.sin(angles)[:, None, None]
    xf = x.float().reshape(b, H, n, d // 2, 2)
    x0, x1 = xf[..., 0], xf[..., 1]
    out = torch.stack([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def rotate_qk(q: torch.Tensor, k: torch.Tensor, theta: float = 10000.0):
    """Rotate q and k jointly at positions [0, n) (training / prefill)."""
    positions = torch.arange(q.shape[-2], device=q.device)
    return apply_rotary(q, positions, theta), apply_rotary(k, positions, theta)
