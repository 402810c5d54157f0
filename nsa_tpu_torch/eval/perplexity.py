"""Perplexity: in-distribution (the byte corpus) and OOD (CS441 QA bytes)
(``nsa_tpu/eval/perplexity.py``).

The token stream is cut into non-overlapping windows of ``seq_len + 1``
bytes; each window predicts ``seq_len`` bytes (a partial last window is
padded and masked); the summed NLL in nats over every predicted byte gives
PPL = exp(total_nll / total_tokens).  Two paths: the dense forward over
whole windows (``compute_ppl``) and the exact per-token path through the
decode cache (``compute_ppl_incremental``), which agree.

``run_ppl_eval`` writes the JAX package's CSV schema: model_type, step,
seq_len, ppl_id, tokens_id, ppl_ood, tokens_ood.  Every entry point runs on
``device`` ("cuda" unless the caller asks for the CPU), where the params
must lie; ``use_kernels=False`` runs the plain versions of the kernels.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..config import ModelConfig
from ..models import decode_graph
from ..models.transformer import (
    default_max_len,
    fuse_decode_params,
    transformer_decode_step,
    transformer_forward,
)
from ..utils.metrics import CSVLogger
from .efficiency import copy_cache


def _token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """-log p(label) under float32 ``log_softmax``; logits [..., vocab],
    labels [...] int."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels[..., None].long())[..., 0]


def _window_nll(params, cfg: ModelConfig, window: torch.Tensor, valid: torch.Tensor, *,
                use_kernels: bool = True) -> torch.Tensor:
    """Summed NLL over one batch of windows: window [b, L + 1] int, valid
    [b, L] float32 (1 where the label is a real byte)."""
    logits = transformer_forward(params, cfg, window[:, :-1], use_kernels=use_kernels)
    return torch.sum(_token_nll(logits, window[:, 1:]) * valid)


def ppl_windows(tokens: np.ndarray, seq_len: int):
    """The windows of ``seq_len + 1`` bytes, zero-padded, and their [seq_len]
    masks of real labels (``compute_ppl``'s chunking)."""
    win = seq_len + 1
    windows, valids = [], []
    for w in range(max((len(tokens) + seq_len - 1) // seq_len, 1)):
        chunk = tokens[w * seq_len:w * seq_len + win]
        if len(chunk) < 2:
            continue
        valid = np.zeros(seq_len, np.float32)
        valid[:len(chunk) - 1] = 1.0
        windows.append(np.pad(chunk, (0, win - len(chunk))).astype(np.int64))
        valids.append(valid)
    return windows, valids


@torch.no_grad()
def compute_ppl(
    params,
    cfg: ModelConfig,
    tokens: np.ndarray,
    seq_len: int,
    batch_size: int = 8,
    max_tokens: Optional[int] = 1_000_000,
    *,
    use_kernels: bool = True,
    device="cuda",
) -> Tuple[float, int]:
    """(PPL, predicted bytes) over windows of ``seq_len + 1`` (the dense
    path).  Batches of ``batch_size`` windows; the last batch is padded with
    zero windows whose labels are masked, so every forward has one shape."""
    if max_tokens is not None:
        tokens = tokens[:max_tokens]
    windows, valids = ppl_windows(tokens, seq_len)
    total_nll, total_cnt = 0.0, 0
    for i in range(0, len(windows), batch_size):
        wb = np.stack(windows[i:i + batch_size])
        vb = np.stack(valids[i:i + batch_size])
        pad = batch_size - len(wb)
        wb = np.pad(wb, ((0, pad), (0, 0)))
        vb = np.pad(vb, ((0, pad), (0, 0)))
        nll = _window_nll(params, cfg, torch.from_numpy(wb).to(device),
                          torch.from_numpy(vb).to(device), use_kernels=use_kernels)
        total_nll += float(nll)
        total_cnt += int(vb.sum())
    return float(np.exp(total_nll / max(total_cnt, 1))), total_cnt


@torch.no_grad()
def compute_ppl_incremental(
    params,
    cfg: ModelConfig,
    tokens: np.ndarray,
    seq_len: int,
    max_tokens: Optional[int] = 4096,
    *,
    use_kernels: bool = True,
    capture: bool = True,
    device="cuda",
) -> Tuple[float, int]:
    """Exact per-token PPL through the decode cache: each window's first
    byte is prefilled, then one decode step a byte, fed the true byte (not
    the argmax).  The steps read the next byte from the window on the device
    at a device position and add their NLL to a float64 device scalar (JAX
    sums Python floats on the host), so no step reads back to the host; on
    the card the loop is a captured CUDA graph of one step, replayed
    (``models/decode_graph.py``), and ``capture=False`` runs the same steps
    eagerly.  The cache is ``default_max_len`` rows (a multiple of 128; JAX
    rounds to ``lcm(block, 8)``): rows past the position are masked, so the
    NLL is the same."""
    if max_tokens is not None:
        tokens = tokens[:max_tokens]
    win = seq_len + 1
    max_len = default_max_len(cfg, win)
    params = fuse_decode_params(params, cfg)
    run_cache = None          # one cache for every window, so one graph serves them
    total_nll, total_cnt = 0.0, 0

    def step(s):
        token = s["window"].index_select(0, s["i"].reshape(1))
        logits, _ = transformer_decode_step(params, cfg, token, run_cache,
                                            use_kernels=use_kernels, pos=s["pos"])
        s["i"].add_(1)
        s["nll"].add_(_token_nll(logits, s["window"].index_select(0, s["i"].reshape(1)))[0])
        s["pos"].add_(1)

    for start in range(0, len(tokens) - 1, seq_len):
        chunk = tokens[start:start + win]
        if len(chunk) < 2:
            break
        window = torch.from_numpy(np.pad(chunk, (0, win - len(chunk))).astype(np.int64))
        window = window.to(device)
        logits, cache = transformer_forward(params, cfg, window[None, :1],
                                            return_cache_max_len=max_len,
                                            use_kernels=use_kernels)
        if run_cache is None:
            run_cache = cache
        else:
            copy_cache(run_cache, cache)
        state = {"window": window,
                 "pos": decode_graph.device_scalar(1, window.device),
                 "i": decode_graph.device_scalar(1, window.device, torch.long),
                 "nll": _token_nll(logits[0, -1], window[1]).double()}
        out = decode_graph.decode_loop(state, step, len(chunk) - 2,
                                       reads=(params, run_cache.layers),
                                       opts=(cfg, use_kernels), capture=capture)
        total_nll += float(out["nll"])
        total_cnt += len(chunk) - 1
    return float(np.exp(total_nll / max(total_cnt, 1))), total_cnt


def run_ppl_eval(
    params,
    cfg: ModelConfig,
    model_type: str,
    seq_len: int,
    id_tokens: np.ndarray,
    ood_tokens: np.ndarray,
    csv_path: Optional[str] = None,
    step: int = 0,
    max_id_tokens: int = 1_000_000,
    *,
    device="cuda",
) -> dict:
    """ID and OOD perplexity on the dense path as one row (appended to
    ``csv_path`` if given)."""
    ppl_id, n_id = compute_ppl(params, cfg, id_tokens, seq_len, max_tokens=max_id_tokens,
                               device=device)
    ppl_ood, n_ood = compute_ppl(params, cfg, ood_tokens, seq_len, max_tokens=None,
                                 device=device)
    row = {
        "model_type": model_type,
        "step": step,
        "seq_len": seq_len,
        "ppl_id": round(ppl_id, 4),
        "tokens_id": n_id,
        "ppl_ood": round(ppl_ood, 4),
        "tokens_ood": n_ood,
    }
    if csv_path:
        CSVLogger(csv_path).append(row)
    return row
