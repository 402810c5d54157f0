"""Generation samples (``nsa_tpu/eval/generate.py``): greedy bytes from a
fixed OOD QA prompt and from an in-distribution corpus snippet, one CSV row
a model (model_type, step, id_prompt, id_generation, ood_prompt,
ood_generation).  Decoding goes through ``transformer_sample`` at
temperature 0, so at b = 1 the sparse model decodes on the whole-model
kernel, as a captured loop on the card.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import DataConfig, ModelConfig
from ..models.transformer import transformer_sample
from ..train.data import load_byte_corpus
from ..utils.metrics import CSVLogger

DEFAULT_OOD_PROMPT = (
    "Q: Which protocol uses prepare and commit phases across participants?\nAnswer: "
)


def decode_bytes(tokens: np.ndarray) -> str:
    """Bytes as printable text: control bytes below 32 become spaces."""
    return "".join(chr(max(32, int(t))) for t in tokens)


@torch.no_grad()
def greedy_continuation(params, cfg: ModelConfig, ids: np.ndarray, gen_len: int, *,
                        device="cuda") -> np.ndarray:
    """The ``gen_len`` greedy bytes after the prompt ``ids`` [n], on ``device``."""
    prompt = torch.from_numpy(np.asarray(ids, np.int64))[None].to(device)
    return transformer_sample(params, cfg, prompt, gen_len, temperature=0.0)[0].cpu().numpy()


def generate_samples(
    params,
    cfg: ModelConfig,
    model_type: str,
    gen_len: int = 256,
    id_snippet: Optional[np.ndarray] = None,
    ood_prompt: str = DEFAULT_OOD_PROMPT,
    csv_path: Optional[str] = None,
    step: int = 0,
    *,
    device="cuda",
) -> dict:
    """Greedy continuations of ``id_snippet`` (default: the first 64 bytes
    of the default corpus's validation split) and ``ood_prompt``, ``gen_len``
    bytes each, on ``device``."""
    if id_snippet is None:
        _, val = load_byte_corpus(DataConfig())
        id_snippet = val[:64]
    ood_ids = np.frombuffer(ood_prompt.encode(), np.uint8)
    id_out = greedy_continuation(params, cfg, id_snippet, gen_len, device=device)
    ood_out = greedy_continuation(params, cfg, ood_ids, gen_len, device=device)
    row = {
        "model_type": model_type,
        "step": step,
        "id_prompt": decode_bytes(id_snippet),
        "id_generation": decode_bytes(id_out),
        "ood_prompt": ood_prompt,
        "ood_generation": decode_bytes(ood_out),
    }
    if csv_path:
        CSVLogger(csv_path).append(row)
    return row
