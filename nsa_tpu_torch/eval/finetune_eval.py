"""QA accuracy of adapted models (``nsa_tpu/eval/finetune_eval.py``).

Greedy generation per question, answer extraction by regex, exact match on
the first token, accuracy with its Wilson interval, optionally beside the
frozen base; JSON results.  A ``forward_fn`` takes token ids [1, n] (an
int64 tensor on the CPU) and returns logits [1, n, vocab]; the ones made
here move the ids to the params' device and run without autograd.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import ModelConfig
from ..models.adapter import adapted_forward


def extract_answer(text: str) -> Optional[str]:
    """The text after the first 'Answer:', to the end of its line,
    stripped and lower-cased; None without one."""
    m = re.search(r"Answer:\s*([^\n]+)", text)
    if not m:
        return None
    return m.group(1).strip().lower()


def answer_matches(pred: Optional[str], gold: str) -> bool:
    """Exact match on the FIRST generated token: its first
    whitespace-delimited token, stripped of trailing punctuation, must
    equal the gold answer (so a degenerate 'bbbbbbbb' does not match
    'b')."""
    if pred is None:
        return False
    gold = gold.strip().lower()
    parts = pred.split()
    if not parts:
        return False
    tok = parts[0].strip(".,;:!?)('\"")
    return tok == gold


def _last_logits(forward_fn, ids: np.ndarray) -> np.ndarray:
    return forward_fn(torch.from_numpy(ids.astype(np.int64))[None])[0].float().cpu().numpy()


def greedy_generate_reforward(forward_fn, prompt_ids: np.ndarray, gen_len: int) -> np.ndarray:
    """Greedy generation by a whole forward each step over the growing ids
    (no cache), stopping after a newline."""
    ids = prompt_ids.copy()
    for _ in range(gen_len):
        nxt = int(np.argmax(_last_logits(forward_fn, ids)[-1]))
        ids = np.concatenate([ids, [nxt]])
        if nxt == ord("\n"):
            break
    return ids[len(prompt_ids):]


def greedy_generate_fixed(forward_fn, prompt_ids: np.ndarray, gen_len: int,
                          fixed_len: int) -> np.ndarray:
    """Greedy generation in a buffer of ``fixed_len`` tokens: causality
    makes the zero suffix irrelevant, so every step runs one shape.  An
    overlong prompt keeps its tail (the "...\\nAnswer: " cue)."""
    buf = np.zeros(fixed_len, np.int32)
    n0 = n = min(len(prompt_ids), fixed_len - 1)
    buf[:n] = prompt_ids[len(prompt_ids) - n:]
    for _ in range(gen_len):
        nxt = int(np.argmax(_last_logits(forward_fn, buf)[n - 1]))
        buf[n] = nxt
        n += 1
        if nxt == ord("\n") or n >= fixed_len:
            break
    return buf[n0:n]


def wilson_interval(correct: int, n: int, z: float = 1.96) -> Tuple[float, float]:
    """The 95% Wilson score interval of a binomial proportion."""
    if n == 0:
        return (0.0, 1.0)
    p = correct / n
    denom = 1 + z * z / n
    center = (p + z * z / (2 * n)) / denom
    half = z * np.sqrt(p * (1 - p) / n + z * z / (4 * n * n)) / denom
    return (max(0.0, center - half), min(1.0, center + half))


def model_forward_fn(fn, params) -> callable:
    """``forward_fn`` of ``fn(ids)`` on the params' device, without autograd."""
    device = params["token_emb"].device

    def forward(ids: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return fn(ids.to(device))
    return forward


def evaluate_qa_accuracy(
    adapters,
    teacher_params,
    cfg_student: ModelConfig,
    pairs: List[Tuple[str, str]],
    gen_len: int = 32,
    max_samples: int = 50,
    json_path: Optional[str] = None,
    compare_base=None,          # optional forward_fn of the frozen base
    fixed_len: Optional[int] = None,
) -> Dict:
    """The adapted model's QA accuracy on ``pairs[:max_samples]`` (greedy
    generation of ``gen_len`` tokens; at ``fixed_len`` in a fixed buffer),
    with the frozen base's beside it when ``compare_base`` is given."""
    student_fn = model_forward_fn(
        lambda ids: adapted_forward(adapters, teacher_params, cfg_student, ids), teacher_params)
    if fixed_len is not None:
        def gen_with(fn, prompt):
            return greedy_generate_fixed(fn, prompt, gen_len, fixed_len)
    else:
        def gen_with(fn, prompt):
            return greedy_generate_reforward(fn, prompt, gen_len)

    results, correct, base_correct = [], 0, 0
    for q, a in pairs[:max_samples]:
        prompt = np.frombuffer(f"{q}\nAnswer: ".encode(), np.uint8).astype(np.int32)
        gen = gen_with(student_fn, prompt)
        text = f"{q}\nAnswer: " + bytes(gen.astype(np.uint8)).decode(errors="ignore")
        pred = extract_answer(text)
        hit = answer_matches(pred, a)
        correct += int(hit)
        row = {"question": q, "gold": a, "pred": pred, "correct": hit}
        if compare_base is not None:
            bgen = gen_with(compare_base, prompt)
            btext = f"{q}\nAnswer: " + bytes(bgen.astype(np.uint8)).decode(errors="ignore")
            bpred = extract_answer(btext)
            bhit = answer_matches(bpred, a)
            base_correct += int(bhit)
            row.update({"base_pred": bpred, "base_correct": bhit})
        results.append(row)

    n = len(results)
    out = {
        "accuracy": correct / max(n, 1),
        "accuracy_ci95": wilson_interval(correct, n),
        "num_samples": n,
        "results": results,
    }
    if compare_base is not None:
        out["base_accuracy"] = base_correct / max(n, 1)
        out["base_accuracy_ci95"] = wilson_interval(base_correct, n)
    if json_path:
        os.makedirs(os.path.dirname(json_path) or ".", exist_ok=True)
        with open(json_path, "w") as f:
            json.dump(out, f, indent=2)
    return out
