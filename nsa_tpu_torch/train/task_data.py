"""Fine-tuning task loaders and answer extraction
(``nsa_tpu/train/task_data.py``, a plain-Python copy: the port imports
nothing of ``nsa_tpu``).

Plain JSON / JSONL readers returning ``[{"question", "answer"}, ...]`` for
GSM8K, AQuA, StrategyQA, Date-Understanding and augmented ASDiv, offline
only (point ``path`` at a local copy).  The byte-level "chat template"
frames examples as the CS441 QA serialization does (``Question
...\nAnswer: ...``), so fine-tuned byte models and the imported-Llama
adapter line share one collation path
(:func:`nsa_tpu_torch.train.finetune.qa_to_tokens` masks the prompt span).
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional, Tuple

# default file names per task, mirroring the reference loaders
_TASK_FILES = {
    "gsm8k": {"train": "train_socratic.jsonl", "dev": "test_socratic.jsonl",
              "test": "test_socratic.jsonl"},
    "aqua": {"train": "gsm_style_train.jsonl", "dev": "gsm_style_dev.jsonl",
             "test": "gsm_style_test.jsonl"},
    "asdiv": {"train": "aug-train.jsonl", "dev": "aug-dev.jsonl",
              "test": "aug-dev.jsonl"},
    "du": {"train": "date_understanding_gsm_style.json",
           "dev": "date_understanding_gsm_style.json",
           "test": "date_understanding_gsm_style.json"},
    "strategyqa": {"train": "strategyqa_train.json",
                   "dev": "strategyqa_train.json",
                   "test": "strategyqa_train.json"},
}

TASKS = tuple(_TASK_FILES)


def _read_json_or_jsonl(path: str) -> List[dict]:
    """Accept a JSON array OR one-JSON-object-per-line (the reference
    mixes both, e.g. AQuA json.load()s files named .jsonl)."""
    with open(path, encoding="utf-8") as f:
        text = f.read().strip()
    if not text:
        return []
    if text[0] == "[":
        return json.loads(text)
    return [json.loads(line) for line in text.splitlines() if line.strip()]


def load_task(
    task: str, path: str, split: str = "train",
    strategyqa_train_split: float = 0.8,
) -> List[Dict[str, str]]:
    """Load one task split as ``[{"question": ..., "answer": ...}, ...]``.

    ``path`` is a directory (reference file names are used) or a file.
    StrategyQA has a single file split 80/20 by position (reference:
    fine_tune/data_loader.py:86-105).
    """
    if task not in _TASK_FILES:
        raise ValueError(f"unknown task {task!r}; have {TASKS}")
    if os.path.isdir(path):
        path = os.path.join(path, _TASK_FILES[task][split])
    rows = _read_json_or_jsonl(path)
    if task == "strategyqa":
        n_train = int(len(rows) * strategyqa_train_split)
        rows = rows[:n_train] if split == "train" else rows[n_train:]
    out = []
    for r in rows:
        q = r.get("question", r.get("input", ""))
        a = r.get("answer", r.get("target", ""))
        if isinstance(a, bool):  # raw StrategyQA style
            a = "yes" if a else "no"
        out.append({"question": str(q), "answer": str(a)})
    return out


_FINAL_RE = re.compile(r"####\s*([^\n]+)")
_NUMBER_RE = re.compile(r"-?\$?[\d,]*\.?\d+")


def final_answer(task: str, answer_text: str) -> str:
    """Extract the final short answer from a worked solution.

    GSM8K-style tasks end with ``#### <answer>``; StrategyQA answers are
    yes/no (reference: evaluation/fine_tune/
    evaluate_sparse_attention_finetune.py:25-67 does the same extraction
    on generations)."""
    if task == "strategyqa":
        m = re.search(r"\b(yes|no)\b", answer_text.lower())
        return m.group(1) if m else answer_text.strip().lower()
    m = _FINAL_RE.search(answer_text)
    if m:
        return m.group(1).strip().replace(",", "").replace("$", "")
    nums = _NUMBER_RE.findall(answer_text)
    return nums[-1].replace(",", "").replace("$", "") if nums else ""


def format_chat(question: str, answer: Optional[str] = None,
                system: Optional[str] = None) -> str:
    """Byte-level chat framing (the HF-chat-template equivalent for byte
    models; matches the CS441 OOD serialization so eval and fine-tune see
    one format)."""
    parts = []
    if system:
        parts.append(f"{system}\n\n")
    parts.append(f"{question}\nAnswer: ")
    if answer is not None:
        parts.append(f"{answer}\n\n")
    return "".join(parts)


def task_pairs(task: str, path: str, split: str = "train",
               ) -> List[Tuple[str, str]]:
    """(question, answer) tuples ready for finetune.qa_to_tokens."""
    return [(r["question"], r["answer"]) for r in load_task(task, path, split)]
