"""Synthetic QA data collection (``nsa_tpu/train/data_collection.py``, a
plain-Python copy: the port imports nothing of ``nsa_tpu``).

A seed bank of distributed-systems questions expanded through
deterministic paraphrase frames and split 196 train / 84 test, written as
JSON lists of {"question", "answer"}:

    python -m nsa_tpu_torch.train.data_collection     # data/cs441_synthetic_*.json
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

SEED_BANK: List[Dict[str, str]] = [
    {"question": "Which consistency model makes reads reflect all prior writes in real time?",
     "answer": "linearizability"},
    {"question": "Which commit protocol coordinates participants with a prepare phase then a commit phase?",
     "answer": "two-phase commit"},
    {"question": "How many replicas are needed to tolerate f crash failures with majority quorums?",
     "answer": "2f+1"},
    {"question": "Which consensus algorithm decomposes agreement into leader election and log replication?",
     "answer": "raft"},
    {"question": "Which partitioning technique minimizes data movement when nodes join or leave?",
     "answer": "consistent hashing"},
    {"question": "Which theorem says a partitioned system must choose between consistency and availability?",
     "answer": "the CAP theorem"},
    {"question": "Which logical clock orders events without synchronized physical clocks?",
     "answer": "lamport timestamps"},
    {"question": "Which vector-based clock detects concurrent updates between replicas?",
     "answer": "vector clocks"},
    {"question": "Which failure detector property guarantees every crash is eventually suspected?",
     "answer": "completeness"},
    {"question": "Which replication style applies every operation in the same order at all replicas?",
     "answer": "state machine replication"},
    {"question": "Which storage structure batches writes in memory and merges sorted runs on disk?",
     "answer": "lsm tree"},
    {"question": "Which delivery guarantee can duplicate a message but never lose it?",
     "answer": "at-least-once"},
    {"question": "Which technique breaks one logical update across shards with compensating actions?",
     "answer": "saga"},
    {"question": "Which gossip mechanism spreads membership updates epidemically?",
     "answer": "anti-entropy"},
]

FRAMES = [
    "{q}",
    "In a distributed system, {q_lower}",
    "Exam question: {q}",
    "Short answer: {q}",
    "Consider a cluster of unreliable nodes. {q}",
    "For the systems final: {q}",
    "A practitioner asks: {q}",
    "Quiz: {q}",
    "During a design review someone asks: {q_lower}",
    "Interview question: {q}",
    "True understanding check: {q}",
    "From the lecture notes: {q}",
    "Lab follow-up: {q}",
    "Midterm review: {q}",
    "Design exercise: {q}",
    "Reliability drill: {q}",
    "Clarify this: {q_lower}",
    "One-liner: {q}",
    "Core concept: {q}",
    "Final check: {q}",
]


def generate_synthetic_qa(num: int = 280) -> List[Dict[str, str]]:
    """Deterministic expansion: every (frame, seed) combination in order."""
    out = []
    i = 0
    while len(out) < num:
        frame = FRAMES[i % len(FRAMES)]
        seed = SEED_BANK[(i // len(FRAMES)) % len(SEED_BANK)]
        q = seed["question"]
        out.append({
            "question": frame.format(q=q, q_lower=q[0].lower() + q[1:]),
            "answer": seed["answer"],
        })
        i += 1
    return out


def split_train_test(
    data: List[Dict], train_n: int = 196, test_n: int = 84
) -> Dict[str, List[Dict]]:
    """Same split sizes as the reference (196 train / 84 test,
    data_collection/readme.md)."""
    assert len(data) >= train_n + test_n
    return {"train": data[:train_n], "test": data[train_n:train_n + test_n]}


def write_dataset(out_dir: str = "data") -> Dict[str, str]:
    os.makedirs(out_dir, exist_ok=True)
    data = generate_synthetic_qa(280)
    splits = split_train_test(data)
    paths = {}
    for split, rows in splits.items():
        path = os.path.join(out_dir, f"cs441_synthetic_{split}.json")
        with open(path, "w") as f:
            json.dump(rows, f, indent=2)
        paths[split] = path
    return paths


if __name__ == "__main__":
    print(write_dataset())
