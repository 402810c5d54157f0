"""Byte-corpus data pipeline (``nsa_tpu/train/data.py``), numpy only.

The enwik8 pipeline: first 95e6 bytes, 90/5 train/val split, random crops
of ``seq_len + 1`` bytes.  Without the corpus file it falls back to a
deterministic synthetic byte corpus with enwik8-like statistics (the JAX
package's generator, copied): the same seed gives byte-identical corpora and
batches in both packages.  The synthetic corpus is cached under ``data/``
relative to the working directory, as the JAX package caches it.
"""

from __future__ import annotations

import gzip
import os
from typing import Iterator, List, Tuple

import numpy as np

from ..config import DataConfig

_SYLLABLES = [
    "ba", "co", "di", "fu", "ga", "he", "ji", "ka", "lo", "mu", "ne", "or",
    "pa", "qui", "ra", "so", "ta", "un", "ve", "wa", "xi", "yo", "zu",
    "tion", "ment", "er", "ing", "ly", "al", "ic", "st", "br",
]
_VOCAB_SIZE = 2048


def _make_vocab(seed: int) -> List[str]:
    """2048 deterministic pseudo-words built from syllables."""
    rng = np.random.RandomState(seed)
    vocab = []
    seen = set()
    while len(vocab) < _VOCAB_SIZE:
        k = int(rng.randint(2, 5))
        w = "".join(_SYLLABLES[int(i)]
                    for i in rng.randint(0, len(_SYLLABLES), size=k))
        if w not in seen:
            seen.add(w)
            vocab.append(w)
    return vocab


def synthetic_byte_corpus(num_bytes: int, seed: int = 1234) -> np.ndarray:
    """Deterministic pseudo-text byte corpus (enwik8 stand-in).

    Wiki-flavoured articles over a 2048-word Zipf vocabulary; each article
    introduces a few title-cased two-word entities that recur through its
    2-12 KB body, plus a year repeated at random offsets: long-range
    dependencies far beyond the 64-token sliding window.
    """
    rng = np.random.RandomState(seed)
    vocab = _make_vocab(seed)
    probs = 1.0 / np.arange(1, _VOCAB_SIZE + 1) ** 1.1
    probs /= probs.sum()

    chunks: List[bytes] = []
    total = 0
    while total < num_bytes:
        n_ent = int(rng.randint(3, 7))
        ents = [
            " ".join(vocab[int(i)].title()
                     for i in rng.randint(0, _VOCAB_SIZE, size=2))
            for _ in range(n_ent)
        ]
        year = int(rng.randint(1100, 2030))
        parts = [f"\n== {ents[0]} ==\n"]
        n_sent = int(rng.randint(40, 120))
        word_ids = rng.choice(_VOCAB_SIZE, size=n_sent * 18, p=probs)
        wpos = 0
        for _ in range(n_sent):
            n_w = int(rng.randint(6, 18))
            toks = [vocab[int(w)] for w in word_ids[wpos:wpos + n_w]]
            wpos += n_w
            r = rng.rand()
            if r < 0.35:
                toks.insert(int(rng.randint(0, len(toks))),
                            ents[int(rng.randint(0, n_ent))])
            if r > 0.9:
                toks.append(f"in {year}")
            joined = " ".join(toks)
            # uppercase only the first char: str.capitalize() would
            # lowercase the recurring title-cased entity mentions
            sent = joined[0].upper() + joined[1:] + ". "
            if rng.rand() < 0.05:
                sent = "[[" + sent.strip() + "]] "
            parts.append(sent)
        b = "".join(parts).encode("utf-8")
        chunks.append(b)
        total += len(b)
    return np.frombuffer(b"".join(chunks)[:num_bytes], dtype=np.uint8).copy()


def _synthetic_corpus_cached(num_bytes: int, seed: int = 1234) -> np.ndarray:
    """The synthetic corpus, cached as ``data/synthetic_v2_<bytes>_<seed>.npy``
    (the JAX package's file name, so either package reuses the other's)."""
    cache_dir = "data"
    path = os.path.join(cache_dir, f"synthetic_v2_{num_bytes}_{seed}.npy")
    if os.path.exists(path):
        return np.load(path)
    data = synthetic_byte_corpus(num_bytes, seed)
    try:
        os.makedirs(cache_dir, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.save(f, data)
        os.replace(tmp, path)
    except OSError:  # read-only working directory: skip the cache
        pass
    return data


def load_byte_corpus(cfg: DataConfig) -> Tuple[np.ndarray, np.ndarray]:
    """Return (train_bytes, val_bytes) uint8 arrays."""
    path = cfg.path
    if path and os.path.exists(path):
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as f:
            data = np.frombuffer(f.read(cfg.num_bytes), dtype=np.uint8).copy()
    elif cfg.allow_synthetic_fallback:
        data = _synthetic_corpus_cached(cfg.synthetic_bytes)
    else:
        raise FileNotFoundError(path)
    split = min(cfg.train_bytes, int(len(data) * 90 / 95))
    return data[:split], data[split:]


def sample_batch(
    data: np.ndarray, batch_size: int, seq_len: int, rng: np.random.RandomState
) -> np.ndarray:
    """Random crops of seq_len + 1 bytes -> [batch, seq_len + 1] int32."""
    hi = len(data) - seq_len - 1
    starts = rng.randint(0, hi, size=batch_size)
    idx = starts[:, None] + np.arange(seq_len + 1)[None, :]
    return data[idx].astype(np.int32)


def batch_iterator(
    data: np.ndarray, batch_size: int, seq_len: int, seed: int = 0
) -> Iterator[np.ndarray]:
    rng = np.random.RandomState(seed)
    while True:
        yield sample_batch(data, batch_size, seq_len, rng)
