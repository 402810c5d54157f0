"""Append-only CSV metrics logging (``nsa_tpu/utils/metrics.py``, without
the optional wandb sink): the same CSV schema, so the JAX package's
plotters read the port's logs."""

from __future__ import annotations

import csv
import os
import time
from typing import Dict, Optional


class CSVLogger:
    """Append rows to a CSV, writing the header on first creation."""

    def __init__(self, path: str):
        self.path = path
        if os.path.dirname(path):
            os.makedirs(os.path.dirname(path), exist_ok=True)

    def append(self, row: Dict):
        """Append one row; the header is fixed by the first row ever
        written, later rows are aligned to it (missing keys blank, new keys
        appended in order at the end, so nothing is silently dropped)."""
        exists = os.path.exists(self.path)
        fields = list(row.keys())
        if exists:
            with open(self.path, newline="") as f:
                header = next(csv.reader(f), None)
            if header:
                fields = header + [k for k in row if k not in header]
        with open(self.path, "a", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=fields, extrasaction="ignore")
            if not exists:
                writer.writeheader()
            writer.writerow(row)


class MetricsLogger:
    """stdout + optional CSV training logger."""

    def __init__(self, csv_path: Optional[str] = None):
        self.csv = CSVLogger(csv_path) if csv_path else None
        self._t0 = time.time()

    def log(self, step: int, **metrics):
        stamp = time.time() - self._t0
        parts = " ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                         for k, v in metrics.items())
        print(f"[{stamp:8.1f}s] step {step}: {parts}", flush=True)
        if self.csv:
            # unified schema: train and valid rows share one header
            row = {"step": step, "time_s": round(stamp, 2),
                   "loss": "", "tokens_per_s": "", "valid_loss": ""}
            row.update(metrics)
            self.csv.append(row)
