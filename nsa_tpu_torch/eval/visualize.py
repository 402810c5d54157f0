"""Result plots and the perplexity table (``nsa_tpu/eval/visualize.py``).

They read the CSVs that ``eval/perplexity.py`` and ``eval/efficiency.py``
write (and the trainer's loss logs) and draw the JAX package's dashboards:
PPL bars (ID / OOD by sequence length), decode tok/s against prompt length
and batch, prefill tok/s against prompt length, KV access saving, and
training loss; ``ppl_markdown_table`` renders the PPL CSV as markdown.
``matplotlib`` is imported by the plot functions only, so the table and
the rest of the port need none.
"""

from __future__ import annotations

import csv
import os
from collections import defaultdict
from typing import Dict, List


def _pyplot():
    """matplotlib's pyplot on the file-only Agg backend."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt

def _read_csv(path: str) -> List[Dict[str, str]]:
    with open(path) as f:
        return list(csv.DictReader(f))


def ppl_markdown_table(csv_path: str) -> str:
    rows = _read_csv(csv_path)
    lines = [
        "| model_type | seq_len | ppl_id | ppl_ood |",
        "|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| {r['model_type']} | {r['seq_len']} | {r['ppl_id']} | {r['ppl_ood']} |"
        )
    return "\n".join(lines)


def plot_ppl(csv_path: str, out_path: str) -> str:
    """ID and OOD PPL bars, one column of panels a sequence length."""
    plt = _pyplot()
    rows = _read_csv(csv_path)
    seq_lens = sorted({int(r["seq_len"]) for r in rows})
    fig, axes = plt.subplots(
        2, max(len(seq_lens), 1), figsize=(5 * max(len(seq_lens), 1), 8),
        squeeze=False,
    )
    for j, sl in enumerate(seq_lens):
        sub = [r for r in rows if int(r["seq_len"]) == sl]
        names = [r["model_type"] for r in sub]
        for i, key in enumerate(["ppl_id", "ppl_ood"]):
            vals = [float(r[key]) for r in sub]
            ax = axes[i][j]
            ax.bar(names, vals)
            ax.set_title(f"{key} @ seq {sl}")
            ax.tick_params(axis="x", rotation=30)
            for x, v in enumerate(vals):
                ax.text(x, v, f"{v:.3f}", ha="center", va="bottom", fontsize=8)
    fig.tight_layout()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_efficiency(csv_path: str, out_path: str) -> str:
    """2x2 dashboard: decode tok/s against prompt length (a line a batch
    size) and against batch (at the longest prompt), prefill tok/s against
    prompt length, and the KV access saving against prompt length."""
    plt = _pyplot()
    rows = _read_csv(csv_path)
    by_model = defaultdict(list)
    for r in rows:
        by_model[r["model_type"]].append(r)

    fig, axes = plt.subplots(2, 2, figsize=(12, 9))

    for model, sub in sorted(by_model.items()):
        # one line per batch size in the vs-prompt panels (a single line
        # through every (bs, prompt) row draws a sawtooth)
        by_bs = defaultdict(list)
        for r in sub:
            by_bs[int(r["batch_size"])].append(r)
        for bs, rows_bs in sorted(by_bs.items()):
            rows_bs = sorted(rows_bs, key=lambda r: int(r["prompt_len"]))
            prompts = [int(r["prompt_len"]) for r in rows_bs]
            axes[0][0].plot(
                prompts,
                [float(r["decode_tokens_per_s"]) for r in rows_bs],
                marker="o", label=f"{model} bs{bs}",
            )
            axes[1][0].plot(
                prompts,
                [float(r["prefill_tokens_per_s"]) for r in rows_bs],
                marker="s", label=f"{model} bs{bs}",
            )
        # decode vs batch at the LARGEST prompt length (the headline axis)
        pmax = max(int(r["prompt_len"]) for r in sub)
        by_batch = sorted(
            (r for r in sub if int(r["prompt_len"]) == pmax),
            key=lambda r: int(r["batch_size"]),
        )
        axes[0][1].plot(
            [int(r["batch_size"]) for r in by_batch],
            [float(r["decode_tokens_per_s"]) for r in by_batch],
            marker="o", label=f"{model} prompt {pmax}",
        )
        # KV saving depends only on prompt length
        seen = {}
        for r in sorted(sub, key=lambda r: int(r["prompt_len"])):
            seen[int(r["prompt_len"])] = float(r["kv_cache_saving_ratio"])
        axes[1][1].plot(
            list(seen.keys()), list(seen.values()), marker="^", label=model,
        )

    axes[0][0].set(title="decode tok/s vs prompt len", xlabel="prompt len")
    axes[0][1].set(title="decode tok/s vs batch", xlabel="batch size")
    axes[1][0].set(title="prefill tok/s vs prompt len", xlabel="prompt len")
    axes[1][1].set(title="KV access saving vs prompt len", xlabel="prompt len")
    for ax in axes.flat:
        ax.legend(fontsize=8)
        ax.grid(alpha=0.3)
    fig.tight_layout()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def _read_loss_csv(path: str):
    """Read a MetricsLogger CSV, tolerating the legacy mixed-shape files
    whose header was fixed by whichever row type (train vs valid) came
    first: rows wider than the header are mapped positionally to the
    train-row schema (step, time_s, loss, tokens_per_s)."""
    with open(path, newline="") as f:
        rdr = csv.reader(f)
        header = next(rdr, None)
        if header is None:
            return []
        rows = []
        for vals in rdr:
            if len(vals) <= len(header):
                rows.append(dict(zip(header, vals)))
            elif len(vals) == 4:
                rows.append(dict(zip(
                    ("step", "time_s", "loss", "tokens_per_s"), vals)))
        return rows


def plot_train_loss(csv_paths: Dict[str, str], out_path: str,
                    smooth: int = 20) -> str:
    """Overlay training loss curves from MetricsLogger CSVs."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(8, 5))
    for label, path in csv_paths.items():
        rows = [r for r in _read_loss_csv(path) if r.get("loss")]
        steps = [int(r["step"]) for r in rows]
        loss = [float(r["loss"]) for r in rows]
        if smooth > 1 and len(loss) > smooth:
            loss = [
                sum(loss[max(0, i - smooth + 1):i + 1]) /
                len(loss[max(0, i - smooth + 1):i + 1])
                for i in range(len(loss))
            ]
        ax.plot(steps, loss, label=label)
    ax.set(xlabel="step", ylabel="train loss", title="pretraining loss")
    ax.legend()
    ax.grid(alpha=0.3)
    fig.tight_layout()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path
