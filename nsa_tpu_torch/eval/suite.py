"""The evaluation sweep as one CLI (``scripts/run_eval_suite.py``'s flags,
plus ``--device``):

    python -m nsa_tpu_torch.eval.suite [--models full mlp] [--seq-len 512] ...

For each model type it restores the newest checkpoint that the port's
trainer wrote under ``<ckpt-root>/<name>_seq<N><suffix>`` (a fresh seeded
model where there is none), then appends rows to the efficiency, perplexity
and generation CSVs in ``--out-dir`` and prints the perplexity table and
draws the plots.  The efficiency sweep measures and needs the card; pass
``--skip-efficiency`` with ``--device cpu``.  The default ``--out-dir`` is
``exp_result_torch/``, never the JAX package's ``exp_result/``.
"""

import argparse
import importlib.util
import os

import torch

from ..config import DataConfig, reference_model_config
from ..models.transformer import init_transformer
from ..train.data import load_byte_corpus, load_cs441_qa_bytes
from ..utils.checkpoint import latest_checkpoint, model_config_from_checkpoint, restore_checkpoint
from .efficiency import run_efficiency_sweep
from .generate import generate_samples
from .perplexity import run_ppl_eval
from .visualize import plot_efficiency, plot_ppl, ppl_markdown_table


def load_model(ckpt_dir, fallback_type, device="cuda"):
    """(params, cfg, step) from the newest checkpoint under ``ckpt_dir``, or
    a fresh model of ``fallback_type`` ("full" or a compressor) from seed 0
    in bf16."""
    ckpt = latest_checkpoint(ckpt_dir) if ckpt_dir else None
    if ckpt:
        cfg = model_config_from_checkpoint(ckpt)
        state, meta = restore_checkpoint(ckpt, names=("params",), device=device)
        return state["params"], cfg, meta.get("step", 0)
    cfg = reference_model_config(
        compressor=fallback_type if fallback_type not in ("full",) else "mlp",
        use_sparse_attn=fallback_type != "full",
    ).replace(dtype="bfloat16")
    return init_transformer(cfg, torch.Generator().manual_seed(0), device=device), cfg, 0


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--models", nargs="+", default=["full", "mlp"],
                   help="model types (checkpoint dirs ckpt/<name>_seqN or fresh)")
    p.add_argument("--ckpt-root", default="ckpt")
    p.add_argument("--ckpt-suffix", default="",
                   help="suffix after _seqN in checkpoint dir names "
                        "(e.g. _s5000 or _cpt)")
    p.add_argument("--seq-len", type=int, default=512)
    p.add_argument("--out-dir", default="exp_result_torch")
    p.add_argument("--batch-sizes", nargs="+", type=int, default=[1, 8, 64])
    p.add_argument("--prompt-lens", nargs="+", type=int, default=[500, 2000, 3900])
    p.add_argument("--gen-len", type=int, default=100)
    p.add_argument("--skip-efficiency", action="store_true")
    p.add_argument("--skip-ppl", action="store_true")
    p.add_argument("--skip-generate", action="store_true")
    p.add_argument("--max-id-tokens", type=int, default=200_000)
    p.add_argument("--attn-impl", default=None,
                   help="override attention impl (e.g. pallas) for all models; carried "
                        "into the config, the port has one path")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
    eff_csv = os.path.join(args.out_dir, f"efficiency_seq{args.seq_len}.csv")
    ppl_csv = os.path.join(args.out_dir, f"ppl_seq{args.seq_len}.csv")
    gen_csv = os.path.join(args.out_dir, f"generation_seq{args.seq_len}.csv")

    _, val = load_byte_corpus(DataConfig())
    ood = load_cs441_qa_bytes()

    for mt in args.models:
        name = "full_attn" if mt == "full" else f"sparse_{mt}"
        ckpt_dir = os.path.join(
            args.ckpt_root, f"{name}_seq{args.seq_len}{args.ckpt_suffix}"
        )
        params, cfg, step = load_model(ckpt_dir, mt, args.device)
        if args.attn_impl and cfg.use_sparse_attn:
            cfg = cfg.replace(attn_impl=args.attn_impl)
        print(f"== {name} (step {step}) ==")

        if not args.skip_ppl:
            row = run_ppl_eval(
                params, cfg, name, args.seq_len, val, ood, csv_path=ppl_csv,
                step=step, max_id_tokens=args.max_id_tokens, device=args.device,
            )
            print("ppl:", row)

        if not args.skip_efficiency:
            run_efficiency_sweep(
                params, cfg, name, args.batch_sizes, args.prompt_lens,
                args.gen_len, seq_len=args.seq_len, csv_path=eff_csv,
                step=step, device=args.device,
            )

        if not args.skip_generate:
            row = generate_samples(
                params, cfg, name, gen_len=128, id_snippet=val[:64],
                csv_path=gen_csv, step=step, device=args.device,
            )
            print("generated id sample:", row["id_generation"][:80])

    plots = importlib.util.find_spec("matplotlib") is not None
    if not plots:
        print("matplotlib is not installed: the plots were not drawn")
    if not args.skip_ppl and os.path.exists(ppl_csv):
        print(ppl_markdown_table(ppl_csv))
        if plots:
            plot_ppl(ppl_csv, os.path.join(args.out_dir, "ppl_plots.png"))
    if plots and not args.skip_efficiency and os.path.exists(eff_csv):
        plot_efficiency(eff_csv, os.path.join(args.out_dir, "efficiency_plots.png"))


if __name__ == "__main__":
    main()
