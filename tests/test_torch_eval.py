"""The port's evaluation layer against ``nsa_tpu``'s, on the CPU.

Seeded numpy bytes and the same weights (a JAX init carried across by
``params_from_numpy``, or the committed export read by both packages) go
through both packages' ``compute_ppl``, ``compute_ppl_incremental``,
``run_ppl_eval`` and ``generate_samples``; the QA byte stream, the
checkpoint's config, the perplexity table and the sweep's fixed columns
are compared as values.  Tolerances: perplexity rel 1e-5 on the tiny
config (float32 sums in another order), 1e-4 on the committed weights (six
layers at dim 512), the port's dense path against its incremental path
2e-3 (``tests/test_eval_suite.py``'s bound for JAX's own two paths);
counts, CSV rows and bytes exact.
"""

import dataclasses
import functools
import json
import math
import os

import jax
import numpy as np
import pytest
import torch

from nsa_tpu.config import model_config_from_json, tiny_test_config as j_tiny
from nsa_tpu.eval import efficiency as j_eff
from nsa_tpu.eval import generate as j_gen
from nsa_tpu.eval import perplexity as j_ppl
from nsa_tpu.eval import visualize as j_vis
from nsa_tpu.models import transformer as jt
from nsa_tpu.train import data as j_data
from nsa_tpu.utils import checkpoint as j_ckpt
from nsa_tpu_torch import tiny_test_config as t_tiny
from nsa_tpu_torch.eval import efficiency as t_eff
from nsa_tpu_torch.eval import generate as t_gen
from nsa_tpu_torch.eval import perplexity as t_ppl
from nsa_tpu_torch.eval import suite
from nsa_tpu_torch.eval import visualize as t_vis
from nsa_tpu_torch.train import data as t_data
from nsa_tpu_torch.utils import checkpoint as t_ckpt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "ckpt_export", "sparse_mlp_seq4096.npz")
REL = 1e-5


@functools.lru_cache(maxsize=None)
def model_params(sparse, seed=0):
    cfg = j_tiny(use_sparse_attn=sparse)
    params = jax.jit(jt.init_transformer, static_argnums=1)(jax.random.PRNGKey(seed), cfg)
    port = t_ckpt.params_from_numpy(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    return params, port


def corpus_bytes(n, seed):
    return np.random.RandomState(seed).randint(0, 256, n).astype(np.uint8)


@pytest.mark.parametrize("sparse", [True, False])
def test_compute_ppl_matches_jax(sparse):
    """Ten windows of 17 bytes, the last partial (6 bytes), in batches of 4:
    the last batch padded with two zero windows."""
    params, port = model_params(sparse)
    tokens = corpus_bytes(150, seed=1)
    want = j_ppl.compute_ppl(params, j_tiny(use_sparse_attn=sparse), tokens, seq_len=16,
                             batch_size=4)
    got = t_ppl.compute_ppl(port, t_tiny(use_sparse_attn=sparse), tokens, seq_len=16,
                            batch_size=4, device="cpu")
    assert got[1] == want[1] == 149
    assert got[0] == pytest.approx(want[0], rel=REL)


@pytest.mark.parametrize("sparse", [True, False])
def test_incremental_ppl_matches_jax_and_the_dense_path(sparse, monkeypatch):
    """Windows of 17 bytes (17, 17 and 6 bytes): the port's cache is 128
    rows, JAX's 24; rows past the position are masked, so the NLL agrees."""
    # JAX's prefill compiled whole: run eagerly it compiles op by op (~6 s)
    monkeypatch.setattr(j_ppl, "transformer_prefill",
                        jax.jit(jt.transformer_prefill, static_argnums=(1, 3)))
    params, port = model_params(sparse, seed=3)
    j_cfg, t_cfg = j_tiny(use_sparse_attn=sparse), t_tiny(use_sparse_attn=sparse)
    tokens = corpus_bytes(38, seed=2)
    assert t_ppl.default_max_len(t_cfg, 17) == 128
    blk = max(j_cfg.nsa.compress_block_sliding_stride,
              j_cfg.nsa.selection_block_size) if sparse else 1
    assert j_ppl.round_up_mult(17, math.lcm(blk, 8)) == 24      # JAX's rule
    want = j_ppl.compute_ppl_incremental(params, j_cfg, tokens, seq_len=16)
    got = t_ppl.compute_ppl_incremental(port, t_cfg, tokens, seq_len=16, device="cpu")
    dense = t_ppl.compute_ppl(port, t_cfg, tokens, seq_len=16, device="cpu")
    assert got[1] == want[1] == dense[1] == 37
    assert got[0] == pytest.approx(want[0], rel=REL)
    assert got[0] == pytest.approx(dense[0], rel=2e-3)
    plain = t_ppl.compute_ppl_incremental(port, t_cfg, tokens, seq_len=16, use_kernels=False,
                                          capture=False, device="cpu")
    assert plain == got                   # on the CPU the kernels' plain versions run anyway


def test_committed_weights_ppl_matches_jax():
    """``ckpt_export/sparse_mlp_seq4096.npz`` in float32 at seq_len 256 on
    1,000 synthetic corpus bytes: four windows, the last partial."""
    t_params, meta = t_ckpt.load_params_npz(WEIGHTS, device="cpu", dtype=torch.float32)
    t_cfg = t_ckpt.model_config_from_meta(meta).replace(dtype="float32")
    j_cfg = dataclasses.replace(model_config_from_json(json.dumps(meta["model_config"])),
                                dtype="float32", attn_impl="xla")
    template = jax.eval_shape(lambda: jt.init_transformer(jax.random.PRNGKey(0), j_cfg))
    j_params, _ = j_ckpt.import_params_npz(WEIGHTS, template)
    j_params = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), j_params)
    tokens = j_data.synthetic_byte_corpus(1000)
    want = j_ppl.compute_ppl(j_params, j_cfg, tokens, seq_len=256, batch_size=4)
    got = t_ppl.compute_ppl(t_params, t_cfg, tokens, seq_len=256, batch_size=4, device="cpu")
    assert got[1] == want[1] == 999
    assert got[0] == pytest.approx(want[0], rel=1e-4)
    assert got[0] < 4.0                    # the trained model, not a uniform one (256)


def test_ppl_and_generation_rows_match_jax(tmp_path, monkeypatch):
    # JAX's sampler compiled whole (eagerly it compiles op by op, ~20 s), and
    # both prompts of one length, so it compiles once
    monkeypatch.setattr(j_gen, "transformer_sample",
                        jax.jit(jt.transformer_sample, static_argnums=(1, 3),
                                static_argnames=("temperature",)))
    params, port = model_params(True, seed=5)
    id_tokens, ood = corpus_bytes(200, seed=6), t_data.load_cs441_qa_bytes()[:90]
    kw = dict(model_type="sparse_mlp", seq_len=32, id_tokens=id_tokens, ood_tokens=ood,
              step=7, max_id_tokens=150)
    want = j_ppl.run_ppl_eval(params, j_tiny(), csv_path=str(tmp_path / "j_ppl.csv"), **kw)
    got = t_ppl.run_ppl_eval(port, t_tiny(), csv_path=str(tmp_path / "t_ppl.csv"),
                             device="cpu", **kw)
    # ppl ~300 (a random init) rounded to 4 places: sum order shows there
    assert {k: v for k, v in got.items() if not k.startswith("ppl")} == \
        {k: v for k, v in want.items() if not k.startswith("ppl")}
    assert list(got) == list(want)
    for k in ("ppl_id", "ppl_ood"):
        assert got[k] == pytest.approx(want[k], rel=REL)
    header = (tmp_path / "t_ppl.csv").read_text().splitlines()[0]
    assert header == (tmp_path / "j_ppl.csv").read_text().splitlines()[0]

    snippet = id_tokens[:len(t_gen.DEFAULT_OOD_PROMPT)]
    kw = dict(model_type="sparse_mlp", gen_len=12, id_snippet=snippet, step=7)
    want = j_gen.generate_samples(params, j_tiny(), csv_path=str(tmp_path / "j_gen.csv"), **kw)
    got = t_gen.generate_samples(port, t_tiny(), csv_path=str(tmp_path / "t_gen.csv"),
                                 device="cpu", **kw)
    assert got == want
    assert (tmp_path / "t_gen.csv").read_text() == (tmp_path / "j_gen.csv").read_text()
    assert t_gen.DEFAULT_OOD_PROMPT == j_gen.DEFAULT_OOD_PROMPT


def test_qa_bytes_match_jax(tmp_path):
    for split in ("test", "train"):
        np.testing.assert_array_equal(t_data.load_cs441_qa_bytes(split=split),
                                      j_data.load_cs441_qa_bytes(split=split))
    assert t_data.synthetic_qa_pairs(196) == j_data.synthetic_qa_pairs(196)
    assert t_data.CS441_CANDIDATES == j_data.CS441_CANDIDATES[:2]
    assert t_data.CS441_TRAIN_CANDIDATES == j_data.CS441_TRAIN_CANDIDATES[:2]
    path = tmp_path / "qa.json"
    path.write_text(json.dumps([{"question": "Q: é?", "answer": "ñ"}, {"question": "x"}]))
    assert t_data.load_cs441_qa_pairs(str(path)) == j_data.load_cs441_qa_pairs(str(path))
    np.testing.assert_array_equal(t_data.load_cs441_qa_bytes(str(path)),
                                  j_data.load_cs441_qa_bytes(str(path)))


def test_model_config_from_a_port_checkpoint(tmp_path):
    cfg = t_tiny(use_sparse_attn=False, dtype="bfloat16")
    _, port = model_params(False)
    t_ckpt.save_checkpoint(str(tmp_path), 3, port, model_cfg=cfg)
    path = t_ckpt.latest_checkpoint(str(tmp_path))
    assert t_ckpt.model_config_from_checkpoint(path) == cfg
    assert dataclasses.asdict(j_ckpt.model_config_from_checkpoint(path)) == \
        dataclasses.asdict(cfg)


def test_ppl_table_matches_jax_and_plots_draw(tmp_path):
    ppl_csv = tmp_path / "ppl.csv"
    ppl_csv.write_text("model_type,step,seq_len,ppl_id,tokens_id,ppl_ood,tokens_ood\n"
                       "full_attn,0,512,3.1,99,5.6,9\nsparse_mlp,0,512,3.2,99,5.7,9\n")
    table = t_vis.ppl_markdown_table(str(ppl_csv))
    assert table == j_vis.ppl_markdown_table(str(ppl_csv))
    assert "| sparse_mlp | 512 | 3.2 | 5.7 |" in table
    pytest.importorskip("matplotlib")
    eff_csv = tmp_path / "eff.csv"
    lines = ["model_type,batch_size,prompt_len,prefill_tokens_per_s,decode_tokens_per_s,"
             "kv_cache_saving_ratio"]
    lines += [f"{m},{bs},{p},1e5,2e4,0.9" for m in ("full_attn", "sparse_mlp")
              for bs in (1, 8) for p in (500, 2000)]
    eff_csv.write_text("\n".join(lines) + "\n")
    loss_csv = tmp_path / "loss.csv"
    loss_csv.write_text("step,time_s,loss\n" + "".join(f"{i},{i},{3 - i / 100}\n"
                                                       for i in range(30)))
    out = [t_vis.plot_ppl(str(ppl_csv), str(tmp_path / "p" / "ppl.png")),
           t_vis.plot_efficiency(str(eff_csv), str(tmp_path / "eff.png")),
           t_vis.plot_train_loss({"sparse": str(loss_csv)}, str(tmp_path / "loss.png"))]
    assert all(os.path.getsize(p) > 1000 for p in out)


@pytest.mark.parametrize("sparse", [True, False])
def test_sweep_columns_follow_jax_rule(tmp_path, sparse):
    """JAX's sweep on the tiny config; the port's cache length, admission
    bucket (300 is capped at the cache's 384 rows) and KV saving per row."""
    j_cfg, t_cfg = j_tiny(use_sparse_attn=sparse), t_tiny(use_sparse_attn=sparse)
    params, port = model_params(sparse)
    prompts, gen, seq = [9, 130, 300], 4, 64
    rows = j_eff.run_efficiency_sweep(params, j_cfg, "m", batch_sizes=[1],
                                      prompt_lens=prompts, gen_len=gen, seq_len=seq)
    max_len = t_eff.sweep_max_len(t_cfg, prompts, gen, seq)
    assert max_len == 384
    for r in rows:
        assert r["max_len"] == max_len
        assert r["prefill_bucket"] == t_eff.prefill_bucket(r["prompt_len"], max_len)
        assert r["kv_cache_saving_ratio"] == round(
            t_eff.kv_cache_saving_ratio(t_cfg, r["prompt_len"]), 4)
    assert [r["prefill_bucket"] for r in rows] == [128, 256, 384]
    with pytest.raises(RuntimeError, match="CUDA"):
        t_eff.run_efficiency_sweep(port, t_cfg, "m", [1], prompts, gen, seq, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_eff.run_efficiency_eval(port, t_cfg, "m", 1, 9, gen, seq, device="cpu")


def test_suite_cli_on_tiny_checkpoints(tmp_path, monkeypatch, capsys):
    """``python -m nsa_tpu_torch.eval.suite --device cpu`` on tiny sparse and
    full checkpoints, the corpus loader patched to a small corpus."""
    cfgs = {"sparse_mlp": t_tiny(), "full_attn": t_tiny(use_sparse_attn=False)}
    for name, cfg in cfgs.items():
        port = model_params(cfg.use_sparse_attn)[1]
        t_ckpt.save_checkpoint(str(tmp_path / "ckpt" / f"{name}_seq32"), 5, port,
                               model_cfg=cfg)
    val = corpus_bytes(400, seed=8)
    monkeypatch.setattr(suite, "load_byte_corpus", lambda cfg: (val[:0], val))
    out = tmp_path / "out"
    suite.main(["--models", "mlp", "full", "--ckpt-root", str(tmp_path / "ckpt"),
                "--seq-len", "32", "--out-dir", str(out), "--skip-efficiency",
                "--max-id-tokens", "100", "--device", "cpu"])
    printed = capsys.readouterr().out
    ppl_rows = t_vis._read_csv(str(out / "ppl_seq32.csv"))
    gen_rows = t_vis._read_csv(str(out / "generation_seq32.csv"))
    assert [r["model_type"] for r in ppl_rows] == ["sparse_mlp", "full_attn"]
    assert [r["model_type"] for r in gen_rows] == ["sparse_mlp", "full_attn"]
    ood = t_data.load_cs441_qa_bytes()
    for r in ppl_rows:
        cfg = cfgs[r["model_type"]]
        port = model_params(cfg.use_sparse_attn)[1]
        want = t_ppl.run_ppl_eval(port, cfg, r["model_type"], 32, val, ood, step=5,
                                  max_id_tokens=100, device="cpu")
        assert r == {k: str(v) for k, v in want.items()}
        assert f"| {r['model_type']} | 32 | {r['ppl_id']} | {r['ppl_ood']} |" in printed
    for r in gen_rows:
        assert r["id_prompt"] == t_gen.decode_bytes(val[:64]) and len(r["id_generation"]) == 128
    assert not (out / "efficiency_seq32.csv").exists()
    if suite.importlib.util.find_spec("matplotlib"):
        assert (out / "ppl_plots.png").stat().st_size > 1000
