"""Continuous pretraining: the port's loop
(``nsa_tpu_torch/train/continuous_pretrain.py``) against the JAX package's
``scripts/continuous_pretrain.py`` on the CPU, float32, from one tiny
checkpoint written in each package's format (the same params).

Both packages' corpus loaders are patched to one seeded 24,000-byte corpus
(``data/enwik8.gz`` is absent, and the 32 MB synthetic fallback takes about
a minute to generate); the CS441 QA bytes are the built-in synthetic pairs
in both.  Two steps at batch 4 x seq 64 (half QA, half corpus crops), an
eval point at step 2 on 300 bytes at seq 64.

Tolerances: the logged losses rel 1e-5 (``tests/test_torch_train.py``);
the eval point's perplexities rel 1e-4 (float32 sums of ~600 NLLs in
another order); the final params: Adam's update is ~lr times the sign of
the gradient, so an element whose gradient float32 noise can flip moves by
up to 2 lr a step the other way; every element within 2 lr a step, and all
but 0.5% within 1e-6.
"""

import csv
import importlib.util
import os
import sys

import jax
import numpy as np
import pytest
import torch

import nsa_tpu.eval.perplexity  # noqa: F401  (imported by the script's eval point)
import nsa_tpu.train.pretrain  # noqa: F401  (imported by the script)
from nsa_tpu.config import tiny_test_config as j_tiny
from nsa_tpu.models.transformer import init_transformer
from nsa_tpu.utils.checkpoint import save_checkpoint as j_save
from nsa_tpu_torch import tiny_test_config as t_tiny
from nsa_tpu_torch.train import continuous_pretrain as tcpt
from nsa_tpu_torch.utils.checkpoint import params_from_numpy, restore_checkpoint
from nsa_tpu_torch.utils.checkpoint import save_checkpoint as t_save

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP, STEPS, LR = 5, 2, 3e-5
# the loop is the same for every model: the full-attention one compiles
# fastest in JAX (the sparse model's training is held in test_torch_train)
J_CFG, T_CFG = j_tiny(use_sparse_attn=False), t_tiny(use_sparse_attn=False)
J_INIT = jax.jit(init_transformer, static_argnums=1)
FLAGS = ["--num-batches", str(STEPS), "--batch-size", "4", "--seq-len", "64",
         "--eval-every", "2", "--eval-max-tokens", "300"]


def jax_script():
    spec = importlib.util.spec_from_file_location(
        "continuous_pretrain_script", os.path.join(ROOT, "scripts", "continuous_pretrain.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def corpus():
    data = np.random.RandomState(11).randint(32, 127, 24_000).astype(np.uint8)
    return data[:20_000], data[20_000:]


def log_rows(path):
    """The CSV's rows without the time column: the header is fixed by the
    first row (step, time_s, loss, tokens_per_s, valid_loss, cpt_loss) and
    the eval point's two perplexities follow it unnamed, in both packages."""
    with open(path, newline="") as f:
        return [[float(x) if x else None for i, x in enumerate(r) if i != 1]
                for r in list(csv.reader(f))[1:]]


def test_continuous_pretrain_matches_jax_script(tmp_path, monkeypatch):
    params = J_INIT(jax.random.PRNGKey(2), J_CFG)
    j_save(str(tmp_path / "jax"), STEP, params, model_cfg=J_CFG)
    t_save(str(tmp_path / "port"), STEP,
           params_from_numpy(jax.tree_util.tree_map(np.asarray, params), device="cpu"),
           model_cfg=T_CFG)

    script = jax_script()
    j_final = {}

    def keep(directory, step, p, *args, **kw):     # the script's checkpoints, not written
        j_final[step] = jax.tree_util.tree_map(np.asarray, p)
        return directory

    monkeypatch.setattr(script, "load_byte_corpus", lambda cfg: corpus())
    monkeypatch.setattr(script, "save_checkpoint", keep)
    # the script's init is only the restore's template: jitted, the same arrays
    monkeypatch.setattr(script, "init_transformer", J_INIT)
    monkeypatch.setattr(sys, "argv", ["continuous_pretrain.py", "--ckpt-dir",
                                      str(tmp_path / "jax"), "--force-cpu", *FLAGS])
    script.main()

    monkeypatch.setattr(tcpt, "load_byte_corpus", lambda cfg: corpus())
    tcpt.main(["--ckpt-dir", str(tmp_path / "port"), "--device", "cpu", *FLAGS])

    j_rows = log_rows(tmp_path / "jax_cpt" / "cpt_log.csv")
    t_rows = log_rows(tmp_path / "port_cpt" / "cpt_log.csv")
    # two loss rows (steps 0 and 1), then the eval point's ppl_id, ppl_ood
    assert [r[0] for r in t_rows] == [r[0] for r in j_rows] == [0, 1, STEPS]
    for got, want in zip(t_rows, j_rows):
        assert [x is None for x in got] == [x is None for x in want]
        rel = 1e-5 if got[0] < STEPS else 1e-4
        for g, w in zip(got[1:], want[1:]):
            assert g == w or g == pytest.approx(w, rel=rel), (got, want)

    # an eval-point checkpoint and the final one, at the restored step plus
    assert sorted(j_final) == [STEP + STEPS]
    state, meta = restore_checkpoint(str(tmp_path / "port_cpt" / f"step_{STEP + STEPS:08d}"),
                                     device="cpu")
    assert meta["continuous_pretrain"] and meta["step"] == STEP + STEPS
    assert set(state["opt_state"]["state"]) and not meta["model_config"]["use_sparse_attn"]
    t_leaves = [t.numpy() for t in jax.tree_util.tree_leaves(state["params"])]
    j_leaves = jax.tree_util.tree_leaves(j_final[STEP + STEPS])
    assert len(t_leaves) == len(j_leaves)
    diffs = np.concatenate([np.abs(t - j).ravel() for t, j in zip(t_leaves, j_leaves)])
    assert diffs.max() <= 2 * LR * STEPS + 1e-6
    assert np.mean(diffs > 1e-6) <= 0.005, np.mean(diffs > 1e-6)
    with pytest.raises(SystemExit):      # --mesh names its backend (tests/test_torch_parallel.py)
        tcpt.main(["--ckpt-dir", str(tmp_path / "port"), "--mesh"])
    with pytest.raises(FileNotFoundError):
        tcpt.run_continuous_pretrain(str(tmp_path / "missing"), device="cpu")
    assert torch.is_grad_enabled()
