"""The port's training I/O against nsa_tpu's: the synthetic byte corpus and
its batches (byte-identical for the same seeds), checkpoints (saved and
restored exactly, partial saves skipped), the ``.npz`` export (read by
``nsa_tpu.utils.checkpoint.import_params_npz`` and by the port's
``load_params_npz`` with equal leaves) and the CSV metrics log."""

import csv
import json
import os

import jax
import numpy as np
import pytest
import torch

from nsa_tpu.config import DataConfig as JDataConfig
from nsa_tpu.config import tiny_test_config as j_tiny
from nsa_tpu.models.transformer import init_transformer as j_init
from nsa_tpu.train import data as jd
from nsa_tpu.utils.checkpoint import import_params_npz
from nsa_tpu_torch import tiny_test_config as t_tiny
from nsa_tpu_torch.config import DataConfig, TrainConfig, config_to_json
from nsa_tpu_torch.models.transformer import init_transformer, transformer_loss
from nsa_tpu_torch.train import data as td
from nsa_tpu_torch.train.pretrain import make_optimizer, trainable
from nsa_tpu_torch.utils.checkpoint import (
    export_params_npz,
    latest_checkpoint,
    load_params_npz,
    model_config_from_meta,
    restore_checkpoint,
    save_checkpoint,
    tree_items,
    tree_leaves,
    tree_to,
)
from nsa_tpu_torch.utils.metrics import MetricsLogger


@pytest.mark.parametrize("num_bytes,seed", [(5_000, 1234), (60_000, 7)])
def test_synthetic_corpus_matches_jax(num_bytes, seed):
    got = td.synthetic_byte_corpus(num_bytes, seed)
    want = jd.synthetic_byte_corpus(num_bytes, seed)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_batches_and_corpus_split_match_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = dict(path=str(tmp_path / "missing.gz"), synthetic_bytes=40_000)
    train_t, val_t = td.load_byte_corpus(DataConfig(**cfg))
    train_j, val_j = jd.load_byte_corpus(JDataConfig(**cfg))
    np.testing.assert_array_equal(train_t, train_j)
    np.testing.assert_array_equal(val_t, val_j)
    assert (tmp_path / "data" / "synthetic_v2_40000_1234.npy").is_file()
    for seed in (0, 5):
        rt, rj = np.random.RandomState(seed), np.random.RandomState(seed)
        for _ in range(3):
            np.testing.assert_array_equal(td.sample_batch(train_t, 4, 64, rt),
                                          jd.sample_batch(train_j, 4, 64, rj))
    it_t, it_j = td.batch_iterator(val_t, 2, 32, 3), jd.batch_iterator(val_j, 2, 32, 3)
    for _ in range(2):
        np.testing.assert_array_equal(next(it_t), next(it_j))


def test_checkpoint_roundtrip_is_exact(tmp_path):
    cfg = t_tiny()
    params = trainable(init_transformer(cfg, torch.Generator().manual_seed(0), device="cpu"))
    opt = make_optimizer(TrainConfig(), params)
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (2, 33)))
    transformer_loss(params, cfg, ids).backward()
    opt.step()
    path = save_checkpoint(str(tmp_path), 7, params, opt.state_dict(), cfg, extra={"loss": 1.5})
    os.makedirs(tmp_path / "step_00000009")          # a partial save: no meta.json
    assert latest_checkpoint(str(tmp_path)) == path

    state, meta = restore_checkpoint(path, device="cpu")
    assert meta["step"] == 7 and meta["loss"] == 1.5 and model_config_from_meta(meta) == cfg
    for a, b in zip(tree_leaves(state["params"]), tree_leaves(params)):
        assert torch.equal(a, b.detach())
    fresh = trainable(init_transformer(cfg, torch.Generator().manual_seed(1), device="cpu"))
    opt2 = make_optimizer(TrainConfig(), fresh)
    opt2.load_state_dict(state["opt_state"])
    s1, s2 = opt.state_dict()["state"], opt2.state_dict()["state"]
    assert s1.keys() == s2.keys()
    for k in s1:
        for name in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(s1[k][name], s2[k][name])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_export_npz_reads_in_both_packages(tmp_path, dtype):
    cfg = t_tiny()
    params = tree_to(init_transformer(cfg, torch.Generator().manual_seed(2), device="cpu"),
                     dtype=dtype)
    path = export_params_npz(str(tmp_path / "out" / "run.npz"), params, cfg,
                             extra={"step": 3})
    template = j_init(jax.random.PRNGKey(0), j_tiny())
    jtree, jmeta = import_params_npz(path, template)
    assert jmeta["step"] == 3 and jmeta["model_config"] == json.loads(config_to_json(cfg))
    mine = dict(tree_items(params))
    leaves = jax.tree_util.tree_flatten_with_path(jtree)[0]
    assert len(leaves) == len(mine)
    for kp, leaf in leaves:
        want = mine[jax.tree_util.keystr(kp)]
        got = np.asarray(leaf)
        assert got.shape == tuple(want.shape) and str(got.dtype) == str(dtype)[6:]
        np.testing.assert_array_equal(got.astype(np.float32), want.float().numpy())
    back, meta = load_params_npz(path, device="cpu")
    assert meta["step"] == 3
    for (ka, a), (kb, b) in zip(tree_items(back), tree_items(params)):
        assert ka == kb and a.dtype == b.dtype and torch.equal(a, b)


def test_metrics_logger_csv_schema(tmp_path, capsys):
    path = tmp_path / "logs" / "train.csv"
    log = MetricsLogger(str(path))
    log.log(0, valid_loss=2.5)
    log.log(1, loss=2.25, tokens_per_s=100, extra=1)
    assert "step 1: loss=2.2500 tokens_per_s=100" in capsys.readouterr().out
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["step", "time_s", "loss", "tokens_per_s", "valid_loss"]
    assert rows[1][0] == "0" and rows[1][4] == "2.5"
    assert rows[2][0] == "1" and rows[2][2] == "2.25" and rows[2][5:] == ["1"]
