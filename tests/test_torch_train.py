"""The port's training path against nsa_tpu's on the same weights (tiny
config, float32, CPU):

* ``transformer_loss`` and every parameter gradient against
  ``jax.value_and_grad(transformer_loss)`` with ``impl="pallas"`` (the fused
  kernel and its Pallas backward in interpret mode), and the gradient of
  the straight-through gates is nonzero;
* one ``train_step`` (accum 2) against ``_train_step_cpu`` with
  ``make_optimizer``: the params after the Adam update;
* a short ``run_pretrain`` on the CPU, then its resume.

Tolerances: loss rtol 1e-5; gradients rtol 1e-3 / atol 2e-5 (float32 sums
in another order through two softmaxes and the top-k scores, the bound
``tests/test_impl_equivalence.py`` uses between the JAX paths); params
after a step atol 1e-6 where the gradient is decided (see the test).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from nsa_tpu.config import TrainConfig as JTrainConfig
from nsa_tpu.config import tiny_test_config as j_tiny
from nsa_tpu.models import transformer as jt
from nsa_tpu.train import pretrain as jp
from nsa_tpu_torch import tiny_test_config as t_tiny
from nsa_tpu_torch.config import DataConfig, TrainConfig
from nsa_tpu_torch.models import transformer as tt
from nsa_tpu_torch.ops import nsa as t_nsa
from nsa_tpu_torch.train import pretrain as tp
from nsa_tpu_torch.utils.checkpoint import latest_checkpoint, params_from_numpy, tree_leaves

GRAD_TOL = dict(rtol=1e-3, atol=2e-5)


@functools.lru_cache(maxsize=None)
def jax_params(seed):
    return jax.jit(jt.init_transformer, static_argnums=1)(
        jax.random.PRNGKey(seed), j_tiny(attn_chunk_size=16))


def port_params(params):
    return tp.trainable(params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                          device="cpu"))


def port_leaf(tree, path):
    for key in path:
        tree = tree[key.key if hasattr(key, "key") else key.idx]
    return tree


def ids(shape, seed):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(np.int32)


def test_loss_and_grads_match_jax(monkeypatch):
    params = jax_params(0)
    batch = ids((1, 49), 1)
    # scan_layers=False: the remat'd layer scan cannot hold the interpret
    # mode's ordered callbacks; the per-layer loop computes the same loss
    with pltpu.force_tpu_interpret_mode():
        loss_j, grads_j = jax.value_and_grad(jt.transformer_loss)(
            params, j_tiny(attn_chunk_size=16, scan_layers=False), jnp.asarray(batch),
            impl="pallas")

    gates = []

    def keep_gates(*args, **kw):
        args[5].retain_grad()
        gates.append(args[5])
        return fine_sliding(*args, **kw)

    fine_sliding = t_nsa.nsa_fine_sliding_attention
    monkeypatch.setattr(t_nsa, "nsa_fine_sliding_attention", keep_gates)
    tparams = port_params(params)
    loss_t = tt.transformer_loss(tparams, t_tiny(attn_chunk_size=16),
                                 torch.from_numpy(batch).long())
    loss_t.backward()

    assert loss_t.item() == pytest.approx(float(loss_j), rel=1e-5)
    for path, g in jax.tree_util.tree_flatten_with_path(grads_j)[0]:
        np.testing.assert_allclose(port_leaf(tparams, path).grad.numpy(), np.asarray(g),
                                   err_msg=jax.tree_util.keystr(path), **GRAD_TOL)
    assert len(gates) == 2 and all(g.grad is not None and g.grad.abs().max() > 0
                                   for g in gates)


def test_train_step_matches_jax():
    """One optimizer step, accum 2.  Adam's first update is lr * g / (|g| +
    eps): where |g| is below 1e-3 of its tensor's largest gradient, float32
    noise may flip its sign, so there the test only bounds the move by 2 lr;
    elsewhere the updated params agree to 1e-6.  (The clipped gradient the
    step leaves in ``.grad`` decides which is which.)"""
    params = jax_params(3)
    jcfg = j_tiny(attn_chunk_size=16)
    batch = ids((2, 2, 33), 4)
    jtrain = JTrainConfig()
    opt = jp.make_optimizer(jtrain)
    new_j, _, loss_j = jp._train_step_cpu(params, opt.init(params), jnp.asarray(batch),
                                          jcfg, opt, 2)

    tparams = port_params(params)
    loss_t = tp.train_step(tparams, tp.make_optimizer(TrainConfig(), tparams),
                           torch.from_numpy(batch).long(), t_tiny(attn_chunk_size=16), 2)
    assert loss_t.item() == pytest.approx(float(loss_j), rel=1e-5)
    lr = jtrain.learning_rate
    for path, want in jax.tree_util.tree_flatten_with_path(new_j)[0]:
        got = port_leaf(tparams, path).detach().numpy()
        g = port_leaf(tparams, path).grad.abs().numpy()      # the step's clipped gradient
        decided = g > 1e-3 * g.max()
        want = np.asarray(want)
        np.testing.assert_allclose(got[decided], want[decided], rtol=0, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))
        assert np.abs(got - want).max() <= 2 * lr + 1e-6, jax.tree_util.keystr(path)


def test_run_pretrain_cpu_and_resume(tmp_path, monkeypatch):
    """Two steps with a checkpoint at step 2, then a resume to step 3 that
    starts from the saved params; everything lands in the working directory."""
    monkeypatch.chdir(tmp_path)
    cfg = t_tiny(attn_chunk_size=16)
    tc = TrainConfig(num_batches=2, batch_size=2, grad_accum_every=2, seq_len=48,
                     log_every=1, validate_every=1, generate_every=1, generate_length=4,
                     prime_length=8, ckpt_every=2, ckpt_dir="ckpt/tiny",
                     log_csv="ckpt/tiny/log.csv")
    data = DataConfig(path="missing.gz", synthetic_bytes=50_000)
    params, loss = tp.run_pretrain(cfg, tc, data, device="cpu")
    assert np.isfinite(loss)
    assert latest_checkpoint("ckpt/tiny").endswith("step_00000002")
    assert (tmp_path / "ckpt_export" / "tiny.npz").is_file()
    assert (tmp_path / "data" / "synthetic_v2_50000_1234.npy").is_file()

    start = []
    monkeypatch.setattr(tp, "train_step", lambda p, *a, **k: (
        start.append([x.detach().clone() for x in tree_leaves(p)]) or torch.tensor(loss)))
    tp.run_pretrain(cfg, dataclasses.replace(tc, num_batches=3), data, device="cpu")
    assert len(start) == 1
    for got, want in zip(start[0], tree_leaves(params)):
        assert torch.equal(got, want.detach())
