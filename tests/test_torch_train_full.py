"""Training the full-attention model in the port against nsa_tpu's (tiny
config, float32, CPU), at n 200 > 128, so that the attention is taken in
query chunks of 128 (``max(attn_chunk_size, 128)``, as in JAX):

* ``transformer_loss`` and every parameter gradient against
  ``jax.value_and_grad(transformer_loss)`` (JAX's remat'd layer scan over
  its chunked XLA attention, each chunk remat'd);
* the recomputed chunks against the same chunks kept for the backward: the
  loss and every gradient bit for bit, and the recomputed forward keeps
  fewer bytes for the backward by at least the chunks' float32 logits;
* one ``train_step`` (accum 2) against JAX's;
* ``main(["--full-attention", ...])`` for one CPU step: the full model's
  config and its ``ckpt/full_attn_seq<n>`` directory.

Tolerances as ``tests/test_torch_train.py``: loss rtol 1e-5; gradients rtol
1e-3 / atol 2e-5 (float32 sums in another order through the softmax);
params after a step atol 1e-6 where the gradient decides its sign.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsa_tpu.config import TrainConfig as JTrainConfig
from nsa_tpu.config import tiny_test_config as j_tiny
from nsa_tpu.models import transformer as jt
from nsa_tpu.train import pretrain as jp
from nsa_tpu_torch import tiny_test_config as t_tiny
from nsa_tpu_torch.config import TrainConfig
from nsa_tpu_torch.models import transformer as tt
from nsa_tpu_torch.ops import attention as t_att
from nsa_tpu_torch.train import pretrain as tp
from nsa_tpu_torch.utils.checkpoint import latest_checkpoint, params_from_numpy, tree_leaves

GRAD_TOL = dict(rtol=1e-3, atol=2e-5)
N = 200


@functools.lru_cache(maxsize=None)
def jax_params(seed):
    return jax.jit(jt.init_transformer, static_argnums=1)(
        jax.random.PRNGKey(seed), j_tiny(use_sparse_attn=False))


def port_params(params):
    return tp.trainable(params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                          device="cpu"))


def port_leaf(tree, path):
    for key in path:
        tree = tree[key.key if hasattr(key, "key") else key.idx]
    return tree


def ids(shape, seed):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(np.int32)


def test_loss_and_grads_match_jax():
    params = jax_params(0)
    batch = ids((2, N + 1), 1)
    loss_j, grads_j = jax.jit(jax.value_and_grad(jt.transformer_loss), static_argnums=1)(
        params, j_tiny(use_sparse_attn=False), jnp.asarray(batch))
    tparams = port_params(params)
    loss_t = tt.transformer_loss(tparams, t_tiny(use_sparse_attn=False),
                                 torch.from_numpy(batch).long())
    loss_t.backward()
    assert loss_t.item() == pytest.approx(float(loss_j), rel=1e-5)
    for path, g in jax.tree_util.tree_flatten_with_path(grads_j)[0]:
        np.testing.assert_allclose(port_leaf(tparams, path).grad.numpy(), np.asarray(g),
                                   err_msg=jax.tree_util.keystr(path), **GRAD_TOL)


def loss_grads_and_saved_bytes(tparams, batch):
    saved = []

    def pack(t):
        saved.append(t.numel() * t.element_size())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = tt.transformer_loss(tparams, t_tiny(use_sparse_attn=False), batch)
    return loss, torch.autograd.grad(loss, tree_leaves(tparams)), sum(saved)


def test_recomputed_chunks_equal_kept_chunks_bit_for_bit(monkeypatch):
    tparams = port_params(jax_params(1))
    batch = torch.from_numpy(ids((2, N + 1), 2)).long()
    calls = []
    real = t_att.full_attention_chunked

    def counted(*args, **kw):
        calls.append(kw["chunk"])
        return real(*args, **kw)

    monkeypatch.setattr(tt, "full_attention_chunked", counted)
    loss_r, grads_r, bytes_r = loss_grads_and_saved_bytes(tparams, batch)
    assert calls == [128, 128]                    # one call a layer, JAX's chunk
    # the same chunks kept for the backward: checkpoint as a pass-through
    monkeypatch.setattr(t_att, "checkpoint", lambda fn, *args, **kw: fn(*args))
    loss_k, grads_k, bytes_k = loss_grads_and_saved_bytes(tparams, batch)
    assert torch.equal(loss_r, loss_k)
    assert all(torch.equal(a, b) for a, b in zip(grads_r, grads_k))
    # the kept path saves at least each layer's float32 logits of its chunks
    logits = 2 * 2 * 4 * (128 * 128 + (N - 128) * N) * 4
    assert bytes_k - bytes_r >= logits, (bytes_k, bytes_r)
    with torch.no_grad():                         # no gradient: the flash kernel's path
        monkeypatch.setattr(tt, "full_attention_chunked", None)
        assert torch.isfinite(tt.transformer_loss(tparams, t_tiny(use_sparse_attn=False), batch))


def test_train_step_matches_jax():
    """One optimizer step, accum 2 (see ``tests/test_torch_train.py``)."""
    params = jax_params(3)
    batch = ids((2, 2, N + 1), 4)
    jtrain = JTrainConfig()
    opt = jp.make_optimizer(jtrain)
    new_j, _, loss_j = jp._train_step_cpu(params, opt.init(params), jnp.asarray(batch),
                                          j_tiny(use_sparse_attn=False), opt, 2)
    tparams = port_params(params)
    loss_t = tp.train_step(tparams, tp.make_optimizer(TrainConfig(), tparams),
                           torch.from_numpy(batch).long(), t_tiny(use_sparse_attn=False), 2)
    assert loss_t.item() == pytest.approx(float(loss_j), rel=1e-5)
    lr = jtrain.learning_rate
    for path, want in jax.tree_util.tree_flatten_with_path(new_j)[0]:
        got = port_leaf(tparams, path).detach().numpy()
        g = port_leaf(tparams, path).grad.abs().numpy()
        decided = g > 1e-3 * g.max()
        want = np.asarray(want)
        np.testing.assert_allclose(got[decided], want[decided], rtol=0, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))
        assert np.abs(got - want).max() <= 2 * lr + 1e-6, jax.tree_util.keystr(path)


def test_cli_trains_the_full_model(tmp_path, monkeypatch):
    """The reference config and the synthetic corpus are cut to the tiny
    config and a 20,480-byte corpus; everything else is the CLI's."""
    monkeypatch.chdir(tmp_path)
    built = []

    def tiny_reference(**kw):
        built.append(kw)
        return t_tiny(use_sparse_attn=kw["use_sparse_attn"])

    corpus = np.tile(np.arange(256, dtype=np.uint8), 80)
    monkeypatch.setattr(tp, "reference_model_config", tiny_reference)
    monkeypatch.setattr(tp, "load_byte_corpus", lambda cfg: (corpus[:18_000], corpus[18_000:]))
    tp.main(["--full-attention", "--seq-len", str(N), "--batch-size", "1", "--grad-accum", "1",
             "--num-batches", "1", "--ckpt-every", "1", "--generate-every", "0",
             "--device", "cpu"])
    assert built == [{"compressor": "mlp", "use_sparse_attn": False}]
    ckpt = latest_checkpoint(f"ckpt/full_attn_seq{N}")
    assert ckpt is not None and ckpt.endswith("step_00000001")
    assert (tmp_path / "ckpt_export" / f"full_attn_seq{N}.npz").is_file()
    assert (tmp_path / "ckpt" / f"full_attn_seq{N}" / "train_log.csv").is_file()
