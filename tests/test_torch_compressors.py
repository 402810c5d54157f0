"""The port's compressor zoo (``nsa_tpu_torch/ops/compress.py``) against
``nsa_tpu/ops/compress.py``, all seven kinds, on the CPU:

* JAX's ``init_compressor`` params carried across by ``params_from_numpy``:
  ``apply_compressor`` and the gradients of a seeded cotangent with respect
  to the params and the windows, in float32;
* the output in bf16 (the windows in bf16, the params float32 and cast
  inside), against JAX's bf16 output; for ``mlp``, whose bf16 einsum into
  float32 JAX's CPU backend cannot run, against JAX's float32 output on the
  bf16-rounded windows and params;
* the port's ``init_compressor`` gives JAX's keys and shapes;
* for ``conv``, ``attn`` and ``transformer``, a tiny-config NSA layer from a
  JAX random init: the prefill with its cache, then 4 decode steps on the
  port's split route against ``nsa_tpu``'s XLA path (the only decode route
  of a compressor other than ``mlp`` in both packages);
* for those and ``mean``, JAX's ``.npz`` export of the layer read by the
  port, and the port's checkpoint of it written and restored, trees and
  leaves equal.

Tolerances.  float32: rtol 1e-5 with an atol of 1e-6 of the largest value
of the output, or of all the gradients (sums in another order; the absolute
term covers gradients that are zero but for rounding, such as the
``transformer`` kind's key bias, which the softmax cancels).  bf16: one
bf16 ulp at the largest output value (2^-7 of it): both packages round each
layer's output once to bf16 from float32 sums taken in another order, so a
rounding can flip by one ulp (``mlp``'s float32 reference also keeps the
hidden layer unrounded: half an ulp of it, carried through the second
product); the ``transformer`` kind 2^-6, for such flips carried through its
two layers, its softmax, norms and GELU.
The layer: atol/rtol 2e-4, the repo's prefill/decode tolerance
(``tests/test_torch_nsa.py``).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsa_tpu.config import NSAConfig as JNSAConfig
from nsa_tpu.config import tiny_test_config as j_tiny
from nsa_tpu.ops import compress as jcomp
from nsa_tpu.ops import nsa as j_nsa
from nsa_tpu.utils import checkpoint as j_ckpt
from nsa_tpu_torch import tiny_test_config as t_tiny
from nsa_tpu_torch.config import NSAConfig, TrainConfig
from nsa_tpu_torch.ops import compress as tcomp
from nsa_tpu_torch.ops import nsa as t_nsa
from nsa_tpu_torch.train.pretrain import make_optimizer, trainable
from nsa_tpu_torch.utils.checkpoint import (
    load_params_npz,
    model_config_from_checkpoint,
    model_config_from_meta,
    params_from_numpy,
    restore_checkpoint,
    save_checkpoint,
    tree_leaves,
)

KINDS = ("mlp", "conv", "attn", "mean", "shared_mlp", "single", "transformer")
KVH, D, BLOCK, STRIDE = 2, 8, 4, 2
LAYER_TOL = dict(rtol=2e-4, atol=2e-4)


def windows(seed):
    return np.random.RandomState(seed).standard_normal((2, KVH, 5, BLOCK, D)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def jax_compressor(kind):
    nsa = JNSAConfig(compress_block_size=BLOCK, compress_block_sliding_stride=STRIDE,
                     selection_block_size=4, compressor=kind)
    params = jcomp.init_compressor(jax.random.PRNGKey(7), nsa, KVH, D)
    return jax.tree_util.tree_map(np.asarray, params)


@functools.partial(jax.jit, static_argnums=(1,))
def jax_value_and_grads(params, kind, kv, cot):
    def f(p, x):
        out = jcomp.apply_compressor(p, kind, x)
        return jnp.sum(out * cot), out
    (_, out), grads = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(params, kv)
    return out, grads


def port_value_and_grads(params, kind, kv, cot):
    p = params_from_numpy(params, device="cpu")
    for leaf in jax.tree_util.tree_leaves(p):
        leaf.requires_grad_()
    x = torch.from_numpy(kv).requires_grad_()
    out = tcomp.apply_compressor(p, kind, x)
    (out * torch.from_numpy(cot)).sum().backward()
    return out, p, x.grad


def assert_close(got, want, rtol, atol, msg=""):
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=rtol, atol=atol,
                               err_msg=msg)


def largest(tree):
    return max(float(np.abs(np.asarray(x, np.float32)).max())
               for x in jax.tree_util.tree_leaves(tree))


@pytest.mark.parametrize("kind", KINDS)
def test_apply_and_grads_match_jax_float32(kind):
    params, kv = jax_compressor(kind), windows(1)
    cot = np.random.RandomState(2).standard_normal((2, KVH, 5, D)).astype(np.float32)
    j_out, (j_gp, j_gx) = jax_value_and_grads(params, kind, kv, cot)
    t_out, t_p, t_gx = port_value_and_grads(params, kind, kv, cot)
    assert tuple(t_out.shape) == (2, KVH, 5, D) and t_out.dtype == torch.float32
    assert_close(t_out, j_out, 1e-5, 1e-6 * largest(j_out))
    atol = 1e-6 * largest((j_gp, j_gx))
    assert_close(t_gx, j_gx, 1e-5, atol, "d windows")
    for path, g in jax.tree_util.tree_flatten_with_path(j_gp)[0]:
        leaf = t_p
        for key in path:
            leaf = leaf[key.key if hasattr(key, "key") else key.idx]
        assert_close(leaf.grad, g, 1e-5, atol, jax.tree_util.keystr(path))


@pytest.mark.parametrize("kind", KINDS)
def test_apply_matches_jax_bf16(kind):
    params, kv = jax_compressor(kind), windows(3)
    if kind == "mlp":
        # JAX's CPU backend cannot run this kind's bf16 einsum into float32:
        # its float32 math on the values the bf16 path sees instead
        rounded = jax.tree_util.tree_map(
            lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)), params)
        want = jcomp.apply_compressor(rounded, kind, jnp.asarray(kv, jnp.bfloat16)
                                      .astype(jnp.float32))
    else:
        want = jax.jit(jcomp.apply_compressor, static_argnums=1)(
            params, kind, jnp.asarray(kv, jnp.bfloat16))
        assert want.dtype == jnp.bfloat16
    got = tcomp.apply_compressor(params_from_numpy(params, device="cpu"), kind,
                                 torch.from_numpy(kv).bfloat16())
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    assert_close(got, want, 0, 2.0 ** (-6 if kind == "transformer" else -7) * largest(want))


@pytest.mark.parametrize("kind", KINDS)
def test_init_layout_matches_jax(kind):
    nsa = NSAConfig(compress_block_size=BLOCK, compress_block_sliding_stride=STRIDE,
                    selection_block_size=4, compressor=kind)
    port = tcomp.init_compressor(nsa, KVH, D, torch.Generator().manual_seed(0))
    want = jax.tree_util.tree_map(lambda x: x.shape, jax_compressor(kind))
    assert jax.tree_util.tree_map(lambda x: tuple(x.shape), port) == want
    if kind == "attn":
        assert torch.equal(port["w_logits"], torch.eye(D))
    with pytest.raises(ValueError, match="unknown compressor"):
        tcomp.init_compressor(dataclasses.replace(nsa, compressor="bogus"), KVH, D,
                              torch.Generator())


@functools.lru_cache(maxsize=None)
def layer_params(kind):
    j_cfg = j_tiny().replace(nsa=dataclasses.replace(j_tiny().nsa, compressor=kind))
    attn = jax.jit(j_nsa.init_sparse_attention, static_argnums=1)(jax.random.PRNGKey(3), j_cfg)
    return j_cfg, attn, params_from_numpy(jax.tree_util.tree_map(np.asarray, attn),
                                          device="cpu")


@pytest.mark.parametrize("kind", ["conv", "attn", "transformer"])
def test_layer_prefill_and_split_decode_match_jax(kind):
    j_cfg, j_attn, port = layer_params(kind)
    t_cfg = t_tiny().replace(nsa=dataclasses.replace(t_tiny().nsa, compressor=kind))
    prompt, steps, max_len = 9, 4, 16
    x = (np.random.RandomState(5).standard_normal((2, prompt + steps, 64)) * 0.5
         ).astype(np.float32)
    j_out, j_cache = jax.jit(functools.partial(
        j_nsa.sparse_attention_forward, cfg=j_cfg, return_cache_max_len=max_len))(
        j_attn, x=jnp.asarray(x[:, :prompt]))
    t_out, t_cache = t_nsa.sparse_attention_forward(
        port, t_cfg, torch.from_numpy(x[:, :prompt]), return_cache_max_len=max_len)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), **LAYER_TOL)
    rs = np.random.RandomState(6)
    ff = {"norm_scale": np.ones(64, np.float32),
          "w1": rs.uniform(-0.125, 0.125, (64, 256)).astype(np.float32),
          "b1": rs.uniform(-0.125, 0.125, 256).astype(np.float32),
          "w2": rs.uniform(-0.0625, 0.0625, (256, 64)).astype(np.float32),
          "b2": rs.uniform(-0.0625, 0.0625, 64).astype(np.float32)}
    j_step = jax.jit(lambda p, x_, c, t_, f: j_nsa.sparse_attention_decode(
        p, j_cfg, x_, c, t_, ff_params=f))
    layer = t_nsa.fuse_decode_layer({"attn": port, "ff": params_from_numpy(ff, device="cpu")},
                                    torch.float32, kind)
    packed = layer["attn"]
    assert set(packed["decode_fused"]) == {"w_qkvg"}
    for t in range(prompt, prompt + steps):
        j_y, j_cache = j_step(j_attn, jnp.asarray(x[:, t:t + 1]), j_cache, jnp.int32(t), ff)
        # b = 2 takes the fused route for mlp only: the default here is split
        t_y, t_cache = t_nsa.sparse_attention_decode(
            packed, t_cfg, torch.from_numpy(x[:, t:t + 1]), t_cache, t, ff_params=layer["ff"])
        np.testing.assert_allclose(t_y.numpy(), np.asarray(j_y), err_msg=f"t={t}", **LAYER_TOL)
        np.testing.assert_allclose(t_cache.ckv.numpy()[:, :, :-1],
                                   np.asarray(j_cache.ckv)[:, :, :-1], err_msg=f"t={t}",
                                   **LAYER_TOL)
    with pytest.raises(ValueError, match="mlp compressor"):
        t_nsa.sparse_attention_decode(packed, t_cfg, torch.from_numpy(x[:, :1]), t_cache,
                                      prompt + steps, route="fused")


@pytest.mark.parametrize("kind", ["mean", "conv", "attn", "transformer"])
def test_exports_and_checkpoints_carry_every_tree(kind, tmp_path):
    """JAX's ``export_params_npz`` of a layer read by ``load_params_npz``
    (``mean``'s empty dicts put back from the recorded config, the
    ``transformer`` kind's ``layers`` a list), then ``trainable``, a
    checkpoint with an optimizer state, its restore and its config."""
    if kind == "mean":
        j_cfg = j_tiny().replace(nsa=dataclasses.replace(j_tiny().nsa, compressor=kind))
        j_attn = j_nsa.init_sparse_attention(jax.random.PRNGKey(3), j_cfg)
    else:
        j_cfg, j_attn, _ = layer_params(kind)
    t_cfg = t_tiny().replace(nsa=dataclasses.replace(t_tiny().nsa, compressor=kind))
    tree = {"layers": [{"attn": j_attn}]}
    j_ckpt.export_params_npz(str(tmp_path / "w.npz"), tree, j_cfg)
    params, meta = load_params_npz(str(tmp_path / "w.npz"), device="cpu")
    assert model_config_from_meta(meta) == t_cfg
    assert (jax.tree_util.tree_structure(jax.tree_util.tree_map(np.asarray, tree))
            == jax.tree_util.tree_structure(params))
    compressor = params["layers"][0]["attn"]["k_compress"]
    assert (compressor == {}) == (kind == "mean")
    if kind == "transformer":
        assert isinstance(compressor["layers"], list) and len(compressor["layers"]) == 2
    for (path, want), got in zip(jax.tree_util.tree_flatten_with_path(tree)[0],
                                 jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=jax.tree_util.keystr(path))

    trained = trainable(params)
    loss = sum(leaf.sum() for leaf in tree_leaves(trained))
    loss.backward()
    opt = make_optimizer(TrainConfig(), trained)
    opt.step()
    path = save_checkpoint(str(tmp_path / "ckpt"), 3, trained, opt.state_dict(), t_cfg)
    state, _ = restore_checkpoint(path, device="cpu")
    assert model_config_from_checkpoint(path) == t_cfg
    assert (jax.tree_util.tree_structure(state["params"])
            == jax.tree_util.tree_structure(params))
    assert all(torch.equal(a, b.detach())
               for a, b in zip(tree_leaves(state["params"]), tree_leaves(trained)))
    assert len(state["opt_state"]["state"]) == len(tree_leaves(trained))
