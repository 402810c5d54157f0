"""The port's NSA layer against nsa_tpu's on the same weights and inputs:
the prefill forward with its decode cache, and the scalar-position decode
step over positions that cross compressed-block emissions.

float32 on the CPU, the port's kernel wrappers running their plain
versions.  Tolerance atol/rtol 2e-4, the repo's prefill/decode tolerance
(tests/test_decode_equivalence.py): float32 sums in another order through
two attention layers' worth of matmuls.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsa_tpu.config import tiny_test_config as j_tiny
from nsa_tpu.models.transformer import init_transformer
from nsa_tpu.ops import nsa as j_nsa
from nsa_tpu_torch import tiny_test_config as t_tiny
from nsa_tpu_torch.ops import nsa as t_nsa
from nsa_tpu_torch.utils.checkpoint import params_from_numpy

TOL = dict(rtol=2e-4, atol=2e-4)


@functools.lru_cache(maxsize=None)
def layer_params(seed=0):
    """Layer-0 attention and FF params of a JAX tiny model, in both packages."""
    params = jax.jit(init_transformer, static_argnums=1)(jax.random.PRNGKey(seed), j_tiny())
    layer = params["layers"][0]
    port = params_from_numpy(jax.tree_util.tree_map(np.asarray, layer), device="cpu")
    return layer, port


def inputs(n, seed, b=2, dim=64):
    return (np.random.RandomState(seed).standard_normal((b, n, dim)) * 0.5).astype(np.float32)


def assert_cache_equal(t_cache, j_cache, trash=True):
    """Every leaf equal; ``trash=False`` leaves out ckv's last row, the trash
    row that only the split route writes."""
    for name, t_leaf, j_leaf in zip(t_cache._fields, t_cache, j_cache):
        t_leaf, j_leaf = t_leaf.numpy(), np.asarray(j_leaf)
        if name == "ckv" and not trash:
            t_leaf, j_leaf = t_leaf[:, :, :-1], j_leaf[:, :, :-1]
        np.testing.assert_allclose(t_leaf, j_leaf, err_msg=name, **TOL)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("n,chunk", [(3, 128), (24, 128), (37, 16)])
def test_prefill_forward_with_cache(impl, n, chunk):
    layer, port = layer_params()
    x = inputs(n, seed=n + 1)
    max_len = 48
    j_out, j_cache = jax.jit(functools.partial(
        j_nsa.sparse_attention_forward, cfg=j_tiny(attn_chunk_size=chunk), impl=impl,
        return_cache_max_len=max_len))(layer["attn"], x=jnp.asarray(x))
    t_out, t_cache = t_nsa.sparse_attention_forward(
        port["attn"], t_tiny(attn_chunk_size=chunk), torch.from_numpy(x),
        return_cache_max_len=max_len)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), **TOL)
    assert_cache_equal(t_cache, j_cache)
    no_cache = t_nsa.sparse_attention_forward(port["attn"], t_tiny(attn_chunk_size=chunk),
                                              torch.from_numpy(x))
    assert torch.equal(no_cache, t_out)


@pytest.mark.parametrize("prompt", [1, 6])
def test_decode_steps_across_emissions(prompt):
    """stride 2: every other step emits a compressed block; 14 steps cross
    seven emissions and a selection-block boundary every 4 positions.  At
    b = 2 the port takes its fused route, against JAX's XLA path."""
    decode_steps_against_jax(prompt, route=None)


@pytest.mark.parametrize("prompt", [1, 6])
def test_decode_steps_across_emissions_split_route(prompt):
    """The same steps on the port's split route, trash row included."""
    decode_steps_against_jax(prompt, route="split")


def decode_steps_against_jax(prompt, route):
    layer, port = layer_params()
    steps, max_len = 14, 32
    x = inputs(prompt + steps, seed=8)
    j_cfg, t_cfg = j_tiny(), t_tiny()
    j_step = jax.jit(lambda p, x_, c, t_, ff: j_nsa.sparse_attention_decode(
        p, j_cfg, x_, c, t_, ff_params=ff))
    _, j_cache = j_nsa.sparse_attention_forward(
        layer["attn"], j_cfg, jnp.asarray(x[:, :prompt]), return_cache_max_len=max_len)
    _, t_cache = t_nsa.sparse_attention_forward(
        port["attn"], t_cfg, torch.from_numpy(x[:, :prompt]), return_cache_max_len=max_len)
    for t in range(prompt, prompt + steps):
        j_out, j_cache = j_step(layer["attn"], jnp.asarray(x[:, t:t + 1]), j_cache,
                                jnp.int32(t), layer["ff"])
        t_out, t_cache = t_nsa.sparse_attention_decode(
            port["attn"], t_cfg, torch.from_numpy(x[:, t:t + 1]), t_cache, t,
            ff_params=port["ff"], route=route)
        np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), err_msg=f"t={t}", **TOL)
        assert_cache_equal(t_cache, j_cache, trash=route == "split")


def test_decode_plain_and_wrapper_paths_agree_on_cpu():
    """use_kernels=False calls the plain versions directly; on CPU tensors the
    wrappers run the same plain versions, so both paths give equal bits."""
    plain_and_wrapper_paths_agree(route=None)


def test_decode_plain_and_wrapper_paths_agree_on_cpu_split_route():
    plain_and_wrapper_paths_agree(route="split")


def plain_and_wrapper_paths_agree(route):
    _, port = layer_params()
    cfg = t_tiny()
    x = torch.from_numpy(inputs(10, seed=10))
    _, c1 = t_nsa.sparse_attention_forward(port["attn"], cfg, x[:, :9], return_cache_max_len=16)
    c2 = t_nsa.NSADecodeCache(*(leaf.clone() for leaf in c1))
    a, _ = t_nsa.sparse_attention_decode(port["attn"], cfg, x[:, 9:], c1, 9, route=route)
    b, _ = t_nsa.sparse_attention_decode(port["attn"], cfg, x[:, 9:], c2, 9, use_kernels=False,
                                         route=route)
    assert torch.equal(a, b)


def test_unported_configurations_raise():
    """The configurations the port once refused (non-causal, selection block
    = stride, per-head selection) now run, the forward with its cache
    (tests/test_torch_configs.py holds them against JAX); the cache widths
    and shapes are JAX's."""
    _, port = layer_params()
    x = torch.from_numpy(inputs(4, seed=3, b=1))
    nsa = t_tiny().nsa
    for cfg in (t_tiny(causal=False),
                t_tiny(nsa=nsa.__class__(compress_block_size=4, compress_block_sliding_stride=4,
                                         selection_block_size=4)),
                t_tiny(nsa=nsa.__class__(query_heads_share_selected_kv=False))):
        out, cache = t_nsa.sparse_attention_forward(port["attn"], cfg, x, return_cache_max_len=8)
        assert tuple(out.shape) == (1, 4, 64) and bool(torch.isfinite(out).all())
        assert tuple(cache.ckv.shape) == (1, 2, t_nsa._ckv_width(
            8, cfg.nsa.compress_block_sliding_stride, cfg.nsa.num_compress_per_fine), 32)
    assert t_nsa._ckv_width(4096, 8, 2) == j_nsa._ckv_width(4096, 8, 2) == 520
    empty = t_nsa.init_decode_cache(t_tiny(), 2, 32, device="cpu")
    j_empty = j_nsa.init_decode_cache(j_tiny(), 2, 32)
    assert [tuple(x.shape) for x in empty] == [x.shape for x in j_empty]
