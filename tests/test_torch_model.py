"""The port's model against nsa_tpu's on the same weights (tiny config,
float32, CPU): prefill logits, then 8 greedy decode steps, with the blocks
every selection picked; greedy generation; and the port's own check that
prefill equals incremental decode (as tests/test_decode_equivalence.py does
for nsa_tpu).

Tolerance: logits atol/rtol 2e-4 (the repo's prefill/decode tolerance);
selected block ids and greedy tokens exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsa_tpu.config import tiny_test_config as j_tiny
from nsa_tpu.models import transformer as jt
from nsa_tpu.ops import nsa as j_nsa
from nsa_tpu_torch import tiny_test_config as t_tiny
from nsa_tpu_torch.models import transformer as tt
from nsa_tpu_torch.ops import nsa as t_nsa
from nsa_tpu_torch.ops.cuda import nsa_decode as t_dec
from nsa_tpu_torch.utils.checkpoint import params_from_numpy

TOL = dict(rtol=2e-4, atol=2e-4)


@functools.lru_cache(maxsize=None)
def model_params(seed):
    params = jax.jit(jt.init_transformer, static_argnums=1)(jax.random.PRNGKey(seed), j_tiny())
    return params, params_from_numpy(jax.tree_util.tree_map(np.asarray, params), device="cpu")


def prompt_ids(b, n, seed):
    return np.random.RandomState(seed).randint(0, 256, (b, n)).astype(np.int32)


class SelectionLog:
    """Records (ids, valid) of every select_blocks call, in call order; on
    the JAX side through an ordered debug callback, so jitted code reports
    the values it computes."""

    def __init__(self, fn, jax_side=False):
        self.fn, self.jax_side, self.calls = fn, jax_side, []

    def _record(self, idx, msk):
        self.calls.append((np.asarray(idx).reshape(-1), np.asarray(msk).reshape(-1)))

    def __call__(self, scores, num_selected_blocks, use_diff_topk, **kw):
        sel = self.fn(scores, num_selected_blocks, use_diff_topk, **kw)
        if self.jax_side:
            jax.debug.callback(self._record, sel.indices, sel.mask, ordered=True)
        else:
            self._record(sel.indices, sel.mask)
        return sel


def test_prefill_and_greedy_decode_match_jax(monkeypatch):
    """At b = 2 the port decodes on its fused route, JAX on its XLA path."""
    prefill_and_greedy_decode_against_jax(monkeypatch, route=None)


def test_prefill_and_greedy_decode_match_jax_split_route(monkeypatch):
    prefill_and_greedy_decode_against_jax(monkeypatch, route="split")


def prefill_and_greedy_decode_against_jax(monkeypatch, route):
    params, port = model_params(0)
    j_cfg, t_cfg = j_tiny(), t_tiny()
    prompt, steps, max_len = 13, 8, 32
    ids = prompt_ids(2, prompt, seed=1)
    # every selection of both packages; prompt <= attn_chunk_size, so the
    # prefill selects once per layer in both
    j_log = SelectionLog(j_nsa.select_blocks, jax_side=True)
    t_log = SelectionLog(t_nsa.select_blocks)
    monkeypatch.setattr(j_nsa, "select_blocks", j_log)
    monkeypatch.setattr(t_nsa, "select_blocks", t_log)
    monkeypatch.setattr(t_dec, "select_blocks", t_log)

    j_logits, j_cache = jax.jit(lambda p, i: jt.transformer_prefill(p, j_cfg, i, max_len))(
        params, jnp.asarray(ids))
    j_step = jax.jit(lambda p, tok, c: jt.transformer_decode_step(p, j_cfg, tok, c))
    t_logits, t_cache = tt.transformer_prefill(port, t_cfg, torch.from_numpy(ids), max_len)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), **TOL)
    token = np.asarray(j_logits[:, -1]).argmax(-1)
    assert (t_logits[:, -1].argmax(-1).numpy() == token).all()
    for step in range(steps):
        j_logits, j_cache = j_step(params, jnp.asarray(token), j_cache)
        t_logits, t_cache = tt.transformer_decode_step(port, t_cfg, torch.from_numpy(token),
                                                       t_cache, route=route)
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                                   err_msg=f"step {step}", **TOL)
        token = np.asarray(j_logits).argmax(-1)
        assert (t_logits.argmax(-1).numpy() == token).all(), f"step {step}"
    assert t_cache.seq_len == int(j_cache.seq_len) == prompt + steps
    jax.effects_barrier()

    # depth 2: one prefill selection and 8 decode selections per layer
    assert len(t_log.calls) == len(j_log.calls) == 2 * (1 + steps)
    for i, ((ti, tm), (ji, jm)) in enumerate(zip(t_log.calls, j_log.calls)):
        np.testing.assert_array_equal(ti, ji, err_msg=f"selection {i}")
        np.testing.assert_array_equal(tm, jm, err_msg=f"selection {i}")


def test_greedy_generation_matches_jax_sampler():
    params, port = model_params(2)
    ids = prompt_ids(2, 11, seed=3)
    want = jt.transformer_sample(params, j_tiny(), jnp.asarray(ids), 10, max_len=32)
    got = tt.transformer_greedy(port, t_tiny(), torch.from_numpy(ids), 10, max_len=32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    split = tt.transformer_greedy(port, t_tiny(), torch.from_numpy(ids), 10, max_len=32,
                                  route="split")
    np.testing.assert_array_equal(split.numpy(), np.asarray(want))
    assert tt.transformer_greedy(port, t_tiny(), torch.from_numpy(ids), 0).shape == (2, 0)


@pytest.mark.parametrize("n,prompt", [(24, 8), (19, 5), (17, 16), (18, 1)])
def test_prefill_equals_incremental_decode(n, prompt):
    prefill_equals_incremental_decode(n, prompt, route=None)


@pytest.mark.parametrize("n,prompt", [(24, 8), (18, 1)])
def test_prefill_equals_incremental_decode_split_route(n, prompt):
    prefill_equals_incremental_decode(n, prompt, route="split")


def prefill_equals_incremental_decode(n, prompt, route):
    _, port = model_params(4)
    cfg = t_tiny()
    ids = torch.from_numpy(prompt_ids(2, n, seed=n))
    full = tt.transformer_forward(port, cfg, ids)
    logits, cache = tt.transformer_prefill(port, cfg, ids[:, :prompt], 32)
    outs = [logits[:, -1]]
    for t in range(prompt, n):
        logits, cache = tt.transformer_decode_step(port, cfg, ids[:, t], cache, route=route)
        outs.append(logits)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full[:, prompt - 1:].numpy(),
                               **TOL)


def test_random_init_layout_matches_jax():
    params, _ = model_params(0)
    port = tt.init_transformer(t_tiny(), torch.Generator().manual_seed(0), device="cpu")
    j_shapes = jax.tree_util.tree_map(lambda x: x.shape, params)
    t_shapes = jax.tree_util.tree_map(lambda x: tuple(x.shape), port)
    assert t_shapes == j_shapes
    np.testing.assert_array_equal(port["layers"][1]["attn"]["gate_b"].numpy(),
                                  np.asarray(params["layers"][1]["attn"]["gate_b"]))
    # swiglu runs since the adapter line (tests/test_torch_adapter.py); an FF
    # kind neither package has raises
    with pytest.raises(ValueError, match="ff_kind"):
        tt.transformer_forward(port, t_tiny(ff_kind="relu"), torch.zeros(1, 4, dtype=torch.long))
