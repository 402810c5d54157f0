"""The committed trained weights through both packages.

``ckpt_export/sparse_mlp_seq4096.npz`` (the reference configuration, 6
layers at dim 512), cast to float32, on the CPU, at bs 2: the prefill of a
300-token prompt (three query chunks) into a 1024-row cache, then 24 greedy
decode steps.  JAX runs its XLA path (``attn_impl="xla"``); the port runs
its plain versions on both of its small-batch decode routes: the
whole-model decode (its default at bs 2) and the per-layer fused route, so
this holds both routes' plain versions against JAX's split XLA math on
real weights.

Tolerance: logits atol/rtol 2e-4, the repo's prefill/decode tolerance
(float32 sums in another order through six layers); greedy tokens exact.
"""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsa_tpu.config import model_config_from_json
from nsa_tpu.models import transformer as jt
from nsa_tpu.utils.checkpoint import import_params_npz
from nsa_tpu_torch.models import transformer as tt
from nsa_tpu_torch.utils.checkpoint import load_params_npz, model_config_from_meta

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "ckpt_export", "sparse_mlp_seq4096.npz")
TOL = dict(rtol=2e-4, atol=2e-4)
BATCH, PROMPT, STEPS, MAX_LEN = 2, 300, 24, 1024


@pytest.mark.parametrize("route", ["mega", "fused"])
def test_committed_weights_prefill_and_decode_match_jax(route):
    t_params, meta = load_params_npz(WEIGHTS, device="cpu", dtype=torch.float32)
    t_cfg = model_config_from_meta(meta).replace(dtype="float32")
    j_cfg = dataclasses.replace(
        model_config_from_json(json.dumps(meta["model_config"])),
        dtype="float32", attn_impl="xla")
    template = jax.eval_shape(lambda: jt.init_transformer(jax.random.PRNGKey(0), j_cfg))
    j_params, _ = import_params_npz(WEIGHTS, template)
    j_params = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float32), j_params)
    ids = np.random.RandomState(0).randint(0, 256, (BATCH, PROMPT)).astype(np.int32)

    j_logits, j_cache = jax.jit(functools.partial(jt.transformer_prefill, cfg=j_cfg,
                                                  max_len=MAX_LEN))(j_params, ids=jnp.asarray(ids))
    with torch.no_grad():
        t_logits, t_cache = tt.transformer_prefill(t_params, t_cfg, torch.from_numpy(ids),
                                                   MAX_LEN)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), **TOL)

    j_step = jax.jit(lambda p, tok, c: jt.transformer_decode_step(p, j_cfg, tok, c))
    packed = tt.fuse_decode_params(t_params, t_cfg)
    assert tt.use_mega_decode(t_cfg, BATCH)       # the default route at bs 2 is "mega"
    token = np.asarray(j_logits[:, -1]).argmax(-1)
    assert (t_logits[:, -1].argmax(-1).numpy() == token).all()
    for step in range(STEPS):
        j_logits, j_cache = j_step(j_params, jnp.asarray(token), j_cache)
        with torch.no_grad():
            t_logits, t_cache = tt.transformer_decode_step(packed, t_cfg,
                                                           torch.from_numpy(token), t_cache,
                                                           route=route)
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                                   err_msg=f"step {step}", **TOL)
        token = np.asarray(j_logits).argmax(-1)
        assert (t_logits.argmax(-1).numpy() == token).all(), f"step {step}"
    assert t_cache.seq_len == int(j_cache.seq_len) == PROMPT + STEPS
