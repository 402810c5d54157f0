"""The NSA configurations that nsa_tpu runs on its XLA path, in the port
against nsa_tpu (``attn_impl="xla"``) on the same weights and inputs:

* per-head selection (``query_heads_share_selected_kv=False``),
* ``selection_block_size == stride`` (``num_compress_per_fine == 1``;
  compress 4, stride 4, selection block 4 on the tiny configuration),
* non-causal attention (``causal=False``).

For each: the layer forward with and without its decode cache (one chunk
and several), decode steps across emissions at one position and ragged
(rows at their own positions), the loss and every gradient against
``jax.value_and_grad(transformer_loss)``, with the query chunks recomputed
in the backward and bit for bit the same as kept; for the two causal ones
incremental decode against the full forward and the greedy loop against
the steps, and the serving engine against JAX's ``xla`` engine token for
token; checkpoints and ``.npz`` exports in both packages; the oracles
``fine_attention_reference``, ``blockify_kv``, ``fine_attend_core`` and
``sliding_window_attention`` in these regimes; and the routes these
configurations do not take raising.

float32 on the CPU, the tiny test configuration.  Tolerance atol/rtol 2e-4,
the repo's prefill/decode tolerance (tests/test_decode_equivalence.py):
float32 sums in another order; tokens exact.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsa_tpu import config as jcfg
from nsa_tpu.models import transformer as jt
from nsa_tpu.ops import attention as j_attn
from nsa_tpu.ops import nsa as j_nsa
from nsa_tpu.serve import ContinuousBatchingEngine as JaxEngine
from nsa_tpu.utils.checkpoint import import_params_npz
from nsa_tpu_torch import config as tcfg
from nsa_tpu_torch.models import transformer as tt
from nsa_tpu_torch.ops import attention as t_attn
from nsa_tpu_torch.ops import nsa as t_nsa
from nsa_tpu_torch.serve import ContinuousBatchingEngine
from nsa_tpu_torch.train.pretrain import trainable
from nsa_tpu_torch.utils.checkpoint import (
    export_params_npz,
    load_params_npz,
    model_config_from_meta,
    params_from_numpy,
    restore_checkpoint,
    save_checkpoint,
    tree_items,
    tree_leaves,
)

TOL = dict(rtol=2e-4, atol=2e-4)
# the three configurations, as overrides of the tiny test configuration
CONFIGS = {
    "per_head": dict(nsa=dict(query_heads_share_selected_kv=False)),
    "stride_eq_block": dict(nsa=dict(compress_block_sliding_stride=4)),
    "non_causal": dict(causal=False),
}
NAMES = tuple(CONFIGS)
CAUSAL = ("per_head", "stride_eq_block")


def configs(name, **kw):
    """(JAX config, port config) of one configuration; ``kw`` overrides
    both."""
    spec = dict(CONFIGS[name])
    nsa = spec.pop("nsa", None)

    def build(tiny):
        base = tiny(**kw)
        return base.replace(**spec, **({"nsa": dataclasses.replace(base.nsa, **nsa)}
                                       if nsa else {}))

    return build(jcfg.tiny_test_config), build(tcfg.tiny_test_config)


@functools.lru_cache(maxsize=None)
def model_params(seed=0):
    """A JAX tiny model's params and the same in the port: the three
    configurations share the default's parameter shapes."""
    params = jax.jit(jt.init_transformer, static_argnums=1)(jax.random.PRNGKey(seed),
                                                            jcfg.tiny_test_config())
    return params, params_from_numpy(jax.tree_util.tree_map(np.asarray, params), device="cpu")


def T(x):
    return torch.from_numpy(np.array(x))


def inputs(n, seed, b=2, dim=64):
    return (np.random.RandomState(seed).standard_normal((b, n, dim)) * 0.5).astype(np.float32)


def ids(shape, seed):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(np.int32)


def assert_cache_equal(t_cache, j_cache, trash=True):
    """Every leaf within TOL; ``trash=False`` leaves out ckv's trash row,
    which only the XLA and split routes write."""
    for name, t_leaf, j_leaf in zip(t_cache._fields, t_cache, j_cache):
        t_leaf, j_leaf = t_leaf.numpy(), np.asarray(j_leaf)
        if name == "ckv" and not trash:
            t_leaf, j_leaf = t_leaf[:, :, :-1], j_leaf[:, :, :-1]
        np.testing.assert_allclose(t_leaf, j_leaf, err_msg=name, **TOL)


def no_prefill_kernel(monkeypatch):
    """Make the forward kernel's wrapper raise: these configurations run the
    XLA path, as JAX's use_fused_kernel is false for them."""
    def refuse(*a, **kw):
        raise AssertionError("the forward kernel ran")
    monkeypatch.setattr(t_nsa, "nsa_fine_sliding_attention", refuse)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("n,chunk", [(24, 128), (37, 16)])
def test_layer_forward_with_cache_matches_jax(name, n, chunk, monkeypatch):
    params, port = model_params()
    j_cfg, t_cfg = configs(name, attn_chunk_size=chunk)
    x = inputs(n, seed=n + 1)
    j_out, j_cache = jax.jit(functools.partial(
        j_nsa.sparse_attention_forward, cfg=j_cfg, impl="xla", return_cache_max_len=48))(
        params["layers"][0]["attn"], x=jnp.asarray(x))
    no_prefill_kernel(monkeypatch)
    t_out, t_cache = t_nsa.sparse_attention_forward(port["layers"][0]["attn"], t_cfg, T(x),
                                                    return_cache_max_len=48)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), **TOL)
    assert_cache_equal(t_cache, j_cache)
    assert torch.equal(t_nsa.sparse_attention_forward(port["layers"][0]["attn"], t_cfg, T(x)),
                       t_out)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("ragged", [False, True], ids=["scalar", "ragged"])
def test_decode_steps_match_jax(name, ragged):
    """8 steps from a 6-token prompt (ragged: rows at 6 and 3) cross
    emissions (every 2 steps at stride 2, every 4 at stride 4) and
    selection-block boundaries.  The non-causal configuration decodes as
    the default does (decode is causal by nature; JAX's decode ignores the
    flag): the fused route, which leaves ckv's trash row alone."""
    params, port = model_params()
    j_cfg, t_cfg = configs(name)
    layer, t_layer = params["layers"][0], port["layers"][0]
    prompt, steps, max_len = 6, 8, 32
    x = inputs(prompt + steps, seed=8)
    rows = np.arange(2)
    start = np.array([prompt, prompt - 3], np.int32)
    true_len = dict(j=dict(true_len=jnp.asarray(start)), t=dict(true_len=T(start))) if ragged \
        else dict(j={}, t={})
    _, j_cache = jax.jit(functools.partial(
        j_nsa.sparse_attention_forward, cfg=j_cfg, impl="xla", return_cache_max_len=max_len))(
        layer["attn"], x=jnp.asarray(x[:, :prompt]), **true_len["j"])
    _, t_cache = t_nsa.sparse_attention_forward(
        t_layer["attn"], t_cfg, T(x[:, :prompt]), return_cache_max_len=max_len, **true_len["t"])
    j_step = jax.jit(lambda p, x_, c, t_, ff: j_nsa.sparse_attention_decode(
        p, j_cfg, x_, c, t_, ff_params=ff))
    for i in range(steps):
        pos = start + i if ragged else prompt + i
        xs = x[rows, pos][:, None] if ragged else x[:, pos:pos + 1]
        j_out, j_cache = j_step(layer["attn"], jnp.asarray(xs), j_cache,
                                jnp.asarray(pos, jnp.int32), layer["ff"])
        t_out, t_cache = t_nsa.sparse_attention_decode(
            t_layer["attn"], t_cfg, T(xs), t_cache, T(pos) if ragged else pos,
            ff_params=t_layer["ff"])
        np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), err_msg=f"step {i}", **TOL)
        assert_cache_equal(t_cache, j_cache, trash=name != "non_causal")


@pytest.mark.parametrize("name", CAUSAL)
def test_incremental_decode_equals_full_forward(name):
    """JAX's test_decode_no_overlap_config in the port: prefill 3 tokens,
    decode the other 18 one at a time, against the port's full forward (and
    that against JAX's); then ``greedy_decode``'s loop, whose steps read
    their position on the device, against the argmax of the same steps."""
    params, port = model_params()
    j_cfg, t_cfg = configs(name)
    seq = ids((2, 21), 5)
    full = tt.transformer_forward(port, t_cfg, T(seq).long())
    np.testing.assert_allclose(full.numpy(), np.asarray(jt.transformer_forward(
        params, j_cfg, jnp.asarray(seq), impl="xla")), **TOL)
    prompt = 3
    logits, cache = tt.transformer_prefill(port, t_cfg, T(seq[:, :prompt]).long(), 32)
    outs = [logits[:, -1]]
    for t in range(prompt, seq.shape[1]):
        step, cache = tt.transformer_decode_step(port, t_cfg, T(seq[:, t]).long(), cache)
        outs.append(step)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full[:, prompt - 1:].numpy(), **TOL)

    logits, cache = tt.transformer_prefill(port, t_cfg, T(seq[:, :prompt]).long(), 32)
    first = logits[:, -1].argmax(-1)
    tokens = tt.greedy_decode(port, t_cfg, first, cache, 8)
    _, cache = tt.transformer_prefill(port, t_cfg, T(seq[:, :prompt]).long(), 32)
    tok, want = first, []
    for _ in range(8):
        want.append(tok)
        step, cache = tt.transformer_decode_step(port, t_cfg, tok, cache)
        tok = step.argmax(-1)
    assert torch.equal(tokens, torch.stack(want, 1))


def port_loss_and_grads(port, t_cfg, batch):
    tparams = trainable(port)
    loss = tt.transformer_loss(tparams, t_cfg, T(batch).long())
    return loss, torch.autograd.grad(loss, tree_leaves(tparams))


@pytest.mark.parametrize("name", NAMES)
def test_loss_and_grads_match_jax(name, monkeypatch):
    """n 48 over chunks of 16: the port recomputes each chunk in the
    backward (``torch.utils.checkpoint``, JAX's ``jax.checkpoint``), and
    gives the same bits with the chunks kept."""
    params, port = model_params()
    j_cfg, t_cfg = configs(name, attn_chunk_size=16)
    batch = ids((1, 49), 1)
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p, b: jt.transformer_loss(p, j_cfg, b, impl="xla")))(params, jnp.asarray(batch))
    no_prefill_kernel(monkeypatch)
    recomputed = []
    real = t_nsa.checkpoint
    monkeypatch.setattr(t_nsa, "checkpoint",
                        lambda fn, *a, **kw: recomputed.append(1) or real(fn, *a, **kw))
    loss_t, grads_t = port_loss_and_grads(port, t_cfg, batch)
    assert len(recomputed) == t_cfg.depth * 3
    assert loss_t.item() == pytest.approx(float(loss_j), rel=2e-4)
    flat = jax.tree_util.tree_flatten_with_path(grads_j)[0]
    assert len(flat) == len(grads_t)
    keys = [k for k, _ in tree_items(port)]
    for (path, g), key, got in zip(flat, keys, grads_t):
        assert jax.tree_util.keystr(path) == key
        np.testing.assert_allclose(got.numpy(), np.asarray(g), err_msg=key, **TOL)

    monkeypatch.setattr(t_nsa, "checkpoint", lambda fn, *a, **kw: fn(*a))   # chunks kept
    loss_k, grads_k = port_loss_and_grads(port, t_cfg, batch)
    assert torch.equal(loss_k, loss_t)
    assert all(torch.equal(a, b) for a, b in zip(grads_k, grads_t))


@pytest.mark.parametrize("per_head", [False, True], ids=["shared", "per-head"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "non-causal"])
def test_fine_and_sliding_oracles_match_jax(per_head, causal):
    """``fine_attention_reference`` (so ``blockify_kv`` at Hs = heads and
    ``fine_attend_core``) and ``sliding_window_attention`` against JAX's,
    with the straight-through gates, causal or not."""
    rs = np.random.RandomState(3)
    b, h, kvh, n, d, Bs, S = 2, 4, 2, 21, 8, 4, 2
    Hs = h if per_head else kvh
    q, k, v = (rs.standard_normal(s).astype(np.float32)
               for s in ((b, h, n, d), (b, kvh, n, d), (b, kvh, n, d)))
    idx = rs.randint(0, -(-n // Bs), (b, Hs, n, S)).astype(np.int32)
    mask = rs.rand(b, Hs, n, S) > 0.3
    gates = (1.0 + rs.standard_normal((b, Hs, n, S)) * 0.1).astype(np.float32)
    want = jax.jit(j_attn.fine_attention_reference, static_argnums=(6, 7))(
        *map(jnp.asarray, (q, k, v, idx, mask, gates)), Bs, causal)
    got = t_attn.fine_attention_reference(*map(T, (q, k, v, idx, mask, gates)), Bs, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    jb, tb = j_attn.blockify_kv(jnp.asarray(k), jnp.asarray(v), Bs, Hs), \
        t_attn.blockify_kv(T(k), T(v), Bs, Hs)
    for a, w in zip(tb, jb):
        np.testing.assert_array_equal(a.numpy(), np.asarray(w))
    want = jax.jit(j_attn.sliding_window_attention, static_argnums=(3, 4))(
        *map(jnp.asarray, (q, k, v)), 5, causal)
    got = t_attn.sliding_window_attention(*map(T, (q, k, v)), 5, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


PROMPTS = (tuple(range(1, 10)), tuple(range(40, 52)), tuple(range(90, 98)))


def engine_tokens(engine_cls, params, cfg, **kw):
    eng = engine_cls(params, cfg, max_batch=2, max_len=64, prefill_buckets=(16, 32), **kw)
    rids = [eng.add_request(np.asarray(p, np.int32), max_new_tokens=n)
            for p, n in zip(PROMPTS, (9, 6, 7))]
    out = eng.run()
    return [out[r] for r in rids]


@pytest.mark.parametrize("name", CAUSAL)
def test_engine_matches_jax(name):
    """The dense pool on the XLA branches (the block gather's plain version
    at stride == block), 2 slots for 3 requests, 1 and 3 tokens a sync."""
    params, port = model_params()
    j_cfg, t_cfg = configs(name, attn_impl="xla")
    want = engine_tokens(JaxEngine, params, j_cfg)
    for sps in (1, 3):
        got = engine_tokens(ContinuousBatchingEngine, port, t_cfg, steps_per_sync=sps)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", CAUSAL)
def test_routes_they_do_not_take_raise(name):
    """The fused, split and hybrid routes and the paged pool raise for them,
    as JAX's paged pool does; non-causal decodes like the default."""
    _, port = model_params()
    _, t_cfg = configs(name)
    _, cache = tt.transformer_prefill(port, t_cfg, T(ids((2, 5), 2)).long(), 32)
    token = torch.zeros(2, dtype=torch.long)
    for route in ("fused", "split", "hybrid", "mega"):
        with pytest.raises(ValueError, match="route"):
            tt.transformer_decode_step(port, t_cfg, token, cache, route=route)
    with pytest.raises(NotImplementedError, match="dense pool"):
        ContinuousBatchingEngine(port, t_cfg, max_len=64, paged_pool_pages=8, page_tokens=8)
    assert t_nsa.decode_route(t_cfg, 16, False) == "xla"
    assert t_nsa.decode_route(t_cfg, 2, True) == "xla"
    _, non_causal = configs("non_causal")
    assert t_nsa.decode_route(non_causal, 2, False) == "fused"
    assert tt.use_mega_decode(non_causal, 2) and not tt.use_mega_decode(t_cfg, 2)


@pytest.mark.parametrize("name", NAMES)
def test_checkpoints_and_exports_round_trip(name, tmp_path):
    """``params_from_numpy`` carries JAX's parameters across unchanged; the
    port's checkpoint and ``.npz`` export restore them exactly; the
    exported ``model_config`` builds the same configuration in both
    packages."""
    params, port = model_params()
    j_cfg, t_cfg = configs(name)
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    items = list(tree_items(port))
    assert [jax.tree_util.keystr(p) for p, _ in flat] == [k for k, _ in items]
    for (_, want), (_, got) in zip(flat, items):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    path = export_params_npz(str(tmp_path / "run.npz"), port, t_cfg, extra={"step": 4})
    jtree, jmeta = import_params_npz(path, params)
    assert jcfg.model_config_from_json(json.dumps(jmeta["model_config"])) == j_cfg
    for (_, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(jtree)[0], flat):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    back, meta = load_params_npz(path, device="cpu")
    assert model_config_from_meta(meta) == t_cfg
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(back), tree_leaves(port)))
    ckpt = save_checkpoint(str(tmp_path / "ckpt"), 4, port, model_cfg=t_cfg)
    state, meta = restore_checkpoint(ckpt, names=("params",), device="cpu")
    assert model_config_from_meta(meta) == t_cfg
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(state["params"]),
                                                 tree_leaves(port)))
