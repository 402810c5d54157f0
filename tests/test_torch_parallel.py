"""The (data, heads) mesh (``nsa_tpu_torch/parallel/``) on the CPU: gloo
ranks spawned through a ``FileStore`` (no TCP port), ``tiny_test_config``
(4 heads over 2 KV heads), float32, one thread a rank.

One spawn of 4 ranks (the ``world`` fixture, joined within 60 s, failing
on a timeout) runs every check that needs a group and returns its figures;
the parent holds them against the port's single-process path and
``nsa_tpu``'s:

* one ``sharded_train_step`` on a 2 x 2 mesh at accum 2, sparse and full
  model: the loss rel 1e-5, the params after the step rtol 2e-4 / atol
  2e-5 (``tests/test_sharding.py``'s tolerances), the clipped gradients
  rtol 5e-4 / atol 5e-5 (float32 sums over heads and data slices in
  another order, through the clip by the global norm);
* the hierarchical (2, 1, 2) mesh against the flat (2, 2): loss and params
  within 1e-5;
* prefill and one decode step on the 2 x 2 mesh: logits and each rank's
  caches against the single process's (its caches' slices) within rtol /
  atol 2e-4 / 2e-5; the logits against ``nsa_tpu``'s
  ``transformer_decode_step`` within 2e-4 (``tests/test_torch_model.py``'s
  tolerance), the loss against ``nsa_tpu``'s ``transformer_loss`` rel 1e-5;
* the serving engine at 1 and 3 tokens a sync, token for token
  (``tests/test_serve.py``'s mesh cases);
* ``continuous_pretrain`` over ``auto_mesh`` for two steps: rank 0's
  checkpoint loads in one process (params and optimizer state), equals the
  gathered params bit for bit and the single process's run within the
  train step's tolerances;
* the dry run's rank body (``train_step._dryrun_rank``) in the same world.

The rest runs in-process with no spawn: the partition table against
``nsa_tpu``'s ``param_spec``, sharding and joining, the mesh shapes, the
helpers' identity without a mesh, and the refusals.
"""

import contextlib

import numpy as np
import pytest
import torch

from nsa_tpu_torch import tiny_test_config as t_tiny
from nsa_tpu_torch.config import MeshConfig, TrainConfig
from nsa_tpu_torch.models import transformer as tt
from nsa_tpu_torch.ops import nsa as t_nsa
from nsa_tpu_torch.parallel import comm, sharding
from nsa_tpu_torch.parallel import train_step as pstep
from nsa_tpu_torch.parallel.mesh import (
    Mesh,
    auto_mesh,
    auto_mesh_config,
    make_hierarchical_mesh,
    make_mesh,
    run_ranks,
)
from nsa_tpu_torch.serve import ContinuousBatchingEngine
from nsa_tpu_torch.train import continuous_pretrain as tcpt
from nsa_tpu_torch.train.pretrain import make_optimizer, train_step, trainable
from nsa_tpu_torch.utils.checkpoint import (
    params_from_numpy,
    restore_checkpoint,
    save_checkpoint,
    tree_items,
    tree_leaves,
)

SPAWN_TIMEOUT_S = 60
TRAIN = TrainConfig(batch_size=4, seq_len=16, grad_accum_every=2, learning_rate=1e-3)
LOSS_REL = 1e-5
PARAM_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)
CACHE_TOL = dict(rtol=2e-4, atol=2e-5)
JAX_LOGITS_TOL = dict(rtol=2e-4, atol=2e-4)
PROMPTS = [np.arange(1, 10), np.arange(40, 52), np.arange(90, 98), np.arange(7, 14)]
PREFILL_IDS, MAX_LEN = (4, 12), 64
CPT_KW = dict(num_batches=2, batch_size=4, seq_len=64, eval_every=2, eval_max_tokens=300)


def cfgs():
    return {"sparse": t_tiny(), "full": t_tiny(use_sparse_attn=False)}


# the compressors other than mlp: per-head (conv), a weight shared by the
# heads (attn, shared_mlp, single), none (mean), mixing the heads (transformer)
OTHER_COMPRESSORS = ["conv", "attn", "mean", "shared_mlp", "single", "transformer"]


def compressor_cfg(kind):
    nsa = t_tiny().nsa
    return t_tiny(nsa=nsa.__class__(**{**nsa.__dict__, "compressor": kind}))


def compressor_params(kind):
    return tt.init_transformer(compressor_cfg(kind), torch.Generator().manual_seed(5), "cpu")


def corpus(_cfg=None):
    data = np.random.RandomState(11).randint(32, 127, 24_000).astype(np.uint8)
    return data[:20_000], data[20_000:]


def to_numpy(tree):
    return {k: v.detach().numpy().copy() for k, v in tree_items(tree)}


def grads_of(params):
    """The params' gradients in the params' tree layout."""
    if isinstance(params, dict):
        return {k: grads_of(v) for k, v in params.items()}
    if isinstance(params, list):
        return [grads_of(v) for v in params]
    return params.grad


def batch_of(payload):
    return torch.from_numpy(payload["batch"]).long()


def one_process_step(params, cfg, batch):
    params = trainable(params)
    opt = make_optimizer(TRAIN, params)
    loss = train_step(params, opt, batch, cfg, TRAIN.grad_accum_every)
    return float(loss), to_numpy(params), to_numpy(grads_of(params))


def run_engine(params, cfg, prompts, new, mesh, **kw):
    eng = ContinuousBatchingEngine(params, cfg, max_len=MAX_LEN, prefill_buckets=(8, 16),
                                   mesh=mesh, capture=False, **kw)
    rids = [eng.add_request(p.astype(np.int32), max_new_tokens=new) for p in prompts]
    done = eng.run()
    return [done[r].tolist() for r in rids]


def engine_cases(params, cfg, mesh=None):
    """tests/test_serve.py's two mesh cases: 4 requests through 4 slots at
    1 token a sync, and one through 2 slots at 3 tokens a sync."""
    return [run_engine(params, cfg, PROMPTS, 5, mesh, max_batch=4),
            run_engine(params, cfg, PROMPTS[:1], 6, mesh, max_batch=2, steps_per_sync=3)]


@contextlib.contextmanager
def copy_to_heads_backward_is_identity():
    """``comm.copy_to_heads`` with the plain identity as its backward."""
    real = comm._CopyToHeads.__dict__["backward"]
    comm._CopyToHeads.backward = staticmethod(lambda ctx, g: (g, None))
    try:
        yield
    finally:
        comm._CopyToHeads.backward = real


def _rank(payload):
    """One rank of the 4-rank world: every check that needs a group."""
    tcpt.load_byte_corpus = corpus          # the tests' small seeded corpus
    out = {}
    mesh = make_mesh(2, 2)
    hmesh = make_hierarchical_mesh(2, 1, 2)
    out["shapes"] = [mesh.describe(), hmesh.describe(), auto_mesh(4, kv_heads=2).describe()]
    out["coords"] = mesh.coords
    batch = batch_of(payload)
    for name, cfg in cfgs().items():
        full = params_from_numpy(payload[name], device="cpu")
        params = pstep.shard_trainable(full, mesh, cfg)
        opt = make_optimizer(TRAIN, params)
        loss = pstep.sharded_train_step(params, opt, batch, cfg, TRAIN.grad_accum_every, mesh)
        out[name] = {"loss": float(loss),
                     "params": to_numpy(sharding.gather_params(params, mesh, cfg)),
                     "grads": to_numpy(sharding.gather_params(grads_of(params), mesh, cfg))}
        if name == "sparse":
            # the shards gathered back are the params (before any step)
            back = sharding.gather_params(pstep.shard_trainable(full, mesh, cfg), mesh, cfg)
            out["gathered_init_equal"] = all(torch.equal(a, b) for a, b in
                                             zip(tree_leaves(back), tree_leaves(full)))
            hparams = pstep.shard_trainable(full, hmesh, cfg)
            hopt = make_optimizer(TRAIN, hparams)
            hloss = pstep.sharded_train_step(hparams, hopt, batch, cfg,
                                             TRAIN.grad_accum_every, hmesh)
            out["hier"] = {"loss": float(hloss),
                           "params": to_numpy(sharding.gather_params(hparams, hmesh, cfg))}
            # the control: copy_to_heads's backward all-reduce left out
            cparams = pstep.shard_trainable(full, mesh, cfg)
            with copy_to_heads_backward_is_identity():
                closs = pstep.sharded_train_step(cparams, make_optimizer(TRAIN, cparams), batch,
                                                 cfg, TRAIN.grad_accum_every, mesh)
            out["no_copy_reduce"] = {
                "loss": float(closs),
                "grads": to_numpy(sharding.gather_params(grads_of(cparams), mesh, cfg))}

    for kind in OTHER_COMPRESSORS:
        cfg = compressor_cfg(kind)
        params = pstep.shard_trainable(compressor_params(kind), mesh, cfg)
        loss = pstep.sharded_train_step(params, make_optimizer(TRAIN, params), batch, cfg,
                                        TRAIN.grad_accum_every, mesh)
        out[kind] = {"loss": float(loss),
                     "params": to_numpy(sharding.gather_params(params, mesh, cfg)),
                     "grads": to_numpy(sharding.gather_params(grads_of(params), mesh, cfg))}

    # prefill and one decode step on the split route
    cfg = cfgs()["sparse"]
    full = params_from_numpy(payload["sparse"], device="cpu")
    local = tt.fuse_decode_params(sharding.shard_params(full, mesh, cfg),
                                  sharding.local_config(cfg, mesh))
    ids = sharding.shard_batch(torch.from_numpy(payload["ids"]).long(), mesh)
    lcfg = sharding.local_config(cfg, mesh)
    with torch.no_grad(), mesh:
        logits, cache = tt.transformer_prefill(local, lcfg, ids, MAX_LEN)
        prefill_cache = [[leaf.clone() for leaf in lc] for lc in cache.layers]
        step, cache = tt.transformer_decode_step(local, lcfg, logits[:, -1].argmax(-1), cache)
    out["decode"] = {"prefill_logits": logits.numpy(), "step_logits": step.numpy(),
                     "prefill_cache": [[x.numpy() for x in lc] for lc in prefill_cache],
                     "step_cache": [[x.numpy() for x in lc] for lc in cache.layers]}

    out["engine"] = engine_cases(full, cfg, mesh)

    cpt_mesh = auto_mesh(4, kv_heads=cfg.kv_heads)
    params, loss, path = tcpt.run_continuous_pretrain(
        payload["cpt_dir"], out_dir=payload["cpt_out"], device="cpu", mesh=cpt_mesh, **CPT_KW)
    out["cpt"] = {"loss": loss, "path": path,
                  "params": to_numpy(sharding.gather_params(params, cpt_mesh, cfg))}
    out["dryrun"] = pstep._dryrun_rank(4, "cpu")
    return out


def numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [numpy_tree(v) for v in tree]
    return tree.numpy()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    payload = {name: numpy_tree(tt.init_transformer(cfg, torch.Generator().manual_seed(3), "cpu"))
               for name, cfg in cfgs().items()}
    rng = np.random.RandomState(0)
    payload["batch"] = rng.randint(0, 256, (TRAIN.grad_accum_every, TRAIN.batch_size,
                                            TRAIN.seq_len + 1)).astype(np.int32)
    payload["ids"] = rng.randint(0, 256, PREFILL_IDS).astype(np.int32)
    save_checkpoint(str(tmp / "ckpt"), 5, params_from_numpy(payload["sparse"], device="cpu"),
                    model_cfg=t_tiny())
    payload.update(cpt_dir=str(tmp / "ckpt"), cpt_out=str(tmp / "cpt_mesh"))
    results = run_ranks(_rank, 4, "gloo", (payload,), timeout_s=SPAWN_TIMEOUT_S,
                        workdir=str(tmp))
    return payload, results


def assert_trees_close(got, want, **tol):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def test_world_layout(world):
    _, results = world
    assert results[0]["shapes"] == [{"data": 2, "heads": 2}, {"dcn": 2, "data": 1, "heads": 2},
                                    {"data": 2, "heads": 2}]
    assert [r["coords"] for r in results] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert all(r["gathered_init_equal"] for r in results)


@pytest.mark.parametrize("name", ["sparse", "full"])
def test_sharded_train_step_matches_one_process(world, name):
    payload, results = world
    loss, params, grads = one_process_step(params_from_numpy(payload[name], device="cpu"),
                                           cfgs()[name], batch_of(payload))
    for r in results:                       # every rank holds the same result
        assert r[name]["loss"] == pytest.approx(loss, rel=LOSS_REL)
        assert_trees_close(r[name]["params"], params, **PARAM_TOL)
        assert_trees_close(r[name]["grads"], grads, **GRAD_TOL)


def test_gradient_tolerance_fails_without_copy_to_heads_backward(world):
    """A step whose replicated inputs' gradients miss the other heads rank's
    part (``copy_to_heads``'s backward all-reduce left out) keeps the loss
    (the forward is the same) and breaks the gradient tolerance above (rtol
    5e-4, atol 5e-5) on every layer's norm scales (the attention's and the
    FF's, which scale those inputs)."""
    payload, results = world
    loss, _, grads = one_process_step(params_from_numpy(payload["sparse"], device="cpu"),
                                      cfgs()["sparse"], batch_of(payload))
    for r in results:
        got = r["no_copy_reduce"]
        assert got["loss"] == pytest.approx(loss, rel=LOSS_REL)
        scales = [k for k in grads if k.startswith("['layers']") and k.endswith("['norm_scale']")]
        assert scales
        for k in scales:
            assert not np.allclose(got["grads"][k], grads[k], **GRAD_TOL), k


@pytest.mark.parametrize("kind", OTHER_COMPRESSORS)
def test_sharded_train_step_other_compressors(world, kind):
    """The compressors whose leaves the port replicates (their gradient
    summed over heads, or the heads gathered for the transformer kind) and
    conv / mean, against one process, with the train step's tolerances."""
    payload, results = world
    loss, params, grads = one_process_step(compressor_params(kind), compressor_cfg(kind),
                                           batch_of(payload))
    for r in results:
        assert r[kind]["loss"] == pytest.approx(loss, rel=LOSS_REL)
        assert_trees_close(r[kind]["params"], params, **PARAM_TOL)
        assert_trees_close(r[kind]["grads"], grads, **GRAD_TOL)


def test_hierarchical_mesh_matches_flat(world):
    _, results = world
    for r in results:
        assert r["hier"]["loss"] == pytest.approx(r["sparse"]["loss"], rel=1e-5)
        assert_trees_close(r["hier"]["params"], r["sparse"]["params"], rtol=1e-5, atol=1e-5)


def one_process_decode(payload):
    cfg = cfgs()["sparse"]
    params = tt.fuse_decode_params(params_from_numpy(payload["sparse"], device="cpu"), cfg)
    with torch.no_grad():
        logits, cache = tt.transformer_prefill(params, cfg, torch.from_numpy(payload["ids"]).long(),
                                               MAX_LEN)
        prefill_cache = [[leaf.clone() for leaf in lc] for lc in cache.layers]
        step, cache = tt.transformer_decode_step(params, cfg, logits[:, -1].argmax(-1), cache,
                                                 route="split")
    return logits, prefill_cache, step, [list(lc) for lc in cache.layers]


def test_prefill_and_decode_step_match_one_process(world):
    payload, results = world
    logits, prefill_cache, step, step_cache = one_process_decode(payload)
    half = PREFILL_IDS[0] // 2
    for r in results:
        data, heads = r["coords"]
        rows = slice(data * half, (data + 1) * half)
        dec = r["decode"]
        np.testing.assert_allclose(dec["prefill_logits"], logits[rows].numpy(), **CACHE_TOL)
        np.testing.assert_allclose(dec["step_logits"], step[rows].numpy(), **CACHE_TOL)
        mesh = fake_mesh(2, 2, (data, heads))
        for got_c, want_c in ((dec["prefill_cache"], prefill_cache),
                              (dec["step_cache"], step_cache)):
            for got_l, want_l in zip(got_c, sharding.shard_cache(want_c, mesh)):
                for got, want in zip(got_l, want_l):
                    np.testing.assert_allclose(got, want.numpy(), **CACHE_TOL)


def test_loss_and_decode_step_match_jax(world):
    import jax
    import jax.numpy as jnp

    from nsa_tpu.config import tiny_test_config as j_tiny
    from nsa_tpu.models import transformer as jt

    payload, results = world
    cfg = j_tiny()
    params = jax_tree(payload["sparse"])
    loss = jax.jit(jt.transformer_loss, static_argnums=1)
    want_loss = np.mean([float(loss(params, cfg, jnp.asarray(m))) for m in payload["batch"]])
    # the loss the step returns is the mean over its micro-batches before the update
    for r in results:
        assert r["sparse"]["loss"] == pytest.approx(want_loss, rel=LOSS_REL)
    logits, cache = jax.jit(jt.transformer_prefill, static_argnums=(1, 3))(
        params, cfg, jnp.asarray(payload["ids"]), MAX_LEN)
    step, _ = jax.jit(jt.transformer_decode_step, static_argnums=1)(
        params, cfg, jnp.argmax(logits[:, -1], -1), cache)
    half = PREFILL_IDS[0] // 2
    got = np.concatenate([r["decode"]["step_logits"] for r in results if r["coords"][1] == 0])
    assert got.shape[0] == 2 * half
    np.testing.assert_allclose(got, np.asarray(step), **JAX_LOGITS_TOL)


def jax_tree(tree):
    import jax.numpy as jnp

    if isinstance(tree, dict):
        return {k: jax_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [jax_tree(v) for v in tree]
    return jnp.asarray(tree)


def test_engine_over_mesh_matches_one_process(world):
    payload, results = world
    cfg = cfgs()["sparse"]
    want = engine_cases(params_from_numpy(payload["sparse"], device="cpu"), cfg)
    assert all(len(toks) == 5 for toks in want[0])
    for r in results:
        assert r["engine"] == want


def test_continuous_pretrain_over_mesh(world, tmp_path, monkeypatch):
    payload, results = world
    monkeypatch.setattr(tcpt, "load_byte_corpus", corpus)
    params, loss, _ = tcpt.run_continuous_pretrain(payload["cpt_dir"], out_dir=str(tmp_path),
                                                   device="cpu", **CPT_KW)
    path = results[0]["cpt"]["path"]
    state, meta = restore_checkpoint(path, device="cpu")   # params and the optimizer state
    assert meta["step"] == 5 + CPT_KW["num_batches"]
    saved = to_numpy(state["params"])
    for r in results:
        assert r["cpt"]["path"] == path
        assert r["cpt"]["loss"] == pytest.approx(loss, rel=LOSS_REL)
        for k, v in r["cpt"]["params"].items():
            np.testing.assert_array_equal(saved[k], v, err_msg=k)
    assert_trees_close(saved, to_numpy(params), **PARAM_TOL)
    opt = make_optimizer(TRAIN, trainable(state["params"]))
    opt.load_state_dict(state["opt_state"])
    moments = [s["exp_avg"].shape for s in opt.state_dict()["state"].values()]
    assert moments == [p.shape for p in tree_leaves(state["params"])]


def test_dryrun_rank_body(world):
    _, results = world
    summaries = [r["dryrun"] for r in results]
    assert all(s == summaries[0] for s in summaries)
    assert summaries[0]["mesh"] == {"data": 1, "heads": 4}
    assert np.isfinite(summaries[0]["loss"])


# ---- in-process, no spawn -------------------------------------------------

def jax_specs(params):
    """nsa_tpu's param_spec of every leaf, by tree path, as a tuple a dim."""
    import jax

    from nsa_tpu.parallel.sharding import param_spec

    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        spec = tuple(param_spec(path, leaf))
        out[jax.tree_util.keystr(path)] = spec + (None,) * (leaf.ndim - len(spec))
    return out


def port_specs(params, compressor):
    """The port's ``params_pspecs`` by tree path (a spec, a tuple, is a leaf)."""
    out = {}

    def walk(tree, key):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{key}[{k!r}]")
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                walk(v, f"{key}[{i}]")
        else:
            out[key] = tree

    walk(sharding.params_pspecs(params, compressor), "")
    return out


def join_shards(shards, cfg):
    """The heads ranks' local params (in heads order) concatenated back on
    each split axis, the replicated leaves taken from the first."""
    def join(path, parts):
        axis = [i for i, a in enumerate(sharding.param_spec(path, parts[0],
                                                              cfg.nsa.compressor)) if a]
        return torch.cat(parts, dim=axis[0]) if axis else parts[0]

    def walk(trees, path):
        if isinstance(trees[0], dict):
            return {k: walk([t[k] for t in trees], path + (k,)) for k in trees[0]}
        if isinstance(trees[0], list):
            return [walk([t[i] for t in trees], path + (i,)) for i in range(len(trees[0]))]
        return join(path, trees)

    return walk(shards, ())


COMPRESSORS = ["mlp", "conv", "attn", "mean", "shared_mlp", "single", "transformer"]
# the compressor leaves whose axis 0 is not the KV heads: JAX's table splits
# them there (GSPMD gathers them back), the port's replicates them
REPLICATED_COMPRESSOR_LEAVES = {"attn": ("w_logits",), "shared_mlp": ("w1", "w2"),
                                "single": ("w",),
                                "transformer": ("w_q", "w_k", "w_v", "w_o", "w_f1", "w_f2")}


@pytest.mark.parametrize("compressor", COMPRESSORS)
def test_partition_table_matches_jax(compressor):
    """Equal on every leaf and every fused decode pack leaf that both
    packages have, but the listed ones: the compressor leaves whose axis 0
    is not the KV heads (replicated here) and ``w_qkvg`` (packed from the
    rank's own columns here, replicated in JAX)."""
    import jax

    from nsa_tpu.config import tiny_test_config as j_tiny
    from nsa_tpu.models.transformer import fuse_decode_params, init_transformer

    nsa = t_tiny().nsa.__class__(**{**t_tiny().nsa.__dict__, "compressor": compressor})
    jcfg = j_tiny(nsa=jax_nsa(compressor))
    packed = compressor == "mlp"        # JAX packs the decode weights of mlp only

    def init(key):
        params = init_transformer(key, jcfg)
        return fuse_decode_params(params, jcfg) if packed else params

    # the specs read paths and shapes only
    jparams = jax.eval_shape(init, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(
        lambda x: np.zeros(x.shape, np.float32), jparams), device="cpu")
    if packed:
        tparams = {**tparams, "layers": [
            {**layer, "attn": {k: v for k, v in layer["attn"].items() if k != "decode_fused"}}
            for layer in tparams["layers"]]}
        tparams = tt.fuse_decode_params(tparams, t_tiny(nsa=nsa))
    want, got = jax_specs(jparams), port_specs(tparams, compressor)
    replicated = REPLICATED_COMPRESSOR_LEAVES.get(compressor, ())
    differ = set()
    for key, spec in want.items():
        leaf = key.rsplit("[", 1)[1].strip("]'")
        if "compress" in key and leaf in replicated or leaf == "w_qkvg":
            assert got[key] != spec and all(a is None for a in spec[1:])
            differ.add(leaf)
        else:
            assert got[key] == spec, key
    assert differ == set(replicated) | ({"w_qkvg"} if packed else set())


def jax_nsa(compressor):
    from nsa_tpu.config import tiny_test_config as j_tiny

    base = j_tiny().nsa
    return base.__class__(**{**base.__dict__, "compressor": compressor})


def fake_mesh(data, heads, coord=(0, 0)):
    """A mesh of shapes and coordinates only (no groups): enough for the
    pure sharding helpers and for the checks that raise before any
    collective."""
    return Mesh(("data", "heads"), (data, heads), coord)


@pytest.mark.parametrize("compressor", ["mlp", "transformer"])
def test_shard_then_join_is_identity(compressor):
    cfg = t_tiny(nsa=t_tiny().nsa.__class__(**{**t_tiny().nsa.__dict__,
                                                "compressor": compressor}))
    params = tt.init_transformer(cfg, torch.Generator().manual_seed(0), device="cpu")
    shards = [sharding.shard_params(params, fake_mesh(1, 2, (0, i)), cfg) for i in range(2)]
    assert shards[0]["layers"][0]["attn"]["w_q"].shape == (cfg.dim, cfg.dim_inner // 2)
    back = join_shards(shards, cfg)
    assert [k for k, _ in tree_items(back)] == [k for k, _ in tree_items(params)]
    for a, b in zip(tree_leaves(back), tree_leaves(params)):
        assert torch.equal(a, b)
    local = sharding.local_config(cfg, fake_mesh(1, 2))
    assert (local.heads, local.kv_heads) == (2, 1)
    with pytest.raises(ValueError):
        sharding.local_config(cfg, fake_mesh(1, 4))


def test_mesh_shapes_match_jax():
    import jax

    from nsa_tpu.parallel.mesh import auto_mesh as j_auto_mesh

    for n, kvh in ((8, 4), (8, 3), (4, 2), (2, 4)):
        got = auto_mesh_config(n, kvh).shape
        if n <= len(jax.devices()):
            assert got == j_auto_mesh(n, kv_heads=kvh).devices.shape
    assert auto_mesh_config(8, 4) == MeshConfig(data=2, heads=4)
    assert auto_mesh_config(8, 3).shape == (8, 1)


def test_helpers_are_identity_without_a_mesh():
    """Without a mesh each helper returns its input itself, and under a mesh
    of one rank on each axis the loss and gradients are bit for bit the
    ones without a mesh; the train step is the one before the mesh (clip,
    then Adam) bit for bit."""
    x = torch.randn(3, 4, requires_grad=True)
    for fn in (comm.copy_to_heads, comm.reduce_from_heads, comm.gather_batch,
               comm.mean_over_batch):
        assert fn(x) is x
    assert comm.gather_from_heads(x, 1) is x and comm.scatter_to_heads(x, 1) is x
    x.grad = torch.randn(3, 4)
    assert torch.equal(comm.grad_norm([x]), torch.nn.utils.get_total_norm([x.grad]))

    cfg = t_tiny()
    ids = torch.from_numpy(np.random.RandomState(1).randint(0, 256, (2, 2, 17))).long()

    def run(ctx, step):
        params = trainable(tt.init_transformer(cfg, torch.Generator().manual_seed(0), "cpu"))
        opt = make_optimizer(TRAIN, params)
        with ctx:
            loss = step(params, opt)
        return loss, [p.detach().clone() for p in tree_leaves(params)], \
            [p.grad.clone() for p in tree_leaves(params)]

    def grads_only(params, opt):
        loss = tt.transformer_loss(params, cfg, ids[0])
        loss.backward()
        return loss

    def before(params, opt):          # train_step as it was without the mesh
        opt.zero_grad(set_to_none=True)
        total = torch.zeros(())
        for micro in ids:
            loss = tt.transformer_loss(params, cfg, micro)
            (loss / 2).backward()
            total += loss.detach()
        torch.nn.utils.clip_grad_norm_(tree_leaves(params), opt.max_norm)
        torch.optim.Adam.step(opt)
        return total / 2

    plain = run(contextlib.nullcontext(), grads_only)
    meshed = run(fake_mesh(1, 1), grads_only)
    assert torch.equal(plain[0], meshed[0])
    assert all(torch.equal(a, b) for a, b in zip(plain[2], meshed[2]))
    old = run(contextlib.nullcontext(), before)
    new = run(contextlib.nullcontext(), lambda p, o: train_step(p, o, ids, cfg, 2))
    assert torch.equal(old[0], new[0])
    assert all(torch.equal(a, b) for a, b in zip(old[1], new[1]))


def test_routes_that_fold_w_out_refuse_a_heads_axis(monkeypatch):
    cfg = t_tiny()
    with fake_mesh(1, 2):
        for route in ("fused", "hybrid"):
            with pytest.raises(ValueError, match="heads axis"):
                t_nsa.decode_route(cfg, 4, False, route)
        assert t_nsa.decode_route(cfg, 4, False) == "split"
        assert t_nsa.decode_route(cfg, 4, True) == "xla"
        assert not tt.use_mega_decode(cfg, 4)
        with pytest.raises(ValueError, match="heads axis"):
            tt._mega_route(cfg, 4, "mega")
        monkeypatch.setenv("NSA_HYBRID_DECODE", "1")
        with pytest.raises(ValueError, match="heads axis"):
            t_nsa.decode_route(cfg, 16, False)
        monkeypatch.delenv("NSA_HYBRID_DECODE")
    with fake_mesh(2, 1):             # a data-only mesh keeps every route
        assert t_nsa.decode_route(cfg, 4, False) == "fused"
        assert t_nsa.decode_route(cfg, 4, False, "hybrid") == "hybrid"
        assert tt.use_mega_decode(cfg, 4)


def test_capture_and_paged_pool_refuse_a_mesh():
    cfg = t_tiny()
    params = tt.init_transformer(cfg, torch.Generator().manual_seed(0), "cpu")
    mesh = fake_mesh(1, 1)
    with torch.no_grad():
        logits, cache = tt.transformer_prefill(params, cfg, torch.zeros((1, 8), dtype=torch.long),
                                               32)
    with mesh, pytest.raises(ValueError, match="capture=False"):
        tt.greedy_decode(params, cfg, logits[:, -1].argmax(-1), cache, 2)
    with pytest.raises(ValueError, match="capture=False"):
        ContinuousBatchingEngine(params, cfg, max_batch=2, max_len=64, mesh=mesh)
    with pytest.raises(NotImplementedError, match="paged"):
        ContinuousBatchingEngine(params, cfg, max_batch=2, max_len=64, mesh=mesh,
                                 capture=False, paged_pool_pages=4)
    with pytest.raises(ValueError, match="split over"):
        ContinuousBatchingEngine(params, cfg, max_batch=3, max_len=64, mesh=fake_mesh(2, 1),
                                 capture=False)


def _raise_or_hang():
    """Rank 1 raises, rank 0 hangs (``test_run_ranks_fails_a_raising_or_hung_rank``)."""
    import time

    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    time.sleep(120)


def test_run_ranks_fails_a_raising_or_hung_rank(tmp_path, monkeypatch):
    """A rank that raises fails the run at once, long before the timeout:
    the hung rank beside it is stopped, the error holds the raising rank's
    traceback and the stopped rank's stacks; ``meanwhile`` runs while the
    ranks do.  A rank that finds no kernel library raises before it loads
    one."""
    import time

    called = []
    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as err:
        run_ranks(_raise_or_hang, 2, "gloo", timeout_s=SPAWN_TIMEOUT_S, workdir=str(tmp_path),
                  meanwhile=lambda: called.append(True))
    assert time.monotonic() - t0 < SPAWN_TIMEOUT_S / 2 and called == [True]
    msg = str(err.value)
    assert "rank 1 raised" in msg and "rank 1 fails on purpose" in msg
    assert "rank 0: stopped" in msg and "_raise_or_hang" in msg      # its dumped stack
    from nsa_tpu_torch.ops.cuda import runtime

    monkeypatch.setattr(runtime, "library_path", lambda: tmp_path / "missing.so")
    with pytest.raises(RuntimeError, match="not built"):
        runtime.require_built()
