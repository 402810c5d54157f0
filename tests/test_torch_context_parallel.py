"""Context parallelism (``nsa_tpu_torch/parallel/context.py``) on the CPU:
4 gloo ranks on a ``seq`` mesh, ``tiny_test_config`` (4 heads over 2 KV
heads, window 8), float32, one thread a rank.

One spawn (the ``world`` fixture) runs every case that needs a group and
returns its figures; the parent holds them against what JAX's
``tests/test_context_parallel.py`` proves equal to JAX's own context
parallelism (which is not called here: its file takes minutes on 8
virtual devices):

* the whole logits against ``nsa_tpu``'s ``transformer_forward(impl="xla")``,
  rtol / atol 2e-4 (JAX's test's tolerance);
* the loss against ``nsa_tpu``'s ``transformer_loss``, rel 2e-5;
* the gradients summed over the ranks against the port's single-process
  backward of ``transformer_loss``, rtol 2e-3 / atol 2e-5;
* the sparse and the full model at b 2 x n 64 (16 rows a rank), and the
  sparse model at n 16 (4 rows a rank, under the window of 8, so a row's
  band reaches back across two ranks);
* a gather whose backward only slices breaks the gradients, and
  ``copy_to_heads`` / ``reduce_from_heads`` stay the identity under the
  seq mesh;
* the scaling benchmark's rank body: meshes of JAX's scaling model over
  the world's first 1, 2 and 4 ranks.
"""

import contextlib

import numpy as np
import pytest
import torch

from nsa_tpu_torch import tiny_test_config as t_tiny
from nsa_tpu_torch.models import transformer as tt
from nsa_tpu_torch.parallel import comm, context, scaling_bench
from nsa_tpu_torch.parallel.mesh import AXIS_SEQ, make_seq_mesh, run_ranks
from nsa_tpu_torch.train.pretrain import trainable
from nsa_tpu_torch.utils.checkpoint import params_from_numpy, tree_items

SPAWN_TIMEOUT_S = 60
RANKS = 4
LOGITS_TOL = dict(rtol=2e-4, atol=2e-4)
LOSS_REL = 2e-5
GRAD_TOL = dict(rtol=2e-3, atol=2e-5)
# (model, b, n): n the loss's input length; n 16 puts 4 rows on a rank
CASES = {"sparse": (True, 2, 64), "full": (False, 2, 64), "short": (True, 2, 16)}


def numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [numpy_tree(v) for v in tree]
    return tree.numpy()


def jax_tree(tree):
    import jax.numpy as jnp

    if isinstance(tree, dict):
        return {k: jax_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [jax_tree(v) for v in tree]
    return jnp.asarray(tree)


def grads_numpy(params):
    return {k: v.grad.numpy().copy() for k, v in tree_items(params)}


@contextlib.contextmanager
def gather_backward_only_slices():
    """``comm.gather_from_seq`` with a backward that keeps this rank's
    slice of the gradient and drops the other ranks' parts."""
    real = comm._GatherFromSeq.__dict__["backward"]
    comm._GatherFromSeq.backward = staticmethod(
        lambda ctx, g: (comm._local_slice(g, ctx.group, ctx.dim), None, None))
    try:
        yield
    finally:
        comm._GatherFromSeq.backward = real


def _rank(payload):
    """One rank of the 4-rank seq world: every case that needs a group."""
    mesh = make_seq_mesh()
    out = {"coord": mesh.coord(AXIS_SEQ), "shape": mesh.describe()}
    x = torch.randn(2, 3, requires_grad=True)
    with mesh:
        y = comm.reduce_from_heads(comm.copy_to_heads(x))
    out["heads_identity"] = y is x
    for name, (sparse, _, _) in CASES.items():
        cfg = t_tiny(use_sparse_attn=sparse)
        ids = torch.from_numpy(payload[name]["ids"]).long()
        params = trainable(params_from_numpy(payload[name]["params"], device="cpu"))
        with torch.no_grad():
            logits = context.context_parallel_forward(params, cfg, ids[:, :-1], mesh)
        loss = context.context_parallel_value_and_grad(params, cfg, ids, mesh)
        res = {"loss": float(loss), "grads": grads_numpy(params)}
        if out["coord"] == 0:
            res["logits"] = logits.numpy()
        if name == "sparse":
            cparams = trainable(params_from_numpy(payload[name]["params"], device="cpu"))
            with gather_backward_only_slices():
                context.context_parallel_value_and_grad(cparams, cfg, ids, mesh)
            res["control_grads"] = grads_numpy(cparams)
        out[name] = res
    # the scaling benchmark's rank body: meshes over the first 1, 2, 4 ranks
    out["scaling"] = scaling_bench._bench_rank((1, 2, RANKS), 16, 1, 1, "cpu")
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("seq")
    payload = {}
    for name, (sparse, b, n) in CASES.items():
        params = tt.init_transformer(t_tiny(use_sparse_attn=sparse),
                                     torch.Generator().manual_seed(3), "cpu")
        ids = np.random.RandomState(len(payload)).randint(0, 256, (b, n + 1)).astype(np.int32)
        payload[name] = {"params": numpy_tree(params), "ids": ids}
    results = run_ranks(_rank, RANKS, "gloo", (payload,), timeout_s=SPAWN_TIMEOUT_S,
                        workdir=str(tmp))
    return payload, results


def one_process_grads(payload, name):
    cfg = t_tiny(use_sparse_attn=CASES[name][0])
    params = trainable(params_from_numpy(payload[name]["params"], device="cpu"))
    loss = tt.transformer_loss(params, cfg, torch.from_numpy(payload[name]["ids"]).long())
    loss.backward()
    return float(loss.detach()), grads_numpy(params)


def test_seq_mesh_layout(world):
    _, results = world
    assert [r["coord"] for r in results] == list(range(RANKS))
    assert all(r["shape"] == {AXIS_SEQ: RANKS} for r in results)
    assert all(r["heads_identity"] for r in results)


def jax_model():
    """nsa_tpu's config and model, imported here: the spawned ranks import
    this module and need no JAX."""
    from nsa_tpu.config import tiny_test_config
    from nsa_tpu.models import transformer

    return tiny_test_config, transformer


@pytest.mark.parametrize("name", list(CASES))
def test_logits_match_jax(world, name):
    import jax.numpy as jnp

    j_tiny, jt = jax_model()
    payload, results = world
    cfg = j_tiny(use_sparse_attn=CASES[name][0])
    want = jt.transformer_forward(jax_tree(payload[name]["params"]), cfg,
                                  jnp.asarray(payload[name]["ids"][:, :-1]), impl="xla")
    np.testing.assert_allclose(results[0][name]["logits"], np.asarray(want), **LOGITS_TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_loss_matches_jax(world, name):
    import jax.numpy as jnp

    j_tiny, jt = jax_model()
    payload, results = world
    cfg = j_tiny(use_sparse_attn=CASES[name][0])
    want = float(jt.transformer_loss(jax_tree(payload[name]["params"]), cfg,
                                     jnp.asarray(payload[name]["ids"]), impl="xla"))
    for r in results:                       # every rank holds the global loss
        assert r[name]["loss"] == pytest.approx(want, rel=LOSS_REL)


@pytest.mark.parametrize("name", list(CASES))
def test_summed_gradients_match_one_process(world, name):
    payload, results = world
    loss, grads = one_process_grads(payload, name)
    for r in results:
        assert r[name]["loss"] == pytest.approx(loss, rel=LOSS_REL)
        assert r[name]["grads"].keys() == grads.keys()
        for k, want in grads.items():
            np.testing.assert_allclose(r[name]["grads"][k], want, err_msg=k, **GRAD_TOL)


def test_gradient_tolerance_fails_when_the_gather_only_slices(world):
    """Without the sum over the ranks in the gather's backward, the K/V
    projections lose every later rank's queries' part: ``w_k`` and ``w_v``
    of each layer break the gradient tolerance."""
    payload, results = world
    _, grads = one_process_grads(payload, "sparse")
    keys = [k for k in grads if k.endswith("['w_k']") or k.endswith("['w_v']")]
    assert keys
    for r in results:
        for k in keys:
            assert not np.allclose(r["sparse"]["control_grads"][k], grads[k], **GRAD_TOL), k


def test_sequence_must_divide_by_the_ranks():
    mesh = context.Mesh((AXIS_SEQ,), (4,), (1,))
    with pytest.raises(ValueError, match="divide"):
        context._local(torch.zeros(1, 10), mesh)
    assert torch.equal(context._local(torch.arange(8)[None], mesh), torch.tensor([[2, 3]]))


def test_scaling_bench_rank_body(world):
    """Each size's mesh spans the world's first ranks (JAX's kv_heads 4:
    all heads), the others wait outside it."""
    _, results = world
    assert {n: f["mesh"] for n, f in results[0]["scaling"].items()} == {
        1: {"data": 1, "heads": 1}, 2: {"data": 1, "heads": 2}, 4: {"data": 1, "heads": 4}}
    assert [sorted(r["scaling"]) for r in results] == [[1, 2, 4], [2, 4], [4], [4]]
    assert all(f["step_s"] > 0 for r in results for f in r["scaling"].values())
    rows = scaling_bench.scaling_rows((1, 2, 4), 16, 1, results[0]["scaling"], "cpu")
    assert [(r["n_devices"], r["global_batch"], r["mesh_heads"]) for r in rows] == [
        (1, 1, 1), (2, 2, 2), (4, 4, 4)]
    assert all(r["metric_validity"] == "structural_only_cpu_mesh"
               and r["weak_scaling_efficiency"] == "" for r in rows)


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scaling_bench.main(["--devices", "1"])
