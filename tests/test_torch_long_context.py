"""The long-context path: JAX's streaming kernel bodies and its 16k entry
point, against the port.

* ``flash_attention_plain`` (row 13's plain version) against JAX's
  ``flash_attention(..., stream=True)``, the body JAX runs past
  ``STREAM_MIN_NK`` keys, in interpret mode with 128-row tiles (as
  ``tests/test_pallas_kernels.py`` runs it): n 512 causal and 384
  non-causal, b 1, 4 / 2 heads, d 64.
* ``fine_sliding_plain`` (row 1's plain version) and its backward, through
  ``nsa_fine_sliding_attention``, against JAX's ``nsa_fine_sliding_attention``
  with its streaming forward forced (``FORCE_STREAM``): n 256, d 64, S 2,
  selection block 16, window 24; value and the gradients of rq, rk, v.
* ``python -m nsa_tpu_torch.eval.efficiency_16k --device cpu`` on tiny
  checkpoints (an export and a checkpoint directory): a small ``--max-len``
  and prompts on both sides of a bucket; its CSV has JAX's columns and
  JAX's cache length and buckets (``nsa_tpu/eval/efficiency.py``).
* ``python -m nsa_tpu_torch.profile_decode``'s timing path on the tiny
  configuration; both entry points raise without a card unless asked for
  the CPU.

float32; inputs from numpy seeds.  Tolerance 2e-5 (atol and rtol) on
values and gradients: the same float32 math summed in another order.
"""

import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsa_tpu.config import tiny_test_config as j_tiny
from nsa_tpu.eval import efficiency as j_eff
from nsa_tpu.ops.pallas import nsa_prefill as j_pre
from nsa_tpu.ops.pallas.flash import flash_attention as j_flash
from nsa_tpu_torch import profile_decode
from nsa_tpu_torch import tiny_test_config as t_tiny
from nsa_tpu_torch.eval import efficiency as t_eff
from nsa_tpu_torch.eval import efficiency_16k
from nsa_tpu_torch.models import transformer as tt
from nsa_tpu_torch.ops.cuda import flash as t_flash
from nsa_tpu_torch.ops.cuda import nsa_prefill as t_pre
from nsa_tpu_torch.utils import checkpoint as t_ckpt

TOL = dict(rtol=2e-5, atol=2e-5)


def T(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("n,causal", [(512, True), (384, False)])
def test_flash_plain_matches_jax_streaming_body(n, causal):
    b, h, kvh, d = 1, 4, 2, 64
    rs = np.random.RandomState(11)
    q, k, v = (rs.standard_normal(s).astype(np.float32)
               for s in ((b, h, n, d), (b, kvh, n, d), (b, kvh, n, d)))
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                   interpret=True, block_q=128, block_k=128, stream=True)
    before = t_flash.flash_attention.launches
    got = t_flash.flash_attention(T(q), T(k), T(v), causal=causal)
    assert t_flash.flash_attention.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(t_flash.flash_attention_plain(T(q), T(k), T(v), causal).numpy(),
                               np.asarray(want), **TOL)


def prefill_selection(rs, b, kvh, n, sel_block):
    """Two selected blocks a row, before its own block (distinct where there
    are two), 80% valid: ``tests/test_pallas_kernels.py``'s recipe."""
    q_blk = np.arange(n) // sel_block
    avail = np.maximum(q_blk, 1)[None, None, :]
    raw = rs.randint(0, 1 << 30, (b, kvh, n, 2))
    idx0 = raw[..., 0] % avail
    idx1 = (idx0 + 1 + raw[..., 1] % np.maximum(avail - 1, 1)) % avail
    sel_idx = np.stack([idx0, idx1], axis=-1).astype(np.int32)
    ok = np.stack([np.broadcast_to(q_blk > 0, (b, kvh, n)),
                   np.broadcast_to(q_blk > 1, (b, kvh, n))], axis=-1)
    return sel_idx, (rs.rand(b, kvh, n, 2) < 0.8) & ok


def test_fine_sliding_plain_and_backward_match_jax_streaming_body(monkeypatch):
    b, h, kvh, n, d, sel_block, window, scale = 1, 4, 2, 256, 64, 16, 24, 0.125
    rs = np.random.RandomState(7)
    rq, rk, v = (0.5 * rs.standard_normal(s).astype(np.float32)
                 for s in ((b, h, n, d), (b, kvh, n, d), (b, kvh, n, d)))
    sel_idx, sel_mask = prefill_selection(rs, b, kvh, n, sel_block)
    monkeypatch.setattr(j_pre, "FORCE_STREAM", True)

    def f(q_, k_, v_):
        fo, so = j_pre.nsa_fine_sliding_attention(
            q_, k_, v_, jnp.asarray(sel_idx), jnp.asarray(sel_mask), None, sel_block, window,
            scale, 64, 128, True)
        return (fo ** 2).sum() + (so * 0.5).sum()

    want, want_grads = jax.value_and_grad(f, argnums=(0, 1, 2))(
        jnp.asarray(rq), jnp.asarray(rk), jnp.asarray(v))

    leaves = [T(x).requires_grad_() for x in (rq, rk, v)]
    fo, so = t_pre.nsa_fine_sliding_attention(*leaves, T(sel_idx), T(sel_mask), None,
                                              sel_block, window, scale)
    got = (fo ** 2).sum() + (so * 0.5).sum()
    grads = torch.autograd.grad(got, leaves)
    assert got.item() == pytest.approx(float(want), rel=1e-5)
    for name, g, w in zip(("rq", "rk", "v"), grads, want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **TOL)
    # the plain forward alone: both outputs against JAX's streamed forward
    outs = t_pre.fine_sliding_plain(*(T(x) for x in (rq, rk, v, sel_idx, sel_mask)),
                                    sel_block, window, scale)
    jfo, jso = j_pre.nsa_fine_sliding_attention(
        *(jnp.asarray(x) for x in (rq, rk, v, sel_idx, sel_mask)), None, sel_block, window,
        scale, 64, 128, True)
    for x, y in zip(outs[:2], (jfo, jso)):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), **TOL)


def tiny_checkpoints(tmp_path):
    """The tiny sparse model as an export and the tiny full model as a
    checkpoint directory, from a seeded init; and the sparse one as a JAX
    tree."""
    paths = {}
    for name, sparse in (("sparse", True), ("full", False)):
        cfg = t_tiny(use_sparse_attn=sparse)
        port = tt.init_transformer(cfg, torch.Generator().manual_seed(3), device="cpu")
        if sparse:
            paths[name] = t_ckpt.export_params_npz(str(tmp_path / "sparse.npz"), port, cfg)
            paths["sparse_jax"] = jax.tree_util.tree_map(lambda x: jnp.asarray(x.numpy()), port)
        else:
            t_ckpt.save_checkpoint(str(tmp_path / "full_ckpt"), 7, port, model_cfg=cfg)
            paths[name] = str(tmp_path / "full_ckpt")
    return paths


def test_efficiency_16k_cli_on_tiny_checkpoints(tmp_path, capsys):
    """``--max-len 256``, prompts 100 and 200: the second pads to the whole
    cache (the 16k cell's 15,000 -> 16,384), the first to the 128 bucket
    (8,000 -> 8,192).  The rows carry JAX's columns in JAX's order, JAX's
    cache length and buckets, and their counts."""
    paths = tiny_checkpoints(tmp_path)
    out = tmp_path / "eff.csv"
    argv = ["--bs", "2", "--prompts", "100", "200", "--gen", "2", "--max-len", "256",
            "--csv", str(out), "--sparse-ckpt", paths["sparse"], "--full-ckpt", paths["full"]]
    with pytest.raises(RuntimeError, match="CUDA"):
        efficiency_16k.main(argv)
    rows = efficiency_16k.main(argv + ["--device", "cpu"])
    printed = capsys.readouterr().out
    assert "== sparse_mlp @ max_len 256 ==" in printed and "== full @ max_len 256 ==" in printed
    # JAX's sweep at the prompt whose bucket is the whole cache
    want = j_eff.run_efficiency_sweep(paths["sparse_jax"], j_tiny(), "sparse_mlp",
                                      batch_sizes=[2], prompt_lens=[200], gen_len=2,
                                      seq_len=256, step=5000)
    with open(out) as f:
        written = list(csv.DictReader(f))
    assert len(rows) == len(written) == 4
    assert list(written[0]) == list(want[0])
    assert [(r["model_type"], r["batch_size"], r["prompt_len"]) for r in rows] == [
        (m, 2, p) for m in ("sparse_mlp", "full") for p in (100, 200)]
    for key in ("seq_len", "max_len", "prefill_bucket", "gen_len", "kv_cache_saving_ratio"):
        assert rows[1][key] == want[0][key], key
    assert [r["prefill_bucket"] for r in rows] == [128, 256] * 2
    assert all(r["max_len"] == 256 and r["seq_len"] == 256 for r in rows)
    assert all(r["kv_cache_saving_ratio"] == 0.0 for r in rows[2:])
    assert all(r["decode_tokens_per_s"] > 0 and r["prefill_tokens_per_s"] > 0 for r in rows)


def test_sweep_keeps_its_card_check():
    """The sweep still refuses the CPU unless the host clock is asked for."""
    port = tt.init_transformer(t_tiny(), torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_eff.run_efficiency_sweep(port, t_tiny(), "m", [1], [9], 2, 32, device="cpu")
    rows = t_eff.run_efficiency_sweep(port, t_tiny(), "m", [1], [9], 2, 32, device="cpu",
                                      host_clock=True, log=lambda line: None)
    assert rows[0]["prefill_bucket"] == rows[0]["max_len"] == 128


def test_profile_decode_on_the_tiny_config(monkeypatch):
    """Every ablation's decode runs and is timed on the host clock; the
    entry point raises without a card unless asked for the CPU."""
    with pytest.raises(RuntimeError, match="CUDA"):
        profile_decode.main(["--full-only"])
    monkeypatch.delenv("NSA_ABLATE", raising=False)
    cfg = t_tiny()
    params = tt.init_transformer(cfg, torch.Generator().manual_seed(0), device="cpu")
    lines = []
    got = profile_decode.profile(params, cfg, batch=9, prompt=9, gen=3, max_len=32, iters=1,
                                 device="cpu", log=lines.append)
    assert list(got) == ["full", *profile_decode.ABLATIONS]
    assert all(ms > 0 for ms in got.values()) and len(lines) == 5
    assert lines[0].startswith("full step: ")
    assert "NSA_ABLATE" not in profile_decode.os.environ
