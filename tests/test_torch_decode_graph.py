"""The port's decode at a device position, the form its captured decode
loops run (``models/decode_graph.py``), against nsa_tpu on the CPU.

On the CPU the loops run the same step eagerly, so these tests hold that
step: the position a 0-d int32 tensor, the caches written in place, the
emission slot and the kv row chosen on the device.

* the scalar split route at b = 9 and the full-attention model, stepped at
  a device position, against JAX's ``transformer_decode_step`` over steps
  that cross compressed-block emissions;
* every route's step keeps each cache tensor at its address, and the split
  route's in-place ring shift equals the shifted ring the fused route's
  plain version builds with ``cat``;
* the decode loop's eager path against JAX's greedy tokens and, with JAX's
  noise passed in, its tempered ones;
* the plain versions of rows 2, 3, 6, 7 and 12 at a device position against
  the same at the int.

Inputs from numpy with fixed seeds, float32, tiny configuration.
Tolerance atol/rtol 2e-4, the repo's decode tolerance; tokens exact; the
plain versions at a tensor position equal those at the int bit for bit
(the same ops on the same values).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsa_tpu.config import tiny_test_config as j_tiny
from nsa_tpu.models import transformer as jt
from nsa_tpu_torch import tiny_test_config as t_tiny
from nsa_tpu_torch.models import decode_graph
from nsa_tpu_torch.models import transformer as tt
from nsa_tpu_torch.ops import nsa as t_nsa
from nsa_tpu_torch.ops.cuda import nsa_decode, nsa_decode_fused, nsa_decode_ragged
from nsa_tpu_torch.utils.checkpoint import params_from_numpy

TOL = dict(rtol=2e-4, atol=2e-4)
MAX_LEN = 32


@functools.lru_cache(maxsize=None)
def model_params(seed, sparse=True):
    cfg = j_tiny(use_sparse_attn=sparse)
    params = jax.jit(jt.init_transformer, static_argnums=1)(jax.random.PRNGKey(seed), cfg)
    return params, params_from_numpy(jax.tree_util.tree_map(np.asarray, params), device="cpu")


@functools.lru_cache(maxsize=None)
def jax_steps(sparse=True):
    """JAX's jitted prefill and decode step, shared by the tests (one
    compile a worker)."""
    cfg = j_tiny(use_sparse_attn=sparse)
    return (jax.jit(lambda p, i: jt.transformer_prefill(p, cfg, i, MAX_LEN)),
            jax.jit(lambda p, tok, c: jt.transformer_decode_step(p, cfg, tok, c)))


def jax_sampled(params, ids, gen, temperature=0.0, rng=None):
    """JAX's ``transformer_sample`` scan step by step: the prefill, then the
    decode step, each picking its token with JAX's ``_sample_from_logits``
    (the first with ``rng``, token i with the i-1-th key of its split)."""
    prefill, step = jax_steps()
    logits, cache = prefill(params, jnp.asarray(ids))
    keys = [rng, *jax.random.split(rng, gen)[:gen - 1]] if temperature > 0 else [None] * gen
    token = np.asarray(jt._sample_from_logits(logits[:, -1], keys[0], temperature, 0.9))
    toks = [token]
    for i in range(1, gen):
        logits, cache = step(params, jnp.asarray(token), cache)
        token = np.asarray(jt._sample_from_logits(logits, keys[i], temperature, 0.9))
        toks.append(token)
    return np.stack(toks, 1), keys


def prompt_ids(b, n, seed):
    return np.random.RandomState(seed).randint(0, 256, (b, n)).astype(np.int32)


def position(t):
    return torch.tensor(t, dtype=torch.int32)


def T(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("sparse,b", [(True, 9), (False, 2)])
def test_decode_at_a_device_position_matches_jax(sparse, b):
    """b = 9 takes the port's split route (JAX: its XLA path); 2 x stride
    + 1 steps from position 13 emit at t = 13, 15 and 17.  The full model
    attends over every row under the mask row <= t."""
    params, port = model_params(5, sparse)
    t_cfg = t_tiny(use_sparse_attn=sparse)
    ids = prompt_ids(b, 13, seed=7)
    j_prefill, j_step = jax_steps(sparse)
    j_logits, j_cache = j_prefill(params, jnp.asarray(ids))
    _, t_cache = tt.transformer_prefill(port, t_cfg, T(ids), MAX_LEN)
    token = np.asarray(j_logits[:, -1]).argmax(-1)
    stride = t_cfg.nsa.compress_block_sliding_stride
    for step in range(2 * stride + 1):
        j_logits, j_cache = j_step(params, jnp.asarray(token), j_cache)
        t_logits, _ = tt.transformer_decode_step(port, t_cfg, T(token), t_cache,
                                                 pos=position(13 + step))
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                                   err_msg=f"step {step}", **TOL)
        token = np.asarray(j_logits).argmax(-1)
        assert (t_logits.argmax(-1).numpy() == token).all(), f"step {step}"


def cache_pointers(layers):
    return [x.data_ptr() for lc in layers for x in lc]


@pytest.mark.parametrize("route", ["split", "fused", "mega", "ragged", "paged", "ragged_split"])
def test_decode_step_keeps_cache_addresses(route):
    """One step on each route writes every cache tensor in place; on the
    split route the ring after the step equals the fused route's plain
    shift (``cat`` of the old ring's tail and the new row), bit for bit."""
    _, port = model_params(6)
    cfg = t_tiny()
    packed = tt.fuse_decode_params(port, cfg)
    ids = T(prompt_ids(2, 13, seed=8))
    logits, cache = tt.transformer_prefill(port, cfg, ids, MAX_LEN)
    token = logits[:, -1].argmax(-1)
    before = cache_pointers(cache.layers)
    seq = torch.tensor([13, 13], dtype=torch.int32)
    if route in ("split", "fused", "mega"):
        tt.transformer_decode_step(packed, cfg, token, cache, route=route, pos=position(13))
    elif route == "paged":
        page = 8
        table = torch.arange(MAX_LEN // page * 2, dtype=torch.int32).reshape(2, -1)
        pools = tuple(t_nsa.NSADecodeCache(
            kv=lc.kv.reshape(2, cfg.kv_heads, -1, page, lc.kv.shape[-1]).transpose(1, 2)
            .reshape(-1, cfg.kv_heads, page, lc.kv.shape[-1]).contiguous(),
            ckv=lc.ckv, ring=lc.ring) for lc in cache.layers)
        before = cache_pointers(pools)
        tt.transformer_decode_step_ragged(packed, cfg, token, pools, seq, table)
        assert cache_pointers(pools) == before
        return
    else:
        tt.transformer_decode_step_ragged(packed, cfg, token, cache.layers, seq,
                                          route="split" if route == "ragged_split" else None)
    assert cache_pointers(cache.layers) == before
    if route == "split":       # layer 0: the same inputs on both routes
        _, again = tt.transformer_prefill(port, cfg, ids, MAX_LEN)
        old = again.layers[0].ring.clone()
        tt.transformer_decode_step(packed, cfg, token, again, route="fused")
        assert torch.equal(cache.layers[0].ring, again.layers[0].ring)
        assert torch.equal(cache.layers[0].ring[:, :, :-1], old[:, :, 1:])


def counted_loops(monkeypatch):
    loops = []
    real = decode_graph.decode_loop
    monkeypatch.setattr(decode_graph, "decode_loop",
                        lambda state, body, n, **kw: loops.append(
                            (body.__qualname__.split(".")[0], n)) or real(state, body, n, **kw))
    return loops


def test_greedy_loop_eager_gives_jax_tokens(monkeypatch):
    """The greedy loop runs through ``decode_graph.decode_loop``, eagerly on
    the CPU: at b = 9 (the split route) token for token JAX's greedy
    sampling; the host checks the loop's range at its start."""
    params, port = model_params(2)
    loops = counted_loops(monkeypatch)
    b, gen = 9, 8
    ids = prompt_ids(b, 13, seed=3)
    want, _ = jax_sampled(params, ids, gen)
    got = tt.transformer_greedy(port, t_tiny(), T(ids), gen, max_len=MAX_LEN)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert loops == [("greedy_decode", gen)]
    with pytest.raises(ValueError, match="do not fit"):
        tt.transformer_greedy(port, t_tiny(), T(ids), gen, max_len=16)


def test_sample_loop_eager_gives_jax_tokens(monkeypatch):
    """The tempered loop at b = 9, JAX's noise passed in and indexed by the
    step counter on the device: token for token JAX's tempered sampling
    (its sampler on its logits, with the keys ``transformer_sample``
    splits)."""
    params, port = model_params(2)
    loops = counted_loops(monkeypatch)
    b, gen = 9, 8
    ids = prompt_ids(b, 13, seed=3)
    want, keys = jax_sampled(params, ids, gen, 0.8, jax.random.PRNGKey(11))
    gumbel = np.stack([np.asarray(-jnp.log(-jnp.log(jax.random.uniform(k, (b, 256)) + 1e-20)
                                           + 1e-20)) for k in keys])
    got = tt.transformer_sample(port, t_tiny(), T(ids), gen, temperature=0.8, gumbel=T(gumbel),
                                max_len=MAX_LEN)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert loops == [("sample_decode", gen - 1)]


def split_inputs(t, b=3, kvh=2, g=2, d=16, M=1, stride=4, Bs=8, max_len=64):
    gen = torch.Generator().manual_seed(t)
    Wc = t_nsa._ckv_width(max_len, stride, Bs // stride)

    def randn(*shape):
        return torch.randn(shape, generator=gen)

    return dict(q=randn(b, kvh, g, d), ckv=randn(b, kvh, Wc, 2 * d), mem=randn(2, kvh, M, d),
                rq=randn(b, kvh, g, d), kv=randn(b, kvh, max_len, 2 * d),
                gates=torch.rand((b, kvh, g, 3), generator=gen), randn=randn,
                skw=dict(max_blocks=max_len // Bs, stride=stride, sel_block=Bs, num_sel=2,
                         n_slide=3, scale=d ** -0.5),
                akw=dict(sel_block=Bs, window=16, num_sel=2, n_slide=3, scale=d ** -0.5))


@pytest.mark.parametrize("t", [3, 22, 63])
def test_split_pair_plain_at_a_device_position(t):
    """Rows 2 and 3: the plain select and attend, and the wrappers on the
    CPU, at position t as a 0-d tensor equal the same at the int."""
    x = split_inputs(t)
    stride = x["skw"]["stride"]
    for select, attend in ((nsa_decode.decode_select_plain, nsa_decode.decode_attend_plain),
                           (nsa_decode.decode_select, nsa_decode.decode_attend)):
        outs = []
        for tt_ in (t, position(t)):
            c_out, info = select(x["q"], x["ckv"], x["mem"], tt_, tt_ // stride, **x["skw"])
            out = attend(x["rq"], x["kv"], info, c_out, x["gates"], tt_, **x["akw"])
            outs.append((c_out, info, out))
        for a, b in zip(*outs):
            assert torch.equal(a, b)


@pytest.mark.parametrize("t", [22, 23, 63])
def test_fused_pair_plain_at_a_device_position(t):
    """Rows 6 and 7: the plain select-emit (t = 23 and 63 emit at stride 4,
    22 does not) and attend at position t as a 0-d tensor equal the same at
    the int, caches included."""
    x = split_inputs(t)
    b, kvh, g, d = x["q"].shape
    Bc, hid, dim = 8, 64, 32
    randn, stride = x["randn"], x["skw"]["stride"]
    ring, kv_new = randn(b, kvh, Bc, 2 * d), randn(b, kvh, 1, 2 * d)
    weights = (randn(kvh, Bc, 2 * d), randn(kvh, Bc * d, hid) * 0.1, randn(kvh, hid),
               randn(kvh, Bc * d, hid) * 0.1, randn(kvh, hid), randn(kvh, hid, 2 * d) * 0.1,
               randn(kvh, 2 * d))
    xs, w_out = randn(b, 1, dim), randn(kvh * g * d, dim) * 0.1
    ff = (torch.ones(dim), randn(dim, 64) * 0.1, randn(64), randn(64, dim) * 0.1, randn(dim))
    outs = []
    for tt_ in (t, position(t)):
        ckv, rg, kv = x["ckv"].clone(), ring.clone(), x["kv"].clone()
        c_out, info = nsa_decode_fused.decode_select_emit_plain(
            x["q"], ckv, rg, kv_new, x["mem"], *weights, tt_, tt_ // stride, **x["skw"])
        out = nsa_decode_fused.decode_attend_fused_plain(
            x["rq"], kv, kv_new, info, c_out, x["gates"], xs, w_out, tt_, ff, **x["akw"])
        outs.append((c_out, info, ckv, rg, kv, out))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    emitted = not torch.equal(outs[0][2], x["ckv"])
    assert emitted == ((t + 1) % stride == 0)


@pytest.mark.parametrize("t0,steps", [(13, 1), (14, 3)])
def test_whole_model_plain_at_a_device_position(t0, steps):
    """Row 12: the plain whole-model decode (the wrapper on the CPU) at a
    0-d tensor position equals the same at the int: logits, tokens and
    caches."""
    _, port = model_params(4)
    cfg = t_tiny()
    mp = tt.fuse_decode_params(port, cfg)["mega"]
    logits, cache = tt.transformer_prefill(port, cfg, T(prompt_ids(2, t0, seed=t0)), MAX_LEN)
    token = logits[:, -1].argmax(-1)
    outs = []
    for t in (t0, position(t0)):
        kv, ckv, ring = (torch.stack([getattr(lc, f) for lc in cache.layers])
                         for f in ("kv", "ckv", "ring"))
        outs.append(tt.transformer_decode_step_mega(mp, cfg, token, kv, ckv, ring, t,
                                                    greedy=True, steps=steps))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_ragged_emission_predicate_at_one_position():
    """The split route's emission slot, chosen on the device for every row
    at one position, is the slot the host's rule gives."""
    stride, trash = 4, 20
    for t in range(12):
        tv = position(t).expand(3)
        slot = torch.where(nsa_decode_ragged.ragged_emits(tv, tv // stride, stride),
                           (tv // stride).clamp(0, trash), trash)
        want = min(t // stride, trash) if nsa_decode_fused.emits(t, stride) else trash
        assert slot.tolist() == [want] * 3
