"""The adapter / distillation line (``models/adapter.py``,
``models/llama_import.py``, ``train/finetune.py``, ``train/task_data.py``,
``train/data_collection.py``, ``eval/finetune_eval.py``, the swiglu FF)
against ``nsa_tpu``'s on the same weights and inputs: ``tiny_test_config``,
float32, the CPU (the wrappers' plain versions).

Tolerances: logits 2e-4 (the repo's forward tolerance), losses rel 1e-5,
the adapters' gradients rtol 2e-3 / atol 2e-5, the adapters after two
fine-tune steps rtol 2e-4 / atol 2e-5; tokens, masks, loaders and the
converter's tensors exact; the converted model against HF ``transformers``'
logits 2e-3 (``tests/test_llama_import.py``'s).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsa_tpu.config import tiny_test_config as j_tiny
from nsa_tpu.eval import finetune_eval as j_eval
from nsa_tpu.models import adapter as j_ad
from nsa_tpu.models import llama_import as j_llama
from nsa_tpu.models import transformer as jt
from nsa_tpu.train import data_collection as j_dc
from nsa_tpu.train import finetune as j_ft
from nsa_tpu.train import task_data as j_td
from nsa_tpu_torch import tiny_test_config as t_tiny
from nsa_tpu_torch.eval import finetune_eval as t_eval
from nsa_tpu_torch.models import adapter as t_ad
from nsa_tpu_torch.models import llama_import as t_llama
from nsa_tpu_torch.models import transformer as tt
from nsa_tpu_torch.ops import nsa as t_nsa
from nsa_tpu_torch.train import data_collection as t_dc
from nsa_tpu_torch.train import finetune as t_ft
from nsa_tpu_torch.train import finetune_cs441
from nsa_tpu_torch.train import task_data as t_td
from nsa_tpu_torch.train.pretrain import trainable
from nsa_tpu_torch.utils.checkpoint import params_from_numpy, save_checkpoint, tree_items

LOGITS_TOL = dict(rtol=2e-4, atol=2e-4)
LOSS_REL = 1e-5
GRAD_TOL = dict(rtol=2e-3, atol=2e-5)
STEP_TOL = dict(rtol=2e-4, atol=2e-5)
HF_TOL = dict(rtol=2e-3, atol=2e-3)
B, N = 2, 24
CFG_T, CFG_S = dict(use_sparse_attn=False), dict(use_sparse_attn=True)


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    """JAX's teacher and adapters, and the same in the port.  The adapters
    start from another teacher's projections, so the student's logits are
    not the teacher's and the KL is not a difference of near-equal sums."""
    init = jax.jit(jt.init_transformer, static_argnums=1)
    teacher = init(jax.random.PRNGKey(0), j_tiny(**CFG_T))
    adapters = jax.jit(j_ad.init_adapters, static_argnums=1)(
        jax.random.PRNGKey(1), j_tiny(**CFG_S), init(jax.random.PRNGKey(7), j_tiny(**CFG_T)))
    np_t, np_a = to_numpy(teacher), to_numpy(adapters)
    ids = np.random.RandomState(0).randint(0, 256, (B, N + 1)).astype(np.int32)
    mask = np.random.RandomState(1).rand(B, N + 1) > 0.3
    return {"teacher": np_t, "adapters": np_a, "ids": ids, "mask": mask,
            "j_teacher": teacher, "j_adapters": adapters}


def port(m):
    return (params_from_numpy(m["teacher"], device="cpu"),
            params_from_numpy(m["adapters"], device="cpu"))


def test_adapted_forward_matches_jax(models):
    teacher, adapters = port(models)
    ids = models["ids"][:, :-1]
    want, want_h = jax.jit(j_ad.adapted_forward, static_argnums=2,
                           static_argnames="output_hidden_states")(
        models["j_adapters"], models["j_teacher"], j_tiny(**CFG_S), jnp.asarray(ids),
        output_hidden_states=True)
    got, got_h = t_ad.adapted_forward(adapters, teacher, t_tiny(**CFG_S),
                                      torch.from_numpy(ids).long(), output_hidden_states=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS_TOL)
    assert len(got_h) == len(want_h) == t_tiny().depth + 1
    for g, w in zip(got_h, want_h):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **LOGITS_TOL)


@pytest.mark.parametrize("mode", t_ad.MODES)
def test_distillation_loss_modes_match_jax(models, mode):
    teacher, adapters = port(models)
    ids, mask = models["ids"][:, :-1], models["mask"][:, 1:]
    want = jax.jit(j_ad.distillation_step_loss, static_argnums=(2, 3),
                   static_argnames="mode")(
        models["j_adapters"], models["j_teacher"], j_tiny(**CFG_S), j_tiny(**CFG_T),
        jnp.asarray(ids), label_mask=jnp.asarray(mask), mode=mode)
    got = t_ad.distillation_step_loss(adapters, teacher, t_tiny(**CFG_S), t_tiny(**CFG_T),
                                      torch.from_numpy(ids).long(),
                                      label_mask=torch.from_numpy(mask), mode=mode)
    assert float(got) == pytest.approx(float(want), rel=LOSS_REL)


def test_adapter_gradients_match_jax(models):
    teacher, adapters = port(models)
    ids, mask = models["ids"][:, :-1], models["mask"][:, 1:]

    def j_loss(ad):
        return j_ad.distillation_step_loss(ad, models["j_teacher"], j_tiny(**CFG_S),
                                           j_tiny(**CFG_T), jnp.asarray(ids),
                                           label_mask=jnp.asarray(mask), mode="mixed")

    want = jax.jit(jax.grad(j_loss))(models["j_adapters"])
    want = {jax.tree_util.keystr(p): np.asarray(g)
            for p, g in jax.tree_util.tree_flatten_with_path(want)[0]}
    adapters = trainable(adapters)
    t_ad.distillation_step_loss(adapters, teacher, t_tiny(**CFG_S), t_tiny(**CFG_T),
                                torch.from_numpy(ids).long(), label_mask=torch.from_numpy(mask),
                                mode="mixed").backward()
    got = {k: v.grad.numpy() for k, v in tree_items(adapters)}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **GRAD_TOL)


def test_two_finetune_steps_match_jax(models):
    """Two ``finetune_step``s (clip 0.1, AdamW with optax's defaults, the
    cosine-restart schedule at counts 0 and 1) against JAX's, jitted once."""
    teacher, adapters = port(models)
    lr, steps = 1e-3, 6
    rng = np.random.RandomState(2)
    batches = [(rng.randint(0, 256, (B, N + 1)).astype(np.int32), rng.rand(B, N + 1) > 0.3)
               for _ in range(2)]
    opt = j_ft.make_finetune_optimizer(lr, steps)
    j_adapters, state = models["j_adapters"], None
    state = opt.init(j_adapters)
    adapters = trainable(adapters)
    t_opt = t_ft.make_finetune_optimizer(adapters, lr, steps)
    for ids, mask in batches:
        j_adapters, state, j_loss = j_ft.finetune_step(
            j_adapters, state, models["j_teacher"], jnp.asarray(ids), jnp.asarray(mask),
            j_tiny(**CFG_S), j_tiny(**CFG_T), opt, "kl_output_only")
        t_loss = t_ft.finetune_step(adapters, t_opt, teacher, torch.from_numpy(ids).long(),
                                    torch.from_numpy(mask), t_tiny(**CFG_S), t_tiny(**CFG_T))
        assert float(t_loss) == pytest.approx(float(j_loss), rel=STEP_TOL["rtol"])
    want = {jax.tree_util.keystr(p): np.asarray(g)
            for p, g in jax.tree_util.tree_flatten_with_path(j_adapters)[0]}
    for k, v in tree_items(adapters):
        np.testing.assert_allclose(v.detach().numpy(), want[k], err_msg=k, **STEP_TOL)


def test_schedule_matches_optax():
    j_fn, t_fn = j_ft.cosine_restarts_schedule(1e-4, 10), t_ft.cosine_restarts_schedule(1e-4, 10)
    for step in range(12):
        assert t_fn(step) == pytest.approx(float(j_fn(step)), rel=1e-6)


def test_gradient_flow(models):
    teacher, adapters = port(models)
    ids = torch.from_numpy(models["ids"][:, :-1]).long()
    ok, info = t_ad.verify_gradient_flow(adapters, teacher, t_tiny(**CFG_S), t_tiny(**CFG_T), ids)
    assert ok, info
    assert info["teacher_grad_norm"] == 0.0 and len(info["adapter_grad_norms"]) == 2


def test_init_copies_the_teacher_projections(models):
    teacher, _ = port(models)
    adapters = t_ad.init_adapters(torch.Generator().manual_seed(0), t_tiny(**CFG_S), teacher)
    for ad, layer in zip(adapters, teacher["layers"]):
        for name in ("w_q", "w_k", "w_v", "w_out"):
            assert torch.equal(ad[name], layer["attn"][name])
            assert ad[name].data_ptr() != layer["attn"][name].data_ptr()
        assert torch.equal(ad["norm_scale"], torch.ones(t_tiny().dim))
    shapes = [{k: tuple(v.shape) for k, v in tree_items(a)} for a in adapters]
    assert shapes == [{k: v.shape for k, v in tree_items(a)} for a in models["adapters"]]


def swiglu_params(cfg):
    params = tt.init_transformer(cfg, torch.Generator().manual_seed(4), "cpu")
    assert set(params["layers"][0]["ff"]) == {"norm_scale", "w1", "w3", "w2"}
    return params


@pytest.mark.parametrize("sparse", [True, False])
def test_swiglu_forward_and_decode_match_jax(sparse):
    """The swiglu model's forward, prefill and two decode steps (the FF
    after the attention; the sparse model on the split route) against
    ``nsa_tpu``'s."""
    cfg = t_tiny(ff_kind="swiglu", use_sparse_attn=sparse)
    jcfg = j_tiny(ff_kind="swiglu", use_sparse_attn=sparse)
    tree = jax.tree_util.tree_map(lambda t: t.numpy(), swiglu_params(cfg))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    params = params_from_numpy(tree, device="cpu")      # w1, w3, w2 carried across
    ids = np.random.RandomState(5).randint(0, 256, (2, 20)).astype(np.int32)
    want = jax.jit(jt.transformer_forward, static_argnums=1)(jparams, jcfg, jnp.asarray(ids))
    got = tt.transformer_forward(params, cfg, torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS_TOL)
    logits, cache = tt.transformer_prefill(params, cfg, torch.from_numpy(ids[:, :16]).long(), 32)
    jl, jc = jax.jit(jt.transformer_prefill, static_argnums=(1, 3))(
        jparams, jcfg, jnp.asarray(ids[:, :16]), 32)
    j_step = jax.jit(jt.transformer_decode_step, static_argnums=1)
    for t in (16, 17):
        logits, cache = tt.transformer_decode_step(params, cfg, torch.from_numpy(ids[:, t]).long(),
                                                   cache)
        jl, jc = j_step(jparams, jcfg, jnp.asarray(ids[:, t]), jc)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **LOGITS_TOL)


def test_swiglu_refuses_the_routes_that_fold_the_gelu_ff(monkeypatch):
    cfg = t_tiny(ff_kind="swiglu")
    for route in ("fused", "hybrid"):
        with pytest.raises(ValueError, match="gelu FF"):
            t_nsa.decode_route(cfg, 4, False, route)
    assert t_nsa.decode_route(cfg, 4, False) == "split"
    assert t_nsa.decode_route(cfg, 4, True) == "xla"
    assert not tt.use_mega_decode(cfg, 4)
    with pytest.raises(ValueError, match="gelu FF"):
        tt._mega_route(cfg, 4, "mega")
    with pytest.raises(ValueError, match="gelu FF"):
        tt.pack_mega_params(swiglu_params(cfg), cfg)
    monkeypatch.setenv("NSA_HYBRID_DECODE", "1")
    with pytest.raises(ValueError, match="swiglu"):
        t_nsa.decode_route(cfg, 16, False)
    with pytest.raises(ValueError, match="ff_kind"):
        tt.transformer_forward(swiglu_params(cfg), t_tiny(ff_kind="relu"),
                               torch.zeros(1, 4, dtype=torch.long))


def test_greedy_generate_fixed_matches_jax(models):
    teacher, adapters = port(models)
    prompt = np.frombuffer(b"Which clock?\nAnswer: ", np.uint8).astype(np.int32)

    def j_fn(ids):
        return j_ad.adapted_forward(models["j_adapters"], models["j_teacher"], j_tiny(**CFG_S),
                                    ids)

    t_fn = t_eval.model_forward_fn(
        lambda ids: t_ad.adapted_forward(adapters, teacher, t_tiny(**CFG_S), ids), teacher)
    want = j_eval.greedy_generate_fixed(jax.jit(j_fn), prompt, 6, 32)
    got = t_eval.greedy_generate_fixed(t_fn, prompt, 6, 32)
    np.testing.assert_array_equal(got, want)
    # causal: the growing forward gives the fixed buffer's tokens
    stop = list(want).index(ord("\n")) + 1 if ord("\n") in want else len(want)
    np.testing.assert_array_equal(t_eval.greedy_generate_reforward(t_fn, prompt, 6),
                                  want[:stop])


def test_text_helpers_match_jax():
    pairs = [("What is 2+2", "4"), ("Which consensus algorithm?", "raft"), ("x" * 40, "y")]
    for a, b in zip(t_ft.qa_to_tokens(pairs, 32), j_ft.qa_to_tokens(pairs, 32)):
        np.testing.assert_array_equal(a, b)
    for text in ("Q?\nAnswer: Raft.\nmore", "no answer here", "Answer:   \n"):
        assert t_eval.extract_answer(text) == j_eval.extract_answer(text)
    for pred, gold in (("b", "b"), ("b) x", "B"), ("bbbb", "b"), (None, "a"), ("", "a")):
        assert t_eval.answer_matches(pred, gold) == j_eval.answer_matches(pred, gold)
    for c, n in ((0, 0), (0, 10), (7, 84), (84, 84)):
        assert t_eval.wilson_interval(c, n) == pytest.approx(j_eval.wilson_interval(c, n))
    for q, a, s in (("Q?", "A", None), ("Q?", None, "sys")):
        assert t_td.format_chat(q, a, s) == j_td.format_chat(q, a, s)
    for task, text in (("gsm8k", "x\n#### 1,234"), ("gsm8k", "costs $6.50"),
                       ("strategyqa", "Yes, because"), ("aqua", "none")):
        assert t_td.final_answer(task, text) == j_td.final_answer(task, text)


def test_task_loaders_and_data_collection_match_jax(tmp_path):
    gsm = [{"question": "Tom has 3 apples and buys 4. How many?", "answer": "7.\n#### 7"},
           {"input": "A pen costs $2?", "target": "#### 6"}]
    for names in t_td._TASK_FILES.values():
        for name in set(names.values()):
            path = tmp_path / name
            if name.endswith(".jsonl"):
                path.write_text("\n".join(json.dumps(r) for r in gsm) + "\n")
            else:
                rows = [{"question": f"Q{i}?", "answer": bool(i % 2)} for i in range(10)]
                path.write_text(json.dumps(rows))
    assert t_td.TASKS == j_td.TASKS
    for task in t_td.TASKS:
        for split in ("train", "dev", "test"):
            assert t_td.load_task(task, str(tmp_path), split) == \
                j_td.load_task(task, str(tmp_path), split)
        assert t_td.task_pairs(task, str(tmp_path)) == j_td.task_pairs(task, str(tmp_path))
    assert t_dc.generate_synthetic_qa(280) == j_dc.generate_synthetic_qa(280)
    assert t_dc.split_train_test(t_dc.generate_synthetic_qa(280)) == \
        j_dc.split_train_test(j_dc.generate_synthetic_qa(280))
    got, want = t_dc.write_dataset(str(tmp_path / "t")), j_dc.write_dataset(str(tmp_path / "j"))
    for split in ("train", "test"):
        with open(got[split]) as f, open(want[split]) as g:
            assert f.read() == g.read()


def write_tiny_llama(path, tie, safe=True):
    transformers = pytest.importorskip("transformers")
    cfg = transformers.LlamaConfig(
        vocab_size=64, hidden_size=32, intermediate_size=48, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
        rms_norm_eps=1e-5, rope_theta=10000.0, tie_word_embeddings=tie, attention_bias=False)
    torch.manual_seed(0)
    model = transformers.LlamaForCausalLM(cfg).eval()
    model.save_pretrained(str(path), safe_serialization=safe)
    return model


@pytest.mark.parametrize("tie,safe", [(False, True), (True, True), (False, False)])
def test_llama_import_matches_jax_and_hf(tmp_path, tie, safe):
    """The port's converter (its own safetensors reader, or ``torch.load``
    for ``.bin``) against JAX's, leaf by leaf exactly, and the converted
    model's logits against HF's."""
    model = write_tiny_llama(tmp_path, tie, safe)
    params, cfg = t_llama.convert_llama_checkpoint(str(tmp_path), device="cpu")
    jparams, jcfg = j_llama.convert_llama_checkpoint(str(tmp_path))
    assert cfg.ff_kind == "swiglu" and (cfg.heads, cfg.kv_heads, cfg.dim_head) == (4, 2, 8)
    assert {f.name: getattr(cfg, f.name) for f in cfg.__dataclass_fields__.values()
            if f.name != "nsa"} == {f.name: getattr(jcfg, f.name)
                                    for f in jcfg.__dataclass_fields__.values() if f.name != "nsa"}
    want = {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    got = {k: v.numpy() for k, v in tree_items(params)}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    ids = np.random.RandomState(0).randint(0, 64, (2, 17))
    with torch.no_grad():
        ref = model(torch.from_numpy(ids)).logits.float().numpy()
        ours = tt.transformer_forward(params, cfg, torch.from_numpy(ids))
    np.testing.assert_allclose(ours.numpy(), ref, **HF_TOL)


def test_safetensors_writer_and_reader(tmp_path):
    """``write_safetensors`` / ``read_safetensors`` round trip in F32, F16
    and BF16, and the writer's file as the ``safetensors`` package reads
    it."""
    g = torch.Generator().manual_seed(0)
    tensors = {"a": torch.randn(3, 5, generator=g), "b.w": torch.randn(7, generator=g).half(),
               "c": torch.randn(2, 2, 4, generator=g).bfloat16(), "e": torch.zeros(0, 3)}
    path = t_llama.write_safetensors(str(tmp_path / "x.safetensors"), tensors)
    back = t_llama.read_safetensors(path)
    assert back.keys() == tensors.keys()
    for k, v in tensors.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k
    st = pytest.importorskip("safetensors.torch")
    for k, v in st.load_file(path).items():
        assert torch.equal(v, tensors[k]), k


def test_finetune_cs441_main_on_the_cpu(tmp_path, monkeypatch, models):
    teacher, _ = port(models)
    save_checkpoint(str(tmp_path / "teacher"), 3, teacher, model_cfg=t_tiny(**CFG_T))
    monkeypatch.chdir(tmp_path)
    summary = finetune_cs441.main([
        "--teacher-ckpt", str(tmp_path / "teacher"), "--steps", "2", "--batch-size", "2",
        "--seq-len", "32", "--gen-len", "3", "--max-samples", "2", "--device", "cpu",
        "--out", str(tmp_path / "out.json")])
    assert summary["num_samples"] == 2 and summary["steps"] == 2
    with open(tmp_path / "out.json") as f:
        result = json.load(f)
    assert result["accuracy"] == summary["adapted_accuracy"]
    assert len(result["results"]) == 2 and "base_pred" in result["results"][0]


def test_entry_point_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        finetune_cs441.main(["--teacher-ckpt", "unused"])
