"""Sparse-attention adapters and distillation (``nsa_tpu/models/adapter.py``).

* ``init_adapter_from_attention`` - one NSA layer whose q/k/v/out
  projections start as a frozen teacher attention layer's, its own input
  norm neutral (ones): the host model's norm is applied before it;
* ``adapted_forward`` - the frozen base with trainable NSA adapters in
  place of each attention block; the frozen FF's whole output is detached
  (``x + stop_gradient(ff(x))``), so no gradient flows through the FF into
  ``x``, and only the adapters receive gradients;
* ``distillation_loss`` - 'kl_output_only' / 'kl_logits' / 'mse_hidden' /
  'mixed' / 'ce', with temperature scaling, logits clamped at +-30, the
  label-masked KL, and layerwise MSE over scale-free layer-normed hiddens;
* ``verify_gradient_flow`` - the adapters get gradients and the frozen
  base none.

The teacher is any full-attention model of the port: the committed
byte-GPT (``ckpt_export/full_attn_seq4096.npz``) or an HF Llama converted
by ``models/llama_import.py``.  Its forward runs without autograd, through
the flash kernel (row 13) on the card; the adapters' forward and backward
through the prefill kernels (rows 1, 4, 5).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..ops.common import rms_norm
from ..ops.nsa import init_sparse_attention, sparse_attention_forward
from ..train.pretrain import trainable
from ..utils.checkpoint import _detached, tree_leaves, tree_to
from .transformer import _compute_dtype, _ff_apply, _full_attn_forward, transformer_forward

MODES = ("kl_output_only", "kl_logits", "mse_hidden", "mixed", "ce")


def init_adapter_from_attention(generator: torch.Generator, cfg: ModelConfig,
                                attn_params: Dict) -> Dict:
    """An NSA adapter whose w_q / w_k / w_v / w_out are float32 copies of
    the teacher layer's, the rest a random init from ``generator`` (on the
    CPU), its ``norm_scale`` ones; on the teacher's device."""
    adapter = init_sparse_attention(cfg, generator, "cpu")
    for name in ("w_q", "w_k", "w_v", "w_out"):
        if name in attn_params:
            adapter[name] = attn_params[name].detach().to("cpu", torch.float32, copy=True)
    adapter["norm_scale"] = torch.ones_like(adapter["norm_scale"])
    return tree_to(adapter, attn_params["w_q"].device)


def init_adapters(generator: torch.Generator, cfg: ModelConfig, teacher_params: Dict):
    """One adapter per teacher layer, drawn from ``generator`` in turn (JAX
    splits its key per layer; the numbers differ)."""
    return [init_adapter_from_attention(generator, cfg, layer["attn"])
            for layer in teacher_params["layers"]]


def adapted_forward(adapters, teacher_params: Dict, cfg: ModelConfig, ids: torch.Tensor, *,
                    output_hidden_states: bool = False, use_kernels: bool = True):
    """Frozen base + trainable NSA adapters -> float32 logits [b, n, vocab]
    (and the hidden states, embeddings first).  Each layer: the host's
    input norm (the teacher's ``norm_scale``), the adapter (which norms
    again with its ones), the residual; then the frozen FF, detached.
    ``use_kernels`` as in ``sparse_attention_forward``."""
    dtype = _compute_dtype(cfg)
    frozen = _detached(teacher_params)
    x = frozen["token_emb"][ids].to(dtype)
    hiddens = [x]
    for adapter, layer in zip(adapters, frozen["layers"]):
        normed_in = rms_norm(x, layer["attn"]["norm_scale"], cfg.norm_eps)
        x = x + sparse_attention_forward(adapter, cfg, normed_in, use_kernels=use_kernels)
        with torch.no_grad():           # stop_gradient on the whole FF term
            ff = _ff_apply(layer["ff"], cfg, x)
        x = x + ff
        hiddens.append(x)
    x = rms_norm(x, frozen["norm_scale"], cfg.norm_eps)
    logits = (x @ frozen["to_logits"].to(dtype)).float()
    if output_hidden_states:
        return logits, hiddens
    return logits


def _masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return x.mean()
    m = mask.to(x.dtype)
    return (x * m).sum() / torch.clamp(m.sum(), min=1.0)


def _scale_free_norm(h: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm without an affine: the biased variance, as ``jnp.var``."""
    mu = h.mean(-1, keepdim=True)
    var = h.var(-1, keepdim=True, unbiased=False)
    return (h - mu) * torch.rsqrt(var + eps)


def distillation_loss(
    student_logits: torch.Tensor,
    teacher_logits: torch.Tensor,
    mode: str = "kl_output_only",
    labels: Optional[torch.Tensor] = None,
    label_mask: Optional[torch.Tensor] = None,
    student_hiddens=None,
    teacher_hiddens=None,
    temperature: float = 2.0,
    logit_clamp: float = 30.0,
    mix_alpha: float = 0.5,
) -> torch.Tensor:
    """Teacher/student losses (``nsa_tpu.models.adapter.distillation_loss``):
    'kl_output_only' and 'kl_logits' (the KL of the tempered softmaxes
    times temperature squared), 'mse_hidden' (layerwise MSE over
    scale-free-normed hiddens), 'mixed' (alpha KL + (1 - alpha) MSE), 'ce'
    (cross-entropy of the unclamped student logits on ``labels``).  The
    teacher's logits and hiddens are detached."""
    sl = torch.clamp(student_logits, -logit_clamp, logit_clamp)
    tl = torch.clamp(teacher_logits.detach(), -logit_clamp, logit_clamp)

    def kl():
        t = max(temperature, 1e-4)
        logp_s = F.log_softmax(sl / t, dim=-1)
        p_t = F.softmax(tl / t, dim=-1)
        kl_tok = (p_t * (torch.log(torch.clamp(p_t, min=1e-9)) - logp_s)).sum(-1)
        return _masked_mean(kl_tok, label_mask) * (t * t)

    def hidden_mse():
        if student_hiddens is None or teacher_hiddens is None:
            raise ValueError(f"mode {mode!r} needs the student's and the teacher's hiddens")
        losses = [((_scale_free_norm(hs) - _scale_free_norm(ht.detach())) ** 2).mean()
                  for hs, ht in zip(student_hiddens, teacher_hiddens)]
        return torch.stack(losses).mean()

    def ce():
        if labels is None:
            raise ValueError("mode 'ce' needs labels")
        logp = F.log_softmax(student_logits, dim=-1)
        nll = -logp.gather(-1, labels[..., None].long())[..., 0]
        return _masked_mean(nll, label_mask)

    if mode in ("kl_output_only", "kl_logits"):
        return kl()
    if mode == "mse_hidden":
        return hidden_mse()
    if mode == "mixed":
        return mix_alpha * kl() + (1.0 - mix_alpha) * hidden_mse()
    if mode == "ce":
        return ce()
    raise ValueError(f"unknown distillation mode '{mode}'")


def distillation_step_loss(adapters, teacher_params, cfg_student: ModelConfig,
                           cfg_teacher: ModelConfig, ids: torch.Tensor,
                           label_mask: Optional[torch.Tensor] = None,
                           mode: str = "kl_output_only", *, use_kernels: bool = True,
                           **loss_kw) -> torch.Tensor:
    """One distillation forward: the frozen base as the teacher (without
    autograd: the flash kernel on the card) and the adapted student.  As in
    JAX the 'ce' mode's labels are ``ids`` themselves."""
    need_hiddens = mode in ("mse_hidden", "mixed")
    with torch.no_grad():
        teacher_logits = transformer_forward(teacher_params, cfg_teacher, ids,
                                             use_kernels=use_kernels)
        t_h = _teacher_hiddens(teacher_params, cfg_teacher, ids, use_kernels) \
            if need_hiddens else None
    if need_hiddens:
        student_logits, s_h = adapted_forward(adapters, teacher_params, cfg_student, ids,
                                              output_hidden_states=True,
                                              use_kernels=use_kernels)
    else:
        student_logits = adapted_forward(adapters, teacher_params, cfg_student, ids,
                                         use_kernels=use_kernels)
        s_h = None
    return distillation_loss(student_logits, teacher_logits, mode=mode, labels=ids,
                             label_mask=label_mask, student_hiddens=s_h, teacher_hiddens=t_h,
                             **loss_kw)


def _teacher_hiddens(params, cfg: ModelConfig, ids, use_kernels: bool = True):
    """The teacher's residual stream after the embedding and each layer."""
    x = params["token_emb"][ids].to(_compute_dtype(cfg))
    hiddens = [x]
    for layer in params["layers"]:
        x = x + _full_attn_forward(layer["attn"], cfg, x, use_kernels=use_kernels)
        x = x + _ff_apply(layer["ff"], cfg, x)
        hiddens.append(x)
    return hiddens


def verify_gradient_flow(adapters, teacher_params, cfg_student, cfg_teacher,
                         ids) -> Tuple[bool, dict]:
    """The adapters must receive gradients and the frozen base none: the
    'kl_output_only' loss differentiated with respect to float32 copies of
    both that require grad; a leaf the loss does not reach counts as
    zero."""
    ad, tp = trainable(adapters), trainable(teacher_params)
    loss = distillation_step_loss(ad, tp, cfg_student, cfg_teacher, ids, mode="kl_output_only")
    ad_leaves = [tree_leaves(a) for a in ad]
    tp_leaves = tree_leaves(tp)
    flat = [leaf for leaves in ad_leaves for leaf in leaves] + tp_leaves
    grads = torch.autograd.grad(loss, flat, allow_unused=True)

    def norm(gs):
        return float(sum((g.float() ** 2).sum() for g in gs if g is not None) ** 0.5)

    ad_norms, i = [], 0
    for leaves in ad_leaves:
        ad_norms.append(norm(grads[i:i + len(leaves)]))
        i += len(leaves)
    tp_norm = norm(grads[i:])
    ok = all(n > 0 for n in ad_norms) and tp_norm == 0.0
    return ok, {"adapter_grad_norms": ad_norms, "teacher_grad_norm": tp_norm}
