"""HF Llama checkpoint -> the port's params (``nsa_tpu/models/llama_import.py``).

Offline only: point ``convert_llama_checkpoint`` at a local
``LlamaForCausalLM`` checkpoint directory (``config.json`` and
``*.safetensors`` or ``pytorch_model*.bin``); it returns (params,
ModelConfig) in the full-attention layout with the swiglu FF, ready to be
the frozen teacher of ``models/adapter.py``.

Layout mapping (HF -> ours), as JAX's:
  model.embed_tokens.weight            -> token_emb            [V, D]
  layers.i.input_layernorm.weight      -> layers[i].attn.norm_scale
  layers.i.self_attn.{q,k,v}_proj      -> layers[i].attn.w_{q,k,v}  (transposed)
  layers.i.self_attn.o_proj            -> layers[i].attn.w_out     (transposed)
  layers.i.post_attention_layernorm    -> layers[i].ff.norm_scale
  layers.i.mlp.{gate,up,down}_proj     -> layers[i].ff (w1=gate, w3=up, w2=down)
  model.norm.weight                    -> norm_scale
  lm_head.weight                       -> to_logits (transposed; the
                                          embedding's when tied)

``.safetensors`` files are read by ``read_safetensors``, a reader of the
format's own (an 8-byte little-endian header length, a JSON header, the raw
little-endian buffers), since the machine with the card has no
``safetensors`` package; ``write_safetensors`` writes the same format.
Like JAX's converter this one ignores ``rope_scaling``: Llama-3's scaled
long-context frequencies are not applied (ROADMAP.md section 3).
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Tuple

import numpy as np
import torch

from ..config import ModelConfig
from ..utils.checkpoint import tree_to

# the format's names of the dtypes a checkpoint's weights come in
SAFETENSORS_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of one ``.safetensors`` file, on the CPU in its stored
    dtype."""
    with open(path, "rb") as f:
        data = f.read()
    (header_len,) = struct.unpack("<Q", data[:8])
    header = json.loads(data[8:8 + header_len])
    start = 8 + header_len
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = SAFETENSORS_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, which this reader "
                             f"does not take ({sorted(SAFETENSORS_DTYPES)})")
        begin, end = info["data_offsets"]
        count = (end - begin) // torch.tensor([], dtype=dtype).element_size()
        flat = torch.frombuffer(bytearray(data[start + begin:start + end]), dtype=dtype,
                                count=count) if count else torch.empty(0, dtype=dtype)
        out[name] = flat.reshape(info["shape"])
    return out


def write_safetensors(path: str, tensors: Dict[str, torch.Tensor]) -> str:
    """Write ``tensors`` as one ``.safetensors`` file (the layout
    ``read_safetensors`` and HF's loaders read); returns ``path``."""
    names = {v: k for k, v in SAFETENSORS_DTYPES.items()}
    header, blobs, offset = {}, [], 0
    for name, t in tensors.items():
        raw = t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    text = json.dumps(header).encode()
    text += b" " * (-len(text) % 8)           # the buffers start 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for raw in blobs:
            f.write(raw)
    return path


def _load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A local HF checkpoint's tensors (safetensors preferred), as float32
    on the CPU."""
    files = sorted(os.listdir(path))
    st_files = [f for f in files if f.endswith(".safetensors")]
    sd: Dict[str, torch.Tensor] = {}
    if st_files:
        for f in st_files:
            sd.update(read_safetensors(os.path.join(path, f)))
    else:
        bin_files = [f for f in files if f.endswith(".bin")]
        if not bin_files:
            raise FileNotFoundError(f"no safetensors/bin weights under {path}")
        for f in bin_files:
            sd.update(torch.load(os.path.join(path, f), map_location="cpu", weights_only=True))
    return {k: v.float() for k, v in sd.items()}


def _half_split_to_interleaved(w: torch.Tensor, num_heads: int, dim_head: int) -> torch.Tensor:
    """Permute q/k projection columns from HF's half-split RoPE layout to
    the interleaved pairs of ``ops/rotary.py``: column 2j <- j and 2j+1 <- j
    + d/2 per head, so the port's rotary turns exactly the pairs HF's
    ``rotate_half`` turns (q and k permute together, so q.k is unchanged)."""
    d = dim_head
    perm = np.empty(d, np.int64)
    perm[0::2] = np.arange(d // 2)
    perm[1::2] = np.arange(d // 2) + d // 2
    w = w.reshape(w.shape[0], num_heads, d)[:, :, torch.from_numpy(perm)]
    return w.reshape(w.shape[0], num_heads * d)


def convert_llama_checkpoint(path: str, device="cuda",
                             dtype: torch.dtype = torch.float32) -> Tuple[Dict, ModelConfig]:
    """Convert a local HF Llama checkpoint directory to (params, config),
    the leaves in ``dtype`` (float32, as JAX's) on ``device``."""
    with open(os.path.join(path, "config.json")) as f:
        hf = json.load(f)
    cfg = ModelConfig(
        vocab_size=hf["vocab_size"],
        dim=hf["hidden_size"],
        depth=hf["num_hidden_layers"],
        dim_head=hf["hidden_size"] // hf["num_attention_heads"],
        heads=hf["num_attention_heads"],
        kv_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
        ff_expansion_factor=hf["intermediate_size"] / hf["hidden_size"],
        use_sparse_attn=False,
        rope_theta=float(hf.get("rope_theta", 10000.0)),
        norm_eps=float(hf.get("rms_norm_eps", 1e-5)),
        ff_kind="swiglu",
    )
    sd = _load_state_dict(path)

    def t(name):
        return sd[name]

    layers = []
    for i in range(cfg.depth):
        p = f"model.layers.{i}."
        layers.append({
            "attn": {
                "norm_scale": t(p + "input_layernorm.weight"),
                "w_q": _half_split_to_interleaved(t(p + "self_attn.q_proj.weight").T,
                                                  cfg.heads, cfg.dim_head),
                "w_k": _half_split_to_interleaved(t(p + "self_attn.k_proj.weight").T,
                                                  cfg.kv_heads, cfg.dim_head),
                "w_v": t(p + "self_attn.v_proj.weight").T,
                "w_out": t(p + "self_attn.o_proj.weight").T,
            },
            "ff": {
                "norm_scale": t(p + "post_attention_layernorm.weight"),
                "w1": t(p + "mlp.gate_proj.weight").T,
                "w3": t(p + "mlp.up_proj.weight").T,
                "w2": t(p + "mlp.down_proj.weight").T,
            },
        })
    head = sd.get("lm_head.weight", sd["model.embed_tokens.weight"])    # tied embeddings
    params = {
        "token_emb": t("model.embed_tokens.weight"),
        "layers": layers,
        "norm_scale": t("model.norm.weight"),
        "to_logits": head.T,
    }
    return tree_to(params, device, dtype), cfg
