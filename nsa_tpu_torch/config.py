"""Typed configuration for the PyTorch port.

A copy of the model, NSA, training and data dataclasses of
``nsa_tpu/config.py``: the port
imports nothing from ``nsa_tpu``, so that it runs where JAX is not
installed.  Field names, defaults and validation are the JAX package's, so
one JSON ``model_config`` (as written into ``ckpt_export/*.npz``) builds
the same configuration in both packages.

``attn_impl``, ``scan_layers`` and the decode tile fields are carried for
JSON compatibility only; the port has one implementation per function.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class NSAConfig:
    """Native Sparse Attention hyperparameters."""

    sliding_window_size: int = 64
    compress_block_size: int = 16
    compress_block_sliding_stride: int = 8
    selection_block_size: int = 16
    num_selected_blocks: int = 4
    num_compressed_mem_kv: int = 1
    # 'mlp' (GroupedMLP), 'conv', 'attn', 'mean', 'shared_mlp', 'single' or
    # 'transformer'; see ops/compress.py
    compressor: str = "mlp"
    compress_mlp_expand_factor: float = 1.0
    use_diff_topk: bool = True
    query_heads_share_selected_kv: bool = True

    def __post_init__(self):
        if self.compress_block_size < self.compress_block_sliding_stride:
            raise ValueError("compress_block_size must be >= stride")
        if self.compress_block_sliding_stride <= 0:
            raise ValueError("compress_block_sliding_stride must be > 0")
        if self.selection_block_size % self.compress_block_sliding_stride:
            raise ValueError(
                "selection_block_size must be divisible by "
                "compress_block_sliding_stride"
            )
        if self.num_compressed_mem_kv <= 0:
            raise ValueError("num_compressed_mem_kv must be > 0")
        if self.num_selected_blocks < 0:
            raise ValueError("num_selected_blocks must be >= 0")

    @property
    def compress_overlap_len(self) -> int:
        return self.compress_block_size - self.compress_block_sliding_stride

    @property
    def num_compress_per_fine(self) -> int:
        return self.selection_block_size // self.compress_block_sliding_stride


@dataclass(frozen=True)
class ModelConfig:
    """Byte-level GPT model configuration."""

    vocab_size: int = 256
    dim: int = 512
    depth: int = 6
    dim_head: int = 64
    heads: int = 8
    kv_heads: int = 4
    ff_expansion_factor: float = 4.0
    # the port implements only 'gelu' (Linear-GELU-Linear with bias)
    ff_kind: str = "gelu"
    causal: bool = True
    use_sparse_attn: bool = True
    nsa: NSAConfig = field(default_factory=NSAConfig)
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    # activation dtype: 'float32' or 'bfloat16'
    dtype: str = "float32"
    attn_impl: str = "xla"
    # query-chunk size of the compressed-attention + selection step
    attn_chunk_size: int = 128
    scan_layers: bool = True
    decode_select_tile: int = 32
    decode_attend_tile: int = 64

    def __post_init__(self):
        if self.heads % max(self.kv_heads, 1):
            raise ValueError("heads must be divisible by kv_heads")

    @property
    def num_grouped_queries(self) -> int:
        return self.heads // self.kv_heads

    @property
    def dim_inner(self) -> int:
        return self.heads * self.dim_head

    @property
    def dim_kv_inner(self) -> int:
        return self.kv_heads * self.dim_head

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class TrainConfig:
    """Pretraining loop configuration (``nsa_tpu/config.py``'s, same fields
    and defaults)."""

    num_batches: int = 5000
    batch_size: int = 16
    grad_accum_every: int = 4
    learning_rate: float = 1e-4
    grad_clip_norm: float = 0.5
    seq_len: int = 4096
    # the loss is read back to the host (a device sync) only every
    # log_every steps; early stopping is checked at the same cadence
    log_every: int = 20
    validate_every: int = 100
    generate_every: int = 500
    generate_length: int = 512
    prime_length: int = 64
    early_stop_loss: float = 0.2
    ckpt_every: int = 2500
    ckpt_dir: str = "./ckpt"
    seed: int = 0
    log_csv: Optional[str] = None


@dataclass(frozen=True)
class DataConfig:
    """enwik8-style byte corpus configuration (``nsa_tpu/config.py``'s)."""

    path: str = "data/enwik8.gz"
    num_bytes: int = 95_000_000
    train_bytes: int = 90_000_000
    # without the corpus file, fall back to a deterministic synthetic byte
    # corpus so that the pipeline stays runnable end to end
    allow_synthetic_fallback: bool = True
    synthetic_bytes: int = 32_000_000


@dataclass(frozen=True)
class MeshConfig:
    """The (data, heads) mesh's shape (``nsa_tpu/config.py``'s): data
    parallelism over ``data`` ranks and tensor parallelism over KV heads on
    ``heads`` ranks (``parallel/mesh.py``).  NSA selection is per KV head,
    so a ``heads`` axis keeps every block-index gather local to a rank."""

    data: int = 1
    heads: int = 1

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.data, self.heads)


def config_to_json(cfg) -> str:
    """Serialize a config dataclass (with nesting) to JSON."""
    return json.dumps(dataclasses.asdict(cfg), indent=2, sort_keys=True)


def model_config_from_json(text: str) -> ModelConfig:
    raw = json.loads(text)
    nsa_raw = raw.pop("nsa", {})
    return ModelConfig(nsa=NSAConfig(**nsa_raw), **raw)


def reference_model_config(
    compressor: str = "mlp",
    use_sparse_attn: bool = True,
    **overrides,
) -> ModelConfig:
    """The reference model: 6 layers, dim 512, 8 heads / 4 KV heads."""
    return ModelConfig(
        vocab_size=256,
        dim=512,
        depth=6,
        dim_head=64,
        heads=8,
        kv_heads=4,
        use_sparse_attn=use_sparse_attn,
        nsa=NSAConfig(
            sliding_window_size=64,
            compress_block_size=16,
            compress_block_sliding_stride=8,
            selection_block_size=16,
            num_selected_blocks=4,
            compressor=compressor,
            use_diff_topk=True,
            query_heads_share_selected_kv=True,
        ),
        **overrides,
    )


def tiny_test_config(**overrides) -> ModelConfig:
    """Small config for fast unit tests."""
    kw = dict(
        vocab_size=256,
        dim=64,
        depth=2,
        dim_head=16,
        heads=4,
        kv_heads=2,
        use_sparse_attn=True,
        nsa=NSAConfig(
            sliding_window_size=8,
            compress_block_size=4,
            compress_block_sliding_stride=2,
            selection_block_size=4,
            num_selected_blocks=2,
            compressor="mlp",
        ),
    )
    kw.update(overrides)
    return ModelConfig(**kw)
