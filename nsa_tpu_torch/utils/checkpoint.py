"""Weights for the port: training checkpoints, the committed ``.npz``
exports and JAX trees.

Training checkpoints keep ``nsa_tpu/utils/checkpoint.py``'s layout:
``<dir>/step_XXXXXXXX/`` with one file per item (``params.pt``,
``opt_state.pt``, written with ``torch.save``; the JAX package writes Orbax
trees there) and ``meta.json`` written last and atomically as the completion
marker, so a directory without it is a partial save that
``latest_checkpoint`` skips.

``ckpt_export/*.npz`` (written by ``nsa_tpu.utils.checkpoint.
export_params_npz``) stores each parameter under its JAX tree path, for
example ``['layers'][0]['attn']['w_q']``; bfloat16 leaves are stored as
their ``uint16`` bit patterns, and a ``__meta__`` entry holds JSON with the
per-leaf dtypes, the step and the ``model_config``.  The port reads it with
numpy alone and keeps the JAX layout: a dict with ``token_emb``,
``norm_scale``, ``to_logits`` and a list ``layers`` of ``{"attn", "ff"}``
dicts, every leaf a tensor of the JAX shape.  Every compressor's tree
carries across: the ``transformer`` kind's list of ``layers`` as a list,
the ``mean`` kind as an empty dict.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import ModelConfig, config_to_json, model_config_from_json

_KEY_PART = re.compile(r"\[(?:'([^']*)'|(\d+))\]")


def _to_tensor(x: np.ndarray, bf16_bits: bool, device, dtype) -> torch.Tensor:
    x = np.ascontiguousarray(x)
    if not x.flags.writeable:       # e.g. a JAX array seen through np.asarray
        x = x.copy()
    t = torch.from_numpy(x.view(np.int16)).view(torch.bfloat16) if bf16_bits else torch.from_numpy(x)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def _lists_from_int_keys(node):
    """Turn dicts keyed 0..n-1 (list positions in a tree path) into lists."""
    if not isinstance(node, dict):
        return node
    node = {k: _lists_from_int_keys(v) for k, v in node.items()}
    if node and all(isinstance(k, int) for k in node):
        return [node[i] for i in range(len(node))]
    return node


def _insert(tree: dict, key: str, leaf) -> None:
    if not key or _KEY_PART.sub("", key):
        raise ValueError(f"unrecognised tree path {key!r}")
    parts = [s if i == "" else int(i) for s, i in _KEY_PART.findall(key)]
    node = tree
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = leaf


def load_params_npz(
    path: str, device="cuda", dtype: Optional[torch.dtype] = None
) -> Tuple[dict, dict]:
    """Read an ``export_params_npz`` file into the port's params.

    Returns ``(params, meta)``.  Leaves keep their stored dtype unless
    ``dtype`` is given, which casts every floating leaf.
    """
    with np.load(os.path.abspath(path)) as data:
        meta = json.loads(bytes(data["__meta__"]).decode("utf-8"))
        dtypes = meta.get("dtypes", {})
        tree: dict = {}
        for key in data.files:
            if key == "__meta__":
                continue
            leaf = _to_tensor(
                data[key], dtypes.get(key) == "bfloat16", device, dtype
            )
            _insert(tree, key, leaf)
    return _with_empty_compressors(_lists_from_int_keys(tree), meta), meta


def _with_empty_compressors(params: dict, meta: dict) -> dict:
    """The ``mean`` compressor has no parameters, so an export holds no path
    under its ``k_compress`` / ``v_compress``: put their empty dicts back,
    as the JAX package's params template has them."""
    cfg = meta.get("model_config") or {}
    if cfg.get("use_sparse_attn", True) and cfg.get("nsa", {}).get("compressor") == "mean":
        for layer in params.get("layers", []):
            for name in ("k_compress", "v_compress"):
                layer["attn"].setdefault(name, {})
    return params


def model_config_from_meta(meta: dict) -> ModelConfig:
    """The ``ModelConfig`` recorded in an export's ``__meta__``."""
    return model_config_from_json(json.dumps(meta["model_config"]))


def model_config_from_checkpoint(path: str) -> ModelConfig:
    """The ``ModelConfig`` recorded in a checkpoint's ``meta.json``."""
    with open(os.path.join(path, "meta.json")) as f:
        return model_config_from_meta(json.load(f))


def params_from_numpy(
    tree: Any, device="cuda", dtype: Optional[torch.dtype] = None
) -> Any:
    """Carry a params tree of numpy arrays (a JAX tree passed through
    ``np.asarray``) across into tensors, keeping its dict/list layout: a
    model's, the swiglu FF's ``w1`` / ``w3`` / ``w2`` among its leaves, or a
    list of adapters (``models/adapter.py``).

    bfloat16 arrays (an extension dtype that JAX registers with numpy) are
    reinterpreted through their bits, so this module needs no such package.
    """
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device, dtype) for v in tree]
    x = np.asarray(tree)
    return _to_tensor(x, x.dtype.name == "bfloat16", device, dtype)


def tree_to(tree: Any, device=None, dtype: Optional[torch.dtype] = None) -> Any:
    """Move a params tree (dicts and lists of tensors) to ``device`` and cast
    its floating leaves to ``dtype``; None keeps each as it is."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to(v, device, dtype) for v in tree]
    return tree.to(device=device, dtype=dtype if tree.is_floating_point() else None)


def tree_leaves(tree: Any) -> list:
    """The tensors of a params tree in a fixed order (dicts in insertion
    order, lists by position)."""
    return [leaf for _, leaf in tree_items(tree)]


def tree_items(tree: Any, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(JAX tree path, leaf) pairs, the path as ``jax.tree_util.keystr``
    writes it, for example ``['layers'][0]['attn']['w_q']``."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_items(v, f"{prefix}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_items(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def _detached(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_detached(v) for v in tree]
    return tree.detach()


def save_checkpoint(
    directory: str,
    step: int,
    params: Any,
    opt_state: Optional[dict] = None,
    model_cfg: Optional[ModelConfig] = None,
    extra: Optional[dict] = None,
) -> str:
    """Save params (and an optimizer ``state_dict``) as
    ``<directory>/step_XXXXXXXX``; returns that path."""
    path = os.path.join(os.path.abspath(directory), f"step_{step:08d}")
    os.makedirs(path, exist_ok=True)
    items = {"params": _detached(params)}
    if opt_state is not None:
        items["opt_state"] = opt_state
    for name, item in items.items():
        tmp = os.path.join(path, f"{name}.pt.tmp")
        torch.save(item, tmp)
        os.replace(tmp, os.path.join(path, f"{name}.pt"))
    meta = {"step": step, **(extra or {})}
    if model_cfg is not None:
        meta["model_config"] = json.loads(config_to_json(model_cfg))
    tmp = os.path.join(path, "meta.json.tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f, indent=2)
    os.replace(tmp, os.path.join(path, "meta.json"))
    return path


def latest_checkpoint(directory: str) -> Optional[str]:
    """The newest complete ``step_*`` checkpoint under ``directory``."""
    directory = os.path.abspath(directory)
    if not os.path.isdir(directory):
        return None
    steps = sorted(
        d for d in os.listdir(directory)
        if d.startswith("step_")
        and os.path.isfile(os.path.join(directory, d, "meta.json"))
    )
    return os.path.join(directory, steps[-1]) if steps else None


def restore_checkpoint(
    path: str, names: Sequence[str] = ("params", "opt_state"), device="cuda"
) -> Tuple[dict, dict]:
    """Restore the named items of a checkpoint onto ``device``; returns
    ``(state, meta)`` with ``state[name]`` as saved."""
    path = os.path.abspath(path)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    state = {
        name: torch.load(os.path.join(path, f"{name}.pt"), map_location=device,
                         weights_only=True)
        for name in names
    }
    return state, meta


def load_params(path: str, device="cuda",
                dtype: Optional[torch.dtype] = None) -> Tuple[dict, ModelConfig, dict]:
    """(params, cfg, meta) from an exported ``.npz`` (``load_params_npz``)
    or a training checkpoint: one ``step_*`` directory or a run directory,
    whose newest is read.  ``dtype`` casts every floating leaf."""
    if path.endswith(".npz"):
        params, meta = load_params_npz(path, device=device, dtype=dtype)
        return params, model_config_from_meta(meta), meta
    if not os.path.isfile(os.path.join(path, "meta.json")):
        path = latest_checkpoint(path) or path
    state, meta = restore_checkpoint(path, ("params",), device)
    return tree_to(state["params"], device, dtype), model_config_from_meta(meta), meta


def export_params_npz(
    path: str,
    params: Any,
    model_cfg: Optional[ModelConfig] = None,
    extra: Optional[dict] = None,
) -> str:
    """Write params to one ``.npz`` in ``nsa_tpu``'s export format: each
    leaf under its JAX tree path, bfloat16 leaves as their ``uint16`` bit
    patterns, a ``__meta__`` JSON entry with the per-leaf dtypes (and the
    model config); ``nsa_tpu.utils.checkpoint.import_params_npz`` and
    ``load_params_npz`` read it."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays, dtypes = {}, {}
    for key, leaf in tree_items(params):
        leaf = leaf.detach().cpu()
        dtypes[key] = str(leaf.dtype).removeprefix("torch.")
        if leaf.dtype == torch.bfloat16:
            arrays[key] = leaf.view(torch.int16).numpy().view(np.uint16)
        else:
            arrays[key] = leaf.numpy()
    meta = {"dtypes": dtypes, **(extra or {})}
    if model_cfg is not None:
        meta["model_config"] = json.loads(config_to_json(model_cfg))
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)
    return path
