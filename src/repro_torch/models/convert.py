"""Weights and caches carried across from the reference (``repro.models``):
its parameter and cache trees, as nested dicts of numpy arrays with every
block leaf stacked on the repeat axis, to the port's ``Transformer`` and
per-layer caches, and back (``params_to_reference`` also lays out any
per-parameter values, such as gradients, as the reference's tree).

The reference's init cannot be reproduced in torch (``jax.random`` bits,
and a key folded from ``hash(path)``), so parity checks take the
reference's initialized parameters through here. Leaf names are the
same on both sides; layer ``r * len(pattern) + i`` of the port is repeat
r of the reference's ``blocks/p{i}``, and the reference's caches hold K
and V as (R, B, T, KV, hd) where the port's layers hold (B, KV, T, hd).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.config import DEFAULT_POLICY, KernelPolicy, resolve_device

from .config import ModelConfig
from .layers import Initializer, dtype_of
from .transformer import Cache, Transformer

__all__ = ["reference_path", "params_from_reference", "params_to_reference",
           "cache_from_reference", "cache_to_reference"]

_KV_KEYS = ("k", "v", "ck", "cv")


def _tensor(a, dtype=None, device=None) -> torch.Tensor:
    """A numpy (or array-like) leaf as a tensor of its own."""
    return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)


def _load(module: nn.Module, tree: Dict, index=None, loaded=None,
          prefix: str = "") -> None:
    """Copy ``tree``'s leaves (row ``index`` of each, when stacked) into the
    parameters of the same path under ``module``."""
    for key, node in tree.items():
        if isinstance(node, dict):
            _load(getattr(module, key), node, index, loaded,
                  f"{prefix}{key}.")
            continue
        param = getattr(module, key)
        value = np.asarray(node)
        if index is not None:
            value = value[index]
        if tuple(value.shape) != tuple(param.shape):
            raise ValueError(f"{prefix}{key}: reference {value.shape}, port "
                             f"{tuple(param.shape)}")
        with torch.no_grad():
            param.copy_(_tensor(value, param.dtype, param.device))
        loaded.add(id(param))


def params_from_reference(tree: Dict, cfg: ModelConfig, device=None,
                          policy: KernelPolicy = DEFAULT_POLICY
                          ) -> Transformer:
    """A ``Transformer`` holding the reference's parameters ``tree`` (its
    ``init_model`` output through ``numpy``), on ``device`` (the card by
    default). Raises if a leaf is missing, extra, or of another shape."""
    device = resolve_device(device)
    model = Transformer(cfg, Initializer(None, dtype_of(cfg.param_dtype)),
                        policy)
    loaded = set()
    P = len(cfg.pattern)
    for key, node in tree.items():
        if key == "blocks":
            for r in range(cfg.repeats):
                for i in range(P):
                    _load(model.blocks[r * P + i], node[f"p{i}"], r, loaded,
                          f"blocks/p{i}~{r}/")
        elif key == "encoder":
            for r, bp in enumerate(model.encoder.blocks):
                _load(bp, node["blocks"]["p0"], r, loaded, f"enc/p0~{r}/")
            _load(model.encoder.final_norm, node["final_norm"], None, loaded,
                  "enc/final_norm/")
        elif isinstance(node, dict):
            _load(getattr(model, key), node, None, loaded, f"{key}/")
        else:
            _load(model, {key: node}, None, loaded)
    missing = [n for n, p in model.named_parameters() if id(p) not in loaded]
    if missing:
        raise ValueError(f"params_from_reference: no reference leaf for "
                         f"{missing}")
    return model.to(device)


def reference_path(name: str, pattern_len: int,
                   stacked_keys=("blocks",)) -> Tuple[Tuple[str, ...], bool]:
    """The port's parameter ``name`` ("blocks.7.attn.wq") as the path of
    its leaf in the reference's tree (("blocks", "p1", "attn", "wq") for a
    pattern of 2: layer ``r * pattern_len + i`` is repeat r of ``p{i}``;
    the encoder's layers are repeats of ``encoder/blocks/p0``), and whether
    that leaf is stacked on the repeat axis (a key of ``stacked_keys`` on
    its path, as the reference's ``param_specs`` reads it)."""
    parts = name.split(".")
    if parts[0] == "blocks":
        i = int(parts[1]) % pattern_len
        path = ("blocks", f"p{i}", *parts[2:])
    elif parts[:2] == ["encoder", "blocks"]:
        path = ("encoder", "blocks", "p0", *parts[3:])
    else:
        path = tuple(parts)
    return path, any(k in stacked_keys for k in path)


def params_to_reference(model: Transformer,
                        values: Optional[Dict[str, torch.Tensor]] = None
                        ) -> Dict:
    """``values`` (parameter name -> tensor; the model's parameters by
    default) in the reference's tree as float32 numpy arrays: block leaves
    stacked on the repeat axis under ``blocks/p{i}`` (the encoder's under
    ``encoder/blocks/p0``), every other leaf at its own path."""
    if values is None:
        values = dict(model.named_parameters())
    P = len(model.cfg.pattern)
    tree: Dict = {}
    stacks: Dict[tuple, Dict[int, np.ndarray]] = {}
    for name, t in values.items():
        a = t.detach().float().cpu().numpy()
        path, stacked = reference_path(name, P)
        if stacked:  # the repeat: blocks.<r P + i>, encoder.blocks.<r>
            parts = name.split(".")
            r = int(parts[1]) // P if parts[0] == "blocks" else int(parts[2])
            stacks.setdefault(path, {})[r] = a
            continue
        _put(tree, path, a)
    for path, rows in stacks.items():
        _put(tree, path, np.stack([rows[r] for r in sorted(rows)]))
    return tree


def _put(tree: Dict, path: tuple, leaf) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = leaf


def cache_from_reference(tree: Dict, cfg: ModelConfig, device=None) -> Cache:
    """The reference's stacked cache (``{"p{i}": {leaf: (R, ...)}}``) as the
    port's per-layer list: K and V from (B, T, KV, hd) to (B, KV, T, hd),
    the SSM states as they are."""
    device = resolve_device(device)
    out = []
    for r in range(cfg.repeats):
        for i in range(len(cfg.pattern)):
            layer = {}
            for key, leaf in tree[f"p{i}"].items():
                t = _tensor(np.asarray(leaf)[r], device=device)
                if key in _KV_KEYS:
                    t = t.transpose(1, 2).contiguous()
                layer[key] = t
            out.append(layer)
    return out


def cache_to_reference(cache: Cache, cfg: ModelConfig) -> Dict:
    """The port's cache in the reference's stacked layout, as float32 numpy
    arrays (bf16 caches are widened exactly)."""
    P = len(cfg.pattern)
    tree = {}
    for i in range(P):
        layers = cache[i::P]
        tree[f"p{i}"] = {
            key: np.stack([
                (layer[key].transpose(1, 2) if key in _KV_KEYS
                 else layer[key]).float().cpu().numpy() for layer in layers])
            for key in layers[0]}
    return tree
