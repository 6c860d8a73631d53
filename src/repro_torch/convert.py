"""Carry weights across from the JAX package as numpy.

The JAX params are a nested dict of arrays with layers stacked on axis 0
(``repro.models.transformer.init_params``: one ``layers`` stack, or the
``dense_layers`` and ``moe_layers`` stacks of a moe model); the port
keeps exactly that layout, so the conversion is leaf by leaf.  Imports
neither ``jax`` nor ``repro``: the caller hands over numpy arrays
(``np.asarray`` of each JAX leaf; bfloat16 leaves arrive as ml_dtypes
arrays).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig

_MOR_KEYS = ("m", "b", "enable", "proxy_slot", "is_proxy", "perm",
             "inv_perm", "bn_scale", "bn_bias")


def _leaf(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)     # a writable copy


def _tree(tree, device):
    if isinstance(tree, dict):
        return {k: _tree(v, device) for k, v in tree.items()}
    return _leaf(tree, device)


def _n_layers(stack: Dict) -> int:
    return np.asarray(stack["ln1"]["scale"]).shape[0]


def params_from_numpy(cfg: ModelConfig, tree: Dict,
                      device="cuda") -> Dict:
    """JAX transformer params (numpy leaves) -> the port's params: the
    ``layers`` stack of a dense model, the ``dense_layers`` /
    ``moe_layers`` stacks of a moe model."""
    if cfg.family == "moe":
        keys = (["dense_layers"] if cfg.first_k_dense else []) + \
            ["moe_layers"]
    else:
        keys = ["layers"]
    missing = [k for k in keys if k not in tree]
    if missing:
        raise ValueError(f"params of {cfg.name} lack {missing}")
    L = sum(_n_layers(tree[k]) for k in keys)
    embed = np.asarray(tree["embed"]).shape
    if L != cfg.n_layers or embed != (cfg.vocab_size, cfg.d_model):
        raise ValueError(f"params do not match {cfg.name}: {L} layers, "
                         f"embed {embed}")
    return _tree(tree, device)


def _mor_layer(group: str, layer: Dict, device) -> Dict:
    missing = set(_MOR_KEYS) - set(layer)
    if missing:
        raise ValueError(f"MoR group {group!r} lacks {sorted(missing)}")
    return {k: _leaf(layer[k], device) for k in _MOR_KEYS}


def mor_from_numpy(tree: Dict, device="cuda") -> Dict:
    """A calibrated MoR tree (numpy leaves) -> the port's MoR tree:
    {group: stacked MoRLayer}, where a moe model's expert group is
    {"moe_layers": {"experts": (L, E)-stacked MoRLayer}}."""
    out = {}
    for group, layer in tree.items():
        if "experts" in layer:
            out[group] = {"experts": _mor_layer(group, layer["experts"],
                                                device)}
        else:
            out[group] = _mor_layer(group, layer, device)
    return out
