"""Carry weights across from the JAX package as numpy.

The JAX params are a nested dict of arrays with layers stacked on axis 0
(``repro.models.transformer.init_params``); the port keeps exactly that
layout, so the conversion is leaf by leaf.  Imports neither ``jax`` nor
``repro``: the caller hands over numpy arrays (``np.asarray`` of each
JAX leaf; bfloat16 leaves arrive as ml_dtypes arrays).
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


def params_from_numpy(cfg: ModelConfig, tree: Dict,
                      device="cuda") -> Dict:
    """JAX transformer params (numpy leaves) -> the port's params."""
    layers = tree["layers"]
    L = np.asarray(layers["mlp"]["w_up"]).shape[0]
    if L != cfg.n_layers or np.asarray(tree["embed"]).shape != (
            cfg.vocab_size, cfg.d_model):
        raise ValueError(f"params do not match {cfg.name}: {L} layers, "
                         f"embed {np.asarray(tree['embed']).shape}")
    return _tree(tree, device)


def mor_from_numpy(tree: Dict, device="cuda") -> Dict:
    """A calibrated MoR tree {"layers": stacked MoRLayer} (numpy leaves)
    -> the port's MoR tree."""
    out = {}
    for group, layer in tree.items():
        missing = set(_MOR_KEYS) - set(layer)
        if missing:
            raise ValueError(f"MoR group {group!r} lacks {sorted(missing)}")
        out[group] = {k: _leaf(layer[k], device) for k in _MOR_KEYS}
    return out
