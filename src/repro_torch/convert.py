"""Carry weights across from the JAX package as numpy.

The JAX transformer params are a nested dict of arrays with layers
stacked on axis 0 (``repro.models.transformer.init_params``: one
``layers`` stack, or the ``dense_layers`` and ``moe_layers`` stacks of a
moe model); the paper's DNNs keep a Python *list* of per-layer dicts
(``repro.models.cnn`` / ``tds`` ``init_params``), with the CNN's BN
running stats in a separate state list and one calibrated MoRLayer per
layer (``calibrate_cnn`` / ``calibrate_tds``).  The port keeps exactly
those layouts, so the conversion is leaf by leaf.  Imports
neither ``jax`` nor ``repro``: the caller hands over numpy arrays
(``np.asarray`` of each JAX leaf; bfloat16 leaves arrive as ml_dtypes
arrays).
"""
from __future__ import annotations

from typing import Dict, List

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
    if isinstance(tree, (list, tuple)):
        return [_tree(v, device) for v in tree]
    return _leaf(tree, device)


def _n_paper_layers(cfg: ModelConfig) -> int:
    return (len(cfg.cnn_channels) - 1 if cfg.family == "cnn"
            else cfg.n_layers)


def _n_layers(stack: Dict) -> int:
    return np.asarray(stack["ln1"]["scale"]).shape[0]


def params_from_numpy(cfg: ModelConfig, tree: Dict,
                      device="cuda") -> Dict:
    """JAX params (numpy leaves) -> the port's params: the ``layers``
    stack of a dense model, the ``dense_layers`` / ``moe_layers`` stacks
    of a moe model, the ``layers`` list and ``head`` of a cnn or tds
    model."""
    if cfg.family in ("cnn", "tds"):
        layers = tree.get("layers")
        n = _n_paper_layers(cfg)
        if not isinstance(layers, (list, tuple)) or len(layers) != n:
            raise ValueError(f"params of {cfg.name} need a list of {n} "
                             f"layers")
        return _tree(tree, device)
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


def state_from_numpy(cfg: ModelConfig, state: Dict, device="cuda") -> Dict:
    """The CNN's BN running stats ({"bn": [{"mu", "var"}, ...]}, numpy
    leaves) -> the port's state."""
    n = _n_paper_layers(cfg)
    if len(state.get("bn", ())) != n:
        raise ValueError(f"state of {cfg.name} needs {n} BN entries")
    return _tree(state, device)


def mor_list_from_numpy(layers: List, device="cuda") -> List:
    """The per-layer MoRLayer list of ``calibrate_cnn`` /
    ``calibrate_tds`` (numpy leaves; None for a layer without one) ->
    the port's list."""
    return [None if layer is None else _mor_layer(f"layer {i}", layer,
                                                  device)
            for i, layer in enumerate(layers)]
