"""The slotted serving cache (``repro.serving.kv_pool`` ``ring_cfg`` /
``init`` / ``reset_slots``): every slot owns a contiguous ring row.

Layout: {"pos": (n_slots,) int32 next position per slot, "layers":
{"k", "v": (L, n_slots, Lr, hkv, hd), "pos": (L, n_slots, Lr) int32
position tags, -1 = empty}} — the JAX layout, with the page/slot dim at
axis 1 of every stacked leaf.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import get_model


def ring_cfg(cfg: ModelConfig, chunk: int) -> ModelConfig:
    """Config used ONLY for cache allocation: window + chunk ring slack."""
    if cfg.sliding_window:
        cfg = cfg.replace(sliding_window=cfg.sliding_window + chunk)
    return cfg


def init(cfg: ModelConfig, n_slots: int, max_len: int, chunk: int = 0,
         dtype=None, device="cuda") -> Dict:
    """Allocate the slot-pool cache for ``n_slots`` sequences of up to
    ``max_len`` positions."""
    chunk = chunk or cfg.serve_chunk
    api = get_model(cfg)
    cache = api.cache_init(ring_cfg(cfg, chunk), n_slots, max_len,
                           dtype or cfg.tdtype, device)
    layers = dict(cache["layers"])
    L, Lr = layers["pos"].shape
    layers["pos"] = torch.full((L, n_slots, Lr), -1, dtype=torch.int32,
                               device=device)
    return {"pos": torch.zeros((n_slots,), dtype=torch.int32,
                               device=device),
            "layers": layers}


def reset_slots(cache: Dict, slots: torch.Tensor) -> Dict:
    """Recycle cache slots IN PLACE: zero state / -1 kv tags / 0 position
    for every slot where ``slots`` (n_slots,) bool is True."""
    for key, a in cache["layers"].items():
        m = slots.reshape((1, -1) + (1,) * (a.ndim - 2))
        a.masked_fill_(m, -1 if key == "pos" else 0)
    cache["pos"].masked_fill_(slots, 0)
    return cache
