"""Offline MoR deployment (``repro.core.deploy``): calibrate a model,
cluster its ReLU layers, fold the tile permutation into the weights, and
emit the layer-stacked MoRLayer dict the runtime consumes.

  taps -> per-neuron (m, b, c) regression   [calibration.py]
  weights -> angle clusters -> proxies       [clustering.py]
  -> column permutation folded into w_gate/w_up (cols) + w_down (rows)
"""
from __future__ import annotations

from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.calibration import (finalize_regression,
                                          init_accumulator,
                                          update_accumulator)
from repro_torch.core.clustering import cluster_layer
from repro_torch.core.executor import MoRExecutionPlan
from repro_torch.core.policy import build_mor_layer


def attach_plans(mor, cfg: ModelConfig, mode: str,
                 capacities: Optional[Dict] = None):
    """Wrap calibrated layer-stacked MoR groups ({group -> stacked
    MoRLayer}) in execution plans carrying the mode, tile geometry and
    capacity from ``cfg.mor``.  ``capacities`` ({group -> (L,) fractions
    or a scalar}) attaches per-layer calibrated budgets as ``cap_live``;
    a scalar applies to every layer."""
    if mor is None or mode == "dense":
        return mor
    caps = capacities or {}

    def wrap(layer, cap):
        if layer is None:
            return None
        cap_live = None
        if cap is not None:
            cap_live = np.broadcast_to(np.asarray(cap, np.float32),
                                       tuple(layer["m"].shape[:1]))
        return MoRExecutionPlan(layer, mode=mode, tile_m=cfg.mor.tile_m,
                                tile_n=cfg.mor.tile_n,
                                capacity_frac=cfg.mor.capacity,
                                cap_live=cap_live)

    return {k: wrap(v, caps.get(k)) for k, v in mor.items()}


def calibrate_lm(params: Dict, cfg: ModelConfig, forward: Callable,
                 batches: Iterator[Dict], n_batches: int,
                 layer_key: str = "layers") -> Tuple[Dict, Dict, Dict]:
    """Calibrate a layer-stacked dense LM.

    -> (params with permuted FFN weights, mor {layer_key: stacked
        MoRLayer}, report dict with Pearson stats).  ``params`` itself
    is left as it was."""
    L = cfg.n_layers
    lp = params[layer_key]
    w_stack = lp["mlp"].get("w_gate", lp["mlp"]["w_up"])
    N = w_stack.shape[-1]
    device = w_stack.device

    acc = init_accumulator((L, N), device)
    seen = 0
    with torch.no_grad():
        for batch in batches:
            taps = forward(params, cfg, batch, with_taps=True)[1]["taps"]
            acc = update_accumulator(acc, taps["p_bin"], taps["p_base"])
            del taps
            seen += 1
            if seen >= n_batches:
                break
    m, b, c = (t.cpu().numpy() for t in finalize_regression(acc))

    layers = []
    for l in range(L):
        cl = cluster_layer(w_stack[l], cfg.mor.max_cluster_angle)
        layers.append(build_mor_layer(m[l], b[l], c[l], cl, cfg.mor,
                                      device))
    mor_stack = {k: torch.stack([ml[k] for ml in layers])
                 for k in layers[0]}

    # fold the permutations into the weights (offline, zero runtime cost)
    perm = mor_stack["perm"].long()                       # (L, N)

    def permute_stack(w, axis):
        return torch.stack([w[l].index_select(axis, perm[l])
                            for l in range(L)])

    mlp = dict(lp["mlp"])
    if "w_gate" in mlp:
        mlp["w_gate"] = permute_stack(mlp["w_gate"], 1)
    mlp["w_up"] = permute_stack(mlp["w_up"], 1)
    mlp["w_down"] = permute_stack(mlp["w_down"], 0)
    new_params = dict(params)
    new_params[layer_key] = dict(lp, mlp=mlp)

    report = {
        "pearson_mean": float(c.mean()),
        "pearson_frac_above_T": float((c > cfg.mor.corr_threshold).mean()),
        "n_proxies_mean": float(np.mean([
            len(np.unique(ml["proxy_slot"].cpu().numpy()))
            for ml in layers])),
        "enabled_frac": float(mor_stack["enable"].float().mean()),
    }
    return new_params, {layer_key: mor_stack}, report
