"""FFN layers with the Mixture-of-Rookies hook (``repro.models.layers.mlp``).

``mlp_apply`` runs the dense math unless an active MoR plan is supplied
and the activation is ReLU-family, in which case it routes through
``MoRExecutionPlan.ffn``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers.common import activation_fn, dense_init, is_glu


def effective_activation(cfg: ModelConfig) -> str:
    """swiglu + relufied -> relu_glu; gelu/silu + relufied -> relu."""
    act = cfg.activation
    if cfg.mor.relufied:
        if act == "swiglu":
            return "relu_glu"
        if act in ("gelu", "silu"):
            return "relu"
    return act


def mlp_init(gen: torch.Generator, cfg: ModelConfig, n_layers: int,
             d_ff: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Layer-stacked FFN weights in (d_in, d_out) layout."""
    d, f, L = cfg.d_model, d_ff or cfg.d_ff, n_layers
    pd = cfg.tparam_dtype
    if is_glu(effective_activation(cfg)):
        return {"w_gate": dense_init(gen, (L, d, f), pd),
                "w_up": dense_init(gen, (L, d, f), pd),
                "w_down": dense_init(gen, (L, f, d), pd)}
    return {"w_up": dense_init(gen, (L, d, f), pd),
            "w_down": dense_init(gen, (L, f, d), pd)}


def mlp_apply(params: Dict, cfg: ModelConfig, x: torch.Tensor, *,
              mor=None, mor_mode: str = "dense",
              ) -> Tuple[torch.Tensor, Dict]:
    """x: (..., d).  Returns (y, mor_stats)."""
    from repro_torch.core.executor import as_plan
    act_name = effective_activation(cfg)
    dt = x.dtype
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    plan = as_plan(mor, mode=mor_mode, tile_m=cfg.mor.tile_m,
                   tile_n=cfg.mor.tile_n, capacity_frac=cfg.mor.capacity)
    if plan.active and act_name in ("relu", "relu2", "relu_glu"):
        base = "relu" if act_name == "relu_glu" else act_name
        y, stats = plan.ffn(
            x2, params["w_up"].to(dt), params["w_down"].to(dt),
            activation=base,
            w_gate=params.get("w_gate") if is_glu(act_name) else None)
        return y.reshape(*lead, -1).to(dt), stats

    fn = activation_fn(act_name)
    if is_glu(act_name):
        h = fn(x2 @ params["w_gate"].to(dt)) * (x2 @ params["w_up"].to(dt))
    else:
        h = fn(x2 @ params["w_up"].to(dt))
    y = h.to(dt) @ params["w_down"].to(dt)
    return y.reshape(*lead, -1), {}


def mlp_taps(params: Dict, cfg: ModelConfig, x: torch.Tensor) -> Dict:
    """Calibration taps: (p_bin, p_base) for the ReLU pre-activation of
    this FFN (gate matmul for GLU, up matmul otherwise)."""
    from repro_torch.core.predictor import binary_preact
    dt = x.dtype
    x2 = x.reshape(-1, x.shape[-1])
    w = params["w_gate"] if "w_gate" in params else params["w_up"]
    p_base = (x2 @ w.to(dt)).float()
    p_bin = binary_preact(x2, w)
    return {"p_bin": p_bin, "p_base": p_base}
