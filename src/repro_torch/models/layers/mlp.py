"""FFN layers with the Mixture-of-Rookies hook (``repro.models.layers.mlp``).

``mlp_apply`` runs the dense math unless an active MoR plan is supplied
and the activation is ReLU-family, in which case it routes through
``MoRExecutionPlan.ffn``.

Under a mesh (``distributed.sharding_rules.activation_context``) whose
layer loop left ``w_gate`` / ``w_up`` split over ``model`` by column and
``w_down`` by row (``tp_keep``; under ``"contract_tp"`` moved there from
the contraction splits), the FFN is Megatron's tensor-parallel FFN: the
input enters through ``copy_to_model``, each rank computes its f / MP
hidden columns, and one ``all_reduce_sum`` over ``model`` sums the down
projection's partials.  An active MoR plan runs so too, in every mode,
where f divides over ``model`` in whole ``tile_n`` tiles (``mor_whole``):
the rank's plan (``executor.MoRExecutionPlan.for_rank``) predicts, clips
and computes its own column block of one device's tile mask, after two
small exchanges over the mesh (its proxies' ReLU inputs, "mor_proxy",
and, where a budget can bite, its tile rows' live counts, "mor_rows").
Where f does not divide so, the FFN under an active plan is gathered
whole (``sharding_rules.model_gathers`` names its leaves).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding_rules as sr
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


def mor_whole(cfg: ModelConfig, mp: int, mor_active: bool) -> bool:
    """Whether the config's FFN is gathered whole over ``mp`` model
    ranks for its MoR plan: where the plan is active and its d_ff
    columns do not divide into whole ``tile_n`` tiles a rank."""
    return mor_active and cfg.d_ff % (mp * cfg.mor.tile_n) != 0


def tp_keep(specs, whole: bool, prefix: str = "") -> dict:
    """The FFN leaves whose ``model`` splits the tensor-parallel FFN
    consumes, each with the dim it consumes it on: ``w_gate`` / ``w_up``
    by d_ff column (dim -1) and ``w_down`` by d_ff row (dim -2), where
    every one of them is split over ``model`` and the FFN is not kept
    ``whole`` for its MoR plan (``mor_whole``), else none.
    ``"fsdp_tp"`` splits them there; ``"contract_tp"`` splits the up
    projections' input dim and the down projection's output dim, and
    ``sharding_rules.use`` moves each onto the form's dim."""
    if whole or not isinstance(specs, dict):
        return {}
    up = [k for k in ("w_gate", "w_up") if k in specs]
    if any(sr.model_dim(specs, k) is None for k in up + ["w_down"]):
        return {}
    return {prefix + k: (-2 if k == "w_down" else -1)
            for k in up + ["w_down"]}


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
    # column-parallel up projections, row-parallel down projection
    # (under sequence parallelism x holds every S row and the sum comes
    # back as this rank's rows: ``sharding_rules.tp_exit``)
    group = sr.split_group(params["w_down"])
    if group is not None:
        x2 = sr.tp_enter(x2, group)
    if plan.active and act_name in ("relu", "relu2", "relu_glu"):
        base = "relu" if act_name == "relu_glu" else act_name
        if group is not None:
            plan = plan.for_rank(group)
        y, stats = plan.ffn(
            x2, params["w_up"].to(dt), params["w_down"].to(dt),
            activation=base,
            w_gate=params.get("w_gate") if is_glu(act_name) else None)
        y = y.reshape(*lead, -1).to(dt)
        if group is not None:
            y = sr.tp_exit(y, group, max(len(lead) - 1, 0))
        return y, stats

    fn = activation_fn(act_name)
    if is_glu(act_name):
        h = fn(x2 @ params["w_gate"].to(dt)) * (x2 @ params["w_up"].to(dt))
    else:
        h = fn(x2 @ params["w_up"].to(dt))
    y = (h.to(dt) @ params["w_down"].to(dt)).reshape(*lead, -1)
    if group is not None:
        y = sr.tp_exit(y, group, max(len(lead) - 1, 0))
    return y, {}


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
