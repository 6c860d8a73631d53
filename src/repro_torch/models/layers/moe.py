"""Mixture-of-Experts FFN (``repro.models.layers.moe``): top-k routing
with static capacity, sort-based dispatch, shared experts (DeepSeek-V2
style), the load-balancing auxiliary loss.

Expert weights are (E, d, f) / (E, f, d) (the JAX layout, with the
layer stack leading).  Expert-level MoR runs every execution mode
through one batched-expert plan per layer (``executor.expert_ffn``):
per-(layer, expert) predictors, per-expert calibrated budgets, and
(E,)-shaped skip stats in aux["mor_stats"] for the serving telemetry.
Serving dispatches (the ``token_mask`` path) provision each expert for
the dispatch shape (``cfg.serve_expert_capacity``), so chunked prefill
never drops a valid token.  The expert-parallel ``moe_apply_a2a`` of
the JAX package runs only under a device mesh; the port's has no mesh
yet (ROADMAP queue A 7).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers.common import (activation_fn, dense_init,
                                              is_glu)
from repro_torch.models.layers.mlp import (effective_activation, mlp_apply,
                                           mlp_init)


def moe_init(gen: torch.Generator, cfg: ModelConfig,
             n_layers: int) -> Dict:
    """Layer-stacked router, expert and shared-expert weights."""
    d, f, E, L = cfg.d_model, cfg.moe_d_ff or cfg.d_ff, cfg.n_experts, \
        n_layers
    pd = cfg.tparam_dtype
    p = {"router": dense_init(gen, (L, d, E), pd, scale=0.02),
         "w_up": dense_init(gen, (L, E, d, f), pd),
         "w_down": dense_init(gen, (L, E, f, d), pd)}
    if is_glu(effective_activation(cfg)):
        p["w_gate"] = dense_init(gen, (L, E, d, f), pd)
    if cfg.n_shared_experts:
        p["shared"] = mlp_init(gen, cfg, L, d_ff=cfg.n_shared_experts * f)
    return p


def _count(idx: torch.Tensor, E: int) -> torch.Tensor:
    """Per-expert counts of ``idx`` (int64, (E,)), the sentinel E
    dropped.  A scatter into a fixed-size buffer: ``torch.bincount``
    would read the maximum back to the host on a CUDA tensor."""
    ones = torch.ones_like(idx, dtype=torch.int64)
    return torch.zeros(E + 1, dtype=torch.int64, device=idx.device
                       ).scatter_add_(0, idx.long(), ones)[:E]


def _dispatch_indices(top_idx: torch.Tensor, E: int, C: int) -> torch.Tensor:
    """top_idx: (T, k) expert choice per token-slot, E meaning a masked
    token.  Returns, per (token, k) pair, the expert buffer slot it
    lands in, or E*C if dropped: a stable sort so that earlier tokens
    win capacity (GShard / Switch semantics)."""
    T, k = top_idx.shape
    flat = top_idx.reshape(-1)
    order = torch.argsort(flat, stable=True)            # group by expert
    sorted_e = flat[order]
    counts = _count(flat, E)
    starts = torch.cumsum(counts, 0) - counts
    # sentinel pairs index the last start (JAX clamps) and are dropped
    pos_in_e = torch.arange(T * k, device=flat.device) - \
        starts[torch.clamp(sorted_e, max=E - 1)]
    keep = (pos_in_e < C) & (sorted_e < E)
    slot_sorted = torch.where(keep, sorted_e * C + pos_in_e, E * C)
    slot = torch.empty((T * k,), dtype=torch.int32, device=flat.device)
    slot[order] = slot_sorted.to(torch.int32)
    return slot.reshape(T, k)


def moe_apply(params: Dict, cfg: ModelConfig, x: torch.Tensor, *,
              mor=None, mor_mode: str = "dense",
              token_mask=None) -> Tuple[torch.Tensor, Dict]:
    """x: (..., d) -> (y, aux); aux carries the load-balance loss, the
    router entropy and, with an active expert plan, the (E,)-shaped
    ``mor_stats``.  ``token_mask`` (broadcastable to x's leading dims)
    marks REAL tokens: the others are routed to the sentinel expert E,
    so they never claim capacity."""
    from repro_torch.core.executor import as_expert_plan
    dt = x.dtype
    lead = x.shape[:-1]
    d = x.shape[-1]
    xf = x.reshape(-1, d)
    T = xf.shape[0]
    E, k = cfg.n_experts, cfg.top_k
    if token_mask is not None and cfg.serve_expert_capacity > 0:
        # each token claims at most one slot per expert, so C = T never
        # drops a valid token: chunked prefill computes the exact MoE
        C = max(int(math.ceil(cfg.serve_expert_capacity * T)), 1)
    else:
        C = max(int(cfg.capacity_factor * T * k / E), 1)
    act_name = effective_activation(cfg)
    glu = "w_gate" in params

    logits = (xf @ params["router"].to(dt)).float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_idx = torch.topk(probs, k, dim=-1)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    if token_mask is not None:
        tm = torch.broadcast_to(token_mask, lead).reshape(-1)
        top_idx = torch.where(tm[:, None], top_idx, E)

    slot = _dispatch_indices(top_idx, E, C)             # (T, k)
    # dispatch = a gather of d-vectors through an int32 slot map
    tok_src = torch.arange(T, dtype=torch.int32,
                           device=x.device)[:, None].expand(T, k).reshape(-1)
    slot_map = torch.full((E * C + 1,), T, dtype=torch.int32,
                          device=x.device)
    slot_map[slot.reshape(-1).long()] = tok_src
    xf_pad = torch.cat([xf, torch.zeros((1, d), dtype=dt, device=x.device)])
    eb = xf_pad[slot_map[:E * C].long()].reshape(E, C, d)

    # per-expert FFN: one batched-expert plan; the router itself is the
    # coarse zero predictor for the (E - top_k) unrouted experts
    em = mor.get("experts") if isinstance(mor, dict) else None
    eplan = as_expert_plan(em, mode=mor_mode, tile_m=cfg.mor.tile_m,
                           tile_n=cfg.mor.tile_n,
                           capacity_frac=cfg.mor.capacity)
    mor_stats = None
    if eplan.active and act_name in ("relu", "relu2", "relu_glu"):
        base_act = "relu" if act_name == "relu_glu" else act_name
        # buffer rows past an expert's routed count hold the zero row:
        # forced dead, so they mark no tile live
        counts = _count(top_idx.reshape(-1), E)
        row_valid = (torch.arange(C, device=x.device)[None, :]
                     < torch.clamp(counts, max=C)[:, None])
        out_e, mor_stats = eplan.expert_ffn(
            eb, params["w_up"].to(dt), params["w_down"].to(dt),
            activation=base_act,
            w_gate=params["w_gate"].to(dt) if glu else None,
            row_mask=row_valid)
        out_e = out_e.to(dt)
    else:
        act = activation_fn(act_name)
        up = torch.bmm(eb, params["w_up"].to(dt))
        if glu:
            h = (act(torch.bmm(eb, params["w_gate"].to(dt))) * up).to(dt)
        else:
            h = act(up).to(dt)
        out_e = torch.bmm(h, params["w_down"].to(dt))
    out_flat = torch.cat([out_e.reshape(E * C, d),
                          torch.zeros((1, d), dtype=dt, device=x.device)])

    # combine: one (T, d) gather per routed expert k
    y = torch.zeros((T, d), dtype=dt, device=x.device)
    for kk in range(k):
        part = out_flat[slot[:, kk].long()]
        y = y + part * top_p[:, kk:kk + 1].to(dt)

    if cfg.n_shared_experts:
        ys, _ = mlp_apply(params["shared"], cfg, xf, mor=mor,
                          mor_mode=mor_mode)
        y = y + ys

    frac_routed = _count(top_idx.reshape(-1), E).float() / (T * k)
    aux = {"lb_loss": E * torch.sum(frac_routed * probs.mean(0)),
           "router_entropy": -torch.mean(
               torch.sum(probs * torch.log(probs + 1e-9), -1))}
    if mor_stats is not None:
        aux["mor_stats"] = mor_stats
    return y.reshape(*lead, d), aux


def moe_taps(params: Dict, cfg: ModelConfig, x: torch.Tensor) -> Dict:
    """Calibration taps for the expert FFNs: per-expert (p_bin, p_base)
    of the gate (or up) pre-activation over ALL tokens, (E, T, f) each.
    Taps are routing-independent: dispatch merely subsamples the token
    distribution the fitted line models."""
    from repro_torch.core.predictor import binary_preact
    x2 = x.reshape(-1, x.shape[-1])
    w = params.get("w_gate", params["w_up"])            # (E, d, f)
    p_base = x2.float() @ w.float()
    return {"p_bin": binary_preact(x2, w), "p_base": p_base}
