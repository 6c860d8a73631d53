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
never drops a valid token.

Under a mesh (``distributed.sharding_rules.activation_context``):

  * ``moe_apply_a2a`` ("expert slicing", the reference's shard_map
    schedule) for ``expert_sharding="ep_shmap"`` without a token mask:
    tokens sharded over ``data`` only and routed identically on every
    ``model`` rank with the per-data-shard capacity ``C_loc``; each rank
    runs its E / MP experts (or, where MP does not divide E, every
    expert on its f / MP columns), and one ``all_reduce_sum`` over
    ``model`` combines them.  Expert MoR rides the expert-slicing form
    only: the rank's slice of the attached expert plan runs
    ``executor.expert_ffn`` (in kernel mode the expert-grid kernels on
    its E / MP experts);
  * otherwise the single-device semantics: the tokens all-gathered over
    ``data`` (routing is over the global batch), the experts whole, or
    split over ``model`` by f column where the rules put f or d there
    (``"contract_tp"``'s d split moved onto f by
    ``sharding_rules.use``) and no expert plan runs, then this rank's
    rows taken back.  An expert plan keeps the experts whole here, as
    the reference keeps ``moe_apply_a2a``'s f-sliced form dense: the
    column split of a plan (``executor.MoRExecutionPlan.for_rank``) is
    the dense FFN's, and the expert grid's goes with this path's token
    gather.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives as co
from repro_torch.distributed import sharding_rules as sr
from repro_torch.models.layers.common import (activation_fn, dense_init,
                                              is_glu)
from repro_torch.models.layers.mlp import (effective_activation, mlp_apply,
                                           mlp_init)
from repro_torch.models.layers.mlp import tp_keep as mlp_tp_keep

_MOR_ACTS = ("relu", "relu2", "relu_glu")
_EXPERT = ("w_gate", "w_up", "w_down")


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


def _a2a_form(cfg: ModelConfig, mesh, T_loc: int):
    """"ep" (expert slicing), "tp" (f slicing) or None: whether and how
    ``moe_apply_a2a`` runs ``T_loc`` local tokens on ``mesh``."""
    if "model" not in mesh.axis_names:
        return None
    MP = mesh.shape["model"]
    f = cfg.moe_d_ff or cfg.d_ff
    mode_tp = cfg.n_experts % MP != 0
    if mode_tp and f % MP != 0:
        return None
    # the reference's T % (dp * MP), with T = dp * T_loc
    if T_loc % MP != 0:
        return None
    return "tp" if mode_tp else "ep"


def tp_keep(cfg: ModelConfig, specs, mesh, T_loc: int, masked: bool,
            plan_active: bool, prefix: str = "moe/") -> dict:
    """The MoE leaves whose ``model`` splits stay split for this call,
    each with the dim its form consumes it on: the expert dim (-3,
    expert slicing) or the f dim (f slicing: ``w_gate`` / ``w_up`` on
    -1, ``w_down`` on -2) of the expert weights where ``moe_apply_a2a``
    runs them, the f dim where the plain path splits it (no expert
    plan), and the shared experts' as ``mlp.tp_keep`` says.  Under
    ``"contract_tp"`` the ``moe_tp`` experts are split on d, their
    contraction dim for ``w_gate`` / ``w_up`` and their output dim for
    ``w_down``; ``sharding_rules.use`` moves each onto f.  The router is
    always whole."""
    keep = {}
    if isinstance(specs.get("shared"), dict):
        keep.update(mlp_tp_keep(specs["shared"], False, prefix + "shared/"))
    experts = [k for k in _EXPERT if k in specs]
    f_dims = {k: -1 if k != "w_down" else -2 for k in experts}
    on_f = all(sr.model_dim(specs, k) in (-1, -2) for k in experts)
    form = (_a2a_form(cfg, mesh, T_loc)
            if cfg.expert_sharding == "ep_shmap" and not masked else None)
    if form == "ep" and all(sr.on_model(specs, k, -3) for k in experts):
        keep.update({prefix + k: -3 for k in experts})
    elif on_f and (form is not None or not plan_active):
        keep.update({prefix + k: f_dims[k] for k in experts})
    return keep


def _expert_ffn_dense(eb, w_up, w_gate, w_down, act_name: str):
    act = activation_fn(act_name)
    dt = eb.dtype
    up = torch.bmm(eb, w_up.to(dt))
    if w_gate is not None:
        h = (act(torch.bmm(eb, w_gate.to(dt))) * up).to(dt)
    else:
        h = act(up).to(dt)
    return torch.bmm(h, w_down.to(dt))


def _route(xf, router, k: int):
    logits = (xf @ router.to(xf.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_idx = torch.topk(probs, k, dim=-1)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return probs, top_p, top_idx


def _slot_plan(em_plan, e0: int, n: int, E: int, device):
    """The rank's (E_loc, ...) slice of an attached expert plan: every
    leaf's rows [e0, e0 + n) and the per-expert ``cap_live`` budget
    (broadcast to (E,) first), as the reference's in_specs slice them."""
    from repro_torch.core.executor import MoRExecutionPlan
    em = {key: v[e0:e0 + n] for key, v in em_plan.mor.items()}
    cap = em_plan.cap_live
    if cap is not None:
        cap = torch.broadcast_to(torch.as_tensor(
            cap, dtype=torch.float32, device=device), (E,))[e0:e0 + n]
    return MoRExecutionPlan(em, mode=em_plan.mode, tile_m=em_plan.tile_m,
                            tile_n=em_plan.tile_n,
                            capacity_frac=em_plan.capacity_frac,
                            cap_live=cap)


def moe_apply_a2a(params: Dict, cfg: ModelConfig, x: torch.Tensor, *,
                  mor=None, mor_mode: str = "dense"):
    """Expert-parallel MoE ("expert slicing", the reference's shard_map
    form) under the active mesh, or None where it does not apply (no
    mesh, no ``model`` axis, T_loc % MP != 0, f slicing with f % MP !=
    0).  x holds this data rank's T_loc tokens, the same on every
    ``model`` rank; the expert weights are this rank's blocks (E / MP
    experts, or every expert's f / MP columns).  Every rank routes the
    same tokens (capacity ``C_loc = max(int(cf T_loc k / E), 1)``, so a
    lossy capacity drops per data shard), keeps its own experts' slots,
    runs them, and one ``all_reduce_sum`` over ``model`` sums the
    disjoint contributions.  The load-balance loss is this shard's,
    identical on every ``model`` rank.  -> (y, aux) without the shared
    experts."""
    from repro_torch.core.executor import as_expert_plan
    ctx = sr.current()
    if ctx is None:
        return None
    mesh = ctx.mesh
    E, k = cfg.n_experts, cfg.top_k
    lead = x.shape[:-1]
    d = x.shape[-1]
    xf = x.reshape(-1, d)
    T_loc = xf.shape[0]
    form = _a2a_form(cfg, mesh, T_loc)
    if form is None:
        return None
    group = sr.model_group(ctx)
    MP = mesh.shape["model"]
    C_loc = max(int(cfg.capacity_factor * T_loc * k / E), 1)
    E_loc = E if form == "tp" else E // MP
    e0 = 0 if form == "tp" else mesh.index("model") * E_loc
    dt = x.dtype
    dev = x.device
    glu = "w_gate" in params
    act_name = effective_activation(cfg)
    em = mor.get("experts") if isinstance(mor, dict) else None
    eplan = as_expert_plan(em, mode=mor_mode, tile_m=cfg.mor.tile_m,
                           tile_n=cfg.mor.tile_n,
                           capacity_frac=cfg.mor.capacity)
    # expert-level MoR rides the expert-slicing form only: f slicing
    # splits every expert's columns (proxies may live elsewhere)
    use_mor = eplan.active and form == "ep" and act_name in _MOR_ACTS
    params = dict(params)
    for name in _EXPERT:
        if name not in params:
            continue
        w = params[name]
        if form == "ep" and w.shape[0] == E and MP > 1:
            # the rules put every expert's f on ``model``: one all-to-all
            # hands each rank the other f blocks of its own experts
            f_dim = 2 if name != "w_down" else 1
            params[name] = co.all_to_all_dim(w, 0, f_dim, group)
        assert params[name].shape[0] == E_loc, \
            (name, tuple(params[name].shape), E_loc)

    probs, top_p, top_idx = _route(xf, params["router"], k)
    slot = _dispatch_indices(top_idx, E, C_loc)          # (T_loc, k)
    # this rank's experts' slots
    loc = slot.long() - e0 * C_loc
    mine = (loc >= 0) & (loc < E_loc * C_loc)
    loc = torch.where(mine, loc, E_loc * C_loc)
    tok = torch.arange(T_loc, dtype=torch.int32, device=dev
                       )[:, None].expand(T_loc, k).reshape(-1)
    smap = torch.full((E_loc * C_loc + 1,), T_loc, dtype=torch.int32,
                      device=dev)
    # the other ranks' slots all land on the sentinel entry, which no
    # expert row reads (no boolean mask: its size would be data-
    # dependent, which the meta device of the dry run cannot hold)
    smap[loc.reshape(-1)] = tok
    xr = co.copy_to_model(xf, group)          # the experts' region
    xpad = torch.cat([xr, torch.zeros((1, d), dtype=dt, device=dev)])
    eb = xpad[smap[:E_loc * C_loc].long()].reshape(E_loc, C_loc, d)
    gate = params["w_gate"] if glu else None
    if use_mor:
        counts = _count(top_idx.reshape(-1), E)[e0:e0 + E_loc]
        row_valid = (torch.arange(C_loc, device=dev)[None, :]
                     < torch.clamp(counts, max=C_loc)[:, None])
        plan = _slot_plan(eplan, e0, E_loc, E, dev)
        base_act = "relu" if act_name == "relu_glu" else act_name
        out_e, _ = plan.expert_ffn(
            eb, params["w_up"].to(dt), params["w_down"].to(dt),
            activation=base_act, w_gate=None if gate is None else
            gate.to(dt), row_mask=row_valid)
        out_e = out_e.to(dt)
    else:
        out_e = _expert_ffn_dense(eb, params["w_up"], gate,
                                  params["w_down"], act_name)
    out_flat = torch.cat([out_e.reshape(E_loc * C_loc, d),
                          torch.zeros((1, d), dtype=dt, device=dev)])
    tp_r = co.copy_to_model(top_p, group)
    y = torch.zeros((T_loc, d), dtype=dt, device=dev)
    for kk in range(k):
        y = y + out_flat[loc[:, kk]] * tp_r[:, kk:kk + 1].to(dt)
    y = co.all_reduce_sum(y, group)
    fr = _count(top_idx.reshape(-1), E).float() / (T_loc * k)
    aux = {"lb_loss": E * torch.sum(fr * probs.mean(0)),
           "router_entropy": torch.zeros((), dtype=torch.float32,
                                         device=dev)}
    return y.reshape(*lead, d), aux


def moe_apply(params: Dict, cfg: ModelConfig, x: torch.Tensor, *,
              mor=None, mor_mode: str = "dense",
              token_mask=None) -> Tuple[torch.Tensor, Dict]:
    """x: (..., d) -> (y, aux); aux carries the load-balance loss, the
    router entropy and, with an active expert plan, the (E,)-shaped
    ``mor_stats``.  ``token_mask`` (broadcastable to x's leading dims)
    marks REAL tokens: the others are routed to the sentinel expert E,
    so they never claim capacity.  Under a mesh: ``moe_apply_a2a`` for
    ``ep_shmap`` without a token mask, else ``_moe_mesh``."""
    ctx = sr.current()
    out = None
    if ctx is not None and cfg.expert_sharding == "ep_shmap" and \
            token_mask is None:
        out = moe_apply_a2a(params, cfg, x, mor=mor, mor_mode=mor_mode)
    if out is None:
        out = (_moe_mesh if ctx is not None else _moe_core)(
            params, cfg, x, mor=mor, mor_mode=mor_mode,
            token_mask=token_mask)
    y, aux = out
    if cfg.n_shared_experts:
        xf = x.reshape(-1, x.shape[-1])
        ys, _ = mlp_apply(params["shared"], cfg, xf, mor=mor,
                          mor_mode=mor_mode)
        y = y + ys.reshape(y.shape)
    return y, aux


def _moe_mesh(params: Dict, cfg: ModelConfig, x: torch.Tensor, *,
              mor=None, mor_mode: str = "dense", token_mask=None):
    """The single-device semantics under a mesh: the tokens (and the
    mask) all-gathered over ``data``, the experts split by f column
    where the layer loop left them so (``copy_to_model`` in, one
    ``all_reduce_sum`` out), this data rank's rows taken back."""
    ctx = sr.current()
    dgroup = sr.dp_group(ctx.mesh)
    lead = x.shape[:-1]
    d = x.shape[-1]
    xf = x.reshape(-1, d)
    T_loc = xf.shape[0]
    tm = None
    if token_mask is not None:
        tm = torch.broadcast_to(token_mask, lead).reshape(-1)
    if dgroup.size > 1:
        xf = co.all_gather_dim(xf, 0, dgroup, reduce_grad=True)
        if tm is not None:
            tm = co.all_gather(tm, 0, dgroup, "moe_tokens")
    y, aux = _moe_core(params, cfg, xf, mor=mor, mor_mode=mor_mode,
                       token_mask=tm,
                       group=sr.split_group(params["w_down"]))
    if dgroup.size > 1:
        y = y[dgroup.rank * T_loc:(dgroup.rank + 1) * T_loc]
    return y.reshape(*lead, d), aux


def _moe_core(params: Dict, cfg: ModelConfig, x: torch.Tensor, *,
              mor=None, mor_mode: str = "dense", token_mask=None,
              group=None) -> Tuple[torch.Tensor, Dict]:
    """The routed experts of ``moe_apply`` (the shared ones apart).
    ``group``: the ``model`` group the experts' f columns are split over
    (their buffer and router weights enter through ``copy_to_model``,
    the combined output leaves through ``all_reduce_sum``), or None."""
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

    probs, top_p, top_idx = _route(xf, params["router"], k)
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
    xr = co.copy_to_model(xf, group)
    xf_pad = torch.cat([xr, torch.zeros((1, d), dtype=dt, device=x.device)])
    eb = xf_pad[slot_map[:E * C].long()].reshape(E, C, d)

    # per-expert FFN: one batched-expert plan; the router itself is the
    # coarse zero predictor for the (E - top_k) unrouted experts
    em = mor.get("experts") if isinstance(mor, dict) else None
    eplan = as_expert_plan(em, mode=mor_mode, tile_m=cfg.mor.tile_m,
                           tile_n=cfg.mor.tile_n,
                           capacity_frac=cfg.mor.capacity)
    mor_stats = None
    if eplan.active and act_name in _MOR_ACTS:
        assert group is None, "an expert plan runs on whole experts"
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
        out_e = _expert_ffn_dense(eb, params["w_up"],
                                  params["w_gate"] if glu else None,
                                  params["w_down"], act_name)
    out_flat = torch.cat([out_e.reshape(E * C, d),
                          torch.zeros((1, d), dtype=dt, device=x.device)])

    # combine: one (T, d) gather per routed expert k
    tp_r = co.copy_to_model(top_p, group)
    y = torch.zeros((T, d), dtype=dt, device=x.device)
    for kk in range(k):
        part = out_flat[slot[:, kk].long()]
        y = y + part * tp_r[:, kk:kk + 1].to(dt)
    y = co.all_reduce_sum(y, group)

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
