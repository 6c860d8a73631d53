"""RWKV6 "Finch" layers (``repro.models.layers.rwkv``): time-mix with a
data-dependent decay (a LoRA on w) and the ReLU^2 channel-mix, a native
Mixture-of-Rookies target (zero iff its pre-activation is <= 0).

The wkv recurrence runs in the JAX package's GLA-style chunked form
(``_wkv6_chunked``: chunks of 8 positions, a float32 state carried
between them); decode is one recurrence step.  The reference's scans are
jnp, so plain torch ops are their port: there is no kernel here.  Every
``*_init`` returns weights with a leading layer dim of ``n_layers``; the
other functions take one layer's views.  ``timemix_forward(chunked=
False)`` is the reference's serial scan, one position a step, with its
rematerialised chunks of ``SERIAL_CHUNK`` positions under autograd (a
training-memory variant: no serving or calibration path calls it).

Under a mesh whose layer loop left their ``model`` splits (``tp_keep``)
the teacher-forced forms are tensor-parallel.  The time mix runs by
head: the input enters the region once (``tp_enter``), every rank forms
the five lerps and the decay LoRA's ``tanh(x wA)`` with the whole
``mu`` / ``wA`` (``sharding_rules.tp_shared``), its column blocks of
``Wr``, ``Wk``, ``Wv``, ``Wg`` and ``wB`` give its heads' r, k, v, gate
and decay, its slices of ``w0``, ``u`` and ``ln_scale``
(``tp_slice``) its heads' WKV6 and group norm, and ``Wo`` closes the
region with one reduction.  ``Wo``'s ``model`` split is on its output
columns; the rank needs its heads' rows, so ``Wo`` is gathered (d^2
weights a layer) and sliced by row, rather than all-gathering y and
the output (2 B S d activations a layer, far more at training
shapes).  The channel mix is Megatron's FFN: ``w_up`` by column,
``w_down`` by row, the ``Wr`` gate (gathered whole) applied to the
reduced sum, on this rank's rows under sequence parallelism.  Under an
active MoR plan it runs so too where d_ff divides over ``model`` in
whole ``tile_n`` tiles: the rank's plan (``executor.MoRExecutionPlan.
for_rank``) runs ``relu_matmul`` (relu2) on its columns, after the
plan's exchanges of its proxies' inputs and its tile rows' live
counts; the down projection stays a plain product, as in the
reference.  Its decode gathers the block whole on every rank.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding_rules as sr
from repro_torch.models.layers.common import dense_init, randn
from repro_torch.models.transformer import _remat

_W_LORA = 64
_W_MIN = float(torch.exp(torch.tensor(-10.0)))     # the decay clamp, e^-10
# positions a rematerialised chunk of the serial scan covers
SERIAL_CHUNK = 256


def _heads(cfg: ModelConfig):
    hd = cfg.rwkv_head_size
    return cfg.d_model // hd, hd


def timemix_init(gen: torch.Generator, cfg: ModelConfig,
                 n_layers: int) -> Dict[str, torch.Tensor]:
    d, L, dev = cfg.d_model, n_layers, gen.device
    H, hd = _heads(cfg)
    pd = cfg.tparam_dtype
    return {
        "mu": torch.full((L, 5, d), 0.5, device=dev),   # r,k,v,g,w lerps
        "w0": torch.full((L, d), -6.0, device=dev),
        "wA": dense_init(gen, (L, d, _W_LORA), pd, scale=0.01),
        "wB": dense_init(gen, (L, _W_LORA, d), pd, scale=0.01),
        "Wr": dense_init(gen, (L, d, d), pd),
        "Wk": dense_init(gen, (L, d, d), pd),
        "Wv": dense_init(gen, (L, d, d), pd),
        "Wg": dense_init(gen, (L, d, d), pd),
        "Wo": dense_init(gen, (L, d, d), pd),
        "u": randn(gen, (L, H, hd)) * 0.1,
        "ln_scale": torch.ones((L, d), device=dev),
    }


def _mix(x, x_prev, mu):
    return x + (x_prev - x) * mu


def tp_keep(cfg: ModelConfig, specs, mp: int, mor_active: bool) -> dict:
    """The block's leaves whose ``model`` splits the tensor-parallel
    forms consume, each with the dim it consumes it on: the time mix's
    ``Wr``, ``Wk``, ``Wv``, ``Wg`` and ``wB`` by column (dim -1) where
    its heads divide over ``mp`` (rwkv6-3b's 40 heads do not over 16:
    its time mix then stays gathered whole), the channel mix's ``w_up``
    by column and ``w_down`` by row unless a MoR plan runs on a d_ff
    that does not divide over ``mp`` in whole tiles (``mlp.mor_whole``:
    rwkv6-3b's 8,960 columns over 16).  Only ``"fsdp_tp"``'s splits are
    consumed: under ``"contract_tp"`` (the time mix's projections split
    on their input dim) the block is gathered whole."""
    from repro_torch.models.layers.mlp import mor_whole
    if mp == 1 or not isinstance(specs, dict):
        return {}
    keep = {}
    tm = ("Wr", "Wk", "Wv", "Wg", "wB")
    if _heads(cfg)[0] % mp == 0 and all(sr.on_model(specs["tm"], k, -1)
                                        for k in tm):
        keep.update({"tm/" + k: -1 for k in tm})
    if not mor_whole(cfg, mp, mor_active) and \
            sr.on_model(specs["cm"], "w_up", -1) and \
            sr.on_model(specs["cm"], "w_down", -2):
        keep.update({"cm/w_up": -1, "cm/w_down": -2})
    return keep


def _tp_local(params, group):
    """The time mix's params as the rank's heads use them: the column
    blocks as they are, ``mu`` / ``wA`` whole (their gradients summed),
    the rank's slices of ``w0``, ``u``, ``ln_scale`` and rows of the
    gathered ``Wo``."""
    out = dict(params)
    for k in ("mu", "wA"):
        out[k] = sr.tp_shared(params[k], group)
    for k in ("w0", "u", "ln_scale", "Wo"):
        out[k] = sr.tp_slice(params[k], 0, group)
    return out


def _timemix_inputs(params, cfg: ModelConfig, x, x_prev):
    """x, x_prev: (..., d) current and token-shifted activations ->
    (r, k, v (..., H, hd) in x's dtype, g (..., d) float32, w (..., H,
    hd) float32 decays)."""
    lead = x.shape[:-1]
    hd = cfg.rwkv_head_size
    dt = x.dtype
    mu = params["mu"].to(dt)
    xr, xk, xv, xg, xw = (_mix(x, x_prev, mu[i]) for i in range(5))
    r = (xr @ params["Wr"].to(dt)).reshape(*lead, -1, hd)
    k = (xk @ params["Wk"].to(dt)).reshape(*lead, -1, hd)
    v = (xv @ params["Wv"].to(dt)).reshape(*lead, -1, hd)
    g = F.silu((xg @ params["Wg"].to(dt)).float())
    # Finch data-dependent decay: w = exp(-exp(w0 + tanh(xw A) B))
    dd = torch.tanh(xw @ params["wA"].to(dt)) @ params["wB"].to(dt)
    w = torch.exp(-torch.exp(params["w0"] + dd.float()))
    return r, k, v, g, w.reshape(*lead, -1, hd)


def _group_norm(y, scale, eps: float = 1e-6):
    """Per-head rmsnorm, then flatten; y: (..., H, hd)."""
    r = torch.reciprocal(torch.sqrt(torch.mean(y * y, -1, keepdim=True)
                                    + eps))
    return (y * r).reshape(*y.shape[:-2], -1) * scale


def _wkv6_chunked(r, k, v, w, u, chunk: int = 8, initial_state=None,
                  return_state: bool = False):
    """GLA-style chunked-parallel wkv6 (``repro.models.layers.rwkv.
    _wkv6_chunked``).  With per-channel decay w_t and A_t the exclusive
    cumsum of log w within a chunk, the intra-chunk term factorises into
    (r_t e^{A_t}) . (k_j e^{-A_j - log w_j}) over j < t, the current
    token enters through the bonus u, and a float32 (B, H, hd, hd) state
    carries across chunks.  log w is clamped to [-10, 0] so that the
    factored exponentials stay finite (|A| <= 80 in a chunk of 8).

    r, k, v, w: (B, S, H, hd); u (H, hd) -> y (B, S, H, hd) float32 (and
    the state after the last position with ``return_state``)."""
    B, S, H, hd = r.shape
    C = min(chunk, S)
    pad = (-S) % C
    if pad:
        z = (0, 0, 0, 0, 0, pad)
        r, k, v = F.pad(r, z), F.pad(k, z), F.pad(v, z)
        w = F.pad(w, z, value=1.0)
    nc = (S + pad) // C
    rc = r.reshape(B, nc, C, H, hd).float()
    kc = k.reshape(B, nc, C, H, hd).float()
    vc = v.reshape(B, nc, C, H, hd).float()
    logw = torch.log(torch.clamp(w.reshape(B, nc, C, H, hd).float(),
                                 min=_W_MIN, max=1.0))
    A = torch.cumsum(logw, dim=2) - logw              # exclusive cumsum
    r_sc = rc * torch.exp(A)
    k_sc = kc * torch.exp(-A - logw)
    scores = torch.einsum("bcthk,bcjhk->bchtj", r_sc, k_sc)
    tri = torch.tril(torch.ones((C, C), dtype=torch.bool, device=r.device),
                     diagonal=-1)
    scores = torch.where(tri, scores, 0.0)
    y_intra = torch.einsum("bchtj,bcjhv->bcthv", scores, vc)
    # current-token bonus
    y_intra = y_intra + (rc * kc * u).sum(-1, keepdim=True) * vc
    # inter-chunk: carry S (B, H, hd, hd) across chunks
    last = A[:, :, -1:] + logw[:, :, -1:]
    decay_end = torch.exp(last[:, :, 0])              # (B, nc, H, hd)
    S_local = torch.einsum("bcjhk,bcjhv->bchkv",
                           kc * torch.exp(last - A - logw), vc)
    S_state = (torch.zeros((B, H, hd, hd), dtype=torch.float32,
                           device=r.device)
               if initial_state is None else initial_state)
    prevs = []
    for c in range(nc):
        prevs.append(S_state)
        S_state = S_state * decay_end[:, c, ..., None] + S_local[:, c]
    S_prevs = torch.stack(prevs, 1)                   # (B, nc, H, hd, hd)
    y_inter = torch.einsum("bcthk,bchkv->bcthv", r_sc, S_prevs)
    y = (y_intra + y_inter).reshape(B, nc * C, H, hd)[:, :S]
    if return_state:
        return y, S_state
    return y


def _wkv6_serial(r, k, v, w, u, S_state):
    """The recurrence one position at a time from ``S_state`` (B, H, hd,
    hd) float32: y_t = r_t (S + u k_t v_t^T), S <- w_t S + k_t v_t^T.
    r, k, v, w: (B, T, H, hd) -> (y (B, T, H, hd) float32, the state
    after the last position)."""
    ys = []
    for t in range(r.shape[1]):
        kv = torch.einsum("bhk,bhv->bhkv", k[:, t].float(), v[:, t].float())
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t].float(),
                               S_state + u[None, :, :, None] * kv))
        S_state = w[:, t].float()[..., None] * S_state + kv
    return torch.stack(ys, 1), S_state


def timemix_forward(params: Dict, cfg: ModelConfig, x, *,
                    chunked: bool = True) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d), the wkv from a zero state: chunked
    (``_wkv6_chunked``), or the serial scan over chunks of
    ``SERIAL_CHUNK`` positions, each recomputed in the backward (the
    reference's ``jax.checkpoint`` a chunk: one carry saved a chunk).
    On a tensor-parallel layer x holds every row (the region is entered
    here) and the output is the sum over ``model`` (this rank's S rows of
    it under sequence parallelism: ``sharding_rules.tp_exit``)."""
    dt = x.dtype
    group = sr.split_group(params["Wr"])
    if group is not None:
        x = sr.tp_enter(x, group)
        params = _tp_local(params, group)
    x_prev = F.pad(x, (0, 0, 1, 0))[:, :-1]
    r, k, v, g, w = _timemix_inputs(params, cfg, x, x_prev)
    if chunked:
        y = _wkv6_chunked(r, k, v, w, params["u"])
    else:
        B, S, H, hd = r.shape
        chunk = _remat(_wkv6_serial, "nothing_saveable")
        S_state = torch.zeros((B, H, hd, hd), dtype=torch.float32,
                              device=x.device)
        ys = []
        for lo in range(0, S, SERIAL_CHUNK):
            sl = slice(lo, lo + SERIAL_CHUNK)
            y, S_state = chunk(r[:, sl], k[:, sl], v[:, sl], w[:, sl],
                               params["u"], S_state)
            ys.append(y)
        y = torch.cat(ys, 1)
    y = _group_norm(y, params["ln_scale"]) * g
    out = y.to(dt) @ params["Wo"].to(dt)
    return out if group is None else sr.tp_exit(out, group, 1)


def timemix_chunk(params: Dict, cfg: ModelConfig, x, shift0, wkv0,
                  valid) -> Tuple:
    """State-carrying chunk: x (B, C, d) continues from ``shift0`` (B, d)
    token-shift state and ``wkv0`` (B, H, hd, hd) wkv state; ``valid``
    (B, C) marks the valid prefix of each row.  Invalid positions are
    identity updates on the state (k -> 0, w -> 1), so the returned state
    is the state after exactly the valid tokens.  -> (y (B, C, d),
    shift_new, wkv_new)."""
    dt = x.dtype
    x_prev = torch.cat([shift0[:, None, :].to(dt), x[:, :-1]], 1)
    r, k, v, g, w = _timemix_inputs(params, cfg, x, x_prev)
    vm = valid[:, :, None, None]
    k = torch.where(vm, k, torch.zeros((), dtype=k.dtype, device=k.device))
    w = torch.where(vm, w, 1.0)
    y, S_last = _wkv6_chunked(r, k, v, w, params["u"], initial_state=wkv0,
                              return_state=True)
    y = _group_norm(y, params["ln_scale"]) * g
    y = y.to(dt) @ params["Wo"].to(dt)
    nv = valid.sum(1)
    last = torch.clamp(nv - 1, min=0)
    x_last = torch.gather(x, 1, last[:, None, None].expand(
        -1, 1, x.shape[-1]))[:, 0]
    shift_new = torch.where((nv > 0)[:, None], x_last, shift0.to(dt))
    return y, shift_new, S_last


def timemix_decode(params: Dict, cfg: ModelConfig, x, state) -> Tuple:
    """x: (B, d); state: {"shift": (B, d), "wkv": (B, H, hd, hd)} ->
    (y (B, d), new state)."""
    dt = x.dtype
    r, k, v, g, w = _timemix_inputs(params, cfg, x,
                                    state["shift"].to(dt))
    u = params["u"]
    kv = torch.einsum("bhk,bhv->bhkv", k.float(), v.float())
    y = torch.einsum("bhk,bhkv->bhv", r.float(),
                     state["wkv"] + u[None, :, :, None] * kv)
    wkv = w.float()[..., None] * state["wkv"] + kv
    y = _group_norm(y, params["ln_scale"]) * g
    out = y.to(dt) @ params["Wo"].to(dt)
    return out, {"shift": x, "wkv": wkv}


# --- channel mix (ReLU^2: a native MoR target) -------------------------------

def chanmix_init(gen: torch.Generator, cfg: ModelConfig,
                 n_layers: int) -> Dict[str, torch.Tensor]:
    d, f, L = cfg.d_model, cfg.d_ff, n_layers
    pd = cfg.tparam_dtype
    return {
        "mu": torch.full((L, 2, d), 0.5, device=gen.device),   # k, r lerps
        "w_up": dense_init(gen, (L, d, f), pd),
        "w_down": dense_init(gen, (L, f, d), pd),
        "Wr": dense_init(gen, (L, d, d), pd),
    }


def chanmix_forward(params: Dict, cfg: ModelConfig, x, x_prev, *,
                    mor=None, mor_mode: str = "dense") -> Tuple:
    """x, x_prev: (..., d).  The ReLU^2 channel mix with the MoR hook:
    the up projection goes through the plan (kernel mode:
    ``mor_tile_mask`` then ``gather_matmul``); the down projection stays
    a plain product, as in the JAX package.  On a tensor-parallel layer:
    the rank's ``w_up`` columns (through the rank's plan where one is
    active) and ``w_down`` rows on the entered input, summed over
    ``model`` (this rank's S rows under sequence parallelism), then
    gated by the whole ``Wr``'s gate.  -> (y, mor_stats)."""
    from repro_torch.core.executor import as_plan
    dt = x.dtype
    plan = as_plan(mor, mode=mor_mode, tile_m=cfg.mor.tile_m,
                   tile_n=cfg.mor.tile_n, capacity_frac=cfg.mor.capacity)
    group = sr.split_group(params["w_down"])
    if group is not None:
        return _chanmix_tp(params, x, x_prev, group,
                           plan.for_rank(group) if plan.active else None)
    mu = params["mu"].to(dt)
    xk = _mix(x, x_prev, mu[0])
    xr = _mix(x, x_prev, mu[1])
    gate = torch.sigmoid((xr @ params["Wr"].to(dt)).float())
    stats: Dict = {}
    if plan.active:
        lead = xk.shape[:-1]
        h, stats = plan.relu_matmul(xk.reshape(-1, xk.shape[-1]),
                                    params["w_up"].to(dt),
                                    activation="relu2")
        h = h.reshape(*lead, -1)
    else:
        h = torch.square(F.relu(xk @ params["w_up"].to(dt)))
    y = gate.to(dt) * (h.to(dt) @ params["w_down"].to(dt))
    return y, stats


def _chanmix_tp(params: Dict, x, x_prev, group, plan=None) -> Tuple:
    """The tensor-parallel channel mix: x, x_prev (B, S, d) every row.
    The gate is the replicated region (its whole weights through
    ``tp_weight``), on this rank's rows under sequence parallelism
    (``seq_rows``); x and x_prev enter the region together (one
    collective in the backward).  ``plan``: the rank's MoR plan, or
    None.  -> (y, mor_stats)."""
    dt = x.dtype
    mu = sr.tp_weight(params["mu"], group).to(dt)
    xr = _mix(sr.seq_rows(x), sr.seq_rows(x_prev), mu[1])
    gate = torch.sigmoid((xr @ sr.tp_weight(params["Wr"], group).to(dt))
                         .float())
    xf, xpf = sr.tp_enter(torch.stack([x, x_prev]), group).unbind(0)
    xk = _mix(xf, xpf, sr.tp_shared(params["mu"], group).to(dt)[0])
    stats: Dict = {}
    if plan is not None:
        h, stats = plan.relu_matmul(xk.reshape(-1, xk.shape[-1]),
                                    params["w_up"].to(dt),
                                    activation="relu2")
        h = h.reshape(*xk.shape[:-1], -1)
    else:
        h = torch.square(F.relu(xk @ params["w_up"].to(dt)))
    y = sr.tp_exit(h.to(dt) @ params["w_down"].to(dt), group, x.ndim - 2)
    return gate.to(dt) * y, stats


def chanmix_taps(params: Dict, x, x_prev) -> Dict:
    """Calibration taps of the channel mix's ReLU^2 pre-activation (the
    up projection of the k-lerped input)."""
    from repro_torch.core.predictor import binary_preact
    xk = x + (x_prev - x) * params["mu"][0].to(x.dtype)
    x2 = xk.reshape(-1, xk.shape[-1])
    w = params["w_up"]
    return {"p_bin": binary_preact(x2, w),
            "p_base": (x2 @ w.to(x2.dtype)).float()}
