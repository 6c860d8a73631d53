"""Mamba2 (SSD) layer (``repro.models.layers.ssm``): the chunked
state-space dual form for calibration and serving chunks, and an O(1)
recurrent decode step.

in_proj -> [z | xBC | dt], a causal depthwise conv over xBC, a per-head
scalar decay a_t = exp(-softplus(dt + bias) * exp(A_log)), the SSD
intra-chunk term plus a carried float32 state, a gated RMSNorm and
out_proj.  The reference's scans are jnp, so plain torch ops are their
port: there is no kernel here.  ``mamba2_init`` returns weights with a
leading layer dim of ``n_layers``; the other functions take one layer's
views.

Under a mesh whose layer loop left its leaves split over ``model``
(``tp_keep``: where the SSD heads divide) the forward runs by head.
The input enters the region once.  ``in_proj``'s split cuts the
concatenated [z | xBC | dt] columns (``"fsdp_tp"``) or its input rows
(``"contract_tp"``), and ``conv_w`` / ``conv_b``'s the channels,
mid-segment, so one all-to-all each hands every rank its heads' z, x
and dt columns (its x channels) and the B / C ones every head shares
(``_tp_local``, in place of gathering the leaf whole; the B / C
gradients are summed on their holders).  The
rank's SSD heads run with its slices of ``A_log``, ``D`` and
``dt_bias``; the gated RMSNorm over the whole ``d_in`` sums its
squares with one all-reduce of (B, S, 1)
(``collectives.all_reduce_partial``) before ``norm_scale``'s block, and
``out_proj`` by row closes the region (``sharding_rules.tp_exit``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives as co
from repro_torch.distributed import sharding_rules as sr
from repro_torch.models.layers.common import dense_init, randn

_D_CONV = 4


def _dims(cfg: ModelConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    H = d_in // cfg.ssm_head_dim
    return d_in, H, cfg.ssm_head_dim, cfg.ssm_state


def mamba2_init(gen: torch.Generator, cfg: ModelConfig,
                n_layers: int) -> Dict[str, torch.Tensor]:
    d, L, dev = cfg.d_model, n_layers, gen.device
    d_in, H, P, N = _dims(cfg)
    pd = cfg.tparam_dtype
    conv_ch = d_in + 2 * N
    return {
        "in_proj": dense_init(gen, (L, d, 2 * d_in + 2 * N + H), pd),
        "conv_w": (randn(gen, (L, _D_CONV, conv_ch)) * 0.1).to(pd),
        "conv_b": torch.zeros((L, conv_ch), dtype=pd, device=dev),
        "A_log": torch.zeros((L, H), device=dev),
        "D": torch.ones((L, H), device=dev),
        "dt_bias": torch.zeros((L, H), device=dev),
        "norm_scale": torch.ones((L, d_in), device=dev),
        "out_proj": dense_init(gen, (L, d_in, d), pd),
    }


_TP_LEAVES = ("in_proj", "conv_w", "conv_b", "norm_scale", "out_proj")


def tp_keep(cfg: ModelConfig, specs, mp: int, prefix: str = "mamba/"
            ) -> dict:
    """The Mamba2 leaves whose ``model`` splits the tensor-parallel form
    consumes, each with the dim it consumes it on, where the SSD heads
    divide over ``mp`` ranks and every leaf of ``_TP_LEAVES`` is split
    over ``model``; else none.  ``conv_w``, ``conv_b`` and
    ``norm_scale`` carry the same splits under both layouts (their
    channels).  ``out_proj`` is consumed by row (dim -2): ``"fsdp_tp"``
    splits it there, ``"contract_tp"`` on its output dim, and
    ``sharding_rules.use`` moves it.  ``in_proj`` stays where the layout
    put it (its columns under ``"fsdp_tp"``, its input rows under
    ``"contract_tp"``): ``_tp_local`` routes the rank's columns to it
    from either."""
    H = _dims(cfg)[1]
    if mp == 1 or not isinstance(specs, dict) or H % mp or any(
            sr.model_dim(specs, k) is None for k in _TP_LEAVES) or not all(
                sr.on_model(specs, k, -1) for k in _TP_LEAVES[1:4]):
        return {}
    keep = {k: -1 for k in _TP_LEAVES[1:4]}
    keep.update(in_proj=sr.model_dim(specs, "in_proj"), out_proj=-2)
    return {prefix + k: d for k, d in keep.items()}


def _tp_local(params, cfg: ModelConfig, group):
    """The layer's params as the rank's heads use them: ``in_proj``'s
    columns [z | x | B | C | dt] of its heads and the conv's channels
    [x | B | C], its slices of the per-head vectors; ``norm_scale`` and
    ``out_proj`` are its blocks already.

    The conv's channels are split evenly, as are ``in_proj``'s columns
    under ``"fsdp_tp"``, cutting the segments mid-way: one uneven
    all-to-all each (``collectives.regroup``) hands every rank the
    indices it needs from their holders.  Under ``"contract_tp"``
    ``in_proj`` arrives split by input row, every column on every rank
    (``in_proj[d_r, :]``): each rank cuts out the columns of every
    rank's heads, ``cols(q)``, side by side, and one even all-to-all
    (``collectives.all_to_all_dim``, counted as "model_move") hands rank
    q the d / MP rows of ``cols(q)`` from every rank, i.e.
    ``in_proj[:, cols(q)]``.  Its backward moves the gradients back, and
    the column selection's adds the B / C columns' over the ranks.  This
    one exchange moves (MP - 1) / MP x d x |cols| elements a rank, where
    |cols| = 2 d_in / MP + 2 N + H / MP; moving the split onto the
    columns first and regrouping after would move (MP - 1) / MP x d x
    (2 d_in + 2 N + H) / MP and then the columns of ``cols(r)`` outside
    the rank's even block: 1.5x to 2x as many at zamba2-7b's MP 16."""
    d_in, H, P, N = _dims(cfg)
    n = group.size
    dl, hl = d_in // n, H // n

    def spans(*ranges):
        return torch.cat([torch.arange(a, b) for a, b in ranges])

    def cols(q):                        # [z | x | B | C | dt] of q's heads
        dt0 = 2 * d_in + 2 * N
        return spans((q * dl, (q + 1) * dl),
                     (d_in + q * dl, d_in + (q + 1) * dl),
                     (2 * d_in, dt0), (dt0 + q * hl, dt0 + (q + 1) * hl))

    def chans(q):                       # [x | B | C]
        return spans((q * dl, (q + 1) * dl), (d_in, d_in + 2 * N))

    w = params["in_proj"]
    if sr.split_on(w) == -2:
        idx = torch.cat([cols(q) for q in range(n)]).to(w.device)
        w = co.all_to_all_dim(w.index_select(-1, idx), -1, -2, group,
                              "model_move")
    else:
        w = co.regroup(w, -1, cols, group)
    out = dict(params, in_proj=w)
    for k in ("conv_w", "conv_b"):
        out[k] = co.regroup(params[k], -1, chans, group)
    for k in ("A_log", "D", "dt_bias"):
        out[k] = sr.tp_slice(params[k], 0, group)
    return out


def _split_proj(zxbcdt, cfg: ModelConfig):
    """[z | xBC | dt] of the heads whose columns ``zxbcdt`` holds (all of
    them on one device)."""
    N = cfg.ssm_state
    dl = (zxbcdt.shape[-1] - 2 * N) * cfg.ssm_head_dim // (
        2 * cfg.ssm_head_dim + 1)
    return (zxbcdt[..., :dl], zxbcdt[..., dl:2 * dl + 2 * N],
            zxbcdt[..., 2 * dl + 2 * N:])


def _gated_norm(y, z, scale, group=None, eps: float = 1e-6):
    """RMSNorm of y * silu(z) over the whole d_in: on a tensor-parallel
    layer the rank's channels' sum of squares summed over ``group``."""
    g = y * F.silu(z.float())
    if group is None:
        ms = torch.mean(g * g, -1, keepdim=True)
    else:
        ms = co.all_reduce_partial(torch.sum(g * g, -1, keepdim=True),
                                   group) / (g.shape[-1] * group.size)
    return g * torch.reciprocal(torch.sqrt(ms + eps)) * scale


def _ssd(xbar, Bc, Cc, la, S0):
    """Chunked SSD core: xbar (B, nc, Q, H, P); Bc / Cc (B, nc, Q, N); la
    (B, nc, Q, H) log-decays; S0 (B, H, N, P) the initial state.  ->
    (y (B, nc, Q, H, P), S_last): S_last is the state after the final
    position, so chaining calls is exact (serving's chunked prefill)."""
    B, nc, Q, H, P = xbar.shape
    cum = torch.cumsum(la, dim=2)                         # (B, nc, Q, H)
    # intra-chunk (quadratic within the chunk)
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)      # shared by heads
    rel = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B, nc, i, j, H)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                device=xbar.device))
    # masked before the exponential: above the diagonal rel is a sum of
    # positive decays (past 88 at zamba2's chunk of 256, float32's exp
    # overflows), and the reference's where(tri, exp(rel), 0) has the same
    # forward but a NaN gradient there (0 x inf)
    Lm = torch.exp(torch.where(tri[:, :, None], rel, float("-inf")))
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", scores[..., None] * Lm,
                           xbar)
    # inter-chunk state carry
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)     # (B, nc, Q, H)
    S_local = torch.einsum("bcjn,bcjhp->bchnp", Bc,
                           decay_to_end[..., None] * xbar)
    chunk_decay = torch.exp(cum[:, :, -1, :])             # (B, nc, H)
    S_state, prevs = S0, []
    for c in range(nc):
        prevs.append(S_state)
        S_state = S_state * chunk_decay[:, c, :, None, None] + S_local[:, c]
    S_prevs = torch.stack(prevs, 1)                       # (B, nc, H, N, P)
    y_inter = torch.einsum("bcin,bchnp->bcihp", Cc, S_prevs) * \
        torch.exp(cum)[..., None]
    return y_intra + y_inter, S_state


def _conv(hist, params, C: int, dt):
    """The causal depthwise conv of width 4 over ``hist`` (B, C + 3, ch)
    -> (B, C, ch) float32, SiLU applied."""
    conv = sum(hist[:, i:i + C, :] * params["conv_w"][i].to(dt)
               for i in range(_D_CONV)) + params["conv_b"].to(dt)
    return F.silu(conv.float())


def _ssd_inputs(params, cfg: ModelConfig, conv, dtd):
    """conv (B, S, ch) float32, dtd (B, S, H) -> (xs (B, S, H, P), B_,
    C_ (B, S, N) float32, log-decay (B, S, H), xbar (B, S, H, P))."""
    Bsz, S = conv.shape[:2]
    P, N = cfg.ssm_head_dim, cfg.ssm_state
    d_in = conv.shape[-1] - 2 * N
    xs = conv[..., :d_in].reshape(Bsz, S, -1, P)
    B_ = conv[..., d_in:d_in + N]
    C_ = conv[..., d_in + N:]
    dt_soft = F.softplus(dtd.float() + params["dt_bias"])
    loga = -dt_soft * torch.exp(params["A_log"])          # (B, S, H) <= 0
    xbar = xs * dt_soft[..., None]                        # dt-scaled input
    return xs, B_, C_, loga, xbar


def _chunked(cfg: ModelConfig, xbar, B_, C_, loga, S0):
    """Pad S to the SSD chunk, run ``_ssd`` -> (y (B, S, H, P), S_last)."""
    Bsz, S, H, P = xbar.shape
    N = B_.shape[-1]
    Q = min(cfg.ssm_chunk, S)
    pad = (-S) % Q
    if pad:
        xbar = F.pad(xbar, (0, 0, 0, 0, 0, pad))
        B_ = F.pad(B_, (0, 0, 0, pad))
        C_ = F.pad(C_, (0, 0, 0, pad))
        loga = F.pad(loga, (0, 0, 0, pad))
    nc = (S + pad) // Q
    y, S_last = _ssd(xbar.reshape(Bsz, nc, Q, H, P),
                     B_.reshape(Bsz, nc, Q, N), C_.reshape(Bsz, nc, Q, N),
                     loga.reshape(Bsz, nc, Q, H), S0)
    return y.reshape(Bsz, S + pad, H, P)[:, :S], S_last


def mamba2_forward(params: Dict, cfg: ModelConfig, x) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d) from a zero state.  On a
    tensor-parallel layer x holds every row (the region is entered here)
    and the output is the sum over ``model`` of the rank's heads' (this
    rank's S rows of it under sequence parallelism)."""
    Bsz, S, d = x.shape
    P, N = cfg.ssm_head_dim, cfg.ssm_state
    dt_ = x.dtype
    group = sr.split_group(params["out_proj"])
    if group is not None:
        x = sr.tp_enter(x, group)
        params = _tp_local(params, cfg, group)
    zxbcdt = x @ params["in_proj"].to(dt_)
    z, xBC, dtd = _split_proj(zxbcdt, cfg)
    hist = F.pad(xBC, (0, 0, _D_CONV - 1, 0))
    conv = _conv(hist, params, S, dt_)
    xs, B_, C_, loga, xbar = _ssd_inputs(params, cfg, conv, dtd)
    H = xs.shape[2]
    y, _ = _chunked(cfg, xbar, B_, C_, loga,
                    torch.zeros((Bsz, H, N, P), dtype=torch.float32,
                                device=x.device))
    y = y + params["D"][None, None, :, None] * xs
    y = _gated_norm(y.reshape(Bsz, S, H * P), z, params["norm_scale"],
                    group)
    out = y.to(dt_) @ params["out_proj"].to(dt_)
    return out if group is None else sr.tp_exit(out, group, 1)


def mamba2_cache_init(cfg: ModelConfig, batch: int, n_layers: int, dtype,
                      device) -> Dict[str, torch.Tensor]:
    """Layer-stacked state: the conv history (L, B, 3, ch) in the model's
    dtype and the SSD state (L, B, H, N, P) float32."""
    d_in, H, P, N = _dims(cfg)
    return {
        "conv": torch.zeros((n_layers, batch, _D_CONV - 1, d_in + 2 * N),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((n_layers, batch, H, N, P), dtype=torch.float32,
                           device=device),
    }


def mamba2_chunk(params: Dict, cfg: ModelConfig, x, cache, valid
                 ) -> Tuple[torch.Tensor, Dict]:
    """State-carrying chunk: x (B, C, d) continues from ``cache`` ({conv
    (B, 3, ch), ssm (B, H, N, P)}); ``valid`` (B, C) marks the real-token
    prefix of each row.  Invalid positions contribute nothing to the SSD
    state (xbar -> 0, log-decay -> 0) and the conv history advances by
    exactly the valid count, so chaining chunks equals one long forward.
    -> (y (B, C, d), new state)."""
    Bsz, C, d = x.shape
    d_in, H, P, N = _dims(cfg)
    dt_ = x.dtype
    zxbcdt = x @ params["in_proj"].to(dt_)
    z, xBC, dtd = _split_proj(zxbcdt, cfg)
    hist = torch.cat([cache["conv"].to(dt_), xBC], 1)    # (B, C + 3, ch)
    conv = _conv(hist, params, C, dt_)
    xs, B_, C_, loga, xbar = _ssd_inputs(params, cfg, conv, dtd)
    xbar = torch.where(valid[:, :, None, None], xbar, 0.0)
    loga = torch.where(valid[:, :, None], loga, 0.0)
    y, S_last = _chunked(cfg, xbar, B_, C_, loga, cache["ssm"])
    y = y + params["D"][None, None, :, None] * xs
    y = _gated_norm(y.reshape(Bsz, C, d_in), z, params["norm_scale"])
    out = y.to(dt_) @ params["out_proj"].to(dt_)
    # the conv history = the last 3 VALID inputs: rows [n_valid,
    # n_valid + 3) of the (history ++ chunk) concatenation
    nv = valid.sum(1)
    idx = nv[:, None] + torch.arange(_D_CONV - 1, device=x.device)[None, :]
    conv_new = torch.gather(hist, 1, idx[:, :, None].expand(
        -1, -1, hist.shape[-1]))
    return out, {"conv": conv_new.to(cache["conv"].dtype), "ssm": S_last}


def mamba2_decode(params: Dict, cfg: ModelConfig, x, cache
                  ) -> Tuple[torch.Tensor, Dict]:
    """x: (B, 1, d), one step -> (y (B, 1, d), new state)."""
    Bsz = x.shape[0]
    d_in, H, P, N = _dims(cfg)
    dt_ = x.dtype
    zxbcdt = x[:, 0] @ params["in_proj"].to(dt_)
    z, xBC, dtd = _split_proj(zxbcdt, cfg)
    hist = torch.cat([cache["conv"], xBC[:, None, :]], 1)   # (B, 4, ch)
    conv = torch.einsum("bkc,kc->bc", hist.float(),
                        params["conv_w"].float()) + params["conv_b"].float()
    conv = F.silu(conv)
    xs = conv[:, :d_in].reshape(Bsz, H, P)
    B_ = conv[:, d_in:d_in + N]
    C_ = conv[:, d_in + N:]
    dt_soft = F.softplus(dtd.float() + params["dt_bias"])
    a = torch.exp(-dt_soft * torch.exp(params["A_log"]))    # (B, H)
    xbar = xs * dt_soft[..., None]
    S_new = cache["ssm"] * a[..., None, None] + \
        torch.einsum("bn,bhp->bhnp", B_, xbar)
    y = torch.einsum("bn,bhnp->bhp", C_, S_new) + \
        params["D"][None, :, None] * xs
    y = _gated_norm(y.reshape(Bsz, d_in), z, params["norm_scale"])
    out = (y.to(dt_) @ params["out_proj"].to(dt_))[:, None, :]
    return out, {"conv": hist[:, 1:], "ssm": S_new}
