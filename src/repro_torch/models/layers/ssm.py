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
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers.common import dense_init

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
        "conv_w": (torch.randn((L, _D_CONV, conv_ch), generator=gen,
                               device=dev) * 0.1).to(pd),
        "conv_b": torch.zeros((L, conv_ch), dtype=pd, device=dev),
        "A_log": torch.zeros((L, H), device=dev),
        "D": torch.ones((L, H), device=dev),
        "dt_bias": torch.zeros((L, H), device=dev),
        "norm_scale": torch.ones((L, d_in), device=dev),
        "out_proj": dense_init(gen, (L, d_in, d), pd),
    }


def _split_proj(zxbcdt, cfg: ModelConfig):
    d_in, H, P, N = _dims(cfg)
    return (zxbcdt[..., :d_in], zxbcdt[..., d_in:2 * d_in + 2 * N],
            zxbcdt[..., 2 * d_in + 2 * N:])


def _gated_norm(y, z, scale, eps: float = 1e-6):
    g = y * F.silu(z.float())
    r = torch.reciprocal(torch.sqrt(torch.mean(g * g, -1, keepdim=True)
                                    + eps))
    return g * r * scale


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
    Lm = torch.where(tri[:, :, None], torch.exp(rel), 0.0)
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
    d_in, H, P, N = _dims(cfg)
    xs = conv[..., :d_in].reshape(Bsz, S, H, P)
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
    """x: (B, S, d) -> (B, S, d) from a zero state."""
    Bsz, S, d = x.shape
    d_in, H, P, N = _dims(cfg)
    dt_ = x.dtype
    zxbcdt = x @ params["in_proj"].to(dt_)
    z, xBC, dtd = _split_proj(zxbcdt, cfg)
    hist = F.pad(xBC, (0, 0, _D_CONV - 1, 0))
    conv = _conv(hist, params, S, dt_)
    xs, B_, C_, loga, xbar = _ssd_inputs(params, cfg, conv, dtd)
    y, _ = _chunked(cfg, xbar, B_, C_, loga,
                    torch.zeros((Bsz, H, N, P), dtype=torch.float32,
                                device=x.device))
    y = y + params["D"][None, None, :, None] * xs
    y = _gated_norm(y.reshape(Bsz, S, d_in), z, params["norm_scale"])
    return y.to(dt_) @ params["out_proj"].to(dt_)


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
