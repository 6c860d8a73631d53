"""The paper's CNN benchmarks (``repro.models.cnn``): CNN10 / Darknet19
(conv-BN-ReLU stacks, Fig. 2b) and ResNet18 (conv-BN-ReLU + residual,
Fig. 2c).

Activations are NHWC and weights HWIO, as in the JAX package.  Batch
norm is functional: train mode uses the batch statistics (population
variance) and returns updated running stats; eval mode uses the running
stats, which is what MoR's BN folding consumes (scale = gamma / sigma,
bias = beta - mu * gamma / sigma, paper §3.2.1).

A conv output channel is a neuron whose weight vector is the flattened
(kh * kw * cin) filter; the binary rookie is the conv of sign tensors.
Two paddings meet here, both as the reference has them:

- the conv pads as XLA's "SAME" does: at stride 2 on an even input that
  is (0, 1), not (1, 1);
- the predictor's ``_im2col`` pads (k - 1) // 2 on both sides, so on a
  stride-2 layer its patches sit one pixel off the conv it predicts, and
  a padded x = 0 binarises to -1, where the calibration taps' sign conv
  pads with 0.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.predictor import binarize, binarize_act
from repro_torch.models.layers.common import randn

_BN_MOMENTUM = 0.9
_BN_EPS = 1e-5
_KERNEL = 3


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA "SAME": out = ceil(size / stride), the total pad split with
    the extra pixel at the end."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """NHWC x, HWIO w -> NHWC, padded as XLA's "SAME"."""
    kh, kw = w.shape[:2]
    ph, pw = _same_pads(x.shape[1], kh, stride), _same_pads(x.shape[2], kw,
                                                            stride)
    xn = F.pad(x.permute(0, 3, 1, 2), (pw[0], pw[1], ph[0], ph[1]))
    out = F.conv2d(xn, w.permute(3, 2, 0, 1), stride=stride)
    return out.permute(0, 2, 3, 1)


def _bn_apply(p: Dict, s: Dict, x: torch.Tensor, train: bool
              ) -> Tuple[torch.Tensor, Dict]:
    if train:
        mu = x.mean((0, 1, 2))
        var = x.var((0, 1, 2), correction=0)
        new_s = {"mu": _BN_MOMENTUM * s["mu"] + (1 - _BN_MOMENTUM) * mu,
                 "var": _BN_MOMENTUM * s["var"] + (1 - _BN_MOMENTUM) * var}
    else:
        mu, var = s["mu"], s["var"]
        new_s = s
    inv = torch.rsqrt(var + _BN_EPS)
    return (x - mu) * inv * p["gamma"] + p["beta"], new_s


def bn_fold(p: Dict, s: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (scale, bias) s.t. relu_input = preact * scale + bias."""
    inv = torch.rsqrt(s["var"] + _BN_EPS)
    return p["gamma"] * inv, p["beta"] - s["mu"] * p["gamma"] * inv


def _strides(cfg: ModelConfig) -> List[int]:
    """Downsample (stride 2) whenever the channel count grows."""
    ch = cfg.cnn_channels
    return [2 if ch[i + 1] > ch[i] and i > 0 else 1
            for i in range(len(ch) - 1)]


def init_params(gen: torch.Generator, cfg: ModelConfig) -> Dict:
    """Random weights from ``gen`` on ``gen.device``: per layer an HWIO
    filter of std (k * k * cin)^-1/2 (and BN gamma 1, beta 0), then the
    (C, classes) head."""
    ch = cfg.cnn_channels
    dev = gen.device
    layers = []
    for i in range(len(ch) - 1):
        w = randn(gen, (_KERNEL, _KERNEL, ch[i], ch[i + 1])) \
            * (_KERNEL * _KERNEL * ch[i]) ** -0.5
        p: Dict[str, Any] = {"w": w}
        if cfg.batchnorm:
            p["bn"] = {"gamma": torch.ones(ch[i + 1], device=dev),
                       "beta": torch.zeros(ch[i + 1], device=dev)}
        layers.append(p)
    head = randn(gen, (ch[-1], cfg.cnn_num_classes)) * ch[-1] ** -0.5
    return {"layers": layers, "head": head}


def init_state(cfg: ModelConfig, device="cuda") -> Dict:
    """BN running stats: mu 0, var 1 per layer."""
    return {"bn": [{"mu": torch.zeros(c, device=device),
                    "var": torch.ones(c, device=device)}
                   for c in cfg.cnn_channels[1:]]}


def conv_layer(lp: Dict, s: Dict, cfg: ModelConfig, x: torch.Tensor,
               stride: int, shortcut: Optional[torch.Tensor], *,
               train: bool = False, with_taps: bool = False, mor=None,
               mor_mode: str = "dense") -> Dict[str, Any]:
    """One conv-BN-(+shortcut)-ReLU layer on NHWC ``x``.  ``shortcut`` is
    added to the ReLU input when it is given and has the conv output's
    shape.  -> {"y", "bn" (new running stats), "pre" (the conv output),
    "relu_in", "res_in", "tap" (with_taps), "computed" (the predictor's
    neuron mask in permuted column order, under an active MoR plan)}."""
    pre = _conv(x, lp["w"], stride)
    res_in = (shortcut if shortcut is not None
              and shortcut.shape == pre.shape else None)
    if cfg.batchnorm:
        pre_bn, s_new = _bn_apply(lp["bn"], s, pre, train)
    else:
        pre_bn, s_new = pre, s
    relu_in = pre_bn + res_in if res_in is not None else pre_bn
    out: Dict[str, Any] = {"bn": s_new, "pre": pre, "relu_in": relu_in,
                           "res_in": res_in, "computed": None}
    C = pre.shape[-1]
    if with_taps:
        # the sign conv over zero padding: a pad contributes 0
        p_bin = _conv(binarize_act(x).to(x.dtype),
                      binarize(lp["w"]).to(x.dtype), stride)
        out["tap"] = {"p_bin": p_bin.reshape(-1, C),
                      "p_base": pre.reshape(-1, C).float(),
                      "relu_in": relu_in.reshape(-1, C).float()}
    if mor is not None and mor_mode != "dense":
        from repro_torch.core.executor import as_plan
        plan = as_plan(mor, mode=mor_mode, tile_m=cfg.mor.tile_m,
                       tile_n=cfg.mor.tile_n)
        perm = plan.mor["perm"].long()
        B, H, W, _ = pre.shape
        res_flat = None if res_in is None else res_in.reshape(-1, C)[:, perm]
        # ONE predictor pass on the true pre-activations: the conv is
        # already computed, so conv layers always evaluate exact-style
        # (no kernel branch in any mode)
        computed = plan.predict(
            _im2col(x, lp["w"].shape[0], stride),
            _wmat(lp["w"])[:, perm],
            preact_full=pre.reshape(-1, C)[:, perm],
            residual=res_flat).computed
        y = torch.where(computed, F.relu(relu_in.reshape(-1, C)[:, perm]),
                        0.0)
        out["y"] = y[:, plan.mor["inv_perm"].long()].reshape(B, H, W, C)
        out["computed"] = computed
    else:
        out["y"] = F.relu(relu_in)
    return out


def forward(params: Dict, state: Dict, cfg: ModelConfig,
            images: torch.Tensor, *, train: bool = False,
            with_taps: bool = False, mor: Optional[List] = None,
            mor_mode: str = "dense") -> Tuple[torch.Tensor, Dict, Dict]:
    """NHWC images -> (logits, new_state, aux).  aux["taps"][i] are the
    calibration taps of conv layer i; aux["mor_stats"][i] holds its
    frac_computed under an active MoR plan."""
    x = images
    strides = _strides(cfg)
    new_bn: List[Dict] = []
    taps: List[Dict] = []
    mstats: List[Dict] = []
    shortcut = None
    for i, lp in enumerate(params["layers"]):
        mor_i = None if mor is None else mor[i]
        r = conv_layer(lp, state["bn"][i], cfg, x, strides[i],
                       shortcut if cfg.residual and i % 2 == 1 else None,
                       train=train, with_taps=with_taps, mor=mor_i,
                       mor_mode=mor_mode)
        new_bn.append(r["bn"])
        if with_taps:
            taps.append(r["tap"])
        if r["computed"] is not None:
            mstats.append({"frac_computed": r["computed"].float().mean()})
        x = r["y"]
        if cfg.residual and i % 2 == 0:
            shortcut = x
    logits = x.mean((1, 2)) @ params["head"]
    aux: Dict[str, Any] = {}
    if with_taps:
        aux["taps"] = taps
    if mstats:
        aux["mor_stats"] = mstats
    return logits, {"bn": new_bn}, aux


def _wmat(w: torch.Tensor) -> torch.Tensor:
    """(kh, kw, cin, cout) -> (kh * kw * cin, cout) neuron weight matrix."""
    return w.reshape(-1, w.shape[-1])


def _im2col(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """NHWC -> (B * H' * W', k * k * C) patches, (di, dj) major and C
    minor as ``_wmat`` flattens, over a (k - 1) // 2 pad on both sides."""
    B, H, W, C = x.shape
    pad = (k - 1) // 2
    xp = F.pad(x, (0, 0, pad, pad, pad, pad))
    Ho, Wo = -(-H // stride), -(-W // stride)
    cols = torch.cat([xp[:, di:di + H:stride, dj:dj + W:stride, :]
                      for di in range(k) for dj in range(k)], dim=-1)
    return cols.reshape(B * Ho * Wo, k * k * C)


def layer_weight_matrices(params: Dict) -> List[torch.Tensor]:
    """Per-conv-layer (K, N) matrices for clustering and calibration."""
    return [_wmat(lp["w"]) for lp in params["layers"]]
