"""Time-Depth-Separable ASR network (``repro.models.tds``; paper §3.1
Fig. 2a, Hannun et al.): per block a causal 1-D conv over time with ReLU
+ residual + layernorm, then a two-layer FC bottleneck with ReLU +
residual + layernorm.  The FC1 ReLU layers are the MoR targets: in
``kernel`` mode each runs ``mor_tile_mask`` and ``gather_matmul`` once.

Inputs are audio frames (B, T, d).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.predictor import binarize, binarize_act, binary_preact
from repro_torch.models.layers.common import dense_init, randn
from repro_torch.models.layers.norms import apply_norm, norm_init

_KERNEL = 5


def init_params(gen: torch.Generator, cfg: ModelConfig) -> Dict:
    """Random weights from ``gen`` on ``gen.device``, a list of per-block
    dicts in the JAX package's layout."""
    d, f = cfg.d_model, cfg.d_ff
    dev = gen.device
    layers = []
    for _ in range(cfg.n_layers):
        layers.append({
            "conv_w": randn(gen, (_KERNEL, d, d)) * (_KERNEL * d) ** -0.5,
            "conv_b": torch.zeros(d, device=dev),
            "ln1": norm_init("layernorm", d, dev),
            "fc1": dense_init(gen, (d, f)),
            "fc1_b": torch.zeros(f, device=dev),
            "fc2": dense_init(gen, (f, d)),
            "ln2": norm_init("layernorm", d, dev),
        })
    return {"layers": layers, "head": dense_init(gen, (d, cfg.vocab_size))}


def _conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
            ) -> torch.Tensor:
    """x (B, T, d), w (K, d, d): a causal conv over time (K - 1 zeros in
    front), summed tap by tap as the reference does."""
    T = x.shape[1]
    xp = F.pad(x, (0, 0, _KERNEL - 1, 0))
    out = xp[:, 0:T, :] @ w[0]
    for i in range(1, _KERNEL):
        out = out + xp[:, i:i + T, :] @ w[i]
    return out + b


def block(lp: Dict, cfg: ModelConfig, x: torch.Tensor, *,
          with_taps: bool = False, mor=None, mor_mode: str = "dense"
          ) -> Dict[str, Any]:
    """One TDS block on (B, T, d) frames.  -> {"y", "taps" (the conv tap,
    then the FC tap when FC1 runs dense), "fc_in" ((B * T, d), FC1's
    input), "stats" (FC1's MoR stats under an active plan, else None)}."""
    out: Dict[str, Any] = {"taps": [], "stats": None}
    # --- conv sub-block ---
    pre = _conv1d(x, lp["conv_w"], lp["conv_b"])
    if with_taps:
        p_bin = _conv1d(binarize_act(x), binarize(lp["conv_w"]).to(x.dtype),
                        torch.zeros_like(lp["conv_b"]))
        flat = pre.reshape(-1, pre.shape[-1])
        out["taps"].append({"p_bin": p_bin.reshape(-1, pre.shape[-1]),
                            "p_base": flat, "relu_in": flat})
    x = apply_norm("layernorm", lp["ln1"], x + F.relu(pre))
    # --- FC sub-block ---
    x2 = x.reshape(-1, x.shape[-1])
    out["fc_in"] = x2
    if mor is not None and mor_mode != "dense":
        from repro_torch.core.executor import as_plan
        plan = as_plan(mor, mode=mor_mode, tile_m=cfg.mor.tile_m,
                       tile_n=cfg.mor.tile_n,
                       capacity_frac=cfg.mor.capacity)
        perm = plan.mor["perm"].long()
        h, out["stats"] = plan.relu_matmul(x2, lp["fc1"][:, perm],
                                           activation="relu")
        fc = (h @ lp["fc2"][perm, :]).reshape(x.shape)
    else:
        pre_fc = x @ lp["fc1"] + lp["fc1_b"]
        if with_taps:
            out["taps"].append({
                "p_bin": binary_preact(x2, lp["fc1"]),
                "p_base": (x2 @ lp["fc1"]).float(),
                "relu_in": pre_fc.reshape(-1, pre_fc.shape[-1])})
        fc = F.relu(pre_fc) @ lp["fc2"]
    out["y"] = apply_norm("layernorm", lp["ln2"], x + fc)
    return out


def forward(params: Dict, cfg: ModelConfig, batch: Dict, *,
            with_taps: bool = False, mor: Optional[List] = None,
            mor_mode: str = "dense") -> Tuple[torch.Tensor, Dict]:
    """batch["frames"] (B, T, d) -> (logits (B, T, vocab), aux).
    aux["taps"] alternates conv and FC taps, block by block (an FC tap
    only where FC1 runs dense); aux["mor_stats"][i] is block i's FC1
    stats under an active MoR plan."""
    x = batch["frames"]
    taps: List[Dict] = []
    mstats: List[Dict] = []
    for i, lp in enumerate(params["layers"]):
        r = block(lp, cfg, x, with_taps=with_taps,
                  mor=None if mor is None else mor[i], mor_mode=mor_mode)
        taps.extend(r["taps"])
        if r["stats"] is not None:
            mstats.append(r["stats"])
        x = r["y"]
    logits = x @ params["head"]
    aux: Dict[str, Any] = {}
    if with_taps:
        aux["taps"] = taps
    if mstats:
        aux["mor_stats"] = mstats
    return logits, aux


def layer_weight_matrices(params: Dict) -> List[torch.Tensor]:
    """(K, N) weight matrices of the FC1 ReLU layers (the MoR targets)."""
    return [lp["fc1"] for lp in params["layers"]]
