"""Decoder LM assembly for the dense family (``repro.models.transformer``).

Parameters keep the JAX package's layer-stacked layout (every per-layer
leaf has a leading L dim, ``x @ w`` weights are (d_in, d_out)); the
layer loop is a Python loop over views of those stacks.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import attention as attn
from repro_torch.models.layers.common import dense_init, embed_init
from repro_torch.models.layers.mlp import mlp_apply, mlp_init, mlp_taps
from repro_torch.models.layers.norms import apply_norm, norm_init


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.mla:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}): only the dense GQA family is "
            f"ported so far")


def _stack_norm(cfg: ModelConfig, L: int, device) -> Dict:
    return {k: v[None].repeat(L, *([1] * v.ndim))
            for k, v in norm_init(cfg.norm, cfg.d_model, device).items()}


def init_params(gen: torch.Generator, cfg: ModelConfig) -> Dict:
    """Random weights from ``gen`` on ``gen.device``."""
    _check_family(cfg)
    L, dev = cfg.n_layers, gen.device
    params: Dict[str, Any] = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model,
                            cfg.tparam_dtype),
        "layers": {"ln1": _stack_norm(cfg, L, dev),
                   "attn": attn.gqa_init(gen, cfg, L),
                   "ln2": _stack_norm(cfg, L, dev),
                   "mlp": mlp_init(gen, cfg, L)},
        "final_norm": norm_init(cfg.norm, cfg.d_model, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                       cfg.tparam_dtype)
    return params


def layer_slice(tree, l: int):
    """Views of layer ``l`` of a layer-stacked dict tree."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, l) for k, v in tree.items()}
    return tree[l]


def _layer_plan(mor, l: int):
    if mor is None:
        return None
    if hasattr(mor, "layer"):                      # an attached plan
        return mor.layer(l)
    return layer_slice(mor, l)                     # a bare MoRLayer stack


def _head(params: Dict, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


# --------------------------------------------------------------------------
# forward (teacher-forced; calibration reads its taps)
# --------------------------------------------------------------------------

def forward(params: Dict, cfg: ModelConfig, batch: Dict, *,
            mor: Optional[Dict] = None, mor_mode: str = "dense",
            with_taps: bool = False) -> Tuple[torch.Tensor, Dict]:
    """batch["tokens"] (B, S) -> (logits (B, S, V), aux).  With
    ``with_taps`` aux["taps"] holds the (L, B*S, N) calibration taps."""
    _check_family(cfg)
    tokens = batch["tokens"]
    x = params["embed"][tokens.long()].to(cfg.tdtype)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    stack = params["layers"]
    mor_stack = None if mor is None else mor.get("layers")
    taps, stats = [], []
    for l in range(cfg.n_layers):
        lp = layer_slice(stack, l)
        h = apply_norm(cfg.norm, lp["ln1"], x)
        x = x + attn.gqa_forward(lp["attn"], cfg, h, positions)
        h2 = apply_norm(cfg.norm, lp["ln2"], x)
        f, st = mlp_apply(lp["mlp"], cfg, h2, mor=_layer_plan(mor_stack, l),
                          mor_mode=mor_mode)
        if st:
            stats.append(st)
        if with_taps:
            taps.append(mlp_taps(lp["mlp"], cfg, h2))
        x = x + f
    aux: Dict[str, Any] = {}
    if stats:
        aux["mor_stats"] = _stack_stats(stats)
    if with_taps:
        aux["taps"] = {k: torch.stack([t[k] for t in taps])
                       for k in ("p_bin", "p_base")}
    x = apply_norm(cfg.norm, params["final_norm"], x)
    return x @ _head(params, cfg).to(x.dtype), aux


def _stack_stats(stats):
    return {k: torch.stack([s[k] for s in stats]) for k in stats[0]}


# --------------------------------------------------------------------------
# chunked prefill: C tokens per slot at per-slot positions (serving pool)
# --------------------------------------------------------------------------

def prefill_chunk(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
                  cache: Dict, *, n_valid: torch.Tensor,
                  mor: Optional[Dict] = None, mor_mode: str = "dense"
                  ) -> Tuple[torch.Tensor, Dict]:
    """tokens: (B, C) -> (logits (B, C, V) float32, aux).

    The serving engine's one step: every slot consumes its next
    ``n_valid[b]`` tokens (0 idle, 1 decoding, up to C prefilling) at its
    own ``cache["pos"][b]``.  The invalid tail of each row is masked out
    of the residual stream and out of the cache writes.  The cache is
    UPDATED IN PLACE (layer views of the stacked kv tensors, then
    ``cache["pos"] += n_valid``).  aux["mor_stats"] carries the per-layer
    (L-stacked) realised skip statistics.

    A cache carrying a top-level ``block_table`` is the PAGED layout
    (``serving.kv_pool.PagedPool``): every layer reads and writes its kv
    pages through that shared (B, W) table instead of slot rows."""
    _check_family(cfg)
    B, C = tokens.shape
    pos = cache["pos"]
    block_table = cache.get("block_table")
    valid = torch.arange(C, device=tokens.device)[None, :] < \
        n_valid[:, None]
    vm = valid[..., None]
    x = params["embed"][tokens.long()].to(cfg.tdtype)
    x = torch.where(vm, x, torch.zeros((), dtype=x.dtype, device=x.device))
    stack, caches = params["layers"], cache["layers"]
    mor_stack = None if mor is None else mor.get("layers")
    stats = []
    for l in range(cfg.n_layers):
        lp = layer_slice(stack, l)
        h = apply_norm(cfg.norm, lp["ln1"], x)
        a = attn.gqa_chunk(lp["attn"], cfg, h, layer_slice(caches, l), pos,
                           valid, block_table)
        x = x + torch.where(vm, a, 0.0).to(x.dtype)
        h2 = apply_norm(cfg.norm, lp["ln2"], x)
        f, st = mlp_apply(lp["mlp"], cfg, h2, mor=_layer_plan(mor_stack, l),
                          mor_mode=mor_mode)
        if st:
            stats.append(st)
        x = x + torch.where(vm, f, 0.0).to(x.dtype)
    cache["pos"] += n_valid.to(cache["pos"].dtype)
    aux: Dict[str, Any] = {}
    if stats:
        aux["mor_stats"] = _stack_stats(stats)
    x = apply_norm(cfg.norm, params["final_norm"], x)
    logits = (x @ _head(params, cfg).to(x.dtype)).float()
    return logits, aux


# --------------------------------------------------------------------------
# decode cache
# --------------------------------------------------------------------------

def cache_init(cfg: ModelConfig, batch: int, max_len: int, dtype,
               device) -> Dict:
    _check_family(cfg)
    return {"pos": torch.zeros((), dtype=torch.int32, device=device),
            "layers": attn.gqa_cache_init(cfg, batch, max_len, dtype,
                                          cfg.n_layers, device)}
