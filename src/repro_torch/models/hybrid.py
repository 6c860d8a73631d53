"""Zamba2-style hybrid (``repro.models.hybrid``; family "hybrid"): a
Mamba2 backbone plus ONE shared attention + MLP block re-applied after
every ``shared_attn_every`` mamba layers (zamba2-7b: 81 = 13 segments x
6 mamba layers + a tail of 3).  The shared attention is GQA under the
sliding window ``shared_attn_window``; its MLP is the model's only
ReLU-family FFN, and so the only MoR target (``mor["shared"]``, one
MoRLayer observed at every segment boundary).

Parameters keep the JAX layout: ``mamba_layers`` (the n_seg x every
segment layers stacked), ``tail_layers``, ``shared`` ({ln1, attn, ln2,
mlp}, unstacked), ``embed``, ``final_norm`` and ``lm_head``.  The
serving cache is {"pos", "mamba": {conv, ssm} stacked over the segment
layers, "shared_attn": {k, v, pos} stacked over the n_seg applications
of the shared block, "tail": {conv, ssm}}; on the paged pool the state
leaves are state pages behind a (B,) ``state_table`` and the shared
attention's rings are kv pages behind a (B, W) ``block_table``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import attention as attn
from repro_torch.models.layers.common import dense_init, embed_init
from repro_torch.models.layers.mlp import mlp_apply, mlp_init, mlp_taps
from repro_torch.models.layers.norms import (apply_norm, norm_init,
                                             stacked_norm_init)
from repro_torch.models.layers.ssm import (mamba2_cache_init, mamba2_chunk,
                                           mamba2_decode, mamba2_forward,
                                           mamba2_init)
from repro_torch.models.rwkv_model import state_put, state_take
from repro_torch.models.transformer import _stack_aux, layer_slice


def _seg_counts(cfg: ModelConfig) -> Tuple[int, int, int]:
    """-> (segments, mamba layers a segment, tail layers)."""
    every = cfg.shared_attn_every
    n_seg = cfg.n_layers // every
    return n_seg, every, cfg.n_layers - n_seg * every


def _swa_cfg(cfg: ModelConfig) -> ModelConfig:
    """The shared attention's config: GQA under the shared window."""
    return cfg.replace(sliding_window=cfg.shared_attn_window)


def _mamba_stack_init(gen: torch.Generator, cfg: ModelConfig,
                      L: int) -> Dict:
    return {"ln": stacked_norm_init(cfg.norm, cfg.d_model, L, gen.device),
            "mamba": mamba2_init(gen, cfg, L)}


def init_params(gen: torch.Generator, cfg: ModelConfig) -> Dict:
    """Random weights from ``gen`` on ``gen.device``."""
    n_seg, every, tail = _seg_counts(cfg)
    dev, d = gen.device, cfg.d_model
    params: Dict[str, Any] = {
        "embed": embed_init(gen, cfg.vocab_size, d, cfg.tparam_dtype),
        "mamba_layers": _mamba_stack_init(gen, cfg, n_seg * every),
        "shared": {"ln1": norm_init(cfg.norm, d, dev),
                   "attn": layer_slice(attn.gqa_init(gen, cfg, 1), 0),
                   "ln2": norm_init(cfg.norm, d, dev),
                   "mlp": layer_slice(mlp_init(gen, cfg, 1), 0)},
        "final_norm": norm_init(cfg.norm, d, dev),
        "lm_head": dense_init(gen, (d, cfg.vocab_size), cfg.tparam_dtype),
    }
    if tail:
        params["tail_layers"] = _mamba_stack_init(gen, cfg, tail)
    return params


def _mamba_layers(cfg: ModelConfig):
    """(stack key, index in the stack) of every mamba layer, in layer
    order: -> ([per segment: [(stack, i)]], [(stack, i)] of the
    tail)."""
    n_seg, every, tail = _seg_counts(cfg)
    segs = [[("mamba_layers", s * every + i) for i in range(every)]
            for s in range(n_seg)]
    return segs, [("tail_layers", i) for i in range(tail)]


def _shared_block(sp: Dict, cfg: ModelConfig, x, positions, mor, mor_mode,
                  with_taps: bool = False):
    h = apply_norm(cfg.norm, sp["ln1"], x)
    x = x + attn.gqa_forward(sp["attn"], _swa_cfg(cfg), h, positions)
    h2 = apply_norm(cfg.norm, sp["ln2"], x)
    f, stats = mlp_apply(sp["mlp"], cfg, h2, mor=mor, mor_mode=mor_mode)
    taps = mlp_taps(sp["mlp"], cfg, h2) if with_taps else None
    return x + f, stats, taps


def forward(params: Dict, cfg: ModelConfig, batch: Dict, *,
            mor: Optional[Dict] = None, mor_mode: str = "dense",
            with_taps: bool = False) -> Tuple[torch.Tensor, Dict]:
    """batch["tokens"] (B, S) -> (logits (B, S, V), aux): aux carries the
    shared MLP's "mor_stats" (n_seg-stacked: one entry per application)
    and, with ``with_taps``, its taps (n_seg, B*S, N), which
    ``deploy.calibrate_hybrid`` folds over the segment axis."""
    x = params["embed"][batch["tokens"].long()].to(cfg.tdtype)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    shared_mor = None if mor is None else mor.get("shared")
    segs, tail = _mamba_layers(cfg)

    def mamba_block(key, i, x):
        lp = layer_slice(params[key], i)
        h = apply_norm(cfg.norm, lp["ln"], x)
        return x + mamba2_forward(lp["mamba"], cfg, h)

    ys = []
    for seg in segs:
        for key, i in seg:
            x = mamba_block(key, i, x)
        x, stats, taps = _shared_block(params["shared"], cfg, x, positions,
                                       shared_mor, mor_mode, with_taps)
        y: Dict[str, Any] = {"mor_stats": stats} if stats else {}
        if with_taps:
            y["taps"] = taps
        ys.append(y)
    for key, i in tail:
        x = mamba_block(key, i, x)
    x = apply_norm(cfg.norm, params["final_norm"], x)
    return x @ params["lm_head"].to(x.dtype), _stack_aux(ys, "")


def cache_init(cfg: ModelConfig, batch: int, max_len: int, dtype,
               device) -> Dict:
    """The decode cache of ``batch`` sequences: mamba state per layer and
    the shared attention's ring (the shared window, at most ``max_len``
    rows) per application of the shared block."""
    n_seg, every, tail = _seg_counts(cfg)
    cache = {"pos": torch.zeros((), dtype=torch.int32, device=device),
             "mamba": mamba2_cache_init(cfg, batch, n_seg * every, dtype,
                                        device),
             "shared_attn": attn.gqa_cache_init(_swa_cfg(cfg), batch,
                                                max_len, dtype, n_seg,
                                                device)}
    if tail:
        cache["tail"] = mamba2_cache_init(cfg, batch, tail, dtype, device)
    return cache


_CACHE_OF = {"mamba_layers": "mamba", "tail_layers": "tail"}


def prefill_chunk(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
                  cache: Dict, *, n_valid: torch.Tensor,
                  mor: Optional[Dict] = None, mor_mode: str = "dense"
                  ) -> Tuple[torch.Tensor, Dict]:
    """tokens: (B, C) -> (logits (B, C, V) float32, aux).

    The serving chunk step: the mamba layers carry their SSD and conv
    state across chunks (``mamba2_chunk``), the shared block writes its
    window ring (``gqa_chunk``) at per-slot positions.  The cache is
    UPDATED IN PLACE.  A cache carrying top-level ``state_table`` /
    ``block_table`` is the paged layout: each slot's mamba state rows are
    read and written through its state page, and the shared attention's
    ring through its kv pages (``gqa_paged_flash``).  aux["mor_stats"]
    is n_seg-stacked, one entry per application of the shared MLP."""
    dt = cfg.tdtype
    B, C = tokens.shape
    pos = cache["pos"]
    table = cache.get("state_table")
    if table is not None:
        table = table.long()
    block_table = cache.get("block_table")
    valid = torch.arange(C, device=tokens.device)[None, :] < \
        n_valid[:, None]
    vm = valid[..., None]
    zero = torch.zeros((), dtype=dt, device=tokens.device)
    x = torch.where(vm, params["embed"][tokens.long()].to(dt), zero)
    swa = _swa_cfg(cfg)
    sp = params["shared"]
    shared_mor = None if mor is None else mor.get("shared")
    segs, tail = _mamba_layers(cfg)

    def mamba_block(key, i, x):
        lp = layer_slice(params[key], i)
        leaves = cache[_CACHE_OF[key]]
        st = {k: state_take(a[i], table) for k, a in leaves.items()}
        h = apply_norm(cfg.norm, lp["ln"], x)
        y, new = mamba2_chunk(lp["mamba"], cfg, h, st, valid)
        for k, a in leaves.items():
            state_put(a[i], table, new[k])
        return x + torch.where(vm, y, zero)

    ys = []
    for s, seg in enumerate(segs):
        for key, i in seg:
            x = mamba_block(key, i, x)
        h = apply_norm(cfg.norm, sp["ln1"], x)
        a = attn.gqa_chunk(sp["attn"], swa, h,
                           layer_slice(cache["shared_attn"], s), pos, valid,
                           block_table)
        x = x + torch.where(vm, a, zero)
        h2 = apply_norm(cfg.norm, sp["ln2"], x)
        f, stats = mlp_apply(sp["mlp"], cfg, h2, mor=shared_mor,
                             mor_mode=mor_mode)
        x = x + torch.where(vm, f, zero)
        ys.append({"mor_stats": stats} if stats else {})
    for key, i in tail:
        x = mamba_block(key, i, x)
    cache["pos"] += n_valid.to(cache["pos"].dtype)
    x = apply_norm(cfg.norm, params["final_norm"], x)
    logits = (x @ params["lm_head"].to(dt)).float()
    return logits, _stack_aux(ys, "")


def decode_step(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
                cache: Dict, *, mor: Optional[Dict] = None,
                mor_mode: str = "dense") -> torch.Tensor:
    """One token per sequence: tokens (B, 1) -> logits (B, V), the
    ``cache_init`` cache UPDATED IN PLACE (pos a scalar)."""
    pos = cache["pos"]
    x = params["embed"][tokens.long()].to(cfg.tdtype)     # (B, 1, d)
    swa = _swa_cfg(cfg)
    sp = params["shared"]
    shared_mor = None if mor is None else mor.get("shared")
    segs, tail = _mamba_layers(cfg)

    def mamba_block(key, i, x):
        lp = layer_slice(params[key], i)
        leaves = cache[_CACHE_OF[key]]
        h = apply_norm(cfg.norm, lp["ln"], x)
        y, new = mamba2_decode(lp["mamba"], cfg, h,
                               {k: a[i] for k, a in leaves.items()})
        for k, a in leaves.items():
            a[i].copy_(new[k])
        return x + y

    for s, seg in enumerate(segs):
        for key, i in seg:
            x = mamba_block(key, i, x)
        h = apply_norm(cfg.norm, sp["ln1"], x)
        x = x + attn.gqa_decode(sp["attn"], swa, h,
                                layer_slice(cache["shared_attn"], s), pos)
        h2 = apply_norm(cfg.norm, sp["ln2"], x)
        f, _ = mlp_apply(sp["mlp"], cfg, h2, mor=shared_mor,
                         mor_mode=mor_mode)
        x = x + f
    for key, i in tail:
        x = mamba_block(key, i, x)
    cache["pos"] += 1
    x = apply_norm(cfg.norm, params["final_norm"], x)
    return x[:, 0, :] @ params["lm_head"].to(x.dtype)
