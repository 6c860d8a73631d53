"""RWKV6 model assembly (``repro.models.rwkv_model``; family "ssm",
attention-free).

Parameters keep the JAX layout: one ``layers`` stack (leading L dim) of
{ln1, tm (time mix), ln2, cm (channel mix)}, plus ``embed``, ``in_norm``,
``final_norm`` and ``lm_head``.  The serving cache holds recurrent state
only: {"pos", "tm_shift" (L, B, d), "wkv" (L, B, H, hd, hd) float32,
"cm_shift" (L, B, d)}; the paged pool (``serving.kv_pool.PagedPool``)
gives the same leaves a page axis in place of B and adds a (B,)
``state_table`` that maps each slot to its state page, which is what
lets prefix-cache state snapshots live in the same pool.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import rwkv
from repro_torch.models.layers.common import dense_init, embed_init
from repro_torch.models.layers.norms import (apply_norm, norm_init,
                                             stacked_norm_init)
from repro_torch.models.transformer import (_layer_plan, _stack_aux,
                                            layer_slice)

STATE_KEYS = ("tm_shift", "wkv", "cm_shift")


def init_params(gen: torch.Generator, cfg: ModelConfig) -> Dict:
    """Random weights from ``gen`` on ``gen.device``."""
    dev, L, d = gen.device, cfg.n_layers, cfg.d_model
    return {
        "embed": embed_init(gen, cfg.vocab_size, d, cfg.tparam_dtype),
        "in_norm": norm_init(cfg.norm, d, dev),
        "layers": {"ln1": stacked_norm_init(cfg.norm, d, L, dev),
                   "tm": rwkv.timemix_init(gen, cfg, L),
                   "ln2": stacked_norm_init(cfg.norm, d, L, dev),
                   "cm": rwkv.chanmix_init(gen, cfg, L)},
        "final_norm": norm_init(cfg.norm, d, dev),
        "lm_head": dense_init(gen, (d, cfg.vocab_size), cfg.tparam_dtype),
    }


def _embed(params: Dict, cfg: ModelConfig, tokens) -> torch.Tensor:
    x = params["embed"][tokens.long()].to(cfg.tdtype)
    return apply_norm(cfg.norm, params["in_norm"], x)


def forward(params: Dict, cfg: ModelConfig, batch: Dict, *,
            mor: Optional[Dict] = None, mor_mode: str = "dense",
            with_taps: bool = False) -> Tuple[torch.Tensor, Dict]:
    """batch["tokens"] (B, S) -> (logits (B, S, V), aux): aux carries the
    layer-stacked "mor_stats" of an active plan and, with ``with_taps``,
    the channel mix's calibration taps "taps" ((L, B*S, N))."""
    x = _embed(params, cfg, batch["tokens"])
    mor_stack = (mor or {}).get("layers")
    ys = []
    for l in range(cfg.n_layers):
        lp = layer_slice(params["layers"], l)
        h = apply_norm(cfg.norm, lp["ln1"], x)
        x = x + rwkv.timemix_forward(lp["tm"], cfg, h)
        h2 = apply_norm(cfg.norm, lp["ln2"], x)
        h2_prev = F.pad(h2, (0, 0, 1, 0))[:, :-1]
        f, stats = rwkv.chanmix_forward(lp["cm"], cfg, h2, h2_prev,
                                        mor=_layer_plan(mor_stack, l),
                                        mor_mode=mor_mode)
        x = x + f
        y: Dict[str, Any] = {"mor_stats": stats} if stats else {}
        if with_taps:
            y["taps"] = rwkv.chanmix_taps(lp["cm"], h2, h2_prev)
        ys.append(y)
    aux = _stack_aux(ys, "")
    x = apply_norm(cfg.norm, params["final_norm"], x)
    return x @ params["lm_head"].to(x.dtype), aux


def cache_init(cfg: ModelConfig, batch: int, max_len: int, dtype,
               device) -> Dict:
    """The recurrent state of ``batch`` sequences (``max_len`` unused:
    the state does not grow)."""
    H, hd = rwkv._heads(cfg)
    L, d = cfg.n_layers, cfg.d_model
    return {
        "pos": torch.zeros((), dtype=torch.int32, device=device),
        "tm_shift": torch.zeros((L, batch, d), dtype=dtype, device=device),
        "wkv": torch.zeros((L, batch, H, hd, hd), dtype=torch.float32,
                           device=device),
        "cm_shift": torch.zeros((L, batch, d), dtype=dtype, device=device),
    }


def state_take(leaf: torch.Tensor, table) -> torch.Tensor:
    """One layer's state rows of the dispatch's slots: the slot rows
    themselves (slotted), or the pages ``table`` (B,) points at
    (paged)."""
    return leaf if table is None else leaf[table]


def state_put(leaf: torch.Tensor, table, new: torch.Tensor) -> None:
    """Write one layer's new state rows back IN PLACE, through the same
    indirection as ``state_take``."""
    if table is None:
        leaf.copy_(new)
    else:
        leaf[table] = new.to(leaf.dtype)


def prefill_chunk(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
                  cache: Dict, *, n_valid: torch.Tensor,
                  mor: Optional[Dict] = None, mor_mode: str = "dense"
                  ) -> Tuple[torch.Tensor, Dict]:
    """tokens: (B, C) -> (logits (B, C, V) float32, aux).

    The serving chunk step: each slot consumes its next ``n_valid[b]``
    tokens, carrying the wkv state and the time-mix and channel-mix
    token shifts across chunk boundaries; invalid positions leave the
    state as it was.  The cache is UPDATED IN PLACE.  A cache carrying a
    top-level ``state_table`` is the paged layout: each slot's state rows
    are read and written through its entry."""
    dt = cfg.tdtype
    B, C = tokens.shape
    table = cache.get("state_table")
    if table is not None:
        table = table.long()
    valid = torch.arange(C, device=tokens.device)[None, :] < \
        n_valid[:, None]
    vm = valid[..., None]
    nv = n_valid.long()
    last = torch.clamp(nv - 1, min=0)
    zero = torch.zeros((), dtype=dt, device=tokens.device)
    x = torch.where(vm, _embed(params, cfg, tokens), zero)
    mor_stack = (mor or {}).get("layers")
    ys = []
    for l in range(cfg.n_layers):
        lp = layer_slice(params["layers"], l)
        st = {k: state_take(cache[k][l], table) for k in STATE_KEYS}
        h = apply_norm(cfg.norm, lp["ln1"], x)
        y, tm_new, wkv_new = rwkv.timemix_chunk(
            lp["tm"], cfg, h, st["tm_shift"].to(dt), st["wkv"], valid)
        x = x + torch.where(vm, y, zero)
        h2 = apply_norm(cfg.norm, lp["ln2"], x)
        cm0 = st["cm_shift"].to(dt)
        h2_prev = torch.cat([cm0[:, None], h2[:, :-1]], 1)
        f, stats = rwkv.chanmix_forward(lp["cm"], cfg, h2, h2_prev,
                                        mor=_layer_plan(mor_stack, l),
                                        mor_mode=mor_mode)
        x = x + torch.where(vm, f, zero)
        h2_last = torch.gather(h2, 1, last[:, None, None].expand(
            -1, 1, h2.shape[-1]))[:, 0]
        cm_new = torch.where((nv > 0)[:, None], h2_last, cm0)
        for k, v in (("tm_shift", tm_new), ("wkv", wkv_new),
                     ("cm_shift", cm_new)):
            state_put(cache[k][l], table, v)
        ys.append({"mor_stats": stats} if stats else {})
    cache["pos"] += n_valid.to(cache["pos"].dtype)
    x = apply_norm(cfg.norm, params["final_norm"], x)
    logits = (x @ params["lm_head"].to(dt)).float()
    return logits, _stack_aux(ys, "")


def decode_step(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
                cache: Dict, *, mor: Optional[Dict] = None,
                mor_mode: str = "dense") -> torch.Tensor:
    """One token per sequence: tokens (B, 1) -> logits (B, V), the
    ``cache_init`` state UPDATED IN PLACE (pos a scalar)."""
    dt = cfg.tdtype
    x = _embed(params, cfg, tokens[:, 0])                # (B, d)
    mor_stack = (mor or {}).get("layers")
    for l in range(cfg.n_layers):
        lp = layer_slice(params["layers"], l)
        h = apply_norm(cfg.norm, lp["ln1"], x)
        y, tm_state = rwkv.timemix_decode(
            lp["tm"], cfg, h, {"shift": cache["tm_shift"][l],
                               "wkv": cache["wkv"][l]})
        x = x + y
        h2 = apply_norm(cfg.norm, lp["ln2"], x)
        f, _ = rwkv.chanmix_forward(lp["cm"], cfg, h2,
                                    cache["cm_shift"][l].to(dt),
                                    mor=_layer_plan(mor_stack, l),
                                    mor_mode=mor_mode)
        x = x + f
        cache["tm_shift"][l].copy_(tm_state["shift"])
        cache["wkv"][l].copy_(tm_state["wkv"])
        cache["cm_shift"][l].copy_(h2)
    cache["pos"] += 1
    x = apply_norm(cfg.norm, params["final_norm"], x)
    return x @ params["lm_head"].to(dt)
