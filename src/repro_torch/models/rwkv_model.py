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
from repro_torch.distributed.decode_attention import state_put, state_take
from repro_torch.models.layers import rwkv
from repro_torch.models.layers.common import dense_init, embed_init
from repro_torch.models.layers.norms import (apply_norm, norm_init,
                                             stacked_norm_init)
from repro_torch.distributed import sharding_rules as sr
from repro_torch.models.transformer import (_group_specs, _layer_plan,
                                            _remat, _stack_aux, layer_slice,
                                            layer_views, use_top)

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
    the channel mix's calibration taps "taps" ((L, B*S, N)).  Under a
    mesh every leaf is gathered where it is used (layer by layer), but
    for the ``model`` splits the tensor-parallel time mix and channel
    mix consume (``rwkv.tp_keep``); under sequence parallelism each of
    the two runs on the gathered rows."""
    with sr.seq_sharded(batch["tokens"].shape[1]):
        return _forward(params, cfg, batch, mor, mor_mode, with_taps)


def _forward(params, cfg, batch, mor, mor_mode, with_taps):
    """``forward``'s body; under sequence parallelism the residual stream
    between blocks holds this rank's S rows, and the time mix and the
    channel mix each run on the gathered rows (``sharding_rules.
    seq_call``: a tensor-parallel one reduce-scatters its output, another
    keeps its rows of it)."""
    params = use_top(params, cfg, tp=False)
    x = sr.seq_split(_embed(params, cfg, batch["tokens"]))
    mor_stack = (mor or {}).get("layers")
    lspec = _group_specs("layers")

    def block(x, lp, ml):
        lp = use_block(lp, lspec, cfg, ml, mor_mode)
        h = apply_norm(cfg.norm, sr.seq_weights(lp["ln1"]), x)
        x = x + sr.seq_call(lambda h: rwkv.timemix_forward(lp["tm"], cfg, h),
                            sr.split_group(lp["tm"]["Wr"]) is not None, h)
        h2 = apply_norm(cfg.norm, sr.seq_weights(lp["ln2"]), x)

        def cm(h2):
            h2_prev = F.pad(h2, (0, 0, 1, 0))[:, :-1]
            f, stats = rwkv.chanmix_forward(lp["cm"], cfg, h2, h2_prev,
                                            mor=ml, mor_mode=mor_mode)
            y: Dict[str, Any] = {"mor_stats": stats} if stats else {}
            if with_taps:
                y["taps"] = rwkv.chanmix_taps(lp["cm"], h2, h2_prev)
            return f, y
        f, y = sr.seq_call(cm, sr.split_group(lp["cm"]["w_down"])
                           is not None, h2)
        return x + f, y

    # any policy but "none" recomputes the whole block, as the
    # reference's nothing_saveable does; the block's input and output
    # are this rank's rows
    body = _remat(sr.bind(block), "none" if cfg.remat == "none"
                  else "nothing_saveable")
    ys = []
    for l, lp in enumerate(layer_views(params["layers"])):
        x, y = body(x, lp, _layer_plan(mor_stack, l))
        ys.append(y)
    aux = _stack_aux(ys, "")
    x = apply_norm(cfg.norm, params["final_norm"], sr.seq_gather(x, False))
    return x @ params["lm_head"].to(x.dtype), aux


def use_block(lp: Dict, lspec, cfg: ModelConfig, ml, mor_mode: str,
              tp: bool = True) -> Dict:
    """Gather-on-use of one block's leaves (``sharding_rules.use``),
    leaving split the ``model`` dims its tensor-parallel time mix and
    channel mix consume (``tp``; none on the serving and decode paths;
    the channel mix under an active MoR plan too, where its d_ff divides
    over ``model`` in whole tiles: ``rwkv.tp_keep``)."""
    if lspec is None:
        return lp
    keep: dict = {}
    if tp:
        from repro_torch.core.executor import as_plan
        active = as_plan(ml, mode=mor_mode, tile_m=cfg.mor.tile_m,
                         tile_n=cfg.mor.tile_n).active
        keep = rwkv.tp_keep(cfg, lspec, sr.current().mesh.shape["model"],
                            active)
    return sr.use(lp, lspec, keep)


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
    are read (every layer at once, one collective per leaf when the pool
    is page-sharded: ``decode_attention.state_take``) and written back
    layer by layer through its entry.  Under a mesh every block is
    gathered whole (``use_block(..., tp=False)``)."""
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
    params = use_top(params, cfg, tp=False)
    lspec = _group_specs("layers")
    x = torch.where(vm, _embed(params, cfg, tokens), zero)
    mor_stack = (mor or {}).get("layers")
    taken = {k: state_take(cache[k], table) for k in STATE_KEYS}
    ys = []
    for l in range(cfg.n_layers):
        lp = use_block(layer_slice(params["layers"], l), lspec, cfg, None,
                       mor_mode, tp=False)
        st = {k: taken[k][l] for k in STATE_KEYS}
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
    ``cache_init`` state UPDATED IN PLACE (pos a scalar).  Under a mesh
    every block is gathered whole: each rank decodes the whole layer
    (its state is not split by head)."""
    dt = cfg.tdtype
    params = use_top(params, cfg, tp=False)
    lspec = _group_specs("layers")
    x = _embed(params, cfg, tokens[:, 0])                # (B, d)
    mor_stack = (mor or {}).get("layers")
    for l in range(cfg.n_layers):
        lp = use_block(layer_slice(params["layers"], l), lspec, cfg, None,
                       mor_mode, tp=False)
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
