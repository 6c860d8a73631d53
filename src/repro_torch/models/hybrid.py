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
from repro_torch.distributed.decode_attention import state_put, state_take
from repro_torch.models.layers import attention as attn
from repro_torch.models.layers.common import dense_init, embed_init
from repro_torch.models.layers.mlp import mlp_apply, mlp_init, mlp_taps
from repro_torch.models.layers.mlp import mor_whole
from repro_torch.models.layers.mlp import tp_keep as mlp_tp_keep
from repro_torch.models.layers.norms import (apply_norm, norm_init,
                                             stacked_norm_init)
from repro_torch.models.layers.ssm import (mamba2_cache_init, mamba2_chunk,
                                           mamba2_decode, mamba2_forward,
                                           mamba2_init)
from repro_torch.models.layers.ssm import tp_keep as ssm_tp_keep
from repro_torch.distributed import sharding_rules as sr
from repro_torch.models.transformer import (_group_specs, _remat,
                                            _stack_aux, layer_slice,
                                            layer_views, use_top)


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
    """The shared attention + MLP on ``x`` (this rank's rows under
    sequence parallelism: each of the two runs on the gathered rows,
    ``sharding_rules.seq_call``, tensor-parallel where ``use_shared``
    left its splits)."""
    h = apply_norm(cfg.norm, sr.seq_weights(sp["ln1"]), x)
    x = x + sr.seq_call(
        lambda h: attn.gqa_forward(sp["attn"], _swa_cfg(cfg), h, positions),
        attn.tp_group(sp["attn"]) is not None, h)
    h2 = apply_norm(cfg.norm, sr.seq_weights(sp["ln2"]), x)

    def ffn(h2):
        f, stats = mlp_apply(sp["mlp"], cfg, h2, mor=mor, mor_mode=mor_mode)
        return f, stats, (mlp_taps(sp["mlp"], cfg, h2) if with_taps
                          else None)
    f, stats, taps = sr.seq_call(
        ffn, sr.split_group(sp["mlp"]["w_down"]) is not None, h2)
    return x + f, stats, taps


def use_shared(params: Dict, cfg: ModelConfig, mor, mor_mode: str,
               tp: bool = True) -> Dict:
    """The params outside the mamba stacks gathered for use
    (``transformer.use_top``, the vocabulary whole), the shared block's
    GQA and MLP leaving split the ``model`` dims their tensor-parallel
    forms consume (``tp``: ``attention.tp_keep``, ``mlp.tp_keep``; the
    MLP under an active MoR plan too, where its d_ff divides over
    ``model`` in whole tiles, ``mlp.mor_whole``)."""
    ctx = sr.current()
    keep: dict = {}
    if tp and ctx is not None and ctx.specs is not None:
        from repro_torch.core.executor import as_plan
        specs = ctx.specs["shared"]
        active = as_plan(mor, mode=mor_mode, tile_m=cfg.mor.tile_m,
                         tile_n=cfg.mor.tile_n).active
        mp = ctx.mesh.shape["model"]
        keep = dict(attn.tp_keep(_swa_cfg(cfg), specs["attn"], mp,
                                 "shared/attn/"),
                    **mlp_tp_keep(specs["mlp"], mor_whole(cfg, mp, active),
                                  "shared/mlp/"))
    return use_top(params, cfg, tp=False, keep=keep)


def use_mamba(lp: Dict, lspec, cfg: ModelConfig, tp: bool = True) -> Dict:
    """Gather-on-use of one mamba block's leaves, leaving split the
    ``model`` dims its tensor-parallel form consumes (``tp``:
    ``ssm.tp_keep``)."""
    if lspec is None:
        return lp
    keep = (ssm_tp_keep(cfg, lspec["mamba"], sr.current().mesh.shape[
        "model"]) if tp else {})
    return sr.use(lp, lspec, keep)


def forward(params: Dict, cfg: ModelConfig, batch: Dict, *,
            mor: Optional[Dict] = None, mor_mode: str = "dense",
            with_taps: bool = False) -> Tuple[torch.Tensor, Dict]:
    """batch["tokens"] (B, S) -> (logits (B, S, V), aux): aux carries the
    shared MLP's "mor_stats" (n_seg-stacked: one entry per application)
    and, with ``with_taps``, its taps (n_seg, B*S, N), which
    ``deploy.calibrate_hybrid`` folds over the segment axis.  Under a
    mesh every leaf is gathered where it is used (the mamba layers one
    by one, the shared block once a forward), but for the ``model``
    splits the tensor-parallel Mamba2, GQA and MLP consume; under
    sequence parallelism each mamba layer, attention and MLP runs on
    the gathered rows."""
    with sr.seq_sharded(batch["tokens"].shape[1]):
        return _forward(params, cfg, batch, mor, mor_mode, with_taps)


def _forward(params, cfg, batch, mor, mor_mode, with_taps):
    """``forward``'s body; under sequence parallelism the residual stream
    between blocks holds this rank's S rows and each mamba layer, the
    shared attention and its MLP run on the gathered rows
    (``sharding_rules.seq_call``: a tensor-parallel one reduce-scatters
    its output, another keeps its rows of it)."""
    shared_mor = None if mor is None else mor.get("shared")
    params = use_shared(params, cfg, shared_mor, mor_mode)
    B, S = batch["tokens"].shape
    x = sr.seq_split(params["embed"][batch["tokens"].long()].to(cfg.tdtype))
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    segs, tail = _mamba_layers(cfg)

    views = {key: layer_views(params[key])
             for key in ("mamba_layers", "tail_layers") if key in params}

    lspecs = {key: _group_specs(key) for key in views}

    def block(x, lp, lspec):
        # the block's input and output are this rank's rows
        lp = use_mamba(lp, lspec, cfg)
        h = apply_norm(cfg.norm, sr.seq_weights(lp["ln"]), x)
        return x + sr.seq_call(
            lambda h: mamba2_forward(lp["mamba"], cfg, h),
            sr.split_group(lp["mamba"]["out_proj"]) is not None, h)

    # the reference rematerialises the segments' mamba layers (not the
    # tail's, nor the shared block) with nothing_saveable
    seg_block = _remat(sr.bind(block), "none" if cfg.remat == "none"
                       else "nothing_saveable")

    def mamba_block(key, i, x):
        fn = seg_block if key == "mamba_layers" else block
        return fn(x, views[key][i], lspecs[key])

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
    x = apply_norm(cfg.norm, params["final_norm"], sr.seq_gather(x, False))
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
    read (every layer of a leaf at once: one collective per leaf when the
    pool is page-sharded) and written through its state page, and the
    shared attention's ring through its kv pages (``gqa_paged_flash``).  aux["mor_stats"]
    is n_seg-stacked, one entry per application of the shared MLP.
    Under a mesh every leaf is gathered whole."""
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
    shared_mor = None if mor is None else mor.get("shared")
    params = use_shared(params, cfg, shared_mor, mor_mode, tp=False)
    x = torch.where(vm, params["embed"][tokens.long()].to(dt), zero)
    swa = _swa_cfg(cfg)
    sp = params["shared"]
    segs, tail = _mamba_layers(cfg)
    taken = {key: {k: state_take(a, table)
                   for k, a in cache[name].items()}
             for key, name in _CACHE_OF.items() if name in cache}
    lspecs = {key: _group_specs(key) for key in _CACHE_OF if key in params}

    def mamba_block(key, i, x):
        lp = use_mamba(layer_slice(params[key], i), lspecs[key], cfg,
                       tp=False)
        leaves = cache[_CACHE_OF[key]]
        st = {k: a[i] for k, a in taken[key].items()}
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
    ``cache_init`` cache UPDATED IN PLACE (pos a scalar).  Under a mesh
    the shared block is tensor-parallel as in ``forward`` (its decode
    over the sequence-sharded ring: ``attention._tp_decode``) and each
    rank decodes the whole of every mamba layer (its state is not split
    by head)."""
    pos = cache["pos"]
    shared_mor = None if mor is None else mor.get("shared")
    params = use_shared(params, cfg, shared_mor, mor_mode)
    x = params["embed"][tokens.long()].to(cfg.tdtype)     # (B, 1, d)
    swa = _swa_cfg(cfg)
    sp = params["shared"]
    segs, tail = _mamba_layers(cfg)
    lspecs = {key: _group_specs(key) for key in _CACHE_OF if key in params}

    def mamba_block(key, i, x):
        lp = use_mamba(layer_slice(params[key], i), lspecs[key], cfg,
                       tp=False)
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
