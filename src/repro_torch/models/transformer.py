"""Decoder LM / encoder assembly for the dense, moe, vlm and audio
families (``repro.models.transformer``).

Parameters keep the JAX package's layer-stacked layout (every per-layer
leaf has a leading L dim, ``x @ w`` weights are (d_in, d_out)): the
dense family has one ``layers`` stack; the moe family a ``dense_layers``
stack (the first ``first_k_dense`` layers, a dense FFN) and a
``moe_layers`` stack.  Attention is GQA or, with ``cfg.mla``, MLA.  The
layer loop is a Python loop over views of those stacks; the serving
cache keeps ONE stack of all ``n_layers`` layers, indexed by the global
layer number.  The modality frontends are stubs, as in the JAX package:
the vlm family prepends pre-computed patch embeddings
(``batch["patch_embeds"]``) to the token embeddings in ``forward`` and
serves text only; the audio family (an encoder: ``cfg.causal`` False,
no decode) takes frame embeddings (``batch["frames"]``) through an input
norm (``in_norm``) and has no token embedding in its inputs.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import attention as attn
from repro_torch.models.layers.common import dense_init, embed_init
from repro_torch.models.layers.mlp import mlp_apply, mlp_init, mlp_taps
from repro_torch.models.layers.moe import moe_apply, moe_init, moe_taps
from repro_torch.models.layers.norms import (apply_norm, norm_init,
                                             stacked_norm_init)


def _check_family(cfg: ModelConfig, decode: bool = False) -> None:
    if cfg.family not in ("dense", "moe", "vlm", "audio"):
        raise ValueError(f"{cfg.name} ({cfg.family}) is not a transformer "
                         f"family")
    if decode and cfg.family == "audio":
        raise ValueError(f"{cfg.name} is encoder-only: it does not decode")


def _stack_init(gen: torch.Generator, cfg: ModelConfig, L: int,
                kind: str) -> Dict:
    """One layer-stacked group of ``L`` blocks of ``kind``."""
    dev = gen.device
    attn_p = (attn.mla_init if cfg.mla else attn.gqa_init)(gen, cfg, L)
    p = {"ln1": stacked_norm_init(cfg.norm, cfg.d_model, L, dev),
         "attn": attn_p,
         "ln2": stacked_norm_init(cfg.norm, cfg.d_model, L, dev)}
    if kind == "moe":
        p["moe"] = moe_init(gen, cfg, L)
    else:
        p["mlp"] = mlp_init(gen, cfg, L)
    return p


def init_params(gen: torch.Generator, cfg: ModelConfig) -> Dict:
    """Random weights from ``gen`` on ``gen.device``."""
    _check_family(cfg)
    dev = gen.device
    params: Dict[str, Any] = {}
    if cfg.vocab_size:
        params["embed"] = embed_init(gen, cfg.vocab_size, cfg.d_model,
                                     cfg.tparam_dtype)
    if cfg.frontend == "audio_stub":
        params["in_norm"] = norm_init(cfg.norm, cfg.d_model, dev)
    if cfg.family == "moe":
        kd = cfg.first_k_dense
        if kd:
            params["dense_layers"] = _stack_init(gen, cfg, kd, "dense")
        params["moe_layers"] = _stack_init(gen, cfg, cfg.n_layers - kd,
                                           "moe")
    else:
        params["layers"] = _stack_init(gen, cfg, cfg.n_layers, "dense")
    params["final_norm"] = norm_init(cfg.norm, cfg.d_model, dev)
    if cfg.vocab_size and not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                       cfg.tparam_dtype)
    return params


def layer_slice(tree, l: int):
    """Views of layer ``l`` of a layer-stacked dict tree."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, l) for k, v in tree.items()}
    return tree[l]


def _layer_plan(mor, l: int):
    """Layer ``l`` of a MoR group: an attached plan, a bare stacked
    MoRLayer, or a dict of them (the expert group {"experts": ...})."""
    if mor is None:
        return None
    if hasattr(mor, "layer"):                      # an attached plan
        return mor.layer(l)
    if isinstance(mor, dict):
        return {k: _layer_plan(v, l) for k, v in mor.items()}
    return mor[l]


def _groups(params: Dict, cfg: ModelConfig, mor: Optional[Dict]
            ) -> List[Tuple[str, Dict, Any, str]]:
    """(kind, stacked params, MoR group, aux key prefix) per layer group,
    in layer order: the JAX package's scan stacks."""
    mor = mor or {}
    if cfg.family == "moe":
        out = []
        if cfg.first_k_dense:
            out.append(("dense", params["dense_layers"],
                        mor.get("dense_layers"), "dense_"))
        out.append(("moe", params["moe_layers"], mor.get("moe_layers"), ""))
        return out
    return [("dense", params["layers"], mor.get("layers"), "")]


def _n_stack(stacked: Dict) -> int:
    return stacked["ln1"]["scale"].shape[0]


def _head(params: Dict, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _ffn(lp: Dict, cfg: ModelConfig, h2, kind: str, mor_layer,
         mor_mode: str, token_mask=None):
    """-> (f, {aux key: value}) for one block's FFN."""
    if kind == "moe":
        f, aux = moe_apply(lp["moe"], cfg, h2, mor=mor_layer,
                           mor_mode=mor_mode, token_mask=token_mask)
        ys = {"lb_loss": aux["lb_loss"]}
        if "mor_stats" in aux:
            # (E,)-shaped; stacked over layers to (L, E)
            ys["moe_mor_stats"] = aux["mor_stats"]
        return f, ys
    f, stats = mlp_apply(lp["mlp"], cfg, h2, mor=mor_layer,
                         mor_mode=mor_mode)
    return f, ({"mor_stats": stats} if stats else {})


def _stack_aux(ys: List[Dict], prefix: str) -> Dict:
    """Per-layer aux dicts -> layer-stacked aux, keys prefixed."""
    out: Dict[str, Any] = {}
    for key in ys[0] if ys else ():
        vals = [y[key] for y in ys]
        if isinstance(vals[0], dict):
            out[prefix + key] = {k: torch.stack([v[k] for v in vals])
                                 for k in vals[0]}
        else:
            out[prefix + key] = torch.stack(vals)
    return out


# --------------------------------------------------------------------------
# forward (teacher-forced; calibration reads its taps)
# --------------------------------------------------------------------------

def _embed_inputs(params: Dict, cfg: ModelConfig, batch: Dict
                  ) -> torch.Tensor:
    """The residual stream's input (``repro.models.transformer.
    _embed_inputs``): normed frames for the audio stub, else the token
    embeddings, after the patch embeddings where a vision batch has
    them."""
    dt = cfg.tdtype
    if cfg.frontend == "audio_stub":
        return apply_norm(cfg.norm, params["in_norm"],
                          batch["frames"].to(dt))
    x = params["embed"][batch["tokens"].long()].to(dt)
    if cfg.frontend == "vision_stub" and "patch_embeds" in batch:
        x = torch.cat([batch["patch_embeds"].to(dt), x], 1)
    return x


def forward(params: Dict, cfg: ModelConfig, batch: Dict, *,
            mor: Optional[Dict] = None, mor_mode: str = "dense",
            with_taps: bool = False) -> Tuple[torch.Tensor, Dict]:
    """batch["tokens"] (B, S) (a vision batch may add "patch_embeds" (B,
    P, d), prepended; an audio batch holds "frames" (B, S, d) instead)
    -> (logits (B, S, V), aux); a model without a vocabulary returns the
    final hidden states.  With ``with_taps`` aux["taps"] holds the
    layer-stacked calibration taps ((L, B*S, N) for a dense stack, (L,
    E, B*S, f) for the MoE stack; a moe model's dense layers put theirs
    under "dense_taps")."""
    _check_family(cfg)
    x = _embed_inputs(params, cfg, batch)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    attn_fn = attn.mla_forward if cfg.mla else attn.gqa_forward
    aux: Dict[str, Any] = {}
    for kind, stack, mor_stack, prefix in _groups(params, cfg, mor):
        ys = []
        for l in range(_n_stack(stack)):
            lp = layer_slice(stack, l)
            h = apply_norm(cfg.norm, lp["ln1"], x)
            x = x + attn_fn(lp["attn"], cfg, h, positions)
            h2 = apply_norm(cfg.norm, lp["ln2"], x)
            f, y = _ffn(lp, cfg, h2, kind, _layer_plan(mor_stack, l),
                        mor_mode)
            if with_taps:
                y["taps"] = (moe_taps(lp["moe"], cfg, h2) if kind == "moe"
                             else mlp_taps(lp["mlp"], cfg, h2))
            ys.append(y)
            x = x + f
        aux.update(_stack_aux(ys, prefix))
    x = apply_norm(cfg.norm, params["final_norm"], x)
    if not cfg.vocab_size:
        return x, aux
    return x @ _head(params, cfg).to(x.dtype), aux


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
    of the residual stream, out of the cache writes and out of expert
    routing.  The cache is UPDATED IN PLACE (layer views of the stacked
    cache tensors, then ``cache["pos"] += n_valid``).  aux carries the
    per-layer (L-stacked) realised skip statistics: "mor_stats" for a
    dense model, "dense_mor_stats" and the (L, E) "moe_mor_stats" for a
    moe model.

    A cache carrying a top-level ``block_table`` is the PAGED layout
    (``serving.kv_pool.PagedPool``): every layer reads and writes its kv
    pages through that shared (B, W) table instead of slot rows."""
    _check_family(cfg, decode=True)
    B, C = tokens.shape
    pos = cache["pos"]
    block_table = cache.get("block_table")
    valid = torch.arange(C, device=tokens.device)[None, :] < \
        n_valid[:, None]
    vm = valid[..., None]
    x = params["embed"][tokens.long()].to(cfg.tdtype)
    x = torch.where(vm, x, torch.zeros((), dtype=x.dtype, device=x.device))
    caches = cache["layers"]
    chunk_fn = attn.mla_chunk if cfg.mla else attn.gqa_chunk
    aux: Dict[str, Any] = {}
    g = 0                                   # global layer index
    for kind, stack, mor_stack, prefix in _groups(params, cfg, mor):
        ys = []
        for l in range(_n_stack(stack)):
            lp = layer_slice(stack, l)
            h = apply_norm(cfg.norm, lp["ln1"], x)
            a = chunk_fn(lp["attn"], cfg, h, layer_slice(caches, g), pos,
                         valid, block_table)
            x = x + torch.where(vm, a, 0.0).to(x.dtype)
            h2 = apply_norm(cfg.norm, lp["ln2"], x)
            f, y = _ffn(lp, cfg, h2, kind, _layer_plan(mor_stack, l),
                        mor_mode, token_mask=valid)
            y.pop("lb_loss", None)
            ys.append(y)
            x = x + torch.where(vm, f, 0.0).to(x.dtype)
            g += 1
        aux.update(_stack_aux(ys, prefix))
    cache["pos"] += n_valid.to(cache["pos"].dtype)
    x = apply_norm(cfg.norm, params["final_norm"], x)
    logits = (x @ _head(params, cfg).to(x.dtype)).float()
    return logits, aux


# --------------------------------------------------------------------------
# decode cache
# --------------------------------------------------------------------------

def cache_init(cfg: ModelConfig, batch: int, max_len: int, dtype,
               device) -> Dict:
    """The slotted decode cache: one stack of all ``n_layers`` layers
    (GQA ring rows, or MLA latent rows over the full ``max_len``)."""
    _check_family(cfg, decode=True)
    init = attn.mla_cache_init if cfg.mla else attn.gqa_cache_init
    return {"pos": torch.zeros((), dtype=torch.int32, device=device),
            "layers": init(cfg, batch, max_len, dtype, cfg.n_layers,
                           device)}
