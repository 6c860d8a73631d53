"""Decoder LM / encoder assembly for the dense, moe, vlm and audio
families (``repro.models.transformer``).

Parameters keep the JAX package's layer-stacked layout (every per-layer
leaf has a leading L dim, ``x @ w`` weights are (d_in, d_out)): the
dense family has one ``layers`` stack; the moe family a ``dense_layers``
stack (the first ``first_k_dense`` layers, a dense FFN) and a
``moe_layers`` stack.  Attention is GQA or, with ``cfg.mla``, MLA.  The
layer loop is a Python loop over views of those stacks; the serving
cache keeps ONE stack of all ``n_layers`` layers, indexed by the global
layer number.  Under autograd (training) ``forward`` rematerialises each
block as ``cfg.remat`` says (``_remat``: the reference's
``jax.checkpoint`` policies), and takes its layer views with one
``unbind`` a stacked leaf, whose backward stacks the layers' gradients
in one pass.  The modality frontends are stubs, as in the JAX package:
the vlm family prepends pre-computed patch embeddings
(``batch["patch_embeds"]``) to the token embeddings in ``forward`` and
serves text only; the audio family (an encoder: ``cfg.causal`` False,
no decode) takes frame embeddings (``batch["frames"]``) through an input
norm (``in_norm``) and has no token embedding in its inputs.

Under a mesh (``distributed.sharding_rules.activation_context`` with
the params' spec tree) the params are this rank's blocks: each layer's
leaves are gathered where they are used (``use_layer``, inside the
rematerialised block, so that one gathered layer is live at a time),
except the ``model`` dims the tensor-parallel attention (GQA and MLA),
FFN and experts consume; the embedding is vocabulary-parallel (a masked local
lookup and one ``all_reduce_sum``) and the head column-parallel where
the rules split the vocabulary, and ``forward`` then returns this
rank's vocabulary block of the logits (``launch.steps.cross_entropy``
reduces it); the serving steps gather the logits whole.  The static
prefill and decode keep the same splits (``attention._tp_decode``,
``mla_decode``); the serving chunk step runs every layer gathered
whole.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils import checkpoint as _ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives as co
from repro_torch.distributed import sharding_rules as sr
from repro_torch.models.layers import attention as attn
from repro_torch.models.layers import mlp as mlp_mod
from repro_torch.models.layers import moe as moe_mod
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


def layer_views(tree) -> List:
    """Every layer's views of a layer-stacked dict tree, one ``unbind``
    a leaf: the backward of ``unbind`` stacks the layers' gradients in
    one pass, where ``layer_slice``'s would add each layer's into a
    zeroed full-size stack."""
    if isinstance(tree, dict):
        per_key = {k: layer_views(v) for k, v in tree.items()}
        n = len(next(iter(per_key.values())))
        return [{k: v[l] for k, v in per_key.items()} for l in range(n)]
    return list(tree.unbind(0))


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """``jax.checkpoint_policies.dots_saveable``: keep the products'
    outputs, recompute everything else."""
    policy = _ckpt.CheckpointPolicy
    return (policy.MUST_SAVE if op in _DOTS
            else policy.PREFER_RECOMPUTE)


def _remat(fn: Callable, remat: str) -> Callable:
    """``fn`` under the activation checkpointing ``remat`` names
    (``repro.models.transformer._remat``): "none", "nothing_saveable"
    (every activation inside ``fn`` is recomputed in the backward) or
    "dots_saveable" (the matmul outputs are kept).  Only while autograd
    records: serving and calibration run ``fn`` as it is.  ``fn`` draws
    no random numbers, so the RNG state is not stashed."""
    if remat == "none" or not torch.is_grad_enabled():
        return fn
    kw: Dict[str, Any] = {"use_reentrant": False,
                          "preserve_rng_state": False}
    if remat == "dots_saveable":
        kw["context_fn"] = functools.partial(
            _ckpt.create_selective_checkpoint_contexts, _save_dots)
    elif remat != "nothing_saveable":
        raise ValueError(f"unknown remat policy {remat!r}")
    return lambda *a: _ckpt.checkpoint(fn, *a, **kw)


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


def _stack_key(kind: str, prefix: str) -> str:
    """The params key of a ``_groups`` entry."""
    return "moe_layers" if kind == "moe" else (
        "dense_layers" if prefix == "dense_" else "layers")


def _group_specs(key: str):
    """One layer's specs of the stack ``key`` under the active mesh, or
    None."""
    ctx = sr.current()
    if ctx is None or ctx.specs is None:
        return None
    return sr.layer_specs(ctx.specs[key])


def use_layer(lp: Dict, lspec, cfg: ModelConfig, kind: str, ml,
              mor_mode: str, T_loc: int, masked: bool = False,
              tp: bool = True) -> Dict:
    """Gather-on-use of one layer's leaves (``sharding_rules.use``),
    leaving split the ``model`` splits its tensor-parallel attention,
    FFN or experts consume (``tp``; none on the serving chunk path),
    moved onto the dims those forms consume them on where the layout
    put them elsewhere (``"contract_tp"``).  A dense FFN under an active
    MoR plan stays split where its d_ff divides over ``model`` in whole
    tiles (``mlp.mor_whole``), and is gathered whole elsewhere."""
    if lspec is None:
        return lp
    from repro_torch.core.executor import as_expert_plan, as_plan
    mesh = sr.current().mesh
    keep: dict = {}
    if tp:
        keep.update(attn.tp_keep(cfg, lspec["attn"], mesh.shape["model"]))
        if kind == "moe":
            em = ml.get("experts") if isinstance(ml, dict) else None
            active = as_expert_plan(
                em, mode=mor_mode, tile_m=cfg.mor.tile_m,
                tile_n=cfg.mor.tile_n).active
            keep.update(moe_mod.tp_keep(cfg, lspec["moe"], mesh, T_loc,
                                        masked, active))
        else:
            active = as_plan(ml, mode=mor_mode, tile_m=cfg.mor.tile_m,
                             tile_n=cfg.mor.tile_n).active
            keep.update(mlp_mod.tp_keep(
                lspec["mlp"], mlp_mod.mor_whole(cfg, mesh.shape["model"],
                                                active), "mlp/"))
    return sr.use(lp, lspec, keep)


def use_top(params: Dict, cfg: ModelConfig, tp: bool = True,
            keep=None) -> Dict:
    """The params outside the layer stacks, gathered for use: the
    embedding's vocabulary dim and the head's stay split over ``model``
    (``tp``), as do the leaves named in ``keep`` ({'/'-joined path: the
    dim its form consumes}: zamba2's shared block).  Under
    ``"fsdp_tp"`` the head is split by vocabulary column; under
    ``"contract_tp"`` by input row, and ``sharding_rules.use`` moves it
    onto the vocabulary (dim -1) where the vocabulary divides over
    ``model``.  The embedding is split by vocabulary row under both."""
    ctx = sr.current()
    if ctx is None or ctx.specs is None:
        return params
    top = {k: v for k, v in params.items() if not k.endswith("layers")}
    specs = {k: ctx.specs[k] for k in top}
    keep = dict(keep or {})
    if tp and cfg.vocab_size:
        if sr.on_model(specs, "embed", 0):
            keep["embed"] = 0
        if "lm_head" in specs and sr.model_dim(specs, "lm_head") is not None:
            keep["lm_head"] = -1
    out = dict(params)
    out.update(sr.use(top, specs, keep))
    return out


def embed_tokens(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``embed[tokens]``; on a vocabulary-parallel embedding (this rank's
    rows [r V / MP, (r + 1) V / MP)) a masked local lookup summed over
    ``model`` (the rows are disjoint: the sum is exact), under sequence
    parallelism this rank's S rows of the sum (a reduce-scatter)."""
    group = sr.split_group(embed)
    if group is None:
        return embed[tokens.long()]
    n = embed.shape[0]
    t = tokens.long() - group.rank * n
    ok = (t >= 0) & (t < n)
    x = embed[torch.clamp(t, 0, n - 1)] * ok[..., None].to(embed.dtype)
    return sr.tp_exit(x, group, 1)


def head_logits(params: Dict, cfg: ModelConfig, x: torch.Tensor
                ) -> torch.Tensor:
    """x @ the head; a column-parallel head gives this rank's vocabulary
    block (its input entering through ``copy_to_model``)."""
    head = _head(params, cfg)
    src = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    group = sr.split_group(src)
    if group is not None:
        x = sr.tp_enter(x, group)
    return x @ head.to(x.dtype)


def full_logits(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The whole vocabulary of logits a vocabulary-parallel head left
    split (gathered over ``model``), else ``logits``."""
    group = sr.model_group()
    if group is None or logits.shape[-1] == cfg.vocab_size:
        return logits
    return co.all_gather(logits, logits.ndim - 1, group, "logits")


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
    them; under sequence parallelism this rank's S rows."""
    dt = cfg.tdtype
    if cfg.frontend == "audio_stub":
        return sr.seq_split(apply_norm(cfg.norm, params["in_norm"],
                                       batch["frames"].to(dt)))
    if cfg.frontend == "vision_stub" and "patch_embeds" in batch:
        with sr.sequence_parallel(False):
            x = embed_tokens(params["embed"], batch["tokens"]).to(dt)
        return sr.seq_split(torch.cat([batch["patch_embeds"].to(dt), x],
                                      1))
    x = embed_tokens(params["embed"], batch["tokens"]).to(dt)
    return x if sr.split_group(params["embed"]) is not None else \
        sr.seq_split(x)


def _seq_len(cfg: ModelConfig, batch: Dict) -> Tuple[int, int]:
    """(B, S) of the residual stream a batch makes."""
    if cfg.frontend == "audio_stub":
        return tuple(batch["frames"].shape[:2])
    B, S = batch["tokens"].shape
    if cfg.frontend == "vision_stub" and "patch_embeds" in batch:
        S += batch["patch_embeds"].shape[1]
    return B, S


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
    B, S = _seq_len(cfg, batch)
    with sr.seq_sharded(S):
        return _forward(params, cfg, batch, mor, mor_mode, with_taps, B, S)


def _forward(params, cfg, batch, mor, mor_mode, with_taps, B, S):
    """``forward``'s body; under sequence parallelism the residual
    stream between blocks holds this rank's S / MP rows: each block
    gathers S for its attention and its FFN (``sharding_rules.
    seq_call``: the tensor-parallel ones reduce-scatter their output,
    the others keep their rows of it), and the head reads them
    gathered."""
    params = use_top(params, cfg)
    x = _embed_inputs(params, cfg, batch)
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    attn_fn = attn.mla_forward if cfg.mla else attn.gqa_forward

    def block(x, lp, ml, kind, lspec):
        lp = use_layer(lp, lspec, cfg, kind, ml, mor_mode, B * S)
        h = apply_norm(cfg.norm, sr.seq_weights(lp["ln1"]), x)
        x = x + sr.seq_call(
            lambda h: attn_fn(lp["attn"], cfg, h, positions),
            attn.tp_group(lp["attn"]) is not None, h)
        h2 = apply_norm(cfg.norm, sr.seq_weights(lp["ln2"]), x)

        def ffn(h2):
            f, y = _ffn(lp, cfg, h2, kind, ml, mor_mode)
            if with_taps:
                y["taps"] = (moe_taps(lp["moe"], cfg, h2) if kind == "moe"
                             else mlp_taps(lp["mlp"], cfg, h2))
            return f, y
        f, y = sr.seq_call(ffn, kind != "moe" and sr.split_group(
            lp["mlp"]["w_down"]) is not None, h2)
        return x + f, y

    body = _remat(sr.bind(block), cfg.remat)
    aux: Dict[str, Any] = {}
    for kind, stack, mor_stack, prefix in _groups(params, cfg, mor):
        ys = []
        lspec = _group_specs(_stack_key(kind, prefix))
        for l, lp in enumerate(layer_views(stack)):
            x, y = body(x, lp, _layer_plan(mor_stack, l), kind, lspec)
            ys.append(y)
        aux.update(_stack_aux(ys, prefix))
    x = apply_norm(cfg.norm, sr.seq_weights(params["final_norm"]), x)
    if not cfg.vocab_size:
        return sr.seq_gather(x, False), aux
    src = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    x = sr.seq_gather(x, sr.split_group(src) is not None)
    return head_logits(params, cfg, x), aux


# --------------------------------------------------------------------------
# the static batch: a batched prefill, then one token per step
# --------------------------------------------------------------------------

def _static_layers(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                   cache: Dict, attn_fn, mor: Optional[Dict],
                   mor_mode: str) -> torch.Tensor:
    """Every block over ``x`` with ``attn_fn(lp, cfg, h, layer cache)``
    as its attention; the layers' caches are views of the one stack,
    indexed by the global layer number.  The expert FFNs run without a
    token mask, as in the JAX package: every row is real, and expert
    capacity follows the capacity factor over the B * S tokens."""
    caches = cache["layers"]
    g = 0                                   # global layer index
    T = x.shape[0] * x.shape[1]
    for kind, stack, mor_stack, prefix in _groups(params, cfg, mor):
        lspec = _group_specs(_stack_key(kind, prefix))
        for l in range(_n_stack(stack)):
            lp = use_layer(layer_slice(stack, l), lspec, cfg, kind,
                           _layer_plan(mor_stack, l), mor_mode, T)
            h = apply_norm(cfg.norm, lp["ln1"], x)
            x = x + attn_fn(lp["attn"], cfg, h, layer_slice(caches, g))
            h2 = apply_norm(cfg.norm, lp["ln2"], x)
            f, _ = _ffn(lp, cfg, h2, kind, _layer_plan(mor_stack, l),
                        mor_mode)
            x = x + f
            g += 1
    return apply_norm(cfg.norm, params["final_norm"], x)


def prefill(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
            cache: Dict, *, mor: Optional[Dict] = None,
            mor_mode: str = "dense") -> torch.Tensor:
    """tokens: (B, S) prompt -> last-position logits (B, V).

    One step consumes the whole prompt (``repro.models.transformer.
    prefill``): forward-style causal attention over the batch while
    every layer writes its S kv rows into the cache IN PLACE, then
    ``cache["pos"] += S``.  The MoR predictor runs once a layer over all
    B * S rows.  The cache is ``cache_init``'s or the slot pool's
    (``serving.kv_pool.init``); it must be FRESH (every position 0,
    which is not checked: that would read the device) and hold S rows
    (S <= the kv ring, which raises)."""
    _check_family(cfg, decode=True)
    S = tokens.shape[1]
    fn = attn.mla_prefill if cfg.mla else attn.gqa_prefill
    params = use_top(params, cfg)
    x = embed_tokens(params["embed"], tokens).to(cfg.tdtype)
    x = _static_layers(params, cfg, x, cache, fn, mor, mor_mode)
    cache["pos"] += S
    return full_logits(head_logits(params, cfg, x[:, -1, :]), cfg)


def decode_step(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
                cache: Dict, *, mor: Optional[Dict] = None,
                mor_mode: str = "dense") -> torch.Tensor:
    """tokens: (B, 1) -> logits (B, V) at the shared position
    ``cache["pos"]`` of ``cache_init``'s cache, which is UPDATED IN
    PLACE (``repro.models.transformer.decode_step``)."""
    _check_family(cfg, decode=True)
    pos = cache["pos"]
    fn = attn.mla_decode if cfg.mla else attn.gqa_decode
    params = use_top(params, cfg)
    x = embed_tokens(params["embed"], tokens).to(cfg.tdtype)
    x = _static_layers(params, cfg, x, cache,
                       lambda p, c, h, lc: fn(p, c, h, lc, pos), mor,
                       mor_mode)
    cache["pos"] += 1
    return full_logits(head_logits(params, cfg, x[:, 0, :]), cfg)


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
    params = use_top(params, cfg, tp=False)
    x = params["embed"][tokens.long()].to(cfg.tdtype)
    x = torch.where(vm, x, torch.zeros((), dtype=x.dtype, device=x.device))
    caches = cache["layers"]
    chunk_fn = attn.mla_chunk if cfg.mla else attn.gqa_chunk
    aux: Dict[str, Any] = {}
    g = 0                                   # global layer index
    for kind, stack, mor_stack, prefix in _groups(params, cfg, mor):
        ys = []
        lspec = _group_specs(_stack_key(kind, prefix))
        for l in range(_n_stack(stack)):
            lp = use_layer(layer_slice(stack, l), lspec, cfg, kind, None,
                           mor_mode, B * C, masked=True, tp=False)
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
    (GQA ring rows, or MLA latent rows over the full ``max_len``).
    Under a mesh of MP > 1 ``model`` ranks this rank's block of the GQA
    ring (``attention.gqa_cache_init``); ``batch`` is the rank's own
    (its data shard's) count."""
    _check_family(cfg, decode=True)
    init = attn.mla_cache_init if cfg.mla else attn.gqa_cache_init
    return {"pos": torch.zeros((), dtype=torch.int32, device=device),
            "layers": init(cfg, batch, max_len, dtype, cfg.n_layers,
                           device)}
