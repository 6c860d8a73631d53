"""Step functions (``repro.launch.steps``): the train step (loss,
gradients and AdamW, with micro-batch accumulation), and the serving
steps: the teacher-forced prefill, the static batch's prefill step over
the slot pool, its width-1 decode step, and the single-token serve step
over ``cache_init``'s cache.

The JAX package compiles each step once (``jax.jit``, the params,
optimizer state or cache donated); here a step is a plain function that
updates them IN PLACE and hands them back, so that the two packages'
call sites read the same.  No step reads a device value back to the
host: tokens, losses and norms stay device tensors.

Every step takes an optional ``mesh`` (``launch.mesh.make_host_mesh``):
the params, optimizer state and cache it is handed are then this
rank's blocks (``sharding_rules.shard_tree`` over ``mesh_specs``), the
batch is the global one, of which each data rank runs its
``batch_sharding`` slice, and the model code runs under
``activation_context`` (gather-on-use, tensor parallelism, expert
slicing, the sequence-sharded decode).  Tokens come back whole on
every rank.  The mesh may be the multi-pod one (``make_host_mesh(...,
pods=)``): the data-parallel reductions then run over the ``("pod",
"data")`` tuple (``sharding_rules.dp_group``).

``make_train_step`` and ``make_prefill`` take ``sequence_parallel``
(the residual stream S-sharded over ``model`` between blocks:
``sharding_rules``), and they and ``make_serve_step`` take
``param_layout``: "fsdp_tp" (the reference's train.py's: ``model`` on
the input projections' output dim and the output projections' input
dim) or "contract_tp" (``_PARAM_RULES_CONTRACT``: ``model`` on the
input projections' contraction dim and the output projections' output
dim).  The tensor-parallel layers consume "fsdp_tp"'s splits as they
lie: GQA and MLA by head, the dense FFN by d_ff, RWKV6's time mix by
head and its channel mix by d_ff, Mamba2 by head, zamba2's shared GQA
+ FFN, the vocabulary-parallel embedding and head, the experts of
``moe_apply_a2a`` and ``_moe_mesh``'s f columns; each where its heads
divide over ``model``.  A dense FFN or channel mix under an active MoR
plan (``mor``, ``mor_mode``: every mode; plans attached by
``core.deploy.attach_plans``, which carry their proxy counts) runs on
the rank's own d_ff columns where they divide over ``model`` in whole
``tile_n`` tiles:
the rank's plan predicts and computes its column block of one device's
tile mask after two exchanges, its proxies' ReLU inputs over ``model``
and, where a budget can bite, its tile rows' live counts over the mesh
(``core.executor``).  Under "contract_tp" each layer moves its splits
onto those dims first (one all-to-all over ``model`` a leaf:
``sharding_rules.use``), so that GQA, the dense FFN, Mamba2, zamba2's
shared block, hubert's encoder, the ``moe_tp`` experts and the head
run on the rank's own heads or columns as under "fsdp_tp"; its MLA
and RWKV6 splits are not moved.  Where a layer's tensor-parallel form
does not consume a leaf's split (a form's dim that does not divide
over ``model``, an FFN under an active MoR plan whose d_ff does not
divide into whole tiles, an expert plan on ``_moe_mesh``'s f split,
MLA and RWKV6 under "contract_tp"), the leaf is gathered whole where
it is used, and the layer computes as one device would.  The static
decode keeps (and under "contract_tp" moves) GQA's, MLA's, the FFN's
and zamba2's shared block's splits; RWKV6 and the mamba layers decode
whole on every rank.  Each data rank runs its rows of the batch (the
whole batch where the data ranks do not divide it: the context's
``rows_split``), and a MoR plan's capacity clip counts over the global
batch, as one device's does.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives as co
from repro_torch.distributed import sharding_rules as sr
from repro_torch.models import get_model
from repro_torch.models.transformer import full_logits
from repro_torch.optim import OptConfig, adamw_init, adamw_update
from repro_torch.optim.schedules import cosine_schedule
from repro_torch.tree import leaves, unflatten

LB_LOSS_WEIGHT = 0.01


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab: Optional[int] = None) -> torch.Tensor:
    """Mean over positions of the float32 log-sum-exp minus the gold
    logit.  Under a mesh whose head left the vocabulary split (``logits``
    narrower than ``vocab``), the vocabulary-parallel loss of the
    reference's "TP-friendly" form: the max, the sum of exponentials and
    the gold logit (picked where this rank holds the label's column)
    are each reduced over ``model``, so that the logits are never
    gathered."""
    lf = logits.float()
    group = sr.model_group()
    if group is None or vocab is None or lf.shape[-1] == vocab:
        lse = torch.logsumexp(lf, dim=-1)
        gold = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
        return (lse - gold).mean()
    n = lf.shape[-1]
    with torch.no_grad():
        m = co.all_reduce_max(lf.amax(-1), group)
    sumexp = co.all_reduce_sum(torch.exp(lf - m[..., None]).sum(-1), group)
    t = labels.long() - group.rank * n
    ok = (t >= 0) & (t < n)
    gold = torch.gather(lf, -1, torch.clamp(t, 0, n - 1)[..., None])[..., 0]
    gold = co.all_reduce_sum(torch.where(ok, gold, 0.0), group)
    return (torch.log(sumexp) + m - gold).mean()


def mesh_specs(cfg: ModelConfig, mesh, layout: str = "fsdp_tp"):
    """``param_sharding`` of the config's params (their shapes on the
    meta device) on ``mesh``, the expert mode its ``expert_sharding``
    asks for, in ``layout`` (by default "fsdp_tp", the reference's
    train.py's)."""
    from repro_torch.models import param_shapes
    return sr.param_sharding(param_shapes(cfg), mesh,
                             moe_mode=sr.moe_mode_of(cfg), layout=layout)


def opt_specs(opt_state, specs):
    """The optimizer state's specs: each moment and the master copy
    follow their param's; the step counter is replicated."""
    out = {k: specs for k in opt_state if k != "step"}
    out["step"] = ()
    return out


def _context(mesh, specs, sequence_parallel: bool = False, rows=None):
    """The step's ``activation_context``; ``rows``: a global batch leaf,
    whose ``local_rows`` say whether the data ranks hold distinct rows."""
    if mesh is None:
        return contextlib.nullcontext()
    split = rows is None or _rows_split(rows, mesh)
    return sr.activation_context(mesh, sequence_parallel, specs=specs,
                                 rows_split=split)


def _rows_split(x: torch.Tensor, mesh) -> bool:
    """Whether ``local_rows`` hands the data ranks distinct rows of
    ``x``."""
    if getattr(mesh, "groups", None) is None:
        return False
    return bool(sr.batch_sharding({"x": x}, mesh)["x"])


def local_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """This data rank's ``batch_sharding`` slice of a global batch leaf
    (the whole leaf where the data ranks do not divide it)."""
    if mesh is None or getattr(mesh, "groups", None) is None:
        return x
    spec = sr.batch_sharding({"x": x}, mesh)["x"]
    return sr.shard_leaf(x, spec, mesh) if spec else x


def _whole_rows(x: torch.Tensor, mesh, n: int) -> torch.Tensor:
    """The data ranks' rows back in one tensor of ``n`` rows."""
    if mesh is None or getattr(mesh, "groups", None) is None or \
            x.shape[0] == n:
        return x
    return co.all_gather(x, 0, sr.dp_group(mesh), "tokens")


def make_loss_fn(cfg: ModelConfig) -> Callable:
    """-> loss_fn(params, batch) -> (loss, aux): the cross entropy of the
    teacher-forced forward (a vision batch's logits cut to the labels'
    positions), plus ``LB_LOSS_WEIGHT`` x the mean load-balance loss of
    a moe model."""
    api = get_model(cfg)

    def loss_fn(params, batch):
        logits, aux = api.forward(params, cfg, batch)
        labels = batch["labels"]
        if cfg.frontend == "vision_stub":
            logits = logits[:, -labels.shape[1]:, :]
        loss = cross_entropy(logits, labels, cfg.vocab_size)
        if cfg.family == "moe" and "lb_loss" in aux:
            loss = loss + LB_LOSS_WEIGHT * torch.mean(aux["lb_loss"])
        return loss, aux

    return loss_fn


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig,
                    total_steps: int = 10000, warmup: int = 100,
                    mesh=None, sequence_parallel: bool = False,
                    param_layout: str = "fsdp_tp") -> Callable:
    """-> train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), params and state updated IN PLACE.

    ``cfg.grad_accum`` > 1 splits the global batch (leading dim) into
    that many micro-batches, one forward and backward each, and sums the
    gradients into float32 accumulators: the live activation set is one
    micro-batch's.  Gradients and loss are then divided by the count.
    The learning rate follows ``cosine_schedule(step, total_steps,
    warmup)``.  metrics: "loss", "grad_norm", "lr" (device tensors).

    On a ``mesh`` the params and state are this rank's blocks of
    ``mesh_specs(cfg, mesh, param_layout)`` and ``batch`` the global
    batch (the residual stream S-sharded where ``sequence_parallel``):
    each data rank runs its slice, a leaf replicated over ``data`` has
    its gradient all-reduced and a leaf placed on ``data`` comes out of
    the gather-on-use reduce-scattered, both then divided by the data
    ranks; the clip is the single-device clip (``global_norm`` over the
    mesh), and "loss" the mean over the data ranks."""
    loss_fn = make_loss_fn(cfg)
    accum = max(cfg.grad_accum, 1)
    specs = (mesh_specs(cfg, mesh, param_layout) if mesh is not None
             else None)
    flat_specs = (list(sr.spec_paths(specs).values())
                  if specs is not None else None)

    def grads_of(params, flat, batch):
        loss, _ = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        # a leaf the loss never reads (the audio family's token
        # embedding) has a zero gradient, as under ``jax.grad``
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(flat, grads)]

    def train_step(params, opt_state, batch):
        batch = {k: local_rows(v, mesh) for k, v in batch.items()}
        flat = leaves(params)
        for p in flat:
            p.requires_grad_(True)
        try:
            with _context(mesh, specs, sequence_parallel):
                if accum > 1:
                    acc = [torch.zeros_like(p, dtype=torch.float32)
                           for p in flat]
                    loss = torch.zeros((), dtype=torch.float32,
                                       device=flat[0].device)
                    for i in range(accum):
                        mb = {k: v.reshape(accum, v.shape[0] // accum,
                                           *v.shape[1:])[i]
                              for k, v in batch.items()}
                        l, gs = grads_of(params, flat, mb)
                        for a, g in zip(acc, gs):
                            a.add_(g)
                        del gs
                        loss += l
                    grads = [a.div_(accum) for a in acc]
                    loss = loss / accum
                else:
                    loss, grads = grads_of(params, flat, batch)
        finally:
            for p in flat:
                p.requires_grad_(False)
        if specs is not None:
            grads = _data_reduce(grads, flat_specs, mesh)
            loss = _data_mean(loss, mesh)
        lr_scale = cosine_schedule(opt_state["step"], total_steps, warmup)
        params, opt_state, metrics = adamw_update(
            params, unflatten(params, list(grads)), opt_state, opt_cfg,
            lr_scale, mesh=mesh, specs=specs)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def _data_reduce(grads, flat_specs, mesh):
    """The data ranks' mean gradient: a leaf placed on a data-parallel
    axis was summed by its gather's backward, any other is all-reduced
    here."""
    group = sr.dp_group(mesh)
    if group.size == 1:
        return grads
    out = []
    for g, spec in zip(grads, flat_specs):
        if not sr.on_dp(spec):
            g = co.all_reduce(g, group, "grad_mean")
        out.append(g / group.size)
    return out


def _data_mean(x: torch.Tensor, mesh) -> torch.Tensor:
    group = sr.dp_group(mesh)
    if group.size == 1:
        return x
    return co.all_reduce(x, group, "loss_mean") / group.size


def init_train_state(gen: torch.Generator, cfg: ModelConfig,
                     opt_cfg: OptConfig) -> Tuple[Dict, Dict[str, Any]]:
    """-> (params from ``gen`` on its device, their AdamW state)."""
    params = get_model(cfg).init(gen, cfg)
    return params, adamw_init(params, opt_cfg)


def _argmax(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def make_prefill(cfg: ModelConfig, mor=None, mor_mode: str = "dense",
                 mesh=None, sequence_parallel: bool = False,
                 param_layout: str = "fsdp_tp") -> Callable:
    """prefill(params, batch) -> the greedy next token (B,) after the
    teacher-forced forward (or the forward's output, for a model without
    a vocabulary).  On a ``mesh``: the rank's blocks of the params
    (``mesh_specs(cfg, mesh, param_layout)``), the global batch, of
    which each data rank runs its rows (S-sharded between blocks where
    ``sequence_parallel``); the tokens (or this data rank's outputs)
    come back whole."""
    api = get_model(cfg)
    specs = (mesh_specs(cfg, mesh, param_layout) if mesh is not None
             else None)

    def prefill(params, batch):
        n = next(iter(batch.values())).shape[0]
        with _context(mesh, specs, sequence_parallel,
                      next(iter(batch.values()))):
            logits, _ = api.forward(params, cfg, {
                k: local_rows(v, mesh) for k, v in batch.items()},
                mor=mor, mor_mode=mor_mode)
            if logits.ndim != 3:
                return logits
            last = logits[:, -1, :]
            if cfg.vocab_size:
                last = full_logits(last, cfg)
        return _whole_rows(_argmax(last), mesh, n)

    return prefill


def make_prefill_step(cfg: ModelConfig, mor=None, mor_mode: str = "dense",
                      chunk: int = 0, mesh=None) -> Callable:
    """prefill_step(params, cache, prompts (B, P)) -> (next tokens (B,),
    cache) on the slot pool (``serving.kv_pool.init``).

    A transformer family whose prompt fits its window runs ONE batched
    dispatch (``api.prefill``).  The recurrent families (ssm, hybrid)
    and prompts longer than the sliding window run chunked prefill:
    fixed-shape (B, ``chunk``) dispatches of ``api.prefill_chunk``, the
    last one ragged through ``n_valid``.  Both give the teacher-forced
    forward's logits.  On a ``mesh``: the rank's blocks of the params
    and of the cache (``init_cache``), the global prompts, of which each
    data rank prefills its rows; the tokens come back whole."""
    api = get_model(cfg)
    chunk = chunk or cfg.serve_chunk
    assert api.prefill_chunk is not None, f"{cfg.name} has no chunk step"
    specs = mesh_specs(cfg, mesh) if mesh is not None else None

    def prefill_step(params, cache, prompts):
        n = prompts.shape[0]
        with _context(mesh, specs, rows=prompts):
            nxt, cache = _prefill(params, cache, local_rows(prompts, mesh))
        return _whole_rows(nxt, mesh, n), cache

    def _prefill(params, cache, prompts):
        B, P = prompts.shape
        if api.prefill is not None and \
                (not cfg.sliding_window or P <= cfg.sliding_window):
            logits = api.prefill(params, cfg, prompts, cache, mor=mor,
                                 mor_mode=mor_mode)
            return _argmax(logits), cache
        off = 0
        while off < P:
            take = min(chunk, P - off)
            toks = F.pad(prompts[:, off:off + take], (0, chunk - take))
            n_valid = torch.full((B,), take, dtype=torch.int32,
                                 device=prompts.device)
            logits, _ = api.prefill_chunk(params, cfg, toks, cache,
                                          n_valid=n_valid, mor=mor,
                                          mor_mode=mor_mode)
            nxt = _argmax(logits[:, take - 1])
            off += take
        return nxt, cache

    return prefill_step


def make_decode_step(cfg: ModelConfig, mor=None, mor_mode: str = "dense",
                     mesh=None) -> Callable:
    """decode_step(params, cache, tokens (B, 1)) -> (next tokens, cache,
    aux) on the slot pool: a chunk dispatch of width 1, so that decode
    runs the serving path (and yields its MoR skip stats in ``aux``).
    On a ``mesh`` the chunk step gathers every layer whole (the slot
    pool is not sharded) and each data rank decodes its slots' rows of
    ``tokens`` (its own slot pool)."""
    api = get_model(cfg)
    assert api.prefill_chunk is not None, f"{cfg.name} has no chunk step"
    specs = mesh_specs(cfg, mesh) if mesh is not None else None

    def decode_step(params, cache, tokens):
        n = tokens.shape[0]
        context = _context(mesh, specs, rows=tokens)
        tokens = local_rows(tokens, mesh)
        n_valid = torch.ones((tokens.shape[0],), dtype=torch.int32,
                             device=tokens.device)
        with context:
            logits, aux = api.prefill_chunk(params, cfg, tokens, cache,
                                            n_valid=n_valid, mor=mor,
                                            mor_mode=mor_mode)
        return _whole_rows(_argmax(logits[:, 0]), mesh, n), cache, aux

    return decode_step


def make_serve_step(cfg: ModelConfig, mor=None, mor_mode: str = "dense",
                    mesh=None, sequence_parallel: bool = False,
                    param_layout: str = "fsdp_tp") -> Callable:
    """serve_step(params, cache, tokens (B, 1)) -> (next tokens, cache)
    over ``cache_init``'s cache (one shared position).  On a ``mesh``
    the params (``mesh_specs(cfg, mesh, param_layout)``) and the cache
    (``init_cache``) are the rank's blocks: the tensor-parallel decode
    over the sequence-sharded ring (``attention._tp_decode``); each data
    rank decodes its rows of ``tokens`` and the tokens come back whole.
    A decode's residual is never S-sharded (the reference's
    ``residual_decode``): ``sequence_parallel`` is taken and the step
    runs with it off."""
    api = get_model(cfg)
    assert api.decode_step is not None, f"{cfg.name} has no decode step"
    del sequence_parallel
    specs = (mesh_specs(cfg, mesh, param_layout) if mesh is not None
             else None)

    def serve_step(params, cache, tokens):
        n = tokens.shape[0]
        with _context(mesh, specs, rows=tokens):
            logits = api.decode_step(params, cfg, local_rows(tokens, mesh),
                                     cache, mor=mor, mor_mode=mor_mode)
        return _whole_rows(_argmax(logits), mesh, n), cache

    return serve_step


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device,
               mesh=None, dtype=None) -> Dict:
    """``cache_init``'s cache for ``batch`` sequences; on a ``mesh`` this
    rank's block of it (its data shard's rows, its ring rows)."""
    api = get_model(cfg)
    if mesh is not None and getattr(mesh, "groups", None) is not None:
        dp = sr.dp_group(mesh).size
        if batch % dp == 0:
            batch //= dp
    with _context(mesh, None):
        return api.cache_init(cfg, batch, max_len, dtype or cfg.tdtype,
                              device)
