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
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import get_model
from repro_torch.optim import OptConfig, adamw_init, adamw_update
from repro_torch.optim.schedules import cosine_schedule
from repro_torch.tree import leaves, unflatten

LB_LOSS_WEIGHT = 0.01


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """Mean over positions of the float32 log-sum-exp minus the gold
    logit."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    return (lse - gold).mean()


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
        loss = cross_entropy(logits, labels)
        if cfg.family == "moe" and "lb_loss" in aux:
            loss = loss + LB_LOSS_WEIGHT * torch.mean(aux["lb_loss"])
        return loss, aux

    return loss_fn


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig,
                    total_steps: int = 10000, warmup: int = 100,
                    ) -> Callable:
    """-> train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), params and state updated IN PLACE.

    ``cfg.grad_accum`` > 1 splits the global batch (leading dim) into
    that many micro-batches, one forward and backward each, and sums the
    gradients into float32 accumulators: the live activation set is one
    micro-batch's.  Gradients and loss are then divided by the count.
    The learning rate follows ``cosine_schedule(step, total_steps,
    warmup)``.  metrics: "loss", "grad_norm", "lr" (device tensors)."""
    loss_fn = make_loss_fn(cfg)
    accum = max(cfg.grad_accum, 1)

    def grads_of(params, flat, batch):
        loss, _ = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        # a leaf the loss never reads (the audio family's token
        # embedding) has a zero gradient, as under ``jax.grad``
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(flat, grads)]

    def train_step(params, opt_state, batch):
        flat = leaves(params)
        for p in flat:
            p.requires_grad_(True)
        try:
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
        lr_scale = cosine_schedule(opt_state["step"], total_steps, warmup)
        params, opt_state, metrics = adamw_update(
            params, unflatten(params, list(grads)), opt_state, opt_cfg,
            lr_scale)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def init_train_state(gen: torch.Generator, cfg: ModelConfig,
                     opt_cfg: OptConfig) -> Tuple[Dict, Dict[str, Any]]:
    """-> (params from ``gen`` on its device, their AdamW state)."""
    params = get_model(cfg).init(gen, cfg)
    return params, adamw_init(params, opt_cfg)


def _argmax(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def make_prefill(cfg: ModelConfig, mor=None, mor_mode: str = "dense"
                 ) -> Callable:
    """prefill(params, batch) -> the greedy next token (B,) after the
    teacher-forced forward (or the forward's output, for a model without
    a vocabulary)."""
    api = get_model(cfg)

    def prefill(params, batch):
        logits, _ = api.forward(params, cfg, batch, mor=mor,
                                mor_mode=mor_mode)
        return _argmax(logits[:, -1, :]) if logits.ndim == 3 else logits

    return prefill


def make_prefill_step(cfg: ModelConfig, mor=None, mor_mode: str = "dense",
                      chunk: int = 0) -> Callable:
    """prefill_step(params, cache, prompts (B, P)) -> (next tokens (B,),
    cache) on the slot pool (``serving.kv_pool.init``).

    A transformer family whose prompt fits its window runs ONE batched
    dispatch (``api.prefill``).  The recurrent families (ssm, hybrid)
    and prompts longer than the sliding window run chunked prefill:
    fixed-shape (B, ``chunk``) dispatches of ``api.prefill_chunk``, the
    last one ragged through ``n_valid``.  Both give the teacher-forced
    forward's logits."""
    api = get_model(cfg)
    chunk = chunk or cfg.serve_chunk
    assert api.prefill_chunk is not None, f"{cfg.name} has no chunk step"

    def prefill_step(params, cache, prompts):
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


def make_decode_step(cfg: ModelConfig, mor=None, mor_mode: str = "dense"
                     ) -> Callable:
    """decode_step(params, cache, tokens (B, 1)) -> (next tokens, cache,
    aux) on the slot pool: a chunk dispatch of width 1, so that decode
    runs the serving path (and yields its MoR skip stats in ``aux``)."""
    api = get_model(cfg)
    assert api.prefill_chunk is not None, f"{cfg.name} has no chunk step"

    def decode_step(params, cache, tokens):
        n_valid = torch.ones((tokens.shape[0],), dtype=torch.int32,
                             device=tokens.device)
        logits, aux = api.prefill_chunk(params, cfg, tokens, cache,
                                        n_valid=n_valid, mor=mor,
                                        mor_mode=mor_mode)
        return _argmax(logits[:, 0]), cache, aux

    return decode_step


def make_serve_step(cfg: ModelConfig, mor=None, mor_mode: str = "dense"
                    ) -> Callable:
    """serve_step(params, cache, tokens (B, 1)) -> (next tokens, cache)
    over ``cache_init``'s cache (one shared position)."""
    api = get_model(cfg)
    assert api.decode_step is not None, f"{cfg.name} has no decode step"

    def serve_step(params, cache, tokens):
        logits = api.decode_step(params, cfg, tokens, cache, mor=mor,
                                 mor_mode=mor_mode)
        return _argmax(logits), cache

    return serve_step
