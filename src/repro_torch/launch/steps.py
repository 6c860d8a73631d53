"""Serving step functions (``repro.launch.steps``, its serving half):
the teacher-forced prefill, the static batch's prefill step over the
slot pool, its width-1 decode step, and the single-token serve step
over ``cache_init``'s cache.

The JAX package compiles each step once (``jax.jit``, the cache
donated); here a step is a plain function that updates the cache IN
PLACE and hands it back, so that the two packages' call sites read the
same.  No step reads a device value back to the host: tokens stay
device tensors.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import get_model


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
