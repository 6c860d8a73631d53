"""Model API dispatch (``repro.models.get_model``), dense and moe
families (GQA or MLA attention):
  init(gen, cfg) -> params
  forward(params, cfg, batch, **kw) -> (logits, aux)
  cache_init(cfg, batch, max_len, dtype, device) -> cache
  prefill_chunk(params, cfg, tokens (B, C), cache, *, n_valid, mor,
                mor_mode) -> (logits (B, C, V), aux), cache updated in place
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class ModelAPI:
    init: Callable
    forward: Callable
    cache_init: Callable
    prefill_chunk: Callable


def get_model(cfg: ModelConfig) -> ModelAPI:
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}): only the dense and moe families "
            f"are ported so far")
    from repro_torch.models import transformer as t
    return ModelAPI(t.init_params, t.forward, t.cache_init, t.prefill_chunk)
