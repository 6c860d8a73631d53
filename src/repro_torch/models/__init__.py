"""Model API dispatch (``repro.models.get_model``):
  init(gen, cfg) -> params
  forward(params, cfg, batch, **kw) -> (logits, aux)
    (the cnn family: forward(params, state, cfg, images, **kw) ->
     (logits, new_state, aux))
  cache_init(cfg, batch, max_len, dtype, device) -> cache
  prefill_chunk(params, cfg, tokens (B, C), cache, *, n_valid, mor,
                mor_mode) -> (logits (B, C, V), aux), cache updated in place
The decoder families (dense, moe) serve through ``cache_init`` and
``prefill_chunk``; the paper's DNNs (cnn, tds) have no decode.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class ModelAPI:
    init: Callable
    forward: Callable
    cache_init: Optional[Callable] = None
    prefill_chunk: Optional[Callable] = None
    has_decode: bool = True


def get_model(cfg: ModelConfig) -> ModelAPI:
    if cfg.family in ("dense", "moe"):
        from repro_torch.models import transformer as t
        return ModelAPI(t.init_params, t.forward, t.cache_init,
                        t.prefill_chunk)
    if cfg.family == "cnn":
        from repro_torch.models import cnn
        return ModelAPI(cnn.init_params, cnn.forward, has_decode=False)
    if cfg.family == "tds":
        from repro_torch.models import tds
        return ModelAPI(tds.init_params, tds.forward, has_decode=False)
    raise NotImplementedError(
        f"{cfg.name} ({cfg.family}): only the dense, moe, cnn and tds "
        f"families are ported so far")
