"""Model API dispatch (``repro.models.get_model``):
  init(gen, cfg) -> params
  forward(params, cfg, batch, **kw) -> (logits, aux)
    (the cnn family: forward(params, state, cfg, images, **kw) ->
     (logits, new_state, aux))
  cache_init(cfg, batch, max_len, dtype, device) -> cache
  prefill_chunk(params, cfg, tokens (B, C), cache, *, n_valid, mor,
                mor_mode) -> (logits (B, C, V), aux), cache updated in place
  decode_step(params, cfg, tokens (B, 1), cache, *, mor, mor_mode)
                -> logits (B, V), ``cache_init``'s cache updated in place
The decoder families (dense, moe, vlm) and the recurrent ones (ssm:
RWKV6; hybrid: Mamba2 + a shared attention block) serve through
``cache_init`` and ``prefill_chunk``; the recurrent families also have
the static-batch ``decode_step`` (the transformer's waits for ROADMAP
queue A 1).  The audio encoder and the paper's DNNs (cnn, tds) have no
decode.
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
    decode_step: Optional[Callable] = None


def get_model(cfg: ModelConfig) -> ModelAPI:
    if cfg.family in ("dense", "moe", "vlm"):
        from repro_torch.models import transformer as t
        return ModelAPI(t.init_params, t.forward, t.cache_init,
                        t.prefill_chunk)
    if cfg.family == "audio":
        from repro_torch.models import transformer as t
        return ModelAPI(t.init_params, t.forward, has_decode=False)
    if cfg.family == "cnn":
        from repro_torch.models import cnn
        return ModelAPI(cnn.init_params, cnn.forward, has_decode=False)
    if cfg.family == "tds":
        from repro_torch.models import tds
        return ModelAPI(tds.init_params, tds.forward, has_decode=False)
    if cfg.family == "ssm":
        from repro_torch.models import rwkv_model as r
        return ModelAPI(r.init_params, r.forward, r.cache_init,
                        r.prefill_chunk, decode_step=r.decode_step)
    if cfg.family == "hybrid":
        from repro_torch.models import hybrid as h
        return ModelAPI(h.init_params, h.forward, h.cache_init,
                        h.prefill_chunk, decode_step=h.decode_step)
    raise ValueError(f"unknown family {cfg.family!r}")
