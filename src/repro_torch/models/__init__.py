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
  prefill(params, cfg, tokens (B, S), cache, *, mor, mor_mode)
                -> last-position logits (B, V), a fresh cache filled in
                place (the transformer families only)
``param_shapes`` / ``cache_shapes`` make the same trees on the meta
device: shapes and dtypes, no memory, nothing drawn.
The decoder families (dense, moe, vlm) and the recurrent ones (ssm:
RWKV6; hybrid: Mamba2 + a shared attention block) serve through
``cache_init`` and ``prefill_chunk``, and all of them have the
static-batch ``decode_step``; the decoder families also the batched
``prefill`` (the others prefill in chunks: ``launch.steps.
make_prefill_step``).  The audio encoder and the paper's DNNs (cnn,
tds) have no decode.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers.common import META


@dataclass(frozen=True)
class ModelAPI:
    init: Callable
    forward: Callable
    cache_init: Optional[Callable] = None
    prefill_chunk: Optional[Callable] = None
    has_decode: bool = True
    decode_step: Optional[Callable] = None
    prefill: Optional[Callable] = None


def get_model(cfg: ModelConfig) -> ModelAPI:
    if cfg.family in ("dense", "moe", "vlm"):
        from repro_torch.models import transformer as t
        return ModelAPI(t.init_params, t.forward, t.cache_init,
                        t.prefill_chunk, decode_step=t.decode_step,
                        prefill=t.prefill)
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


def supports_long_context(cfg: ModelConfig) -> bool:
    """Sub-quadratic decode: SSM / hybrid state or a bounded (sliding
    window) kv cache."""
    if cfg.family in ("ssm", "hybrid"):
        return True
    return cfg.sliding_window > 0


def param_shapes(cfg: ModelConfig):
    """The params' tree as meta tensors: every leaf's shape and dtype,
    no allocation (the reference's ``jax.eval_shape`` of ``init``)."""
    return get_model(cfg).init(META, cfg)


def cache_shapes(cfg: ModelConfig, batch: int, max_len: int):
    """``cache_init``'s tree for ``batch`` sequences of ``max_len`` as
    meta tensors, in the model's compute dtype."""
    api = get_model(cfg)
    assert api.cache_init is not None, f"{cfg.name} has no cache"
    return api.cache_init(cfg, batch, max_len, cfg.tdtype, "meta")
