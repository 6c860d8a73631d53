"""Model and MoR configs, the registry, and the smoke-size reduction.

Field-for-field mirror of ``repro.configs.base`` (``MoRConfig``,
``ModelConfig``, ``reduce_config``), so a config built here and one
built by the JAX package describe the same model.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Tuple

import torch

# --------------------------------------------------------------------------
# MoR (Mixture-of-Rookies) feature config
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class MoRConfig:
    """Config for the paper's hybrid ReLU-output predictor.

    ``enabled`` turns the predictor on for ReLU-family FFN layers.
    ``relufied`` swaps a non-sign-thresholdable activation (SiLU/GELU) for
    ReLU so the predictor is exact.
    """

    enabled: bool = False
    relufied: bool = False           # swap SwiGLU/GELU gate for ReLU
    corr_threshold: float = 0.8      # paper's T: enable binary rookie if c > T
    max_cluster_angle: float = 90.0  # degrees; only cluster below this angle
    tile_n: int = 128                # output-column tile of the mask
    tile_m: int = 8                  # rows grouped per mask decision
    capacity: float = 1.0            # static live-tile budget (fraction) for
                                     # gather_matmul; 1.0 = no compaction
    calib_batches: int = 8           # offline calibration batches


# --------------------------------------------------------------------------
# Model config
# --------------------------------------------------------------------------

FAMILIES = ("dense", "moe", "ssm", "vlm", "hybrid", "audio", "cnn", "tds")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # one of FAMILIES
    n_layers: int
    d_model: int
    n_heads: int = 0
    n_kv_heads: int = 0
    d_head: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    qkv_bias: bool = False
    activation: str = "swiglu"      # swiglu | relu_glu | relu | relu2 | gelu
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    causal: bool = True

    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_k_dense: int = 0
    capacity_factor: float = 1.25
    expert_sharding: str = "tp"

    # --- MLA ---
    mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # --- sliding-window attention ---
    sliding_window: int = 0         # 0 = full attention

    # --- SSM ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    rwkv_head_size: int = 64

    # --- hybrid ---
    shared_attn_every: int = 0
    shared_attn_window: int = 0

    # --- modality frontends ---
    frontend: str = "none"
    frontend_tokens: int = 0

    # --- CNN-family ---
    cnn_channels: Tuple[int, ...] = ()
    cnn_num_classes: int = 0
    img_size: int = 0
    batchnorm: bool = False
    residual: bool = False

    # --- distribution ---
    param_layout: str = "fsdp_tp"
    flash_threshold: int = 4096

    # --- serving ---
    serve_chunk: int = 32           # chunked-prefill chunk length
    serve_page: int = 8
    serve_expert_capacity: float = 1.0

    # --- numerics / training ---
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    remat: str = "nothing_saveable"
    grad_accum: int = 1

    # --- the paper's feature ---
    mor: MoRConfig = field(default_factory=MoRConfig)

    @property
    def head_dim(self) -> int:
        if self.d_head:
            return self.d_head
        return self.d_model // max(self.n_heads, 1)

    @property
    def tdtype(self) -> torch.dtype:
        """The compute dtype as a torch dtype."""
        return getattr(torch, self.dtype)

    @property
    def tparam_dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        from repro_torch import configs as _pkg  # noqa: F401
        _pkg.load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


# --------------------------------------------------------------------------
# Smoke-test reduction: same family, tiny dims
# --------------------------------------------------------------------------


def reduce_config(cfg: ModelConfig) -> ModelConfig:
    """The dense, MoE, MLA, CNN and TDS branches of ``repro.configs.base.
    reduce_config``: the same family at tiny widths."""
    if cfg.family not in ("dense", "moe", "cnn", "tds"):
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}): only the dense, moe, cnn and tds "
            f"families are ported so far")
    kw: Dict[str, Any] = dict(
        n_layers=min(cfg.n_layers, 2),
        d_model=128,
        d_ff=256,
        vocab_size=min(cfg.vocab_size, 512) if cfg.vocab_size else 0,
        remat="none",
        grad_accum=1,
        dtype="float32",
        param_dtype="float32",
    )
    if cfg.n_heads:
        kw.update(n_heads=4, n_kv_heads=min(cfg.n_kv_heads, 4) or 1, d_head=32)
    if cfg.family == "moe":
        kw.update(n_experts=4, top_k=min(cfg.top_k, 2),
                  n_shared_experts=min(cfg.n_shared_experts, 1),
                  moe_d_ff=64, first_k_dense=min(cfg.first_k_dense, 1))
    if cfg.mla:
        kw.update(kv_lora_rank=32, q_lora_rank=48, qk_nope_head_dim=16,
                  qk_rope_head_dim=8, v_head_dim=16, d_head=24)
    if cfg.sliding_window:
        kw.update(sliding_window=16)
    if cfg.family == "cnn":
        kw = dict(n_layers=cfg.n_layers, d_model=16, img_size=32,
                  cnn_channels=tuple(min(c, 16) for c in cfg.cnn_channels),
                  dtype="float32", remat="none")
    if cfg.family == "tds":
        kw = dict(n_layers=2, d_model=64, d_ff=128, vocab_size=64,
                  dtype="float32", remat="none")
    kw.setdefault("serve_chunk", 8)
    return cfg.replace(**kw)
