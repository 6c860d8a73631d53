"""zamba2-7b [hybrid] — 81L d_model=3584 32H (kv=32) d_ff=14336
ssm_state=64; Mamba2 backbone + shared attention blocks.
[arXiv:2411.15242; unverified]

Simplifications vs. the (unverified) reference: one shared transformer
block re-applied every ``shared_attn_every`` mamba layers (the real model
alternates two shared blocks with per-invocation LoRA).  For the
``long_500k`` cell the shared attention runs with a sliding window so the
hybrid stays sub-quadratic (see DESIGN.md).
"""
from repro_torch.configs.base import ModelConfig, MoRConfig, register


@register("zamba2-7b")
def zamba2_7b() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b",
        family="hybrid",
        n_layers=81,
        d_model=3584,
        n_heads=32,
        n_kv_heads=32,
        d_head=112,
        d_ff=14336,
        vocab_size=32000,
        ssm_state=64,
        ssm_expand=2,
        ssm_head_dim=64,
        ssm_chunk=256,
        shared_attn_every=6,
        shared_attn_window=4096,
        activation="swiglu",
        norm="rmsnorm",
        mor=MoRConfig(enabled=True, relufied=True),
        param_layout="contract_tp",
        grad_accum=8,
    )
