"""mixtral-8x7b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, 8 experts top-2, SWA(4096).  [arXiv:2401.04088; hf]"""
from repro_torch.configs.base import ModelConfig, MoRConfig, register


@register("mixtral-8x7b")
def mixtral_8x7b() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b",
        family="moe",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_head=128,
        d_ff=14336,
        moe_d_ff=14336,
        vocab_size=32000,
        n_experts=8,
        top_k=2,
        expert_sharding="tp",    # 8 experts < 16-way model axis -> TP inside
        sliding_window=4096,
        activation="swiglu",
        norm="rmsnorm",
        rope_theta=1_000_000.0,
        mor=MoRConfig(enabled=True, relufied=True),
        param_layout="contract_tp",
        grad_accum=8,
    )
