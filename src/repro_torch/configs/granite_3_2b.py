"""granite-3-2b [dense] — 40L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=49155.  [hf:ibm-granite/granite-3.0-2b-base; hf]"""
from repro_torch.configs.base import ModelConfig, MoRConfig, register


@register("granite-3-2b")
def granite_3_2b() -> ModelConfig:
    return ModelConfig(
        name="granite-3-2b",
        family="dense",
        n_layers=40,
        d_model=2048,
        n_heads=32,
        n_kv_heads=8,
        d_head=64,
        d_ff=8192,
        vocab_size=49155,
        activation="swiglu",
        norm="rmsnorm",
        rope_theta=10000.0,
        tie_embeddings=True,
        mor=MoRConfig(enabled=True, relufied=True),
        param_layout="contract_tp",
        grad_accum=4,
    )
