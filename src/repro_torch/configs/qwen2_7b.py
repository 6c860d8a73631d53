"""qwen2-7b [dense] — 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064, QKV bias.  [arXiv:2407.10671; hf]"""
from repro_torch.configs.base import ModelConfig, MoRConfig, register


@register("qwen2-7b")
def qwen2_7b() -> ModelConfig:
    return ModelConfig(
        name="qwen2-7b",
        family="dense",
        n_layers=28,
        d_model=3584,
        n_heads=28,
        n_kv_heads=4,
        d_head=128,
        d_ff=18944,
        vocab_size=152064,
        qkv_bias=True,
        activation="swiglu",
        norm="rmsnorm",
        rope_theta=1_000_000.0,
        mor=MoRConfig(enabled=True, relufied=True),
        param_layout="contract_tp",
        grad_accum=4,
    )
