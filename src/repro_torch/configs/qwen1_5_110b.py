"""qwen1.5-110b [dense] — 80L d_model=8192 64H (GQA kv=8) d_ff=49152
vocab=152064, QKV bias.  [hf:Qwen/Qwen1.5-110B; hf]"""
from repro_torch.configs.base import ModelConfig, MoRConfig, register


@register("qwen1.5-110b")
def qwen1_5_110b() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-110b",
        family="dense",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_head=128,
        d_ff=49152,
        vocab_size=152064,
        qkv_bias=True,
        activation="swiglu",
        norm="rmsnorm",
        rope_theta=1_000_000.0,
        mor=MoRConfig(enabled=True, relufied=True),
        param_layout="contract_tp",
        grad_accum=8,
    )
