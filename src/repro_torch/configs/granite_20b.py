"""granite-20b [dense] — 52L d_model=6144 48H (GQA kv=1 / MQA) d_ff=24576
vocab=49152, llama-arch, code.  [arXiv:2405.04324; hf]"""
from repro_torch.configs.base import ModelConfig, MoRConfig, register


@register("granite-20b")
def granite_20b() -> ModelConfig:
    return ModelConfig(
        name="granite-20b",
        family="dense",
        n_layers=52,
        d_model=6144,
        n_heads=48,
        n_kv_heads=1,
        d_head=128,
        d_ff=24576,
        vocab_size=49152,
        activation="swiglu",
        norm="rmsnorm",
        rope_theta=10000.0,
        mor=MoRConfig(enabled=True, relufied=True),
        grad_accum=8,
    )
