"""rwkv6-3b (Finch) [ssm] — 32L d_model=2560 (attn-free) d_ff=8960
vocab=65536, data-dependent decay.  [arXiv:2404.05892; hf]

RWKV channel-mix uses ReLU^2: zero iff pre-activation <= 0, so the
Mixture-of-Rookies predictor applies *natively* (no relufication).
"""
from repro_torch.configs.base import ModelConfig, MoRConfig, register


@register("rwkv6-3b")
def rwkv6_3b() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b",
        family="ssm",
        n_layers=32,
        d_model=2560,
        n_heads=0,               # attention-free
        d_ff=8960,
        vocab_size=65536,
        rwkv_head_size=64,
        activation="relu2",
        norm="layernorm",
        mor=MoRConfig(enabled=True, relufied=False),  # native ReLU^2
        grad_accum=4,
    )
