"""phi-3-vision-4.2b [vlm] — 32L d_model=3072 32H (MHA kv=32) d_ff=8192
vocab=32064, phi3-mini backbone + CLIP frontend (stub).
[hf:microsoft/Phi-3-vision-128k-instruct; hf]"""
from repro_torch.configs.base import ModelConfig, MoRConfig, register


@register("phi-3-vision-4.2b")
def phi_3_vision_4_2b() -> ModelConfig:
    return ModelConfig(
        name="phi-3-vision-4.2b",
        family="vlm",
        n_layers=32,
        d_model=3072,
        n_heads=32,
        n_kv_heads=32,
        d_head=96,
        d_ff=8192,
        vocab_size=32064,
        activation="swiglu",
        norm="rmsnorm",
        rope_theta=10000.0,
        frontend="vision_stub",
        frontend_tokens=1024,    # pre-computed CLIP patch embeddings
        mor=MoRConfig(enabled=True, relufied=True),
        param_layout="contract_tp",
        grad_accum=2,
    )
