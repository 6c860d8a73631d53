"""deepseek-v2-236b [moe] — 60L d_model=5120 128H d_ff(expert)=1536
vocab=102400, MLA kv_lora=512, 2 shared + 160 routed top-6.
[arXiv:2405.04434; hf:deepseek-ai/DeepSeek-V2]"""
from repro_torch.configs.base import ModelConfig, MoRConfig, register


@register("deepseek-v2-236b")
def deepseek_v2_236b() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b",
        family="moe",
        n_layers=60,
        d_model=5120,
        n_heads=128,
        n_kv_heads=128,          # MLA: heads share the compressed kv
        d_ff=12288,              # dense first layer inter size
        moe_d_ff=1536,
        vocab_size=102400,
        n_experts=160,
        n_shared_experts=2,
        top_k=6,
        first_k_dense=1,
        expert_sharding="ep_shmap",
        activation="swiglu",
        norm="rmsnorm",
        rope_theta=10000.0,
        # --- MLA ---
        mla=True,
        kv_lora_rank=512,
        q_lora_rank=1536,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
        mor=MoRConfig(enabled=True, relufied=True),
        flash_threshold=2048,
        grad_accum=16,
    )
