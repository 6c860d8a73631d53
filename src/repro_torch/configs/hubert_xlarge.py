"""hubert-xlarge [audio] — 48L d_model=1280 16H (MHA kv=16) d_ff=5120
vocab=504, encoder-only (same arch as wav2vec2).  [arXiv:2106.07447;
unverified]

The convolutional waveform frontend is a stub: the model takes
pre-computed frame embeddings (``batch["frames"]``, (B, T, d_model)).
Encoder-only: nothing decodes.  The FFN uses ReLU here (speech domain,
the paper's own domain) so MoR applies natively.
"""
from repro_torch.configs.base import ModelConfig, MoRConfig, register


@register("hubert-xlarge")
def hubert_xlarge() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge",
        family="audio",
        n_layers=48,
        d_model=1280,
        n_heads=16,
        n_kv_heads=16,
        d_head=80,
        d_ff=5120,
        vocab_size=504,
        causal=False,
        activation="relu",
        norm="layernorm",
        frontend="audio_stub",
        mor=MoRConfig(enabled=True, relufied=False),  # native ReLU FFN
        param_layout="contract_tp",
        grad_accum=2,
    )
