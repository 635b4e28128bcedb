"""Llama-3.2-Vision-11B backbone — cross-attn image layers
[hf:meta-llama/Llama-3.2-11B-Vision].

The ViT vision encoder + projector are STUBBED: input_specs provides
precomputed patch embeddings (num_cond_tokens x cond_dim) consumed by the
cross-attention layers.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="llama-3.2-vision-11b",
    family="vlm",
    source="Llama-3.2-Vision [hf:meta-llama/Llama-3.2-11B-Vision]",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    cross_attn_every=5,    # 8 cross-attn layers interleaved in 40
    num_cond_tokens=1601,  # 1 image: (448/14)^2 + cls
    cond_dim=4096,
    rope_theta=500000.0,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        arch_id="llama-vision-reduced",
        family="vlm",
        source=CONFIG.source,
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=2,
        d_ff=512,
        vocab_size=512,
        cross_attn_every=2,
        num_cond_tokens=16,
        cond_dim=256,
    )
