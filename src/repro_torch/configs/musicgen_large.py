"""MusicGen-Large — decoder-only over EnCodec tokens [arXiv:2306.05284].

The EnCodec conv/codec frontend is STUBBED: input_specs provides precomputed
frame embeddings (num_cond_tokens x cond_dim) consumed via additive prefix.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="musicgen-large",
    family="audio",
    source="MusicGen [arXiv:2306.05284]",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    num_cond_tokens=256,   # stubbed text/melody conditioning prefix
    cond_dim=2048,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        arch_id="musicgen-reduced",
        family="audio",
        source=CONFIG.source,
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=4,
        d_ff=512,
        vocab_size=512,
        num_cond_tokens=16,
        cond_dim=256,
    )
