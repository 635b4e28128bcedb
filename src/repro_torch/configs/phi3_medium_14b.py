"""Phi-3-Medium-14B — dense, RoPE SwiGLU GQA [arXiv:2404.14219]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="phi3-medium-14b",
    family="dense",
    source="Phi-3 [arXiv:2404.14219]",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=10,
    d_ff=17920,
    vocab_size=100352,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        arch_id="phi3-reduced",
        family="dense",
        source=CONFIG.source,
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=2,
        d_ff=512,
        vocab_size=512,
    )
