"""Mixtral-8x7B — MoE 8 experts top-2, GQA, SWA [arXiv:2401.04088]."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="mixtral-8x7b",
    family="moe",
    source="Mixtral of Experts [arXiv:2401.04088]",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff=14336),
    sliding_window=4096,
    rope_theta=1e6,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        arch_id="mixtral-reduced",
        family="moe",
        source=CONFIG.source,
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=2,
        d_ff=512,
        vocab_size=512,
        moe=MoEConfig(num_experts=4, top_k=2, d_ff=512),
        sliding_window=128,
    )
