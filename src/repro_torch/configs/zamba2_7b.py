"""Zamba2-7B — Mamba2 backbone + shared attention blocks [arXiv:2411.15242]."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="zamba2-7b",
    family="hybrid",
    source="Zamba2 [arXiv:2411.15242]",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,       # GQA kv=32 (MHA-style shared blocks)
    d_ff=14336,
    vocab_size=32000,
    ssm=SSMConfig(state_dim=64, num_heads=56, head_dim=128, expand=2, conv_dim=4),
    attn_every=6,          # one shared attention block per 6 mamba2 layers
)


def reduced() -> ModelConfig:
    return ModelConfig(
        arch_id="zamba2-reduced",
        family="hybrid",
        source=CONFIG.source,
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=4,
        d_ff=512,
        vocab_size=512,
        ssm=SSMConfig(state_dim=32, num_heads=8, head_dim=64, expand=2, conv_dim=4),
        attn_every=2,
    )
