"""RWKV6 "Finch" 1.6B — attn-free, data-dependent decay [arXiv:2404.05892]."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="rwkv6-1.6b",
    family="ssm",
    source="Finch: RWKV-6 [arXiv:2404.05892]",
    num_layers=24,
    d_model=2048,
    num_heads=32,          # wkv heads (d_model / 64)
    num_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    ssm=SSMConfig(state_dim=64, num_heads=32, head_dim=64),
)


def reduced() -> ModelConfig:
    return ModelConfig(
        arch_id="rwkv6-reduced",
        family="ssm",
        source=CONFIG.source,
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=4,
        d_ff=512,
        vocab_size=512,
        ssm=SSMConfig(state_dim=64, num_heads=4, head_dim=64),
    )
