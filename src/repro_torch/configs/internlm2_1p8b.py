"""InternLM2-1.8B — dense, GQA [arXiv:2403.17297]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="internlm2-1.8b",
    family="dense",
    source="InternLM2 [arXiv:2403.17297]",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=92544,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        arch_id="internlm2-reduced",
        family="dense",
        source=CONFIG.source,
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=2,
        d_ff=512,
        vocab_size=512,
    )
