"""InternLM2-20B — dense, GQA [arXiv:2403.17297]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="internlm2-20b",
    family="dense",
    source="InternLM2 [arXiv:2403.17297]",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=92544,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        arch_id="internlm2-20b-reduced",
        family="dense",
        source=CONFIG.source,
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=2,
        d_ff=512,
        vocab_size=512,
    )
