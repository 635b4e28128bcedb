"""SmolLM-360M — llama-arch small [hf:HuggingFaceTB/SmolLM-135M family]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="smollm-360m",
    family="dense",
    source="SmolLM [hf:HuggingFaceTB/SmolLM-135M]",
    num_layers=32,
    d_model=960,
    num_heads=15,
    num_kv_heads=5,
    d_ff=2560,
    vocab_size=49152,
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        arch_id="smollm-reduced",
        family="dense",
        source=CONFIG.source,
        num_layers=2,
        d_model=192,
        num_heads=3,
        num_kv_heads=1,
        d_ff=512,
        vocab_size=512,
        tie_embeddings=True,
    )
