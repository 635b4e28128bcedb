"""DeepSeek-V2-Lite family — the paper's own evaluation model.

BuddyMoE (§5.1) evaluates DeepSeek-V2-Lite configured with 64 experts per MoE
layer and top-6 gating. We reproduce that routing regime: 64 experts, top-6,
with DeepSeek-style shared experts. Full config mirrors DeepSeek-V2-Lite
(27 layers, d_model 2048); reduced() is the CPU-trainable variant used by the
accuracy benchmarks (Tables 2-4).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="deepseek-v2-lite-buddy",
    family="moe",
    source="DeepSeek-V2-Lite (BuddyMoE eval model, top-6/64)",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=10944,
    vocab_size=102400,
    moe=MoEConfig(num_experts=64, top_k=6, d_ff=1408, num_shared_experts=2),
)


def reduced() -> ModelConfig:
    """~20M-param trainable variant keeping the 64-expert/top-6 routing."""
    return ModelConfig(
        arch_id="deepseek-lite-reduced",
        family="moe",
        source=CONFIG.source,
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=4,
        d_ff=512,
        vocab_size=512,
        moe=MoEConfig(num_experts=4, top_k=2, d_ff=128, num_shared_experts=1),
    )


def profiling() -> ModelConfig:
    """Mid-size variant with the paper's full 64-expert top-6 routing, small
    enough to train briefly on CPU for co-activation profiling experiments.

    Upcycled expert init (MoEConfig.upcycle_noise): production MoEs are
    sparse-upcycled from dense checkpoints, which is what gives them the
    functional redundancy BuddyMoE exploits (Fig. 4). Trained-from-scratch
    experts at this scale are near-orthogonal and provide NO redundancy to
    exploit — see EXPERIMENTS.md §Redundancy-ablation."""
    return ModelConfig(
        arch_id="deepseek-lite-prof",
        family="moe",
        source=CONFIG.source,
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        d_ff=256,
        vocab_size=512,
        moe=MoEConfig(num_experts=64, top_k=6, d_ff=64, num_shared_experts=2,
                      upcycle_noise=0.25),
    )
