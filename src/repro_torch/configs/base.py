"""Model / shape configuration system.

Every assigned architecture provides a module in ``repro_torch.configs``
exposing ``CONFIG`` (the exact full-scale config from its source paper/model
card) and ``reduced()`` (a tiny same-family variant for CPU smoke tests).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Block kinds used by the layer-stack compiler in models/transformer.py.
# A stack is a list of "groups"; each group is (block_kind, repeat) and is
# executed as a loop over stacked params.
# ---------------------------------------------------------------------------
ATTN_DENSE = "attn_dense"      # self-attn + dense SwiGLU FFN
ATTN_MOE = "attn_moe"          # self-attn + MoE FFN
CROSS_DENSE = "cross_dense"    # cross-attn + dense FFN (VLM image layers)
RWKV = "rwkv6"                 # RWKV6 time-mix + channel-mix
MAMBA2 = "mamba2"              # Mamba2 (SSD) block
SHARED_ATTN = "shared_attn"    # zamba2 shared attention block (tied params)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff: int                       # per-expert hidden size
    num_shared_experts: int = 0     # always-on shared experts (DeepSeek-style)
    router_jitter: float = 0.0
    # Sparse-upcycling init (Komatsuzaki et al.; the provenance of most
    # production MoEs the paper targets): every expert starts as a shared
    # base FFN + upcycle_noise * perturbation. This is what creates the
    # functional redundancy BuddyMoE exploits (paper Fig. 4) — experts
    # trained from independent inits are near-orthogonal and substitution
    # (buddy OR random) cannot work. 0.0 = independent init.
    upcycle_noise: float = 0.0


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    # Shared by rwkv6/mamba2 families; interpretation depends on block kind.
    state_dim: int = 64             # per-head state size N
    num_heads: int = 32
    head_dim: int = 64
    conv_dim: int = 4               # mamba2 depthwise-conv width
    expand: int = 2                 # mamba2 inner expansion


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    source: str                     # citation
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # layer-pattern knobs
    attn_every: int = 0             # hybrid: 1 shared-attn block per N ssm blocks
    cross_attn_every: int = 0       # vlm: 1 cross-attn block per N self-attn blocks
    sliding_window: int = 0         # 0 = full attention (native arch value)
    # frontend stubs (audio/vlm): number of conditioning embeddings
    num_cond_tokens: int = 0
    cond_dim: int = 0
    # misc
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "float32"

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    # ------------------------------------------------------------------
    @property
    def is_moe(self) -> bool:
        return self.moe is not None

    @property
    def supports_long_context(self) -> bool:
        """True if decode at 500k is sub-quadratic (SSM state or SWA cache)."""
        return self.family in ("ssm", "hybrid") or True  # all archs get SWA fallback

    def param_count(self) -> int:
        """Approximate total parameter count (embeddings included)."""
        d, v = self.d_model, self.vocab_size
        n = v * d  # embed
        if not self.tie_embeddings:
            n += v * d
        hd = self.head_dim

        def attn_block():
            return d * (self.num_heads * hd) \
                + 2 * d * (self.num_kv_heads * hd) \
                + (self.num_heads * hd) * d + 3 * d * self.d_ff + 2 * d

        def mamba_block():
            s = self.ssm or SSMConfig()
            inner = s.expand * d
            return d * 2 * inner + inner * s.state_dim * 2 + inner * d + 2 * d

        for kind, repeat in self.stack():
            if kind in (ATTN_DENSE, CROSS_DENSE, SHARED_ATTN):
                n += repeat * attn_block()
            elif kind == ATTN_MOE:
                assert self.moe is not None
                e = self.moe
                attn = d * (self.num_heads * hd) \
                    + 2 * d * (self.num_kv_heads * hd) \
                    + (self.num_heads * hd) * d
                ffn = e.num_experts * 3 * d * e.d_ff + d * e.num_experts
                ffn += e.num_shared_experts * 3 * d * e.d_ff
                n += repeat * (attn + ffn + 2 * d)
            elif kind == RWKV:
                s = self.ssm or SSMConfig()
                dh = s.num_heads * s.head_dim
                n += repeat * (5 * d * dh + dh * d + 3 * d * self.d_ff + 2 * d)
            elif kind == MAMBA2:
                n += repeat * mamba_block()
            elif kind == "hybrid_super":
                # attn_every mamba blocks per super; ONE shared attn block
                # overall (tied params — added once below)
                n += repeat * self.attn_every * mamba_block()
            elif kind == "vlm_super":
                n += repeat * self.cross_attn_every * attn_block()
        if self.family == "hybrid":
            n += attn_block()
        return n

    def active_param_count(self) -> int:
        """Per-token active params (MoE: top_k + shared experts only)."""
        if not self.is_moe:
            return self.param_count()
        e = self.moe
        full_moe = e.num_experts * 3 * self.d_model * e.d_ff
        act_moe = (e.top_k + e.num_shared_experts) * 3 * self.d_model * e.d_ff
        n_moe_layers = sum(r for k, r in self.stack() if k == ATTN_MOE)
        return self.param_count() - n_moe_layers * (full_moe - act_moe) \
            + n_moe_layers * e.num_shared_experts * 0

    def stack(self) -> Tuple[Tuple[str, int], ...]:
        """Layer-group structure: ((block_kind, repeat), ...)."""
        if self.family == "ssm":
            return ((RWKV, self.num_layers),)
        if self.family == "hybrid":
            # zamba2: mamba2 backbone with a shared attention block applied
            # every `attn_every` layers. Modeled as scan over super-blocks.
            assert self.attn_every > 0
            n_super = self.num_layers // self.attn_every
            rem = self.num_layers - n_super * self.attn_every
            groups = [("hybrid_super", n_super)]
            if rem:
                groups.append((MAMBA2, rem))
            return tuple(groups)
        if self.family == "vlm":
            assert self.cross_attn_every > 0
            n_super = self.num_layers // self.cross_attn_every
            rem = self.num_layers - n_super * self.cross_attn_every
            groups = [("vlm_super", n_super)]
            if rem:
                groups.append((ATTN_DENSE, rem))
            return tuple(groups)
        if self.is_moe:
            return ((ATTN_MOE, self.num_layers),)
        return ((ATTN_DENSE, self.num_layers),)


# ---------------------------------------------------------------------------
# Input shapes (assigned).
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# The families with model code in this package; the others' configs arrive
# with theirs.
ARCH_IDS = [
    # the paper's own evaluation model family
    "deepseek-v2-lite-buddy",
    "rwkv6-1.6b",
]

_MODULES = {
    "deepseek-v2-lite-buddy": "deepseek_v2_lite_buddy",
    "rwkv6-1.6b": "rwkv6_1p6b",
}


def get_config(arch_id: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


def get_reduced(arch_id: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.reduced()
