"""Expert output similarity on a calibration set (§1: buddies are
"identified via an offline analysis of co-activation patterns and output
similarity on a calibration dataset").

Counterpart of ``repro/core/similarity.py``. For each MoE layer every
expert runs on a sample of that layer's input activations, and the
pairwise cosine similarity of their outputs is averaged over the sample.
Running every expert on the same N rows is the capacity kernel's function
on x broadcast to [E, N, D], so the SwiGLUs go through ``ops.expert_ffn``:
the CUDA kernel on the card, its plain version on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import attention as A
from repro_torch.models import moe as M
from repro_torch.models.common import rmsnorm, tree_map


def expert_output_similarity(moe_params: dict, xs: torch.Tensor) -> np.ndarray:
    """moe_params: one layer's MoE params (w1/w3/w2 [E, ...]); xs: [N, D]
    calibration activations on the weights' device. Returns [E, E] mean
    cosine similarity. The SwiGLU runs at the weights' dtype (f32 in every
    config here, the reference's arithmetic)."""
    w1, w3, w2 = moe_params["w1"], moe_params["w3"], moe_params["w2"]
    n, d = xs.shape
    x = xs.to(w1.dtype).expand(w1.shape[0], n, d).contiguous()
    with torch.no_grad():
        outs = ops.expert_ffn(x, w1, w3, w2).float()            # [E, N, D]
        unit = outs / (torch.linalg.vector_norm(outs, dim=-1) + 1e-8)[..., None]
        sim = torch.einsum("end,fnd->ef", unit, unit) / n
    return sim.cpu().numpy()


def collect_layer_inputs(cfg: ModelConfig, params, tokens) -> torch.Tensor:
    """Calibration activations per MoE layer: the post-attention, pre-MoE
    normalized hidden states of the first layer group. tokens [B, S]
    (numpy or a tensor). Returns [L, N, D] (N = B * S) on the weights'
    device."""
    dev = params["embed"].device
    tokens = torch.as_tensor(tokens).to(dev).long()
    captured = []
    with torch.no_grad():
        x = params["embed"][tokens]
        b, s, d = x.shape
        positions = torch.arange(s, device=dev).expand(b, s)
        gp = params["groups"][0]
        for li in range(gp["ln1"].shape[0]):
            lp = tree_map(lambda a: a[li], gp)
            xn = rmsnorm(x, lp["ln1"], cfg.norm_eps)
            x = x + A.attn_forward(lp["attn"], xn, positions,
                                   num_heads=cfg.num_heads,
                                   num_kv_heads=cfg.num_kv_heads,
                                   head_dim=cfg.head_dim,
                                   rope_theta=cfg.rope_theta,
                                   window=cfg.sliding_window)
            xn = rmsnorm(x, lp["ln2"], cfg.norm_eps)
            captured.append(xn.reshape(-1, d))
            y, _ = M.moe_forward(lp["moe"], xn, cfg.moe, capacity_factor=4.0)
            x = x + y
    return torch.stack(captured)


def all_layer_similarities(cfg: ModelConfig, params, tokens,
                           max_tokens: int = 512) -> np.ndarray:
    """[L, E, E] output-similarity matrices from a calibration batch."""
    xs = collect_layer_inputs(cfg, params, tokens)
    gp = params["groups"][0]
    return np.stack([
        expert_output_similarity({k: gp["moe"][k][li]
                                  for k in ("w1", "w3", "w2")},
                                 xs[li][:max_tokens])
        for li in range(xs.shape[0])])
