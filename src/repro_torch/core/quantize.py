"""Per-channel symmetric quantization for the resident expert replica tier.

Counterpart of ``repro/core/quantize.py``. The tiered expert store
(runtime/tiers.py) keeps a low-precision replica of every expert resident
in device memory, so a miss with no buddy is computed at once at degraded
fidelity instead of stalling on a host transfer. This module owns the
numerics:

  * per-output-channel symmetric quantization (int8 or int4 value range) of
    the SwiGLU expert matrices: scale s_c = max|W[:, c]| / qmax, stored f32;
    ``torch.round`` rounds half to even as ``jnp.round`` does, so ``q`` and
    the scales are bit-equal to the reference's on the same f32 weights;
  * dequantization (the quant_ffn kernel applies the scales after each
    matmul instead);
  * calibrated per-expert fidelity: the relative round-trip weight error
    the runtime trades against expected transfer stall.

Everything runs on the weights' device, a few experts of one stacked
layer at a time (``PASS_BYTES``), so full-width quantization happens on the
card beside the full-precision weights with small f32 temporaries: at
deepseek-v2-lite-buddy's 27 layers the f32 weights and the int8 replicas
alone come to 80.15 GB. int4 values are stored as int8 in [-7, 7]; byte
accounting uses the 4-bit payload (runtime.memory.quant_expert_nbytes).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

TIER_BITS = {"int8": 8, "int4": 4}
# f32 bytes of one weight's slice quantized per pass of attach_quant_tier:
# its temporaries are a few such slices (at least one expert per pass)
PASS_BYTES = 1 << 28


def qmax_for_bits(bits: int) -> int:
    """Symmetric signed range: int8 -> 127, int4 -> 7."""
    if bits not in (4, 8):
        raise ValueError(f"supported tier precisions: int4/int8, got {bits}")
    return 2 ** (bits - 1) - 1


def quantize_per_channel(w: torch.Tensor,
                         bits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """w [..., D, C]: symmetric per-channel quant over the contraction axis.

    Returns (q int8 [..., D, C], scale f32 [..., C]) with dequant =
    q * scale[..., None, :]. Scales are per OUTPUT channel so a kernel can
    apply them after the matmul: (x @ q) * scale."""
    qm = qmax_for_bits(bits)
    w32 = w.float()
    amax = w32.abs().amax(dim=-2)                                 # [..., C]
    scale = torch.where(amax > 0, amax / qm, torch.ones_like(amax))
    q = torch.round(w32 / scale[..., None, :]).clamp(-qm, qm)
    return q.to(torch.int8), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of quantize_per_channel: [..., D, C] f32."""
    return q.float() * scale[..., None, :]


def quantize_expert_ffn(w1, w3, w2, bits: int) -> dict:
    """Quantize a (stacked) SwiGLU expert FFN: w1/w3 [..., D, F], w2
    [..., F, D]. Returns the tier's parameter dict (``w1_q``/``w1_s``/...
    mirroring the full-precision names)."""
    out = {}
    for name, w in (("w1", w1), ("w3", w3), ("w2", w2)):
        out[f"{name}_q"], out[f"{name}_s"] = quantize_per_channel(w, bits)
    return out


def expert_fidelity(w1, w3, w2, quant: dict) -> np.ndarray:
    """Per-expert relative round-trip error (the calibrated fidelity score):
    fid[e] = ||W_e - deq(Q_e)||_F / ||W_e||_F pooled over {w1, w3, w2}.
    Lower is better. Sums are f32 like the reference's, in another order
    (agree to ~1e-6 relative)."""
    err2 = 0.0
    norm2 = 0.0
    for name, w in (("w1", w1), ("w3", w3), ("w2", w2)):
        w32 = w.float()
        d = w32 - dequantize(quant[f"{name}_q"], quant[f"{name}_s"])
        err2 = err2 + (d * d).sum(dim=(-1, -2))
        norm2 = norm2 + (w32 * w32).sum(dim=(-1, -2))
    fid = torch.sqrt(err2 / norm2.clamp(min=1e-30))
    return fid.cpu().numpy()                                      # [..., E]


def attach_quant_tier(cfg, params: dict, bits: int) -> Tuple[dict, np.ndarray]:
    """Build the resident replica tier for every MoE layer of ``params``.

    Returns (params', fidelity [L_moe, E]) where params' is a shallow copy
    whose attn_moe groups carry a ``quant`` sub-dict (stacked [R, E, ...]
    int8 weights + f32 scales, on the weights' device) next to the
    full-precision weights. Shared experts are always resident and are not
    quantized. Every expert is quantized on its own (per-channel scales
    within an expert), so the passes over a few experts at a time give the
    replicas of one pass over the whole stack, bit for bit."""
    groups = list(params["groups"])
    fids = []
    for gi, (kind, _repeat) in enumerate(cfg.stack()):
        if kind != "attn_moe":
            continue
        moe_p = dict(groups[gi]["moe"])
        ws = [moe_p[n] for n in ("w1", "w3", "w2")]
        dev = ws[0].device
        # the stacked outputs, shaped as quantize_expert_ffn shapes them
        quant = {k: torch.empty(v.shape, dtype=v.dtype, device=dev)
                 for k, v in quantize_expert_ffn(
                     *(torch.empty_like(w, device="meta") for w in ws),
                     bits).items()}
        n_layers, n_exp = ws[0].shape[:2]
        step = max(1, PASS_BYTES // (ws[0][0, 0].numel() * 4))
        fid = np.empty((n_layers, n_exp), np.float32)
        for li in range(n_layers):
            for e0 in range(0, n_exp, step):
                part = [w[li, e0:e0 + step] for w in ws]
                lq = quantize_expert_ffn(*part, bits)
                fid[li, e0:e0 + step] = expert_fidelity(*part, lq)
                for k, v in lq.items():
                    quant[k][li, e0:e0 + step] = v
        moe_p["quant"] = quant
        fids.append(fid)
        g = dict(groups[gi])
        g["moe"] = moe_p
        groups[gi] = g
    if not fids:
        raise ValueError("attach_quant_tier: config has no attn_moe groups")
    out = dict(params)
    out["groups"] = tuple(groups)
    return out, np.concatenate(fids, axis=0)
