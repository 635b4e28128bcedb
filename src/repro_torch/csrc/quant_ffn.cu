// Dequant + grouped SwiGLU against the resident replica tier, for sm_90a.
//
// Replaces the TPU kernel quant_ffn_pallas (src/repro/kernels/quant_ffn.py):
//   h   = silu((x[e] @ w1q[e]) * s1[e])
//   g   = (x[e] @ w3q[e]) * s3[e]
//   out = ((h * g) @ w2q[e]) * s2[e]
// with int8 weights (int4 replicas arrive as int8 in [-7, 7]), per-output-
// channel f32 scales applied after each matmul, everything in f32, and the
// output in x.dtype (f32 or bf16). Rows at or past counts[e] (optional) are
// unfilled and come back zero.
//
// This is ffn::launch with no full-precision groups (E = 0): every group
// g is the degraded class at expert g, so the same int8 tiles (gate_up_tile
// and down_tile with QUANT = true) serve this kernel and the degraded half
// of grouped_ffn, and the two cannot drift. It inherits the shared tile's
// cp.async ring and row instances; its shared-memory stages are sized for
// int8 weights (16 bytes copy 16 weights, widened to f32 on read).
//
// Bound on the H100: at the gather branch's decode shapes ([64, 24, 2048] x
// 1408, a few rows in each of the ~20 live experts) each int8 weight byte
// serves one or two rows, so the live experts' int8 weights and scales
// bound it. A block whose rows are all past its expert's count returns
// before reading anything, so an expert with no degraded slot reads no
// weight bytes and a step with no degraded slot costs the empty launches.
// What still holds it back: with 3-4 live experts (the tier path's usual
// step) a launch has ~40 live blocks for 132 SMs, and each block's int8
// slices are a quarter of the f32 bytes, so few bytes are in flight.
#include "ffn_gemm.cuh"

extern "C" int quant_ffn_launch(int dtype, const void* x, const int8_t* w1q, const float* s1,
                                const int8_t* w3q, const float* s3, const int8_t* w2q,
                                const float* s2, const int* counts, float* h, void* out, int E,
                                int C, int D, int F, int vec16, int smem_gate_up, int smem_down,
                                cudaStream_t stream) {
  if (dtype == 0) {
    return ffn::launch<float, ffn::CLASS_Q>(
        static_cast<const float*>(x), nullptr, nullptr, nullptr, w1q, s1, w3q, s3, w2q, s2,
        counts, h, static_cast<float*>(out), 0, E, C, D, F, vec16, smem_gate_up, smem_down,
        stream);
  }
  if (dtype == 1) {
    using bf = __nv_bfloat16;
    return ffn::launch<bf, ffn::CLASS_Q>(
        static_cast<const bf*>(x), nullptr, nullptr, nullptr, w1q, s1, w3q, s3, w2q, s2, counts,
        h, static_cast<bf*>(out), 0, E, C, D, F, vec16, smem_gate_up, smem_down, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
