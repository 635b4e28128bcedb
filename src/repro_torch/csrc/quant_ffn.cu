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
// cp.async ring and row instances. Its stages alone are sized for int8
// weights: BK_Q = 64 deep, so a gate/up stage carries 16 KB of weights (the
// bytes of a 16-deep f32 stage) and a block keeps 48 KB in flight, with a
// quarter of the slices and barriers (32 per gate/up block at D = 2048, 22
// per down block at F = 1408). The depth changes no FMA order, so the
// outputs equal grouped_ffn's degraded half bit for bit (that launch keeps
// BK = 16: its f32 groups fix its shared-memory size).
//
// Bound on the H100: at the gather branch's decode shapes ([64, 24, 2048] x
// 1408, a few rows in each live expert) each int8 weight byte serves one or
// two rows, so the live experts' int8 weights and scales bound it. A block
// whose rows are all past its expert's count returns before reading
// anything, so an expert with no degraded slot reads no weight bytes and a
// step with no degraded slot costs the empty launches. What still holds it
// back (H100, tools/time_ffn.py): with ~20 live experts the launch reaches
// ~60% of its byte bound on the device, but with the tier path's usual 3-4
// it has ~44 live gate/up blocks for 132 SMs and reaches ~20% at every
// stage depth tried (16, 32, 64). More blocks per live expert (a narrower
// column tile, or a persistent grid over the live (expert, column tile)
// pairs) is the next step there.
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
