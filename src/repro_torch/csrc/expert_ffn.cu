// Grouped expert SwiGLU over capacity-dispatch buffers, for sm_90a.
//
// Replaces the TPU kernel expert_ffn_pallas (src/repro/kernels/expert_ffn.py):
//   out[e] = (silu(x[e] @ w1[e]) * (x[e] @ w3[e])) @ w2[e]
// with matmuls on x.dtype inputs, f32 accumulation, and the hidden product
// cast back to x.dtype between the two matmuls.
//
// Bound on the H100: at the capacity path's shapes (E=64 experts, C=32 rows,
// D=2048, F=1408, f32) every weight element is used by 32 rows, 16 FLOP per
// 4-byte weight read: the byte bound (0.67 ms) and the f32 FMA bound (0.53
// ms) are close, so the weight stream and the FMAs have to overlap, each
// near its peak. The shared tile (ffn_gemm.cuh, full-precision class only)
// keeps three 16-deep weight slices in flight through a cp.async ring while
// the 32-row instance runs 8 x 4 outputs per matrix and thread from float4
// shared-memory reads; the hidden activations stay in an [E, C, F] f32
// scratch between the two launches.
#include "ffn_gemm.cuh"

extern "C" int expert_ffn_launch(int dtype, const void* x, const void* w1, const void* w3,
                                 const void* w2, float* h, void* out, int E, int C, int D, int F,
                                 int vec16, int smem_gate_up, int smem_down,
                                 cudaStream_t stream) {
  if (dtype == 0) {
    return ffn::launch<float, ffn::CLASS_FP>(
        static_cast<const float*>(x), static_cast<const float*>(w1),
        static_cast<const float*>(w3), static_cast<const float*>(w2), nullptr, nullptr, nullptr,
        nullptr, nullptr, nullptr, nullptr, h, static_cast<float*>(out), E, E, C, D, F, vec16,
        smem_gate_up, smem_down, stream);
  }
  if (dtype == 1) {
    using bf = __nv_bfloat16;
    return ffn::launch<bf, ffn::CLASS_FP>(
        static_cast<const bf*>(x), static_cast<const bf*>(w1), static_cast<const bf*>(w3),
        static_cast<const bf*>(w2), nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
        h, static_cast<bf*>(out), E, E, C, D, F, vec16, smem_gate_up, smem_down, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
