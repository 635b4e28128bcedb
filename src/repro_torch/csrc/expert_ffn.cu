// Grouped expert SwiGLU over capacity-dispatch buffers, for sm_90a.
//
// Replaces the TPU kernel expert_ffn_pallas (src/repro/kernels/expert_ffn.py):
//   out[e] = (silu(x[e] @ w1[e]) * (x[e] @ w3[e])) @ w2[e]
// with matmuls on x.dtype inputs, f32 accumulation, and the hidden product
// cast back to x.dtype between the two matmuls.
//
// Bound on the H100: at the capacity path's shapes (E=64 experts, C=32 rows,
// D=2048, F=1408, f32) every weight element is used by 32 rows, 16 FLOP per
// 4-byte weight read, below the card's f32 ratio of 67 TFLOP/s to 3.35 TB/s,
// so the weight bytes bound it. The design reads each weight once per
// 32-row tile (all of C at these shapes) and keeps the hidden activations in
// an [E, C, F] f32 scratch between the two launches (ffn_gemm.cuh).
#include "ffn_gemm.cuh"

extern "C" int expert_ffn_launch(int dtype, const void* x, const void* w1, const void* w3,
                                 const void* w2, float* h, void* out, int E, int C, int D, int F,
                                 cudaStream_t stream) {
  if (dtype == 0) {
    return ffn::launch<float>(static_cast<const float*>(x), static_cast<const float*>(w1),
                              static_cast<const float*>(w3), static_cast<const float*>(w2),
                              nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, h,
                              static_cast<float*>(out), E, E, C, D, F, stream);
  }
  if (dtype == 1) {
    using bf = __nv_bfloat16;
    return ffn::launch<bf>(static_cast<const bf*>(x), static_cast<const bf*>(w1),
                           static_cast<const bf*>(w3), static_cast<const bf*>(w2), nullptr,
                           nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, h,
                           static_cast<bf*>(out), E, E, C, D, F, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
