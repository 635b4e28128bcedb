// One grouped expert launch pair for the miss outcomes, for sm_90a.
//
// Replaces the TPU kernel grouped_ffn_pallas (src/repro/kernels/grouped_ffn.py).
// x [2E, C, D] holds slots binned by (resolved expert, class): groups [0, E)
// are the full-precision class with expert_ffn numerics, groups [E, 2E) the
// degraded class against expert (g - E)'s int8 replica with per-output-
// channel scales applied after each matmul. Unfilled rows come back zero.
//
// Bound on the H100: at decode (C = T*K = 24 slots over 128 groups, at most
// 24 of them live) almost every weight byte read serves one or two rows, so
// the bytes of the live groups' weights bound it. Unlike the Pallas version,
// which streams both classes' blocks for every group, a block reads only its
// own class's weights, and a per-group row count from the binning step
// (counts[g]) makes a block of an empty group, or of rows past the count,
// return before reading anything. That is exact: unfilled rows are zero and
// SwiGLU(0) = 0, and the wrapper hands in a zeroed output. Without int8
// replicas the launch covers only the E full-precision groups.
#include "ffn_gemm.cuh"

extern "C" int grouped_ffn_launch(int dtype, const void* x, const void* w1, const void* w3,
                                  const void* w2, const int8_t* w1q, const float* s1,
                                  const int8_t* w3q, const float* s3, const int8_t* w2q,
                                  const float* s2, const int* counts, float* h, void* out, int E,
                                  int G, int C, int D, int F, cudaStream_t stream) {
  if (dtype == 0) {
    return ffn::launch<float>(static_cast<const float*>(x), static_cast<const float*>(w1),
                              static_cast<const float*>(w3), static_cast<const float*>(w2), w1q,
                              s1, w3q, s3, w2q, s2, counts, h, static_cast<float*>(out), E, G, C,
                              D, F, stream);
  }
  if (dtype == 1) {
    using bf = __nv_bfloat16;
    return ffn::launch<bf>(static_cast<const bf*>(x), static_cast<const bf*>(w1),
                           static_cast<const bf*>(w3), static_cast<const bf*>(w2), w1q, s1, w3q,
                           s3, w2q, s2, counts, h, static_cast<bf*>(out), E, G, C, D, F, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
