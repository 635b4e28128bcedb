// Algorithm 1 (Buddy Expert Substitution), precedence mode, for sm_90a.
//
// Replaces the TPU kernel buddy_substitute_pallas
// (src/repro/kernels/buddy_substitute.py). Per token, the K slots run in rank
// order and each sees the earlier slots' substitutions: a non-resident slot
// of a gated token with budget left takes the best-Psi (Psi = q, ties to the
// lower rank) resident buddy among the first H ranks that the token does not
// already use; otherwise it is a miss. Budget rho per gated token.
//
// Bound on the H100: a few KB in and out per step, so launch latency bounds
// it. The TPU version vectorized tokens across lanes and expressed every
// expert lookup as a one-hot matmul; here one thread owns one token (K <= 16
// and H <= R loops in registers) and the residency mask, buddy table and q
// values are staged once per block in shared memory, so each lookup is a
// shared-memory load. The kernel is route.cuh's substitute_kernel with the
// distribution gate and the miss splits switched off (the gate is given);
// route.cu runs the same kernel with them on, and on the model's path this
// entry point stands alone.
#include "route.cuh"

extern "C" int buddy_substitute_smem_bytes(int E, int R) { return route::tables_smem_bytes(E, R); }

extern "C" int buddy_substitute_launch(const int* s, const uint8_t* gate, const uint8_t* resident,
                                       const int* table, const float* q, int T, int K, int E,
                                       int R, int H, int rho, int* out, uint8_t* sub,
                                       uint8_t* miss, cudaStream_t stream) {
  using namespace route;
  const int smem = tables_smem_bytes(E, R);
  if (K > MAX_K || H > R || smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  if (T == 0) return static_cast<int>(cudaSuccess);
  const Tables g{table, q, nullptr, nullptr, nullptr, nullptr, resident, nullptr, nullptr};
  const SubOut o{out, sub, miss, nullptr, nullptr, nullptr};
  const SubParams p{K, R, H, rho, 1, 0, 0.f, 0.f, 0.f, 0.f, E, nullptr, nullptr};
  substitute_kernel<<<(T + SUB_THREADS - 1) / SUB_THREADS, SUB_THREADS, smem, stream>>>(
      SubArgs{s, gate, T, 0, 0.f, p, g, o, nullptr});
  return static_cast<int>(cudaGetLastError());
}
