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
// shared-memory load. The paper's own mapping (one block per token) is left
// for a later change.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_K = 16;
constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
buddy_substitute_kernel(const int* __restrict__ s, const uint8_t* __restrict__ gate,
                        const uint8_t* __restrict__ resident, const int* __restrict__ table,
                        const float* __restrict__ q, int T, int K, int E, int R, int H, int rho,
                        int* __restrict__ out, uint8_t* __restrict__ sub,
                        uint8_t* __restrict__ miss) {
  extern __shared__ unsigned char smem[];
  int* tab_s = reinterpret_cast<int*>(smem);
  float* q_s = reinterpret_cast<float*>(tab_s + E * R);
  uint8_t* res_s = reinterpret_cast<uint8_t*>(q_s + E * R);
  for (int i = threadIdx.x; i < E * R; i += blockDim.x) {
    tab_s[i] = table[i];
    q_s[i] = q[i];
  }
  for (int i = threadIdx.x; i < E; i += blockDim.x) res_s[i] = resident[i];
  __syncthreads();

  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  int row[MAX_K];
  for (int k = 0; k < K; ++k) row[k] = s[(size_t)t * K + k];
  const bool g = gate[t] != 0;
  int budget = g ? rho : 0;

  for (int k = 0; k < K; ++k) {
    const int e = row[k];
    const bool res_e = res_s[e] != 0;
    int best_b = -1;
    if (!res_e && g && budget > 0) {
      float best_psi = -INFINITY;
      for (int r = 0; r < H; ++r) {
        const int b = tab_s[e * R + r];
        if (b < 0 || !res_s[b]) continue;
        bool used = false;
        for (int kk = 0; kk < K; ++kk) used |= row[kk] == b;
        if (used) continue;
        const float psi = q_s[e * R + r] - static_cast<float>(r) * 1e-7f;  // rank tie-break
        if (psi > best_psi) {
          best_psi = psi;
          best_b = b;
        }
      }
    }
    const bool do_sub = best_b >= 0;
    row[k] = do_sub ? best_b : e;
    out[(size_t)t * K + k] = row[k];
    sub[(size_t)t * K + k] = do_sub ? 1 : 0;
    miss[(size_t)t * K + k] = (!res_e && !do_sub) ? 1 : 0;
    budget -= do_sub ? 1 : 0;
  }
}

}  // namespace

extern "C" int buddy_substitute_smem_bytes(int E, int R) { return E * R * 8 + E; }

extern "C" int buddy_substitute_launch(const int* s, const uint8_t* gate, const uint8_t* resident,
                                       const int* table, const float* q, int T, int K, int E,
                                       int R, int H, int rho, int* out, uint8_t* sub,
                                       uint8_t* miss, cudaStream_t stream) {
  const int smem = buddy_substitute_smem_bytes(E, R);
  if (K > MAX_K || H > R || smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (T == 0) return static_cast<int>(cudaSuccess);
  const int blocks = (T + THREADS - 1) / THREADS;
  buddy_substitute_kernel<<<blocks, THREADS, smem, stream>>>(s, gate, resident, table, q, T, K, E,
                                                             R, H, rho, out, sub, miss);
  return static_cast<int>(cudaGetLastError());
}
