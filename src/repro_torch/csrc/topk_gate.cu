// Fused MoE router gate for sm_90a: top-k, renormalized top-k softmax, Token
// Activating Entropy (TAE) and the TAE gate, in one pass over the logits.
//
// Replaces the TPU kernel topk_gate_pallas (src/repro/kernels/topk_gate.py):
// top-k by iterative max with ties to the smallest expert index, p =
// softmax(top-k logits), TAE = entropy(p) / log K (0 when K = 1), allow =
// TAE > tau. Implements temperature 1 and no margin co-gate.
//
// Bound on the H100: it reads T*E*4 bytes and writes T*(3K+2) words, a few
// KB at decode, so the launch itself bounds it, not bytes or FLOPs. The
// design keeps the whole row in registers (one warp per token row, E <= 256
// logits as 8 per lane), runs K rounds of a warp-shuffle argmax, and never
// materializes the [T, E] softmax that a library top-k plus separate
// elementwise passes would.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_E = 256;
constexpr int PER_LANE = MAX_E / 32;
constexpr int MAX_K = 16;
constexpr int ROWS_PER_BLOCK = 8;  // warps per block
constexpr int NONE = 0x7fffffff;

__global__ void __launch_bounds__(ROWS_PER_BLOCK * 32)
topk_gate_kernel(const float* __restrict__ logits, int T, int E, int K, float tau, float log_k,
                 int* __restrict__ idx_out, float* __restrict__ val_out,
                 float* __restrict__ prob_out, float* __restrict__ tae_out,
                 uint8_t* __restrict__ allow_out) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (row >= T) return;  // uniform over the warp
  const float* z = logits + (size_t)row * E;

  float v[PER_LANE];
  unsigned taken = 0;  // bit j: element lane + 32 j is selected or absent
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    const int e = lane + 32 * j;
    v[j] = e < E ? z[e] : 0.f;
    if (e >= E) taken |= 1u << j;
  }

  float sel_v[MAX_K];
  int sel_i[MAX_K];
  for (int k = 0; k < K; ++k) {
    // lane-local best: strictly greater wins, so the smallest index among
    // equal values stays (indices grow with j)
    float best = 0.f;
    int bi = NONE;
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) {
      if (!((taken >> j) & 1u) && (bi == NONE || v[j] > best)) {
        best = v[j];
        bi = lane + 32 * j;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (oi != NONE && (bi == NONE || ov > best || (ov == best && oi < bi))) {
        best = ov;
        bi = oi;
      }
    }
    if ((bi & 31) == lane) taken |= 1u << (bi >> 5);
    sel_v[k] = best;
    sel_i[k] = bi;
  }

  // renormalized top-k softmax, entropy and gate (every lane holds the row)
  const float mx = sel_v[0];
  float sum = 0.f;
  for (int k = 0; k < K; ++k) sum += expf(sel_v[k] - mx);
  const float denom = fmaxf(sum, 1e-20f);
  float ent = 0.f;
  for (int k = 0; k < K; ++k) {
    const float p = expf(sel_v[k] - mx) / denom;
    ent -= p * logf(fmaxf(p, 1e-20f));
    if (k == lane) {
      idx_out[(size_t)row * K + k] = sel_i[k];
      val_out[(size_t)row * K + k] = sel_v[k];
      prob_out[(size_t)row * K + k] = p;
    }
  }
  if (lane == 0) {
    const float tae = K > 1 ? ent / log_k : 0.f;
    tae_out[row] = tae;
    allow_out[row] = tae > tau ? 1 : 0;
  }
}

}  // namespace

extern "C" int topk_gate_launch(const float* logits, int T, int E, int K, float tau, float log_k,
                                int* idx, float* vals, float* probs, float* tae, uint8_t* allow,
                                cudaStream_t stream) {
  if (E > MAX_E || K > MAX_K || K > E || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (T == 0) return static_cast<int>(cudaSuccess);
  const int blocks = (T + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  topk_gate_kernel<<<blocks, ROWS_PER_BLOCK * 32, 0, stream>>>(logits, T, E, K, tau, log_k, idx,
                                                               vals, probs, tae, allow);
  return static_cast<int>(cudaGetLastError());
}
