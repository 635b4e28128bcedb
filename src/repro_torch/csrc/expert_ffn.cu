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
//
// Only the live rows are computed. A capacity buffer is mostly zero rows
// where it is binned per batch row ([E, B, cap]: at Mixtral-8x22B's decode,
// 64 tokens x 2 picks fill 128 of [8, 128] rows, scattered over every row
// tile), and a zero row gives a zero output (SwiGLU(0) = silu(0) * 0 = 0,
// 0 @ w2 = 0, for finite weights). So one launch first finds the live rows
// (any element other than +-0; NaN is live): one block a row streams x once
// near the HBM rate, zeroes the output row of a dead one, and the group's
// last block to finish writes counts[g] and idx[g, :], the live rows in row
// order, then adds counts[g] to a device-side running total of rows
// computed. Then the shared tile's row-indexed instance runs them: row tiles
// past counts[g] return at once, and the row sub-tile covers the count, so
// at decode one row tile per expert streams its weights once (the bound is
// the live experts' weight bytes). A row's FMA chain is the same as when
// every row is computed, so live rows come out the same bits.
#include <stdint.h>

#include "ffn_gemm.cuh"

namespace {

constexpr int LIVE_THREADS = 256;

// An element's bits (U) and the mask of all but the sign: of one element
// (ONE), of a 32-bit word of elements (WORD).
template <typename T> struct Magnitude;
template <> struct Magnitude<float> {
  using U = uint32_t;
  static constexpr U ONE = 0x7fffffffu;
  static constexpr uint32_t WORD = 0x7fffffffu;
};
template <> struct Magnitude<__nv_bfloat16> {
  using U = uint16_t;
  static constexpr U ONE = 0x7fff;
  static constexpr uint32_t WORD = 0x7fff7fffu;
};

// grid (C, E), one block a row of x [E, C, D]. rows: counts [E], then
// idx [E, C]; done [E] is zero at entry and left zero; computed += the live
// rows. A dead row's output row is zeroed here; the tiles write the live
// ones.
template <typename T>
__global__ void __launch_bounds__(LIVE_THREADS)
live_rows_kernel(const T* __restrict__ x, T* __restrict__ out, int* __restrict__ rows,
                 unsigned* __restrict__ done, unsigned long long* __restrict__ computed, int E,
                 int C, int D) {
  using M = Magnitude<T>;
  const int g = blockIdx.y, r = blockIdx.x;
  const size_t base = ((size_t)g * C + r) * D;
  const bool vec = D * sizeof(T) % 16 == 0;
  const int n = vec ? static_cast<int>(D * sizeof(T) / 16) : D;
  bool any = false;
  if (vec) {
    const uint4* src = reinterpret_cast<const uint4*>(x + base);
#pragma unroll 4
    for (int i = threadIdx.x; i < n; i += LIVE_THREADS) {
      const uint4 v = __ldg(src + i);
      any |= ((v.x | v.y | v.z | v.w) & M::WORD) != 0;
    }
  } else {
    const typename M::U* src = reinterpret_cast<const typename M::U*>(x + base);
    for (int i = threadIdx.x; i < n; i += LIVE_THREADS) any |= (src[i] & M::ONE) != 0;
  }
  const bool live = __syncthreads_or(any);
  if (!live) {
    if (vec) {
      uint4* dst = reinterpret_cast<uint4*>(out + base);
      for (int i = threadIdx.x; i < n; i += LIVE_THREADS) dst[i] = make_uint4(0, 0, 0, 0);
    } else {
      typename M::U* dst = reinterpret_cast<typename M::U*>(out + base);
      for (int i = threadIdx.x; i < n; i += LIVE_THREADS) dst[i] = 0;
    }
  }
  int* idx = rows + E + (size_t)g * C;
  __shared__ bool last;
  if (threadIdx.x == 0) {
    idx[r] = live;      // the row's flag, until the group's last block compacts
    __threadfence();    // the flag is visible before the arrival that reports it
    last = atomicAdd(done + g, 1u) == static_cast<unsigned>(C) - 1;
    __threadfence();
  }
  __syncthreads();
  if (!last) return;
  // The group's last block: idx[g, :] holds every row's flag. Compact it in
  // place, in row order, a chunk of LIVE_THREADS rows at a time (a live row
  // moves to a position at or below its own, already read).
  __shared__ int warp_live[LIVE_THREADS / 32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const volatile int* flags = idx;
  int total = 0;  // uniform over the block
  for (int c0 = 0; c0 < C; c0 += LIVE_THREADS) {
    const int row = c0 + threadIdx.x;
    const bool f = row < C && flags[row] != 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, f);
    if (lane == 0) warp_live[warp] = __popc(ballot);
    __syncthreads();  // every flag of the chunk is read before any is overwritten
    int at = total + __popc(ballot & ((1u << lane) - 1));
    for (int w = 0; w < LIVE_THREADS / 32; ++w) {
      if (w < warp) at += warp_live[w];
      total += warp_live[w];
    }
    if (f) idx[at] = row;
    __syncthreads();  // warp_live is read by all before the next chunk writes it
  }
  if (threadIdx.x == 0) {
    rows[g] = total;
    atomicAdd(computed, static_cast<unsigned long long>(total));
    done[g] = 0;
  }
}

template <typename T>
int launch_live_rows(const T* x, const T* w1, const T* w3, const T* w2, int* rows,
                     unsigned* done, unsigned long long* computed, float* h, T* out, int E, int C,
                     int D, int F, int vec16, int smem_gate_up, int smem_down,
                     cudaStream_t stream) {
  live_rows_kernel<T><<<dim3(C, E), LIVE_THREADS, 0, stream>>>(x, out, rows, done, computed, E,
                                                               C, D);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return ffn::launch<T, ffn::CLASS_FP | ffn::ROWS_INDEXED>(
      x, w1, w3, w2, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, rows, h, out, E, E, C,
      D, F, vec16, smem_gate_up, smem_down, stream);
}

}  // namespace

// rows: int32 [E + E*C] scratch (counts, then idx); done: int32 [>= E],
// zero, left zero; computed: the int64 running total of rows computed.
extern "C" int expert_ffn_launch(int dtype, const void* x, const void* w1, const void* w3,
                                 const void* w2, int* rows, unsigned* done,
                                 unsigned long long* computed, float* h, void* out, int E, int C,
                                 int D, int F, int vec16, int smem_gate_up, int smem_down,
                                 cudaStream_t stream) {
  if (dtype == 0) {
    return launch_live_rows<float>(
        static_cast<const float*>(x), static_cast<const float*>(w1), static_cast<const float*>(w3),
        static_cast<const float*>(w2), rows, done, computed, h, static_cast<float*>(out), E, C, D,
        F, vec16, smem_gate_up, smem_down, stream);
  }
  if (dtype == 1) {
    using bf = __nv_bfloat16;
    return launch_live_rows<bf>(
        static_cast<const bf*>(x), static_cast<const bf*>(w1), static_cast<const bf*>(w3),
        static_cast<const bf*>(w2), rows, done, computed, h, static_cast<bf*>(out), E, C, D, F,
        vec16, smem_gate_up, smem_down, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
