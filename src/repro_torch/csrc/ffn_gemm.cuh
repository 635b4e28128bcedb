// Tiled SwiGLU expert FFN for Hopper (sm_90a), shared by expert_ffn.cu and
// grouped_ffn.cu.
//
// Two launches, deterministic, no atomics:
//   gate_up: h[g, m, f] = act(x[g, m, :] @ w1[e, :, f], x[g, m, :] @ w3[e, :, f])
//   down:    out[g, m, d] = (h[g, m, :] @ w2[e, :, d]) (* s2[e, d] for int8)
// Group g < E is the full-precision class at expert e = g: matmuls on T
// (float or bf16) inputs with f32 accumulation and act = round_T(silu(a1) *
// a3), exactly the reference's cast of hg back to x.dtype. Group g >= E is
// the degraded class at expert e = g - E: int8 weights, everything in f32,
// per-output-channel scales applied after each matmul. The scratch h is f32
// for both classes (a full-precision value is stored already rounded to T).
//
// Each block computes a BM x BN output tile of one group, staging BK-deep
// slices of the activations and weights in shared memory and accumulating in
// registers with f32 FMA (no TF32, no tensor cores yet). A group's row count
// (counts[g], optional) bounds the rows computed: a block whose rows are all
// past it returns at once, so empty groups cost one block launch and no
// weight bytes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ffn {

constexpr int BM = 32;        // rows of a tile
constexpr int BN = 64;        // columns of a tile
constexpr int BK = 32;        // depth of a staged slice
constexpr int THREADS = 256;  // 16 x 16 threads; each owns 2 rows x 4 cols

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float ld(const int8_t* p) { return static_cast<float>(*p); }

__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

// Stage a[m0 .. m0+BM) x [k0 .. k0+BK) of a row-major [rows, ld_a] matrix,
// transposed into As[k][m]; out-of-range entries are zero.
template <typename A>
__device__ __forceinline__ void stage_a(const A* __restrict__ a, int rows, int depth,
                                        int m0, int k0, float (*As)[BM + 1]) {
#pragma unroll
  for (int l = 0; l < (BM * BK) / THREADS; ++l) {
    const int idx = threadIdx.x + l * THREADS;
    const int m = idx / BK, k = idx % BK;
    const int gm = m0 + m, gk = k0 + k;
    As[k][m] = (gm < rows && gk < depth) ? ld(a + (size_t)gm * depth + gk) : 0.f;
  }
}

// Stage w[k0 .. k0+BK) x [n0 .. n0+BN) of a row-major [depth, cols] matrix.
template <typename W>
__device__ __forceinline__ void stage_b(const W* __restrict__ w, int depth, int cols,
                                        int k0, int n0, float (*Bs)[BN]) {
#pragma unroll
  for (int l = 0; l < (BK * BN) / THREADS; ++l) {
    const int idx = threadIdx.x + l * THREADS;
    const int k = idx / BN, n = idx % BN;
    const int gk = k0 + k, gn = n0 + n;
    Bs[k][n] = (gk < depth && gn < cols) ? ld(w + (size_t)gk * cols + gn) : 0.f;
  }
}

struct Smem {
  float As[BK][BM + 1];
  float B1s[BK][BN];
  float B3s[BK][BN];
};

// One gate/up tile: x [rows, D] (T), w1/w3 [D, F] (W) -> h [rows, F] (f32).
template <typename T, typename W, bool QUANT>
__device__ __forceinline__ void gate_up_tile(const T* __restrict__ x, const W* __restrict__ w1,
                                             const W* __restrict__ w3, const float* __restrict__ s1,
                                             const float* __restrict__ s3, float* __restrict__ h,
                                             int rows, int D, int F, int m0, int n0, Smem& sm) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float a1[2][4] = {}, a3[2][4] = {};
  for (int k0 = 0; k0 < D; k0 += BK) {
    stage_a(x, rows, D, m0, k0, sm.As);
    stage_b(w1, D, F, k0, n0, sm.B1s);
    stage_b(w3, D, F, k0, n0, sm.B3s);
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      const float a[2] = {sm.As[kk][ty], sm.As[kk][ty + 16]};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float b1 = sm.B1s[kk][tx + 16 * j], b3 = sm.B3s[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          a1[i][j] = fmaf(a[i], b1, a1[i][j]);
          a3[i][j] = fmaf(a[i], b3, a3[i][j]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (m < rows && n < F) {
        float v;
        if (QUANT) {
          v = silu(a1[i][j] * s1[n]) * (a3[i][j] * s3[n]);
        } else {
          v = round_to(silu(a1[i][j]) * a3[i][j], x);
        }
        h[(size_t)m * F + n] = v;
      }
    }
  }
}

// One down tile: h [rows, F] (f32), w2 [F, D] (W) -> out [rows, D] (T).
template <typename T, typename W, bool QUANT>
__device__ __forceinline__ void down_tile(const float* __restrict__ h, const W* __restrict__ w2,
                                          const float* __restrict__ s2, T* __restrict__ out,
                                          int rows, int F, int D, int m0, int n0, Smem& sm) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[2][4] = {};
  for (int k0 = 0; k0 < F; k0 += BK) {
    stage_a(h, rows, F, m0, k0, sm.As);
    stage_b(w2, F, D, k0, n0, sm.B1s);
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      const float a[2] = {sm.As[kk][ty], sm.As[kk][ty + 16]};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float b = sm.B1s[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 2; ++i) acc[i][j] = fmaf(a[i], b, acc[i][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (m < rows && n < D) st(out + (size_t)m * D + n, QUANT ? acc[i][j] * s2[n] : acc[i][j]);
    }
  }
}

// grid (ceil(F / BN), ceil(C / BM), G); x [G, C, D], h [G, C, F].
template <typename T>
__global__ void __launch_bounds__(THREADS)
gate_up_kernel(const T* __restrict__ x, const T* __restrict__ w1, const T* __restrict__ w3,
               const int8_t* __restrict__ w1q, const float* __restrict__ s1,
               const int8_t* __restrict__ w3q, const float* __restrict__ s3,
               const int* __restrict__ counts, float* __restrict__ h, int E, int C, int D, int F) {
  const int g = blockIdx.z;
  const int rows = counts ? min(counts[g], C) : C;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  if (m0 >= rows) return;  // uniform over the block: no barrier is skipped
  __shared__ Smem sm;
  const T* xg = x + (size_t)g * C * D;
  float* hg = h + (size_t)g * C * F;
  if (g < E) {
    const size_t wo = (size_t)g * D * F;
    gate_up_tile<T, T, false>(xg, w1 + wo, w3 + wo, nullptr, nullptr, hg, rows, D, F, m0, n0, sm);
  } else {
    const int e = g - E;
    const size_t wo = (size_t)e * D * F;
    gate_up_tile<T, int8_t, true>(xg, w1q + wo, w3q + wo, s1 + (size_t)e * F, s3 + (size_t)e * F,
                                  hg, rows, D, F, m0, n0, sm);
  }
}

// grid (ceil(D / BN), ceil(C / BM), G); h [G, C, F], out [G, C, D].
template <typename T>
__global__ void __launch_bounds__(THREADS)
down_kernel(const float* __restrict__ h, const T* __restrict__ w2, const int8_t* __restrict__ w2q,
            const float* __restrict__ s2, const int* __restrict__ counts, T* __restrict__ out,
            int E, int C, int D, int F) {
  const int g = blockIdx.z;
  const int rows = counts ? min(counts[g], C) : C;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  if (m0 >= rows) return;
  __shared__ Smem sm;
  const float* hg = h + (size_t)g * C * F;
  T* og = out + (size_t)g * C * D;
  if (g < E) {
    down_tile<T, T, false>(hg, w2 + (size_t)g * F * D, nullptr, og, rows, F, D, m0, n0, sm);
  } else {
    const int e = g - E;
    down_tile<T, int8_t, true>(hg, w2q + (size_t)e * F * D, s2 + (size_t)e * D, og, rows, F, D,
                               m0, n0, sm);
  }
}

// Both launches on `stream`; G groups (G > E only when int8 replicas are
// given). Returns cudaGetLastError() after the launches.
template <typename T>
int launch(const T* x, const T* w1, const T* w3, const T* w2, const int8_t* w1q, const float* s1,
           const int8_t* w3q, const float* s3, const int8_t* w2q, const float* s2,
           const int* counts, float* h, T* out, int E, int G, int C, int D, int F,
           cudaStream_t stream) {
  const dim3 block(THREADS);
  const dim3 grid1((F + BN - 1) / BN, (C + BM - 1) / BM, G);
  gate_up_kernel<T><<<grid1, block, 0, stream>>>(x, w1, w3, w1q, s1, w3q, s3, counts, h, E, C, D,
                                                 F);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid2((D + BN - 1) / BN, (C + BM - 1) / BM, G);
  down_kernel<T><<<grid2, block, 0, stream>>>(h, w2, w2q, s2, counts, out, E, C, D, F);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ffn
