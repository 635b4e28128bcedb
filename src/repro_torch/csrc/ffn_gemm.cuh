// Tiled SwiGLU expert FFN for Hopper (sm_90a), shared by expert_ffn.cu,
// grouped_ffn.cu and quant_ffn.cu.
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
// quant_ffn.cu launches with E = 0, so every group is the degraded class.
//
// What bounds it on the H100: each weight element is read once per 32-row
// tile and used by the tile's filled rows only. At decode (1-3 rows per
// group) that is ~2 FLOP per 4-byte weight, far below the card's f32 ratio
// of 67 TFLOP/s to 3.35 TB/s, so the live groups' weight bytes bound it; at
// 32 full rows (the capacity dispatch) the byte bound (0.67 ms) and the f32
// FMA bound (0.53 ms) are close, so loads and FMAs must run at once, each
// near its peak. No tensor cores: every output is one f32 FMA chain over k
// in increasing order (no split over depth, no TF32), which keeps f32
// parity with the reference.
//
// The design:
//  - A ring of STAGES shared-memory stages, each one BK-deep slice of the
//    activation rows and of the block's BN weight columns, filled with
//    cp.async: the slices kt+1 .. kt+3 stay in flight while slice kt's FMAs
//    run, so the weight stream never waits on the FMAs (one barrier per
//    slice). A gate/up block of f32 weights keeps 48 KB in flight, and three
//    such blocks fit on an SM (72 KB of dynamic shared memory each).
//  - FMA work sized to the filled rows. A block reads counts[g] once and
//    branches, uniformly over the block, into the instance whose row
//    sub-tile RM (1, 2, 4, 8, 16 or 32) covers them. Up to 8 rows every
//    thread owns one column and all RM rows; at 16 and 32 rows RM / 8 row
//    groups split the block and each thread owns 8 rows x RM / 8 adjacent
//    columns (8 x 4 per matrix at 32 rows, fed by float4 shared-memory
//    reads along k for the activations and along n for the weights), so
//    shared-memory reads stay well under the FMA rate.
//  - int8 weights arrive as bytes (16 per copy) and are widened to f32 when
//    read from shared memory; bf16 activations and weights likewise.
//  - Two load widths, one tile and one FMA order. The vec16 instance copies
//    16-byte chunks (cp.async.cg, zero-filled past the ragged edge); it
//    needs every copied row to be a multiple of 16 bytes. The elem
//    instance copies single elements (4-byte cp.async for f32, plain loads
//    for bf16 and int8), for any row length. Both need 16-byte-aligned base
//    pointers. The Python side (kernels/expert_ffn.launch_plan) picks the
//    instance and the dynamic shared-memory bytes; launch() checks the
//    bytes against its own layout and refuses a mismatch.
//  - Empty groups, and row tiles past a group's count, return at once
//    (uniform over the block): they cost a block launch and no weight bytes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace ffn {

constexpr int BM = 32;        // rows of a block's tile
constexpr int BN = 128;       // columns of a block's tile
constexpr int BK = 16;        // depth of one stage
constexpr int STAGES = 4;     // ring depth: 3 slices in flight during FMAs
constexpr int THREADS = 128;
constexpr int MIN_BLOCKS = 3; // per SM: caps registers at 170

constexpr int CLASS_FP = 1;   // full-precision groups [0, E)
constexpr int CLASS_Q = 2;    // int8 groups [E, G)

// Dynamic shared memory of one launch (must equal launch_plan's).
__host__ __device__ constexpr int gate_up_stage_bytes(int t_size, int w_size) {
  return BM * BK * t_size + 2 * BK * BN * w_size;
}
__host__ __device__ constexpr int down_stage_bytes(int w_size) {
  return BM * BK * 4 + BK * BN * w_size;
}

__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

// ---------------------------------------------------------------- cp.async
__device__ __forceinline__ void cp16(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp4(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int S> struct Bits;
template <> struct Bits<2> { using type = uint16_t; };
template <> struct Bits<1> { using type = uint8_t; };

// Copy an R x CC tile of a row-major matrix (row stride ld elements) into
// shared memory [R][CC]; entries at rows >= r_valid or columns >= c_valid
// are zero. VEC16: 16-byte chunks (the caller guarantees ld and the valid
// widths are multiples of a chunk, and the pointers are 16-byte aligned).
template <typename E, bool VEC16, int R, int CC>
__device__ __forceinline__ void copy_tile(E* dst, const E* __restrict__ src, int ld,
                                          int r_valid, int c_valid) {
  if constexpr (VEC16) {
    constexpr int V = 16 / sizeof(E), PER_ROW = CC / V, N = R * PER_ROW;
#pragma unroll
    for (int l = 0; l < (N + THREADS - 1) / THREADS; ++l) {
      const int i = threadIdx.x + l * THREADS;
      if (N % THREADS == 0 || i < N) {
        const int r = i / PER_ROW, c = (i % PER_ROW) * V;
        const bool ok = r < r_valid && c < c_valid;
        cp16(dst + r * CC + c, ok ? src + (size_t)r * ld + c : src, ok ? 16 : 0);
      }
    }
  } else {
    constexpr int N = R * CC;
#pragma unroll 4
    for (int l = 0; l < (N + THREADS - 1) / THREADS; ++l) {
      const int i = threadIdx.x + l * THREADS;
      if (N % THREADS == 0 || i < N) {
        const int r = i / CC, c = i % CC;
        const bool ok = r < r_valid && c < c_valid;
        if constexpr (sizeof(E) == 4) {
          cp4(dst + i, ok ? src + (size_t)r * ld + c : src, ok ? 4 : 0);
        } else {
          using U = typename Bits<sizeof(E)>::type;
          reinterpret_cast<U*>(dst)[i] =
              ok ? reinterpret_cast<const U*>(src)[(size_t)r * ld + c] : U(0);
        }
      }
    }
  }
}

// N consecutive elements of shared memory, widened to f32 (p is aligned to
// N elements).
template <int N>
__device__ __forceinline__ void lds(const float* p, float* o) {
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    o[0] = v.x; o[1] = v.y;
  } else {
    o[0] = *p;
  }
}
template <int N>
__device__ __forceinline__ void lds(const __nv_bfloat16* p, float* o) {
  if constexpr (N == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
    o[0] = lo.x; o[1] = lo.y; o[2] = hi.x; o[3] = hi.y;
  } else if constexpr (N == 2) {
    const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    o[0] = v.x; o[1] = v.y;
  } else {
    o[0] = __bfloat162float(*p);
  }
}
template <int N>
__device__ __forceinline__ void lds(const int8_t* p, float* o) {
  if constexpr (N == 4) {
    const char4 v = *reinterpret_cast<const char4*>(p);
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  } else if constexpr (N == 2) {
    const char2 v = *reinterpret_cast<const char2*>(p);
    o[0] = v.x; o[1] = v.y;
  } else {
    o[0] = static_cast<float>(*p);
  }
}

// The thread layout of a row sub-tile of RM rows: RG row groups of TM rows;
// each thread owns TM rows x TN adjacent columns, TN = RG, BN / TN column
// groups.
template <int RM>
struct Layout {
  static constexpr int TM = RM < 8 ? RM : 8;
  static constexpr int RG = RM / TM;
  static constexpr int TN = RG;
  static constexpr int CG = THREADS / RG;
  static_assert(CG * TN == BN, "a block covers BN columns");
};

// NMAT weight matrices [depth, cols] against one activation slab [rows,
// depth]: acc[q][i][j] = sum_k a[m0 + row_i, k] * w_q[k, n0 + col_j], one FMA
// chain per output in increasing k, through the cp.async ring.
template <typename A, typename W, int NMAT, int RM, bool VEC16>
__device__ __forceinline__ void mma_ring(const A* __restrict__ a, const W* __restrict__ w0,
                                         const W* __restrict__ w1, int rows, int depth, int cols,
                                         int m0, int n0, unsigned char* smem, int stage_bytes,
                                         float (&acc)[NMAT][Layout<RM>::TM][Layout<RM>::TN]) {
  using L = Layout<RM>;
  constexpr int A_BYTES = BM * BK * sizeof(A), B_BYTES = BK * BN * sizeof(W);
  const int rg = threadIdx.x / L::CG, cg = threadIdx.x % L::CG;
  const int nk = (depth + BK - 1) / BK;
  const A* a_tile = a + (size_t)m0 * depth;
  auto load = [&](int kt) {
    unsigned char* s = smem + (kt % STAGES) * stage_bytes;
    const int k0 = kt * BK;
    copy_tile<A, VEC16, RM, BK>(reinterpret_cast<A*>(s), a_tile + k0, depth, rows - m0,
                                depth - k0);
    copy_tile<W, VEC16, BK, BN>(reinterpret_cast<W*>(s + A_BYTES), w0 + (size_t)k0 * cols + n0,
                                cols, depth - k0, cols - n0);
    if constexpr (NMAT == 2)
      copy_tile<W, VEC16, BK, BN>(reinterpret_cast<W*>(s + A_BYTES + B_BYTES),
                                  w1 + (size_t)k0 * cols + n0, cols, depth - k0, cols - n0);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s);
    commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    wait_pending<STAGES - 2>();  // this thread's copies of slice kt landed
    __syncthreads();             // everyone's landed; slot kt-1 is free
    if (kt + STAGES - 1 < nk) load(kt + STAGES - 1);
    commit();                    // (possibly empty) keeps the group count uniform
    const unsigned char* s = smem + (kt % STAGES) * stage_bytes;
    const A* as = reinterpret_cast<const A*>(s) + (rg * L::TM) * BK;
    const W* bs = reinterpret_cast<const W*>(s + A_BYTES) + cg * L::TN;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      float av[L::TM][4];
#pragma unroll
      for (int i = 0; i < L::TM; ++i) lds<4>(as + i * BK + kk, av[i]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int q = 0; q < NMAT; ++q) {
          float b[L::TN];
          lds<L::TN>(bs + q * (B_BYTES / sizeof(W)) + (kk + u) * BN, b);
#pragma unroll
          for (int i = 0; i < L::TM; ++i)
#pragma unroll
            for (int j = 0; j < L::TN; ++j) acc[q][i][j] = fmaf(av[i][u], b[j], acc[q][i][j]);
        }
      }
    }
  }
}

// One gate/up tile: x [rows, D] (T), w1/w3 [D, F] (W) -> h [rows, F] (f32).
template <typename T, typename W, bool QUANT, int RM, bool VEC16>
__device__ __forceinline__ void gate_up_tile(const T* __restrict__ x, const W* __restrict__ w1,
                                             const W* __restrict__ w3, const float* __restrict__ s1,
                                             const float* __restrict__ s3, float* __restrict__ h,
                                             int rows, int D, int F, int m0, int n0,
                                             unsigned char* smem, int stage_bytes) {
  using L = Layout<RM>;
  float acc[2][L::TM][L::TN] = {};
  mma_ring<T, W, 2, RM, VEC16>(x, w1, w3, rows, D, F, m0, n0, smem, stage_bytes, acc);
  const int rg = threadIdx.x / L::CG, cg = threadIdx.x % L::CG;
#pragma unroll
  for (int i = 0; i < L::TM; ++i) {
    const int m = m0 + rg * L::TM + i;
#pragma unroll
    for (int j = 0; j < L::TN; ++j) {
      const int n = n0 + cg * L::TN + j;
      if (m < rows && n < F) {
        float v;
        if constexpr (QUANT) {
          v = silu(acc[0][i][j] * s1[n]) * (acc[1][i][j] * s3[n]);
        } else {
          v = round_to(silu(acc[0][i][j]) * acc[1][i][j], x);
        }
        h[(size_t)m * F + n] = v;
      }
    }
  }
}

// One down tile: h [rows, F] (f32), w2 [F, D] (W) -> out [rows, D] (T).
template <typename T, typename W, bool QUANT, int RM, bool VEC16>
__device__ __forceinline__ void down_tile(const float* __restrict__ h, const W* __restrict__ w2,
                                          const float* __restrict__ s2, T* __restrict__ out,
                                          int rows, int F, int D, int m0, int n0,
                                          unsigned char* smem, int stage_bytes) {
  using L = Layout<RM>;
  float acc[1][L::TM][L::TN] = {};
  mma_ring<float, W, 1, RM, VEC16>(h, w2, nullptr, rows, F, D, m0, n0, smem, stage_bytes, acc);
  const int rg = threadIdx.x / L::CG, cg = threadIdx.x % L::CG;
#pragma unroll
  for (int i = 0; i < L::TM; ++i) {
    const int m = m0 + rg * L::TM + i;
#pragma unroll
    for (int j = 0; j < L::TN; ++j) {
      const int n = n0 + cg * L::TN + j;
      if (m < rows && n < D)
        st(out + (size_t)m * D + n, QUANT ? acc[0][i][j] * s2[n] : acc[0][i][j]);
    }
  }
}

// Call fn(std::integral_constant<int, RM>) for the row sub-tile that covers
// `live` rows (uniform over the block).
template <typename Fn>
__device__ __forceinline__ void by_rows(int live, Fn&& fn) {
  if (live <= 1) fn(std::integral_constant<int, 1>());
  else if (live <= 2) fn(std::integral_constant<int, 2>());
  else if (live <= 4) fn(std::integral_constant<int, 4>());
  else if (live <= 8) fn(std::integral_constant<int, 8>());
  else if (live <= 16) fn(std::integral_constant<int, 16>());
  else fn(std::integral_constant<int, 32>());
}

// grid (ceil(F / BN), ceil(C / BM), G); x [G, C, D], h [G, C, F].
template <typename T, int CLASSES, bool VEC16>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
gate_up_kernel(const T* __restrict__ x, const T* __restrict__ w1, const T* __restrict__ w3,
               const int8_t* __restrict__ w1q, const float* __restrict__ s1,
               const int8_t* __restrict__ w3q, const float* __restrict__ s3,
               const int* __restrict__ counts, float* __restrict__ h, int E, int C, int D, int F,
               int stage_bytes) {
  const int g = blockIdx.z;
  const int rows = counts ? min(counts[g], C) : C;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  if (m0 >= rows) return;  // uniform over the block: no barrier is skipped
  extern __shared__ __align__(16) unsigned char smem[];
  const T* xg = x + (size_t)g * C * D;
  float* hg = h + (size_t)g * C * F;
  const int live = min(rows - m0, BM);
  if (g < E) {
    if constexpr ((CLASSES & CLASS_FP) != 0) {
      const size_t wo = (size_t)g * D * F;
      by_rows(live, [&](auto rm) {
        gate_up_tile<T, T, false, decltype(rm)::value, VEC16>(
            xg, w1 + wo, w3 + wo, nullptr, nullptr, hg, rows, D, F, m0, n0, smem, stage_bytes);
      });
    }
  } else {
    if constexpr ((CLASSES & CLASS_Q) != 0) {
      const int e = g - E;
      const size_t wo = (size_t)e * D * F;
      by_rows(live, [&](auto rm) {
        gate_up_tile<T, int8_t, true, decltype(rm)::value, VEC16>(
            xg, w1q + wo, w3q + wo, s1 + (size_t)e * F, s3 + (size_t)e * F, hg, rows, D, F, m0,
            n0, smem, stage_bytes);
      });
    }
  }
}

// grid (ceil(D / BN), ceil(C / BM), G); h [G, C, F], out [G, C, D].
template <typename T, int CLASSES, bool VEC16>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
down_kernel(const float* __restrict__ h, const T* __restrict__ w2,
            const int8_t* __restrict__ w2q, const float* __restrict__ s2,
            const int* __restrict__ counts, T* __restrict__ out, int E, int C, int D, int F,
            int stage_bytes) {
  const int g = blockIdx.z;
  const int rows = counts ? min(counts[g], C) : C;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  if (m0 >= rows) return;
  extern __shared__ __align__(16) unsigned char smem[];
  const float* hg = h + (size_t)g * C * F;
  T* og = out + (size_t)g * C * D;
  const int live = min(rows - m0, BM);
  if (g < E) {
    if constexpr ((CLASSES & CLASS_FP) != 0) {
      by_rows(live, [&](auto rm) {
        down_tile<T, T, false, decltype(rm)::value, VEC16>(
            hg, w2 + (size_t)g * F * D, nullptr, og, rows, F, D, m0, n0, smem, stage_bytes);
      });
    }
  } else {
    if constexpr ((CLASSES & CLASS_Q) != 0) {
      const int e = g - E;
      by_rows(live, [&](auto rm) {
        down_tile<T, int8_t, true, decltype(rm)::value, VEC16>(
            hg, w2q + (size_t)e * F * D, s2 + (size_t)e * D, og, rows, F, D, m0, n0, smem,
            stage_bytes);
      });
    }
  }
}

template <typename T, int CLASSES, bool VEC16>
int launch_pair(const T* x, const T* w1, const T* w3, const T* w2, const int8_t* w1q,
                const float* s1, const int8_t* w3q, const float* s3, const int8_t* w2q,
                const float* s2, const int* counts, float* h, T* out, int E, int G, int C, int D,
                int F, int smem_gate_up, int smem_down, cudaStream_t stream) {
  constexpr int w_size = (CLASSES & CLASS_FP) ? sizeof(T) : 1;
  constexpr int st1 = gate_up_stage_bytes(sizeof(T), w_size), st2 = down_stage_bytes(w_size);
  if (smem_gate_up != STAGES * st1 || smem_down != STAGES * st2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(gate_up_kernel<T, CLASSES, VEC16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_gate_up);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(down_kernel<T, CLASSES, VEC16>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_down);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid1((F + BN - 1) / BN, (C + BM - 1) / BM, G);
  gate_up_kernel<T, CLASSES, VEC16><<<grid1, THREADS, smem_gate_up, stream>>>(
      x, w1, w3, w1q, s1, w3q, s3, counts, h, E, C, D, F, st1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid2((D + BN - 1) / BN, (C + BM - 1) / BM, G);
  down_kernel<T, CLASSES, VEC16><<<grid2, THREADS, smem_down, stream>>>(
      h, w2, w2q, s2, counts, out, E, C, D, F, st2);
  return static_cast<int>(cudaGetLastError());
}

// Both launches on `stream`; G groups (G > E only when int8 replicas are
// given; CLASSES names the classes this library serves). vec16 picks the
// 16-byte-copy instance; the shared-memory bytes come from launch_plan and
// must match this layout. Returns a cudaError_t.
template <typename T, int CLASSES>
int launch(const T* x, const T* w1, const T* w3, const T* w2, const int8_t* w1q, const float* s1,
           const int8_t* w3q, const float* s3, const int8_t* w2q, const float* s2,
           const int* counts, float* h, T* out, int E, int G, int C, int D, int F, int vec16,
           int smem_gate_up, int smem_down, cudaStream_t stream) {
  if (vec16)
    return launch_pair<T, CLASSES, true>(x, w1, w3, w2, w1q, s1, w3q, s3, w2q, s2, counts, h,
                                         out, E, G, C, D, F, smem_gate_up, smem_down, stream);
  return launch_pair<T, CLASSES, false>(x, w1, w3, w2, w1q, s1, w3q, s3, w2q, s2, counts, h, out,
                                        E, G, C, D, F, smem_gate_up, smem_down, stream);
}

}  // namespace ffn
