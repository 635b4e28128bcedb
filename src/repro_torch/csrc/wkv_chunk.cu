// Chunkwise-parallel RWKV6 WKV for sm_90a: per (batch x head) lane and
// chunk n, with the state carried across the chunks of the lane,
//
//   o_n = r~_n S + [lower(r~_n k~_n^T) + diag(dg_n)] v_n
//   S  <- exp(laE_n) (.)_rows S + k_end_n^T v_n
//
// Replaces the TPU kernel wkv_chunk_pallas (src/repro/kernels/wkv_chunk.py),
// with its interface: rt, kt, v, ke [BH, N, C, D], lae [BH, N, D],
// dg [BH, N, C], s0 [BH, D, D], all f32, contiguous; returns o [BH, N, C, D]
// and s_final [BH, D, D]. C is 16 or 32, D is 32, 64 or 128.
//
// Bound on the H100: bytes. Each input is read once and each output written
// once (~89 MB at BH = 128, N = 16, C = 32, D = 64, about 27 us at
// 3.35 TB/s), against ~1.6 GFLOP of f32 work (about 24 us at 67 TFLOP/s).
//
// Design. The TPU kernel walks the chunk axis as a sequential grid axis and
// keeps S in its output block. Hopper blocks run in no order, so the chunk
// loop runs inside one block. Column e of o and of S depends only on column
// e of v, so the value axis splits across blocks with no reduction between
// them: grid = (BH, D / 32), one warp lane per value column, 8 warps. The
// block's 32 state columns [D, 32] stay in shared memory for the whole
// loop. Per chunk it forms the [C, C] score matrix with diag(dg) folded in,
// then the output, then the state update, with a block barrier after each.
// Plain f32 FMA, no tensor cores: TF32 would break the f32 agreement with
// the plain version that the rest of the port keeps. The scores are
// recomputed by each of the D / 32 value blocks of a lane.
//
// The chunk's tiles (r~, k_end, k~, the block's v columns, laE, dg; ~28 KB
// at C = 32, D = 64) are loaded through a ring of STAGES shared-memory
// stages filled with 16-byte cp.async copies. With two stages, iteration n
// first issues chunk n + 1 into the other stage, then waits for chunk n
// only, so chunk n + 1's load runs under chunk n's three FMA phases. k~ is
// staged row-major at a padded stride of D + 4 floats (a copy cannot
// transpose): in the score phase lane s reads k~[s][d .. d + 3] as one
// float4, conflict-free per quarter-warp for D = 32, 64 and 128. laE is
// staged raw and exponentiated where the state update reads it. Each FMA
// chain runs in the order it had when the tiles were loaded by plain
// stores, so the outputs do not depend on the stage depth, bit for bit.
// Depth per instance (stages<D>): two for D <= 64 (71 KB at C = 32, D =
// 64, still two blocks per SM); one for D = 128, where two stages (129 KB)
// would leave one block per SM and split the grid into two waves.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ffn_gemm.cuh"  // cp.async helpers: ffn::cp16, commit, wait_pending

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ET = 32;  // value columns per block: one per lane
// Blocks per SM the registers must allow (at most 128 a thread). Without
// it ptxas held every instance to 80 registers and spilled at C = 32,
// D = 128. The train and d128 grids (256 blocks for 132 SMs) never place
// more than 2 blocks on an SM.
constexpr int MIN_BLOCKS = 2;

// Ring depth of the (C, D) instance (see the design note).
template <int D>
__host__ __device__ constexpr int stages() {
  return D <= 64 ? 2 : 1;
}

// One stage of the ring: the tiles of one chunk.
template <int C, int D>
struct Stage {
  static constexpr int KS = D + 4;  // padded row stride of k~
  // r~, k_end [C][D]; k~ [C][KS]; v [C][ET]; laE [D]; dg [C]
  static constexpr int FLOATS = 2 * C * D + C * KS + C * ET + D + C;
  float *r, *ke, *k, *v, *lae, *dg;
  __device__ explicit Stage(float* p)
      : r(p), ke(r + C * D), k(ke + C * D), v(k + C * KS), lae(v + C * ET),
        dg(lae + D) {}
};

template <int C, int D, int STAGES>
constexpr size_t smem_floats() {
  // the stages; scores [C][C]; state [D][ET]
  return STAGES * Stage<C, D>::FLOATS + C * C + D * ET;
}

// Issue chunk `chunk` (= bh * N + n) of the lane into stage `st`: 16-byte
// copies, every offset a multiple of 4 floats.
template <int C, int D>
__device__ __forceinline__ void issue(const Stage<C, D>& st,
                                      const float* __restrict__ rt,
                                      const float* __restrict__ kt,
                                      const float* __restrict__ v,
                                      const float* __restrict__ ke,
                                      const float* __restrict__ lae,
                                      const float* __restrict__ dg,
                                      size_t chunk, int e0, int tid) {
  const size_t base = chunk * C * D;
  for (int i = tid; i < C * D / 4; i += THREADS) {
    const int c = 4 * i / D, d = 4 * i % D;
    ffn::cp16(st.r + 4 * i, rt + base + 4 * i, 16);
    ffn::cp16(st.ke + 4 * i, ke + base + 4 * i, 16);
    ffn::cp16(st.k + c * Stage<C, D>::KS + d, kt + base + 4 * i, 16);
  }
  for (int i = tid; i < C * ET / 4; i += THREADS) {
    const int c = 4 * i / ET, e = 4 * i % ET;
    ffn::cp16(st.v + 4 * i, v + base + c * D + e0 + e, 16);
  }
  if (tid < D / 4) ffn::cp16(st.lae + 4 * tid, lae + chunk * D + 4 * tid, 16);
  if (tid < C / 4) ffn::cp16(st.dg + 4 * tid, dg + chunk * C + 4 * tid, 16);
}

template <int C, int D, int STAGES>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
wkv_chunk_kernel(const float* __restrict__ rt, const float* __restrict__ kt,
                 const float* __restrict__ v, const float* __restrict__ ke,
                 const float* __restrict__ lae, const float* __restrict__ dg,
                 const float* __restrict__ s0, float* __restrict__ out,
                 float* __restrict__ s_fin, int N) {
  static_assert(C * C % THREADS == 0 || THREADS % (C * C) == 0, "C");
  static_assert(D % WARPS == 0 && D % ET == 0 && (D / WARPS) % 4 == 0, "D");
  static_assert(STAGES == 1 || STAGES == 2, "STAGES");
  constexpr int KS = Stage<C, D>::KS;
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  float* a_s = ring + STAGES * Stage<C, D>::FLOATS;
  float* st_s = a_s + C * C;

  const int bh = blockIdx.x;
  const int e0 = blockIdx.y * ET;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const float* s0_l = s0 + (size_t)bh * D * D;
  for (int i = tid; i < D * ET; i += THREADS)
    st_s[i] = s0_l[(i / ET) * D + e0 + i % ET];

  issue(Stage<C, D>(ring), rt, kt, v, ke, lae, dg, (size_t)bh * N, e0, tid);
  ffn::commit();
  for (int n = 0; n < N; ++n) {
    const size_t base = ((size_t)bh * N + n) * C * D;
    const Stage<C, D> cur(ring + (n % STAGES) * Stage<C, D>::FLOATS);
    // Chunk n + 1 goes into the stage chunk n - 1 used: the barrier that
    // ended chunk n - 1 is what lets it be refilled here. With one stage,
    // chunk n goes into the only stage after that barrier.
    if (STAGES == 2 && n + 1 < N) {
      const Stage<C, D> next(ring + ((n + 1) % STAGES) * Stage<C, D>::FLOATS);
      issue(next, rt, kt, v, ke, lae, dg, (size_t)bh * N + n + 1, e0, tid);
      ffn::commit();
      ffn::wait_pending<1>();  // chunk n has landed; n + 1 stays in flight
    } else {
      if (STAGES == 1 && n > 0) {
        issue(cur, rt, kt, v, ke, lae, dg, (size_t)bh * N + n, e0, tid);
        ffn::commit();
      }
      ffn::wait_pending<0>();
    }
    __syncthreads();

    // scores: a[c][s] = r~_c . k~_s for s < c, dg_c on the diagonal, else 0
    {
      constexpr int SJ = C * C >= THREADS ? C * C / THREADS : 1;
      constexpr int SROW = THREADS / C;
      const int s = tid % C, c0 = tid / C;
      if (c0 < C) {
        float acc[SJ];
#pragma unroll
        for (int j = 0; j < SJ; ++j) acc[j] = 0.f;
#pragma unroll 4
        for (int d = 0; d < D; d += 4) {
          const float4 k = *reinterpret_cast<const float4*>(cur.k + s * KS + d);
#pragma unroll
          for (int j = 0; j < SJ; ++j) {
            const float4 r = reinterpret_cast<const float4*>(
                cur.r + (c0 + SROW * j) * D)[d / 4];
            acc[j] = fmaf(r.x, k.x, acc[j]);
            acc[j] = fmaf(r.y, k.y, acc[j]);
            acc[j] = fmaf(r.z, k.z, acc[j]);
            acc[j] = fmaf(r.w, k.w, acc[j]);
          }
        }
#pragma unroll
        for (int j = 0; j < SJ; ++j) {
          const int c = c0 + SROW * j;
          a_s[c * C + s] = s < c ? acc[j] : (s == c ? cur.dg[c] : 0.f);
        }
      }
    }
    __syncthreads();

    // output: o[c][e] = r~_c . S[:, e] + a[c, :] . v[:, e]
    {
      constexpr int OJ = C / WARPS;
      float acc[OJ];
#pragma unroll
      for (int j = 0; j < OJ; ++j) acc[j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; d += 4) {
        const float s0v = st_s[(d + 0) * ET + lane];
        const float s1v = st_s[(d + 1) * ET + lane];
        const float s2v = st_s[(d + 2) * ET + lane];
        const float s3v = st_s[(d + 3) * ET + lane];
#pragma unroll
        for (int j = 0; j < OJ; ++j) {
          const float4 r = reinterpret_cast<const float4*>(
              cur.r + (warp + WARPS * j) * D)[d / 4];
          acc[j] = fmaf(r.x, s0v, acc[j]);
          acc[j] = fmaf(r.y, s1v, acc[j]);
          acc[j] = fmaf(r.z, s2v, acc[j]);
          acc[j] = fmaf(r.w, s3v, acc[j]);
        }
      }
#pragma unroll
      for (int s = 0; s < C; s += 4) {
        const float v0 = cur.v[(s + 0) * ET + lane];
        const float v1 = cur.v[(s + 1) * ET + lane];
        const float v2 = cur.v[(s + 2) * ET + lane];
        const float v3 = cur.v[(s + 3) * ET + lane];
#pragma unroll
        for (int j = 0; j < OJ; ++j) {
          const float4 a = reinterpret_cast<const float4*>(
              a_s + (warp + WARPS * j) * C)[s / 4];
          acc[j] = fmaf(a.x, v0, acc[j]);
          acc[j] = fmaf(a.y, v1, acc[j]);
          acc[j] = fmaf(a.z, v2, acc[j]);
          acc[j] = fmaf(a.w, v3, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < OJ; ++j)
        out[base + (warp + WARPS * j) * D + e0 + lane] = acc[j];
    }
    __syncthreads();  // every read of S for this chunk is done

    // state: S[d][e] = exp(laE_d) S[d][e] + k_end[:, d] . v[:, e]; this
    // thread owns rows warp * SD .. + SD of column `lane`
    {
      constexpr int SD = D / WARPS;
      const int d0 = warp * SD;
      // lane j < SD takes exp(laE) of row d0 + j, once for the warp
      const float dec = expf(cur.lae[d0 + lane % SD]);
      float acc[SD];
#pragma unroll
      for (int j = 0; j < SD; ++j)
        acc[j] = __shfl_sync(0xffffffffu, dec, j) * st_s[(d0 + j) * ET + lane];
#pragma unroll 4
      for (int s = 0; s < C; ++s) {
        const float vv = cur.v[s * ET + lane];
#pragma unroll
        for (int j = 0; j < SD; j += 4) {
          const float4 k = reinterpret_cast<const float4*>(
              cur.ke + s * D + d0)[j / 4];
          acc[j + 0] = fmaf(k.x, vv, acc[j + 0]);
          acc[j + 1] = fmaf(k.y, vv, acc[j + 1]);
          acc[j + 2] = fmaf(k.z, vv, acc[j + 2]);
          acc[j + 3] = fmaf(k.w, vv, acc[j + 3]);
        }
      }
#pragma unroll
      for (int j = 0; j < SD; ++j) st_s[(d0 + j) * ET + lane] = acc[j];
    }
    __syncthreads();  // chunk n's stage is read: the next iteration refills it
  }

  float* sf_l = s_fin + (size_t)bh * D * D;
  for (int i = tid; i < D * ET; i += THREADS)
    sf_l[(i / ET) * D + e0 + i % ET] = st_s[i];
}

template <int C, int D>
cudaError_t launch(const float* rt, const float* kt, const float* v,
                   const float* ke, const float* lae, const float* dg,
                   const float* s0, float* out, float* s_fin, int BH, int N,
                   cudaStream_t stream) {
  constexpr int S = stages<D>();
  const size_t bytes = smem_floats<C, D, S>() * sizeof(float);
  // above 48 KB a block gets dynamic shared memory only when asked for
  cudaError_t err = cudaFuncSetAttribute(
      wkv_chunk_kernel<C, D, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, D / ET);
  wkv_chunk_kernel<C, D, S><<<grid, THREADS, bytes, stream>>>(
      rt, kt, v, ke, lae, dg, s0, out, s_fin, N);
  return cudaGetLastError();
}

}  // namespace

extern "C" int wkv_chunk_launch(const float* rt, const float* kt,
                                const float* v, const float* ke,
                                const float* lae, const float* dg,
                                const float* s0, float* out, float* s_fin,
                                int BH, int N, int C, int D, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define WKV_CASE(CC, DD)                                                   \
  if (C == CC && D == DD)                                                  \
    return (int)launch<CC, DD>(rt, kt, v, ke, lae, dg, s0, out, s_fin, BH, \
                               N, st);
  WKV_CASE(16, 32)
  WKV_CASE(16, 64)
  WKV_CASE(16, 128)
  WKV_CASE(32, 32)
  WKV_CASE(32, 64)
  WKV_CASE(32, 128)
#undef WKV_CASE
  return (int)cudaErrorInvalidValue;
}

// The ring depth of the (C, D) instance, 0 for a shape it does not take.
extern "C" int wkv_chunk_stages(int C, int D) {
  if ((C != 16 && C != 32) || (D != 32 && D != 64 && D != 128)) return 0;
  return D == 32 ? stages<32>() : D == 64 ? stages<64>() : stages<128>();
}
