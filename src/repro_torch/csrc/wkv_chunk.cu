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
// loop; per chunk it stages r~, k_end and k~ (transposed, padded against
// bank conflicts), its v columns, exp(laE) and dg, forms the [C, C] score
// matrix with diag(dg) folded in, then the output, then the state update.
// Plain f32 FMA, no tensor cores: TF32 would break the f32 agreement with
// the plain version that the rest of the port keeps. The scores are
// recomputed by each of the D / 32 value blocks of a lane.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ET = 32;  // value columns per block: one per lane

template <int C, int D>
constexpr size_t smem_floats() {
  // r~, k_end [C][D]; k~^T [D][C+1]; v [C][ET]; scores [C][C];
  // state [D][ET]; exp(laE) [D]; dg [C]
  return 2 * C * D + D * (C + 1) + C * ET + C * C + D * ET + D + C;
}

template <int C, int D>
__global__ void __launch_bounds__(THREADS)
wkv_chunk_kernel(const float* __restrict__ rt, const float* __restrict__ kt,
                 const float* __restrict__ v, const float* __restrict__ ke,
                 const float* __restrict__ lae, const float* __restrict__ dg,
                 const float* __restrict__ s0, float* __restrict__ out,
                 float* __restrict__ s_fin, int N) {
  static_assert(C * C % THREADS == 0 || THREADS % (C * C) == 0, "C");
  static_assert(D % WARPS == 0 && D % ET == 0 && (D / WARPS) % 4 == 0, "D");
  extern __shared__ float4 smem4[];
  float* r_s = reinterpret_cast<float*>(smem4);
  float* ke_s = r_s + C * D;
  float* kT_s = ke_s + C * D;
  float* v_s = kT_s + D * (C + 1);
  float* a_s = v_s + C * ET;
  float* st_s = a_s + C * C;
  float* dec_s = st_s + D * ET;
  float* dg_s = dec_s + D;

  const int bh = blockIdx.x;
  const int e0 = blockIdx.y * ET;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const float* s0_l = s0 + (size_t)bh * D * D;
  for (int i = tid; i < D * ET; i += THREADS)
    st_s[i] = s0_l[(i / ET) * D + e0 + i % ET];

  for (int n = 0; n < N; ++n) {
    const size_t base = ((size_t)bh * N + n) * C * D;
    const float4* r4 = reinterpret_cast<const float4*>(rt + base);
    const float4* k4 = reinterpret_cast<const float4*>(kt + base);
    const float4* ke4 = reinterpret_cast<const float4*>(ke + base);
    for (int i = tid; i < C * D / 4; i += THREADS) {
      reinterpret_cast<float4*>(r_s)[i] = r4[i];
      reinterpret_cast<float4*>(ke_s)[i] = ke4[i];
      const float4 kk = k4[i];
      const int c = 4 * i / D, d = 4 * i % D;
      kT_s[(d + 0) * (C + 1) + c] = kk.x;
      kT_s[(d + 1) * (C + 1) + c] = kk.y;
      kT_s[(d + 2) * (C + 1) + c] = kk.z;
      kT_s[(d + 3) * (C + 1) + c] = kk.w;
    }
    for (int i = tid; i < C * ET / 4; i += THREADS) {
      const int c = 4 * i / ET, e = 4 * i % ET;
      reinterpret_cast<float4*>(v_s)[i] =
          *reinterpret_cast<const float4*>(v + base + c * D + e0 + e);
    }
    if (tid < D) dec_s[tid] = expf(lae[((size_t)bh * N + n) * D + tid]);
    if (tid < C) dg_s[tid] = dg[((size_t)bh * N + n) * C + tid];
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
          const float k0 = kT_s[(d + 0) * (C + 1) + s];
          const float k1 = kT_s[(d + 1) * (C + 1) + s];
          const float k2 = kT_s[(d + 2) * (C + 1) + s];
          const float k3 = kT_s[(d + 3) * (C + 1) + s];
#pragma unroll
          for (int j = 0; j < SJ; ++j) {
            const float4 r = reinterpret_cast<const float4*>(
                r_s + (c0 + SROW * j) * D)[d / 4];
            acc[j] = fmaf(r.x, k0, acc[j]);
            acc[j] = fmaf(r.y, k1, acc[j]);
            acc[j] = fmaf(r.z, k2, acc[j]);
            acc[j] = fmaf(r.w, k3, acc[j]);
          }
        }
#pragma unroll
        for (int j = 0; j < SJ; ++j) {
          const int c = c0 + SROW * j;
          a_s[c * C + s] = s < c ? acc[j] : (s == c ? dg_s[c] : 0.f);
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
              r_s + (warp + WARPS * j) * D)[d / 4];
          acc[j] = fmaf(r.x, s0v, acc[j]);
          acc[j] = fmaf(r.y, s1v, acc[j]);
          acc[j] = fmaf(r.z, s2v, acc[j]);
          acc[j] = fmaf(r.w, s3v, acc[j]);
        }
      }
#pragma unroll
      for (int s = 0; s < C; s += 4) {
        const float v0 = v_s[(s + 0) * ET + lane];
        const float v1 = v_s[(s + 1) * ET + lane];
        const float v2 = v_s[(s + 2) * ET + lane];
        const float v3 = v_s[(s + 3) * ET + lane];
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
      float acc[SD];
#pragma unroll
      for (int j = 0; j < SD; ++j)
        acc[j] = dec_s[d0 + j] * st_s[(d0 + j) * ET + lane];
#pragma unroll 4
      for (int s = 0; s < C; ++s) {
        const float vv = v_s[s * ET + lane];
#pragma unroll
        for (int j = 0; j < SD; j += 4) {
          const float4 k = reinterpret_cast<const float4*>(
              ke_s + s * D + d0)[j / 4];
          acc[j + 0] = fmaf(k.x, vv, acc[j + 0]);
          acc[j + 1] = fmaf(k.y, vv, acc[j + 1]);
          acc[j + 2] = fmaf(k.z, vv, acc[j + 2]);
          acc[j + 3] = fmaf(k.w, vv, acc[j + 3]);
        }
      }
#pragma unroll
      for (int j = 0; j < SD; ++j) st_s[(d0 + j) * ET + lane] = acc[j];
    }
    __syncthreads();  // the next chunk overwrites the staged tiles
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
  const size_t bytes = smem_floats<C, D>() * sizeof(float);
  // above 48 KB a block gets dynamic shared memory only when asked for
  cudaError_t err = cudaFuncSetAttribute(
      wkv_chunk_kernel<C, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, D / ET);
  wkv_chunk_kernel<C, D><<<grid, THREADS, bytes, stream>>>(
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
