// Routing of one MoE layer for sm_90a: the router gate, the batch
// distribution gate, Algorithm 1 and the degraded / peer splits of the
// misses, in one launch for T <= 256 tokens (two above).
//
// Replaces, on the model's path, the TPU kernels topk_gate_pallas
// (src/repro/kernels/topk_gate.py) and buddy_substitute_pallas
// (src/repro/kernels/buddy_substitute.py) together with the reference
// functions between and after them: distribution_gate (repro/core/gates.py)
// and the precedence mode's split of a miss into degraded, peer or fetch
// (repro/core/substitute.py). Psi = q, temperature 1, no margin co-gate.
//
// Bound on the H100: about 2 KB in and out per call at T = 4 (logits,
// tables, a dozen [T, K] outputs), well under a microsecond of HBM time,
// so the launch latency and the host's issue path bound it, not bytes or
// operations. Before, each MoE layer issued two launches and about twenty
// eager torch ops between them (the distribution gate's reduction, the
// splits, zero-filled masks). The design makes it one launch of one block
// of 1,024 threads that keeps the batch's state in shared memory:
//   1. warp w takes rows w, w + 32, ...: the warp-shuffle top-k of
//      route.cuh, writing the row's outputs and ORing its experts into the
//      warp's requested bit words (8 words for E <= 256); the warps without
//      a row stage the buddy table, q and the three expert masks in shared
//      memory meanwhile;
//   2. one warp ORs the warps' words, counts the requested and the
//      requested non-resident experts and sets
//      dist_ok = f32(n_cpu) / f32(max(n_req, 1)) < beta;
//   3. thread t < T runs Algorithm 1 for token t and splits its misses.
// Two barriers separate the steps. The wrapper makes two allocations and
// one ctypes call per layer; every output is a view of those two buffers,
// laid out as outputs() below computes (kernels/route.py launch_plan
// mirrors it).
// For T > 256 the router gate runs as its own grid (gate_kernel) and
// substitute_kernel rebuilds the requested set per block from the whole
// routing: two launches, no global scratch. The one block runs every row
// on one SM, so its device time grows with T: the serve path's T = 4 and
// 32 stay under the host's issue time, while at T = 256 the block takes
// longer than the two grid kernels would (PERF.md).
#include "route.cuh"

namespace {

using namespace route;

constexpr int SINGLE_BLOCK_T = 256;
constexpr int THREADS = 1024;

int pad16(int n) { return (n + 15) / 16 * 16; }

// Offsets of the outputs in the two buffers; every segment starts on 16
// bytes. Words (4 bytes): idx, new_idx, topk logits, probs ([T, K] each),
// tae [T]. Flags (1 byte): substituted, missed, degraded, peered, dropped
// ([T, K] each), allow [T], dist_ok [].
struct Outs {
  GateOut gate;
  SubOut sub;
  uint8_t* dist_ok;
};

Outs outputs(int32_t* words, uint8_t* flags, int T, int K) {
  const int ws = pad16(4 * T * K) / 4;  // words of one [T, K] output
  const int fs = pad16(T * K);          // bytes of one [T, K] mask
  float* wf = reinterpret_cast<float*>(words);
  Outs o;
  o.gate = GateOut{words, wf + 2 * ws, wf + 3 * ws, wf + 4 * ws, flags + 5 * fs};
  o.sub = SubOut{words + ws, flags, flags + fs, flags + 2 * fs, flags + 3 * fs, flags + 4 * fs};
  o.dist_ok = flags + 5 * fs + pad16(T);
  return o;
}

struct BlockArgs {
  const float* logits;
  int T, E, K, R, H, rho, substitute;
  float tau, beta, log_k;
  Tables g;
  Outs o;
};

__global__ void __launch_bounds__(THREADS, 1) route_block_kernel(BlockArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned req_s[THREADS / 32][PER_LANE];  // each warp's requested experts
  __shared__ bool dist_ok_s;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  const int row_warps = min(a.T, n_warps);
  // the warps without a row stage the tables while the others take their
  // rows; when every warp has a row, all threads stage first
  const bool spare = row_warps < n_warps;
  uint8_t* unused;
  const Tables st = stage_tables(smem, a.g, a.E, a.R, spare ? row_warps * 32 : 0,
                                 spare ? (n_warps - row_warps) * 32 : blockDim.x, &unused);
  unsigned req_word = 0;
  for (int row = warp; row < a.T; row += n_warps)
    gate_row(a.logits, row, a.E, a.K, a.tau, a.log_k, a.o.gate, req_word);
  if (lane < PER_LANE) req_s[warp][lane] = req_word;
  __syncthreads();
  if (warp == 0) {
    unsigned word = 0;
    if (lane < PER_LANE)
      for (int w = 0; w < n_warps; ++w) word |= req_s[w][lane];
    const bool ok = distribution_gate_warp(word, flag_word(st.resident, a.E), a.beta);
    if (lane == 0) {
      dist_ok_s = ok;
      *a.o.dist_ok = ok ? 1 : 0;
    }
  }
  __syncthreads();
  const int t = threadIdx.x;
  if (t >= a.T) return;
  // the rows' outputs were written by other warps of this block before the
  // barriers above, so plain global loads see them
  substitute_token(t, a.o.gate.allow[t] != 0 && dist_ok_s, a.substitute != 0, a.o.gate.idx, st,
                   a.K, a.R, a.H, a.rho, a.o.sub);
}

}  // namespace

extern "C" int route_launch(const float* logits, const uint8_t* resident, const int* table,
                            const float* q, const uint8_t* quant_ok, const uint8_t* peer_ok,
                            int T, int E, int K, int R, int H, int rho, int substitute, float tau,
                            float beta, float log_k, int32_t* words, uint8_t* flags,
                            cudaStream_t stream) {
  const int smem = tables_smem_bytes(E, R);
  if (E > MAX_E || K > MAX_K || K > E || K < 1 || H > R || H < 1 || smem > SMEM_LIMIT)
    return static_cast<int>(cudaErrorInvalidValue);
  if (T == 0) return static_cast<int>(cudaSuccess);
  const Tables g{table, q, resident, quant_ok, peer_ok};
  const Outs o = outputs(words, flags, T, K);
  if (T <= SINGLE_BLOCK_T) {
    route_block_kernel<<<1, THREADS, smem, stream>>>(
        BlockArgs{logits, T, E, K, R, H, rho, substitute, tau, beta, log_k, g, o});
    return static_cast<int>(cudaGetLastError());
  }
  gate_kernel<<<(T + GATE_ROWS - 1) / GATE_ROWS, GATE_ROWS * 32, 0, stream>>>(logits, T, E, K,
                                                                             tau, log_k, o.gate);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  substitute_kernel<<<(T + SUB_THREADS - 1) / SUB_THREADS, SUB_THREADS, smem, stream>>>(
      SubArgs{o.gate.idx, o.gate.allow, T, K, E, R, H, rho, substitute, 1, beta, g, o.sub,
              o.dist_ok});
  return static_cast<int>(cudaGetLastError());
}
