// Routing of one MoE layer for sm_90a: the router gate with the token gate,
// the batch distribution gate, Algorithm 1 in precedence or cost mode and
// the miss outcomes, in one launch for T <= 256 tokens (two above).
//
// Replaces, on the model's path, the TPU kernels topk_gate_pallas
// (src/repro/kernels/topk_gate.py) and buddy_substitute_pallas
// (src/repro/kernels/buddy_substitute.py) together with the reference
// functions between and after them: token_gate and distribution_gate
// (repro/core/gates.py) and substitute (repro/core/substitute.py) with its
// whole contract: precedence mode with the degraded / peer / fetch split of
// a miss, cost mode's per-slot argmin over buddy / degraded / peer / fetch /
// drop, Psi with the eta (router z-score) and kappa (hop) terms, the TAE
// temperature and the margin co-gate. The reference runs everything past
// the top-k in jnp; buddy_substitute_pallas covers precedence mode with
// Psi = q only.
//
// Bound on the H100: about 2 KB in and out per call at T = 4 (logits,
// tables, a dozen [T, K] outputs), well under a microsecond of HBM time,
// so the launch latency and the host's issue path bound it, not bytes or
// operations. The plain version's slot loop issues about 25 eager ops per
// slot in cost mode or with eta / kappa; here every policy is one launch
// of one block of 1,024 threads that keeps the batch's state in shared
// memory:
//   1. warp w takes rows w, w + 32, ...: the warp-shuffle top-k of
//      route.cuh, the token gate, and with eta the row's mean and std into
//      shared memory; it ORs the row's experts into the warp's requested
//      bit words (8 words for E <= 256). The warps without a row stage the
//      buddy table, q, hop, the cost vectors and the three expert masks in
//      shared memory meanwhile;
//   2. one warp ORs the warps' words, counts the requested and the
//      requested non-resident experts and sets
//      dist_ok = f32(n_cpu) / f32(max(n_req, 1)) < beta;
//   3. thread t < T runs Algorithm 1 for token t and resolves its misses.
// Two barriers separate the steps. The wrapper makes two allocations and
// one ctypes call per layer; every output is a view of those two buffers,
// laid out as outputs() below computes (kernels/route.py launch_plan
// mirrors it).
// For T > 256 the router gate runs as its own grid (gate_kernel, the rows'
// mean and std into a scratch segment of the word buffer) and
// substitute_kernel rebuilds the requested set per block from the whole
// routing: two launches. The one block runs every row on one SM, so its
// device time grows with T: the serve path's T = 4 and 32 stay under the
// host's issue time, while at T = 256 the block takes longer than the two
// grid kernels would (PERF.md).
#include "route.cuh"

namespace {

using namespace route;

constexpr int SINGLE_BLOCK_T = 256;
constexpr int THREADS = 1024;

int pad16(int n) { return (n + 15) / 16 * 16; }

// Offsets of the outputs in the two buffers; every segment starts on 16
// bytes. Words (4 bytes): idx, new_idx, topk logits, probs ([T, K] each),
// tae [T], and for T > 256 the rows' mean and std [T, 2] (scratch).
// Flags (1 byte): substituted, missed, degraded, peered, dropped ([T, K]
// each), allow [T], dist_ok [].
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
  float* stats = wf + 4 * ws + pad16(4 * T) / 4;
  o.gate = GateOut{words, wf + 2 * ws, wf + 3 * ws, wf + 4 * ws, flags + 5 * fs, stats};
  o.sub = SubOut{words + ws, flags, flags + fs, flags + 2 * fs, flags + 3 * fs, flags + 4 * fs};
  o.dist_ok = flags + 5 * fs + pad16(T);
  return o;
}

struct BlockArgs {
  const float* logits;
  int T;
  float beta;
  TokenGate tg;
  SubParams p;
  Tables g;
  Outs o;
};

__global__ void __launch_bounds__(THREADS, 1) route_block_kernel(BlockArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned req_s[THREADS / 32][PER_LANE];  // each warp's requested experts
  __shared__ float stats_s[2 * SINGLE_BLOCK_T];       // rows' mean and std (eta)
  __shared__ bool dist_ok_s;
  const int E = a.p.E;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  const int row_warps = min(a.T, n_warps);
  // the warps without a row stage the tables while the others take their
  // rows; when every warp has a row, all threads stage first
  const bool spare = row_warps < n_warps;
  uint8_t* unused;
  const Tables st = stage_tables(smem, a.g, E, a.p.R, spare ? row_warps * 32 : 0,
                                 spare ? (n_warps - row_warps) * 32 : blockDim.x, &unused);
  GateOut go = a.o.gate;
  go.stats = a.p.stats ? stats_s : nullptr;
  unsigned req_word = 0;
  for (int row = warp; row < a.T; row += n_warps)
    gate_row(a.logits, row, E, a.p.K, a.tg, go, req_word);
  if (lane < PER_LANE) req_s[warp][lane] = req_word;
  __syncthreads();
  if (warp == 0) {
    unsigned word = 0;
    if (lane < PER_LANE)
      for (int w = 0; w < n_warps; ++w) word |= req_s[w][lane];
    const bool ok = distribution_gate_warp(word, flag_word(st.resident, E), a.beta);
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
  SubParams p = a.p;
  p.stats = go.stats;
  substitute_token(t, a.o.gate.allow[t] != 0 && dist_ok_s, a.o.gate.idx, st, p, a.o.sub);
}

}  // namespace

extern "C" int route_launch(const float* logits, const uint8_t* resident, const int* table,
                            const float* q, const uint8_t* quant_ok, const uint8_t* peer_ok,
                            const int* hop, const float* fid_cost, const float* fetch_cost,
                            const float* peer_cost, int T, int E, int K, int R, int H, int rho,
                            int substitute, int cost, float tau, float beta, float log_k,
                            float temperature, float margin, float eta, float kappa, float xr,
                            float r_cost, int32_t* words, uint8_t* flags, cudaStream_t stream) {
  const int smem = tables_smem_bytes(E, R);
  if (E > MAX_E || K > MAX_K || K > E || K < 1 || H > R || H < 1 || smem > SMEM_LIMIT ||
      (cost && !fetch_cost))
    return static_cast<int>(cudaErrorInvalidValue);
  if (T == 0) return static_cast<int>(cudaSuccess);
  // stage only what this policy reads: hop with kappa, the costs in cost
  // mode, the precedence masks otherwise
  const Tables g{table,
                 q,
                 kappa != 0.f ? hop : nullptr,
                 cost ? fid_cost : nullptr,
                 cost ? fetch_cost : nullptr,
                 cost ? peer_cost : nullptr,
                 resident,
                 cost ? nullptr : quant_ok,
                 cost ? nullptr : peer_ok};
  const Outs o = outputs(words, flags, T, K);
  const TokenGate tg{tau, log_k, temperature, margin};
  // the grid form's stats go to the scratch segment; the block's to shared
  // memory (route_block_kernel swaps the pointer)
  const SubParams p{K, R, H, rho, substitute, cost, eta, kappa, xr, r_cost, E, logits,
                    eta != 0.f ? o.gate.stats : nullptr};
  if (T <= SINGLE_BLOCK_T) {
    route_block_kernel<<<1, THREADS, smem, stream>>>(BlockArgs{logits, T, beta, tg, p, g, o});
    return static_cast<int>(cudaGetLastError());
  }
  GateOut go = o.gate;
  if (!p.stats) go.stats = nullptr;
  gate_kernel<<<(T + GATE_ROWS - 1) / GATE_ROWS, GATE_ROWS * 32, 0, stream>>>(logits, T, E, K, tg,
                                                                             go);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  substitute_kernel<<<(T + SUB_THREADS - 1) / SUB_THREADS, SUB_THREADS, smem, stream>>>(
      SubArgs{o.gate.idx, o.gate.allow, T, 1, beta, p, g, o.sub, o.dist_ok});
  return static_cast<int>(cudaGetLastError());
}
