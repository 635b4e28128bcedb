// Routing of one MoE layer for sm_90a: the router gate with the token gate,
// the batch distribution gate, Algorithm 1 in precedence or cost mode and
// the miss outcomes, in one launch for T <= CLUSTER_T tokens (two above).
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
// slot in cost mode or with eta / kappa; here every policy is one launch.
// What grows with T is the router gate's issue time on one SM (a block of
// 1,024 threads that gated every row took 4x longer at T = 256 than at
// T = 32, PERF.md). Up to CLUSTER_T tokens the launch is one thread-block
// cluster of n = ceil(T / ROWS_PER_CTA) <= 8 CTAs on neighbouring SMs, so
// no SM gates more than ROWS_PER_CTA rows; CTA c owns rows and tokens
// [c ROWS_PER_CTA, (c + 1) ROWS_PER_CTA) and keeps its state in its own
// shared memory:
//   1. warp w takes the CTA's rows w, w + n_warps, ...: the warp-shuffle
//      top-k of route.cuh, the token gate, and with eta the row's mean and
//      std into the CTA's shared memory; it ORs the row's experts into the
//      warp's requested bit words (8 words for E <= 256). The warps without
//      a row stage the buddy table, q, hop, the cost vectors and the three
//      expert masks in shared memory meanwhile;
//   2. warp 0 ORs the warps' words into the CTA's words; a cluster barrier;
//      then warp 0 of every CTA reads all n CTAs' words through distributed
//      shared memory and sets dist_ok = f32(n_cpu) / f32(max(n_req, 1)) <
//      beta itself (integer popcounts and one IEEE divide: every CTA gets
//      the same bit), CTA 0 writing it out;
//   3. thread t of CTA c runs Algorithm 1 for token c ROWS_PER_CTA + t and
//      resolves its misses. Its routing was written by its own CTA before a
//      block barrier, so plain global loads see it.
// No CTA exits before every CTA has done its remote reads (a split cluster
// barrier: arrive after the reads, wait before exit). A cluster of one CTA
// (T <= ROWS_PER_CTA) is launched without the cluster attribute: the
// kernel runs as its own cluster of one. The wrapper makes two allocations
// and one ctypes call per layer; every output is a view of those two
// buffers, laid out as outputs() below computes (kernels/route.py
// launch_plan mirrors it).
// For T > CLUSTER_T the router gate runs as its own grid (gate_kernel, the
// rows' mean and std into a scratch segment of the word buffer) and
// substitute_kernel rebuilds the requested set per block from the whole
// routing: two launches. The geometry is measured (PERF.md, tools/
// time_route.py): 4 rows to a CTA of 256 threads was the fastest cluster up
// to 32 tokens, and from 64 tokens on the grid's two kernels (8 rows to a
// gate block, over T / 8 SMs) took less device time than any cluster of at
// most 8 CTAs.
#include <cooperative_groups.h>

#include "route.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace route;

constexpr int ROWS_PER_CTA = 4;  // rows and tokens of one CTA of the cluster
constexpr int CTA_THREADS = 256;
constexpr int MAX_CLUSTER = 8;   // the portable cluster size
constexpr int CLUSTER_T = 32;    // up to this many tokens: one cluster launch
static_assert(CLUSTER_T <= MAX_CLUSTER * ROWS_PER_CTA, "a cluster holds at most 8 CTAs");

int pad16(int n) { return (n + 15) / 16 * 16; }

// Offsets of the outputs in the two buffers; every segment starts on 16
// bytes. Words (4 bytes): idx, new_idx, topk logits, probs ([T, K] each),
// tae [T], and for T > CLUSTER_T the rows' mean and std [T, 2] (scratch).
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

struct ClusterArgs {
  const float* logits;
  int T;
  float beta;
  TokenGate tg;
  SubParams p;
  Tables g;
  Outs o;
};

// The split cluster barrier (PTX barrier.cluster; arrive releases, wait
// acquires): every thread of every CTA arrives once per phase, and wait
// returns when all have arrived.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

__global__ void __launch_bounds__(CTA_THREADS, 1) route_cluster_kernel(ClusterArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned req_s[CTA_THREADS / 32][PER_LANE];  // each warp's requested experts
  __shared__ unsigned cta_req_s[PER_LANE];                // the CTA's, read by the cluster
  __shared__ float stats_s[2 * ROWS_PER_CTA];             // its rows' mean and std (eta)
  __shared__ bool dist_ok_s;
  cg::cluster_group cluster = cg::this_cluster();
  const int E = a.p.E, K = a.p.K;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  const int row0 = static_cast<int>(cluster.block_rank()) * ROWS_PER_CTA;
  const int rows = max(min(a.T - row0, ROWS_PER_CTA), 0);
  const int row_warps = min(rows, n_warps);
  // the warps without a row stage the tables while the others take their
  // rows; when every warp has a row, all threads stage first
  const bool spare = row_warps < n_warps;
  uint8_t* unused;
  const Tables st = stage_tables(smem, a.g, E, a.p.R, spare ? row_warps * 32 : 0,
                                 spare ? (n_warps - row_warps) * 32 : blockDim.x, &unused);
  // the CTA's rows, numbered from 0
  const size_t tk = static_cast<size_t>(row0) * K;
  const float* logits = a.logits + static_cast<size_t>(row0) * E;
  const GateOut& ga = a.o.gate;
  const GateOut go{ga.idx + tk, ga.vals + tk, ga.probs + tk, ga.tae + row0, ga.allow + row0,
                   a.p.stats ? stats_s : nullptr};
  unsigned req_word = 0;
  for (int row = warp; row < rows; row += n_warps)
    gate_row(logits, row, E, K, a.tg, go, req_word);
  if (lane < PER_LANE) req_s[warp][lane] = req_word;
  __syncthreads();
  unsigned word = 0;  // warp 0, lane w: word w of the requested experts
  if (warp == 0 && lane < PER_LANE)
    for (int w = 0; w < n_warps; ++w) word |= req_s[w][lane];
  // a cluster of one has the whole batch already and no cluster barrier
  const unsigned n = cluster.num_blocks();
  if (n > 1) {
    if (warp == 0 && lane < PER_LANE) cta_req_s[lane] = word;
    cluster.sync();  // every CTA's words are written
    if (warp == 0 && lane < PER_LANE)
      for (unsigned c = 0; c < n; ++c) word |= *cluster.map_shared_rank(&cta_req_s[lane], c);
    cluster_arrive();  // this CTA's remote reads are done
  }
  if (warp == 0) {
    const bool ok = distribution_gate_warp(word, flag_word(st.resident, E), a.beta);
    if (lane == 0) {
      dist_ok_s = ok;
      if (row0 == 0) *a.o.dist_ok = ok ? 1 : 0;
    }
  }
  __syncthreads();
  const int t = threadIdx.x;
  if (t < rows) {
    SubParams p = a.p;
    p.logits = logits;
    p.stats = go.stats;
    const SubOut& sa = a.o.sub;
    const SubOut so{sa.idx + tk, sa.sub + tk, sa.miss + tk, sa.deg + tk, sa.peer + tk,
                    sa.drop + tk};
    substitute_token(t, go.allow[t] != 0 && dist_ok_s, go.idx, st, p, so);
  }
  if (n > 1) cluster_wait();  // no CTA's shared memory goes while another may read it
}

// CTAs of the cluster form for T tokens, or 0 for the two-launch form.
int cluster_ctas(int T) { return T <= CLUSTER_T ? (T + ROWS_PER_CTA - 1) / ROWS_PER_CTA : 0; }

}  // namespace

// How route_launch runs T tokens: returns its launches (1 or 2) and sets
// *ctas to the cluster's CTAs (0 for the two-launch form). kernels/route.py
// launch_plan must agree.
extern "C" int route_form(int T, int* ctas) {
  *ctas = cluster_ctas(T);
  return *ctas ? 1 : 2;
}

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
  // the grid form's stats go to the scratch segment; the cluster's to each
  // CTA's shared memory (route_cluster_kernel swaps the pointer)
  const SubParams p{K, R, H, rho, substitute, cost, eta, kappa, xr, r_cost, E, logits,
                    eta != 0.f ? o.gate.stats : nullptr};
  const int n = cluster_ctas(T);
  if (n == 1) {
    route_cluster_kernel<<<1, CTA_THREADS, smem, stream>>>(
        ClusterArgs{logits, T, beta, tg, p, g, o});
    return static_cast<int>(cudaGetLastError());
  }
  if (n > 1) {
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = n;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(n);  // one cluster
    cfg.blockDim = dim3(CTA_THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    // a refused cluster (no GPC with n SMs free for it) returns its error
    const cudaError_t err =
        cudaLaunchKernelEx(&cfg, route_cluster_kernel, ClusterArgs{logits, T, beta, tg, p, g, o});
    return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
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
