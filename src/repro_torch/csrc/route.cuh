// Device code shared by the routing kernels (topk_gate.cu,
// buddy_substitute.cu, route.cu): the router gate of one row, the batch
// distribution gate, Algorithm 1 for one token with the degraded and peer
// splits, and the two grid kernels that the standalone entry points and
// route's two-launch form share. Written once, so that the standalone
// kernels and the fused routing launch do the same arithmetic.
#pragma once
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace route {

constexpr int MAX_E = 256;
constexpr int PER_LANE = MAX_E / 32;
constexpr int MAX_K = 16;
constexpr int NONE = 0x7fffffff;
constexpr unsigned FULL = 0xffffffffu;
constexpr int GATE_ROWS = 8;       // warps (one row each) per gate_kernel block
constexpr int SUB_THREADS = 128;   // tokens per substitute_kernel block
constexpr int SMEM_LIMIT = 48 * 1024;

struct GateOut {
  int* idx;        // [T, K] routed experts, in rank order
  float* vals;     // [T, K] their logits
  float* probs;    // [T, K] renormalized top-k softmax
  float* tae;      // [T]
  uint8_t* allow;  // [T] TAE > tau
};

// Router gate of row `row` by one warp (all 32 lanes call it): top-k by
// iterative max with ties to the smallest expert index (signed zeros tie),
// p = softmax of the top-k logits, TAE = entropy(p) / log K (0 when K = 1),
// allow = TAE > tau. The row stays in registers (E <= 256 logits, 8 per
// lane); each of the K rounds is a warp-shuffle argmax on (value, index),
// and lane k keeps the k-th pick, so no array is indexed at run time (that
// would put it in local memory). Lane w < 8 ORs the row's experts
// 32 w .. 32 w + 31 into `req_word`, a bit each, for the distribution gate.
__device__ __forceinline__ void gate_row(const float* __restrict__ logits, int row, int E, int K,
                                         float tau, float log_k, const GateOut& o,
                                         unsigned& req_word) {
  const int lane = threadIdx.x & 31;
  const float* z = logits + (size_t)row * E;

  float v[PER_LANE];
  unsigned taken = 0;  // bit j: element lane + 32 j is selected or absent
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    const int e = lane + 32 * j;
    v[j] = e < E ? z[e] : 0.f;
    if (e >= E) taken |= 1u << j;
  }

  float my_v = 0.f;  // lane k < K: the k-th pick's logit and expert
  int my_i = 0;
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
      const float ov = __shfl_xor_sync(FULL, best, off);
      const int oi = __shfl_xor_sync(FULL, bi, off);
      if (oi != NONE && (bi == NONE || ov > best || (ov == best && oi < bi))) {
        best = ov;
        bi = oi;
      }
    }
    if ((bi & 31) == lane) taken |= 1u << (bi >> 5);
    if ((bi >> 5) == lane) req_word |= 1u << (bi & 31);
    if (k == lane) {
      my_v = best;
      my_i = bi;
    }
  }

  // renormalized top-k softmax, entropy and gate: the sums run over k in
  // order on every lane, each pick read from its lane
  const float mx = __shfl_sync(FULL, my_v, 0);
  float sum = 0.f;
  for (int k = 0; k < K; ++k) sum += expf(__shfl_sync(FULL, my_v, k) - mx);
  const float denom = fmaxf(sum, 1e-20f);
  float ent = 0.f;
  float my_p = 0.f;
  for (int k = 0; k < K; ++k) {
    const float p = expf(__shfl_sync(FULL, my_v, k) - mx) / denom;
    ent -= p * logf(fmaxf(p, 1e-20f));
    if (k == lane) my_p = p;
  }
  if (lane < K) {
    o.idx[(size_t)row * K + lane] = my_i;
    o.vals[(size_t)row * K + lane] = my_v;
    o.probs[(size_t)row * K + lane] = my_p;
  }
  if (lane == 0) {
    const float tae = K > 1 ? ent / log_k : 0.f;
    o.tae[row] = tae;
    o.allow[row] = tae > tau ? 1 : 0;
  }
}

// Lane w < 8 of a warp: bit i of word w is flags[32 w + i] (E <= 256).
__device__ __forceinline__ unsigned flag_word(const uint8_t* flags, int E) {
  const int lane = threadIdx.x & 31;
  unsigned word = 0;
  for (int w = 0; w * 32 < E; ++w) {
    const int e = w * 32 + lane;
    const unsigned b = __ballot_sync(FULL, e < E && flags[e]);
    if (lane == w) word = b;
  }
  return word;
}

// The distribution gate (Eq. 2) by one warp, from the requested and the
// resident experts as bit words (lane w holds word w): delta = n_cpu /
// max(n_req, 1) as an IEEE f32 divide (as torch and JAX compute it; no
// fast math), allowed when delta < beta. Every lane returns the result.
__device__ __forceinline__ bool distribution_gate_warp(unsigned req_word, unsigned res_word,
                                                       float beta) {
  const int n_req = static_cast<int>(__reduce_add_sync(FULL, __popc(req_word)));
  const int n_cpu = static_cast<int>(__reduce_add_sync(FULL, __popc(req_word & ~res_word)));
  const float delta = __fdiv_rn(static_cast<float>(n_cpu), static_cast<float>(max(n_req, 1)));
  return delta < beta;
}

// What Algorithm 1 reads per expert. In global memory as given; staged into
// shared memory by stage_tables.
struct Tables {
  const int* table;         // [E, R] buddy ids, -1 padded, rank order
  const float* q;           // [E, R] q_{j|i}
  const uint8_t* resident;  // [E]
  const uint8_t* quant_ok;  // [E], or null: no degraded outcome
  const uint8_t* peer_ok;   // [E], or null: no peer outcome
};

// Shared memory of the staged tables: table and q, then resident, quant_ok,
// peer_ok and the requested flags, E bytes each.
__host__ __device__ constexpr int tables_smem_bytes(int E, int R) { return E * R * 8 + 4 * E; }

// Threads [first, first + count) of the block copy the tables into `smem`.
// Returns the staged tables (and the requested flags' place) for every
// thread; a caller synchronizes before reading them.
__device__ __forceinline__ Tables stage_tables(unsigned char* smem, const Tables& g, int E, int R,
                                               int first, int count, uint8_t** requested) {
  int* tab = reinterpret_cast<int*>(smem);
  float* q = reinterpret_cast<float*>(tab + E * R);
  uint8_t* res = reinterpret_cast<uint8_t*>(q + E * R);
  uint8_t* quant = res + E;
  uint8_t* peer = quant + E;
  *requested = peer + E;
  const int i0 = static_cast<int>(threadIdx.x) - first;
  if (i0 >= 0 && i0 < count) {
    for (int i = i0; i < E * R; i += count) {
      tab[i] = g.table[i];
      q[i] = g.q[i];
    }
    for (int i = i0; i < E; i += count) {
      res[i] = g.resident[i];
      if (g.quant_ok) quant[i] = g.quant_ok[i];
      if (g.peer_ok) peer[i] = g.peer_ok[i];
    }
  }
  return Tables{tab, q, res, g.quant_ok ? quant : nullptr, g.peer_ok ? peer : nullptr};
}

struct SubOut {
  int* idx;        // [T, K] final experts
  uint8_t* sub;    // [T, K] substituted by a buddy
  uint8_t* miss;   // [T, K] left to the fetch / drop fallback
  uint8_t* deg;    // [T, K] degraded, or null (no splits: the standalone form)
  uint8_t* peer;   // [T, K] peer borrow, or null
  uint8_t* drop;   // [T, K] written all false, or null
};

// Algorithm 1, precedence mode, for token t (one thread): the K slots in
// rank order, each seeing the earlier slots' substitutions. A non-resident
// slot of a gated token with budget left takes the best-Psi (Psi = q, ties
// to the lower rank through q - r * 1e-7) resident buddy among the first H
// ranks that the token does not already use; otherwise it is a miss. With
// `substitute` false (policy mode "none") no slot is substituted. A miss
// then splits to the degraded outcome where quant_ok holds for its expert,
// else to a peer borrow where peer_ok holds. The slot loops run to MAX_K,
// unrolled, with the row padded by -1, so the token's row stays in
// registers (a run-time index would put it in local memory).
__device__ __forceinline__ void substitute_token(int t, bool gate, bool substitute, const int* s,
                                                 const Tables& st, int K, int R, int H, int rho,
                                                 const SubOut& o) {
  int row[MAX_K];
#pragma unroll
  for (int k = 0; k < MAX_K; ++k) row[k] = k < K ? s[(size_t)t * K + k] : -1;
  int budget = gate ? rho : 0;
#pragma unroll
  for (int k = 0; k < MAX_K; ++k) {
    if (k >= K) break;
    const int e = row[k];
    const bool res_e = st.resident[e] != 0;
    int best_b = -1;
    if (substitute && !res_e && budget > 0) {
      float best_psi = -INFINITY;
      for (int r = 0; r < H; ++r) {
        const int b = st.table[e * R + r];
        if (b < 0 || !st.resident[b]) continue;
        bool used = false;  // b >= 0 never matches the -1 padding
#pragma unroll
        for (int kk = 0; kk < MAX_K; ++kk) used |= row[kk] == b;
        if (used) continue;
        const float psi = st.q[e * R + r] - static_cast<float>(r) * 1e-7f;  // rank tie-break
        if (psi > best_psi) {
          best_psi = psi;
          best_b = b;
        }
      }
    }
    const bool do_sub = best_b >= 0;
    row[k] = do_sub ? best_b : e;
    bool miss = !res_e && !do_sub;  // a miss keeps its own expert e
    const bool deg = miss && st.quant_ok && st.quant_ok[e];
    miss = miss && !deg;
    const bool peer = miss && st.peer_ok && st.peer_ok[e];
    miss = miss && !peer;
    const size_t i = (size_t)t * K + k;
    o.idx[i] = row[k];
    o.sub[i] = do_sub ? 1 : 0;
    o.miss[i] = miss ? 1 : 0;
    if (o.deg) {
      o.deg[i] = deg ? 1 : 0;
      o.peer[i] = peer ? 1 : 0;
      o.drop[i] = 0;
    }
    budget -= do_sub ? 1 : 0;
  }
}

// The router gate over a grid: GATE_ROWS rows per block, one warp each.
__global__ void __launch_bounds__(GATE_ROWS * 32)
gate_kernel(const float* __restrict__ logits, int T, int E, int K, float tau, float log_k,
            GateOut o) {
  const int row = blockIdx.x * GATE_ROWS + (threadIdx.x >> 5);
  if (row >= T) return;  // uniform over the warp
  unsigned unused = 0;
  gate_row(logits, row, E, K, tau, log_k, o, unused);
}

struct SubArgs {
  const int* s;          // [T, K] routed experts
  const uint8_t* gate;   // [T] the token gate (the route's: allow)
  int T, K, E, R, H, rho;
  int substitute;        // 0: policy mode "none"
  int dist;              // 1: AND the distribution gate into `gate`
  float beta;
  Tables g;
  SubOut o;
  uint8_t* dist_ok;      // [] written by block 0 when dist
};

// Algorithm 1 over a grid: SUB_THREADS tokens per block, the tables staged
// per block. With `dist`, each block also rebuilds the batch's requested
// set from the whole [T, K] routing (read from L2) and computes the
// distribution gate itself, so no block waits for another and no global
// scratch is needed. Dynamic shared memory: tables_smem_bytes(E, R).
__global__ void __launch_bounds__(SUB_THREADS) substitute_kernel(SubArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ bool dist_ok_s;
  uint8_t* requested;
  const Tables st = stage_tables(smem, a.g, a.E, a.R, 0, blockDim.x, &requested);
  bool dist_ok = true;
  if (a.dist) {
    for (int i = threadIdx.x; i < a.E; i += blockDim.x) requested[i] = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < a.T * a.K; i += blockDim.x) requested[a.s[i]] = 1;
    __syncthreads();
    if (threadIdx.x < 32) {
      const bool ok = distribution_gate_warp(flag_word(requested, a.E),
                                             flag_word(st.resident, a.E), a.beta);
      if (threadIdx.x == 0) {
        dist_ok_s = ok;
        if (blockIdx.x == 0) *a.dist_ok = ok ? 1 : 0;
      }
    }
  }
  __syncthreads();
  if (a.dist) dist_ok = dist_ok_s;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= a.T) return;
  substitute_token(t, a.gate[t] != 0 && dist_ok, a.substitute != 0, a.s, st, a.K, a.R, a.H,
                   a.rho, a.o);
}

}  // namespace route
