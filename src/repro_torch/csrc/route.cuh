// Device code shared by the routing kernels (topk_gate.cu,
// buddy_substitute.cu, route.cu): the router gate of one row with the token
// gate (temperature, margin co-gate) and the row's mean and std for Psi's
// eta term, the batch distribution gate, Algorithm 1 for one token in
// precedence or cost mode, and the two grid kernels that the standalone
// entry points and route's two-launch form share. Written once, so that the
// standalone kernels and the fused routing launch do the same arithmetic.
// No fast math: every rounding that core/substitute.py and core/gates.py
// make is made here too (__f*_rn where nvcc would otherwise fuse a multiply
// and an add into one FMA and round once).
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
// dynamic shared memory of the staged tables: the 48 KB a block may use
// without opting in, less route_block_kernel's 3 KB of static arrays
constexpr int SMEM_LIMIT = 44 * 1024;

struct GateOut {
  int* idx;        // [T, K] routed experts, in rank order
  float* vals;     // [T, K] their logits
  float* probs;    // [T, K] renormalized top-k softmax
  float* tae;      // [T]
  uint8_t* allow;  // [T] the token gate
  float* stats;    // [T, 2] the row's mean and population std, or null
};

// The token gate (core/gates.py token_gate): TAE over softmax(v /
// temperature) > tau, and p_max - p_2nd < margin when margin < 1. The tae
// and probs outputs stay the router's, at temperature 1.
struct TokenGate {
  float tau, log_k, temperature, margin;
};

// p = softmax(v / temperature) over the K picks (lane k holds pick k's
// logit in my_v); returns the entropy of p and sets my_p to lane k's p_k.
// The sums run over k in order on every lane. kScaled divides by the
// temperature, a true division as torch and JAX divide; without it the
// router's own softmax runs (temperature 1) with no division at all.
template <bool kScaled>
__device__ __forceinline__ float topk_softmax(float my_v, int K, float temperature,
                                              float& my_p) {
  const int lane = threadIdx.x & 31;
  const float mx = kScaled ? __fdiv_rn(__shfl_sync(FULL, my_v, 0), temperature)
                           : __shfl_sync(FULL, my_v, 0);
  float sum = 0.f;
  for (int k = 0; k < K; ++k) {
    const float v = __shfl_sync(FULL, my_v, k);
    sum += expf((kScaled ? __fdiv_rn(v, temperature) : v) - mx);
  }
  const float denom = fmaxf(sum, 1e-20f);
  float ent = 0.f;
  my_p = 0.f;
  for (int k = 0; k < K; ++k) {
    const float v = __shfl_sync(FULL, my_v, k);
    const float p = expf((kScaled ? __fdiv_rn(v, temperature) : v) - mx) / denom;
    ent -= p * logf(fmaxf(p, 1e-20f));
    if (k == lane) my_p = p;
  }
  return ent;
}

// Warp sum of a double (every lane gets it).
__device__ __forceinline__ double warp_sum(double x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}

// Router gate of row `row` by one warp (all 32 lanes call it): top-k by
// iterative max with ties to the smallest expert index (signed zeros tie),
// p = softmax of the top-k logits, TAE = entropy(p) / log K (0 when K = 1),
// and the token gate (TokenGate). The row stays in registers (E <= 256
// logits, 8 per lane); each of the K rounds is a warp-shuffle argmax on
// (value, index), and lane k keeps the k-th pick, so no array is indexed
// at run time (that would put it in local memory). Lane w < 8 ORs the
// row's experts 32 w .. 32 w + 31 into `req_word`, a bit each, for the
// distribution gate. With o.stats, the row's mean and population std
// (ddof 0) for Psi's z-scores, two-pass in double from the registers and
// rounded once to f32: torch's CPU std accumulates in double too.
__device__ __forceinline__ void gate_row(const float* __restrict__ logits, int row, int E, int K,
                                         const TokenGate& g, const GateOut& o,
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

  if (o.stats) {
    double sum = 0.0;
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) sum += v[j];  // 0 past E
    const double mean = warp_sum(sum) / E;
    double dev2 = 0.0;
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) {
      const double d = lane + 32 * j < E ? v[j] - mean : 0.0;
      dev2 += d * d;
    }
    const double var = warp_sum(dev2) / E;
    if (lane == 0) {
      o.stats[2 * (size_t)row] = __double2float_rn(mean);
      o.stats[2 * (size_t)row + 1] = __double2float_rn(sqrt(var));
    }
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

  // the router's renormalized top-k softmax and entropy, then the token
  // gate's at its temperature (the same numbers at temperature 1)
  float my_p;
  const float ent = topk_softmax<false>(my_v, K, 1.f, my_p);
  if (lane < K) {
    o.idx[(size_t)row * K + lane] = my_i;
    o.vals[(size_t)row * K + lane] = my_v;
    o.probs[(size_t)row * K + lane] = my_p;
  }
  float gate_p = my_p;
  const float gate_ent =
      g.temperature != 1.f ? topk_softmax<true>(my_v, K, g.temperature, gate_p) : ent;
  // p_max - p_2nd (1 for K = 1): the picks are in descending order, and so
  // are their p
  float margin = 1.f;
  if (g.margin < 1.f) {
    const float p0 = __shfl_sync(FULL, gate_p, 0), p1 = __shfl_sync(FULL, gate_p, 1);
    if (K > 1) margin = __fsub_rn(p0, p1);
  }
  if (lane == 0) {
    const float tae = K > 1 ? ent / g.log_k : 0.f;
    o.tae[row] = tae;
    const float gate_tae = g.temperature != 1.f ? (K > 1 ? gate_ent / g.log_k : 0.f) : tae;
    const bool allow = gate_tae > g.tau && (g.margin >= 1.f || margin < g.margin);
    o.allow[row] = allow ? 1 : 0;
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
  const int* hop;           // [E] hops for Psi's kappa term (< 0 counts 0), or null
  const float* fid_cost;    // [E] cost mode: degraded outcome, or null (+inf)
  const float* fetch_cost;  // [E] cost mode: fetch outcome
  const float* peer_cost;   // [E] cost mode: peer outcome, or null (no peer entry)
  const uint8_t* resident;  // [E]
  const uint8_t* quant_ok;  // [E] precedence: degraded outcome, or null
  const uint8_t* peer_ok;   // [E] precedence: peer outcome, or null
};

// Shared memory of the staged tables: table and q, then hop and the three
// cost vectors (4 bytes each per expert), then resident, quant_ok, peer_ok
// and the requested flags, E bytes each.
__host__ __device__ constexpr int tables_smem_bytes(int E, int R) {
  return E * R * 8 + 16 * E + 4 * E;
}

// Threads [first, first + count) of the block copy the tables into `smem`.
// Returns the staged tables (and the requested flags' place) for every
// thread; a caller synchronizes before reading them.
__device__ __forceinline__ Tables stage_tables(unsigned char* smem, const Tables& g, int E, int R,
                                               int first, int count, uint8_t** requested) {
  int* tab = reinterpret_cast<int*>(smem);
  float* q = reinterpret_cast<float*>(tab + E * R);
  int* hop = reinterpret_cast<int*>(q + E * R);
  float* fid = reinterpret_cast<float*>(hop + E);
  float* fetch = fid + E;
  float* peer_c = fetch + E;
  uint8_t* res = reinterpret_cast<uint8_t*>(peer_c + E);
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
      if (g.hop) hop[i] = g.hop[i];
      if (g.fid_cost) fid[i] = g.fid_cost[i];
      if (g.fetch_cost) fetch[i] = g.fetch_cost[i];
      if (g.peer_cost) peer_c[i] = g.peer_cost[i];
    }
  }
  return Tables{tab,
                q,
                g.hop ? hop : nullptr,
                g.fid_cost ? fid : nullptr,
                g.fetch_cost ? fetch : nullptr,
                g.peer_cost ? peer_c : nullptr,
                res,
                g.quant_ok ? quant : nullptr,
                g.peer_ok ? peer : nullptr};
}

struct SubOut {
  int* idx;        // [T, K] final experts
  uint8_t* sub;    // [T, K] substituted by a buddy
  uint8_t* miss;   // [T, K] left to the fetch / drop fallback
  uint8_t* deg;    // [T, K] degraded, or null (no splits: the standalone form)
  uint8_t* peer;   // [T, K] peer borrow, or null
  uint8_t* drop;   // [T, K] dropped by the cost argmin, or null
};

// How Algorithm 1 runs (core/substitute.py's policy arguments).
struct SubParams {
  int K, R, H, rho;
  int substitute;         // 0: policy mode "none"
  int cost;               // 1: cost mode's argmin; 0: precedence
  float eta, kappa;       // Psi's weights; a factor applies where its weight is not 0
  float xr, r_cost;       // cost mode: stall_per_quality and xr * drop_loss
  int E;
  const float* logits;    // [T, E], for the z-scores of the eta term
  const float* stats;     // [T, 2] row mean and std (gate_row), or null: no eta term
};

// Algorithm 1 for token t (one thread): the K slots in rank order, each
// seeing the earlier slots' substitutions. Psi(b | e, t) = q_{b|e} * (1 +
// eta * zhat_b(t)) * (1 - kappa * max(hop_b, 0)) - r * 1e-7 for the buddy
// of rank r (ties to the lower rank), zhat_b(t) = (z[t, b] - mean_t) /
// (std_t + 1e-6); each factor applies only when its weight is not 0 (and
// its input is given), so with eta = kappa = 0 Psi is q less the rank
// tie-break. The eligible buddies are resident, among the first H ranks
// and not already in the token's row.
//  * Precedence mode: a non-resident slot of a gated token with budget left
//    takes the best-Psi buddy; otherwise it is a miss, which splits to the
//    degraded outcome where quant_ok holds for its expert, else to a peer
//    borrow where peer_ok holds. With `substitute` false (mode "none") no
//    slot is substituted.
//  * Cost mode: a non-resident slot takes the cheapest of buddy (xr * (1 -
//    clamp(Psi_best, 0, 1)) when the token is gated with budget left and a
//    buddy was found, else +inf), degraded (fid_cost, +inf when absent),
//    peer (peer_cost, only when given), fetch (fetch_cost) and drop
//    (r_cost), ties to the earlier outcome, as torch's and jnp's argmin
//    over the stacked costs (costs are not NaN). When every cost is +inf
//    the argmin is the buddy, at torch's argmax of an all -inf row: the
//    first rank's id. Mode "none" has no buddy option.
// The budget falls on each substitution. The slot loops run to MAX_K,
// unrolled, with the row padded by -1, so the token's row stays in
// registers (a run-time index would put it in local memory). kCost and
// kPsi (a Psi factor applies) are compiled apart, so that precedence mode
// with Psi = q runs no instruction of the other policies.
template <bool kCost, bool kPsi>
__device__ __forceinline__ void substitute_slots(int t, bool gate, const int* s, const Tables& st,
                                                 const SubParams& p, const SubOut& o) {
  const int K = p.K, R = p.R;
  int row[MAX_K];
#pragma unroll
  for (int k = 0; k < MAX_K; ++k) row[k] = k < K ? s[(size_t)t * K + k] : -1;
  int budget = gate ? p.rho : 0;
  const float* z = nullptr;  // the token's router row, when the eta term applies
  float mean = 0.f, scale = 1.f;
  if (kPsi && p.eta != 0.f && p.stats) {
    z = p.logits + (size_t)t * p.E;
    mean = p.stats[2 * (size_t)t];
    scale = __fadd_rn(p.stats[2 * (size_t)t + 1], 1e-6f);
  }
  const int* hop = p.kappa != 0.f ? st.hop : nullptr;
#pragma unroll
  for (int k = 0; k < MAX_K; ++k) {
    if (k >= K) break;
    const int e = row[k];
    const bool res_e = st.resident[e] != 0;
    int best_b = -1;
    float best_psi = -INFINITY;
    // cost mode scores a buddy even without budget: its argmin takes one
    // when every outcome costs +inf
    if (p.substitute && !res_e && (budget > 0 || kCost)) {
      for (int r = 0; r < p.H; ++r) {
        const int b = st.table[e * R + r];
        if (b < 0 || !st.resident[b]) continue;
        bool used = false;  // b >= 0 never matches the -1 padding
#pragma unroll
        for (int kk = 0; kk < MAX_K; ++kk) used |= row[kk] == b;
        if (used) continue;
        float psi = st.q[e * R + r];
        if (kPsi) {
          if (z) {
            const float zhat = __fdiv_rn(__fsub_rn(z[b], mean), scale);
            psi = __fmul_rn(psi, __fadd_rn(1.f, __fmul_rn(p.eta, zhat)));
          }
          if (hop) {
            const float h = static_cast<float>(max(hop[b], 0));
            psi = __fmul_rn(psi, __fsub_rn(1.f, __fmul_rn(p.kappa, h)));
          }
        }
        psi = psi - static_cast<float>(r) * 1e-7f;  // rank tie-break
        if (psi > best_psi) {
          best_psi = psi;
          best_b = b;
        }
      }
    }
    bool do_sub, miss, deg, peer, drop = false;
    if (kCost) {
      float best = INFINITY;
      if (p.substitute && budget > 0 && best_b >= 0)
        best = __fmul_rn(p.xr, __fsub_rn(1.f, fminf(fmaxf(best_psi, 0.f), 1.f)));
      int code = 0;  // 0 buddy, 1 degraded, 2 peer, 3 fetch, 4 drop
      if (st.fid_cost && st.fid_cost[e] < best) {
        best = st.fid_cost[e];
        code = 1;
      }
      if (st.peer_cost && st.peer_cost[e] < best) {
        best = st.peer_cost[e];
        code = 2;
      }
      if (st.fetch_cost[e] < best) {
        best = st.fetch_cost[e];
        code = 3;
      }
      if (p.r_cost < best) code = 4;
      const bool m = !res_e;
      do_sub = m && p.substitute && code == 0;
      if (do_sub && best_b < 0) best_b = max(st.table[e * R], 0);
      deg = m && code == 1;
      peer = m && code == 2;
      miss = m && code == 3;
      drop = m && code == 4;
    } else {
      do_sub = best_b >= 0;
      miss = !res_e && !do_sub;  // a miss keeps its own expert e
      deg = miss && st.quant_ok && st.quant_ok[e];
      miss = miss && !deg;
      peer = miss && st.peer_ok && st.peer_ok[e];
      miss = miss && !peer;
    }
    row[k] = do_sub ? best_b : e;
    const size_t i = (size_t)t * K + k;
    o.idx[i] = row[k];
    o.sub[i] = do_sub ? 1 : 0;
    o.miss[i] = miss ? 1 : 0;
    if (o.deg) {
      o.deg[i] = deg ? 1 : 0;
      o.peer[i] = peer ? 1 : 0;
      o.drop[i] = drop ? 1 : 0;
    }
    budget -= do_sub ? 1 : 0;
  }
}

// Algorithm 1 for token t under the policy `p` (substitute_slots).
__device__ __forceinline__ void substitute_token(int t, bool gate, const int* s, const Tables& st,
                                                 const SubParams& p, const SubOut& o) {
  const bool psi = (p.eta != 0.f && p.stats) || (p.kappa != 0.f && st.hop);
  if (p.cost) {
    if (psi)
      substitute_slots<true, true>(t, gate, s, st, p, o);
    else
      substitute_slots<true, false>(t, gate, s, st, p, o);
  } else if (psi) {
    substitute_slots<false, true>(t, gate, s, st, p, o);
  } else {
    substitute_slots<false, false>(t, gate, s, st, p, o);
  }
}

// The router gate over a grid: GATE_ROWS rows per block, one warp each.
__global__ void __launch_bounds__(GATE_ROWS * 32)
gate_kernel(const float* __restrict__ logits, int T, int E, int K, TokenGate g, GateOut o) {
  const int row = blockIdx.x * GATE_ROWS + (threadIdx.x >> 5);
  if (row >= T) return;  // uniform over the warp
  unsigned unused = 0;
  gate_row(logits, row, E, K, g, o, unused);
}

struct SubArgs {
  const int* s;          // [T, K] routed experts
  const uint8_t* gate;   // [T] the token gate (the route's: allow)
  int T;
  int dist;              // 1: AND the distribution gate into `gate`
  float beta;
  SubParams p;
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
  const int E = a.p.E;
  const Tables st = stage_tables(smem, a.g, E, a.p.R, 0, blockDim.x, &requested);
  bool dist_ok = true;
  if (a.dist) {
    for (int i = threadIdx.x; i < E; i += blockDim.x) requested[i] = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < a.T * a.p.K; i += blockDim.x) requested[a.s[i]] = 1;
    __syncthreads();
    if (threadIdx.x < 32) {
      const bool ok = distribution_gate_warp(flag_word(requested, E),
                                             flag_word(st.resident, E), a.beta);
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
  substitute_token(t, a.gate[t] != 0 && dist_ok, a.s, st, a.p, a.o);
}

}  // namespace route
