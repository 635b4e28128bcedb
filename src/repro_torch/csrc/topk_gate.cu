// Fused MoE router gate for sm_90a: top-k, renormalized top-k softmax, Token
// Activating Entropy (TAE) and the TAE gate, in one pass over the logits.
//
// Replaces the TPU kernel topk_gate_pallas (src/repro/kernels/topk_gate.py):
// top-k by iterative max with ties to the smallest expert index (-0.0
// below +0.0, as lax.top_k orders them), p =
// softmax(top-k logits), TAE = entropy(p) / log K (0 when K = 1), allow =
// TAE > tau. Temperature 1 and no margin co-gate (route.cu has both).
//
// Bound on the H100: it reads T*E*4 bytes and writes T*(3K+2) words, a few
// KB at decode, so the launch itself bounds it, not bytes or FLOPs. The
// design keeps the whole row in registers (one warp per token row, E <= 256
// logits as 8 per lane), runs K rounds of a warp-shuffle argmax, and never
// materializes the [T, E] softmax that a library top-k plus separate
// elementwise passes would. The row's arithmetic is route.cuh's gate_row,
// which the fused routing kernel (route.cu) shares; on the model's path
// route.cu runs it, and this entry point stands alone.
#include "route.cuh"

extern "C" int topk_gate_launch(const float* logits, int T, int E, int K, float tau, float log_k,
                                int* idx, float* vals, float* probs, float* tae, uint8_t* allow,
                                cudaStream_t stream) {
  using namespace route;
  if (E > MAX_E || K > MAX_K || K > E || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (T == 0) return static_cast<int>(cudaSuccess);
  const int blocks = (T + GATE_ROWS - 1) / GATE_ROWS;
  gate_kernel<<<blocks, GATE_ROWS * 32, 0, stream>>>(
      logits, T, E, K, TokenGate{tau, log_k, 1.f, 1.f},
      GateOut{idx, vals, probs, tae, allow, nullptr});
  return static_cast<int>(cudaGetLastError());
}
