// The selection of the two-kernel route (B12 fused_ln_qkv_int8 or B4
// fused_ln_qkv, then the selection, then B13 or B5; models/vit.py:
// _pruned_halves): common.cuh:select_kernel, which K1, B11, B14 and B19
// launch inside their own calls, behind a C entry point of its own. It
// replaces the torch selection (ops/pruning.py:select_tokens_dense: a [B, N,
// N] rank matrix and a [B, K, N] one-hot on the card) on that route. The JAX
// package selects outside Pallas there (rajni_tpu/models/vit.py:867-928), so
// this kernel replaces no TPU kernel: it was added because the torch
// selection took ~1.3 ms of a pruned block at ViT-B/384, batch 128.
//
// Function (_select_from_scores, block.py:722): CLS ranked +inf, rank[n] =
// #{m : s_m > s_n or (s_m == s_n and m < n)}, the K lowest ranks kept in
// ascending index order, next_scores the real scores of the kept tokens;
// exact, as select_tokens_dense.
//
// Bound on the H100: bytes (B·N scores read, B·K indices and scores
// written); the kernel does N² comparisons an image (one block an image, the
// scores in shared memory).
#include "common.cuh"

using namespace rajni;

extern "C" int rajni_select(const void* scores, void* idx_out, void* ns_out, int B, int N, int K,
                            void* stream) {
  if (B < 1 || N < 2 || K < 1 || K > N) return fail(cudaErrorInvalidValue, 1);
  const cudaError_t e = launch_select(static_cast<const float*>(scores), static_cast<int*>(idx_out),
                                      static_cast<float*>(ns_out), B, N, K,
                                      static_cast<cudaStream_t>(stream));
  return e == cudaSuccess ? 0 : fail(e, 1);
}
