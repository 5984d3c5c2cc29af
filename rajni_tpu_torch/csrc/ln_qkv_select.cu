// B19: fused_ln_qkv_select — the front half of a pruned block with the
// selection in the same call: LN1 → QKV → RAJNI scores → top-K selection with
// CLS forced. Returns qkv [B, N, 3C] bf16, the one-hot sel [B, K, N] (bf16,
// the activation dtype), keep_idx [B, K] int32 and next_scores [B, K] fp32.
// It always scores.
//
// Replaces the TPU kernel rajni_tpu/kernels/block.py:fused_ln_qkv_select
// (pallas_call at block.py:833, body _ln_qkv_select_kernel at 784, the
// selection _select_from_scores at 722). The JAX package keeps it as a tested
// alternative and routes no block through it (rajni_tpu/models/vit.py:
// 895-899): neither does the port.
//
// Bound on the H100: operations. At ViT-B/384 (C=768) batch 128 and
// N=577→K=548 the QKV product is 2.6e11 FLOP (~0.26 ms at 989 TFLOP/s);
// its bytes, x in and qkv out with the 81 MB one-hot, need ~0.16 ms. The
// rank loop of the selection is N² fp32 compares an image on the CUDA cores.
//
// Design: B4's entry point (ln_qkv.cu: row LayerNorm, QKV GEMM with +bias,
// rounded, into the caller's qkv, and the score kernel into a scratch), then
// on the same stream the selection kernel shared with K1
// (common.cuh:select_kernel: idx and next_scores) and a one-hot kernel, one
// block per kept row, that writes 1 at the row's index and 0 elsewhere.
#include "common.cuh"

namespace rajni {
namespace {

__global__ void __launch_bounds__(128) onehot_kernel(const int* __restrict__ idx,
                                                     bf16* __restrict__ sel, int N) {
  const size_t row = blockIdx.x;
  const int t = idx[row];
  bf16* r = sel + row * N;
  const bf16 one = __float2bfloat16(1.0f), zero = __float2bfloat16(0.0f);
  for (int n = threadIdx.x; n < N; n += 128) r[n] = n == t ? one : zero;
}

}  // namespace
}  // namespace rajni

using namespace rajni;

extern "C" int rajni_ln_qkv(const void* x, const void* ln_scale, const void* ln_bias,
                            const void* wqkv, const void* bqkv, int with_scores, void* y_scratch,
                            void* qkv_out, void* scores_out, int B, int N, int C, int out_w, int H,
                            float eps, void* stream);

extern "C" int rajni_ln_qkv_select(const void* x, const void* ln_scale, const void* ln_bias,
                                   const void* wqkv, const void* bqkv, void* y_scratch,
                                   void* qkv_out, void* scores_scratch, void* sel_out,
                                   void* idx_out, void* ns_out, int B, int N, int K, int C, int H,
                                   float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = rajni_ln_qkv(x, ln_scale, ln_bias, wqkv, bqkv, 1, y_scratch, qkv_out, scores_scratch,
                        B, N, C, 3 * C, H, eps, stream);
  if (rc != 0) return rc;

  cudaError_t e = launch_select(static_cast<const float*>(scores_scratch),
                                static_cast<int*>(idx_out), static_cast<float*>(ns_out), B, N, K,
                                st);
  if (e != cudaSuccess) return fail(e, 4);

  onehot_kernel<<<B * K, 128, 0, st>>>(static_cast<const int*>(idx_out), static_cast<bf16*>(sel_out),
                                       N);
  e = cudaGetLastError();
  return e == cudaSuccess ? 0 : fail(e, 5);
}
