// B12: fused_ln_qkv_int8 — LN1 and the int8 QKV projection with the RAJNI
// scores of the same qkv: returns qkv [B, N, 3C] bf16 and scores [B, N] fp32
// (zeros when with_scores is 0). Under calibrated static scales the host has
// folded 1/a_qkv into the LN affine and 1/a_proj into the V columns of the
// weight scales and bias, so V leaves pre-scaled for B13's quantizer.
//
// Replaces the TPU kernel rajni_tpu/kernels/block.py:fused_ln_qkv_int8
// (pallas_call at block.py:1408, body _ln_qkv_int8_kernel at 1341).
//
// Bound on the H100: operations (the int8 qkv product, 6·B·N·C²); the
// scores are ~2·N·C multiply-adds an image on the CUDA cores.
//
// Design: three launches on the caller's stream, steps 1-3 of the int8 block
// body (csrc/int8.cuh): LN1 → int8, the qkv product whose epilogue rounds to
// bf16 with _rn intrinsics, and the score kernel shared with K1, B4 and B14
// (common.cuh:score_kernel), which reads that bf16 qkv as the TPU kernel
// scores its rounded qkv (block.py:1361), or a zero fill of the scores.
#include "int8.cuh"

using namespace rajni;

extern "C" int rajni_ln_qkv_int8(const void* x, const void* ln1s, const void* ln1b,
                                 const void* wqkv, const void* sqkv, const void* bqkv,
                                 int with_scores, int static_act, void* q8, void* qs,
                                 void* qkv_out, void* scores_out, int B, int N, int C, int H,
                                 float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Int8Block p{};
  p.x = static_cast<const bf16*>(x);
  p.ln1s = static_cast<const float*>(ln1s);
  p.ln1b = static_cast<const float*>(ln1b);
  p.wqkv = static_cast<const int8_t*>(wqkv);
  p.sqkv = static_cast<const float*>(sqkv);
  p.bqkv = static_cast<const float*>(bqkv);
  p.static_act = static_act;
  p.q8 = static_cast<int8_t*>(q8);
  p.qs = static_cast<float*>(qs);
  p.qkv = static_cast<bf16*>(qkv_out);
  p.B = B;
  p.N = N;
  p.C = C;
  p.eps = eps;
  const int rc = int8_block_head(p, st);
  if (rc != 0) return rc;
  cudaError_t e;
  if (with_scores)
    e = launch_score(p.qkv, static_cast<float*>(scores_out), B, N, C, H, 1e-6f, st);
  else
    e = cudaMemsetAsync(scores_out, 0, (size_t)B * N * sizeof(float), st);
  return e == cudaSuccess ? 0 : fail(e, 3);
}
