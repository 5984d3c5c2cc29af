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
// Design: steps 1-3 of the int8 block body (csrc/int8_block.cuh) on the
// caller's stream, three launches: LN1 → int8 into q8, the qkv product on
// gemm_sm90.cuh whose epilogue rounds to bf16 with _rn intrinsics, and the
// score kernel shared with K1, B4 and B14 (common.cuh:score_kernel), which
// reads that bf16 qkv as the TPU kernel scores its rounded qkv
// (block.py:1361), or a zero fill of the scores. band: LN1 and the qkv
// product as one launch of the row-band GEMM's head form (csrc/band_s8.cuh:
// LN1 → int8 made once a 128-row band in shared memory), the same bits; it
// read slower at every path shape on the H100, so no path takes it, and it
// stays as the bitwise-checked alternative.
// Tensor-parallel shard form (rajni_tpu/parallel/mesh.py:tp_pallas_forward):
// a head-aligned [3·Ca, C] weight (this shard's heads of q, k and v) gives qkv
// [B, N, 3·Ca] from the full LN1 rows, whose int8 row scales are the
// single-device ones (the column-parallel site quantizes the replicated
// rows); it takes no scores (they need every head) and not the band.
#include "int8_block.cuh"

using namespace rajni;

extern "C" int rajni_ln_qkv_int8(const void* x, const void* ln1s, const void* ln1b,
                                 const void* wqkv, const void* sqkv, const void* bqkv,
                                 int with_scores, int static_act, int band, void* q8,
                                 void* qs, void* qkv_out, void* scores_out, int B, int N, int C,
                                 int Ca, int H, float eps, void* stream) {
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
  p.Ca = Ca;
  p.eps = eps;
  if (Ca != C && (with_scores || band)) return fail(cudaErrorInvalidValue, 1);
  const int rc = band ? int8_block_head<true>(p, st) : int8_block_head(p, st);
  if (rc != 0) return rc;
  cudaError_t e;
  if (with_scores)
    e = launch_score(p.qkv, static_cast<float*>(scores_out), B, N, C, H, 1e-6f, st);
  else
    e = cudaMemsetAsync(scores_out, 0, (size_t)B * N * sizeof(float), st);
  return e == cudaSuccess ? 0 : fail(e, 3);
}
