// B4: fused_ln_qkv — LN1 + QKV projection with the RAJNI scores of the same
// qkv: returns qkv [B, N, out_w] and scores [B, N] fp32 (zeros when
// with_scores is 0).
//
// Replaces the TPU kernel rajni_tpu/kernels/block.py:fused_ln_qkv
// (pallas_call at block.py:677), with its helper _importance_f32
// (block.py:340).
//
// Bound on the H100: compute. At batch 128 and N=577 (ViT-B/384) the QKV
// product is 2.6e11 FLOP against ~0.5 GB of activations in and out; the
// scores are ~1e8 fp32 operations on the CUDA cores.
//
// Design: three launches on the caller's stream — row LayerNorm (bf16 out),
// QKV on the wgmma/TMA GEMM of gemm_sm90.cuh with a +bias→round epilogue
// into the caller's qkv (out_w columns, N % 8 masked: a head-aligned
// tensor-parallel shard passes its [3C_local, C] weight), and either the
// score kernel shared with K1 (common.cuh:score_kernel, a cluster of blocks
// per image, scoring from the rounded qkv as the TPU kernel does) or a zero
// fill of the scores.
#include "gemm_sm90.cuh"

using namespace rajni;

extern "C" int rajni_ln_qkv(const void* x, const void* ln_scale, const void* ln_bias,
                            const void* wqkv, const void* bqkv, int with_scores, void* y_scratch,
                            void* qkv_out, void* scores_out, int B, int N, int C, int out_w, int H,
                            float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = B * N;
  cudaError_t e = launch_layer_norm(static_cast<const bf16*>(x), static_cast<const bf16*>(ln_scale),
                                    static_cast<const bf16*>(ln_bias),
                                    static_cast<bf16*>(y_scratch), rows, C, eps, st);
  if (e != cudaSuccess) return fail(e, 1);

  EpilogueArgs ep{static_cast<const bf16*>(bqkv), nullptr, nullptr, nullptr, 1, 1};
  e = launch_gemm_sm90<EPI_BIAS>(static_cast<const bf16*>(y_scratch),
                                 static_cast<const bf16*>(wqkv), static_cast<bf16*>(qkv_out),
                                 rows, out_w, C, ep, st);
  if (e != cudaSuccess) return fail(e, 2);

  if (with_scores)
    e = launch_score(static_cast<const bf16*>(qkv_out), static_cast<float*>(scores_out), B, N, C,
                     H, 1e-6f, st);
  else
    e = cudaMemsetAsync(scores_out, 0, (size_t)rows * sizeof(float), st);
  return e == cudaSuccess ? 0 : fail(e, 3);
}
