// B11: fused_pruned_attn_block_int8 — the pruned attention half of a RAJNI
// block with int8 qkv and proj weights and int8 activations (dynamic per-row
// or calibrated static scales): LN1 → int8 → qkv (rounded to bf16) → RAJNI
// score (or the threaded prev_scores) → top-K selection with CLS forced →
// attention on the kept tokens (output rounded to bf16) → int8 proj → ·ls1 →
// compacted residual. Returns x [B, K, C], next_scores [B, K] and the kept
// indices [B, K].
//
// Replaces the TPU kernel
// rajni_tpu/kernels/block.py:fused_pruned_attn_block_int8 (pallas_call at
// block.py:2616, body _pruned_block_int8_kernel at 2527).
//
// Bound on the H100: operations. At ViT-L/16 (C=1024) batch 256 and
// N=197→K=138 the int8 qkv (at N) and proj (at K) products are ~3.9e11
// operations (~0.2 ms at 1,979 TOP/s) and the attention ~2e10 bf16 FLOP;
// scoring and selection are fp32 CUDA-core work of a few 1e8 operations.
//
// Design: on the caller's stream, the int8 block body's steps (csrc/
// int8_block.cuh) and the shared score and selection kernels (csrc/
// common.cuh), as B14 runs them without its MLP, in six launches (five with
// the threaded scores): LN1 → int8 (per-row scale, or the folded static
// affine; it zeroes the row absmax), the int8 qkv product whose epilogue
// rounds to bf16 into a [B, N, 3C] scratch (block.py:2548), the score kernel
// on that rounded qkv (block.py:2550), the selection kernel, the attention
// reading q/k/v rows through the kept indices
// (common.cuh:launch_attention_any) with a bf16 output and (dynamic) each
// row's absmax, and proj on the row-band GEMM (csrc/band_s8.cuh), which
// quantizes each 128-row band of that output once in shared memory and whose
// residual epilogue reads the pre-norm x rows through the same indices
// (int8_block.cuh:int8_attn_tail; at C = 1280 launch_gemm_s8q:
// TAIL_BAND_MAX_C). band: LN1 and the qkv product as one
// launch of the row-band GEMM's head form, the same bits; it read slower at
// every path shape on the H100, so no path takes it, and it stays as the
// bitwise-checked alternative. two_launch: the old tail with the row
// quantizer between attention and proj. Every route gives the same bits.
// The bf16 attention output is B10's instantiation,
// not B13-B15's fp32 one: the TPU kernel runs _mha_mixed(..., dtype, dtype)
// (block.py:2566), so it rounds the attention output to the activation
// dtype before quantizing it. Under static scales the host always folds
// 1/a_proj into the V columns (block.py:2611-2614), since this kernel's own
// proj undoes it; the scores then come from the pre-scaled V, as on the TPU.
#include "int8_block.cuh"

using namespace rajni;

extern "C" int rajni_pruned_attn_block_int8(
    const void* x, const void* ln1s, const void* ln1b, const void* wqkv, const void* sqkv,
    const void* bqkv, const void* wproj, const void* sproj, const void* bproj, const void* ls1,
    const void* prev_scores, int with_scores, int static_act, int two_launch, int band, void* q8,
    void* qs, void* qkv, void* scores, void* attn, void* amax, void* idx_out, void* ns_out,
    void* out, int B, int N, int K, int C, int H, float scale, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Int8Block p{};
  p.x = static_cast<const bf16*>(x);
  p.ln1s = static_cast<const float*>(ln1s);
  p.ln1b = static_cast<const float*>(ln1b);
  p.wqkv = static_cast<const int8_t*>(wqkv);
  p.sqkv = static_cast<const float*>(sqkv);
  p.bqkv = static_cast<const float*>(bqkv);
  p.wproj = static_cast<const int8_t*>(wproj);
  p.sproj = static_cast<const float*>(sproj);
  p.bproj = static_cast<const float*>(bproj);
  p.ls1 = static_cast<const bf16*>(ls1);
  p.static_act = static_act;
  p.two_launch = two_launch;
  p.amax = static_cast<float*>(amax);
  p.q8 = static_cast<int8_t*>(q8);
  p.qs = static_cast<float*>(qs);
  p.qkv = static_cast<bf16*>(qkv);
  p.B = B;
  p.N = N;
  p.C = C;
  p.H = H;
  p.scale = scale;
  p.eps = eps;
  int rc = band ? int8_block_head<true>(p, st) : int8_block_head(p, st);
  if (rc != 0) return rc;
  const float* s = static_cast<const float*>(prev_scores);
  if (with_scores) {
    cudaError_t e = launch_score(p.qkv, static_cast<float*>(scores), B, N, C, H, 1e-6f, st);
    if (e != cudaSuccess) return fail(e, 3);
    s = static_cast<const float*>(scores);
  }
  cudaError_t e = launch_select(s, static_cast<int*>(idx_out), static_cast<float*>(ns_out), B, N,
                                K, st);
  if (e != cudaSuccess) return fail(e, 4);
  return int8_attn_tail(p, static_cast<const int*>(idx_out), K, static_cast<bf16*>(attn),
                        static_cast<bf16*>(out), st);
}
