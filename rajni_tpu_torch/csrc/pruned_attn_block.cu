// K1: fused_pruned_attn_block — the pruned attention half of a RAJNI block:
// LN1 → QKV → RAJNI score (or the threaded prev_scores) → top-K selection with
// CLS forced → gather of QKV and of the pre-norm x → SDPA on the K kept tokens
// → proj → ·ls1 → compacted residual. Returns x [B, K, C], next_scores [B, K]
// and the kept indices [B, K].
//
// Replaces the TPU kernel rajni_tpu/kernels/block.py:fused_pruned_attn_block
// (pallas_call at block.py:1553), with its helpers _importance_f32
// (block.py:340, common.cuh:score_kernel) and _select_from_scores
// (block.py:722, common.cuh:select_kernel). The same entry point also
// replaces B20, rajni_tpu/kernels/longseq.py:fused_pruned_attn_block_long
// (pallas_call at longseq.py:306): the same function at any N up to
// SDPA_MAX_N. That kernel's 128-row token chunking is a VMEM device and is
// not carried over; its wrapper (kernels/longseq.py) admits the longer N and
// counts its own launches.
//
// Bound on the H100: compute. At batch 256, N=197→K=187 the QKV (at N),
// proj (at K) and attention (at K) products are ~2.6e11 FLOP; scoring reads
// the k and v rows once (0.16 GB) and selection is ~1e7 compares.
//
// Design: six launches on the caller's stream — row LayerNorm, QKV
// (+bias→round) into a [B, N, 3C] device scratch, the score kernel shared
// with B4 (common.cuh:score_kernel: a cluster of blocks per image over token
// ranges; skipped when the threaded scores are used), the selection kernel
// (one block per image), the shared attention kernel reading q/k/v rows
// through the kept indices (a gather is exactly what the TPU kernel's one-hot
// product computes, since sel is 0/1; the short-row kernel up to ATTN_MAX_N
// kept tokens, B6's wgmma body past that), and proj whose residual epilogue reads
// the pre-norm x rows through the same indices. Both products run on the
// wgmma/TMA GEMM of gemm_sm90.cuh (its header has the design), the gathered
// residual by cp.async.
#include "gemm_sm90.cuh"

using namespace rajni;

extern "C" int rajni_pruned_attn_block(
    const void* x, const void* ln_scale, const void* ln_bias, const void* wqkv, const void* bqkv,
    const void* wproj, const void* bproj, const void* ls, const void* prev_scores,
    int with_scores, void* y_scratch, void* qkv_scratch, void* scores_scratch,
    void* attn_scratch, void* idx_out, void* ns_out, void* out, int B, int N, int K, int C,
    int H, float scale, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = launch_layer_norm(static_cast<const bf16*>(x), static_cast<const bf16*>(ln_scale),
                                    static_cast<const bf16*>(ln_bias),
                                    static_cast<bf16*>(y_scratch), B * N, C, eps, st);
  if (e != cudaSuccess) return fail(e, 1);

  EpilogueArgs ep1{static_cast<const bf16*>(bqkv), nullptr, nullptr, nullptr, 1, 1};
  e = launch_gemm_sm90<EPI_BIAS>(static_cast<const bf16*>(y_scratch),
                                 static_cast<const bf16*>(wqkv), static_cast<bf16*>(qkv_scratch),
                                 B * N, 3 * C, C, ep1, st);
  if (e != cudaSuccess) return fail(e, 2);

  const float* scores = static_cast<const float*>(prev_scores);
  if (with_scores) {
    e = launch_score(static_cast<const bf16*>(qkv_scratch), static_cast<float*>(scores_scratch),
                     B, N, C, H, 1e-6f, st);
    if (e != cudaSuccess) return fail(e, 3);
    scores = static_cast<const float*>(scores_scratch);
  }

  e = launch_select(scores, static_cast<int*>(idx_out), static_cast<float*>(ns_out), B, N, K, st);
  if (e != cudaSuccess) return fail(e, 4);

  e = launch_attention_any(static_cast<const bf16*>(qkv_scratch),
                           static_cast<const int*>(idx_out), static_cast<bf16*>(attn_scratch),
                           nullptr, B, N, K, C, H, scale, st);
  if (e != cudaSuccess) return fail(e, 5);

  EpilogueArgs ep2{static_cast<const bf16*>(bproj), static_cast<const bf16*>(ls),
                   static_cast<const bf16*>(x), static_cast<const int*>(idx_out), K, N};
  e = launch_gemm_sm90<EPI_RESIDUAL>(static_cast<const bf16*>(attn_scratch),
                                     static_cast<const bf16*>(wproj), static_cast<bf16*>(out),
                                     B * K, C, C, ep2, st);
  return e == cudaSuccess ? 0 : fail(e, 6);
}
