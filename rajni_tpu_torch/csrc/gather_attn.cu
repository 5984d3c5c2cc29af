// B5: fused_gather_sdpa_proj_residual — the pruned attention tail:
// out = gather(x) + ls1 * proj(mhsa(gather(qkv))) → [B, K, C].
//
// Replaces the TPU kernel rajni_tpu/kernels/block.py:
// fused_gather_sdpa_proj_residual (pallas_calls at block.py:1017, the fast
// body, and 1056, the query-chunked body for long sequences).
//
// Bound on the H100: compute. At batch 128 and N=577→K=548 (ViT-B/384) the
// attention is 1.2e11 FLOP and proj 8.3e10, against ~0.4 GB of kept qkv and
// x rows in and the [B, K, C] out.
//
// Design: two launches on the caller's stream. The TPU kernel gathers with a
// one-hot [K, N] product; since sel is 0/1 that product IS a gather, so both
// launches read through the kept indices idx [B, K] instead:
// * the attention reads q/k/v rows idx[b, t] of qkv [B, N, 3C] — the
//   short-row kernel up to ATTN_MAX_N kept tokens, B6's wgmma body past that
//   (common.cuh:launch_attention_any);
// * proj on the wgmma/TMA GEMM of gemm_sm90.cuh with the
//   +bias→·ls→+x(fp32)→round epilogue, reading the pre-norm x rows through
//   the same indices (res_idx, by cp.async, as K1 does).
// Tensor-parallel shard form (rajni_tpu/parallel/mesh.py:tp_pallas_forward):
// the attention width Ca (this shard's H heads, qkv [B, N, 3·Ca]) is apart
// from the residual width C, and proj is the row-parallel product [B·K, Ca]
// · wproj[C, Ca]ᵀ. The caller passes a zero residual and a zero bias, as the
// TPU kernel's caller does, and gets this shard's partial sum; Ca == C is the
// full-width kernel.
#include "gemm_sm90.cuh"

using namespace rajni;

extern "C" int rajni_gather_sdpa_proj_residual(const void* qkv, const void* idx, const void* x,
                                               const void* wproj, const void* bproj,
                                               const void* ls, void* attn_scratch, void* out,
                                               int B, int N, int K, int C, int Ca, int H,
                                               float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = launch_attention_any(static_cast<const bf16*>(qkv),
                                       static_cast<const int*>(idx),
                                       static_cast<bf16*>(attn_scratch), nullptr, B, N, K, Ca, H,
                                       scale, st);
  if (e != cudaSuccess) return fail(e, 1);

  EpilogueArgs ep{static_cast<const bf16*>(bproj), static_cast<const bf16*>(ls),
                  static_cast<const bf16*>(x), static_cast<const int*>(idx), K, N};
  e = launch_gemm_sm90<EPI_RESIDUAL>(static_cast<const bf16*>(attn_scratch),
                                     static_cast<const bf16*>(wproj), static_cast<bf16*>(out),
                                     B * K, C, Ca, ep, st);
  return e == cudaSuccess ? 0 : fail(e, 2);
}
