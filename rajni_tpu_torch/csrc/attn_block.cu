// K2: fused_attn_block — out = x + ls1 * proj(mhsa(qkv(LN1(x)))).
//
// Replaces the TPU kernel rajni_tpu/kernels/block.py:fused_attn_block
// (pallas_call at block.py:573), which holds a whole image, its QKV and all
// the weights in VMEM.
//
// Bound on the H100: compute. At batch 256 and N=197 the QKV and proj
// products are 2.4e11 FLOP and the attention 3.1e10; the data are ~80 MB.
//
// Design: four launches on the caller's stream — row LayerNorm (bf16 out),
// QKV with a +bias→round epilogue into a [B, N, 3C] bf16 scratch in device
// memory (one image's QKV, 0.9 MB, does not fit a block's 227 KB of shared
// memory), the attention kernel, and proj with a +bias→·ls→+x(fp32)→round
// epilogue; both products on the wgmma/TMA GEMM of gemm_sm90.cuh (its header
// has the design). Up to ATTN_MAX_N = 256 tokens the attention is the
// register-resident kernel (one block per image, head and 64-query tile: K
// and Vᵀ of the head in shared memory, each warp's whole logit rows in
// mma.sync accumulator registers); past that, B6's wgmma body (sdpa.cu,
// N <= SDPA_MAX_N = 848).
#include "gemm_sm90.cuh"

using namespace rajni;

extern "C" int rajni_attn_block(const void* x, const void* ln_scale, const void* ln_bias,
                                const void* wqkv, const void* bqkv, const void* wproj,
                                const void* bproj, const void* ls, void* y_scratch,
                                void* qkv_scratch, void* attn_scratch, void* out, int B, int N,
                                int C, int H, float scale, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = B * N;
  cudaError_t e = launch_layer_norm(static_cast<const bf16*>(x), static_cast<const bf16*>(ln_scale),
                                    static_cast<const bf16*>(ln_bias),
                                    static_cast<bf16*>(y_scratch), rows, C, eps, st);
  if (e != cudaSuccess) return fail(e, 1);

  EpilogueArgs ep1{static_cast<const bf16*>(bqkv), nullptr, nullptr, nullptr, 1, 1};
  e = launch_gemm_sm90<EPI_BIAS>(static_cast<const bf16*>(y_scratch),
                                 static_cast<const bf16*>(wqkv), static_cast<bf16*>(qkv_scratch),
                                 rows, 3 * C, C, ep1, st);
  if (e != cudaSuccess) return fail(e, 2);

  e = launch_attention_any(static_cast<const bf16*>(qkv_scratch), nullptr,
                           static_cast<bf16*>(attn_scratch), B, N, N, C, H, scale, st);
  if (e != cudaSuccess) return fail(e, 3);

  EpilogueArgs ep2{static_cast<const bf16*>(bproj), static_cast<const bf16*>(ls),
                   static_cast<const bf16*>(x), nullptr, 1, 1};
  e = launch_gemm_sm90<EPI_RESIDUAL>(static_cast<const bf16*>(attn_scratch),
                                     static_cast<const bf16*>(wproj), static_cast<bf16*>(out),
                                     rows, C, C, ep2, st);
  return e == cudaSuccess ? 0 : fail(e, 4);
}
