// B6: fused_sdpa — multi-head self-attention on packed qkv [B, N, 3C] →
// [B, N, C], the "per-head" form: logits (q·kᵀ) * scale in fp32, softmax in
// fp32, P normalized then rounded to bf16, P·V in fp32.
//
// Replaces the TPU kernel rajni_tpu/kernels/attention.py:fused_sdpa
// (pallas_call at attention.py:88), which holds one image's qkv and one
// head's [N, N] fp32 logits in VMEM.
//
// Bound on the H100: operations. At batch 128, N=577, C=768 the two products
// are 1.3e11 FLOP against ~0.45 GB of qkv in and out.
//
// Design: one launch of the two-pass kernel (common.cuh:sdpa_kernel): one
// block per (head, image) with K and Vᵀ in shared memory, the logits
// computed once for the row max and sum and once more for P·V, so that P is
// normalized before it is rounded. N <= SDPA_MAX_N = 848, head_dim 64.
#include "common.cuh"

using namespace rajni;

extern "C" int rajni_sdpa(const void* qkv, void* out, int B, int N, int C, int H, float scale,
                          void* stream) {
  cudaError_t e = launch_sdpa(static_cast<const bf16*>(qkv), nullptr, static_cast<bf16*>(out), B,
                              N, N, C, H, scale, static_cast<cudaStream_t>(stream));
  return e == cudaSuccess ? 0 : fail(e, 1);
}
