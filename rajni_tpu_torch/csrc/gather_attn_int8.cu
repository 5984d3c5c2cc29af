// B13: fused_gather_sdpa_proj_residual_int8 — the pruned attention tail with
// an int8 proj weight: out = gather(x) + ls1·proj(quant(mhsa(gather(qkv))))
// → [B, K, C]. The attention output stays fp32 until it is quantized
// (block.py:1122). Under calibrated static scales the qkv comes from B12 with
// V pre-scaled by 1/a_proj and sproj carries a_proj, so the quantizer only
// rounds and clips.
//
// Replaces the TPU kernel
// rajni_tpu/kernels/block.py:fused_gather_sdpa_proj_residual_int8
// (pallas_call at block.py:1167, body _gather_attn_int8_kernel at 1098).
//
// Bound on the H100: operations (the attention's 4·B·K²·C bf16 FLOP and the
// int8 proj product, 2·B·K·C²).
//
// Design: three launches on the caller's stream, steps 5-7 of the int8 block
// body (csrc/int8.cuh) with the kept indices, as B14 runs them after its
// selection: the TPU kernel gathers with a one-hot [K, N] product, which is
// a gather, so the attention reads q/k/v rows idx[b, t] of qkv (register-
// resident up to ATTN_MAX_N kept tokens, two-pass past that) into fp32, the
// row quantizer, and proj with the residual read through the same indices.
#include "int8.cuh"

using namespace rajni;

extern "C" int rajni_gather_sdpa_proj_residual_int8(
    const void* qkv, const void* idx, const void* x, const void* wproj, const void* sproj,
    const void* bproj, const void* ls1, int static_act, void* attn, void* q8, void* qs,
    void* out, int B, int N, int K, int C, int H, float scale, void* stream) {
  Int8Block p{};
  p.x = static_cast<const bf16*>(x);
  p.wproj = static_cast<const int8_t*>(wproj);
  p.sproj = static_cast<const float*>(sproj);
  p.bproj = static_cast<const float*>(bproj);
  p.ls1 = static_cast<const bf16*>(ls1);
  p.static_act = static_act;
  p.q8 = static_cast<int8_t*>(q8);
  p.qs = static_cast<float*>(qs);
  // the attention only reads qkv; Int8Block holds the pointer B12 writes
  p.qkv = const_cast<bf16*>(static_cast<const bf16*>(qkv));
  p.B = B;
  p.N = N;
  p.C = C;
  p.H = H;
  p.scale = scale;
  return int8_attn_tail(p, static_cast<const int*>(idx), K, static_cast<float*>(attn),
                        static_cast<bf16*>(out), static_cast<cudaStream_t>(stream));
}
