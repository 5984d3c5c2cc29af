// B10: fused_attn_block_int8 — the attention half of a stock block with int8
// qkv and proj weights and int8 activations (dynamic per-row or calibrated
// static scales): out = x + ls1·proj(quant(mhsa(qkv(quant(LN1 x))))).
//
// Replaces the TPU kernel rajni_tpu/kernels/block.py:fused_attn_block_int8
// (pallas_call at block.py:1304, body _attn_block_int8_kernel at 1240).
//
// Bound on the H100: operations (the int8 qkv and proj products, 8·B·N·C²,
// and the attention's 4·B·N²·C bf16 FLOP).
//
// Design: four launches on the caller's stream, steps 1-2 and 5-7 of the int8
// block body (csrc/int8_block.cuh): LN1 → int8 (which also zeroes the row absmax),
// the qkv product (bf16 qkv), the attention (common.cuh:launch_attention_any:
// the short-row kernel up to 256 tokens, B6's wgmma body past them), which in
// dynamic mode also takes each row's absmax, and
// proj on the row-band GEMM (csrc/band_s8.cuh), which quantizes each
// 128-row band of the attention output once in shared memory, with the
// residual (int8_block.cuh:int8_attn_tail says why; at ViT-H/14's C = 1280
// proj quantizes as it loads, launch_gemm_s8q: TAIL_BAND_MAX_C). Unlike B13, B14 and B15, the
// TPU kernel rounds the attention output to the activation dtype before
// quantizing it (block.py:1255), and a quantizer turns that last bit into
// whole int8 steps: so the attention writes bf16 here and proj reads bf16.
// two_launch: the old tail (attention, row quantizer, int8 proj), five
// launches, the bitwise reference of the new one.
#include "int8_block.cuh"

using namespace rajni;

extern "C" int rajni_attn_block_int8(
    const void* x, const void* ln1s, const void* ln1b, const void* wqkv, const void* sqkv,
    const void* bqkv, const void* wproj, const void* sproj, const void* bproj, const void* ls1,
    int static_act, int two_launch, void* q8, void* qs, void* qkv, void* attn, void* amax,
    void* out, int B, int N, int C, int H, float scale, float eps, void* stream) {
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
  const int rc = int8_block_head(p, st);
  if (rc != 0) return rc;
  return int8_attn_tail(p, nullptr, N, static_cast<bf16*>(attn), static_cast<bf16*>(out), st);
}
