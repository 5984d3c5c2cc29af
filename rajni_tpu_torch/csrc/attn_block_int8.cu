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
// Design: five launches on the caller's stream, steps 1-2 and 5-7 of the int8
// block body (csrc/int8.cuh): LN1 → int8, the qkv product (bf16 qkv), the
// attention (register-resident up to ATTN_MAX_N tokens, two-pass past that,
// common.cuh:launch_attention_any), the row quantizer, and proj with the
// residual. Unlike B13, B14 and B15, the TPU kernel rounds the attention
// output to the activation dtype before quantizing it (block.py:1255), and a
// quantizer turns that last bit into whole int8 steps: so the attention
// writes bf16 here and the quantizer reads bf16.
#include "int8.cuh"

using namespace rajni;

extern "C" int rajni_attn_block_int8(
    const void* x, const void* ln1s, const void* ln1b, const void* wqkv, const void* sqkv,
    const void* bqkv, const void* wproj, const void* sproj, const void* bproj, const void* ls1,
    int static_act, void* q8, void* qs, void* qkv, void* attn, void* out, int B, int N, int C,
    int H, float scale, float eps, void* stream) {
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
