// B15: fused_block_full_int8 — a whole stock block with int8 weights and
// int8 activations (dynamic per-row or calibrated static scales), bf16
// storage: x + ls1·proj(mhsa(LN1 x)), then + ls2·fc2(gelu(fc1(LN2 ·))).
//
// Replaces the TPU kernel rajni_tpu/kernels/block.py:fused_block_full_int8
// (pallas_call at block.py:2472).
//
// Bound on the H100: operations (four int8 products on the wgmma GEMM); the
// GELU output is quantized in fc1's epilogue under static scales, written
// and read once in fp32 in dynamic mode (csrc/int8.cuh).
//
// Design: seven launches in static mode and nine in dynamic mode on the
// caller's stream (csrc/int8_block.cuh: int8_block_head/_tail without the
// selection): LN1 → int8 (zeroing the attention's row absmax, kept in h's
// first floats), the qkv product (bf16 qkv: B15 does not round qkv itself,
// but its attention casts it to bf16, block.py:284, which is the same), the
// attention with an fp32 output and (dynamic) each row's absmax
// (common.cuh:launch_attention_any), the proj product quantizing that output
// as it loads it, with the residual (int8_block.cuh:int8_attn_tail), LN2 → int8,
// fc1 with its GELU quantized per hc group in the epilogue (dynamic: the
// absmax scratch zeroed, fc1 to fp32 h with the group absmax, then the
// quantizer), and fc2 with the residual. two_launch: the attention tail's
// old route, with the row quantizer before proj.
#include "int8_block.cuh"

using namespace rajni;

extern "C" int rajni_block_full_int8(
    const void* x, const void* ln1s, const void* ln1b, const void* wqkv, const void* sqkv,
    const void* bqkv, const void* wproj, const void* sproj, const void* bproj, const void* ls1,
    const void* ln2s, const void* ln2b, const void* w1, const void* s1, const void* b1,
    const void* w2, const void* s2, const void* b2, const void* ls2, const void* sinv,
    int static_act, int two_launch, void* q8, void* qs, void* qkv, void* attn, void* mid,
    void* h, void* hq, void* hs, void* out, int B, int N, int C, int hidden, int hc, int H,
    float scale, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Int8Block p{
      static_cast<const bf16*>(x),      static_cast<const float*>(ln1s),
      static_cast<const float*>(ln1b),  static_cast<const int8_t*>(wqkv),
      static_cast<const float*>(sqkv),  static_cast<const float*>(bqkv),
      static_cast<const int8_t*>(wproj), static_cast<const float*>(sproj),
      static_cast<const float*>(bproj), static_cast<const bf16*>(ls1),
      static_cast<const float*>(ln2s),  static_cast<const float*>(ln2b),
      static_cast<const int8_t*>(w1),   static_cast<const float*>(s1),
      static_cast<const float*>(b1),    static_cast<const int8_t*>(w2),
      static_cast<const float*>(s2),    static_cast<const float*>(b2),
      static_cast<const bf16*>(ls2),    static_cast<const float*>(sinv),
      static_act,                       static_cast<int8_t*>(q8),
      static_cast<float*>(qs),          static_cast<bf16*>(qkv),
      static_cast<float*>(attn),        static_cast<bf16*>(mid),
      static_cast<float*>(h),           static_cast<int8_t*>(hq),
      static_cast<float*>(hs),          static_cast<bf16*>(out),
      B, N, C, hidden, hc, H, scale, eps};
  p.amax = static_act ? nullptr : p.h;  // the tail's absmax, before step 9 writes h
  p.two_launch = two_launch;
  int rc = int8_block_head(p, st);
  if (rc != 0) return rc;
  return int8_block_tail(p, nullptr, N, st);
}
