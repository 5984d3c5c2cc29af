// B14: fused_pruned_block_full_int8 — a whole pruned block with int8 weights
// (qkv, proj, fc1, fc2 as {int8 [out, in], scale [out]}) and int8
// activations, quantized per row (dynamic) or with calibrated static scales
// folded on the host; bf16 storage. Returns x [B, K, C], next_scores [B, K]
// and the kept indices [B, K].
//
// Replaces the TPU kernel
// rajni_tpu/kernels/block.py:fused_pruned_block_full_int8 (pallas_call at
// block.py:1865), which keeps the block's int8 weights (7.1 MB at ViT-B) in
// VMEM and its fp32 intermediates with them.
//
// Bound on the H100: operations (four int8 products on the wgmma GEMM). The
// GELU output between fc1 and fc2 (0.62 GB in fp32 at ViT-B batch 256 and
// N=197) is quantized in fc1's epilogue under static scales; in dynamic
// mode it is written in fp32 once and read once (csrc/int8.cuh).
//
// Design: nine launches in static mode and eleven in dynamic mode on the
// caller's stream (csrc/int8_block.cuh: int8_block_head/_tail): LN1 → int8
// (zeroing the attention's row absmax, kept in h's first floats), the qkv
// product (bf16 qkv), the score kernel shared with K1 and B4 (skipped when
// the threaded scores are used), the selection kernel shared with K1, the
// attention through the kept indices with an fp32 output and (dynamic) each
// row's absmax (common.cuh:launch_attention_any), the proj product
// quantizing that output as it loads it, with the gathered residual (bf16
// x_mid; int8_block.cuh:int8_attn_tail; two_launch: the old route, with the row
// quantizer before proj), LN2 → int8, fc1 with its GELU quantized per hc group in the epilogue
// (dynamic: the absmax scratch zeroed, fc1 to fp32 h with the group absmax,
// then the quantizer), and the fc2 product that adds the groups in fp32 and
// the x_mid residual.
#include "int8_block.cuh"

using namespace rajni;

extern "C" int rajni_pruned_block_full_int8(
    const void* x, const void* ln1s, const void* ln1b, const void* wqkv, const void* sqkv,
    const void* bqkv, const void* wproj, const void* sproj, const void* bproj, const void* ls1,
    const void* ln2s, const void* ln2b, const void* w1, const void* s1, const void* b1,
    const void* w2, const void* s2, const void* b2, const void* ls2, const void* sinv,
    const void* prev_scores, int with_scores, int static_act, int two_launch, void* q8,
    void* qs, void* qkv, void* scores, void* attn, void* mid, void* h, void* hq, void* hs,
    void* idx_out, void* ns_out, void* out, int B, int N, int K, int C, int hidden, int hc, int H,
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
  const float* s = static_cast<const float*>(prev_scores);
  if (with_scores) {
    // scores from the bf16-rounded qkv (block.py:1644); under static scales
    // its V columns carry the 1/a_proj fold, so near-tied ranks may differ
    // from the dynamic path (math.py:68-71), as on the TPU
    cudaError_t e = launch_score(p.qkv, static_cast<float*>(scores), B, N, C, H, 1e-6f, st);
    if (e != cudaSuccess) return fail(e, 3);
    s = static_cast<const float*>(scores);
  }
  cudaError_t e = launch_select(s, static_cast<int*>(idx_out), static_cast<float*>(ns_out), B, N,
                                K, st);
  if (e != cudaSuccess) return fail(e, 4);
  return int8_block_tail(p, static_cast<const int*>(idx_out), K, st);
}
