// B8: fused_attn_mlp_block — a whole stock block in bf16: K2's attention
// half (LN1, QKV, attention, proj with the residual), then K3's MLP half.
//
// Replaces the TPU kernel rajni_tpu/kernels/block.py:fused_attn_mlp_block
// (pallas_call at block.py:2233). As for B7 (csrc/pruned_block_full.cu), the
// TPU kernel's weight residency has no counterpart in 227 KB of shared
// memory; what it saves beyond that is the [B, N, C] round trip between the
// halves.
//
// Bound on the H100: operations. Numerics: those of K2 + K3, including the
// bf16 rounding at the half boundary (block.py:2179-2180; docstring at
// 2207-2209).
//
// Design: the K2 entry point (csrc/attn_block.cu: four launches; its
// attention the short-row kernel up to ATTN_MAX_N tokens) then the K3 entry
// point (three), on the caller's stream. Return codes: K2's steps 1-4, K3's
// as steps 5-7.

extern "C" int rajni_attn_block(const void* x, const void* ln_scale, const void* ln_bias,
                                const void* wqkv, const void* bqkv, const void* wproj,
                                const void* bproj, const void* ls, void* y_scratch,
                                void* qkv_scratch, void* attn_scratch, void* out, int B, int N,
                                int C, int H, float scale, float eps, void* stream);
extern "C" int rajni_ln_mlp_residual(
    const void* x, const void* ln_scale, const void* ln_bias, const void* w1, const void* b1,
    const void* w2, const void* b2, const void* ls, int add_residual, void* y_scratch,
    void* h_scratch, void* out, int rows, int C, int hidden, float eps, void* stream);

extern "C" int rajni_attn_mlp_block(
    const void* x, const void* ln1s, const void* ln1b, const void* wqkv, const void* bqkv,
    const void* wproj, const void* bproj, const void* ls1, const void* ln2s, const void* ln2b,
    const void* w1, const void* b1, const void* w2, const void* b2, const void* ls2,
    void* y_scratch, void* qkv_scratch, void* attn_scratch, void* mid_scratch, void* h_scratch,
    void* out, int B, int N, int C, int hidden, int H, float scale, float eps, void* stream) {
  int rc = rajni_attn_block(x, ln1s, ln1b, wqkv, bqkv, wproj, bproj, ls1, y_scratch, qkv_scratch,
                            attn_scratch, mid_scratch, B, N, C, H, scale, eps, stream);
  if (rc != 0) return rc;
  rc = rajni_ln_mlp_residual(mid_scratch, ln2s, ln2b, w1, b1, w2, b2, ls2, 1, y_scratch,
                             h_scratch, out, B * N, C, hidden, eps, stream);
  return rc == 0 ? 0 : rc + 4000;
}
