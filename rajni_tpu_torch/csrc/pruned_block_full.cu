// B7: fused_pruned_block_full — a whole pruned block in bf16: K1's
// attention half (LN1, QKV, scores or the threaded prev_scores, selection,
// attention through the kept indices, proj with the gathered residual),
// then K3's MLP half (LN2, fc1 with the GELU epilogue, fc2 with the residual)
// on the kept tokens. Returns x [B, K, C], next_scores [B, K] and the kept
// indices [B, K].
//
// Replaces the TPU kernel rajni_tpu/kernels/block.py:fused_pruned_block_full
// (pallas_call at block.py:2102), which exists to keep all of a block's
// weights in VMEM. At DeiT-S width (C=384) those are 3.5 MB of bf16, and an
// SM has 227 KB of shared memory, so nothing of that carries over; what the
// TPU kernel saves beyond that is the [B, K, C] round trip between the two
// halves (x_mid, written by the proj GEMM and read by LN2 and the fc2
// epilogue): about 21 us of device-memory time a block at DeiT-S batch 256.
//
// Bound on the H100: operations (the four products). Numerics: those of K1
// + K3, including the bf16 rounding of x_mid at the half boundary
// (block.py:2016-2017).
//
// Design: one entry point composed of the port's existing launches — the
// K1 entry point (csrc/pruned_attn_block.cu: six launches) and the K3 entry
// point (csrc/mlp.cu: three), on the caller's stream. Return codes: K1's
// steps 1-6, K3's as steps 7-9.

extern "C" int rajni_pruned_attn_block(
    const void* x, const void* ln_scale, const void* ln_bias, const void* wqkv, const void* bqkv,
    const void* wproj, const void* bproj, const void* ls, const void* prev_scores,
    int with_scores, void* y_scratch, void* qkv_scratch, void* scores_scratch,
    void* attn_scratch, void* idx_out, void* ns_out, void* out, int B, int N, int K, int C,
    int H, float scale, float eps, void* stream);
extern "C" int rajni_ln_mlp_residual(
    const void* x, const void* ln_scale, const void* ln_bias, const void* w1, const void* b1,
    const void* w2, const void* b2, const void* ls, int add_residual, void* y_scratch,
    void* h_scratch, void* out, int rows, int C, int hidden, float eps, void* stream);

extern "C" int rajni_pruned_block_full(
    const void* x, const void* ln1s, const void* ln1b, const void* wqkv, const void* bqkv,
    const void* wproj, const void* bproj, const void* ls1, const void* ln2s, const void* ln2b,
    const void* w1, const void* b1, const void* w2, const void* b2, const void* ls2,
    const void* prev_scores, int with_scores, void* y_scratch, void* qkv_scratch,
    void* scores_scratch, void* attn_scratch, void* idx_out, void* ns_out, void* mid_scratch,
    void* h_scratch, void* out, int B, int N, int K, int C, int hidden, int H, float scale,
    float eps, void* stream) {
  int rc = rajni_pruned_attn_block(x, ln1s, ln1b, wqkv, bqkv, wproj, bproj, ls1, prev_scores,
                                   with_scores, y_scratch, qkv_scratch, scores_scratch,
                                   attn_scratch, idx_out, ns_out, mid_scratch, B, N, K, C, H,
                                   scale, eps, stream);
  if (rc != 0) return rc;
  // y_scratch [B·N, C] is free again: LN2 of the B·K kept rows goes there
  rc = rajni_ln_mlp_residual(mid_scratch, ln2s, ln2b, w1, b1, w2, b2, ls2, 1, y_scratch,
                             h_scratch, out, B * K, C, hidden, eps, stream);
  return rc == 0 ? 0 : rc + 6000;
}
