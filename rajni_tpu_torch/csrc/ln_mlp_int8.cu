// B9: fused_ln_mlp_residual_int8 — the MLP half of a block with int8
// weights and int8 activations (dynamic per-row or calibrated static
// scales): out = x + ls2·fc2(quant(gelu_fast(fc1(quant(LN2 x))))).
//
// Replaces the TPU kernel rajni_tpu/kernels/mlp.py:fused_ln_mlp_residual_int8
// (pallas_calls at mlp.py:413, the hidden-chunked body, and 453, the
// resident one), which keeps the [rows, hidden] GELU output in VMEM.
//
// Bound on the H100: operations (two int8 products, 4·rows·C·hidden). Under
// static scales the GELU output does not reach device memory in fp32 (0.91
// GB each way at ViT-B/384 batch 128 and N=577 when it did); in dynamic mode
// it is written once and read once (csrc/int8.cuh:launch_gelu_quant).
//
// Design: steps 8-11 of the int8 block body (csrc/int8.cuh) on the input x
// instead of x_mid, on the caller's stream, the products on the wgmma GEMM:
// LN2 → int8 (per row, or the folded static affine); fc1 with the GELU, its
// output quantized over hc-wide groups of h (dynamic: one row scale a
// group, which is the chunked TPU kernel's numerics,
// _ln_mlp_int8_chunk_kernel); and fc2 flushing each group's int32 sums to
// fp32 times its scale, then the residual. Static mode: three launches, fc1
// multiplying by sinv and rounding in its epilogue. Dynamic mode: five, as a
// row's group absmax spans column tiles: the absmax scratch zeroed, fc1 to
// fp32 h taking each row and group's absmax in its epilogue, the quantizer
// reading h once. hc comes from the port's copy of the JAX rule
// _hidden_chunk.
#include "int8_block.cuh"

using namespace rajni;

extern "C" int rajni_ln_mlp_residual_int8(
    const void* x, const void* ln2s, const void* ln2b, const void* w1, const void* s1,
    const void* b1, const void* w2, const void* s2, const void* b2, const void* ls2,
    const void* sinv, int static_act, int add_residual, void* q8, void* qs, void* h, void* hq,
    void* hs, void* out, int rows, int C, int hidden, int hc, float eps, void* stream) {
  Int8Block p{};
  p.ln2s = static_cast<const float*>(ln2s);
  p.ln2b = static_cast<const float*>(ln2b);
  p.w1 = static_cast<const int8_t*>(w1);
  p.s1 = static_cast<const float*>(s1);
  p.b1 = static_cast<const float*>(b1);
  p.w2 = static_cast<const int8_t*>(w2);
  p.s2 = static_cast<const float*>(s2);
  p.b2 = static_cast<const float*>(b2);
  p.ls2 = static_cast<const bf16*>(ls2);
  p.sinv = static_cast<const float*>(sinv);
  p.static_act = static_act;
  p.q8 = static_cast<int8_t*>(q8);
  p.qs = static_cast<float*>(qs);
  p.h = static_cast<float*>(h);
  p.hq = static_cast<int8_t*>(hq);
  p.hs = static_cast<float*>(hs);
  p.out = static_cast<bf16*>(out);
  p.C = C;
  p.hidden = hidden;
  p.hc = hc;
  p.eps = eps;
  const bf16* xin = static_cast<const bf16*>(x);
  return int8_mlp(p, xin, add_residual ? xin : nullptr, rows, static_cast<cudaStream_t>(stream));
}
