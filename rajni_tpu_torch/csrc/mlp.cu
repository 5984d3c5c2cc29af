// K3: fused_ln_mlp_residual — out = x + ls * fc2(gelu_fast(fc1(LN(x)))).
//
// Replaces the TPU kernel rajni_tpu/kernels/mlp.py:fused_ln_mlp_residual
// (pallas_call at mlp.py:172), which keeps the [rows, 4C] hidden in VMEM.
//
// Bound on the H100: compute. At batch 256 and N=197, fc1+fc2 are
// 4.8e11 FLOP against 15 MB of weights and 155 MB of activations in and out,
// far above the ~295 FLOP/byte ridge.
//
// Design: three launches on the caller's stream — row LayerNorm (bf16 out),
// fc1 with a +bias→gelu_fast→round epilogue, fc2 with a
// +bias→·ls→+x(fp32)→round epilogue, both products on the wgmma/TMA GEMM of
// gemm_sm90.cuh (persistent, warp-specialized, 128x256 tiles; its header has
// the design). The hidden [rows, 4C] bf16 goes through device memory
// (2·rows·4C·2 bytes extra traffic, ~620 MB at batch 256, N=197, ~0.19 ms at
// 3.35 TB/s); keeping it on chip is a later change.
#include "gemm_sm90.cuh"

using namespace rajni;

extern "C" int rajni_ln_mlp_residual(
    const void* x, const void* ln_scale, const void* ln_bias, const void* w1, const void* b1,
    const void* w2, const void* b2, const void* ls, int add_residual, void* y_scratch,
    void* h_scratch, void* out, int rows, int C, int hidden, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = launch_layer_norm(static_cast<const bf16*>(x), static_cast<const bf16*>(ln_scale),
                                    static_cast<const bf16*>(ln_bias),
                                    static_cast<bf16*>(y_scratch), rows, C, eps, st);
  if (e != cudaSuccess) return fail(e, 1);

  EpilogueArgs ep1{static_cast<const bf16*>(b1), nullptr, nullptr, nullptr, 1, 1};
  e = launch_gemm_sm90<EPI_GELU>(static_cast<const bf16*>(y_scratch),
                                 static_cast<const bf16*>(w1), static_cast<bf16*>(h_scratch),
                                 rows, hidden, C, ep1, st);
  if (e != cudaSuccess) return fail(e, 2);

  EpilogueArgs ep2{static_cast<const bf16*>(b2), static_cast<const bf16*>(ls),
                   add_residual ? static_cast<const bf16*>(x) : nullptr, nullptr, 1, 1};
  e = launch_gemm_sm90<EPI_RESIDUAL>(static_cast<const bf16*>(h_scratch),
                                     static_cast<const bf16*>(w2), static_cast<bf16*>(out), rows,
                                     C, hidden, ep2, st);
  return e == cudaSuccess ? 0 : fail(e, 3);
}

// The library's one error-string export, for every entry point's return code.
extern "C" const char* rajni_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
