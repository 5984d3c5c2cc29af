// B17: train_ln_mlp — y = x + ls2 * fc2(gelu_fast(h)) with h = round(fc1(LN2(x)))
// stored for the backward; add_residual = 0 returns the branch alone.
//
// Replaces the TPU kernel rajni_tpu/kernels/train.py:train_ln_mlp
// (pallas_call at train.py:388, body _train_ln_mlp_kernel at 173), which
// keeps a 128-token chunk's hidden in VMEM and writes h to HBM beside y.
//
// Bound on the H100: compute. At ViT-B training shapes (batch 128, N=197,
// C=768) fc1+fc2 are 2.4e11 FLOP against ~0.2 GB in and out (x, y, and the
// h the backward reads), above the ~295 FLOP/byte ridge.
//
// Design: K3's three launches (csrc/mlp.cu) with one epilogue changed, both
// products on the wgmma/TMA GEMM of gemm_sm90.cuh. The GELU of the TPU
// kernel runs on the ROUNDED h (train.py:189-191), so that the backward's
// gelu' sees the values the forward used: fc1's EPI_GELU_SAVE epilogue
// rounds acc + b1 to bf16 and stores it to h, then stores gelu_fast of that
// rounded value, rounded, to the hidden that fc2 reads: each 128-byte chunk
// of the tile leaves twice, through the chunk buffers and TMA (h's extra
// store is rows·hidden·2 bytes, 155 MB at batch 128 and N=197, ~0.05 ms at
// 3.35 TB/s). Every GELU input is a bf16 value, and the GELU is computed as
// PyTorch computes kernels/math.py:gelu_fast (gemm_sm90.cuh:gelu_fast_torch),
// so the hidden is PyTorch's GELU of the stored h bit for bit. K3's
// EPI_GELU (the GELU of the fp32 sum) is left as it is. fc2 is K3's
// EPI_RESIDUAL GEMM.
#include "gemm_sm90.cuh"

using namespace rajni;

extern "C" int rajni_train_ln_mlp(const void* x, const void* ln_scale, const void* ln_bias,
                                  const void* w1, const void* b1, const void* w2, const void* b2,
                                  const void* ls, int add_residual, void* y_scratch, void* h_out,
                                  void* hg_scratch, void* out, int rows, int C, int hidden,
                                  float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = launch_layer_norm(static_cast<const bf16*>(x), static_cast<const bf16*>(ln_scale),
                                    static_cast<const bf16*>(ln_bias),
                                    static_cast<bf16*>(y_scratch), rows, C, eps, st);
  if (e != cudaSuccess) return fail(e, 1);

  EpilogueArgs ep1{static_cast<const bf16*>(b1), nullptr, nullptr, nullptr, 1, 1,
                   static_cast<bf16*>(h_out)};
  e = launch_gemm_sm90<EPI_GELU_SAVE>(static_cast<const bf16*>(y_scratch),
                                      static_cast<const bf16*>(w1),
                                      static_cast<bf16*>(hg_scratch), rows, hidden, C, ep1, st);
  if (e != cudaSuccess) return fail(e, 2);

  EpilogueArgs ep2{static_cast<const bf16*>(b2), static_cast<const bf16*>(ls),
                   add_residual ? static_cast<const bf16*>(x) : nullptr, nullptr, 1, 1};
  e = launch_gemm_sm90<EPI_RESIDUAL>(static_cast<const bf16*>(hg_scratch),
                                     static_cast<const bf16*>(w2), static_cast<bf16*>(out), rows,
                                     C, hidden, ep2, st);
  return e == cudaSuccess ? 0 : fail(e, 3);
}
