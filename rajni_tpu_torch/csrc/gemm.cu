// The wgmma/TMA GEMM of K1, K2, K3, B4 and B5 (gemm_sm90.cuh, whose header
// has the design and the bound) behind a C entry point of its own, so that
// it can be held to its plain version (kernels/gemm.py:gemm_plain) and timed
// beside the library's GEMM at each product's shapes: out[M, N] =
// epilogue(A[M, K] · W[N, K]ᵀ), epi one of EPI_BIAS, EPI_GELU, EPI_RESIDUAL
// (ls and res optional; with res_idx, output row r adds residual row
// (r / rows_out) · rows_in + res_idx[r], the gathered residual of K1 and B5).
// No path calls it; the entry points call launch_gemm_sm90 from their own
// sources.
#include "gemm_sm90.cuh"

using namespace rajni;

extern "C" int rajni_gemm_sm90(const void* a, const void* w, void* out, int M, int N, int K,
                               int epi, const void* bias, const void* ls, const void* res,
                               const void* res_idx, int rows_out, int rows_in, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* A = static_cast<const bf16*>(a);
  const bf16* W = static_cast<const bf16*>(w);
  bf16* O = static_cast<bf16*>(out);
  const EpilogueArgs ep{static_cast<const bf16*>(bias), static_cast<const bf16*>(ls),
                        static_cast<const bf16*>(res), static_cast<const int*>(res_idx),
                        rows_out, rows_in, nullptr};
  cudaError_t e = cudaErrorNotSupported;  // EPI_GELU_SAVE and anything else
  switch (epi) {
    case EPI_BIAS: e = launch_gemm_sm90<EPI_BIAS>(A, W, O, M, N, K, ep, st); break;
    case EPI_GELU: e = launch_gemm_sm90<EPI_GELU>(A, W, O, M, N, K, ep, st); break;
    case EPI_RESIDUAL: e = launch_gemm_sm90<EPI_RESIDUAL>(A, W, O, M, N, K, ep, st); break;
    default: break;
  }
  return e == cudaSuccess ? 0 : fail(e, 1);
}
