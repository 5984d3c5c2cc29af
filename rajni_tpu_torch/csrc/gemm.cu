// The wgmma/TMA GEMM (gemm_sm90.cuh, whose header has the design and the
// bound) behind C entry points of its own, so that it can be held to its
// plain versions (kernels/gemm.py) and timed beside the library's GEMM at
// each product's shapes. No path calls them; the entry points call
// launch_gemm_sm90 and launch_gemm_s8 from their own sources.
//   * rajni_gemm_sm90, bf16 (K1, K2, K3, B4, B5, B17): out[M, N] =
//     epilogue(A[M, K] · W[N, K]ᵀ), epi one of EPI_BIAS, EPI_GELU,
//     EPI_RESIDUAL (ls and res optional; with res_idx, output row r adds
//     residual row (r / rows_out) · rows_in + res_idx[r], the gathered
//     residual of K1 and B5), EPI_GELU_SAVE (aux [M, N]: the rounded h).
//   * rajni_gemm_s8, int8 (B9-B15): epi one of I8_BIAS (bf16 out), I8_GELU
//     (fp32 out), I8_RESIDUAL (bf16 out; grouped over group_k < K with the
//     row scales a [M, K / group_k]; res_idx as above), I8_PARTIAL (I8_BIAS
//     with fp32 out: the tensor-parallel stock blocks' row-parallel proj).
//   * rajni_gelu_quant_s8: fc1 with its GELU quantized per row and hc group
//     into hq [M, N] int8 and (dynamic) hs [M, N / hc], by the route that
//     B9, B14 and B15 run (int8.cuh:launch_gelu_quant) or, with two_launch,
//     by I8_GELU to fp32 h and quant_rows, its yardstick and bitwise
//     reference; scratch: fp32 h [M, N], then the absmax [M, N / hc].
//   * rajni_gemm_s8q: the int8 tails' proj (B10, B11, B13-B15), out[M, N] =
//     I8_RESIDUAL(quant(A) · Wᵀ) with A [M, K] bf16 (a_fp32 = 0) or fp32
//     quantized per row as it is loaded, by amax [M] (each row's absmax) or,
//     with amax null, static (int8.cuh:launch_gemm_s8q).
//   * rajni_band_proj: the row-band GEMM's proj form (band_s8.cuh, B10's and
//     B11's proj), rajni_gemm_s8q's function on a bf16 A (a residual
//     required) with A quantized once a 128-row band; its head form is held
//     through B11's and B12's entry points.
#include "band_s8.cuh"

using namespace rajni;

extern "C" int rajni_gemm_sm90(const void* a, const void* w, void* out, int M, int N, int K,
                               int epi, const void* bias, const void* ls, const void* res,
                               const void* res_idx, int rows_out, int rows_in, void* aux,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* A = static_cast<const bf16*>(a);
  const bf16* W = static_cast<const bf16*>(w);
  bf16* O = static_cast<bf16*>(out);
  const EpilogueArgs ep{static_cast<const bf16*>(bias), static_cast<const bf16*>(ls),
                        static_cast<const bf16*>(res), static_cast<const int*>(res_idx),
                        rows_out, rows_in, static_cast<bf16*>(aux)};
  cudaError_t e = cudaErrorNotSupported;
  switch (epi) {
    case EPI_BIAS: e = launch_gemm_sm90<EPI_BIAS>(A, W, O, M, N, K, ep, st); break;
    case EPI_GELU: e = launch_gemm_sm90<EPI_GELU>(A, W, O, M, N, K, ep, st); break;
    case EPI_RESIDUAL: e = launch_gemm_sm90<EPI_RESIDUAL>(A, W, O, M, N, K, ep, st); break;
    case EPI_GELU_SAVE: e = launch_gemm_sm90<EPI_GELU_SAVE>(A, W, O, M, N, K, ep, st); break;
    default: break;
  }
  return e == cudaSuccess ? 0 : fail(e, 1);
}

extern "C" int rajni_gemm_s8(const void* a, const void* w, void* out, int M, int N, int K,
                             int epi, const void* a_scale, const void* w_scale, const void* bias,
                             const void* ls, const void* res, const void* res_idx, int rows_out,
                             int rows_in, int group_k, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* A = static_cast<const int8_t*>(a);
  const int8_t* W = static_cast<const int8_t*>(w);
  const I8EpilogueArgs ep{static_cast<const float*>(a_scale), static_cast<const float*>(w_scale),
                          static_cast<const float*>(bias),    static_cast<const bf16*>(ls),
                          static_cast<const bf16*>(res),      static_cast<const int*>(res_idx),
                          rows_out,                           rows_in,
                          group_k};
  cudaError_t e = cudaErrorNotSupported;
  switch (epi) {
    case I8_BIAS: e = launch_gemm_s8<I8_BIAS>(A, W, out, M, N, K, ep, st); break;
    case I8_GELU: e = launch_gemm_s8<I8_GELU>(A, W, out, M, N, K, ep, st); break;
    case I8_RESIDUAL: e = launch_gemm_s8<I8_RESIDUAL>(A, W, out, M, N, K, ep, st); break;
    case I8_PARTIAL: e = launch_gemm_s8<I8_PARTIAL>(A, W, out, M, N, K, ep, st); break;
    default: break;
  }
  return e == cudaSuccess ? 0 : fail(e, 1);
}

extern "C" int rajni_gemm_s8q(const void* a, int a_fp32, const void* amax, const void* w,
                              void* out, int M, int N, int K, const void* w_scale,
                              const void* bias, const void* ls, const void* res,
                              const void* res_idx, int rows_out, int rows_in, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* W = static_cast<const int8_t*>(w);
  bf16* O = static_cast<bf16*>(out);
  I8EpilogueArgs ep{nullptr, static_cast<const float*>(w_scale), static_cast<const float*>(bias),
                    static_cast<const bf16*>(ls), static_cast<const bf16*>(res),
                    static_cast<const int*>(res_idx), rows_out, rows_in, K};
  ep.amax_in = static_cast<const float*>(amax);
  const cudaError_t e =
      a_fp32 ? launch_gemm_s8q(static_cast<const float*>(a), W, O, M, N, K, ep, st)
             : launch_gemm_s8q(static_cast<const bf16*>(a), W, O, M, N, K, ep, st);
  return e == cudaSuccess ? 0 : fail(e, 1);
}

extern "C" int rajni_gelu_quant_s8(const void* a, const void* w, void* hq, void* hs,
                                   void* scratch, int M, int N, int K, const void* a_scale,
                                   const void* w_scale, const void* bias, const void* sinv,
                                   int hc, int two_launch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* A = static_cast<const int8_t*>(a);
  const int8_t* W = static_cast<const int8_t*>(w);
  int8_t* Q = static_cast<int8_t*>(hq);
  float* S = static_cast<float*>(hs);
  float* h = static_cast<float*>(scratch);
  const I8EpilogueArgs ep{static_cast<const float*>(a_scale), static_cast<const float*>(w_scale),
                          static_cast<const float*>(bias), nullptr, nullptr, nullptr, 1, 1, K,
                          static_cast<const float*>(sinv), nullptr, hc};
  if (!two_launch) return launch_gelu_quant(A, W, Q, S, h, h + (size_t)M * N, M, N, K, ep, 1, st);
  cudaError_t e = launch_gemm_s8<I8_GELU>(A, W, h, M, N, K, ep, st);
  if (e != cudaSuccess) return fail(e, 1);
  e = launch_quant_rows(static_cast<const float*>(h), ep.sinv, Q, S, M, N, hc, sinv != nullptr,
                        st);
  return e == cudaSuccess ? 0 : fail(e, 2);
}

extern "C" int rajni_band_proj(const void* a, const void* amax, const void* w,
                               void* out, int M, int N, int C, const void* w_scale,
                               const void* bias, const void* ls, const void* res,
                               const void* res_idx, int rows_out, int rows_in, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  BandArgs p{};
  p.a = static_cast<const bf16*>(a);
  p.amax_in = static_cast<const float*>(amax);
  p.w_scale = static_cast<const float*>(w_scale);
  p.bias = static_cast<const float*>(bias);
  p.ls = static_cast<const bf16*>(ls);
  p.res = static_cast<const bf16*>(res);
  p.res_idx = static_cast<const int*>(res_idx);
  p.rows_out = rows_out;
  p.rows_in = rows_in;
  p.M = M;
  p.N = N;
  p.C = C;
  p.static_act = amax == nullptr;
  const cudaError_t e =
      launch_band<BAND_PROJ>(p, static_cast<const int8_t*>(w), static_cast<bf16*>(out), st);
  return e == cudaSuccess ? 0 : fail(e, 1);
}
