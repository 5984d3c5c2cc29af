// The int8 block bodies, cut into the launch steps that each int8 entry
// point runs its share of (B9-B15), on int8.cuh's building blocks, the
// Hopper GEMM (gemm_sm90.cuh) and the row-band GEMM (band_s8.cuh).
#pragma once

#include "band_s8.cuh"

namespace rajni {
namespace {

// ---------------------------------------------------------------------------
// The int8 block bodies. B14 (pruned: idx/ns/scores given) and B15 (stock)
// run every step; the split kernels run parts of them: B12
// fused_ln_qkv_int8 steps 1-3, B10 fused_attn_block_int8 steps 1-2 and 5-7
// (its attention output in bf16), B11 fused_pruned_attn_block_int8 steps
// 1-7 (bf16), B13 fused_gather_sdpa_proj_residual_int8 steps 5-7, B9
// fused_ln_mlp_residual_int8 steps 8-11 on its input x.
// Launch steps (the return code's step, common.cuh:fail):
//   1 LN1 → int8 q8 [B·N, C] (+ row scales qs; dynamic, and zeroes amax)
//   2 qkv = dequant(q8 · Wqkvᵀ) + bqkv → bf16 [B·N, 3C]
//   (int8_block_head<true>, B11's and B12's band switch: 1 alone, the band
//   GEMM's head form: LN1 → int8 made in shared memory and the qkv product
//   in one launch, no q8)
//   3 scores (B14 rescoring, B12; common.cuh:score_kernel)   4 selection (B14)
//   5 attention through the kept indices (B14, B13) → fp32 attn [B·n, C]
//     (B10, B11: bf16), and (dynamic) each row's absmax → amax [B·n]
//   7 proj: A = attn quantized as it is loaded (by amax), dequant + bproj,
//     · ls1, + x (gathered) → bf16 x_mid [B·n, C]
//   (bf16 attn, B10 and B11: 7 on the band GEMM's proj form up to C =
//   TAIL_BAND_MAX_C, A quantized once a band in shared memory; two_launch: 5 without amax, 6 quantize
//   attn per row → q8, qs, 7 proj of q8 by qs: the old route, kept as the
//   new ones' bitwise reference)
//   8 LN2 → int8 q8, qs
//   9 fc1: gelu_fast(dequant + b1); static: · sinv, quantized in its
//     epilogue → hq [B·n, hidden] int8; dynamic: hmax zeroed, then fp32 h
//     [B·n, hidden] with each row and hc chunk's absmax → hmax
//  10 (dynamic) quantize h per row and hc chunk with hmax → hq, hs
//  11 fc2, grouped over hc: dequant · s2 + b2, · ls2, + x_mid → bf16 out
// with n = K (B14, B13) or N (B15, B10). Static mode passes no row scales.
// ---------------------------------------------------------------------------

struct Int8Block {
  const bf16* x;
  const float *ln1s, *ln1b;
  const int8_t* wqkv;
  const float *sqkv, *bqkv;
  const int8_t* wproj;
  const float *sproj, *bproj;
  const bf16* ls1;
  const float *ln2s, *ln2b;
  const int8_t* w1;
  const float *s1, *b1;
  const int8_t* w2;
  const float *s2, *b2;
  const bf16* ls2;
  const float* sinv;
  int static_act;
  // scratch
  int8_t* q8;
  float* qs;
  bf16* qkv;
  float* attn;
  bf16* mid;
  float* h;  // dynamic: the GELU output [B·n, hidden], then its absmax [B·n, hidden / hc]
  int8_t* hq;
  float* hs;
  bf16* out;
  int B, N, C, hidden, hc, H;
  float scale, eps;
  // dynamic: the attention output's row absmax [B·N] (B14, B15: h's first
  // floats, which step 9 overwrites later)
  float* amax;
  int two_launch;  // the attention tail's two-launch route (int8_attn_tail)
  // the attention width: a tensor-parallel shard's H heads (qkv [B·N, 3·Ca],
  // proj [C, Ca]), 0 for the full width C (B12's and B13's shard forms)
  int Ca;
};

// The attention width of p (its qkv is [B·N, 3·attn_width(p)]).
inline int attn_width(const Int8Block& p) { return p.Ca ? p.Ca : p.C; }

// The absmax that the attention tail's dynamic route takes (int8_attn_tail),
// or null.
inline float* tail_amax(const Int8Block& p) {
  return p.static_act || p.two_launch ? nullptr : p.amax;
}

// Steps 1-2: LN1 → int8 and the qkv product; LN1 zeroes the tail's absmax.
// BAND: one launch (step 1) does all three, and writes the row scales qs
// (dynamic) as LN1's launch does.
template <bool BAND = false>
inline int int8_block_head(const Int8Block& p, cudaStream_t st) {
  const int rows = p.B * p.N;
  if constexpr (BAND) {
    if (p.Ca && p.Ca != p.C) return fail(cudaErrorInvalidValue, 1);  // full width only
    BandArgs a{};
    a.a = p.x;
    a.ln_s = p.ln1s;
    a.ln_b = p.ln1b;
    a.eps = p.eps;
    a.qs = p.static_act ? nullptr : p.qs;
    a.zero = tail_amax(p);
    a.w_scale = p.sqkv;
    a.bias = p.bqkv;
    a.M = rows;
    a.N = 3 * p.C;
    a.C = p.C;
    a.static_act = p.static_act;
    const cudaError_t e = launch_band<BAND_HEAD>(a, p.wqkv, p.qkv, st);
    return e == cudaSuccess ? 0 : fail(e, 1);
  }
  const float* dyn = p.static_act ? nullptr : p.qs;
  cudaError_t e = launch_ln_quant(p.x, p.ln1s, p.ln1b, p.q8, p.qs, rows, p.C, p.eps,
                                  p.static_act, st, tail_amax(p));
  if (e != cudaSuccess) return fail(e, 1);
  e = launch_gemm_s8<I8_BIAS>(p.q8, p.wqkv, p.qkv, rows, 3 * attn_width(p), p.C,
                              I8EpilogueArgs{dyn, p.sqkv, p.bqkv, nullptr, nullptr, nullptr, 1, 1,
                                             p.C},
                              st);
  return e == cudaSuccess ? 0 : fail(e, 2);
}

// Steps 5-7, on the kept tokens sel [B, n] (B11, B13, B14) or on all of them
// (sel null, n = N): the attention of p.qkv into attn (fp32, or bf16 for B10
// and B11), and proj with the (gathered) residual p.x into out [B·n, C].
//   A row's dynamic scale is the absmax over its C columns, which span
// every head, and each attention block holds one head. So the attention's
// epilogue takes each row's absmax over its head's columns by atomicMax into
// amax (zeroed by LN1's launch, or by the caller where the tail runs alone:
// B13), exact in any order, and proj quantizes its A operand itself, with
// quant_rows' operations on that absmax: a bf16 A (B10, B11) on the row-band
// GEMM (band_s8.cuh), which quantizes each 128-row band once in shared
// memory; an fp32 one (B13-B15) as it loads it (launch_gemm_s8q): no
// int8 copy of the attention output, and no launch to make one. Static mode needs
// no absmax (the 1/a_proj fold came with V): proj only rounds and clips as it
// loads. p.two_launch runs the old route instead, attention, quant_rows (one
// launch, reading attn twice) and the int8 proj, the new route's bitwise
// reference (the same attention on both).
//   Measured on the H100 (chip_smoke's tail phase): proj quantizing an fp32
// attention output on load (B13-B15) costs about what the int8 proj and the
// quantizer launch cost together; a bf16 one (B10, B11) costs more, since
// each of the N / BN column tiles reads and quantizes the raw A again
// (ROADMAP queue B2), which the band's proj form removes: it read
// 0.70-1.02× launch_gemm_s8q's time at B10's and B11's path shapes. A band form
// for an fp32 A read slower at 9 of B13-B15's 31 shapes and slowed the
// DeiT-S paths end to end, so it was removed and those keep
// launch_gemm_s8q. The attention storing int8 itself under static scales
// (no proj change at all) was tried; B6's body then read 13% slower (ptxas
// serialized its wgmma in those instantiations), more than the quantizer it
// saved.
//
// The widest C whose bf16 proj (B10, B11) runs on the band's PROJ form;
// past it, launch_gemm_s8q. Both are bitwise the two-launch route. Measured
// on the H100 80GB HBM3, 700 W (chip_smoke's "B10 proj" lines, device time,
// dynamic / static): at C <= 1024 the band read 0.70-1.02x gemm_s8q's time
// at B10's and B11's path shapes. At C = 1280 its 160 KB band leaves
// 2 W stages, and a band is one block, so 128·n rows make n bands on 132
// SMs: at B10's ViT-H shapes (B = 128, n = 257, 180, 126, 88, 61) it read
// 0.965 / 0.983, 1.217 / 1.193, 0.882 / 0.901, 0.995 / 1.020 and 1.262 /
// 1.265x gemm_s8q's time (0.2405, 0.1749, 0.1319, 0.1059, 0.0787 ms
// dynamic): over a pruned ViT-H forward's 28 launches 3.991 ms against
// 3.719, so C = 1280 takes gemm_s8q.
constexpr int TAIL_BAND_MAX_C = 1024;

//   A tensor-parallel shard (B13's shard form, p.Ca < p.C) attends over its
// Ca columns and quantizes each row of its attention output over those
// columns alone: the row absmax the attention takes spans this shard's heads
// only, which is JAX's grouped scale (rajni_tpu/parallel/mesh.py:428-435),
// and proj contracts over Ca into the C residual columns.
template <typename AttnT>
inline int int8_attn_tail(const Int8Block& p, const int* sel, int n, AttnT* attn, bf16* out,
                          cudaStream_t st) {
  const int rows_n = p.B * n, Ca = attn_width(p);
  const I8EpilogueArgs proj{p.static_act ? nullptr : p.qs, p.sproj, p.bproj, p.ls1, p.x, sel, n,
                            p.N, Ca};
  float* amax = tail_amax(p);
  if (!p.static_act && !p.two_launch && amax == nullptr) return fail(cudaErrorInvalidValue, 5);
  cudaError_t e =
      launch_attention_any(p.qkv, sel, attn, amax, p.B, p.N, n, Ca, p.H, p.scale, st);
  if (e != cudaSuccess) return fail(e, 5);
  if constexpr (std::is_same_v<AttnT, bf16>) {
    if (!p.two_launch && p.C <= TAIL_BAND_MAX_C && Ca == p.C) {
      BandArgs a{};
      a.a = attn;
      a.amax_in = amax;
      a.w_scale = p.sproj;
      a.bias = p.bproj;
      a.ls = p.ls1;
      a.res = p.x;
      a.res_idx = sel;
      a.rows_out = n;
      a.rows_in = p.N;
      a.M = rows_n;
      a.N = p.C;
      a.C = p.C;
      a.static_act = p.static_act;
      e = launch_band<BAND_PROJ>(a, p.wproj, out, st);
      return e == cudaSuccess ? 0 : fail(e, 7);
    }
  }
  if (!p.two_launch) {
    I8EpilogueArgs ep = proj;
    ep.amax_in = amax;
    e = launch_gemm_s8q(static_cast<const AttnT*>(attn), p.wproj, out, rows_n, p.C, Ca, ep, st);
    return e == cudaSuccess ? 0 : fail(e, 7);
  }
  e = launch_quant_rows(attn, (const float*)nullptr, p.q8, p.qs, rows_n, Ca, Ca, p.static_act,
                        st);
  if (e != cudaSuccess) return fail(e, 6);
  e = launch_gemm_s8<I8_RESIDUAL>(p.q8, p.wproj, out, rows_n, p.C, Ca, proj, st);
  return e == cudaSuccess ? 0 : fail(e, 7);
}

// Steps 8-11 on rows xin [rows, C] → p.out, adding the residual res (xin,
// or null for the branch alone).
inline int int8_mlp(const Int8Block& p, const bf16* xin, const bf16* res, int rows,
                    cudaStream_t st) {
  const float* dyn = p.static_act ? nullptr : p.qs;
  cudaError_t e = launch_ln_quant(xin, p.ln2s, p.ln2b, p.q8, p.qs, rows, p.C, p.eps,
                                  p.static_act, st);
  if (e != cudaSuccess) return fail(e, 8);
  float* hmax = p.static_act ? nullptr : p.h + (size_t)rows * p.hidden;
  const int rc = launch_gelu_quant(
      p.q8, p.w1, p.hq, p.hs, p.h, hmax, rows, p.hidden, p.C,
      I8EpilogueArgs{dyn, p.s1, p.b1, nullptr, nullptr, nullptr, 1, 1, p.C,
                     p.static_act ? p.sinv : nullptr, nullptr, p.hc},
      9, st);
  if (rc != 0) return rc;
  e = launch_gemm_s8<I8_RESIDUAL>(p.hq, p.w2, p.out, rows, p.C, p.hidden,
                                  I8EpilogueArgs{p.static_act ? nullptr : p.hs, p.s2, p.b2, p.ls2,
                                                 res, nullptr, 1, 1, p.hc},
                                  st);
  return e == cudaSuccess ? 0 : fail(e, 11);
}

// Steps 5-11 of B14 and B15.
inline int int8_block_tail(const Int8Block& p, const int* sel, int n, cudaStream_t st) {
  const int rc = int8_attn_tail(p, sel, n, p.attn, p.mid, st);
  if (rc != 0) return rc;
  return int8_mlp(p, p.mid, p.mid, p.B * n, st);
}

}  // namespace
}  // namespace rajni
