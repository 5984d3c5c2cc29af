// Int8 building blocks of the int8 kernels: the whole blocks (B14
// fused_pruned_block_full_int8, B15 fused_block_full_int8) and the split
// kernels (B9 fused_ln_mlp_residual_int8, B10 fused_attn_block_int8, B12
// fused_ln_qkv_int8, B13 fused_gather_sdpa_proj_residual_int8): LayerNorm
// quantized straight to int8, a quantizer for fp32 or bf16 rows, and the
// int8 GEMM (gemm_sm90.cuh's kernel with the dequantizing epilogues below,
// fc1's GELU quantized in its epilogue). The block body, cut into steps that
// each entry point runs its share of, is int8_block.cuh.
//
// Numeric contract (block.py:1609-1710 and 2279-2371, and the plain versions
// in rajni_tpu_torch/kernels/wholeblock.py):
//  * Rounded to bf16: qkv (B14 rounds it before scoring, block.py:1644; B15's
//    attention casts it, :284, which is the same) and x_mid, the residual
//    stream between the two halves (:1673-1675, 2337-2339).
//  * NOT rounded, fp32 until quantized: the LayerNorm outputs (:1640, 1680,
//    2324, 2341), the GELU output h (:1692, 2353) and the attention output
//    (_mha_mixed(..., float32), :1663, 2329; B13 the same, :1122). Every
//    other launch of the port writes bf16; these write int8 (LayerNorm,
//    and fc1's GELU under static scales, quantized where they are
//    computed) or fp32 (attention, fc1's GELU under dynamic scales). The one exception is B10, whose TPU kernel
//    rounds its attention output to the activation dtype before quantizing
//    it (_mha_mixed(..., x_ref.dtype, ...), :1255): its attention writes
//    bf16 and its quantizer reads bf16.
//  * Dynamic quantization is per row: absmax floored at 1e-8, then
//    rint(y * (127 / absmax)), clipped to ±127, with the row scale
//    absmax * (1/127). The reciprocal multiply, not y / scale (the two
//    differ by one on ties, math.py:25-31), and rint (half to even, as
//    jnp.round), never roundf.
//  * Static quantization: the 1/a factors are folded on the host, in fp32,
//    into the LayerNorm affine (qkv and fc1 inputs), the V columns of the
//    qkv weight scales and bias (attention output) and a [hidden] row sinv
//    (h); the kernels only multiply by sinv, round and clip. The a dequant
//    factors are folded into the weight-scale rows.
//  * The GEMM accumulates exactly in int32 and dequantizes as
//    (float)acc * a_row * w_col + bias, the order of _int8_matmul
//    (block.py:1214-1237). fc2 quantizes h in hc-wide groups, each with its
//    own row scale: the int32 sum of each group is flushed to fp32 once,
//    times that group's scale, and the groups are added in fp32 (:1686-1710).
//    hc is numerics, not tiling: it comes from the plan per call.
//  * The epilogue's and quantizers' products and sums use the _rn
//    intrinsics, so nvcc does not contract them into FMAs that the plain
//    version does not make.
//
// Bound on the H100: operations for the products (int8 tensor cores at
// twice the bf16 rate). Under static scales fc1's GELU output never reaches
// device memory in fp32: it is quantized in fc1's epilogue. In dynamic mode
// the absmax of a row's hc group spans column tiles, so h is written in fp32
// once and read once by its quantizer (launch_gelu_quant says why). The
// attention output is written once (bf16 or fp32) and read once, by proj,
// which quantizes it as it loads it (int8_attn_tail says how).
#pragma once

#include "gemm_sm90.cuh"

namespace rajni {
namespace {

// Round half to even, clip to ±127.
__device__ __forceinline__ int quant1(float v) {
  return (int)fminf(fmaxf(rintf(v), -127.f), 127.f);
}

__device__ __forceinline__ uint32_t pack4_s8(int a, int b, int c, int d) {
  return (uint32_t)(uint8_t)(int8_t)a | ((uint32_t)(uint8_t)(int8_t)b << 8) |
         ((uint32_t)(uint8_t)(int8_t)c << 16) | ((uint32_t)(uint8_t)(int8_t)d << 24);
}

constexpr float INV127 = (float)(1.0 / 127.0);

// ---------------------------------------------------------------------------
// LayerNorm → int8: one warp per row, the row in registers, NV vectors of 8
// elements a lane: LN_MAXV up to C = 1024, LN_MAXV_WIDE past it, to C = 1280
// (ViT-H/14), as common.cuh's bf16 layer_norm_kernel. The fp32 LN output is
// quantized where it is computed and never stored.
// Dynamic: per-row scale to a_out[row]; static (static_act): the affine
// carries the 1/a fold, so the kernel only rounds and clips.
//   The statistics are fp32 sums in a fixed order, each operation an
// explicit _rn intrinsic: lane l adds its elements 8c..8c+7 of chunks c = l,
// l + 32, ... in turn, the warp's xor butterfly adds the lanes, mean =
// sum / C, rstd = 1 / sqrt(var / C + eps) correctly rounded. The plain version
// (kernels/mlp.py:_layer_norm_int8) adds in the same order, so both give the
// same LN output bit for bit, and no quantizer step flips between them on a
// summation order (a flipped k or v element moves a RAJNI score by up to
// ~1%). A lane's chunks past the row's end add nothing, so the order is the
// same at either NV: up to C = 1024 it is the one it always had.
// ---------------------------------------------------------------------------

// zero: null, or a [M] buffer this launch zeroes (the int8 tails' attention
// absmax, int8_attn_tail), so that no launch of its own does.
template <int NV>
__global__ void __launch_bounds__(256) ln_quant_kernel(
    const bf16* __restrict__ x, const float* __restrict__ scale, const float* __restrict__ bias,
    int8_t* __restrict__ q, float* __restrict__ a_out, float* __restrict__ zero, int M, int C,
    float eps, int static_act) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + warp;
  if (row >= M) return;
  if (zero != nullptr && lane == 0) zero[row] = 0.f;
  const int nvec = C / 8;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * C);
  float v[NV][8];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = lane + 32 * i;
    if (c < nvec) {
      unpack8(xr[c], v[i]);
#pragma unroll
      for (int j = 0; j < 8; ++j) s = __fadd_rn(s, v[i][j]);
    }
  }
  const float mean = __fdiv_rn(warp_sum(s), (float)C);
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = lane + 32 * i;
    if (c < nvec) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = __fsub_rn(v[i][j], mean);
        sq = __fadd_rn(sq, __fmul_rn(d, d));
      }
    }
  }
  const float rstd =
      __frcp_rn(__fsqrt_rn(__fadd_rn(__fdiv_rn(warp_sum(sq), (float)C), eps)));
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = lane + 32 * i;
    if (c < nvec) {
      const float4* sc = reinterpret_cast<const float4*>(scale + 8 * c);
      const float4* bi = reinterpret_cast<const float4*>(bias + 8 * c);
      const float4 s0 = sc[0], s1 = sc[1], b0 = bi[0], b1 = bi[1];
      const float sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        // ((x - mean) * rstd) * scale + bias, as _layer_norm_f32
        const float y =
            __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v[i][j], mean), rstd), sv[j]), bv[j]);
        v[i][j] = y;
        amax = fmaxf(amax, fabsf(y));
      }
    }
  }
  float mul = 1.f;
  if (!static_act) {
    amax = fmaxf(warp_max(amax), 1e-8f);
    mul = __fdiv_rn(127.f, amax);
    if (lane == 0) a_out[row] = __fmul_rn(amax, INV127);
  }
  uint2* qr = reinterpret_cast<uint2*>(q + (size_t)row * C);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = lane + 32 * i;
    if (c < nvec) {
      int t[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) t[j] = quant1(__fmul_rn(v[i][j], mul));
      qr[c] = make_uint2(pack4_s8(t[0], t[1], t[2], t[3]), pack4_s8(t[4], t[5], t[6], t[7]));
    }
  }
}

inline cudaError_t launch_ln_quant(const bf16* x, const float* scale, const float* bias,
                                   int8_t* q, float* a_out, int M, int C, float eps,
                                   int static_act, cudaStream_t st, float* zero = nullptr) {
  if (C < 8 || C % 8 || C > 256 * LN_MAXV_WIDE) return cudaErrorInvalidValue;
  if (C <= 256 * LN_MAXV)
    ln_quant_kernel<LN_MAXV><<<(M + 7) / 8, 256, 0, st>>>(x, scale, bias, q, a_out, zero, M, C,
                                                          eps, static_act);
  else
    ln_quant_kernel<LN_MAXV_WIDE><<<(M + 7) / 8, 256, 0, st>>>(x, scale, bias, q, a_out, zero,
                                                               M, C, eps, static_act);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Quantize rows [M, W] of fp32 (the GELU output h; the int8 blocks'
// attention output on the two-launch route) or bf16 (B10's and B11's
// attention output there, which the TPU kernel rounds to the activation
// dtype first, block.py:1255) in groups of G columns: one warp
// per (row, group), two passes over the group (absmax, then quantize), or
// one where the group's absmax comes in amax_in [M, W / G] (fc1's
// epilogue took it: I8_GELU_MAX). Dynamic: scale to a_out[row * (W / G) +
// group]. Static: multiply by sinv (when given; the attention output
// arrives pre-scaled by the V-column fold and has none), round and clip.
// Requires W % 4 == 0 and G % 4 == 0.
// ---------------------------------------------------------------------------

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

template <typename T>
__global__ void __launch_bounds__(256) quant_rows_kernel(
    const T* __restrict__ y, const float* __restrict__ sinv, int8_t* __restrict__ q,
    float* __restrict__ a_out, const float* __restrict__ amax_in, int M, int W, int G,
    int static_act) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int groups = W / G;
  const long long item = (long long)blockIdx.x * 8 + warp;
  if (item >= (long long)M * groups) return;
  const int row = (int)(item / groups), grp = (int)(item % groups);
  const size_t off = (size_t)row * W + (size_t)grp * G;
  const T* yr = y + off;
  const float4* si = sinv ? reinterpret_cast<const float4*>(sinv + (size_t)grp * G) : nullptr;
  const int nv = G / 4;
  float mul = 1.f;
  if (!static_act) {
    float amax = 0.f;
    if (amax_in != nullptr) {
      amax = amax_in[(size_t)row * groups + grp];
    } else {
      for (int c = lane; c < nv; c += 32) {
        const float4 t = load4(yr + 4 * c);
        amax = fmaxf(amax, fmaxf(fmaxf(fabsf(t.x), fabsf(t.y)), fmaxf(fabsf(t.z), fabsf(t.w))));
      }
      amax = warp_max(amax);
    }
    amax = fmaxf(amax, 1e-8f);
    mul = __fdiv_rn(127.f, amax);
    if (lane == 0) a_out[(size_t)row * groups + grp] = __fmul_rn(amax, INV127);
  }
  uint32_t* qr = reinterpret_cast<uint32_t*>(q + off);
  for (int c = lane; c < nv; c += 32) {
    const float4 t = load4(yr + 4 * c);
    const float4 m = si ? si[c] : make_float4(mul, mul, mul, mul);
    qr[c] = pack4_s8(quant1(__fmul_rn(t.x, m.x)), quant1(__fmul_rn(t.y, m.y)),
                     quant1(__fmul_rn(t.z, m.z)), quant1(__fmul_rn(t.w, m.w)));
  }
}

template <typename T>
inline cudaError_t launch_quant_rows(const T* y, const float* sinv, int8_t* q, float* a_out,
                                     int M, int W, int G, int static_act, cudaStream_t st,
                                     const float* amax_in = nullptr) {
  if (G < 4 || W % 4 || G % 4 || W % G) return cudaErrorInvalidValue;
  const long long items = (long long)M * (W / G);
  quant_rows_kernel<T><<<(unsigned)((items + 7) / 8), 256, 0, st>>>(y, sinv, q, a_out, amax_in,
                                                                    M, W, G, static_act);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Int8 GEMM: out[M, N] = epilogue(A[M, K] · W[N, K]ᵀ), s8 × s8 → s32, on
// gemm_sm90.cuh's kernel (its header has the design): A row-major int8
// (quantized activations), W row-major [out, in] int8 (the port's weight
// record), both K-major; m64nBNk32 products, exact int32 sums; BK = 128 (a
// stage is the bf16 GEMM's bytes), BN = 256 where N % 256 == 0, else 128.
// S8Epi below is its epilogue policy, in int8.cuh's operation order:
//   v = (float)acc [· a[row]] (GROUPED: every group_k of the contraction the
//   int32 sums are flushed to fp32, accf += (float)acc [· a[row, group]],
//   and the next group's first product starts from 0: fc2 over hc-wide
//   groups of h; such launches take BN = 128, 64 int32 and 64 fp32
//   registers a thread), then v · w_scale + bias, and
//     I8_BIAS      stores bf16 (qkv);
//     I8_PARTIAL   I8_BIAS stored fp32 (a tensor-parallel shard's row-parallel
//                  proj, whose fp32 partial sums are all-reduced:
//                  rajni_tpu/parallel/mesh.py:553-565);
//     I8_RESIDUAL  · ls (when given), + the residual row (gathered through
//                  res_idx when given), stores bf16 (proj, fc2);
//     I8_GELU      gelu_fast(v) stored fp32 (fc1 to fp32 h; then
//                  quant_rows: the two-launch route, kept only as the
//                  yardstick and bitwise reference of launch_gelu_quant,
//                  through csrc/gemm.cu);
//     I8_GELU_Q    (static) fc1's GELU quantized where it is computed:
//                  quant1(gelu · sinv[col]) stored int8, no fp32 h at all;
//     I8_GELU_MAX  (dynamic) I8_GELU, and each row's |gelu| maximum over
//                  the tile atomicMax'ed on the float's bits (non-negative,
//                  so the integer order is the float order) into amax[row,
//                  group] of hc-wide column groups, which the caller zeroes
//                  first. A tile lies in one group (BN divides hc), and a
//                  maximum does not depend on order, so amax is the group's
//                  exact absmax, and quant_rows reads h once, not twice.
//   The quantizer's own operations take amax to the multiplier and the
//   scale, so both routes' hq and hs are those of I8_GELU + quant_rows bit
//   for bit (launch_gelu_quant below).
// And with ARaw bf16 or fp32 (QUANT_A, launch_gemm_s8q: the int8 tails' proj,
// I8_RESIDUAL ungrouped), A is the attention output, quantized as it is
// loaded: row r by mul = 127 / max(amax_in[r], 1e-8) and dequantized by
// max(amax_in[r], 1e-8) · (1/127), quant_rows' operations on its absmax
// (static: amax_in null, mul 1 and no row scale: the 1/a_proj fold came
// with V). Requires K % 128 == 0, N % 16 == 0
//   (int8 rows of 16-byte multiples), group_k % 128 == 0 dividing K, hc %
//   128 == 0 dividing N; M and N are masked. Shapes it does not take return
//   cudaErrorInvalidValue: there is no second GEMM to fall back to.
// ---------------------------------------------------------------------------

enum I8Epilogue {
  I8_BIAS = 0, I8_GELU = 1, I8_RESIDUAL = 2, I8_GELU_Q = 3, I8_GELU_MAX = 4, I8_PARTIAL = 5
};

struct I8EpilogueArgs {
  const float* a;        // row scales [M, K / group_k], or null (static)
  const float* w_scale;  // [N]
  const float* bias;     // [N] fp32
  const bf16* ls;        // [N] layer scale, or null (ones)
  const bf16* res;       // residual rows, or null
  const int* res_idx;    // [M] token index into res per output row, or null
  int rows_out;          // output rows per image (res_idx addressing)
  int rows_in;           // residual rows per image (res_idx addressing)
  int group_k;           // contraction width of one quantization group
  const float* sinv;     // I8_GELU_Q: [N], the static 1/a_fc2 fold
  float* amax;           // I8_GELU_MAX: [M, N / hc], each row and group's |gelu| maximum
  int hc;                // I8_GELU_MAX: the column group
  const float* amax_in;  // QUANT_A, dynamic: [M] each row's absmax of A; null: static
};

template <int EPI, int BN_, bool GROUPED_, typename ARaw_ = int8_t>
struct S8Epi {
  using In = int8_t;
  using ARaw = ARaw_;
  using Acc = int;
  using Out =
      std::conditional_t<EPI == I8_GELU || EPI == I8_GELU_MAX || EPI == I8_PARTIAL, float,
                         std::conditional_t<EPI == I8_GELU_Q, int8_t, bf16>>;
  using Args = I8EpilogueArgs;
  static constexpr int BN = BN_;
  static constexpr bool RESIDUAL = EPI == I8_RESIDUAL, GROUPED = GROUPED_,
                        ROW_MAX = EPI == I8_GELU_MAX, SAVE = false,
                        QUANT_A = !std::is_same_v<ARaw, int8_t>;
  static constexpr bool GELU = EPI == I8_GELU || EPI == I8_GELU_Q || EPI == I8_GELU_MAX;
  static_assert(!QUANT_A || (EPI == I8_RESIDUAL && !GROUPED), "A quantized on load: proj only");
  struct Rows {
    float a;    // the row scale of an ungrouped product
    float mul;  // QUANT_A: A's multiplier before its rounding
  };
  // dynamic: a row scale to multiply by
  __device__ static bool scaled(const Args& ep) {
    return QUANT_A ? ep.amax_in != nullptr : ep.a != nullptr;
  }
  struct Cols {
    float2 ws, b, l;  // w_scale, bias, and ls (I8_RESIDUAL) or sinv (I8_GELU_Q)
  };
  __device__ static Rows rows(const Args& ep, int r, int M, int, int, int) {
    if constexpr (QUANT_A) {  // the multiplier; the scale after the mainloop
      if (ep.amax_in == nullptr || r >= M) return Rows{1.f, 1.f};
      return Rows{1.f, __fdiv_rn(127.f, fmaxf(ep.amax_in[r], 1e-8f))};
    }
    return Rows{!GROUPED && ep.a != nullptr && r < M ? ep.a[r] : 1.f, 1.f};
  }
  // QUANT_A: row r's dequant scale, max(amax, 1e-8) · (1/127)
  __device__ static void dequant_rows(const Args& ep, Rows& rw, int r, int M) {
    if (ep.amax_in != nullptr && r < M) rw.a = __fmul_rn(fmaxf(ep.amax_in[r], 1e-8f), INV127);
  }
  __device__ static Cols cols(const Args& ep, int c, int N) {
    Cols k{ld_pair(ep.w_scale, c, N), ld_pair(ep.bias, c, N), make_float2(1.f, 1.f)};
    if (EPI == I8_RESIDUAL && ep.ls != nullptr) k.l = ld_pair(ep.ls, c, N);
    if (EPI == I8_GELU_Q) k.l = ld_pair(ep.sinv, c, N);
    return k;
  }
  __device__ static float2 apply(const Args& ep, float2 v, const Cols& k, const Rows& rw) {
    if (!GROUPED && scaled(ep)) {
      v.x = __fmul_rn(v.x, rw.a);
      v.y = __fmul_rn(v.y, rw.a);
    }
    v.x = __fadd_rn(__fmul_rn(v.x, k.ws.x), k.b.x);
    v.y = __fadd_rn(__fmul_rn(v.y, k.ws.y), k.b.y);
    if (GELU) {
      v.x = gelu_fast_epi(v.x);
      v.y = gelu_fast_epi(v.y);
    }
    if (EPI == I8_GELU_Q || (EPI == I8_RESIDUAL && ep.ls != nullptr)) {
      v.x = __fmul_rn(v.x, k.l.x);
      v.y = __fmul_rn(v.y, k.l.y);
    }
    return v;
  }
  __device__ static float2 add_res(float2 x, float2 v) {
    return make_float2(__fadd_rn(x.x, v.x), __fadd_rn(x.y, v.y));
  }
  __device__ static float group_scale(const Args& ep, int r, int M, int groups, int grp) {
    return ep.a != nullptr && r < M ? ep.a[(size_t)r * groups + grp] : 1.f;
  }
  // accf += (float)acc · a[row, group] (static: (float)acc), the plain
  // version's order; element i is row r0 + 8·((i >> 1) & 1)
  template <int NA>
  __device__ static void flush(const Args& ep, float (&accf)[NA], const int (&acc)[NA],
                               const float (&ga)[2]) {
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const float part = __int2float_rn(acc[i]);
      accf[i] = __fadd_rn(accf[i], ep.a != nullptr ? __fmul_rn(part, ga[(i >> 1) & 1]) : part);
    }
  }
  __device__ static void row_max(const Args& ep, int r, int M, int N, int n0, float m, int t4) {
    if (t4 == 0 && r < M)
      atomicMax(reinterpret_cast<int*>(ep.amax) + (size_t)r * (N / ep.hc) + n0 / ep.hc,
                __float_as_int(m));
  }
};

template <int EPI, int BN, bool GROUPED>
inline cudaError_t launch_gemm_s8_bn(const CUtensorMap (&maps)[4], int M, int N, int K,
                                     const I8EpilogueArgs& ep, cudaStream_t st) {
  return launch_gemm_g9<S8Epi<EPI, BN, GROUPED>>(maps[0], maps[1], maps[2], maps[3], M, N, K, ep,
                                                 st);
}

// out[M, N] = epilogue(A[M, K] · W[N, K]ᵀ) on the stream, out of
// S8Epi<EPI>::Out. One group (group_k == K) needs no fp32 flush: (float)acc
// · a is what the flush would give. Only I8_RESIDUAL (fc2) is ever grouped.
template <int EPI>
inline cudaError_t launch_gemm_s8(const int8_t* A, const int8_t* W, void* out, int M, int N,
                                  int K, const I8EpilogueArgs& ep, cudaStream_t st) {
  using Out = typename S8Epi<EPI, 128, false>::Out;
  const bool grouped = EPI == I8_RESIDUAL && ep.group_k < K;
  if (N < 16 || N % 16 || ep.group_k < G9_BKB || ep.group_k % G9_BKB || K % ep.group_k ||
      (EPI != I8_RESIDUAL && ep.res_idx != nullptr) || (EPI == I8_GELU_Q && ep.sinv == nullptr) ||
      (EPI == I8_GELU_MAX && (ep.amax == nullptr || ep.hc < 128 || ep.hc % 128 || N % ep.hc)))
    return cudaErrorInvalidValue;
  const bf16* res = EPI == I8_RESIDUAL ? ep.res : nullptr;
  cudaError_t e = check_gemm_g9(A, W, out, M, K, G9_BKB, res, ep.res_idx, ep.rows_out, ep.rows_in);
  if (e != cudaSuccess) return e;
  const bool wide = !grouped && N % 256 == 0 && (EPI != I8_GELU_MAX || ep.hc % 256 == 0);
  CUtensorMap maps[4] = {};
  e = make_gemm_maps(maps, A, W, static_cast<const Out*>(out), res, ep.res_idx != nullptr, M, N,
                     K, wide ? 256 : 128);
  if (e != cudaSuccess) return e;
  if (grouped) {
    if constexpr (EPI == I8_RESIDUAL) return launch_gemm_s8_bn<EPI, 128, true>(maps, M, N, K, ep, st);
  }
  return wide ? launch_gemm_s8_bn<EPI, 256, false>(maps, M, N, K, ep, st)
              : launch_gemm_s8_bn<EPI, 128, false>(maps, M, N, K, ep, st);
}

// The int8 tails' proj: out[M, N] = I8_RESIDUAL(quant(A) · Wᵀ) with A [M, K]
// of bf16 or fp32 (the attention output) quantized per row as it is loaded
// (S8Epi's QUANT_A: row r's absmax in ep.amax_in[r], or static with none;
// ep.a unused), ungrouped (group_k == K). Shapes as launch_gemm_s8's.
template <typename ARaw>
inline cudaError_t launch_gemm_s8q(const ARaw* A, const int8_t* W, bf16* out, int M, int N, int K,
                                   const I8EpilogueArgs& ep, cudaStream_t st) {
  if (N < 16 || N % 16 || ep.group_k != K) return cudaErrorInvalidValue;
  cudaError_t e = check_gemm_g9(A, W, out, M, K, G9_BKB, ep.res, ep.res_idx, ep.rows_out,
                                ep.rows_in);
  if (e != cudaSuccess) return e;
  const bool wide = N % 256 == 0;
  CUtensorMap maps[4] = {};
  e = make_gemm_maps(maps, A, W, out, ep.res, ep.res_idx != nullptr, M, N, K, wide ? 256 : 128);
  if (e != cudaSuccess) return e;
  return wide ? launch_gemm_g9<S8Epi<I8_RESIDUAL, 256, false, ARaw>>(maps[0], maps[1], maps[2],
                                                                     maps[3], M, N, K, ep, st)
              : launch_gemm_g9<S8Epi<I8_RESIDUAL, 128, false, ARaw>>(maps[0], maps[1], maps[2],
                                                                     maps[3], M, N, K, ep, st);
}

// fc1 with its GELU quantized per row and hc group into hq [M, N] int8 and
// (dynamic) its row scales hs [M, N / hc]. Static (ep.sinv): one launch,
// I8_GELU_Q. Dynamic: the absmax scratch hmax [M, N / hc] zeroed, fc1 to
// fp32 h [M, N] with the group absmax (I8_GELU_MAX), then quant_rows reading
// h once. Returns 0 or fail(e, step) (fc1 and the zeroing), fail(e, step +
// 1) (the quantizer).
//   A design choice, measured on the H100: in dynamic mode a row's scale is
// the absmax over its hc group, which spans 6-16 column tiles, so no int8
// can be written until every tile of the group is done. Running fc1 twice
// (an absmax pass that stores nothing, then a quantizing pass) read slower
// than writing fp32 h and quantizing it in a second launch, at nearly every
// B9 and B15 shape: the second mainloop and GELU cost more than the fp32
// round trip. What does pay is taking the absmax in fc1's epilogue, so that
// the quantizer reads h once, where quant_rows alone reads it twice
// (chip_smoke.py times this route beside that two-launch one).
inline int launch_gelu_quant(const int8_t* A, const int8_t* W, int8_t* hq, float* hs, float* h,
                             float* hmax, int M, int N, int K, I8EpilogueArgs ep, int step,
                             cudaStream_t st) {
  cudaError_t e;
  if (ep.sinv != nullptr) {
    e = launch_gemm_s8<I8_GELU_Q>(A, W, hq, M, N, K, ep, st);
    return e == cudaSuccess ? 0 : fail(e, step);
  }
  if (hmax == nullptr || ep.hc < 128 || N % ep.hc) return fail(cudaErrorInvalidValue, step);
  ep.amax = hmax;
  e = cudaMemsetAsync(hmax, 0, (size_t)M * (N / ep.hc) * sizeof(float), st);
  if (e == cudaSuccess) e = launch_gemm_s8<I8_GELU_MAX>(A, W, h, M, N, K, ep, st);
  if (e != cudaSuccess) return fail(e, step);
  e = launch_quant_rows(static_cast<const float*>(h), (const float*)nullptr, hq, hs, M, N, ep.hc,
                        0, st, hmax);
  return e == cudaSuccess ? 0 : fail(e, step + 1);
}

}  // namespace
}  // namespace rajni
