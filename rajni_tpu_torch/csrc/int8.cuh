// Int8 building blocks of the whole-block int8 kernels (B14
// fused_pruned_block_full_int8, B15 fused_block_full_int8): LayerNorm
// quantized straight to int8, a quantizer for fp32 rows, and an int8 GEMM
// whose epilogue dequantizes. int8_block_head and int8_block_tail at the end
// are the body of both entry points.
//
// Numeric contract (block.py:1609-1710 and 2279-2371, and the plain versions
// in rajni_tpu_torch/kernels/wholeblock.py):
//  * Rounded to bf16: qkv (B14 rounds it before scoring, block.py:1644; B15's
//    attention casts it, :284, which is the same) and x_mid, the residual
//    stream between the two halves (:1673-1675, 2337-2339).
//  * NOT rounded, fp32 until quantized: the LayerNorm outputs (:1640, 1680,
//    2324, 2341), the GELU output h (:1692, 2353) and the attention output
//    (_mha_mixed(..., float32), :1663, 2329). Every other launch of the port
//    writes bf16; these write int8 (LayerNorm) or fp32 (attention, fc1).
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
// twice the bf16 rate); the fp32 h of fc1 is written and read back once
// more (B·K·hidden·4 bytes each way), and each quantize pass reads fp32 rows
// and writes int8.
#pragma once

#include "common.cuh"

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
// LayerNorm → int8: one warp per row, the row in registers (C <= 1024). The
// fp32 LN output is quantized where it is computed and never stored.
// Dynamic: per-row scale to a_out[row]; static (static_act): the affine
// carries the 1/a fold, so the kernel only rounds and clips.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(256) ln_quant_kernel(
    const bf16* __restrict__ x, const float* __restrict__ scale, const float* __restrict__ bias,
    int8_t* __restrict__ q, float* __restrict__ a_out, int M, int C, float eps, int static_act) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + warp;
  if (row >= M) return;
  const int nvec = C / 8;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * C);
  float v[LN_MAXV][8];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < LN_MAXV; ++i) {
    const int c = lane + 32 * i;
    if (c < nvec) {
      unpack8(xr[c], v[i]);
#pragma unroll
      for (int j = 0; j < 8; ++j) s += v[i][j];
    }
  }
  const float mean = warp_sum(s) / (float)C;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < LN_MAXV; ++i) {
    const int c = lane + 32 * i;
    if (c < nvec) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = v[i][j] - mean;
        sq += d * d;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / (float)C + eps);
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < LN_MAXV; ++i) {
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
  for (int i = 0; i < LN_MAXV; ++i) {
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
                                   int static_act, cudaStream_t st) {
  ln_quant_kernel<<<(M + 7) / 8, 256, 0, st>>>(x, scale, bias, q, a_out, M, C, eps, static_act);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Quantize fp32 rows [M, W] in groups of G columns: one warp per (row,
// group), two passes over the group (absmax, then quantize). Dynamic: scale
// to a_out[row * (W / G) + group]. Static: multiply by sinv (when given; the
// attention output arrives pre-scaled by the V-column fold and has none),
// round and clip.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(256) quant_rows_kernel(
    const float* __restrict__ y, const float* __restrict__ sinv, int8_t* __restrict__ q,
    float* __restrict__ a_out, int M, int W, int G, int static_act) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int groups = W / G;
  const long long item = (long long)blockIdx.x * 8 + warp;
  if (item >= (long long)M * groups) return;
  const int row = (int)(item / groups), grp = (int)(item % groups);
  const size_t off = (size_t)row * W + (size_t)grp * G;
  const float4* yr = reinterpret_cast<const float4*>(y + off);
  const float4* si = sinv ? reinterpret_cast<const float4*>(sinv + (size_t)grp * G) : nullptr;
  const int nv = G / 4;
  float mul = 1.f;
  if (!static_act) {
    float amax = 0.f;
    for (int c = lane; c < nv; c += 32) {
      const float4 t = yr[c];
      amax = fmaxf(amax, fmaxf(fmaxf(fabsf(t.x), fabsf(t.y)), fmaxf(fabsf(t.z), fabsf(t.w))));
    }
    amax = fmaxf(warp_max(amax), 1e-8f);
    mul = __fdiv_rn(127.f, amax);
    if (lane == 0) a_out[(size_t)row * groups + grp] = __fmul_rn(amax, INV127);
  }
  uint32_t* qr = reinterpret_cast<uint32_t*>(q + off);
  for (int c = lane; c < nv; c += 32) {
    const float4 t = yr[c];
    const float4 m = si ? si[c] : make_float4(mul, mul, mul, mul);
    qr[c] = pack4_s8(quant1(__fmul_rn(t.x, m.x)), quant1(__fmul_rn(t.y, m.y)),
                     quant1(__fmul_rn(t.z, m.z)), quant1(__fmul_rn(t.w, m.w)));
  }
}

inline cudaError_t launch_quant_rows(const float* y, const float* sinv, int8_t* q, float* a_out,
                                     int M, int W, int G, int static_act, cudaStream_t st) {
  const long long items = (long long)M * (W / G);
  quant_rows_kernel<<<(unsigned)((items + 7) / 8), 256, 0, st>>>(y, sinv, q, a_out, M, W, G,
                                                                 static_act);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Int8 GEMM: out[M, N] = epilogue(A[M, K] · W[N, K]ᵀ), s8 × s8 → s32.
//   A row-major int8 (quantized activations), W row-major [out, in] int8
//   (the port's weight record): both K-contiguous. The byte layout is that
//   of gemm_bf16_kernel (128-byte tile rows, 16-byte chunks XOR-swizzled by
//   row, ldmatrix for both operands): a 16-byte chunk is 16 int8 here, and
//   the m16n8k32 s8 fragments take exactly the words ldmatrix hands out.
//   128x128x128 block tiles, 8 warps of 32x64, a 3-stage cp.async ring,
//   mma.sync m16n8k32 with int32 accumulators.
//   GROUPED: every group_k of the contraction the int32 sums are flushed to
//   fp32 accumulators, times the group's row scale a[row, group] (dynamic)
//   or as they are (static), and reset: fc2 over hc-wide groups of h.
//   Otherwise one group: v = (float)acc [* a[row]].
//   Epilogue: v * w_scale + bias, then I8_BIAS stores bf16; I8_GELU stores
//   gelu_fast(v) in fp32; I8_RESIDUAL multiplies by ls (when given), adds
//   the residual row (gathered through res_idx when given) and stores bf16.
//   Requires K % 128 == 0, group_k % 128 == 0 and N even; M and N masked.
// ---------------------------------------------------------------------------

enum I8Epilogue { I8_BIAS = 0, I8_GELU = 1, I8_RESIDUAL = 2 };

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
};

constexpr int I8_BM = 128, I8_BN = 128, I8_BK = 128, I8_STAGES = 3, I8_THREADS = 256;
constexpr int I8_SMEM = I8_STAGES * (I8_BM + I8_BN) * I8_BK;  // 98,304 bytes

// Byte offset of 16-byte chunk `chunk` (0..7) of row `row` in a tile whose
// rows are I8_BK = 128 bytes long.
__device__ __forceinline__ int swz8(int row, int chunk) {
  return row * I8_BK + ((chunk ^ (row & 7)) << 4);
}

// D += A·B: m16n8k32, s8 in, s32 accumulate. Fragments as mma_16816's with
// four int8 in each 32-bit word (a0: row g, k 4t..4t+3; a2: k + 16; b0: k
// 4t..4t+3, col g; b1: k + 16).
__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int EPI, bool GROUPED, typename OutT>
__global__ void __launch_bounds__(I8_THREADS) gemm_s8_kernel(
    const int8_t* __restrict__ A, const int8_t* __restrict__ W, OutT* __restrict__ out, int M,
    int N, int K, I8EpilogueArgs ep) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  int8_t* As = reinterpret_cast<int8_t*>(smem_raw);
  int8_t* Bs = As + I8_STAGES * I8_BM * I8_BK;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * I8_BM, n0 = blockIdx.x * I8_BN;
  const int wm = warp >> 1, wn = warp & 1;  // 4 x 2 warps, 32 x 64 each
  const int KT = K / I8_BK;
  const int g = lane >> 2, t4 = lane & 3;

  auto load_stage = [&](int slot, int k0) {
    int8_t* as = As + slot * I8_BM * I8_BK;
    int8_t* bs = Bs + slot * I8_BN * I8_BK;
#pragma unroll
    for (int i = 0; i < I8_BM * 8 / I8_THREADS; ++i) {  // A: 8 chunks a row
      const int c = tid + i * I8_THREADS, r = c >> 3, ch = c & 7, gr = m0 + r;
      cp_async16(as + swz8(r, ch), A + (size_t)(gr < M ? gr : 0) * K + k0 + ch * 16, gr < M);
    }
#pragma unroll
    for (int i = 0; i < I8_BN * 8 / I8_THREADS; ++i) {  // W: 8 chunks a row
      const int c = tid + i * I8_THREADS, r = c >> 3, ch = c & 7, gn = n0 + r;
      cp_async16(bs + swz8(r, ch), W + (size_t)(gn < N ? gn : 0) * K + k0 + ch * 16, gn < N);
    }
  };

  int acc[2][8][4];
  float accf[GROUPED ? 2 : 1][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[i][j][e] = 0;
        if (GROUPED) accf[GROUPED ? i : 0][j][e] = 0.f;
      }

#pragma unroll
  for (int s = 0; s < I8_STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s * I8_BK);
    cp_async_commit();
  }

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<I8_STAGES - 2>();
    __syncthreads();
    const int next = kt + I8_STAGES - 1;
    if (next < KT) load_stage(next % I8_STAGES, next * I8_BK);
    cp_async_commit();

    const int8_t* as = As + (kt % I8_STAGES) * I8_BM * I8_BK;
    const int8_t* bs = Bs + (kt % I8_STAGES) * I8_BN * I8_BK;
#pragma unroll
    for (int kk = 0; kk < I8_BK / 32; ++kk) {
      uint32_t af[2][4], bfr[8][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldmatrix_x4(af[i], reinterpret_cast<const bf16*>(
                               as + swz8(wm * 32 + i * 16 + (lane & 15), kk * 2 + (lane >> 4))));
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        uint32_t r[4];
        const int nrow = wn * 64 + jj * 16 + (lane & 7) + ((lane >> 4) << 3);
        ldmatrix_x4(r, reinterpret_cast<const bf16*>(bs + swz8(nrow, kk * 2 + ((lane >> 3) & 1))));
        bfr[2 * jj][0] = r[0];
        bfr[2 * jj][1] = r[1];
        bfr[2 * jj + 1][0] = r[2];
        bfr[2 * jj + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) mma_s8(acc[i][j], af[i], bfr[j][0], bfr[j][1]);
    }

    if (GROUPED && ((kt + 1) * I8_BK) % ep.group_k == 0) {
      // flush this group's exact int32 sums: accf += (float)acc * a[row, group]
      const int groups = K / ep.group_k, grp = (kt + 1) * I8_BK / ep.group_k - 1;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = m0 + wm * 32 + i * 16 + g + half * 8;
          const bool scaled = ep.a != nullptr;
          const float a = (scaled && r < M) ? ep.a[(size_t)r * groups + grp] : 1.f;
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int k = 2 * half + e;
              const float part = scaled ? __fmul_rn((float)acc[i][j][k], a) : (float)acc[i][j][k];
              accf[GROUPED ? i : 0][j][k] = __fadd_rn(accf[GROUPED ? i : 0][j][k], part);
              acc[i][j][k] = 0;
            }
        }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = n0 + wn * 64 + j * 8 + 2 * t4;
    if (c >= N) continue;
    const float2 ws = *reinterpret_cast<const float2*>(ep.w_scale + c);
    const float2 b = *reinterpret_cast<const float2*>(ep.bias + c);
    float2 l = make_float2(1.f, 1.f);
    if (EPI == I8_RESIDUAL && ep.ls != nullptr)
      l = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(ep.ls + c));
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m0 + wm * 32 + i * 16 + g + half * 8;
        if (r >= M) continue;
        float v0, v1;
        if (GROUPED) {
          v0 = accf[GROUPED ? i : 0][j][2 * half];
          v1 = accf[GROUPED ? i : 0][j][2 * half + 1];
        } else {
          v0 = (float)acc[i][j][2 * half];
          v1 = (float)acc[i][j][2 * half + 1];
          if (ep.a != nullptr) {
            const float a = ep.a[r];
            v0 = __fmul_rn(v0, a);
            v1 = __fmul_rn(v1, a);
          }
        }
        v0 = __fadd_rn(__fmul_rn(v0, ws.x), b.x);
        v1 = __fadd_rn(__fmul_rn(v1, ws.y), b.y);
        if (EPI == I8_GELU) {
          v0 = gelu_fast(v0);
          v1 = gelu_fast(v1);
        } else if (EPI == I8_RESIDUAL) {
          if (ep.ls != nullptr) {
            v0 = __fmul_rn(v0, l.x);
            v1 = __fmul_rn(v1, l.y);
          }
          if (ep.res != nullptr) {
            size_t rr = (size_t)r;
            if (ep.res_idx != nullptr)
              rr = (size_t)(r / ep.rows_out) * ep.rows_in + ep.res_idx[r];
            const float2 x =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(ep.res + rr * N + c));
            v0 = __fadd_rn(x.x, v0);
            v1 = __fadd_rn(x.y, v1);
          }
        }
        store_pair(out + (size_t)r * N + c, v0, v1);
      }
    }
  }
}

template <int EPI, bool GROUPED, typename OutT>
inline cudaError_t launch_gemm_s8_t(const int8_t* A, const int8_t* W, OutT* out, int M, int N,
                                    int K, I8EpilogueArgs ep, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(gemm_s8_kernel<EPI, GROUPED, OutT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, I8_SMEM);
  if (e != cudaSuccess) return e;
  dim3 grid((N + I8_BN - 1) / I8_BN, (M + I8_BM - 1) / I8_BM);
  gemm_s8_kernel<EPI, GROUPED, OutT><<<grid, I8_THREADS, I8_SMEM, st>>>(A, W, out, M, N, K, ep);
  return cudaGetLastError();
}

// One group (group_k == K) needs no fp32 flush: (float)acc * a is what the
// flush would give. Only fc2 (I8_RESIDUAL) is ever grouped.
template <int EPI, typename OutT>
inline cudaError_t launch_gemm_s8(const int8_t* A, const int8_t* W, OutT* out, int M, int N,
                                  int K, I8EpilogueArgs ep, cudaStream_t st) {
  if (K % I8_BK || ep.group_k % I8_BK || K % ep.group_k || N % 2) return cudaErrorInvalidValue;
  if constexpr (EPI == I8_RESIDUAL) {
    if (ep.group_k < K) return launch_gemm_s8_t<EPI, true>(A, W, out, M, N, K, ep, st);
  }
  return launch_gemm_s8_t<EPI, false>(A, W, out, M, N, K, ep, st);
}

// ---------------------------------------------------------------------------
// The body of B14 (pruned: idx/ns/scores given) and B15 (stock). Launch
// steps (the return code's step, common.cuh:fail):
//   1 LN1 → int8 q8 [B·N, C] (+ row scales qs)
//   2 qkv = dequant(q8 · Wqkvᵀ) + bqkv → bf16 [B·N, 3C]
//   3 scores (B14 rescoring; common.cuh:score_kernel)   4 selection (B14)
//   5 attention through the kept indices (B14) → fp32 attn [B·n, C]
//   6 quantize attn per row → q8, qs
//   7 proj: dequant + bproj, · ls1, + x (gathered) → bf16 x_mid [B·n, C]
//   8 LN2 → int8 q8, qs
//   9 fc1: gelu_fast(dequant + b1) → fp32 h [B·n, hidden]
//  10 quantize h per row and hc chunk (static: · sinv) → hq, hs
//  11 fc2, grouped over hc: dequant · s2 + b2, · ls2, + x_mid → bf16 out
// with n = K (B14) or N (B15). Static mode passes no row scales.
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
  float* h;
  int8_t* hq;
  float* hs;
  bf16* out;
  int B, N, C, hidden, hc, H;
  float scale, eps;
};

// Steps 1-2: LN1 → int8 and the qkv product.
inline int int8_block_head(const Int8Block& p, cudaStream_t st) {
  const int rows = p.B * p.N;
  const float* dyn = p.static_act ? nullptr : p.qs;
  cudaError_t e = launch_ln_quant(p.x, p.ln1s, p.ln1b, p.q8, p.qs, rows, p.C, p.eps,
                                  p.static_act, st);
  if (e != cudaSuccess) return fail(e, 1);
  e = launch_gemm_s8<I8_BIAS>(p.q8, p.wqkv, p.qkv, rows, 3 * p.C, p.C,
                              I8EpilogueArgs{dyn, p.sqkv, p.bqkv, nullptr, nullptr, nullptr, 1, 1,
                                             p.C},
                              st);
  return e == cudaSuccess ? 0 : fail(e, 2);
}

// Steps 5-11, on the kept tokens sel [B, n] (B14) or on all of them (B15:
// sel null, n = N).
inline int int8_block_tail(const Int8Block& p, const int* sel, int n, cudaStream_t st) {
  const int rows_n = p.B * n;
  const float* dyn = p.static_act ? nullptr : p.qs;
  cudaError_t e = launch_attention_any(p.qkv, sel, p.attn, p.B, p.N, n, p.C, p.H, p.scale, st);
  if (e != cudaSuccess) return fail(e, 5);
  e = launch_quant_rows(p.attn, nullptr, p.q8, p.qs, rows_n, p.C, p.C, p.static_act, st);
  if (e != cudaSuccess) return fail(e, 6);
  e = launch_gemm_s8<I8_RESIDUAL>(p.q8, p.wproj, p.mid, rows_n, p.C, p.C,
                                  I8EpilogueArgs{dyn, p.sproj, p.bproj, p.ls1, p.x, sel, n, p.N,
                                                 p.C},
                                  st);
  if (e != cudaSuccess) return fail(e, 7);
  e = launch_ln_quant(p.mid, p.ln2s, p.ln2b, p.q8, p.qs, rows_n, p.C, p.eps, p.static_act, st);
  if (e != cudaSuccess) return fail(e, 8);
  e = launch_gemm_s8<I8_GELU>(p.q8, p.w1, p.h, rows_n, p.hidden, p.C,
                              I8EpilogueArgs{dyn, p.s1, p.b1, nullptr, nullptr, nullptr, 1, 1,
                                             p.C},
                              st);
  if (e != cudaSuccess) return fail(e, 9);
  e = launch_quant_rows(p.h, p.static_act ? p.sinv : nullptr, p.hq, p.hs, rows_n, p.hidden,
                        p.hc, p.static_act, st);
  if (e != cudaSuccess) return fail(e, 10);
  e = launch_gemm_s8<I8_RESIDUAL>(p.hq, p.w2, p.out, rows_n, p.C, p.hidden,
                                  I8EpilogueArgs{p.static_act ? nullptr : p.hs, p.s2, p.b2, p.ls2,
                                                 p.mid, nullptr, 1, 1, p.hc},
                                  st);
  return e == cudaSuccess ? 0 : fail(e, 11);
}

}  // namespace
}  // namespace rajni
