// The int8 row-band GEMM: out[M, N] = epilogue(A[M, C] · W[N, C]ᵀ), s8 × s8
// → s32, where the kernel makes the int8 A operand itself, once for each
// 128-row band, in shared memory, and then walks every column tile of the
// band. Two forms (int8_block.cuh routes an entry point's steps to them):
//   * BAND_HEAD, the qkv product of the int8 heads (B11
//     fused_pruned_attn_block_int8, B12 fused_ln_qkv_int8, with their band
//     switch set; no path sets it): A is LN1 of the
//     bf16 x rows quantized to int8 (ln_quant_band_row, the operations of
//     int8.cuh:ln_quant_kernel, so the int8 rows and row scales are its
//     bits), and the epilogue is I8_BIAS's: (float)acc [· a[row]] · w_scale
//     + bias, rounded to bf16 once. Dynamic rows keep their scale in shared memory
//     (and write it to qs when given); static rows only round and clip (the
//     LN affine carries 1/a_qkv). It zeroes the int8 tail's row absmax, as
//     ln_quant_kernel does on the other route.
//   * BAND_PROJ, the proj of the int8 tails with a bf16 attention output
//     (B10, B11; on every route but two_launch): A is that output quantized per
//     row, by 127 / max(amax[r], 1e-8) with the absmax the attention's
//     epilogue took (static: round and clip), quant_rows' operations; the
//     epilogue is I8_RESIDUAL's: ·
//     max(amax, 1e-8) · (1/127), · w_scale + bias, · ls, + the residual row
//     (gathered through res_idx: row (r / rows_out) · rows_in + res_idx[r]),
//     rounded to bf16. Bitwise the two-launch route (quant_rows, then
//     launch_gemm_s8<I8_RESIDUAL>) and launch_gemm_s8q.
//
// Replaces, inside those entry points, the products of the TPU kernels
// rajni_tpu/kernels/block.py:fused_ln_qkv_int8 (pallas_call at 1408) and
// fused_pruned_attn_block_int8 (2616), and LN1's launch before them; and
// the proj of fused_attn_block_int8 (1304) and fused_pruned_attn_block_int8.
//
// Bound on the H100: operations (1,979 TOP/s int8) for the products, bytes
// (3.35 TB/s) where a row's products are short: at P4a's 577 tokens (B = 128,
// C = 768) the qkv product is 2.6e11 operations (0.132 ms) and its bf16 output
// 340 MB (0.101 ms).
//
// Design (hopper.cuh's building blocks; gemm_sm90.cuh's products):
//   * What it removes: gemm_sm90.cuh's kernel reads an int8 A that a launch
//     before it wrote (ln_quant_kernel: x read, q8 written, q8 read again),
//     or quantizes a raw A again in each of the N / BN column tiles that
//     read it (launch_gemm_s8q). Here a persistent block owns a band of 128
//     rows at a time (min(bands, SMs) blocks, band b = blockIdx.x, +
//     gridDim.x, ...), its 256 consumer threads make the band's int8 A once
//     into C / 128 tiles of 128 rows × 128 bytes of k in the 128-byte
//     swizzle that TMA would write (the wgmma K-major descriptor reads them
//     as gemm_sm90.cuh reads a stage), and every column tile of the band
//     reads that band. HEAD: one warp a row (ln_quant_band_row, re-reading
//     the row from the L1 for each of its passes). PROJ: each row's
//     multiplier first, then the band's 16-element pieces, four loads a
//     thread in flight. (Prefetching the next band's raw rows into the L2
//     from the producer thread was tried and read no faster.)
//   * Shared memory (227 KB a block): the band, 128·C bytes (48, 96, 128,
//     160 KB at C = 384, 768, 1024, 1280), four 8 KB output chunk buffers
//     (two a consumer), and a ring of W stages of 128 columns × 128 bytes of
//     k (16 KB) on full/empty mbarriers, as many as fit, at most 8 (8, 6, 4,
//     and 2 at C = 1280, where the PROJ form alone goes: ViT-H/14's B10
//     and B11).
//   * Ping-pong: consumer warpgroup c takes the band's column tiles j ≡ c
//     (mod 2), each tile all 128 rows × 128 columns (two m64n128k32 products
//     a k32 step, 128 int32 accumulators a thread). Their mainloops take
//     turns, ordered by two named barriers: a consumer waits for its turn
//     before its first product of a tile and hands the turn over once it has
//     issued its last, so one consumer's epilogue (dequant, bias, bf16
//     rounding, residual, TMA store) can run under the other's products. The
//     turns also keep each W stage's full-barrier phases in order: a
//     consumer only waits on a stage after the other has consumed the
//     stage's use before, so a parity wait cannot pass a round early. The
//     band is read-only while its tiles run, so the second consumer adds no
//     A traffic; W comes by TMA once per tile of the band, as in
//     gemm_sm90.cuh. (gemm_sm90.cuh's consumers split each tile's rows and
//     finish it together, so both epilogues stall the tensor cores; a
//     consumer lagging the other by a fixed offset over the same tiles, which
//     was tried there, kept that and gained nothing.)
//   * The epilogue runs in chunks of 64 rows × 64 columns through the
//     consumer's two buffers, stored by TMA; the column vectors come by the
//     read-only path (ldg_pair). PROJ's residual is gathered into the chunk
//     buffer by cp.async and added in place. (Gathering chunks 0 and 1
//     before the tile's products, as gemm_sm90.cuh does, read no faster.)
//   * Rows past M are made zero and their outputs are not stored (the TMA
//     store clips at M).
//   Measured on the H100 (PERF.md §6): the products alone run at ~96% of
//   the int8 peak, but a 128 × 128 tile's epilogue (4 warps, 16384 outputs)
//   takes 2-3× the tile's products at K = C, so the ping-pong hides part of
//   it, and the head's band is made while the tensor cores wait. The head
//   read 1.02-1.7× the time of ln_quant_kernel + gemm_sm90.cuh at every
//   shape of B11 and B12, so no path takes it. The proj read 0.70-1.02×
//   launch_gemm_s8q's time at B10's and B11's path shapes, faster at all
//   but one, within 2% there. (A form for the
//   fp32 A of B13-B15 read slower at 9 of their 31 shapes and slowed the
//   DeiT-S paths end to end; it was removed.)
// Requires C % 128 == 0, C <= 1024 (HEAD) or C <= 1280 (PROJ), and N % 128
// == 0; anything else returns cudaErrorInvalidValue.
#pragma once

#include "int8.cuh"

namespace rajni {
namespace {

constexpr int BAND_BM = 128;                 // rows of a band
constexpr int BAND_BN = 128;                 // columns of a tile
constexpr int BAND_KB = 128;                 // bytes of k of a band tile and a W stage
constexpr int BAND_TILE = BAND_BM * BAND_KB;  // 16 KB
constexpr int BAND_SMEM_MAX = 232448;        // 227 KB, a block's most
constexpr int BAND_MAX_STAGES = 8;
// the widest C of each form: HEAD's rows are LN1 → int8 at ln_quant_kernel's
// LN_MAXV (no path takes it); PROJ's band of 160 KB leaves 2 W stages
constexpr int BAND_HEAD_MAX_C = 32 * 8 * LN_MAXV, BAND_PROJ_MAX_C = 1280;
// the chunk buffers, the rows' scales, multipliers and residual rows, the
// alignment slack
constexpr int BAND_FIXED = 4 * G9_OUT + 3 * BAND_BM * 4 + 1024;

enum BandForm { BAND_HEAD = 0, BAND_PROJ = 1 };

struct BandArgs {
  const bf16* a;         // HEAD: x [M, C]; PROJ: the attention output [M, C]
  const float* ln_s;     // HEAD: LN1's affine (static: with the 1/a_qkv fold)
  const float* ln_b;
  float eps;
  float* qs;             // HEAD, dynamic: each row's scale [M] out, or null
  float* zero;           // HEAD: a [M] buffer zeroed (the tail's row absmax), or null
  const float* amax_in;  // PROJ, dynamic: each row's absmax [M]; null: static
  const float* w_scale;  // [N]
  const float* bias;     // [N]
  const bf16* ls;        // PROJ: [N] layer scale, or null
  const bf16* res;       // PROJ: the residual rows, N wide
  const int* res_idx;    // PROJ: [M] each output row's token in its image, or null (row r)
  int rows_out, rows_in;  // PROJ with res_idx: output and residual rows an image
  int M, N, C, static_act;
  int stages;  // W stages of the ring (band_stages)
};

// W stages that fit beside a band of width C, at most BAND_MAX_STAGES.
inline int band_stages(int C) {
  return min(BAND_MAX_STAGES, (BAND_SMEM_MAX - BAND_BM * C - BAND_FIXED) / (BAND_TILE + 16));
}
inline int band_smem(int C, int stages) {
  return BAND_BM * C + stages * (BAND_TILE + 16) + BAND_FIXED;
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Two fp32 (or bf16) values of a column vector at c, c + 1 (c < N, as every
// tile is whole), by the read-only path: the compiler may issue these loads
// ahead of the chunk's shared-memory stores, where ld_pair's plain loads
// wait behind them (a load's latency for each 8 columns of the epilogue).
__device__ __forceinline__ float2 ldg_pair(const float* p, int c) {
  return __ldg(reinterpret_cast<const float2*>(p + c));
}
__device__ __forceinline__ float2 ldg_pair(const bf16* p, int c) {
  const uint32_t u = __ldg(reinterpret_cast<const unsigned int*>(p + c));
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// Shared-memory stores and loads by address-space-specific instructions: the
// buffers' pointers come through smem_aligned as generic ones, and generic
// stores (ST.E) made the epilogue and the band's making ~20% slower.
__device__ __forceinline__ void sts32(void* p, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(smem_u32(p)), "r"(v));
}
__device__ __forceinline__ uint32_t lds32(const void* p) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(smem_u32(p)));
  return v;
}
__device__ __forceinline__ void sts64(void* p, uint2 v) {
  asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n" ::"r"(smem_u32(p)), "r"(v.x), "r"(v.y));
}
__device__ __forceinline__ void sts128(void* p, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(smem_u32(p)), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w));
}

// One row x_row [C] of LN → int8 by the lane `lane` of its warp, into the
// band row r: int8.cuh:ln_quant_kernel's operations in its order (lane l's
// chunks c = l, l + 32, ... of 8 elements in turn, the warp's xor butterfly,
// mean = sum / C, rstd = 1 / sqrt(var / C + eps) correctly rounded, y =
// ((x - mean) · rstd) · scale + bias, then y · (127 / absmax) rounded and
// clipped), so the int8 row and its scale are that kernel's bits. The row
// is read again from the L1 for each pass instead of held in registers (four
// passes: sum, squares, absmax, quantize; y is computed twice, the same
// operations giving the same bits), which keeps this function's registers
// few beside the consumers' 128 accumulators. Returns the row's scale amax ·
// (1/127) (dynamic) or 1 (static).
__device__ __forceinline__ float ln_quant_band_row(const bf16* __restrict__ x_row,
                                                   const float* __restrict__ scale,
                                                   const float* __restrict__ bias, int C,
                                                   float eps, int static_act, int lane,
                                                   uint8_t* band, int r) {
  const int nvec = C / 8;
  const uint4* xr = reinterpret_cast<const uint4*>(x_row);
  float s = 0.f;
  for (int c = lane; c < nvec; c += 32) {
    float v[8];
    unpack8(xr[c], v);
#pragma unroll
    for (int j = 0; j < 8; ++j) s = __fadd_rn(s, v[j]);
  }
  const float mean = __fdiv_rn(warp_sum(s), (float)C);
  float sq = 0.f;
  for (int c = lane; c < nvec; c += 32) {
    float v[8];
    unpack8(xr[c], v);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float d = __fsub_rn(v[j], mean);
      sq = __fadd_rn(sq, __fmul_rn(d, d));
    }
  }
  const float rstd =
      __frcp_rn(__fsqrt_rn(__fadd_rn(__fdiv_rn(warp_sum(sq), (float)C), eps)));
  // y of chunk c into v: ((x - mean) * rstd) * scale + bias, as _layer_norm_f32
  auto normed = [&](int c, float (&v)[8]) {
    unpack8(xr[c], v);
    const float4* sc = reinterpret_cast<const float4*>(scale + 8 * c);
    const float4* bi = reinterpret_cast<const float4*>(bias + 8 * c);
    const float4 s0 = sc[0], s1 = sc[1], b0 = bi[0], b1 = bi[1];
    const float sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v[j], mean), rstd), sv[j]), bv[j]);
  };
  float mul = 1.f, a = 1.f;
  if (!static_act) {
    float amax = 0.f;
    for (int c = lane; c < nvec; c += 32) {
      float v[8];
      normed(c, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(v[j]));
    }
    amax = fmaxf(warp_max(amax), 1e-8f);
    mul = __fdiv_rn(127.f, amax);
    a = __fmul_rn(amax, INV127);
  }
  for (int c = lane; c < nvec; c += 32) {  // chunk c: k 8c .. 8c + 7, half of piece (c % 16) / 2
    float v[8];
    normed(c, v);
    int t[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) t[j] = quant1(__fmul_rn(v[j], mul));
    sts64(band + (c >> 4) * BAND_TILE + sw128(r, (c >> 1) & 7) + 8 * (c & 1),
          make_uint2(pack4_s8(t[0], t[1], t[2], t[3]), pack4_s8(t[4], t[5], t[6], t[7])));
  }
  return a;
}

// The 16-byte piece ch (0..7) of k-block kb of band row r.
__device__ __forceinline__ uint8_t* band_piece(uint8_t* band, int r, int kb, int ch) {
  return band + kb * BAND_TILE + sw128(r, ch);
}

// The consumers' 256 threads (t = 0..255, warp mw = t / 32) make the band
// at m0: the int8 A, each row's dequant scale s_rowa[r] (rows past M, and
// static HEAD rows: unused) and (PROJ) its residual row s_rrow[r] (-1 past
// M). HEAD: warp mw makes rows mw + 8·i, i = 0..15 (ln_quant_band_row). PROJ:
// each row's multiplier first (thread t < 128: row t, into s_mul), then the
// band's 16-element pieces, four a thread at a time, loads first.
template <int FORM>
__device__ __forceinline__ void make_band(const BandArgs& p, uint8_t* band, float* s_rowa,
                                          float* s_mul, int* s_rrow, int m0, int t) {
  const int mw = t >> 5, lane = t & 31;
  if constexpr (FORM == BAND_HEAD) {
    const bf16* x = p.a;
#pragma unroll 1
    for (int i = 0; i < BAND_BM / 8; ++i) {
      const int r = mw + 8 * i, R = m0 + r;
      float a = 0.f;
      if (R < p.M) {
        a = ln_quant_band_row(x + (size_t)R * p.C, p.ln_s, p.ln_b, p.C, p.eps, p.static_act,
                              lane, band, r);
        if (lane == 0) {
          if (p.qs != nullptr && !p.static_act) p.qs[R] = a;
          if (p.zero != nullptr) p.zero[R] = 0.f;
        }
      } else {
        for (int c = lane; c < p.C / 16; c += 32)  // a row past M: zero
          sts128(band_piece(band, r, c >> 3, c & 7), make_uint4(0, 0, 0, 0));
      }
      if (lane == 0) s_rowa[r] = a;
    }
  } else {
    const bf16* o = p.a;
    if (t < BAND_BM) {  // row t's multiplier and dequant scale: quant_rows' operations
      const int R = m0 + t;
      const bool valid = R < p.M;
      float mul = 1.f, a = 1.f;
      if (valid && !p.static_act) {
        const float m = fmaxf(p.amax_in[R], 1e-8f);
        mul = __fdiv_rn(127.f, m);
        a = __fmul_rn(m, INV127);
      }
      s_mul[t] = mul;
      s_rowa[t] = a;
      s_rrow[t] = !valid ? -1
                  : p.res_idx != nullptr ? (R / p.rows_out) * p.rows_in + __ldg(p.res_idx + R)
                                         : R;
    }
    named_sync(1, 256);
    const int per_row = p.C / 16, pieces = BAND_BM * per_row;  // 16 int8 a piece
    constexpr int U = 4;
#pragma unroll 1
    for (int i0 = t; i0 < pieces; i0 += 256 * U) {
      uint4 raw[U][2];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + 256 * u, r = i / per_row;
        const bool valid = i < pieces && m0 + r < p.M;
        const uint4* src = reinterpret_cast<const uint4*>(
            o + (size_t)(m0 + r) * p.C + 16 * (i - r * per_row));
#pragma unroll
        for (int h = 0; h < 2; ++h) raw[u][h] = valid ? src[h] : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + 256 * u, r = i / per_row, pc = i - r * per_row;
        if (i < pieces) {
          const float mul = s_mul[r];
          float f[16];
          unpack8(raw[u][0], f);
          unpack8(raw[u][1], f + 8);
          sts128(band_piece(band, r, pc >> 3, pc & 7), make_uint4(
              quant4(make_float4(f[0], f[1], f[2], f[3]), mul),
              quant4(make_float4(f[4], f[5], f[6], f[7]), mul),
              quant4(make_float4(f[8], f[9], f[10], f[11]), mul),
              quant4(make_float4(f[12], f[13], f[14], f[15]), mul)));
        }
      }
    }
  }
}

template <int FORM>
__global__ void __launch_bounds__(G9_THREADS, 1)
    band_s8_kernel(const __grid_constant__ CUtensorMap wmap,
                   const __grid_constant__ CUtensorMap omap, const BandArgs p) {
  constexpr bool PROJ = FORM == BAND_PROJ;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_aligned(smem_raw);
  const int KT = p.C / BAND_KB, S = p.stages;
  uint8_t* band = sm;
  uint8_t* ring = band + KT * BAND_TILE;
  uint8_t* outbuf = ring + S * BAND_TILE;  // consumer c's chunk buffers: 2c, 2c + 1
  uint64_t* full = reinterpret_cast<uint64_t*>(outbuf + 4 * G9_OUT);
  uint64_t* empty = full + S;
  float* s_rowa = reinterpret_cast<float*>(empty + S);  // the band rows' dequant scales
  int* s_rrow = reinterpret_cast<int*>(s_rowa + BAND_BM);  // PROJ: their residual rows
  float* s_mul = reinterpret_cast<float*>(s_rrow + BAND_BM);  // PROJ: their multipliers
  const int tiles_n = p.N / BAND_BN, bands = (p.M + BAND_BM - 1) / BAND_BM;
  const int wg = warpgroup_id();

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);   // the producer's expect_tx, then the bytes
      mbar_init(&empty[s], 1);  // the consumer of the stage's tile
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {  // producer: W tiles of every band in order, (band, tile, k-block)
    regs_producer();
    if (threadIdx.x == 0) {
      int s = 0, round = 0;
      for (int b = blockIdx.x; b < bands; b += gridDim.x) {
        for (int j = 0; j < tiles_n; ++j) {
          for (int kt = 0; kt < KT; ++kt) {
            if (round > 0) mbar_wait(&empty[s], (round - 1) & 1);
            mbar_expect_tx(&full[s], BAND_TILE);
            tma_load_tile(ring + s * BAND_TILE, &wmap, &full[s], kt * BAND_KB, j * BAND_BN, 0);
            if (++s == S) {
              s = 0;
              ++round;
            }
          }
        }
      }
    }
    return;
  }

  regs_consumer();
  const int cw = wg - 1;  // column tiles j ≡ cw (mod 2)
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int cwarp = (threadIdx.x >> 5) & 3, r0 = cwarp * 16 + g;  // rows r0, r0 + 8 of a half
  const int ct = threadIdx.x & 127;
  const bool leader = ct == 0;
  int q0 = 0;  // the ring sequence number of the band's first W stage
  for (int b = blockIdx.x; b < bands; b += gridDim.x, q0 += tiles_n * KT) {
    const int m0 = b * BAND_BM;
    named_sync(1, 256);  // both consumers' products of the band before have retired
    make_band<FORM>(p, band, s_rowa, s_mul, s_rrow, m0, threadIdx.x - 128);
    fence_proxy_async();  // the band, written by threads, read by wgmma
    named_sync(1, 256);
    for (int j = cw; j < tiles_n; j += 2) {
      if (j > 0) named_sync(2 + cw, 256);  // the turn: the other consumer has issued tile j - 1
      int acc0[64], acc1[64];  // rows 0-63 and 64-127 of the tile, live within it only
#pragma unroll
      for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0;
      int prev = 0;
      for (int kt = 0; kt < KT; ++kt) {
        const int q = q0 + j * KT + kt, s = q % S;
        mbar_wait(&full[s], (q / S) & 1);
        const uint64_t db = desc_k(ring + s * BAND_TILE);
        const uint64_t da0 = desc_k(band + kt * BAND_TILE);
        const uint64_t da1 = desc_k(band + kt * BAND_TILE + 64 * BAND_KB);
        keep_acc(acc0);
        keep_acc(acc1);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_step(acc0, da0 + 2 * kk, db + 2 * kk, kt | kk);
          wgmma_step(acc1, da1 + 2 * kk, db + 2 * kk, kt | kk);
        }
        wg_commit();
        wg_wait1();  // the k-step before has retired: its stage is free
        keep_acc(acc0);
        keep_acc(acc1);
        if (kt > 0 && leader) mbar_arrive(&empty[prev]);
        prev = s;
      }
      if (j + 1 < tiles_n) named_arrive(2 + (cw ^ 1), 256);  // the other consumer's turn
      wg_wait0();
      keep_acc(acc0);
      keep_acc(acc1);
      if (leader) mbar_arrive(&empty[prev]);

      const int n0 = j * BAND_BN;
      // epilogue: chunk u = 2·half + qc (rows 64·half.., columns n0 + 64·qc..),
      // through buffer u % 2 of the consumer's two, stored by TMA
      auto chunk = [&](const int (&acc)[64], int half, int qc) {
        uint8_t* buf = outbuf + (2 * cw + qc) * G9_OUT;
        if (leader) bulk_wait_read<1>();  // the store two chunks back has read buf
        named_sync(4 + cw, 128);
        if constexpr (PROJ) {  // the chunk's residual rows into buf, in their swizzled places
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int pc = ct + 128 * i, r = pc >> 3, ch = pc & 7;
            const int row = s_rrow[64 * half + r];
            cp_async16(buf + sw128(r, ch),
                       p.res + (row >= 0 ? (size_t)row * p.N + n0 + 64 * qc + 8 * ch : 0),
                       row >= 0);
          }
          cp_async_commit();
          cp_async_wait<0>();
          named_sync(4 + cw, 128);
        }
        const float ra[2] = {s_rowa[64 * half + r0], s_rowa[64 * half + r0 + 8]};
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int j8 = 8 * qc + jj, c = n0 + 8 * j8 + 2 * t4;
          const float2 ws = ldg_pair(p.w_scale, c), bi = ldg_pair(p.bias, c);
          float2 l = make_float2(1.f, 1.f);
          if (PROJ && p.ls != nullptr) l = ldg_pair(p.ls, c);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            // I8_BIAS / I8_RESIDUAL: (float)acc [· a] · w_scale + bias [· ls] [+ res]
            float2 v = make_float2(__int2float_rn(acc[4 * j8 + 2 * hh]),
                                   __int2float_rn(acc[4 * j8 + 2 * hh + 1]));
            if (!p.static_act) {
              v.x = __fmul_rn(v.x, ra[hh]);
              v.y = __fmul_rn(v.y, ra[hh]);
            }
            v.x = __fadd_rn(__fmul_rn(v.x, ws.x), bi.x);
            v.y = __fadd_rn(__fmul_rn(v.y, ws.y), bi.y);
            const int byte = (8 * jj + 2 * t4) * 2;
            uint8_t* o = buf + sw128(r0 + 8 * hh, byte >> 4) + (byte & 15);
            if constexpr (PROJ) {
              if (p.ls != nullptr) {
                v.x = __fmul_rn(v.x, l.x);
                v.y = __fmul_rn(v.y, l.y);
              }
              const uint32_t xu = lds32(o);
              const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xu));
              v = make_float2(__fadd_rn(x.x, v.x), __fadd_rn(x.y, v.y));
            }
            sts32(o, pack_bf16x2(v.x, v.y));
          }
        }
        fence_proxy_async();
        named_sync(4 + cw, 128);
        if (leader) {
          tma_store_tile(&omap, buf, n0 + 64 * qc, m0 + 64 * half, 0);
          bulk_commit();
        }
      };
      chunk(acc0, 0, 0);
      chunk(acc0, 0, 1);
      chunk(acc1, 1, 0);
      chunk(acc1, 1, 1);
    }
  }
  if (leader) bulk_wait_all();
}

// out[M, N] (bf16) of the band GEMM of FORM with W [N, C] int8. Returns
// cudaErrorInvalidValue for shapes it does not take (C % 128, C past the
// form's widest, N % 128, a PROJ without a residual, res_idx with rows_out
// not dividing M) and
// cudaErrorMisalignedAddress for operands not 16-byte aligned.
template <int FORM>
inline cudaError_t launch_band(BandArgs p, const int8_t* W, bf16* out, cudaStream_t st) {
  if (p.M < 1 || p.C < BAND_KB || p.C % BAND_KB ||
      p.C > (FORM == BAND_HEAD ? BAND_HEAD_MAX_C : BAND_PROJ_MAX_C) || p.N < BAND_BN ||
      p.N % BAND_BN || p.w_scale == nullptr || p.bias == nullptr)
    return cudaErrorInvalidValue;
  if (FORM == BAND_HEAD ? (p.ln_s == nullptr || p.ln_b == nullptr)
                        : (p.res == nullptr ||
                           (p.res_idx != nullptr &&
                            (p.rows_out < 1 || p.rows_in < 1 || p.M % p.rows_out)) ||
                           (!p.static_act && p.amax_in == nullptr)))
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(p.a) | reinterpret_cast<uintptr_t>(W) |
       reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(p.res)) & 15)
    return cudaErrorMisalignedAddress;
  p.stages = band_stages(p.C);
  CUtensorMap wmap{}, omap{};
  cudaError_t e = make_tile_map(&wmap, W, p.C, p.N, 1, BAND_BN, CU_TENSOR_MAP_DATA_TYPE_UINT8);
  if (e == cudaSuccess) e = make_tile_map(&omap, out, p.N, p.M, 1, 64);
  if (e != cudaSuccess) return e;
  auto kernel = band_s8_kernel<FORM>;
  static int done[KERNEL_CACHE_DEVICES] = {};
  int sms = 0;
  e = ready_kernel(kernel, BAND_SMEM_MAX, done, &sms);
  if (e != cudaSuccess) return e;
  const int bands = (p.M + BAND_BM - 1) / BAND_BM;
  kernel<<<min(bands, sms), G9_THREADS, band_smem(p.C, p.stages), st>>>(wmap, omap, p);
  return cudaGetLastError();
}

}  // namespace
}  // namespace rajni
