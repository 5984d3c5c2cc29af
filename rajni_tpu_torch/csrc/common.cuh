// Building blocks shared by the kernels' entry points (K1
// fused_pruned_attn_block, K2 fused_attn_block, K3 fused_ln_mlp_residual, B4
// fused_ln_qkv, B5 fused_gather_sdpa_proj_residual, B6 fused_sdpa, and the
// whole-block B7, B8, B14 and B15; the int8 parts are in int8.cuh, the
// Hopper GEMM in gemm_sm90.cuh). Each .cu
// file includes this header and exports a plain C entry point that launches
// several of these kernels on the caller's stream; the Python wrapper loads
// it with ctypes.
//
// Numeric contract (the same as the TPU kernels and their plain PyTorch
// versions): LayerNorm statistics in fp32 with the biased variance, the normed
// row rounded to bf16 before the product; every product accumulates in fp32
// from bf16 operands; the epilogue adds the bias in fp32 and rounds where the
// TPU kernel rounds; softmax in fp32 with the probabilities rounded to bf16
// before P·V.
//
// What bounds these kernels on the H100: at batch 256 the QKV, proj, fc1 and
// fc2 products are compute-bound (hundreds of FLOP per byte), so the GEMM is
// the part that matters. Every product runs on the wgmma/TMA GEMM of
// gemm_sm90.cuh (Epilogue and EpilogueArgs below are its bf16 epilogues);
// the long-sequence attention (sdpa.cu) and B18 (sdpa_bwd.cu) also use
// Hopper's wgmma, TMA and mbarriers (hopper.cuh). This header keeps the
// LayerNorm, the register-resident attention (mma.sync m16n8k16), the RAJNI
// scores and the selection.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

// B6's attention body (sdpa.cu): qkv [B, n_src, 3C] bf16, token t of image b
// being row idx[b, t] when idx is given, into out [B, n, C] (fp32 when
// out_fp32, else bf16); with amax, each output row's absmax over its C
// columns too (row_absmax). Returns a cudaError_t.
extern "C" int rajni_sdpa_body(const void* qkv, const int* idx, void* out, float* amax,
                               int out_fp32, int B, int n_src, int n, int C, int H, float scale,
                               void* stream);

// Everything here has internal linkage: the .cu files are separate
// translation units of one library, and each includes its own copy.
namespace rajni {
namespace {

using bf16 = __nv_bfloat16;

// An entry point's return code: 0, or 1000 * (1-based launch step) + the
// cudaError_t of the failing launch.
inline int fail(cudaError_t e, int step) { return step * 1000 + (int)e; }

// ---------------------------------------------------------------------------
// Scalar math
// ---------------------------------------------------------------------------

__device__ __forceinline__ float sigmoidf_(float x) { return 1.0f / (1.0f + expf(-x)); }

// x * sigmoid(P(clamp(x, -6, 6))), P the odd degree-9 logit fit of
// rajni_tpu_torch/kernels/math.py:_GELU_P (6.2e-6 from the erf form).
__device__ __forceinline__ float gelu_fast(float x) {
  const float p0 = 1.595741357441813f, p1 = 0.07277895825923464f,
              p2 = -1.7197148127561505e-4f, p3 = -7.415772250437636e-5f,
              p4 = 2.8973745195906267e-6f;
  float t = fminf(fmaxf(x, -6.0f), 6.0f);
  float t2 = t * t;
  float logit = t * (p0 + t2 * (p1 + t2 * (p2 + t2 * (p3 + t2 * p4))));
  return x * sigmoidf_(logit);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float* f) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}

// D += A·B on the tensor cores: m16n8k16, bf16 in, fp32 accumulate. Fragment
// layout (g = lane / 4, t = lane % 4): a0 (row g, k 2t..2t+1), a1 (row g+8),
// a2 (k + 8), a3 (row g+8, k + 8); b0 (k 2t..2t+1, col g), b1 (k + 8);
// c0,c1 (row g, cols 2t, 2t+1), c2,c3 (row g+8).
__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two adjacent outputs: bf16 (packed, rounded) or fp32 (the int8 blocks'
// attention output, which stays fp32 until it is quantized).
__device__ __forceinline__ void store_pair(bf16* p, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16x2(lo, hi);
}
__device__ __forceinline__ void store_pair(float* p, float lo, float hi) {
  *reinterpret_cast<float2*>(p) = make_float2(lo, hi);
}

// The value store_pair stores for v, as a float: v rounded to bf16, or v.
template <typename OutT>
__device__ __forceinline__ float stored(float v) {
  if constexpr (std::is_same_v<OutT, bf16>) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

// The int8 tails' attention output absmax: amax[row] = max(amax[row], m)
// for m >= 0, on the float's bits (a non-negative float orders as its bits
// do), so the maximum over a row's heads is exact in any order. amax is
// zeroed before the attention launch.
__device__ __forceinline__ void row_absmax(float* amax, size_t row, float m) {
  atomicMax(reinterpret_cast<int*>(amax) + row, __float_as_int(m));
}

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// ---------------------------------------------------------------------------
// LayerNorm: one warp per row, the row cached in registers (C <= 32*8*LN_MAXV)
// ---------------------------------------------------------------------------

constexpr int LN_MAXV = 4;  // uint4 (8 x bf16) vectors per lane: C <= 1024

__global__ void __launch_bounds__(256) layer_norm_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ scale,
    const bf16* __restrict__ bias, bf16* __restrict__ y, int M, int C, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + warp;
  if (row >= M) return;
  const int nvec = C / 8;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * C);
  float v[LN_MAXV][8];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < LN_MAXV; ++i) {
    int c = lane + 32 * i;
    if (c < nvec) {
      unpack8(xr[c], v[i]);
#pragma unroll
      for (int j = 0; j < 8; ++j) s += v[i][j];
    }
  }
  const float mean = warp_sum(s) / (float)C;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < LN_MAXV; ++i) {
    int c = lane + 32 * i;
    if (c < nvec) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float d = v[i][j] - mean;
        q += d * d;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(q) / (float)C + eps);
  const uint4* sr = reinterpret_cast<const uint4*>(scale);
  const uint4* br = reinterpret_cast<const uint4*>(bias);
  uint4* yr = reinterpret_cast<uint4*>(y + (size_t)row * C);
#pragma unroll
  for (int i = 0; i < LN_MAXV; ++i) {
    int c = lane + 32 * i;
    if (c < nvec) {
      float sc[8], bi[8], o[8];
      unpack8(sr[c], sc);
      unpack8(br[c], bi);
#pragma unroll
      for (int j = 0; j < 8; ++j) o[j] = (v[i][j] - mean) * rstd * sc[j] + bi[j];
      yr[c] = pack8(o);
    }
  }
}

inline cudaError_t launch_layer_norm(const bf16* x, const bf16* scale, const bf16* bias,
                                     bf16* y, int M, int C, float eps, cudaStream_t st) {
  layer_norm_kernel<<<(M + 7) / 8, 256, 0, st>>>(x, scale, bias, y, M, C, eps);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The bf16 epilogues of gemm_sm90.cuh's GEMM, out[M, N] = epilogue(A[M, K] ·
// W[N, K]ᵀ), from the fp32 sum acc: EPI_BIAS acc + b; EPI_GELU gelu(acc + b)
// (K3: the GELU of the fp32 sum); EPI_RESIDUAL res + (acc + b) · ls;
// EPI_GELU_SAVE (B17 train_ln_mlp): h = round(acc + b) goes to ep.aux, and
// out gets round(gelu_fast(h)) computed from that rounded h, the GELU of the
// stored value.
// ---------------------------------------------------------------------------

enum Epilogue { EPI_BIAS = 0, EPI_GELU = 1, EPI_RESIDUAL = 2, EPI_GELU_SAVE = 3 };

struct EpilogueArgs {
  const bf16* bias;      // [N]
  const bf16* ls;        // [N] layer scale, or null (ones)
  const bf16* res;       // residual rows, or null (no residual add)
  const int* res_idx;    // [M] token index into res per output row, or null
  int rows_out;          // output rows per image (res_idx addressing)
  int rows_in;           // residual rows per image (res_idx addressing)
  bf16* aux;             // EPI_GELU_SAVE: the pre-GELU h [M, N]
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = valid ? 16 : 0;  // src-size 0 zero-fills the destination
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// ---------------------------------------------------------------------------
// Attention: one block of 4 warps per (64-query tile, head, image), head_dim 64.
//   Reads q/k/v rows of the packed qkv [B, n_src, 3C] (lanes (qkv, head, dim)),
//   token t of the attended sequence being row idx[b, t] when idx is given
//   (the one-hot gather of the TPU kernel: sel is 0/1, so it IS a gather),
//   else row t. Writes out [B, n, C] in OutT: bf16 (rounded), or fp32 for
//   the int8 blocks (_mha_mixed's fp32 output, block.py:1663, 2329).
//   Form: the "phased" SDPA of the TPU kernels — q scaled in fp32 and rounded
//   to bf16, logits = q·kᵀ in fp32, full-row fp32 softmax exp(l - max) *
//   (1 / sum), P rounded to bf16, P·V in fp32, output rounded. No online
//   rescaling: each warp keeps its 16 query rows' whole logit rows in
//   registers (mma.sync m16n8k16 accumulators), so the rounding points are
//   those of the plain version. K (row-major) and V (transposed) of the head
//   sit in shared memory; the P accumulators become the A operand of P·V
//   without leaving registers.
// ---------------------------------------------------------------------------

constexpr int ATTN_D = 64, ATTN_QT = 64, ATTN_LDH = ATTN_D + 8, ATTN_MAX_N = 256;

__host__ __device__ inline int attn_npad(int n) { return (n + 15) / 16 * 16; }
__host__ __device__ inline int attn_smem(int n) {
  return attn_npad(n) * ATTN_LDH * 2 + ATTN_D * (attn_npad(n) + 8) * 2;
}

// Two adjacent q values, scaled in fp32 and rounded (zero past the sequence).
__device__ __forceinline__ uint32_t q_pair(const bf16* row, int d, float scale) {
  if (row == nullptr) return 0u;
  float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(row + d));
  return pack_bf16x2(f.x * scale, f.y * scale);
}

// MAXT: the most 16-token tiles this instantiation keeps in registers.
template <int MAXT, typename OutT>
__global__ void __launch_bounds__(128) attention_kernel(
    const bf16* __restrict__ qkv, const int* __restrict__ idx, OutT* __restrict__ out,
    float* __restrict__ amax, int n_src, int n, int C, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int npad = attn_npad(n), nt = npad / 16, ldv = npad + 8;
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [npad][ATTN_LDH]
  bf16* Vt = Ks + npad * ATTN_LDH;               // [ATTN_D][ldv], V transposed

  const int q0 = blockIdx.x * ATTN_QT, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;  // mma fragment row group / column pair
  const size_t row3 = (size_t)3 * C;
  const bf16* base = qkv + (size_t)b * n_src * row3 + h * ATTN_D;

  for (int c = tid; c < npad * 8; c += 128) {
    const int t = c >> 3, col = (c & 7) * 8;
    uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
    if (t < n) {
      const int src = idx ? idx[(size_t)b * n + t] : t;
      const bf16* r = base + (size_t)src * row3;
      kv = *reinterpret_cast<const uint4*>(r + C + col);
      vv = *reinterpret_cast<const uint4*>(r + 2 * C + col);
    }
    *reinterpret_cast<uint4*>(Ks + t * ATTN_LDH + col) = kv;
    const bf16* v8 = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
    for (int j = 0; j < 8; ++j) Vt[(col + j) * ldv + t] = v8[j];
  }

  // This warp's two fragment rows: query q0 + 16*warp + g and + 8.
  const int ra = q0 + warp * 16 + g, rb = ra + 8;
  const bf16* qa = nullptr;
  const bf16* qb = nullptr;
  if (ra < n) qa = base + (size_t)(idx ? idx[(size_t)b * n + ra] : ra) * row3;
  if (rb < n) qb = base + (size_t)(idx ? idx[(size_t)b * n + rb] : rb) * row3;
  uint32_t qf[4][4];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const int d = ks * 16 + 2 * t4;
    qf[ks][0] = q_pair(qa, d, scale);
    qf[ks][1] = q_pair(qb, d, scale);
    qf[ks][2] = q_pair(qa, d + 8, scale);
    qf[ks][3] = q_pair(qb, d + 8, scale);
  }
  __syncthreads();

  // S = Q Kᵀ: s[j][0..3] covers tokens 16j + (0..7), s[j][4..7] tokens 16j + (8..15);
  // elements 0,1 / 4,5 are row ra, 2,3 / 6,7 row rb, at tokens +2*t4 and +2*t4+1.
  float s[MAXT][8];
#pragma unroll
  for (int j = 0; j < MAXT; ++j) {
#pragma unroll
    for (int e = 0; e < 8; ++e) s[j][e] = 0.f;
    if (j < nt) {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const bf16* k0 = Ks + (16 * j + g) * ATTN_LDH + ks * 16 + 2 * t4;
        const bf16* k1 = k0 + 8 * ATTN_LDH;
        mma_16816(s[j], qf[ks], ld_u32(k0), ld_u32(k0 + 8));
        mma_16816(s[j] + 4, qf[ks], ld_u32(k1), ld_u32(k1 + 8));
      }
    }
  }

  float ma = -INFINITY, mb = -INFINITY;
#pragma unroll
  for (int j = 0; j < MAXT; ++j) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int tok = 16 * j + (e & 4 ? 8 : 0) + 2 * t4 + (e & 1);
      if (j >= nt || tok >= n) s[j][e] = -INFINITY;
      if (e & 2) mb = fmaxf(mb, s[j][e]);
      else ma = fmaxf(ma, s[j][e]);
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    ma = fmaxf(ma, __shfl_xor_sync(0xffffffffu, ma, o));
    mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, o));
  }
  float sa = 0.f, sb = 0.f;
#pragma unroll
  for (int j = 0; j < MAXT; ++j) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float p = expf(s[j][e] - ((e & 2) ? mb : ma));
      s[j][e] = p;
      if (e & 2) sb += p;
      else sa += p;
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    sa += __shfl_xor_sync(0xffffffffu, sa, o);
    sb += __shfl_xor_sync(0xffffffffu, sb, o);
  }
  const float ia = 1.0f / sa, ib = 1.0f / sb;

  // O = P V: the accumulator layout of S is the A-fragment layout of P.
  float o[8][4];
#pragma unroll
  for (int dt = 0; dt < 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
#pragma unroll
  for (int j = 0; j < MAXT; ++j) {
    if (j < nt) {
      uint32_t pa[4];
      pa[0] = pack_bf16x2(s[j][0] * ia, s[j][1] * ia);
      pa[1] = pack_bf16x2(s[j][2] * ib, s[j][3] * ib);
      pa[2] = pack_bf16x2(s[j][4] * ia, s[j][5] * ia);
      pa[3] = pack_bf16x2(s[j][6] * ib, s[j][7] * ib);
#pragma unroll
      for (int dt = 0; dt < 8; ++dt) {
        const bf16* v = Vt + (dt * 8 + g) * ldv + 16 * j + 2 * t4;
        mma_16816(o[dt], pa, ld_u32(v), ld_u32(v + 8));
      }
    }
  }

  OutT* oa = out + ((size_t)b * n + ra) * C + h * ATTN_D + 2 * t4;
  OutT* ob = oa + (size_t)8 * C;
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
    if (ra < n) store_pair(oa + dt * 8, o[dt][0], o[dt][1]);
    if (rb < n) store_pair(ob + dt * 8, o[dt][2], o[dt][3]);
  }
  if (amax != nullptr) {  // the int8 tails: |stored value|'s maximum over the head's columns
    float ma = 0.f, mb = 0.f;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      ma = fmaxf(ma, fmaxf(fabsf(stored<OutT>(o[dt][0])), fabsf(stored<OutT>(o[dt][1]))));
      mb = fmaxf(mb, fmaxf(fabsf(stored<OutT>(o[dt][2])), fabsf(stored<OutT>(o[dt][3]))));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {  // over the four lanes of each row
      ma = fmaxf(ma, __shfl_xor_sync(0xffffffffu, ma, off));
      mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, off));
    }
    if (t4 == 0 && ra < n) row_absmax(amax, (size_t)b * n + ra, ma);
    if (t4 == 0 && rb < n) row_absmax(amax, (size_t)b * n + rb, mb);
  }
}

template <int MAXT, typename OutT>
inline cudaError_t launch_attention_t(const bf16* qkv, const int* idx, OutT* out, float* amax,
                                      int B, int n_src, int n, int C, int H, float scale,
                                      cudaStream_t st) {
  const int smem = attn_smem(n);
  cudaError_t e = cudaFuncSetAttribute(attention_kernel<MAXT, OutT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((n + ATTN_QT - 1) / ATTN_QT, H, B);
  attention_kernel<MAXT, OutT><<<grid, 128, smem, st>>>(qkv, idx, out, amax, n_src, n, C,
                                                         scale);
  return cudaGetLastError();
}

// amax: null, or the int8 tails' [B·n] row absmax (row_absmax), zeroed.
template <typename OutT>
inline cudaError_t launch_attention(const bf16* qkv, const int* idx, OutT* out, float* amax,
                                    int B, int n_src, int n, int C, int H, float scale,
                                    cudaStream_t st) {
  const int tiles = attn_npad(n) / 16;
  if (tiles <= 8) return launch_attention_t<8>(qkv, idx, out, amax, B, n_src, n, C, H, scale, st);
  if (tiles <= 13)
    return launch_attention_t<13>(qkv, idx, out, amax, B, n_src, n, C, H, scale, st);
  if (tiles <= 16)
    return launch_attention_t<16>(qkv, idx, out, amax, B, n_src, n, C, H, scale, st);
  return cudaErrorInvalidValue;  // n > ATTN_MAX_N: the wrapper refuses it first
}

// ---------------------------------------------------------------------------
// Long-sequence attention: B6 fused_sdpa's formula, also the attention of K2,
// B5 and K1/B20 past ATTN_MAX_N tokens and of the int8 tails from
// INT8_TAIL_SDPA_MIN_N tokens (int8.cuh). The body is the
// wgmma kernel of sdpa.cu (its header has the design), compiled once there
// and reached from the other translation units through rajni_sdpa_body.
// ---------------------------------------------------------------------------

constexpr int SDPA_MAX_N = 848;

template <typename OutT>
inline cudaError_t launch_sdpa(const bf16* qkv, const int* idx, OutT* out, float* amax, int B,
                               int n_src, int n, int C, int H, float scale, cudaStream_t st) {
  return static_cast<cudaError_t>(rajni_sdpa_body(qkv, idx, out, amax, sizeof(OutT) == 4, B,
                                                  n_src, n, C, H, scale, st));
}

// The attention of K2 and B5: the register-resident kernel up to ATTN_MAX_N
// tokens, B6's body above it. At head_dim 64 the scale is 1/8 and
// both forms give the same bits.
template <typename OutT>
inline cudaError_t launch_attention_any(const bf16* qkv, const int* idx, OutT* out, int B,
                                        int n_src, int n, int C, int H, float scale,
                                        cudaStream_t st) {
  if (n <= ATTN_MAX_N)
    return launch_attention(qkv, idx, out, nullptr, B, n_src, n, C, H, scale, st);
  return launch_sdpa(qkv, idx, out, nullptr, B, n_src, n, C, H, scale, st);
}

// ---------------------------------------------------------------------------
// RAJNI scores (K1, B4, B19, B20 and the int8 B11, B12, B14): scores[b, 0..N)
// in fp32, following _importance_f32 (rajni_tpu/kernels/block.py:340) from
// the bf16 (rounded) qkv [B, N, 3C]: CLS-row softmax over all heads with
// 1/sqrt(D), the head mean of the probabilities; head-mean V centred over
// tokens; unbiased std of the value norms with eps after the sqrt; sigmoid
// z-score. Only the order of the fp32 sums differs from the plain version.
//
// Bound on the H100: bytes. Every k and v row is read once (N · 2C · 2 bytes
// an image: 0.16 GB at batch 256, N=197, C=768, 46 us at 3.35 TB/s) for ~2
// FLOP a byte on the CUDA cores.
//
// Design: one cluster of CL blocks an image (CL = 2 up to 512 tokens, else
// 4), block r taking the tokens [r·T, min(N, (r+1)·T)), T = ceil(N / CL), so
// that CL·B blocks of 8 warps (two an SM) keep the memory busy where one
// block an image left 128 blocks at batch 128 for 132 SMs. A warp streams a
// token's whole k and v rows in 16-byte pieces (lane l holds pieces l + 32j,
// head l/8 + 4j at head_dim 64); the CLS q's pieces sit in its registers. A
// head's logit is the lanes' products summed over its 8 lanes (shuffles
// within the 8); the head mean of v is each lane's heads summed and then
// across the 4 lanes of the same 8 dims. A warp takes two tokens at a time,
// both rows' loads in flight together (one at C > 768, where the registers
// would not hold two). The block keeps its tokens' logits and head-mean
// values (fp32) in shared memory and each warp a running max a head and ΣV
// a dim. The statistics over the whole image are two-phase: each block
// stores its partials (max and Σe a head, ΣV a dim, Σ vn, Σ (vn − mu)²) into
// its slot of every block of the cluster (distributed shared memory), and
// after a cluster barrier each block reduces the CL slots in rank order, so
// every block gets the same bits. Three barriers wait (max and ΣV; Σe and
// Σ vn; Σ (vn − mu)²); one more is only arrived at on entry and waited on
// before the first remote store (every block of the cluster has started).
// After the last no block touches another's shared memory, so blocks leave
// without a barrier.
// ---------------------------------------------------------------------------

constexpr int SCORE_THREADS = 256;  // 8 warps
constexpr int SCORE_WARPS = SCORE_THREADS / 32;
constexpr int SCORE_CL_MAX = 4;

// Blocks (one cluster) an image, and the tokens of each.
__host__ __device__ inline int score_cluster(int N) { return N <= 512 ? 2 : SCORE_CL_MAX; }
__host__ __device__ inline int score_tokens(int N) {
  return (N + score_cluster(N) - 1) / score_cluster(N);
}
// Shared memory of a block; the kernel takes head_dim 64, C % 64 == 0, C <=
// 1024 and 2 <= N <= 1024 (score_tokens(N) <= SCORE_THREADS).
__host__ __device__ inline int score_smem(int N, int C, int H) {
  const int T = score_tokens(N), D = C / H;
  return (T * (D + H + 1) + (SCORE_WARPS + 2 * SCORE_CL_MAX + 2) * H +
          (SCORE_WARPS + SCORE_CL_MAX + 1) * D + 2 * SCORE_CL_MAX + SCORE_WARPS) *
         4;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// NV: the 16-byte pieces of a q, k or v row a lane holds, ceil(C / 256); CL:
// the cluster's blocks.
template <int NV, int CL>
__global__ void __launch_bounds__(SCORE_THREADS, 2)
    score_kernel(const bf16* __restrict__ qkv, float* __restrict__ scores, int N, int C, int H,
                 float eps) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive();  // waited on before the first store into another block
  extern __shared__ __align__(16) float sm[];
  const int D = C / H, T = score_tokens(N);
  float* s_V = sm;                              // [T][D] head-mean values of the block's tokens
  float* s_e = s_V + T * D;                     // [H][T] CLS logits, then e^(l - max)
  float* s_vn = s_e + H * T;                    // [T] value norms
  float* s_wmax = s_vn + T;                     // [warp][H] each warp's running max
  float* s_wv = s_wmax + SCORE_WARPS * H;       // [warp][D] each warp's running ΣV
  float* s_max = s_wv + SCORE_WARPS * D;        // [rank][H] every block's max, stored by it
  float* s_sum = s_max + SCORE_CL_MAX * H;      // [rank][H] every block's Σe
  float* s_v = s_sum + SCORE_CL_MAX * H;        // [rank][D] every block's ΣV
  float* s_gmax = s_v + SCORE_CL_MAX * D;       // [H] the image's max logit
  float* s_inv = s_gmax + H;                    // [H] 1 / the image's Σe
  float* s_mean = s_inv + H;                    // [D] the image's mean V
  float* s_vns = s_mean + D;                    // [rank] every block's Σ vn
  float* s_dev = s_vns + SCORE_CL_MAX;          // [rank] every block's Σ (vn - mu)²
  float* s_warp = s_dev + SCORE_CL_MAX;         // [warp] partials of a block sum

  const int b = blockIdx.x / CL, rank = static_cast<int>(cluster.block_rank());
  const int n0 = rank * T, cnt = max(0, min(N, n0 + T) - n0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int pieces = C / 8;  // 16-byte pieces of a q, k or v row; head h's are 8h..8h+7
  const size_t row3 = (size_t)3 * C;
  const bf16* base = qkv + (size_t)b * N * row3;
  const float inv_sqrt_d = 1.0f / sqrtf((float)D), inv_h = 1.0f / (float)H;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  // this block's partial into its slot of every block of the cluster
  auto push = [&](float* slot, float v) {
#pragma unroll
    for (int r = 0; r < CL; ++r) *cluster.map_shared_rank(slot, r) = v;
  };

  uint4 qv[NV];  // the CLS q's pieces of this lane
  float hmax[NV], vsum[8];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int ci = lane + 32 * j;
    qv[j] = ci < pieces ? __ldg(reinterpret_cast<const uint4*>(base) + ci) : zero;
    hmax[j] = -INFINITY;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) vsum[e] = 0.f;

  // a token's k and v pieces of this lane
  auto load = [&](int t, uint4 (&kp)[NV], uint4 (&vp)[NV]) {
    const uint4* row = reinterpret_cast<const uint4*>(base + (size_t)(n0 + t) * row3);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int ci = lane + 32 * j;
      kp[j] = ci < pieces ? __ldg(row + pieces + ci) : zero;
      vp[j] = ci < pieces ? __ldg(row + 2 * pieces + ci) : zero;
    }
  };
  // its logits (one a head, into s_e and the running max) and head-mean V
  // (into s_V and the running ΣV)
  auto token = [&](int t, const uint4 (&kp)[NV], const uint4 (&vp)[NV]) {
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      float qf[8], kf[8], vf[8];
      unpack8(qv[j], qf);
      unpack8(kp[j], kf);
      unpack8(vp[j], vf);
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) dot += qf[e] * kf[e];
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);  // the head's 8 lanes
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      dot += __shfl_xor_sync(0xffffffffu, dot, 4);
      if (lane + 32 * j < pieces) {
        const float l = dot * inv_sqrt_d;
        if ((lane & 7) == 0) s_e[((lane >> 3) + 4 * j) * T + t] = l;
        hmax[j] = fmaxf(hmax[j], l);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] += vf[e] * inv_h;
      }
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {  // over the lanes of the same 8 dims
      v[e] += __shfl_xor_sync(0xffffffffu, v[e], 8);
      v[e] += __shfl_xor_sync(0xffffffffu, v[e], 16);
      vsum[e] += v[e];
    }
    if (lane < 8) {
      float4* dst = reinterpret_cast<float4*>(s_V + t * D + 8 * lane);
      dst[0] = make_float4(v[0], v[1], v[2], v[3]);
      dst[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
  };
  // two tokens a warp at a time (t and t + 8), both rows' loads in flight,
  // where the registers hold them (NV <= 3: C <= 768)
  constexpr int STEP = NV <= 3 ? 2 : 1;
  for (int t = warp; t < cnt; t += STEP * SCORE_WARPS) {
    const bool two = STEP == 2 && t + SCORE_WARPS < cnt;
    uint4 kp[NV], vp[NV], kp2[NV], vp2[NV];
    load(t, kp, vp);
    if (two) load(t + SCORE_WARPS, kp2, vp2);
    token(t, kp, vp);
    if (two) token(t + SCORE_WARPS, kp2, vp2);
  }
#pragma unroll
  for (int j = 0; j < NV; ++j)
    if ((lane & 7) == 0 && lane + 32 * j < pieces) s_wmax[warp * H + (lane >> 3) + 4 * j] = hmax[j];
  if (lane < 8) {
#pragma unroll
    for (int e = 0; e < 8; ++e) s_wv[warp * D + 8 * lane + e] = vsum[e];
  }
  __syncthreads();
  cluster_wait();  // every block of the cluster has started
  if (tid < H) {
    float m = -INFINITY;
    for (int w = 0; w < SCORE_WARPS; ++w) m = fmaxf(m, s_wmax[w * H + tid]);
    push(s_max + rank * H + tid, m);
  } else if (tid >= 64 && tid < 64 + D) {
    float a = 0.f;
    for (int w = 0; w < SCORE_WARPS; ++w) a += s_wv[w * D + tid - 64];
    push(s_v + rank * D + tid - 64, a);
  }
  cluster.sync();  // 1: every block's max a head and ΣV a dim

  if (tid < H) {
    float m = -INFINITY;
#pragma unroll
    for (int r = 0; r < CL; ++r) m = fmaxf(m, s_max[r * H + tid]);
    s_gmax[tid] = m;
  } else if (tid >= 64 && tid < 64 + D) {
    float a = 0.f;
#pragma unroll
    for (int r = 0; r < CL; ++r) a += s_v[r * D + tid - 64];
    s_mean[tid - 64] = a / (float)N;
  }
  __syncthreads();
  for (int h = warp; h < H; h += SCORE_WARPS) {  // e^(l - max) and the block's Σe, a warp a head
    const float m = s_gmax[h];
    float a = 0.f;
    for (int t = lane; t < cnt; t += 32) {
      const float e = expf(s_e[h * T + t] - m);
      s_e[h * T + t] = e;
      a += e;
    }
    a = warp_sum(a);
    if (lane == 0) push(s_sum + rank * H + h, a);
  }
  for (int t = warp; t < cnt; t += SCORE_WARPS) {  // value norms, a warp a token
    float a = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float c = s_V[t * D + d] - s_mean[d];
      a += c * c;
    }
    a = warp_sum(a);
    if (lane == 0) s_vn[t] = sqrtf(a);
  }
  __syncthreads();
  if (warp == 0) {
    float a = 0.f;
    for (int t = lane; t < cnt; t += 32) a += s_vn[t];
    a = warp_sum(a);
    if (lane == 0) push(s_vns + rank, a);
  }
  cluster.sync();  // 2: every block's Σe a head and Σ vn

  if (tid < H) {
    float a = 0.f;
#pragma unroll
    for (int r = 0; r < CL; ++r) a += s_sum[r * H + tid];
    s_inv[tid] = 1.0f / a;
  }
  float mu = 0.f;
#pragma unroll
  for (int r = 0; r < CL; ++r) mu += s_vns[r];
  mu = mu / (float)N;
  __syncthreads();
  float a_cls = 0.f, vn = 0.f, dev = 0.f;
  if (tid < cnt) {  // a thread a token
    for (int h = 0; h < H; ++h) a_cls += s_e[h * T + tid] * s_inv[h];
    a_cls = a_cls / (float)H;
    vn = s_vn[tid];
    dev = (vn - mu) * (vn - mu);
  }
  dev = warp_sum(dev);
  if (lane == 0) s_warp[warp] = dev;
  __syncthreads();
  if (tid == 0) {
    float a = 0.f;
    for (int w = 0; w < SCORE_WARPS; ++w) a += s_warp[w];
    push(s_dev + rank, a);
  }
  cluster.sync();  // 3: every block's Σ (vn - mu)²; no remote access after this

  float var = 0.f;
#pragma unroll
  for (int r = 0; r < CL; ++r) var += s_dev[r];
  var = var / (float)(N - 1);
  const float sd = sqrtf(var) + eps;
  if (tid < cnt) scores[(size_t)b * N + n0 + tid] = a_cls * sigmoidf_((vn - mu) / sd);
}

template <int NV>
inline cudaError_t launch_score_nv(const bf16* qkv, float* scores, int B, int N, int C, int H,
                                   float eps, cudaStream_t st) {
  const int cl = score_cluster(N), smem = score_smem(N, C, H);
  auto kernel = cl == 2 ? score_kernel<NV, 2> : score_kernel<NV, SCORE_CL_MAX>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * cl);
  cfg.blockDim = dim3(SCORE_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, qkv, scores, N, C, H, eps);
  return e == cudaSuccess ? cudaGetLastError() : e;
}

inline cudaError_t launch_score(const bf16* qkv, float* scores, int B, int N, int C, int H,
                                float eps, cudaStream_t st) {
  if (N < 2 || score_tokens(N) > SCORE_THREADS || C % 64 || C > 1024 || C != 64 * H)
    return cudaErrorInvalidValue;
  switch ((C / 8 + 31) / 32) {
    case 1: return launch_score_nv<1>(qkv, scores, B, N, C, H, eps, st);
    case 2: return launch_score_nv<2>(qkv, scores, B, N, C, H, eps, st);
    case 3: return launch_score_nv<3>(qkv, scores, B, N, C, H, eps, st);
    default: return launch_score_nv<4>(qkv, scores, B, N, C, H, eps, st);
  }
}

// ---------------------------------------------------------------------------
// Selection (K1 and B14): one block per image, following _select_from_scores
// (block.py:722): CLS ranked +inf, rank[n] = #{m : s_m > s_n or (s_m == s_n
// and m < n)}, the K lowest ranks kept in ascending index order,
// next_scores the real scores of the kept tokens (CLS's own included).
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(256) select_kernel(const float* __restrict__ scores,
                                                     int* __restrict__ idx_out,
                                                     float* __restrict__ ns_out, int N, int K) {
  extern __shared__ __align__(16) float sm[];
  float* s_score = sm;                              // [N]
  int* s_kept = reinterpret_cast<int*>(sm + N);     // [N]
  const int b = blockIdx.x, tid = threadIdx.x;
  for (int n = tid; n < N; n += 256) s_score[n] = scores[(size_t)b * N + n];
  __syncthreads();

  for (int n = tid; n < N; n += 256) {
    const float kn = (n == 0) ? INFINITY : s_score[n];
    int rank = 0;
    for (int m = 0; m < N; ++m) {
      const float km = (m == 0) ? INFINITY : s_score[m];
      rank += (km > kn) || (km == kn && m < n);
    }
    s_kept[n] = rank < K;
  }
  __syncthreads();
  if (tid == 0) {
    int pos = 0;
    for (int n = 0; n < N; ++n) {
      if (s_kept[n]) {
        idx_out[(size_t)b * K + pos] = n;
        ns_out[(size_t)b * K + pos] = s_score[n];
        ++pos;
      }
    }
  }
}

inline cudaError_t launch_select(const float* scores, int* idx_out, float* ns_out, int B, int N,
                                 int K, cudaStream_t st) {
  select_kernel<<<B, 256, 2 * N * 4, st>>>(scores, idx_out, ns_out, N, K);
  return cudaGetLastError();
}

}  // namespace
}  // namespace rajni
