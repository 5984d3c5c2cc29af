// Building blocks shared by the kernels' entry points (K1
// fused_pruned_attn_block, K2 fused_attn_block, K3 fused_ln_mlp_residual, B4
// fused_ln_qkv, B5 fused_gather_sdpa_proj_residual, B6 fused_sdpa, and the
// whole-block B7, B8, B14 and B15; the int8 parts are in int8.cuh). Each .cu
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
// the part that matters. This header's GEMM (gemm_bf16_kernel) reaches the
// tensor cores through ldmatrix + mma.sync m16n8k16 (Ampere-style); K1, B4,
// B5 and B17 still take it. K2 and K3 (and B7's MLP half, B8 and B16 through
// them) take the wgmma/TMA GEMM of gemm_sm90.cuh; the long-sequence attention
// (sdpa.cu) and B18 (sdpa_bwd.cu) also use Hopper's wgmma, TMA and mbarriers
// (hopper.cuh).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

// B6's attention body (sdpa.cu): qkv [B, n_src, 3C] bf16, token t of image b
// being row idx[b, t] when idx is given, into out [B, n, C] (fp32 when
// out_fp32, else bf16). Returns a cudaError_t.
extern "C" int rajni_sdpa_body(const void* qkv, const int* idx, void* out, int out_fp32, int B,
                               int n_src, int n, int C, int H, float scale, void* stream);

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

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Four 8x8 bf16 matrices from shared memory; lanes 8i..8i+7 give the row
// addresses of matrix i, and register i receives matrix i in mma layout.
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const bf16* p) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
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
// GEMM: out[M, N] = epilogue(A[M, K] @ W[N, K]^T)
//   A row-major bf16 (activations), W row-major [out, in] bf16 (nn.Linear
//   layout): both operands are K-contiguous, so both come to the tensor cores
//   through ldmatrix (no transpose). 128x128x64 block tiles, 4 warps of 64x64,
//   two blocks per SM (so one block's epilogue overlaps the other's main
//   loop), a 3-stage cp.async ring in shared memory with 16-byte chunks XOR-swizzled
//   by row (conflict-free for the copies and for ldmatrix), mma.sync
//   m16n8k16 with fp32 accumulators, and the epilogue applied straight from
//   the accumulator registers.
//   Requires K % 64 == 0 and N % 8 == 0; M and N are masked.
// ---------------------------------------------------------------------------

// EPI_GELU_SAVE (B17 train_ln_mlp): h = round(acc + bias) goes to ep.aux,
// and out gets round(gelu_fast(h)) computed from that rounded h — the GELU
// of the stored value, where EPI_GELU (K3) takes it of the fp32 sum.
enum Epilogue { EPI_BIAS = 0, EPI_GELU = 1, EPI_RESIDUAL = 2, EPI_GELU_SAVE = 3 };

constexpr int GEMM_BM = 128, GEMM_BN = 128, GEMM_BK = 64, GEMM_STAGES = 3, GEMM_THREADS = 128;
constexpr int GEMM_SMEM = GEMM_STAGES * (GEMM_BM + GEMM_BN) * GEMM_BK * 2;

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

// Element offset of 16-byte chunk `chunk` (0..7) of row `row` in a tile whose
// rows are GEMM_BK = 64 bf16 (128 bytes) long.
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * GEMM_BK + ((chunk ^ (row & 7)) << 3);
}

template <int EPI>
__global__ void __launch_bounds__(GEMM_THREADS, 2) gemm_bf16_kernel(
    const bf16* __restrict__ A, const bf16* __restrict__ W, bf16* __restrict__ out,
    int M, int N, int K, EpilogueArgs ep) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);
  bf16* Bs = As + GEMM_STAGES * GEMM_BM * GEMM_BK;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * GEMM_BM, n0 = blockIdx.x * GEMM_BN;
  const int wm = warp >> 1, wn = warp & 1;  // 2 x 2 warps, 64 x 64 each
  const int KT = K / GEMM_BK;

  auto load_stage = [&](int slot, int k0) {
    bf16* as = As + slot * GEMM_BM * GEMM_BK;
    bf16* bs = Bs + slot * GEMM_BN * GEMM_BK;
#pragma unroll
    for (int i = 0; i < GEMM_BM * 8 / GEMM_THREADS; ++i) {  // A: 8 chunks a row
      const int c = tid + i * GEMM_THREADS, r = c >> 3, ch = c & 7, gr = m0 + r;
      cp_async16(as + swz(r, ch), A + (size_t)(gr < M ? gr : 0) * K + k0 + ch * 8, gr < M);
    }
#pragma unroll
    for (int i = 0; i < GEMM_BN * 8 / GEMM_THREADS; ++i) {  // W: 8 chunks a row
      const int c = tid + i * GEMM_THREADS, r = c >> 3, ch = c & 7, gn = n0 + r;
      cp_async16(bs + swz(r, ch), W + (size_t)(gn < N ? gn : 0) * K + k0 + ch * 8, gn < N);
    }
  };

  float acc[4][8][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < GEMM_STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s * GEMM_BK);
    cp_async_commit();
  }

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<GEMM_STAGES - 2>();
    __syncthreads();
    const int next = kt + GEMM_STAGES - 1;
    if (next < KT) load_stage(next % GEMM_STAGES, next * GEMM_BK);
    cp_async_commit();

    const bf16* as = As + (kt % GEMM_STAGES) * GEMM_BM * GEMM_BK;
    const bf16* bs = Bs + (kt % GEMM_STAGES) * GEMM_BN * GEMM_BK;
#pragma unroll
    for (int kk = 0; kk < GEMM_BK / 16; ++kk) {
      uint32_t af[4][4], bfr[8][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldmatrix_x4(af[i], as + swz(wm * 64 + i * 16 + (lane & 15), kk * 2 + (lane >> 4)));
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        uint32_t r[4];
        const int nrow = wn * 64 + jj * 16 + (lane & 7) + ((lane >> 4) << 3);
        ldmatrix_x4(r, bs + swz(nrow, kk * 2 + ((lane >> 3) & 1)));
        bfr[2 * jj][0] = r[0];
        bfr[2 * jj][1] = r[1];
        bfr[2 * jj + 1][0] = r[2];
        bfr[2 * jj + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) mma_16816(acc[i][j], af[i], bfr[j][0], bfr[j][1]);
    }
  }
  cp_async_wait<0>();

  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = n0 + wn * 64 + j * 8 + 2 * t4;
    if (c >= N) continue;
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(ep.bias + c));
    float2 l = make_float2(1.f, 1.f);
    if (EPI == EPI_RESIDUAL && ep.ls != nullptr)
      l = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(ep.ls + c));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m0 + wm * 64 + i * 16 + g + half * 8;
        if (r >= M) continue;
        float v0 = acc[i][j][2 * half] + b.x, v1 = acc[i][j][2 * half + 1] + b.y;
        if (EPI == EPI_GELU) {
          v0 = gelu_fast(v0);
          v1 = gelu_fast(v1);
        } else if (EPI == EPI_GELU_SAVE) {
          const uint32_t hb = pack_bf16x2(v0, v1);
          *reinterpret_cast<uint32_t*>(ep.aux + (size_t)r * N + c) = hb;
          const float2 hr = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hb));
          v0 = gelu_fast(hr.x);
          v1 = gelu_fast(hr.y);
        } else if (EPI == EPI_RESIDUAL) {
          if (ep.ls != nullptr) {
            v0 *= l.x;
            v1 *= l.y;
          }
          if (ep.res != nullptr) {
            size_t rr = (size_t)r;
            if (ep.res_idx != nullptr)
              rr = (size_t)(r / ep.rows_out) * ep.rows_in + ep.res_idx[r];
            const float2 x =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(ep.res + rr * N + c));
            v0 = x.x + v0;
            v1 = x.y + v1;
          }
        }
        *reinterpret_cast<uint32_t*>(out + (size_t)r * N + c) = pack_bf16x2(v0, v1);
      }
    }
  }
}

template <int EPI>
inline cudaError_t launch_gemm(const bf16* A, const bf16* W, bf16* out, int M, int N, int K,
                               EpilogueArgs ep, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(gemm_bf16_kernel<EPI>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, GEMM_SMEM);
  if (e != cudaSuccess) return e;
  dim3 grid((N + GEMM_BN - 1) / GEMM_BN, (M + GEMM_BM - 1) / GEMM_BM);
  gemm_bf16_kernel<EPI><<<grid, GEMM_THREADS, GEMM_SMEM, st>>>(A, W, out, M, N, K, ep);
  return cudaGetLastError();
}

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
    int n_src, int n, int C, float scale) {
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
}

template <int MAXT, typename OutT>
inline cudaError_t launch_attention_t(const bf16* qkv, const int* idx, OutT* out, int B,
                                      int n_src, int n, int C, int H, float scale,
                                      cudaStream_t st) {
  const int smem = attn_smem(n);
  cudaError_t e = cudaFuncSetAttribute(attention_kernel<MAXT, OutT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((n + ATTN_QT - 1) / ATTN_QT, H, B);
  attention_kernel<MAXT, OutT><<<grid, 128, smem, st>>>(qkv, idx, out, n_src, n, C, scale);
  return cudaGetLastError();
}

template <typename OutT>
inline cudaError_t launch_attention(const bf16* qkv, const int* idx, OutT* out, int B, int n_src,
                                    int n, int C, int H, float scale, cudaStream_t st) {
  const int tiles = attn_npad(n) / 16;
  if (tiles <= 8) return launch_attention_t<8>(qkv, idx, out, B, n_src, n, C, H, scale, st);
  if (tiles <= 13) return launch_attention_t<13>(qkv, idx, out, B, n_src, n, C, H, scale, st);
  if (tiles <= 16) return launch_attention_t<16>(qkv, idx, out, B, n_src, n, C, H, scale, st);
  return cudaErrorInvalidValue;  // n > ATTN_MAX_N: the wrapper refuses it first
}

// ---------------------------------------------------------------------------
// Long-sequence attention: B6 fused_sdpa's formula, also the attention of K2,
// B5, K1/B20 and the int8 tails past ATTN_MAX_N tokens. The body is the
// wgmma kernel of sdpa.cu (its header has the design), compiled once there
// and reached from the other translation units through rajni_sdpa_body.
// ---------------------------------------------------------------------------

constexpr int SDPA_MAX_N = 848;

template <typename OutT>
inline cudaError_t launch_sdpa(const bf16* qkv, const int* idx, OutT* out, int B, int n_src,
                               int n, int C, int H, float scale, cudaStream_t st) {
  return static_cast<cudaError_t>(rajni_sdpa_body(qkv, idx, out, sizeof(OutT) == 4, B, n_src, n,
                                                  C, H, scale, st));
}

// The attention of K2 and B5: the register-resident kernel up to ATTN_MAX_N
// tokens, B6's body above it. At head_dim 64 the scale is 1/8 and
// both forms give the same bits.
template <typename OutT>
inline cudaError_t launch_attention_any(const bf16* qkv, const int* idx, OutT* out, int B,
                                        int n_src, int n, int C, int H, float scale,
                                        cudaStream_t st) {
  if (n <= ATTN_MAX_N) return launch_attention(qkv, idx, out, B, n_src, n, C, H, scale, st);
  return launch_sdpa(qkv, idx, out, B, n_src, n, C, H, scale, st);
}

// ---------------------------------------------------------------------------
// RAJNI scores (K1 and B4): one block of 256 threads per image writes
// scores[b, 0..N) in fp32, following _importance_f32 from the bf16 (rounded)
// qkv [B, N, 3C]: CLS-row softmax over all heads with 1/sqrt(D), head-mean;
// head-mean V centred over tokens; unbiased std with eps after the sqrt;
// sigmoid z-score. ~2·N·C multiply-adds an image on the CUDA cores.
// ---------------------------------------------------------------------------

__host__ __device__ inline int score_smem(int N, int C, int H) {
  const int D = C / H;
  return (C + H * N + N * D + 2 * N + D + 2) * 4;
}

__global__ void __launch_bounds__(256) score_kernel(const bf16* __restrict__ qkv,
                                                    float* __restrict__ scores, int N, int C,
                                                    int H, float eps) {
  extern __shared__ __align__(16) float sm[];
  const int D = C / H;
  float* s_q = sm;               // [C] CLS query
  float* s_logit = s_q + C;      // [H, N] CLS logits, then softmax
  float* s_V = s_logit + H * N;  // [N, D] head-mean values
  float* s_score = s_V + N * D;  // [N]
  float* s_vn = s_score + N;     // [N]
  float* s_mean = s_vn + N;      // [D]
  float* s_stat = s_mean + D;    // mu, std

  const int b = blockIdx.x, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t row3 = (size_t)3 * C;
  const bf16* base = qkv + (size_t)b * N * row3;

  for (int c = tid; c < C; c += 256) s_q[c] = __bfloat162float(base[c]);
  __syncthreads();
  const float inv_sqrt_d = 1.0f / sqrtf((float)D);
  for (int p = tid; p < H * N; p += 256) {
    const int h = p / N, n = p % N;
    const bf16* k = base + (size_t)n * row3 + C + h * D;
    float dot = 0.f;
    for (int d = 0; d < D; ++d) dot += s_q[h * D + d] * __bfloat162float(k[d]);
    s_logit[h * N + n] = dot * inv_sqrt_d;
  }
  __syncthreads();
  for (int h = warp; h < H; h += 8) {
    float* l = s_logit + h * N;
    float m = -INFINITY;
    for (int n = lane; n < N; n += 32) m = fmaxf(m, l[n]);
    m = warp_max(m);
    float s = 0.f;
    for (int n = lane; n < N; n += 32) {
      float e = expf(l[n] - m);
      l[n] = e;
      s += e;
    }
    const float inv = 1.0f / warp_sum(s);
    for (int n = lane; n < N; n += 32) l[n] *= inv;
  }
  __syncthreads();
  const float inv_h = 1.0f / (float)H;
  for (int n = tid; n < N; n += 256) {
    float a = 0.f;
    for (int h = 0; h < H; ++h) a += s_logit[h * N + n];
    s_score[n] = a / (float)H;
  }
  for (int p = tid; p < N * D; p += 256) {
    const int n = p / D, d = p % D;
    const bf16* v = base + (size_t)n * row3 + 2 * C + d;
    float s = 0.f;
    for (int h = 0; h < H; ++h) s += __bfloat162float(v[h * D]) * inv_h;
    s_V[p] = s;
  }
  __syncthreads();
  for (int d = tid; d < D; d += 256) {
    float s = 0.f;
    for (int n = 0; n < N; ++n) s += s_V[n * D + d];
    s_mean[d] = s / (float)N;
  }
  __syncthreads();
  for (int n = tid; n < N; n += 256) {
    float s = 0.f;
    for (int d = 0; d < D; ++d) {
      float t = s_V[n * D + d] - s_mean[d];
      s += t * t;
    }
    s_vn[n] = sqrtf(s);
  }
  __syncthreads();
  if (tid == 0) {
    float mu = 0.f;
    for (int n = 0; n < N; ++n) mu += s_vn[n];
    mu /= (float)N;
    float var = 0.f;
    for (int n = 0; n < N; ++n) var += (s_vn[n] - mu) * (s_vn[n] - mu);
    var /= (float)(N - 1);
    s_stat[0] = mu;
    s_stat[1] = sqrtf(var) + eps;
  }
  __syncthreads();
  for (int n = tid; n < N; n += 256)
    scores[(size_t)b * N + n] = s_score[n] * sigmoidf_((s_vn[n] - s_stat[0]) / s_stat[1]);
}

inline cudaError_t launch_score(const bf16* qkv, float* scores, int B, int N, int C, int H,
                                float eps, cudaStream_t st) {
  const int smem = score_smem(N, C, H);
  cudaError_t e =
      cudaFuncSetAttribute(score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  score_kernel<<<B, 256, smem, st>>>(qkv, scores, N, C, H, eps);
  return cudaGetLastError();
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
