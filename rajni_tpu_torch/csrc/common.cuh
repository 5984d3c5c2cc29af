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
// Hopper's wgmma, TMA and mbarriers (hopper.cuh), as does every attention
// up to 256 tokens (short_attn.cu). This header keeps the LayerNorm, the
// RAJNI scores, the selection and the attention's routing.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

// B6's attention body (sdpa.cu): qkv [B, n_src, 3C] bf16, token t of image b
// being row idx[b, t] when idx is given, into out [B, n, C] (fp32 when
// out_fp32, else bf16); with amax, each output row's absmax over its C
// columns too (row_absmax); with phased, q·scale rounded to bf16 before q·kᵀ
// (mha_phased). Returns a cudaError_t.
extern "C" int rajni_sdpa_body(const void* qkv, const int* idx, void* out, float* amax,
                               int out_fp32, int B, int n_src, int n, int C, int H, float scale,
                               int phased, void* stream);
// The short-row attention (short_attn.cu): the same function for n <=
// ATTN_MAX_N, qkv [B, n_src, 3C] with n == n_src when idx is null. Returns a
// cudaError_t.
extern "C" int rajni_short_attn_body(const void* qkv, const int* idx, void* out, float* amax,
                                     int out_fp32, int B, int n_src, int n, int C, int H,
                                     float scale, int phased, void* stream);

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

// ---------------------------------------------------------------------------
// LayerNorm: one warp per row, the row cached in registers (C <= 32*8*NV)
// ---------------------------------------------------------------------------

constexpr int LN_MAXV = 4;  // uint4 (8 x bf16) vectors per lane: C <= 1024
constexpr int LN_MAXV_WIDE = 5;  // at C <= 1280 (ViT-H/14); int8.cuh's LN → int8 takes both

// NV: the vectors a lane holds, LN_MAXV up to C = 1024 (the sums in the order
// they always had), LN_MAXV_WIDE past it.
template <int NV>
__global__ void __launch_bounds__(256) layer_norm_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ scale,
    const bf16* __restrict__ bias, bf16* __restrict__ y, int M, int C, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + warp;
  if (row >= M) return;
  const int nvec = C / 8;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * C);
  float v[NV][8];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
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
  for (int i = 0; i < NV; ++i) {
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
  for (int i = 0; i < NV; ++i) {
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
  if (C % 8 || C > 256 * LN_MAXV_WIDE) return cudaErrorInvalidValue;
  if (C <= 256 * LN_MAXV)
    layer_norm_kernel<LN_MAXV><<<(M + 7) / 8, 256, 0, st>>>(x, scale, bias, y, M, C, eps);
  else
    layer_norm_kernel<LN_MAXV_WIDE><<<(M + 7) / 8, 256, 0, st>>>(x, scale, bias, y, M, C, eps);
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
// Attention, head_dim 64 or 80 (ViT-H/14's; bf16 and the int8 tails). Up to
// ATTN_MAX_N tokens every caller's attention is the short-row kernel of
// short_attn.cu (its header has the design), past it B6's body (sdpa.cu);
// both are compiled once there, each instantiated for both head widths, and
// reached from the other translation units through their C entry points.
// ---------------------------------------------------------------------------

constexpr int ATTN_D = 64, ATTN_D80 = 80, ATTN_MAX_N = 256;

// Long-sequence attention: B6 fused_sdpa's formula, also the attention of
// K2, B5, K1/B20 and the int8 tails past ATTN_MAX_N tokens. At head_dim 80
// B6's body runs one pass of at most 3 key tiles a consumer (sdpa.cu), so at
// most 384 tokens.
constexpr int SDPA_MAX_N = 848, SDPA_MAX_N_D80 = 384;

__host__ __device__ inline bool attn_head_dim_ok(int D) { return D == ATTN_D || D == ATTN_D80; }
// The longest row B6's body takes at head_dim D (0: none).
inline int sdpa_max_n(int D) {
  return D == ATTN_D ? SDPA_MAX_N : D == ATTN_D80 ? SDPA_MAX_N_D80 : 0;
}

template <typename OutT>
inline cudaError_t launch_sdpa(const bf16* qkv, const int* idx, OutT* out, float* amax, int B,
                               int n_src, int n, int C, int H, float scale, bool phased,
                               cudaStream_t st) {
  return static_cast<cudaError_t>(rajni_sdpa_body(qkv, idx, out, amax, sizeof(OutT) == 4, B,
                                                  n_src, n, C, H, scale, phased, st));
}

template <typename OutT>
inline cudaError_t launch_short_attention(const bf16* qkv, const int* idx, OutT* out,
                                          float* amax, int B, int n_src, int n, int C, int H,
                                          float scale, bool phased, cudaStream_t st) {
  return static_cast<cudaError_t>(rajni_short_attn_body(qkv, idx, out, amax, sizeof(OutT) == 4,
                                                        B, n_src, n, C, H, scale, phased, st));
}

// Whether the TPU kernels' _mha (rajni_tpu/kernels/block.py:136) takes its
// phased form on n tokens: q·scale in fp32 rounded to bf16 before q·kᵀ, while
// H·n²·6 <= 4 MiB; else the per-head form, the scale on the fp32 logits. At
// a power-of-two scale (head_dim 64's 1/8) both forms give the same bits, so
// the kernels take the phased one only where the scale is not a power of two
// (head_dim 80's 80^-0.5). kernels/attention.py:mha_phased is the same test.
inline bool mha_phased(int H, int n, float scale) {
  int e;
  return (long long)H * n * n * 6 <= 4ll * 1024 * 1024 && frexpf(scale, &e) != 0.5f;
}

// Every caller's attention (K1/B20, K2 so B8 and B16, B5, and with the row
// absmax amax or null the int8 tails B10, B11, B13-B15): the short-row
// kernel up to SHORT_ATTN_MAX_N tokens, contiguous or through idx, B6's body
// past it. The crossover that set it (chip_smoke.py's crossover phase, H100
// SXM 700 W, B = 256, bf16 output, device time, at 47, 67, 96, 120, 138 and
// 197 tokens, C = 768 and 1024): the short-row kernel read 0.36-0.69x B6's
// body contiguous and 0.20-0.43x gathered; in its first (ex2) form, in
// another call, 0.25-0.61x the register kernel (mma.sync, one block a
// 64-query tile) that it replaced. So no n up to 256 keeps another kernel,
// and the register kernel was deleted. Both take _mha's form (mha_phased):
// the phased one rounds q·scale in the Q tile, the per-head one scales the
// fp32 logits.
constexpr int SHORT_ATTN_MAX_N = ATTN_MAX_N;

template <typename OutT>
inline cudaError_t launch_attention_any(const bf16* qkv, const int* idx, OutT* out, float* amax,
                                        int B, int n_src, int n, int C, int H, float scale,
                                        cudaStream_t st) {
  const bool phased = mha_phased(H, n, scale);
  if (n <= SHORT_ATTN_MAX_N)
    return launch_short_attention(qkv, idx, out, amax, B, n_src, n, C, H, scale, phased, st);
  return launch_sdpa(qkv, idx, out, amax, B, n_src, n, C, H, scale, phased, st);
}

// ---------------------------------------------------------------------------
// RAJNI scores (K1, B4, B19, B20 and the int8 B11, B12, B14; head_dim 64, and
// 80 for the bf16 K1 and B4 at ViT-H/14): scores[b, 0..N)
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
// token's whole k and v rows in 16-byte pieces; the CLS q's pieces sit in
// its registers.
//   * Head_dim 64: lane l holds pieces l + 32j, of head l/8 + 4j. A head's
//     logit is the lanes' products summed over its 8 lanes (shuffles within
//     the 8); the head mean of v is each lane's heads summed and then across
//     the 4 lanes of the same 8 dims. A warp takes two tokens at a time,
//     both rows' loads in flight together (one at C > 768, where the
//     registers would not hold two). Each warp keeps a running ΣV a dim.
//   * Head_dim 80 (a head is 10 pieces, which fall in no aligned group of 8
//     lanes): lane l holds the 5 pieces 10·(l/2) + 5·(l%2) + j of head l/2
//     (H <= 16, C <= 1280), its dims 40·(l%2) + 8j..+7. A head's logit is
//     the lane's 5 pieces summed and one shuffle across the pair; the head
//     mean of v is summed across the 16 lanes of the same parity (4
//     shuffles a value). One token at a time, its 10 pieces a lane in
//     flight; the CLS q is read from shared memory (in registers beside
//     them it spilled under the 128 that two blocks an SM leave). The
//     block's ΣV a dim is summed over its tokens' head-mean values in
//     shared memory.
// The block keeps its tokens' logits and head-mean values (fp32) in shared
// memory and each warp a running max a head. The statistics over the whole
// image are two-phase: each block
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
// Shared memory of a block; the kernel takes head_dim 64 (C % 64 == 0, C <=
// 1024) or 80 (H <= 16, C <= 1280), and 2 <= N <= 1024 (score_tokens(N) <=
// SCORE_THREADS).
__host__ __device__ inline int score_smem(int N, int C, int H, bool pair) {
  const int T = score_tokens(N), D = C / H;
  return (T * (D + H + 1) + (SCORE_WARPS + 2 * SCORE_CL_MAX + 2) * H +
          (SCORE_WARPS + SCORE_CL_MAX + 1) * D + 2 * SCORE_CL_MAX + SCORE_WARPS) *
             4 +
         (pair ? 2 * C : 0);  // two lanes a head: the CLS q row, bf16
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// D: the head_dim (64 or 80); NV: the 16-byte pieces of a q, k or v row a
// lane holds, ceil(C / 256) at head_dim 64, or 0 for two lanes a head (D/16
// pieces a lane: head_dim 80); CL: the cluster's blocks.
template <int D_, int NV, int CL>
__global__ void __launch_bounds__(SCORE_THREADS, 2)
    score_kernel(const bf16* __restrict__ qkv, float* __restrict__ scores, int N, int C, int H,
                 float eps) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive();  // waited on before the first store into another block
  extern __shared__ __align__(16) float sm[];
  constexpr bool PAIR = NV == 0;  // two lanes a head
  constexpr int PL = D_ / 16;     // then the pieces of a lane
  const int D = C / H, T = score_tokens(N);
  // two lanes a head: the CLS q row (C bf16, a multiple of 16 bytes) first
  const int q_floats = PAIR ? C / 2 : 0;
  float* s_V = sm + q_floats;                   // [T][D] head-mean values of the block's tokens
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

  if constexpr (PAIR) {
    // lane: head hh's pieces p0..p0+PL-1 (dims (D/2)·half + 8j..+7); lanes
    // past 2H hold zeros
    const int hh = lane >> 1, half = lane & 1, p0 = (D_ / 8) * hh + PL * half;
    const bool live = hh < H;
    uint4* s_q = reinterpret_cast<uint4*>(sm);
    for (int i = tid; i < pieces; i += SCORE_THREADS)
      s_q[i] = __ldg(reinterpret_cast<const uint4*>(base) + i);
    __syncthreads();
    const uint4* qv = s_q + (live ? p0 : 0);
    float hm = -INFINITY;
    for (int t = warp; t < cnt; t += SCORE_WARPS) {
      const uint4* row = reinterpret_cast<const uint4*>(base + (size_t)(n0 + t) * row3);
      uint4 kp[PL], vp[PL];
#pragma unroll
      for (int j = 0; j < PL; ++j) {
        kp[j] = live ? __ldg(row + pieces + p0 + j) : zero;
        vp[j] = live ? __ldg(row + 2 * pieces + p0 + j) : zero;
      }
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < PL; ++j) {
        float qf[8], kf[8];
        unpack8(qv[j], qf);
        unpack8(kp[j], kf);
#pragma unroll
        for (int e = 0; e < 8; ++e) dot += qf[e] * kf[e];
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);  // the head's two lanes
      const float l = dot * inv_sqrt_d;
      if (live) {
        if (half == 0) s_e[hh * T + t] = l;
        hm = fmaxf(hm, l);
      }
#pragma unroll
      for (int j = 0; j < PL; ++j) {
        float v[8];
        unpack8(vp[j], v);
#pragma unroll
        for (int e = 0; e < 8; ++e) {  // over the heads: the lanes of the same parity
          v[e] *= inv_h;
          v[e] += __shfl_xor_sync(0xffffffffu, v[e], 2);
          v[e] += __shfl_xor_sync(0xffffffffu, v[e], 4);
          v[e] += __shfl_xor_sync(0xffffffffu, v[e], 8);
          v[e] += __shfl_xor_sync(0xffffffffu, v[e], 16);
        }
        if (lane < 2) {
          float4* dst = reinterpret_cast<float4*>(s_V + t * D + (D_ / 2) * lane + 8 * j);
          dst[0] = make_float4(v[0], v[1], v[2], v[3]);
          dst[1] = make_float4(v[4], v[5], v[6], v[7]);
        }
      }
    }
    if (live && half == 0) s_wmax[warp * H + hh] = hm;
    __syncthreads();
    if (tid >= 64 && tid < 64 + D) {  // the block's ΣV a dim, over its tokens
      float a = 0.f;
      for (int t = 0; t < cnt; ++t) a += s_V[t * D + tid - 64];
      s_wv[tid - 64] = a;  // the block's sum, in warp 0's slot
    }
  } else {
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
      if ((lane & 7) == 0 && lane + 32 * j < pieces)
        s_wmax[warp * H + (lane >> 3) + 4 * j] = hmax[j];
    if (lane < 8) {
#pragma unroll
      for (int e = 0; e < 8; ++e) s_wv[warp * D + 8 * lane + e] = vsum[e];
    }
  }
  __syncthreads();
  cluster_wait();  // every block of the cluster has started
  if (tid < H) {
    float m = -INFINITY;
    for (int w = 0; w < SCORE_WARPS; ++w) m = fmaxf(m, s_wmax[w * H + tid]);
    push(s_max + rank * H + tid, m);
  } else if (tid >= 64 && tid < 64 + D) {
    float a = 0.f;
    if constexpr (PAIR) {
      a = s_wv[tid - 64];
    } else {
      for (int w = 0; w < SCORE_WARPS; ++w) a += s_wv[w * D + tid - 64];
    }
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

template <int D, int NV>
inline cudaError_t launch_score_nv(const bf16* qkv, float* scores, int B, int N, int C, int H,
                                   float eps, cudaStream_t st) {
  const int cl = score_cluster(N), smem = score_smem(N, C, H, NV == 0);
  auto kernel = cl == 2 ? score_kernel<D, NV, 2> : score_kernel<D, NV, SCORE_CL_MAX>;
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
  if (N < 2 || score_tokens(N) > SCORE_THREADS || H < 1) return cudaErrorInvalidValue;
  if (C == ATTN_D80 * H && H <= 16)  // head_dim 80: two lanes a head
    return launch_score_nv<ATTN_D80, 0>(qkv, scores, B, N, C, H, eps, st);
  if (C % 64 || C > 1024 || C != ATTN_D * H) return cudaErrorInvalidValue;
  switch ((C / 8 + 31) / 32) {
    case 1: return launch_score_nv<ATTN_D, 1>(qkv, scores, B, N, C, H, eps, st);
    case 2: return launch_score_nv<ATTN_D, 2>(qkv, scores, B, N, C, H, eps, st);
    case 3: return launch_score_nv<ATTN_D, 3>(qkv, scores, B, N, C, H, eps, st);
    default: return launch_score_nv<ATTN_D, 4>(qkv, scores, B, N, C, H, eps, st);
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
