// K1: fused_pruned_attn_block — the pruned attention half of a RAJNI block:
// LN1 → QKV → RAJNI score (or the threaded prev_scores) → top-K selection with
// CLS forced → gather of QKV and of the pre-norm x → SDPA on the K kept tokens
// → proj → ·ls1 → compacted residual. Returns x [B, K, C], next_scores [B, K]
// and the kept indices [B, K].
//
// Replaces the TPU kernel rajni_tpu/kernels/block.py:fused_pruned_attn_block
// (pallas_call at block.py:1553), with its helpers _importance_f32
// (block.py:340) and _select_from_scores (block.py:722).
//
// Bound on the H100: compute. At batch 256, N=197→K=187 the QKV (at N),
// proj (at K) and attention (at K) products are ~2.6e11 FLOP; scoring and
// selection are ~2e8 operations of fp32 CUDA-core work.
//
// Design: five launches on the caller's stream — row LayerNorm, GEMM QKV
// (+bias→round) into a [B, N, 3C] device scratch, the score-and-select kernel
// below (one block per image), the shared attention kernel reading q/k/v rows
// through the kept indices (a gather is exactly what the TPU kernel's one-hot
// product computes, since sel is 0/1), and GEMM proj whose residual epilogue
// reads the pre-norm x rows through the same indices.
#include "common.cuh"

using namespace rajni;

namespace rajni {
namespace {

// One block per image. Scores follow _importance_f32 from the bf16 (rounded)
// qkv: CLS-row softmax over all heads with 1/sqrt(D), head-mean; head-mean V
// centred over tokens; unbiased std with eps after the sqrt; sigmoid z-score.
// Selection follows _select_from_scores: CLS ranked +inf, rank[n] = #{m : s_m >
// s_n or (s_m == s_n and m < n)}, the K lowest ranks kept in ascending index
// order, next_scores the real scores of the kept tokens (CLS's own included).
__global__ void __launch_bounds__(256) score_select_kernel(
    const bf16* __restrict__ qkv, const float* __restrict__ prev, int with_scores,
    int* __restrict__ idx_out, float* __restrict__ ns_out, int N, int K, int C, int H, float eps) {
  extern __shared__ __align__(16) float sm[];
  const int D = C / H;
  float* s_q = sm;                  // [C] CLS query
  float* s_logit = s_q + C;         // [H, N] CLS logits, then softmax
  float* s_V = s_logit + H * N;     // [N, D] head-mean values
  float* s_score = s_V + N * D;     // [N]
  float* s_vn = s_score + N;        // [N]
  float* s_mean = s_vn + N;         // [D]
  float* s_stat = s_mean + D;       // mu, std
  int* s_kept = reinterpret_cast<int*>(s_stat + 2);  // [N]

  const int b = blockIdx.x, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t row3 = (size_t)3 * C;
  const bf16* base = qkv + (size_t)b * N * row3;

  if (with_scores) {
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
      s_score[n] *= sigmoidf_((s_vn[n] - s_stat[0]) / s_stat[1]);
  } else {
    for (int n = tid; n < N; n += 256) s_score[n] = prev[(size_t)b * N + n];
  }
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

int score_select_smem(int N, int C, int H) {
  const int D = C / H;
  return (C + H * N + N * D + 2 * N + D + 2) * 4 + N * 4;
}

}  // namespace
}  // namespace rajni

extern "C" int rajni_pruned_attn_block(
    const void* x, const void* ln_scale, const void* ln_bias, const void* wqkv, const void* bqkv,
    const void* wproj, const void* bproj, const void* ls, const void* prev_scores,
    int with_scores, void* y_scratch, void* qkv_scratch, void* attn_scratch, void* idx_out,
    void* ns_out, void* out, int B, int N, int K, int C, int H, float scale, float eps,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = launch_layer_norm(static_cast<const bf16*>(x), static_cast<const bf16*>(ln_scale),
                                    static_cast<const bf16*>(ln_bias),
                                    static_cast<bf16*>(y_scratch), B * N, C, eps, st);
  if (e != cudaSuccess) return fail(e, 1);

  EpilogueArgs ep1{static_cast<const bf16*>(bqkv), nullptr, nullptr, nullptr, 1, 1};
  e = launch_gemm<EPI_BIAS>(static_cast<const bf16*>(y_scratch), static_cast<const bf16*>(wqkv),
                            static_cast<bf16*>(qkv_scratch), B * N, 3 * C, C, ep1, st);
  if (e != cudaSuccess) return fail(e, 2);

  const int smem = score_select_smem(N, C, H);
  e = cudaFuncSetAttribute(score_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return fail(e, 3);
  score_select_kernel<<<B, 256, smem, st>>>(
      static_cast<const bf16*>(qkv_scratch), static_cast<const float*>(prev_scores), with_scores,
      static_cast<int*>(idx_out), static_cast<float*>(ns_out), N, K, C, H, 1e-6f);
  e = cudaGetLastError();
  if (e != cudaSuccess) return fail(e, 4);

  e = launch_attention(static_cast<const bf16*>(qkv_scratch), static_cast<const int*>(idx_out),
                       static_cast<bf16*>(attn_scratch), B, N, K, C, H, scale, st);
  if (e != cudaSuccess) return fail(e, 5);

  EpilogueArgs ep2{static_cast<const bf16*>(bproj), static_cast<const bf16*>(ls),
                   static_cast<const bf16*>(x), static_cast<const int*>(idx_out), K, N};
  e = launch_gemm<EPI_RESIDUAL>(static_cast<const bf16*>(attn_scratch),
                                static_cast<const bf16*>(wproj), static_cast<bf16*>(out), B * K,
                                C, C, ep2, st);
  return e == cudaSuccess ? 0 : fail(e, 6);
}
