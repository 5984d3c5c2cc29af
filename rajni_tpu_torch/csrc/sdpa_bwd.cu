// B18: train_sdpa_bwd — the SDPA forward recomputed and differentiated, per
// head: (qkv [B, K, 3C], d_out [B, K, C]) -> (attn_out [B, K, C],
// d_qkv [B, K, 3C]), d_qkv packed [dQ | dK | dV] in the (qkv, head, dim) lane
// order of qkv, everything bf16 in and out.
//
// Replaces the TPU kernel rajni_tpu/kernels/train.py:train_sdpa_bwd
// (pallas_call at train.py:310, body _sdpa_bwd_kernel at 222), which holds one
// image's qkv and one head's [K, K] fp32 matrices in VMEM. Its numerics, per
// head, are kept term by term:
//   s = (q·kᵀ in fp32)·scale;  p32 = e·(1/Σe), e = exp(s − max);  pb = bf16(p32)
//   attn_out = pb·v;  dv = pbᵀ·dO;  dp = dO·vᵀ (fp32)
//   ds = p32∘(dp − rowsum(dp∘p32));  dsb = bf16(ds·scale)
//   dq = dsb·k;  dk = dsbᵀ·q           (each accumulated in fp32, rounded once)
// The row term is taken from the fp32 dp and p32, as the TPU kernel takes
// it, not FlashAttention's rowsum(dO∘O): O is built from the rounded pb and
// rounded itself, so that shortcut gives other numbers.
//
// Bound on the H100: bytes. At batch 128, K=197, C=768 the six [K,K]x[K,64]
// products are 4.6e10 FLOP (0.05 ms at 989 TFLOP/s) against 0.31 GB in and out
// (0.09 ms at 3.35 TB/s).
//
// Design: FlashAttention-2's backward in two launches, with 64-token tiles of
// one head staged in shared memory (four 64x64 bf16 tiles, 37 KB, so any K
// up to SDPA_MAX_N and beyond) and mma.sync m16n8k16 products, fp32
// accumulators in registers; four warps a block, each owning 16 rows.
//   1. One block per (64-query tile, head, image). Pass 1 over the key tiles
//      takes each row's max and Σe (the running sum rescaled as the max
//      rises, as common.cuh:sdpa_kernel does). Pass 2 recomputes p32 and pb,
//      accumulates attn_out = pb·V, and the row term δ = Σ dp∘p32 from
//      dp = dO·Vᵀ; it writes attn_out and (max, 1/Σe, δ) as fp32 [3, B, H, K].
//      Pass 3 recomputes p32, dp and dsb and accumulates dQ = dsb·K.
//   2. One block per (64-key tile, head, image): over the query tiles it
//      recomputes sᵀ = K·Qᵀ, p32ᵀ from the saved (max, 1/Σe), pbᵀ, dpᵀ =
//      V·dOᵀ and dsbᵀ, and accumulates dV = pbᵀ·dO and dK = dsbᵀ·Q.
// No atomics: each output element is summed by one thread, so the result
// is deterministic. p32 is recomputed in the second launch from the first's
// statistics, as FlashAttention does; the logits there come from the same
// bf16 operands in another mma order, so p32 may differ in its last fp32 bit.
#include "common.cuh"

namespace rajni {
namespace {

constexpr int BT = 64;         // tokens per tile, queries or keys
constexpr int LDT = ATTN_LDH;  // row stride (elements) of a 64-wide bf16 tile

// Tokens [t0, t0 + 64) of one head's 64 columns (src: token 0 of those
// columns, `stride` elements a token, n tokens, zero past them), row-major
// into `rows` ([tok][d]) and transposed into `cols` ([d][tok]); either may be
// null.
__device__ __forceinline__ void load_tile(const bf16* __restrict__ src, size_t stride, int t0,
                                          int n, bf16* rows, bf16* cols) {
  for (int c = threadIdx.x; c < BT * 8; c += blockDim.x) {
    const int t = c >> 3, col = (c & 7) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (t0 + t < n) v = *reinterpret_cast<const uint4*>(src + (size_t)(t0 + t) * stride + col);
    if (rows != nullptr) *reinterpret_cast<uint4*>(rows + t * LDT + col) = v;
    if (cols != nullptr) {
      const bf16* v8 = reinterpret_cast<const bf16*>(&v);
#pragma unroll
      for (int j = 0; j < 8; ++j) cols[(col + j) * LDT + t] = v8[j];
    }
  }
}

// A fragments (k = the 64 head dims) of rows ra and rb = ra + 8 of one head;
// a null row is zero.
__device__ __forceinline__ void load_rows(uint32_t (&f)[4][4], const bf16* ra, const bf16* rb,
                                          int t4) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const int d = ks * 16 + 2 * t4;
    f[ks][0] = ra ? ld_u32(ra + d) : 0u;
    f[ks][1] = rb ? ld_u32(rb + d) : 0u;
    f[ks][2] = ra ? ld_u32(ra + d + 8) : 0u;
    f[ks][3] = rb ? ld_u32(rb + d + 8) : 0u;
  }
}

// acc = A·Yᵀ for a 64-token tile Y ([tok][d]): acc[nt][0..1] is row g at
// tokens 8nt + 2t4 and + 1, acc[nt][2..3] row g + 8.
__device__ __forceinline__ void mma_abt(float (&acc)[8][4], const uint32_t (&a)[4][4],
                                        const bf16* Y, int g, int t4) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const bf16* y = Y + (nt * 8 + g) * LDT + ks * 16 + 2 * t4;
      mma_16816(acc[nt], a[ks], ld_u32(y), ld_u32(y + 8));
    }
  }
}

// out += bf16(P)·Z: P a warp's 16 x 64 fp32 tile in acc layout, rounded to
// bf16 here; Z ([tok][d]) given transposed, Zt ([d][tok]).
__device__ __forceinline__ void mma_pz(float (&out)[8][4], const float (&p)[8][4], const bf16* Zt,
                                       int g, int t4) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t a[4] = {pack_bf16x2(p[2 * kk][0], p[2 * kk][1]),
                           pack_bf16x2(p[2 * kk][2], p[2 * kk][3]),
                           pack_bf16x2(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           pack_bf16x2(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      const bf16* z = Zt + (dt * 8 + g) * LDT + kk * 16 + 2 * t4;
      mma_16816(out[dt], a, ld_u32(z), ld_u32(z + 8));
    }
  }
}

// A warp's 16 x 64 result rounded to bf16 into rows oa and ob (null: skip).
__device__ __forceinline__ void store_rows(bf16* oa, bf16* ob, const float (&o)[8][4], int t4) {
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
    if (oa != nullptr) store_pair(oa + dt * 8 + 2 * t4, o[dt][0], o[dt][1]);
    if (ob != nullptr) store_pair(ob + dt * 8 + 2 * t4, o[dt][2], o[dt][3]);
  }
}

__global__ void __launch_bounds__(128) sdpa_bwd_query_kernel(
    const bf16* __restrict__ qkv, const bf16* __restrict__ dout, bf16* __restrict__ ao,
    bf16* __restrict__ dqkv, float* __restrict__ stats, int n, int C, float scale) {
  __shared__ __align__(16) bf16 Ks[BT * LDT];
  __shared__ __align__(16) bf16 Kt[BT * LDT];
  __shared__ __align__(16) bf16 Vs[BT * LDT];
  __shared__ __align__(16) bf16 Vt[BT * LDT];
  const int q0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const size_t row3 = (size_t)3 * C;
  const bf16* base = qkv + (size_t)b * n * row3 + h * ATTN_D;  // the head's q columns
  const bf16* dbase = dout + (size_t)b * n * C + h * ATTN_D;
  const int ra = q0 + warp * 16 + g, rb = ra + 8;
  const bool va = ra < n, vb = rb < n;
  uint32_t qf[4][4], df[4][4];
  load_rows(qf, va ? base + ra * row3 : nullptr, vb ? base + rb * row3 : nullptr, t4);
  load_rows(df, va ? dbase + (size_t)ra * C : nullptr, vb ? dbase + (size_t)rb * C : nullptr, t4);
  const int ntiles = (n + BT - 1) / BT;

  // s = (q·kᵀ)·scale over key tile kt (in Ks), -inf past n
  auto logits = [&](float (&s)[8][4], int kt) {
    mma_abt(s, qf, Ks, g, t4);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tok = kt * BT + nt * 8 + 2 * t4 + (e & 1);
        s[nt][e] = tok < n ? s[nt][e] * scale : -INFINITY;
      }
  };

  // Pass 1: each row's max and sum of exp(s - max)
  float ma = -INFINITY, mb = -INFINITY, la = 0.f, lb = 0.f;
  for (int kt = 0; kt < ntiles; ++kt) {
    __syncthreads();
    load_tile(base + C, row3, kt * BT, n, Ks, nullptr);
    __syncthreads();
    float s[8][4];
    logits(s, kt);
    float ta = -INFINITY, tb = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      ta = fmaxf(ta, fmaxf(s[nt][0], s[nt][1]));
      tb = fmaxf(tb, fmaxf(s[nt][2], s[nt][3]));
    }
    if (ta > ma) {
      la *= expf(ma - ta);
      ma = ta;
    }
    if (tb > mb) {
      lb *= expf(mb - tb);
      mb = tb;
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      la += exp_shifted(s[nt][0], ma) + exp_shifted(s[nt][1], ma);
      lb += exp_shifted(s[nt][2], mb) + exp_shifted(s[nt][3], mb);
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    merge_row(ma, la, __shfl_xor_sync(0xffffffffu, ma, o), __shfl_xor_sync(0xffffffffu, la, o));
    merge_row(mb, lb, __shfl_xor_sync(0xffffffffu, mb, o), __shfl_xor_sync(0xffffffffu, lb, o));
  }
  const float ia = 1.0f / la, ib = 1.0f / lb;

  // p32 = exp(s - max) * (1 / sum), in place
  auto probs = [&](float (&s)[8][4]) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = exp_shifted(s[nt][0], ma) * ia;
      s[nt][1] = exp_shifted(s[nt][1], ma) * ia;
      s[nt][2] = exp_shifted(s[nt][2], mb) * ib;
      s[nt][3] = exp_shifted(s[nt][3], mb) * ib;
    }
  };

  // Pass 2: attn_out = pb·V and the row term δ = Σ dp∘p32
  float o[8][4] = {};
  float da = 0.f, db = 0.f;
  for (int kt = 0; kt < ntiles; ++kt) {
    __syncthreads();
    load_tile(base + C, row3, kt * BT, n, Ks, nullptr);
    load_tile(base + 2 * C, row3, kt * BT, n, Vs, Vt);
    __syncthreads();
    float s[8][4], dp[8][4];
    logits(s, kt);
    probs(s);
    mma_pz(o, s, Vt, g, t4);
    mma_abt(dp, df, Vs, g, t4);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      da += dp[nt][0] * s[nt][0] + dp[nt][1] * s[nt][1];
      db += dp[nt][2] * s[nt][2] + dp[nt][3] * s[nt][3];
    }
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    da += __shfl_xor_sync(0xffffffffu, da, off);
    db += __shfl_xor_sync(0xffffffffu, db, off);
  }
  store_rows(va ? ao + ((size_t)b * n + ra) * C + h * ATTN_D : nullptr,
             vb ? ao + ((size_t)b * n + rb) * C + h * ATTN_D : nullptr, o, t4);
  const size_t plane = (size_t)gridDim.z * H * n, srow = ((size_t)b * H + h) * n;
  if (t4 == 0) {
    if (va) {
      stats[srow + ra] = ma;
      stats[plane + srow + ra] = ia;
      stats[2 * plane + srow + ra] = da;
    }
    if (vb) {
      stats[srow + rb] = mb;
      stats[plane + srow + rb] = ib;
      stats[2 * plane + srow + rb] = db;
    }
  }

  // Pass 3: dQ = dsb·K, dsb = bf16(p32∘(dp − δ)·scale)
  float dq[8][4] = {};
  for (int kt = 0; kt < ntiles; ++kt) {
    __syncthreads();
    load_tile(base + C, row3, kt * BT, n, Ks, Kt);
    load_tile(base + 2 * C, row3, kt * BT, n, Vs, nullptr);
    __syncthreads();
    float s[8][4], dp[8][4];
    logits(s, kt);
    probs(s);
    mma_abt(dp, df, Vs, g, t4);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][0] * (dp[nt][0] - da) * scale;
      s[nt][1] = s[nt][1] * (dp[nt][1] - da) * scale;
      s[nt][2] = s[nt][2] * (dp[nt][2] - db) * scale;
      s[nt][3] = s[nt][3] * (dp[nt][3] - db) * scale;
    }
    mma_pz(dq, s, Kt, g, t4);
  }
  store_rows(va ? dqkv + ((size_t)b * n + ra) * row3 + h * ATTN_D : nullptr,
             vb ? dqkv + ((size_t)b * n + rb) * row3 + h * ATTN_D : nullptr, dq, t4);
}

__global__ void __launch_bounds__(128) sdpa_bwd_key_kernel(
    const bf16* __restrict__ qkv, const bf16* __restrict__ dout, bf16* __restrict__ dqkv,
    const float* __restrict__ stats, int n, int C, float scale) {
  __shared__ __align__(16) bf16 Qs[BT * LDT];
  __shared__ __align__(16) bf16 Qt[BT * LDT];
  __shared__ __align__(16) bf16 Ds[BT * LDT];
  __shared__ __align__(16) bf16 Dt[BT * LDT];
  __shared__ float s_max[BT], s_inv[BT], s_delta[BT];
  const int k0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const size_t row3 = (size_t)3 * C;
  const bf16* base = qkv + (size_t)b * n * row3 + h * ATTN_D;
  const bf16* dbase = dout + (size_t)b * n * C + h * ATTN_D;
  const int ka = k0 + warp * 16 + g, kb = ka + 8;
  const bool va = ka < n, vb = kb < n;
  uint32_t kf[4][4], vf[4][4];
  load_rows(kf, va ? base + ka * row3 + C : nullptr, vb ? base + kb * row3 + C : nullptr, t4);
  load_rows(vf, va ? base + ka * row3 + 2 * C : nullptr, vb ? base + kb * row3 + 2 * C : nullptr,
            t4);
  const size_t plane = (size_t)gridDim.z * H * n;
  const float* st = stats + ((size_t)b * H + h) * n;
  const int ntiles = (n + BT - 1) / BT;

  float dv[8][4] = {}, dk[8][4] = {};
  for (int qt = 0; qt < ntiles; ++qt) {
    __syncthreads();
    load_tile(base, row3, qt * BT, n, Qs, Qt);
    load_tile(dbase, C, qt * BT, n, Ds, Dt);
    for (int i = threadIdx.x; i < BT; i += blockDim.x) {
      const int q = qt * BT + i;
      // a query past n gets p = exp(-inf) * 0 = 0
      s_max[i] = q < n ? st[q] : INFINITY;
      s_inv[i] = q < n ? st[plane + q] : 0.f;
      s_delta[i] = q < n ? st[2 * plane + q] : 0.f;
    }
    __syncthreads();
    float s[8][4], dp[8][4];
    mma_abt(s, kf, Qs, g, t4);   // sᵀ: rows keys, columns queries
    mma_abt(dp, vf, Ds, g, t4);  // dpᵀ
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = nt * 8 + 2 * t4 + (e & 1);
        const float p = expf(s[nt][e] * scale - s_max[qi]) * s_inv[qi];
        s[nt][e] = p;
        dp[nt][e] = p * (dp[nt][e] - s_delta[qi]) * scale;
      }
    mma_pz(dv, s, Dt, g, t4);   // dV += pbᵀ·dO
    mma_pz(dk, dp, Qt, g, t4);  // dK += dsbᵀ·Q
  }
  store_rows(va ? dqkv + ((size_t)b * n + ka) * row3 + C + h * ATTN_D : nullptr,
             vb ? dqkv + ((size_t)b * n + kb) * row3 + C + h * ATTN_D : nullptr, dk, t4);
  store_rows(va ? dqkv + ((size_t)b * n + ka) * row3 + 2 * C + h * ATTN_D : nullptr,
             vb ? dqkv + ((size_t)b * n + kb) * row3 + 2 * C + h * ATTN_D : nullptr, dv, t4);
}

}  // namespace
}  // namespace rajni

using namespace rajni;

extern "C" int rajni_train_sdpa_bwd(const void* qkv, const void* dout, void* attn_out, void* dqkv,
                                    void* stats, int B, int n, int C, int H, float scale,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + BT - 1) / BT, H, B);
  sdpa_bwd_query_kernel<<<grid, 128, 0, st>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(dout), static_cast<bf16*>(attn_out),
      static_cast<bf16*>(dqkv), static_cast<float*>(stats), n, C, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return fail(e, 1);
  sdpa_bwd_key_kernel<<<grid, 128, 0, st>>>(static_cast<const bf16*>(qkv),
                                            static_cast<const bf16*>(dout),
                                            static_cast<bf16*>(dqkv),
                                            static_cast<const float*>(stats), n, C, scale);
  e = cudaGetLastError();
  return e == cudaSuccess ? 0 : fail(e, 2);
}
