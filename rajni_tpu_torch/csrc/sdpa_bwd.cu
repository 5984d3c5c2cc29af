// B18: train_sdpa_bwd — the SDPA forward recomputed and differentiated, per
// head: (qkv [B, K, 3C], d_out [B, K, C]) -> (attn_out [B, K, C],
// d_qkv [B, K, 3C]), d_qkv packed [dQ | dK | dV] in the (qkv, head, dim) lane
// order of qkv, everything bf16 in and out; head_dim D = 64, or 80
// (ViT-H/14) up to SDPA_MAX_N_D80 tokens.
//
// Replaces the TPU kernel rajni_tpu/kernels/train.py:295 train_sdpa_bwd
// (pallas_call at train.py:310, body _sdpa_bwd_kernel at 222), which holds one
// image's qkv and one head's [K, K] fp32 matrices in VMEM. Its numerics, per
// head, are kept term by term:
//   s = (q·kᵀ in fp32)·scale;  p32 = e·(1/Σe), e = exp(s − max);  pb = bf16(p32)
//   attn_out = pb·v;  dv = pbᵀ·dO;  dp = dO·vᵀ (fp32)
//   ds = p32∘(dp − rowsum(dp∘p32));  dsb = bf16(ds·scale)
//   dq = dsb·k;  dk = dsbᵀ·q           (each accumulated in fp32, rounded once)
// The row term is taken from the fp32 dp and p32, as the TPU kernel takes
// it, not FlashAttention's rowsum(dO∘O): O is built from the rounded pb and
// rounded itself, so that shortcut gives other numbers. The scale multiplies
// the fp32 logits (the per-head form) at every head_dim: the forward kernels'
// phased form (q·scale rounded to bf16 first, common.cuh:mha_phased) is not
// the TPU backward's, and at 80^-0.5 the two are ~3e-3 rel L2 apart.
//
// Bound on the H100: bytes at the training paths' lengths. At batch 128,
// K=197, C=768 the six [K,K]x[K,64] products the function needs are 4.6e10
// FLOP (0.046 ms at 989 TFLOP/s) against 0.31 GB in and out (0.092 ms at
// 3.35 TB/s); at ViT-H's K=180, C=1280 and batch 64 3.2e10 FLOP (0.032 ms)
// against 0.24 GB (0.070 ms); at K=577 (batch 32) the products, 1.0e11 FLOP
// (0.10 ms), bound it.
//
// Design: warp-specialized blocks of three warpgroups on wgmma m64n64k16
// (hopper.cuh): warpgroup 0 produces (TMA loads of 64-token tiles of one
// head's q, k, v or dO columns, 128-byte swizzled, completing on mbarriers;
// 40 registers), warpgroups 1 and 2 consume (232 registers). The products
// with a reduction over tokens (pb·v, dsb·k, pbᵀ·dO, dsbᵀ·q) take the
// bf16 fragments from the registers of the product before them and read
// their right operand transposed from its [token][dim] tile; nothing is
// transposed by scalar stores. No atomics: each output element is summed by
// one thread in a fixed order, so the result is deterministic.
//   * K <= BW_FUSED_N = 256 (T6's 197, 187, 120): one launch, one block per
//     (head, image). Q, K, V and dO of the head are loaded once and stay
//     whole in shared memory (4 × 4 tiles, 128 KB). Query side, per 64-query
//     slab, in one pass: S is computed once and its row held in registers,
//     the two consumers splitting the key tiles (p32 and dp of a whole
//     256-token row are 2 × 128 registers a thread, which one warpgroup's
//     232 cannot hold beside the accumulators; half a row each, 2 × 64, fits
//     without spilling). S and dp take a consumer's two key tiles in one
//     m64n128k16 product a step. Then p32, pb, attn_out = pb·V, dp = dO·Vᵀ,
//     the row term, dsb and dQ = dsb·K, the two consumers' row statistics and
//     partial products combined through shared memory; the slab's row
//     offset, 1/Σe and row term stay in shared memory. Key side, per 64-key
//     slab (the consumers taking alternate slabs): Sᵀ = K·Qᵀ and p32ᵀ from
//     the kept statistics, dpᵀ = V·dOᵀ, dsbᵀ, dV = pbᵀ·dO and dK = dsbᵀ·Q.
//     8 products and 2 exps a logit; no statistics through device memory.
//   * Past 256 tokens (to SDPA_MAX_N = 848), two launches. (1) One block per
//     (pair of 64-query slabs, head, image), one slab a consumer; the K and V
//     tiles stream through a ring of BW_RING stages that both consumers read.
//     Pass 1 takes each row's max and Σe online; pass 2 recomputes p32 and
//     pb, accumulates attn_out = pb·V and the row term from dp = dO·Vᵀ, and
//     writes attn_out and (row offset, 1/Σe, row term) as fp32 [3, B, H, K];
//     pass 3 recomputes p32, dp and dsb and accumulates dQ = dsb·K. (2) One
//     block per (pair of 64-key slabs, head, image): the head's statistics
//     are read into shared memory once, the Q and dO tiles stream through the
//     ring, and each consumer recomputes Sᵀ, p32ᵀ, dpᵀ and dsbᵀ and
//     accumulates dV and dK.
//   Softmax in the log2 domain (hopper.cuh): p32 = 2^(s·scale·log2e − c)·
//   (1/Σ), c the row's max logit times scale·log2e. At head_dim 64 the scale
//   1/8 is a power of two and scale·log2e is log2e/8 exactly; at 80^-0.5 it
//   is rounded once more, a relative error of ~1e-7 in each exponent (well
//   under ex2.approx's own). p32 on the key side is recomputed from the query
//   side's statistics, as FlashAttention does; its logits come from the same
//   bf16 operands summed in another order, so p32 may differ in its last
//   fp32 bit.
// Head_dim 80 (ViT-H/14): each tile of a head is hopper.cuh's 64-column tile
// plus a 2 KB 16-column part in the 32-byte swizzle, loaded by a second TMA
// box on the same mbarrier; the parts follow the 64-column tiles in shared
// memory, so head_dim 64's layout is the one it always had. Products that
// reduce over the head dim (S, Sᵀ, dp, dpᵀ) take a fifth k16 step on the
// parts; products whose output is the head dim (attn_out, dQ, dK, dV) take an
// m64n16k16 product beside the m64n64k16 one, into an 8-register
// accumulator. The fused form holds 16 tiles and 16 parts (160 KB) and its
// exchange rows grow to 80 + 4 floats (~187 KB in all); the two-launch ring
// keeps its 16 stages at 10 KB (~206 KB, the key kernel ~211 KB with its
// statistics at K <= 384), so the fused form hands over at 256 tokens at
// both head dims.
// What limits it on an H100 SXM: at T6's lengths the fused launch runs at
// about the library's device time (0.426 against 0.414 ms at K=197, B=128,
// chip_smoke.py); a block's phases are serial (products, then softmax on
// the special-function units, then the next products), as in B6. Past 256
// tokens every tile step waits for its products before the softmax that
// feeds the next ones, and each key tile is read five times by the query
// launch, so K=577 runs at 1.5x the library's device time.
#include "hopper.cuh"

namespace rajni {
namespace {

constexpr int BW_THREADS = 384;
constexpr int BW_FUSED_N = 256;  // one launch up to here
constexpr int BW_QT = 2;         // key tiles of a row each consumer holds (fused)
constexpr int BW_RING = 16;      // ring stages (8 KB, + 2 KB at head_dim 80) of the two-launch kernels

// Shared memory of head_dim D: X the 16-column parts a tile has, XO_LD the
// row stride (floats) of the partial-product exchange, MAX_N the longest row.
template <int D>
struct BwSmem {
  static constexpr int X = xparts<D>();
  static constexpr int TILE_SET = TILE_BYTES + X * XTILE_BYTES;  // a tile and its part
  static constexpr int XO_LD = D + 4;
  static constexpr int MAX_N = D == ATTN_D ? SDPA_MAX_N : SDPA_MAX_N_D80;
  static constexpr int FUSED = 16 * TILE_SET + 64 * XO_LD * 4 + 3 * 2 * 64 * 4 +
                               3 * BW_FUSED_N * 4 + 16 * 8 + 1024;
  static constexpr int SPLIT = (4 + BW_RING) * TILE_SET + (4 + 2 * BW_RING) * 8 + 1024;
  // the key kernel also keeps the head's statistics, 3 x n fp32
  static constexpr int KEY = SPLIT + 3 * MAX_N * 4;
};
static_assert(BwSmem<ATTN_D80>::FUSED <= 232448 && BwSmem<ATTN_D80>::KEY <= 232448,
              "head_dim 80's shared memory");

struct BwdArgs {
  const bf16* dout;
  bf16* ao;
  bf16* dqkv;
  float* stats;  // [3, B, H, n]: row offset c (log2 domain), 1/Σe, row term (two launches)
  int n, C;
  float scale;
};

// The tensor maps of a launch: 64-column boxes of qkv and d_out, and at
// head_dim 80 their 16-column parts' boxes (unused at 64).
struct BwdMaps {
  const CUtensorMap* q;
  const CUtensorMap* d;
  const CUtensorMap* qx;
  const CUtensorMap* dx;
};

// The per-thread coordinates of a consumer warpgroup.
struct Lane {
  int cw, t4, r0;  // consumer 0/1, column pair, slab rows r0 and r0 + 8
  bool leader;
  __device__ Lane() {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    cw = warpgroup_id() - 1;
    t4 = lane & 3;
    r0 = (warp & 3) * 16 + (lane >> 2);
    leader = (threadIdx.x & 127) == 0;
  }
};

// The producer's TMA load of tile t of one head's q (kind 0), k (1), v (2)
// columns of qkv, or of d_out (kind 3); at head_dim 80 also its 16-column
// part, on the same barrier.
template <int D>
__device__ __forceinline__ void load_kind(uint8_t* dst, uint8_t* part, uint64_t* bar,
                                          const BwdMaps& m, int kind, int t, int h, int b, int C) {
  constexpr int X = xparts<D>();
  mbar_expect_tx(bar, TILE_BYTES + X * XTILE_BYTES);
  const int col = (kind == 3 ? 0 : kind * C) + h * D;
  tma_load_tile(dst, kind == 3 ? m.d : m.q, bar, col, t * TILE, b);
  if constexpr (X > 0) tma_load_tile(part, kind == 3 ? m.dx : m.qx, bar, col + TILE, t * TILE, b);
}

// p32 of key tile j in place from its raw logits: s ← 2^(s·sl2 − c)·inv
// (hopper.cuh's log2 domain), 0 past n.
__device__ __forceinline__ void probs(float (&s)[32], int j, int T, int n, int t4, float sl2,
                                      float ca, float ia, float cb, float ib) {
  if (j == T - 1) mask_tail(s, j * TILE, n, t4);
#pragma unroll
  for (int e = 0; e < 32; ++e)
    s[e] = acc_row8(e) ? exp_row(s[e], sl2, cb) * ib : exp_row(s[e], sl2, ca) * ia;
}

// The rows r0 / r0 + 8 of slab q0 in a [token][·] output, null past n.
template <typename T>
__device__ __forceinline__ T* row_or_null(T* base, size_t ld, int q, int n) {
  return q < n ? base + (size_t)q * ld : nullptr;
}

// A head's 64 + 16 output columns (d, and dx at head_dim 80) to rows a / b
// (null: skip) of a [token][·] output.
template <int D>
__device__ __forceinline__ void store_head(bf16* a, bf16* b, const float (&d)[32],
                                           const float (&dx)[8], int t4) {
  store_acc(a, b, d, t4);
  if constexpr (xparts<D>() > 0)
    store_acc(a ? a + TILE : nullptr, b ? b + TILE : nullptr, dx, t4);
}

// ---------------------------------------------------------------------------
// K <= 256: one launch
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(BW_THREADS, 1)
    sdpa_bwd_fused_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap dmap,
                          const __grid_constant__ CUtensorMap qxmap,
                          const __grid_constant__ CUtensorMap dxmap, BwdArgs a) {
  using L = BwSmem<D>;
  constexpr bool X = L::X > 0;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* tiles = smem_aligned(smem_raw);  // kind k, tile t at 4k + t
  uint8_t* parts = tiles + 16 * TILE_BYTES;  // head_dim 80: their 16-column parts, same index
  float* xo = reinterpret_cast<float*>(parts + 16 * L::X * XTILE_BYTES);  // [64][XO_LD]
  float* red_max = xo + 64 * L::XO_LD;  // [consumer][64 rows], then red_sum, red_del
  float* red_sum = red_max + 128;
  float* red_del = red_sum + 128;
  float* sm_m = red_del + 128;  // [BW_FUSED_N]: row offset c, 1/Σe, row term of each query
  float* sm_inv = sm_m + BW_FUSED_N;
  float* sm_del = sm_inv + BW_FUSED_N;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm_del + BW_FUSED_N);  // [4k + t], one use each

  const int h = blockIdx.x, b = blockIdx.y;
  const int n = a.n, C = a.C, T = (n + TILE - 1) / TILE, T0 = (T + 1) / 2;
  const float scale = a.scale, sl2 = scale * LOG2E;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 16; ++i) mbar_init(&bars[i], 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warpgroup_id() == 0) {  // producer: every tile once, in the order of first use
    regs_producer();
    if (threadIdx.x == 0) {
      const BwdMaps m{&qmap, &dmap, &qxmap, &dxmap};
      auto load = [&](int kind, int t) {
        load_kind<D>(tiles + (4 * kind + t) * TILE_BYTES, parts + (4 * kind + t) * XTILE_BYTES,
                     &bars[4 * kind + t], m, kind, t, h, b, C);
      };
      load(0, 0);
      for (int t = 0; t < T; ++t) load(1, t);
      for (int t = 0; t < T; ++t) load(2, t);
      load(3, 0);
      for (int t = 1; t < T; ++t) {
        load(0, t);
        load(3, t);
      }
    }
    return;
  }

  regs_consumer();
  const Lane L_;
  const int cw = L_.cw, t4 = L_.t4, r0 = L_.r0;
  const int j0 = cw ? T0 : 0, nt = cw ? T - T0 : T0;
  auto ready = [&](int kind, int t) -> uint8_t* {
    mbar_wait(&bars[4 * kind + t], 0);
    return tiles + (4 * kind + t) * TILE_BYTES;
  };
  // head_dim 80: the 16-column part of a tile (after ready() has waited for it)
  auto part = [&](int kind, int t) -> uint8_t* { return parts + (4 * kind + t) * XTILE_BYTES; };
  // the two consumers' values of rows r0, r0 + 8 summed (consumer 0's first)
  auto row_sum2 = [&](float* red, float& va, float& vb) {
    if (t4 == 0) {
      red[cw * 64 + r0] = va;
      red[cw * 64 + r0 + 8] = vb;
    }
    named_sync(1, 256);
    va = red[r0] + red[64 + r0];
    vb = red[r0 + 8] + red[64 + r0 + 8];
  };
  // a 64xD product split over the consumers' key tiles: consumer 1's
  // partial added to consumer 0's, which stores the rows
  auto sum_store = [&](float (&d)[32], float (&dx)[8], bf16* ra, bf16* rb) {
    if (cw == 1) {
#pragma unroll
      for (int e = 0; e < 32; e += 2)
        *reinterpret_cast<float2*>(xo + (r0 + acc_row8(e)) * L::XO_LD + acc_col(e, t4)) =
            make_float2(d[e], d[e + 1]);
      if constexpr (X) {
#pragma unroll
        for (int e = 0; e < 8; e += 2)
          *reinterpret_cast<float2*>(xo + (r0 + acc_row8(e)) * L::XO_LD + TILE + acc_col(e, t4)) =
              make_float2(dx[e], dx[e + 1]);
      }
    }
    named_sync(1, 256);
    if (cw == 0) {
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const float2 p = *reinterpret_cast<const float2*>(xo + (r0 + acc_row8(e)) * L::XO_LD +
                                                          acc_col(e, t4));
        d[e] += p.x;
        d[e + 1] += p.y;
      }
      if constexpr (X) {
#pragma unroll
        for (int e = 0; e < 8; e += 2) {
          const float2 p = *reinterpret_cast<const float2*>(
              xo + (r0 + acc_row8(e)) * L::XO_LD + TILE + acc_col(e, t4));
          dx[e] += p.x;
          dx[e + 1] += p.y;
        }
      }
      store_head<D>(ra, rb, d, dx, t4);
    }
    named_sync(1, 256);
  };

  const size_t ld3 = (size_t)3 * C;
  bf16* ao = a.ao + (size_t)b * n * C + h * D;
  bf16* dqkv = a.dqkv + (size_t)b * n * ld3 + h * D;

  // query side
  for (int qs = 0; qs < T; ++qs) {
    const int qa = qs * TILE + r0, qb = qa + 8;
    uint8_t* qt = ready(0, qs);
    uint8_t* qx = part(0, qs);
    float s[BW_QT][32];
#pragma unroll
    for (int jj = 0; jj < BW_QT; ++jj) keep(s[jj]);
    wg_fence();
    // the consumer's two key tiles in one m64n128k16 product a step (tiles
    // t and t + 1 of a kind are adjacent, and so are their parts); every
    // product is issued (a skipped one would make ptxas serialize them):
    // with no tile of its own a consumer reads the Q tiles, and a tile past
    // its nt is masked to -inf, so its p32 and dsb are 0
    if (nt > 1) ready(1, j0 + 1);
    mma_abt2(s[0], s[1], qt, nt > 0 ? ready(1, j0) : qt);
    if constexpr (X) mma_abt2_x(s[0], s[1], qx, nt > 0 ? part(1, j0) : qx);
    wg_commit();
    wg_wait0();
    float ma = -INFINITY, mb = -INFINITY;  // the rows' max raw logit
#pragma unroll
    for (int jj = 0; jj < BW_QT; ++jj) {
      keep(s[jj]);
      if (jj >= nt) {
#pragma unroll
        for (int e = 0; e < 32; ++e) s[jj][e] = -INFINITY;
      } else if (j0 + jj == T - 1) {
        mask_tail(s[jj], (T - 1) * TILE, n, t4);
      }
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        if (acc_row8(e)) mb = fmaxf(mb, s[jj][e]);
        else ma = fmaxf(ma, s[jj][e]);
      }
    }
    ma = quad_max(ma);
    mb = quad_max(mb);
    if (t4 == 0) {
      red_max[cw * 64 + r0] = ma;
      red_max[cw * 64 + r0 + 8] = mb;
    }
    named_sync(1, 256);
    const float ca = fmaxf(red_max[r0], red_max[64 + r0]) * sl2;  // row offsets, log2 domain
    const float cb = fmaxf(red_max[r0 + 8], red_max[64 + r0 + 8]) * sl2;
    float la = 0.f, lb = 0.f;
#pragma unroll
    for (int jj = 0; jj < BW_QT; ++jj)
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const float p = exp_row(s[jj][e], sl2, acc_row8(e) ? cb : ca);
        s[jj][e] = p;
        if (acc_row8(e)) lb += p;
        else la += p;
      }
    la = quad_sum(la);
    lb = quad_sum(lb);
    row_sum2(red_sum, la, lb);
    const float ia = row_recip(la), ib = row_recip(lb);
    uint32_t pf[BW_QT][16];
#pragma unroll
    for (int jj = 0; jj < BW_QT; ++jj) {
#pragma unroll
      for (int e = 0; e < 32; ++e) s[jj][e] *= acc_row8(e) ? ib : ia;  // p32
      to_frag(pf[jj], s[jj]);                                          // pb
    }

    float o[32], ox[8];  // ox: head_dim 80's columns 64-79
#pragma unroll
    for (int e = 0; e < 32; ++e) o[e] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) ox[e] = 0.f;
    keep(o);
    if constexpr (X) keep(ox);
    wg_fence();
#pragma unroll
    for (int jj = 0; jj < BW_QT; ++jj) {  // pb·V
      mma_pz(o, pf[jj], jj < nt ? ready(2, j0 + jj) : qt);
      if constexpr (X) mma_pz_x(ox, pf[jj], jj < nt ? part(2, j0 + jj) : qx);
    }
    wg_commit();
    wg_wait0();
    keep(o);
    if constexpr (X) keep(ox);
#pragma unroll
    for (int jj = 0; jj < BW_QT; ++jj) keep(pf[jj]);
    sum_store(o, ox, row_or_null(ao, C, qa, n), row_or_null(ao, C, qb, n));

    float dp[BW_QT][32];
    uint8_t* dt = ready(3, qs);
    uint8_t* dx = part(3, qs);
#pragma unroll
    for (int jj = 0; jj < BW_QT; ++jj) keep(dp[jj]);
    wg_fence();
    if (nt > 1) ready(2, j0 + 1);
    mma_abt2(dp[0], dp[1], dt, nt > 0 ? ready(2, j0) : qt);  // dp = dO·Vᵀ
    if constexpr (X) mma_abt2_x(dp[0], dp[1], dx, nt > 0 ? part(2, j0) : qx);
    wg_commit();
    wg_wait0();
    float da = 0.f, db = 0.f;
#pragma unroll
    for (int jj = 0; jj < BW_QT; ++jj) {
      keep(dp[jj]);
      if (jj >= nt) {  // a tile not loaded: whatever it held, its dsb is 0
#pragma unroll
        for (int e = 0; e < 32; ++e) dp[jj][e] = 0.f;
      } else {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          if (acc_row8(e)) db += dp[jj][e] * s[jj][e];
          else da += dp[jj][e] * s[jj][e];
        }
      }
    }
    da = quad_sum(da);
    db = quad_sum(db);
    row_sum2(red_del, da, db);  // rowsum(dp∘p32)
#pragma unroll
    for (int jj = 0; jj < BW_QT; ++jj) {
#pragma unroll
      for (int e = 0; e < 32; ++e)
        s[jj][e] = s[jj][e] * (dp[jj][e] - (acc_row8(e) ? db : da)) * scale;
      to_frag(pf[jj], s[jj]);  // dsb
    }
    float dq[32], dqx[8];
#pragma unroll
    for (int e = 0; e < 32; ++e) dq[e] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) dqx[e] = 0.f;
    keep(dq);
    if constexpr (X) keep(dqx);
    wg_fence();
#pragma unroll
    for (int jj = 0; jj < BW_QT; ++jj) {  // dsb·K
      mma_pz(dq, pf[jj], jj < nt ? ready(1, j0 + jj) : qt);
      if constexpr (X) mma_pz_x(dqx, pf[jj], jj < nt ? part(1, j0 + jj) : qx);
    }
    wg_commit();
    wg_wait0();
    keep(dq);
    if constexpr (X) keep(dqx);
#pragma unroll
    for (int jj = 0; jj < BW_QT; ++jj) keep(pf[jj]);
    sum_store(dq, dqx, row_or_null(dqkv, ld3, qa, n), row_or_null(dqkv, ld3, qb, n));
    if (cw == 0 && t4 == 0) {
      sm_m[qa] = ca;
      sm_inv[qa] = ia;
      sm_del[qa] = da;
      sm_m[qb] = cb;
      sm_inv[qb] = ib;
      sm_del[qb] = db;
    }
  }
  named_sync(1, 256);  // the statistics of every query are in shared memory

  // key side: consumer c takes key slabs c, c + 2, ...
  for (int ks = cw; ks < T; ks += 2) {
    uint8_t* kt = ready(1, ks);
    uint8_t* vt = ready(2, ks);
    uint8_t* kx = part(1, ks);
    uint8_t* vx = part(2, ks);
    float dv[32], dk[32], dvx[8], dkx[8];
#pragma unroll
    for (int e = 0; e < 32; ++e) dv[e] = dk[e] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) dvx[e] = dkx[e] = 0.f;
    for (int qt = 0; qt < T; ++qt) {
      uint8_t* qtile = ready(0, qt);
      uint8_t* dtile = ready(3, qt);
      uint8_t* qxp = part(0, qt);
      uint8_t* dxp = part(3, qt);
      float st[32], dpt[32];
      keep(st);
      keep(dpt);
      wg_fence();
      mma_abt(st, kt, qtile);  // sᵀ: rows keys, columns queries
      if constexpr (X) mma_abt_x(st, kx, qxp);
      mma_abt(dpt, vt, dtile);  // dpᵀ
      if constexpr (X) mma_abt_x(dpt, vx, dxp);
      wg_commit();
      wg_wait0();
      keep(st);
      keep(dpt);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int qi = qt * TILE + acc_col(e, t4);
        const bool ok = qi < n;  // a query past n gets p = 0
        const float p = ok ? exp_row(st[e], sl2, sm_m[qi]) * sm_inv[qi] : 0.f;
        st[e] = p;
        dpt[e] = ok ? p * (dpt[e] - sm_del[qi]) * scale : 0.f;
      }
      uint32_t pv[16], pk[16];
      to_frag(pv, st);   // pbᵀ
      to_frag(pk, dpt);  // dsbᵀ
      wg_fence();
      mma_pz(dv, pv, dtile);  // dV += pbᵀ·dO
      if constexpr (X) mma_pz_x(dvx, pv, dxp);
      mma_pz(dk, pk, qtile);  // dK += dsbᵀ·Q
      if constexpr (X) mma_pz_x(dkx, pk, qxp);
      wg_commit();
      wg_wait0();
      keep(dv);
      keep(dk);
      if constexpr (X) {
        keep(dvx);
        keep(dkx);
      }
      keep(pv);
      keep(pk);
    }
    const int ka = ks * TILE + r0, kb = ka + 8;
    store_head<D>(row_or_null(dqkv + C, ld3, ka, n), row_or_null(dqkv + C, ld3, kb, n), dk, dkx,
                  t4);
    store_head<D>(row_or_null(dqkv + 2 * C, ld3, ka, n), row_or_null(dqkv + 2 * C, ld3, kb, n),
                  dv, dvx, t4);
  }
}

// ---------------------------------------------------------------------------
// K > 256: two launches, the streamed tiles in a ring both consumers read
// ---------------------------------------------------------------------------

// Ring of BW_RING stages after the four fixed tiles; item i's stage and phase.
struct Ring {
  uint8_t* base;
  uint8_t* parts;  // head_dim 80: each stage's 16-column part
  uint64_t* full;
  uint64_t* empty;
  __device__ uint8_t* wait(int i) const {
    mbar_wait(&full[i % BW_RING], (i / BW_RING) & 1);
    return base + (i % BW_RING) * TILE_BYTES;
  }
  __device__ uint8_t* part(int i) const { return parts + (i % BW_RING) * XTILE_BYTES; }
  __device__ void release(int i, bool leader) const {
    if (leader) mbar_arrive(&empty[i % BW_RING]);
  }
};

// Shared layout of the two-launch kernels: fixed tiles [4], ring tiles, at
// head_dim 80 the fixed tiles' parts [4] and the ring's, then the barriers
// (fixed [4], full [BW_RING], empty [BW_RING]).
template <int D>
__device__ __forceinline__ Ring split_layout(uint8_t* sm, uint8_t*& fixed, uint8_t*& fparts,
                                             uint64_t*& fbar) {
  fixed = sm;
  uint8_t* ring = sm + 4 * TILE_BYTES;
  fparts = ring + BW_RING * TILE_BYTES;
  fbar = reinterpret_cast<uint64_t*>(fparts + xparts<D>() * (4 + BW_RING) * XTILE_BYTES);
  return Ring{ring, fparts + 4 * XTILE_BYTES, fbar + 4, fbar + 4 + BW_RING};
}

// Producer of a two-launch kernel: the four fixed tiles (kinds fk[0..3] at
// tiles ft[0..3]), then ring items 0..items-1, item i being (kind_of, tile_of).
template <int D, typename ItemFn>
__device__ __forceinline__ void split_produce(const BwdMaps& m, uint8_t* fixed, uint8_t* fparts,
                                              uint64_t* fbar, const Ring& ring,
                                              const int (&fk)[4], const int (&ft)[4], int items,
                                              int T, ItemFn item, int h, int b, int C) {
  for (int i = 0; i < 4; ++i)
    if (ft[i] < T)
      load_kind<D>(fixed + i * TILE_BYTES, fparts + i * XTILE_BYTES, &fbar[i], m, fk[i], ft[i], h,
                   b, C);
  for (int i = 0; i < items; ++i) {
    const int stage = i % BW_RING, round = i / BW_RING;
    if (round > 0) mbar_wait(&ring.empty[stage], (round - 1) & 1);
    int kind, t;
    item(i, kind, t);
    load_kind<D>(ring.base + stage * TILE_BYTES, ring.parts + stage * XTILE_BYTES,
                 &ring.full[stage], m, kind, t, h, b, C);
  }
}

__device__ __forceinline__ void split_init(uint64_t* fbar, const Ring& ring) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < 4; ++i) mbar_init(&fbar[i], 1);
    for (int s = 0; s < BW_RING; ++s) {
      mbar_init(&ring.full[s], 1);
      mbar_init(&ring.empty[s], 2);  // both consumers read every item
    }
    mbar_init_fence();
  }
  __syncthreads();
}

// (1) per pair of 64-query slabs: attn_out, the statistics and dQ
template <int D>
__global__ void __launch_bounds__(BW_THREADS, 1)
    sdpa_bwd_query_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap dmap,
                          const __grid_constant__ CUtensorMap qxmap,
                          const __grid_constant__ CUtensorMap dxmap, BwdArgs a) {
  constexpr bool X = xparts<D>() > 0;
  extern __shared__ uint8_t smem_raw[];
  uint8_t *fixed, *fparts;
  uint64_t* fbar;
  const Ring ring = split_layout<D>(smem_aligned(smem_raw), fixed, fparts, fbar);
  const int h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int n = a.n, C = a.C, T = (n + TILE - 1) / TILE;
  const float scale = a.scale, sl2 = scale * LOG2E;
  split_init(fbar, ring);

  if (warpgroup_id() == 0) {  // items: K_0..K_{T-1}, then twice K_j, V_j
    regs_producer();
    if (threadIdx.x == 0) {
      const int s0 = 2 * blockIdx.x;
      const int fk[4] = {0, 3, 0, 3}, ft[4] = {s0, s0, s0 + 1, s0 + 1};
      split_produce<D>(BwdMaps{&qmap, &dmap, &qxmap, &dxmap}, fixed, fparts, fbar, ring, fk, ft,
                       5 * T, T,
                       [T](int i, int& kind, int& t) {
                         if (i < T) {
                           kind = 1;
                           t = i;
                         } else {
                           const int r = (i - T) % (2 * T);
                           kind = 1 + (r & 1);
                           t = r >> 1;
                         }
                       },
                       h, b, C);
    }
    return;
  }

  regs_consumer();
  const Lane L;
  const int cw = L.cw, t4 = L.t4, r0 = L.r0;
  const int qs = 2 * blockIdx.x + cw, qa = qs * TILE + r0, qb = qa + 8;
  // a slab past n (the second of an odd count) runs with zero tiles, unstored
  uint8_t* qt = fixed + (2 * cw) * TILE_BYTES;
  uint8_t* dt = fixed + (2 * cw + 1) * TILE_BYTES;
  uint8_t* qx = fparts + (2 * cw) * XTILE_BYTES;
  uint8_t* dx = fparts + (2 * cw + 1) * XTILE_BYTES;
  if (qs < T) {
    mbar_wait(&fbar[2 * cw], 0);
    mbar_wait(&fbar[2 * cw + 1], 0);
  }
  int it = 0;

  float ca = -INFINITY, cb = -INFINITY, la = 0.f, lb = 0.f;  // row offsets (log2 domain), Σ
  for (int j = 0; j < T; ++j, ++it) {  // pass 1: max and Σe
    float s[32];
    keep(s);
    wg_fence();
    mma_abt(s, qt, ring.wait(it));
    if constexpr (X) mma_abt_x(s, qx, ring.part(it));
    wg_commit();
    wg_wait0();
    keep(s);
    ring.release(it, L.leader);
    if (j == T - 1) mask_tail(s, j * TILE, n, t4);
    online_row(ca, la, s, 0, sl2);
    online_row(cb, lb, s, 8, sl2);
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    merge_row(ca, la, __shfl_xor_sync(0xffffffffu, ca, off), __shfl_xor_sync(0xffffffffu, la, off));
    merge_row(cb, lb, __shfl_xor_sync(0xffffffffu, cb, off), __shfl_xor_sync(0xffffffffu, lb, off));
  }
  const float ia = row_recip(la), ib = row_recip(lb);

  float o[32], ox[8];
#pragma unroll
  for (int e = 0; e < 32; ++e) o[e] = 0.f;
#pragma unroll
  for (int e = 0; e < 8; ++e) ox[e] = 0.f;
  float da = 0.f, db = 0.f;
  for (int j = 0; j < T; ++j, it += 2) {  // pass 2: attn_out and the row term
    uint8_t* kt = ring.wait(it);
    uint8_t* vt = ring.wait(it + 1);
    float s[32], dp[32];
    keep(s);
    keep(dp);
    wg_fence();
    mma_abt(s, qt, kt);
    if constexpr (X) mma_abt_x(s, qx, ring.part(it));
    mma_abt(dp, dt, vt);
    if constexpr (X) mma_abt_x(dp, dx, ring.part(it + 1));
    wg_commit();
    wg_wait0();
    keep(s);
    keep(dp);
    probs(s, j, T, n, t4, sl2, ca, ia, cb, ib);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      if (acc_row8(e)) db += dp[e] * s[e];
      else da += dp[e] * s[e];
    }
    uint32_t pf[16];
    to_frag(pf, s);
    wg_fence();
    mma_pz(o, pf, vt);
    if constexpr (X) mma_pz_x(ox, pf, ring.part(it + 1));
    wg_commit();
    wg_wait0();
    keep(o);
    if constexpr (X) keep(ox);
    keep(pf);
    ring.release(it, L.leader);
    ring.release(it + 1, L.leader);
  }
  da = quad_sum(da);
  db = quad_sum(db);
  const size_t ld3 = (size_t)3 * C;
  bf16* ao = a.ao + (size_t)b * n * C + h * D;
  store_head<D>(row_or_null(ao, C, qa, n), row_or_null(ao, C, qb, n), o, ox, t4);
  if (t4 == 0) {
    const size_t plane = (size_t)gridDim.z * H * n;
    float* st = a.stats + ((size_t)b * H + h) * n;
    if (qa < n) {
      st[qa] = ca;
      st[plane + qa] = ia;
      st[2 * plane + qa] = da;
    }
    if (qb < n) {
      st[qb] = cb;
      st[plane + qb] = ib;
      st[2 * plane + qb] = db;
    }
  }

  float dq[32], dqx[8];
#pragma unroll
  for (int e = 0; e < 32; ++e) dq[e] = 0.f;
#pragma unroll
  for (int e = 0; e < 8; ++e) dqx[e] = 0.f;
  for (int j = 0; j < T; ++j, it += 2) {  // pass 3: dQ = dsb·K
    uint8_t* kt = ring.wait(it);
    uint8_t* vt = ring.wait(it + 1);
    float s[32], dp[32];
    keep(s);
    keep(dp);
    wg_fence();
    mma_abt(s, qt, kt);
    if constexpr (X) mma_abt_x(s, qx, ring.part(it));
    mma_abt(dp, dt, vt);
    if constexpr (X) mma_abt_x(dp, dx, ring.part(it + 1));
    wg_commit();
    wg_wait0();
    keep(s);
    keep(dp);
    probs(s, j, T, n, t4, sl2, ca, ia, cb, ib);
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = s[e] * (dp[e] - (acc_row8(e) ? db : da)) * scale;
    uint32_t pf[16];
    to_frag(pf, s);
    wg_fence();
    mma_pz(dq, pf, kt);
    if constexpr (X) mma_pz_x(dqx, pf, ring.part(it));
    wg_commit();
    wg_wait0();
    keep(dq);
    if constexpr (X) keep(dqx);
    keep(pf);
    ring.release(it, L.leader);
    ring.release(it + 1, L.leader);
  }
  bf16* dqkv = a.dqkv + (size_t)b * n * ld3 + h * D;
  store_head<D>(row_or_null(dqkv, ld3, qa, n), row_or_null(dqkv, ld3, qb, n), dq, dqx, t4);
}

// (2) per pair of 64-key slabs: dK and dV
template <int D>
__global__ void __launch_bounds__(BW_THREADS, 1)
    sdpa_bwd_key_kernel(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap dmap,
                        const __grid_constant__ CUtensorMap qxmap,
                        const __grid_constant__ CUtensorMap dxmap, BwdArgs a) {
  constexpr bool X = xparts<D>() > 0;
  extern __shared__ uint8_t smem_raw[];
  uint8_t *fixed, *fparts;
  uint64_t* fbar;
  const Ring ring = split_layout<D>(smem_aligned(smem_raw), fixed, fparts, fbar);
  const int h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int n = a.n, C = a.C, T = (n + TILE - 1) / TILE;
  const float scale = a.scale, sl2 = scale * LOG2E;
  split_init(fbar, ring);

  if (warpgroup_id() == 0) {  // items: Q_qt, dO_qt for each query tile
    regs_producer();
    if (threadIdx.x == 0) {
      const int s0 = 2 * blockIdx.x;
      const int fk[4] = {1, 2, 1, 2}, ft[4] = {s0, s0, s0 + 1, s0 + 1};
      split_produce<D>(BwdMaps{&qmap, &dmap, &qxmap, &dxmap}, fixed, fparts, fbar, ring, fk, ft,
                       2 * T, T,
                       [](int i, int& kind, int& t) {
                         kind = (i & 1) ? 3 : 0;
                         t = i >> 1;
                       },
                       h, b, C);
    }
    return;
  }

  regs_consumer();
  const Lane L;
  const int cw = L.cw, t4 = L.t4, r0 = L.r0;
  const int ks = 2 * blockIdx.x + cw, ka = ks * TILE + r0, kb = ka + 8;
  uint8_t* kt = fixed + (2 * cw) * TILE_BYTES;
  uint8_t* vt = fixed + (2 * cw + 1) * TILE_BYTES;
  uint8_t* kx = fparts + (2 * cw) * XTILE_BYTES;
  uint8_t* vx = fparts + (2 * cw + 1) * XTILE_BYTES;
  if (ks < T) {
    mbar_wait(&fbar[2 * cw], 0);
    mbar_wait(&fbar[2 * cw + 1], 0);
  }
  // the head's (c, 1/Σe, row term) of every query, into shared memory once
  const size_t plane = (size_t)gridDim.z * H * n;
  const float* gst = a.stats + ((size_t)b * H + h) * n;
  float* st_m = reinterpret_cast<float*>(ring.empty + BW_RING);
  float* st_inv = st_m + n;
  float* st_del = st_inv + n;
  for (int i = threadIdx.x - 128; i < 3 * n; i += 256) st_m[i] = gst[(i / n) * plane + i % n];
  named_sync(1, 256);

  float dv[32], dk[32], dvx[8], dkx[8];
#pragma unroll
  for (int e = 0; e < 32; ++e) dv[e] = dk[e] = 0.f;
#pragma unroll
  for (int e = 0; e < 8; ++e) dvx[e] = dkx[e] = 0.f;
  for (int qt = 0; qt < T; ++qt) {
    uint8_t* qtile = ring.wait(2 * qt);
    uint8_t* dtile = ring.wait(2 * qt + 1);
    uint8_t* qxp = ring.part(2 * qt);
    uint8_t* dxp = ring.part(2 * qt + 1);
    float st[32], dpt[32];
    keep(st);
    keep(dpt);
    wg_fence();
    mma_abt(st, kt, qtile);  // sᵀ: rows keys, columns queries
    if constexpr (X) mma_abt_x(st, kx, qxp);
    mma_abt(dpt, vt, dtile);  // dpᵀ
    if constexpr (X) mma_abt_x(dpt, vx, dxp);
    wg_commit();
    wg_wait0();
    keep(st);
    keep(dpt);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int qi = qt * TILE + acc_col(e, t4);
      const bool ok = qi < n;  // a query past n gets p = 0
      const float p = ok ? exp_row(st[e], sl2, st_m[qi]) * st_inv[qi] : 0.f;
      st[e] = p;
      dpt[e] = ok ? p * (dpt[e] - st_del[qi]) * scale : 0.f;
    }
    uint32_t pv[16], pk[16];
    to_frag(pv, st);   // pbᵀ
    to_frag(pk, dpt);  // dsbᵀ
    wg_fence();
    mma_pz(dv, pv, dtile);  // dV += pbᵀ·dO
    if constexpr (X) mma_pz_x(dvx, pv, dxp);
    mma_pz(dk, pk, qtile);  // dK += dsbᵀ·Q
    if constexpr (X) mma_pz_x(dkx, pk, qxp);
    wg_commit();
    wg_wait0();
    keep(dv);
    keep(dk);
    if constexpr (X) {
      keep(dvx);
      keep(dkx);
    }
    keep(pv);
    keep(pk);
    ring.release(2 * qt, L.leader);
    ring.release(2 * qt + 1, L.leader);
  }
  const size_t ld3 = (size_t)3 * C;
  bf16* dqkv = a.dqkv + (size_t)b * n * ld3 + h * D;
  store_head<D>(row_or_null(dqkv + C, ld3, ka, n), row_or_null(dqkv + C, ld3, kb, n), dk, dkx,
                t4);
  store_head<D>(row_or_null(dqkv + 2 * C, ld3, ka, n), row_or_null(dqkv + 2 * C, ld3, kb, n), dv,
                dvx, t4);
}

// `done` is the kernel's own cache (ready_kernel): the kernels share one
// type, so the caller keeps one for each.
template <typename Kernel>
cudaError_t launch_bwd(Kernel kernel, dim3 grid, int smem, int (&done)[KERNEL_CACHE_DEVICES],
                       const CUtensorMap (&maps)[4], const BwdArgs& a, cudaStream_t st) {
  int sms = 0;
  const cudaError_t e = ready_kernel(kernel, smem, done, &sms);
  if (e != cudaSuccess) return e;
  kernel<<<grid, BW_THREADS, smem, st>>>(maps[0], maps[1], maps[2], maps[3], a);
  return cudaGetLastError();
}

// B18 at head_dim D: one launch up to BW_FUSED_N tokens, else two. Returns
// the step (1 or 2) and cudaError_t as fail() packs them, 0 on success.
template <int D>
int sdpa_bwd(const void* qkv, const void* dout, const BwdArgs& a, int B, int H,
             cudaStream_t st) {
  using L = BwSmem<D>;
  const int n = a.n, C = a.C;
  CUtensorMap maps[4] = {};  // q, d, and at head_dim 80 their parts
  cudaError_t e = make_tile_map(&maps[0], qkv, 3 * C, n, B);
  if (e == cudaSuccess) e = make_tile_map(&maps[1], dout, C, n, B);
  if (e == cudaSuccess && L::X > 0)
    e = make_tile_map(&maps[2], qkv, 3 * C, n, B, TILE, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2 * XCOLS);
  if (e == cudaSuccess && L::X > 0)
    e = make_tile_map(&maps[3], dout, C, n, B, TILE, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2 * XCOLS);
  if (e != cudaSuccess) return fail(e, 1);
  static int fused_done[KERNEL_CACHE_DEVICES] = {}, query_done[KERNEL_CACHE_DEVICES] = {},
             key_done[KERNEL_CACHE_DEVICES] = {};  // one set per head_dim
  if (n <= BW_FUSED_N) {
    e = launch_bwd(sdpa_bwd_fused_kernel<D>, dim3(H, B), L::FUSED, fused_done, maps, a, st);
    return e == cudaSuccess ? 0 : fail(e, 1);
  }
  const dim3 grid(((n + TILE - 1) / TILE + 1) / 2, H, B);
  e = launch_bwd(sdpa_bwd_query_kernel<D>, grid, L::SPLIT, query_done, maps, a, st);
  if (e != cudaSuccess) return fail(e, 1);
  e = launch_bwd(sdpa_bwd_key_kernel<D>, grid, L::KEY, key_done, maps, a, st);
  return e == cudaSuccess ? 0 : fail(e, 2);
}

}  // namespace
}  // namespace rajni

using namespace rajni;

// head_dim C / H = 64 (n <= SDPA_MAX_N) or 80 (n <= SDPA_MAX_N_D80).
extern "C" int rajni_train_sdpa_bwd(const void* qkv, const void* dout, void* attn_out, void* dqkv,
                                    void* stats, int B, int n, int C, int H, float scale,
                                    void* stream) {
  const int D = H > 0 && C % H == 0 ? C / H : 0;
  if (!attn_head_dim_ok(D) || n < 1 || n > sdpa_max_n(D)) return fail(cudaErrorInvalidValue, 1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const BwdArgs a{static_cast<const bf16*>(dout), static_cast<bf16*>(attn_out),
                  static_cast<bf16*>(dqkv), static_cast<float*>(stats), n, C, scale};
  return D == ATTN_D80 ? sdpa_bwd<ATTN_D80>(qkv, dout, a, B, H, st)
                       : sdpa_bwd<ATTN_D>(qkv, dout, a, B, H, st);
}
