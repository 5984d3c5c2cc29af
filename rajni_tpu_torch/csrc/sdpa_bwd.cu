// B18: train_sdpa_bwd — the SDPA forward recomputed and differentiated, per
// head: (qkv [B, K, 3C], d_out [B, K, C]) -> (attn_out [B, K, C],
// d_qkv [B, K, 3C]), d_qkv packed [dQ | dK | dV] in the (qkv, head, dim) lane
// order of qkv, everything bf16 in and out.
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
// rounded itself, so that shortcut gives other numbers.
//
// Bound on the H100: bytes at T6's lengths. At batch 128, K=197, C=768 the six
// [K,K]x[K,64] products the function needs are 4.6e10 FLOP (0.046 ms at 989
// TFLOP/s) against 0.31 GB in and out (0.092 ms at 3.35 TB/s); at K=577
// (batch 32) the products, 1.0e11 FLOP (0.10 ms), bound it.
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
//   (1/Σ), c the row's max logit times scale·log2e. p32 on the key side is
//   recomputed from the query side's statistics, as FlashAttention does; its
//   logits come from the same bf16 operands summed in another order, so p32
//   may differ in its last fp32 bit.
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
constexpr int BW_RING = 16;      // ring stages (8 KB) of the two-launch kernels
constexpr int BW_XO_LD = 68;     // row stride (floats) of the partial-product exchange
constexpr int BW_FUSED_SMEM = 16 * TILE_BYTES + 64 * BW_XO_LD * 4 + 3 * 2 * 64 * 4 +
                              3 * BW_FUSED_N * 4 + 16 * 8 + 1024;
constexpr int BW_SPLIT_SMEM = (4 + BW_RING) * TILE_BYTES + (4 + 2 * BW_RING) * 8 + 1024;
// the key kernel also keeps the head's statistics, 3 x n fp32
constexpr int BW_KEY_SMEM = BW_SPLIT_SMEM + 3 * SDPA_MAX_N * 4;

struct BwdArgs {
  const bf16* dout;
  bf16* ao;
  bf16* dqkv;
  float* stats;  // [3, B, H, n]: row offset c (log2 domain), 1/Σe, row term (two launches)
  int n, C;
  float scale;
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
// columns of qkv, or of d_out (kind 3).
__device__ __forceinline__ void load_kind(uint8_t* dst, uint64_t* bar, const CUtensorMap* qmap,
                                          const CUtensorMap* dmap, int kind, int t, int h, int b,
                                          int C) {
  mbar_expect_tx(bar, TILE_BYTES);
  if (kind == 3) tma_load_tile(dst, dmap, bar, h * TILE, t * TILE, b);
  else tma_load_tile(dst, qmap, bar, kind * C + h * TILE, t * TILE, b);
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

// ---------------------------------------------------------------------------
// K <= 256: one launch
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(BW_THREADS, 1)
    sdpa_bwd_fused_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap dmap, BwdArgs a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* tiles = smem_aligned(smem_raw);  // kind k, tile t at 4k + t
  float* xo = reinterpret_cast<float*>(tiles + 16 * TILE_BYTES);  // [64][BW_XO_LD]
  float* red_max = xo + 64 * BW_XO_LD;  // [consumer][64 rows], then red_sum, red_del
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
      auto load = [&](int kind, int t) {
        load_kind(tiles + (4 * kind + t) * TILE_BYTES, &bars[4 * kind + t], &qmap, &dmap, kind, t,
                  h, b, C);
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
  const Lane L;
  const int cw = L.cw, t4 = L.t4, r0 = L.r0;
  const int j0 = cw ? T0 : 0, nt = cw ? T - T0 : T0;
  auto ready = [&](int kind, int t) -> uint8_t* {
    mbar_wait(&bars[4 * kind + t], 0);
    return tiles + (4 * kind + t) * TILE_BYTES;
  };
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
  // a 64x64 product split over the consumers' key tiles: consumer 1's
  // partial added to consumer 0's, which stores the rows
  auto sum_store = [&](float (&d)[32], bf16* ra, bf16* rb) {
    if (cw == 1) {
#pragma unroll
      for (int e = 0; e < 32; e += 2)
        *reinterpret_cast<float2*>(xo + (r0 + acc_row8(e)) * BW_XO_LD + acc_col(e, t4)) =
            make_float2(d[e], d[e + 1]);
    }
    named_sync(1, 256);
    if (cw == 0) {
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const float2 p = *reinterpret_cast<const float2*>(xo + (r0 + acc_row8(e)) * BW_XO_LD +
                                                          acc_col(e, t4));
        d[e] += p.x;
        d[e + 1] += p.y;
      }
      store_acc(ra, rb, d, t4);
    }
    named_sync(1, 256);
  };

  const size_t ld3 = (size_t)3 * C;
  bf16* ao = a.ao + (size_t)b * n * C + h * TILE;
  bf16* dqkv = a.dqkv + (size_t)b * n * ld3 + h * TILE;

  // query side
  for (int qs = 0; qs < T; ++qs) {
    const int qa = qs * TILE + r0, qb = qa + 8;
    uint8_t* qt = ready(0, qs);
    float s[BW_QT][32];
#pragma unroll
    for (int jj = 0; jj < BW_QT; ++jj) keep(s[jj]);
    wg_fence();
    // the consumer's two key tiles in one m64n128k16 product a step (tiles
    // t and t + 1 of a kind are adjacent); every product is issued (a
    // skipped one would make ptxas serialize them): with no tile of its own
    // a consumer reads the Q tiles, and a tile past its nt is masked to
    // -inf, so its p32 and dsb are 0
    if (nt > 1) ready(1, j0 + 1);
    mma_abt2(s[0], s[1], qt, nt > 0 ? ready(1, j0) : qt);
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

    float o[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) o[e] = 0.f;
    keep(o);
    wg_fence();
#pragma unroll
    for (int jj = 0; jj < BW_QT; ++jj) mma_pz(o, pf[jj], jj < nt ? ready(2, j0 + jj) : qt);  // pb·V
    wg_commit();
    wg_wait0();
    keep(o);
#pragma unroll
    for (int jj = 0; jj < BW_QT; ++jj) keep(pf[jj]);
    sum_store(o, row_or_null(ao, C, qa, n), row_or_null(ao, C, qb, n));

    float dp[BW_QT][32];
    uint8_t* dt = ready(3, qs);
#pragma unroll
    for (int jj = 0; jj < BW_QT; ++jj) keep(dp[jj]);
    wg_fence();
    if (nt > 1) ready(2, j0 + 1);
    mma_abt2(dp[0], dp[1], dt, nt > 0 ? ready(2, j0) : qt);  // dp = dO·Vᵀ
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
    float dq[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) dq[e] = 0.f;
    keep(dq);
    wg_fence();
#pragma unroll
    for (int jj = 0; jj < BW_QT; ++jj) mma_pz(dq, pf[jj], jj < nt ? ready(1, j0 + jj) : qt);  // dsb·K
    wg_commit();
    wg_wait0();
    keep(dq);
#pragma unroll
    for (int jj = 0; jj < BW_QT; ++jj) keep(pf[jj]);
    sum_store(dq, row_or_null(dqkv, ld3, qa, n), row_or_null(dqkv, ld3, qb, n));
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
    float dv[32], dk[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) dv[e] = dk[e] = 0.f;
    for (int qt = 0; qt < T; ++qt) {
      uint8_t* qtile = ready(0, qt);
      uint8_t* dtile = ready(3, qt);
      float st[32], dpt[32];
      keep(st);
      keep(dpt);
      wg_fence();
      mma_abt(st, kt, qtile);   // sᵀ: rows keys, columns queries
      mma_abt(dpt, vt, dtile);  // dpᵀ
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
      mma_pz(dk, pk, qtile);  // dK += dsbᵀ·Q
      wg_commit();
      wg_wait0();
      keep(dv);
      keep(dk);
      keep(pv);
      keep(pk);
    }
    const int ka = ks * TILE + r0, kb = ka + 8;
    store_acc(row_or_null(dqkv + C, ld3, ka, n), row_or_null(dqkv + C, ld3, kb, n), dk, t4);
    store_acc(row_or_null(dqkv + 2 * C, ld3, ka, n), row_or_null(dqkv + 2 * C, ld3, kb, n), dv,
              t4);
  }
}

// ---------------------------------------------------------------------------
// K > 256: two launches, the streamed tiles in a ring both consumers read
// ---------------------------------------------------------------------------

// Ring of BW_RING stages after the four fixed tiles; item i's stage and phase.
struct Ring {
  uint8_t* base;
  uint64_t* full;
  uint64_t* empty;
  __device__ uint8_t* wait(int i) const {
    mbar_wait(&full[i % BW_RING], (i / BW_RING) & 1);
    return base + (i % BW_RING) * TILE_BYTES;
  }
  __device__ void release(int i, bool leader) const {
    if (leader) mbar_arrive(&empty[i % BW_RING]);
  }
};

// Shared layout of the two-launch kernels: fixed tiles [4], ring, barriers
// (fixed [4], full [BW_RING], empty [BW_RING]).
__device__ __forceinline__ Ring split_layout(uint8_t* sm, uint8_t*& fixed, uint64_t*& fbar) {
  fixed = sm;
  uint8_t* ring = sm + 4 * TILE_BYTES;
  fbar = reinterpret_cast<uint64_t*>(ring + BW_RING * TILE_BYTES);
  return Ring{ring, fbar + 4, fbar + 4 + BW_RING};
}

// Producer of a two-launch kernel: the four fixed tiles (kinds fk[0..3] at
// tiles ft[0..3]), then ring items 0..items-1, item i being (kind_of, tile_of).
template <typename ItemFn>
__device__ __forceinline__ void split_produce(const CUtensorMap* qmap, const CUtensorMap* dmap,
                                              uint8_t* fixed, uint64_t* fbar, const Ring& ring,
                                              const int (&fk)[4], const int (&ft)[4], int items,
                                              int T, ItemFn item, int h, int b, int C) {
  for (int i = 0; i < 4; ++i)
    if (ft[i] < T) load_kind(fixed + i * TILE_BYTES, &fbar[i], qmap, dmap, fk[i], ft[i], h, b, C);
  for (int i = 0; i < items; ++i) {
    const int stage = i % BW_RING, round = i / BW_RING;
    if (round > 0) mbar_wait(&ring.empty[stage], (round - 1) & 1);
    int kind, t;
    item(i, kind, t);
    load_kind(ring.base + stage * TILE_BYTES, &ring.full[stage], qmap, dmap, kind, t, h, b, C);
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
__global__ void __launch_bounds__(BW_THREADS, 1)
    sdpa_bwd_query_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap dmap, BwdArgs a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* fixed;
  uint64_t* fbar;
  const Ring ring = split_layout(smem_aligned(smem_raw), fixed, fbar);
  const int h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int n = a.n, C = a.C, T = (n + TILE - 1) / TILE;
  const float scale = a.scale, sl2 = scale * LOG2E;
  split_init(fbar, ring);

  if (warpgroup_id() == 0) {  // items: K_0..K_{T-1}, then twice K_j, V_j
    regs_producer();
    if (threadIdx.x == 0) {
      const int s0 = 2 * blockIdx.x;
      const int fk[4] = {0, 3, 0, 3}, ft[4] = {s0, s0, s0 + 1, s0 + 1};
      split_produce(&qmap, &dmap, fixed, fbar, ring, fk, ft, 5 * T, T,
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

  float o[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) o[e] = 0.f;
  float da = 0.f, db = 0.f;
  for (int j = 0; j < T; ++j, it += 2) {  // pass 2: attn_out and the row term
    uint8_t* kt = ring.wait(it);
    uint8_t* vt = ring.wait(it + 1);
    float s[32], dp[32];
    keep(s);
    keep(dp);
    wg_fence();
    mma_abt(s, qt, kt);
    mma_abt(dp, dt, vt);
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
    wg_commit();
    wg_wait0();
    keep(o);
    keep(pf);
    ring.release(it, L.leader);
    ring.release(it + 1, L.leader);
  }
  da = quad_sum(da);
  db = quad_sum(db);
  const size_t ld3 = (size_t)3 * C;
  bf16* ao = a.ao + (size_t)b * n * C + h * TILE;
  store_acc(row_or_null(ao, C, qa, n), row_or_null(ao, C, qb, n), o, t4);
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

  float dq[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) dq[e] = 0.f;
  for (int j = 0; j < T; ++j, it += 2) {  // pass 3: dQ = dsb·K
    uint8_t* kt = ring.wait(it);
    uint8_t* vt = ring.wait(it + 1);
    float s[32], dp[32];
    keep(s);
    keep(dp);
    wg_fence();
    mma_abt(s, qt, kt);
    mma_abt(dp, dt, vt);
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
    wg_commit();
    wg_wait0();
    keep(dq);
    keep(pf);
    ring.release(it, L.leader);
    ring.release(it + 1, L.leader);
  }
  bf16* dqkv = a.dqkv + (size_t)b * n * ld3 + h * TILE;
  store_acc(row_or_null(dqkv, ld3, qa, n), row_or_null(dqkv, ld3, qb, n), dq, t4);
}

// (2) per pair of 64-key slabs: dK and dV
__global__ void __launch_bounds__(BW_THREADS, 1)
    sdpa_bwd_key_kernel(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap dmap, BwdArgs a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* fixed;
  uint64_t* fbar;
  const Ring ring = split_layout(smem_aligned(smem_raw), fixed, fbar);
  const int h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int n = a.n, C = a.C, T = (n + TILE - 1) / TILE;
  const float scale = a.scale, sl2 = scale * LOG2E;
  split_init(fbar, ring);

  if (warpgroup_id() == 0) {  // items: Q_qt, dO_qt for each query tile
    regs_producer();
    if (threadIdx.x == 0) {
      const int s0 = 2 * blockIdx.x;
      const int fk[4] = {1, 2, 1, 2}, ft[4] = {s0, s0, s0 + 1, s0 + 1};
      split_produce(&qmap, &dmap, fixed, fbar, ring, fk, ft, 2 * T, T,
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

  float dv[32], dk[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) dv[e] = dk[e] = 0.f;
  for (int qt = 0; qt < T; ++qt) {
    uint8_t* qtile = ring.wait(2 * qt);
    uint8_t* dtile = ring.wait(2 * qt + 1);
    float st[32], dpt[32];
    keep(st);
    keep(dpt);
    wg_fence();
    mma_abt(st, kt, qtile);   // sᵀ: rows keys, columns queries
    mma_abt(dpt, vt, dtile);  // dpᵀ
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
    mma_pz(dk, pk, qtile);  // dK += dsbᵀ·Q
    wg_commit();
    wg_wait0();
    keep(dv);
    keep(dk);
    keep(pv);
    keep(pk);
    ring.release(2 * qt, L.leader);
    ring.release(2 * qt + 1, L.leader);
  }
  const size_t ld3 = (size_t)3 * C;
  bf16* dqkv = a.dqkv + (size_t)b * n * ld3 + h * TILE;
  store_acc(row_or_null(dqkv + C, ld3, ka, n), row_or_null(dqkv + C, ld3, kb, n), dk, t4);
  store_acc(row_or_null(dqkv + 2 * C, ld3, ka, n), row_or_null(dqkv + 2 * C, ld3, kb, n), dv, t4);
}

// `done` is the kernel's own cache (ready_kernel): the three kernels share
// one type, so the caller keeps one for each.
template <typename Kernel>
cudaError_t launch_bwd(Kernel kernel, dim3 grid, int smem, int (&done)[KERNEL_CACHE_DEVICES],
                       const CUtensorMap& qmap, const CUtensorMap& dmap, const BwdArgs& a,
                       cudaStream_t st) {
  int sms = 0;
  const cudaError_t e = ready_kernel(kernel, smem, done, &sms);
  if (e != cudaSuccess) return e;
  kernel<<<grid, BW_THREADS, smem, st>>>(qmap, dmap, a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace rajni

using namespace rajni;

extern "C" int rajni_train_sdpa_bwd(const void* qkv, const void* dout, void* attn_out, void* dqkv,
                                    void* stats, int B, int n, int C, int H, float scale,
                                    void* stream) {
  if (n < 1 || n > SDPA_MAX_N || C != H * ATTN_D) return fail(cudaErrorInvalidValue, 1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap qmap, dmap;
  cudaError_t e = make_tile_map(&qmap, qkv, 3 * C, n, B);
  if (e == cudaSuccess) e = make_tile_map(&dmap, dout, C, n, B);
  if (e != cudaSuccess) return fail(e, 1);
  const BwdArgs a{static_cast<const bf16*>(dout), static_cast<bf16*>(attn_out),
                  static_cast<bf16*>(dqkv), static_cast<float*>(stats), n, C, scale};
  static int fused_done[KERNEL_CACHE_DEVICES] = {}, query_done[KERNEL_CACHE_DEVICES] = {},
             key_done[KERNEL_CACHE_DEVICES] = {};
  if (n <= BW_FUSED_N) {
    e = launch_bwd(sdpa_bwd_fused_kernel, dim3(H, B), BW_FUSED_SMEM, fused_done, qmap, dmap, a,
                   st);
    return e == cudaSuccess ? 0 : fail(e, 1);
  }
  const dim3 grid(((n + TILE - 1) / TILE + 1) / 2, H, B);
  e = launch_bwd(sdpa_bwd_query_kernel, grid, BW_SPLIT_SMEM, query_done, qmap, dmap, a, st);
  if (e != cudaSuccess) return fail(e, 1);
  e = launch_bwd(sdpa_bwd_key_kernel, grid, BW_KEY_SMEM, key_done, qmap, dmap, a, st);
  return e == cudaSuccess ? 0 : fail(e, 2);
}
