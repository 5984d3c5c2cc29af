// B6: fused_sdpa — multi-head self-attention on packed qkv [B, N, 3C] →
// [B, N, C], the "per-head" form: logits (q·kᵀ) * scale in fp32 from the
// unscaled operands, softmax in fp32 as exp(l - max) · (1/Σ), P normalized
// and only then rounded to bf16, P·V accumulated in fp32 and rounded once.
// The same body (rajni_sdpa_body) is the attention of K2, B5, K1/B20 and
// the int8 tails past ATTN_MAX_N tokens (common.cuh:launch_attention_any),
// there in the form _mha takes (common.cuh:mha_phased: with phased, q·scale
// rounded to bf16 in the Q tile before the product, each consumer rescaling
// half of it, then both synced):
// with idx (token t is row idx[b, t] of qkv [B, n_src, 3C]) and with an fp32
// output (the int8 blocks), for every 1 <= n <= SDPA_MAX_N = 848 at head_dim
// 64; at head_dim 80 (ViT-H/14) one pass, n <= SDPA_MAX_N_D80 = 384, in bf16,
// and for the int8 tails (fp32 output or the row absmax) past ATTN_MAX_N
// tokens only, where common.cuh:launch_attention_any sends them.
//
// Replaces the TPU kernel rajni_tpu/kernels/attention.py:71 fused_sdpa
// (pallas_call at attention.py:88; body _mha_kernel, 45-67), which holds one
// image's qkv and one head's [N, N] fp32 logits in VMEM.
//
// Bound on the H100: operations. At batch 128, N=577, C=768 the two products
// are 1.3e11 FLOP (0.132 ms at 989 TFLOP/s) and the 5.1e8 exps take 0.131 ms
// on the special-function units, against 0.45 GB of qkv in and out (0.135 ms
// at 3.35 TB/s).
//
// Design: persistent blocks (one an SM) of three warpgroups on wgmma
// (hopper.cuh); a block walks (head, image) units in the one-pass form and
// 64-query slabs in the two-pass form.
//   * Warpgroup 0 produces (40 registers): warp 0 loads each slab's Q tile
//     (two buffers), warp c consumer c's K and V tiles (64 tokens of the
//     head's 64 columns), each tile completing on its own full mbarrier and
//     freed through an empty one. Contiguous tokens come by TMA (a 3-D tensor
//     map over qkv, zero fill past its edges); tokens through idx by
//     cp.async, a warp keeping one tile in flight while it signals the one
//     before. Each consumer has its own slots, so it never waits on a slot
//     whose previous load it has not consumed itself (the parity waits need
//     that).
//   * Warpgroups 1 and 2 consume (232 registers each, setmaxnreg). They split
//     the key tiles of each 64-query row: the first takes tiles [0, T0), the
//     second [T0, T), T = ceil(n/64), T0 = ceil(T/2). S = Q·Kᵀ on m64n128k16
//     (two key tiles a product, Q read once for both) with both operands in
//     shared memory; P·V on m64n64k16 with P in registers (the accumulator
//     layout of S is the A-fragment layout) and V read transposed by the
//     tensor cores (MN-major descriptor) from its [token][dim] tile.
//   * One pass where the row fits, T <= 2·SD_NT = 10 tiles (n <= 640). The
//     threshold is the register reckoning: a consumer keeps its NT = T0 tiles
//     of fp32 logits in registers, 32 a tile a thread; at NT = 5 that is 160
//     of the 232 setmaxnreg gives, beside the P·V accumulator (32), a P
//     fragment (16) and addresses, and ptxas fits it without spilling the
//     logits; a sixth tile (192) would not fit. The kernel is instantiated
//     for each NT. The unit's K and V stay resident (K_j in slot j, V_j in
//     slot SD_NT + j: 160 KB at NT = 5) for all its T slabs, so qkv is read
//     once. Softmax in the log2 domain (hopper.cuh: one FFMA and one ex2 a
//     logit); the row max and Σe of the two halves are combined through 1 KB
//     of shared memory, P is normalized and rounded in registers, and the two
//     partial P·V sums (64x64 fp32) are added once through shared memory,
//     each consumer adding and storing half the rows. 2 products and 1 exp a
//     logit.
//   * Past 640 tokens, two passes, the tiles streamed through each
//     consumer's ring of SD_RING stages: the first pass takes each row's max
//     and Σe online (the running sum rescaled as the max rises), the second
//     recomputes S, normalizes, rounds and accumulates P·V. 3 products and 2
//     exps a logit there.
//   Either way P is normalized before it is rounded, as in the plain version.
//   * Head_dim 80: each tile is the 64-column tile and its 16-column part
//     (hopper.cuh: a fifth k16 step of S, an m64n16k16 product beside P·V's
//     m64n64k16, 40 accumulators a thread), so a slot is 10 KB. One pass
//     only. Shared memory: at NT = 5, 2·10 slots of 10 KB (200 KB), the Q
//     buffers and the P·V exchange (64x84 fp32) pass the 227 KB a block can
//     have; NT = 4 fits (208 KB). Registers: the producer, feeding each
//     tile's part too, spilled 28 bytes at 56 registers (ptxas, every NT), so
//     it keeps 72 and each consumer 216; NT·32 logits, the accumulators (40)
//     and a P fragment pair (32) are 168 at NT = 3 and 200 at NT = 4, too
//     near 216. So a consumer keeps at most SD_NT80 = 3 tiles (6 slots; 163
//     KB in all) and the rows are at most 384 tokens (ViT-H sends 257: T =
//     5, T0 = 3).
// What limits it (clock64 per phase on an H100 SXM, one-pass, N=577, about
// 10k cycles a slab): the split row makes a slab's phases serial, since the
// row max and Σe must cross both halves before P can be normalized: S with
// its max ~2.9k (tensor cores and FMNMX), the exps ~2.9k (the special-
// function units, 16 ex2 a clock an SM, are the bound), P·V ~2.1k, the
// exchange and store ~1.5k. Issuing wgmma stalls the issuing warp until the
// tensor cores take it, so one warpgroup cannot hide its epilogue under the
// next slab's products either.
#include "hopper.cuh"

namespace rajni {
namespace {

constexpr int SD_NT = 5;     // most key tiles of the row a consumer keeps in registers
constexpr int SD_NT80 = 3;   // the same at head_dim 80, which the registers bound
constexpr int SD_THREADS = 384;

// The shared memory of head_dim D: NTM the most tiles a consumer keeps,
// RING its tile slots (8 KB, and at head_dim 80 a 2 KB part each; a head's K
// and V at NTM tiles), XO_LD the row stride (floats) of the partial-P·V
// exchange. The 16-column parts follow the 64-column tiles (Q's two, then
// each consumer's slots), so head_dim 64's layout is the one it always had.
template <int D>
struct SdpaSmem {
  static constexpr int X = xparts<D>();
  static constexpr int NTM = X ? SD_NT80 : SD_NT;
  static constexpr int RING = 2 * NTM;
  static constexpr int XO_LD = D + 4;
  // the warpgroups' registers (head_dim 80's split: the design above)
  static constexpr int PRODUCER_REGS = X ? 72 : 40, CONSUMER_REGS = X ? 216 : 232;
  static constexpr int TILES = TILE_BYTES * (2 + 2 * RING);
  static constexpr int PARTS = X * XTILE_BYTES * (2 + 2 * RING);
  static constexpr int BYTES =
      TILES + PARTS + 64 * XO_LD * 4 + 2 * 2 * 64 * 4 + (4 + 4 * RING) * 8 + 1024;
};

struct SdpaArgs {
  const bf16* qkv;
  const int* idx;  // [B, n] or null
  void* out;       // [B, n, C], OutT
  float* amax;     // [B·n] row absmax of out (the int8 tails: AMAX), or null
  int n_src, n, C, H, units;  // units: B·H (one pass) or B·H·ceil(n/64) slabs (two passes)
  float scale;
  int phased;  // q·scale rounded to bf16 before q·kᵀ (common.cuh:mha_phased)
};

// D: the head_dim (64 or 80). NT: the key tiles each consumer holds in
// registers (one pass, NT = T0), or 0 for the two-pass form (head_dim 64).
// AMAX: take each output row's absmax into a.amax (the int8 tails' dynamic
// route, head_dim 64 and 80), an instantiation of its own, since its code in the
// epilogue slowed the others down by ~10% (H100, chip_smoke). qkv_map: the
// 64-column boxes; x_map (head_dim 80): the 16-column parts' boxes.
template <int D, int NT, typename OutT, bool AMAX>
__global__ void __launch_bounds__(SD_THREADS, 1)
    sdpa_wgmma_kernel(const __grid_constant__ CUtensorMap qkv_map,
                      const __grid_constant__ CUtensorMap x_map, SdpaArgs a) {
  using L = SdpaSmem<D>;
  constexpr bool X = L::X > 0;
  constexpr bool ONEPASS = NT > 0;
  static_assert(NT <= L::NTM && (D == 64 || ONEPASS), "head_dim 80: one pass");
  constexpr int SD_RING = L::RING, SD_XO_LD = L::XO_LD, NTM = L::NTM;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_aligned(smem_raw);
  uint8_t* qtiles = sm;                  // [2]: the k-th slab's Q in buffer k & 1
  uint8_t* rings = sm + 2 * TILE_BYTES;  // consumer c's slots [c·SD_RING, (c+1)·SD_RING)
  uint8_t* qparts = sm + L::TILES;       // head_dim 80: Q's [2] parts, then the slots'
  uint8_t* rparts = qparts + 2 * XTILE_BYTES;
  float* xo = reinterpret_cast<float*>(sm + L::TILES + L::PARTS);  // [64][SD_XO_LD]
  float* red_max = xo + 64 * SD_XO_LD;  // [consumer][64 rows]
  float* red_sum = red_max + 2 * 64;
  uint64_t* qfull = reinterpret_cast<uint64_t*>(red_sum + 2 * 64);  // [2]
  uint64_t* qempty = qfull + 2;                                      // [2]
  uint64_t* fulls = qempty + 2;                                      // [2 · SD_RING]
  uint64_t* empties = fulls + 2 * SD_RING;

  const int n = a.n, C = a.C, T = (n + TILE - 1) / TILE, T0 = (T + 1) / 2;
  const int wg = warpgroup_id(), warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool gather = a.idx != nullptr;

  if (threadIdx.x == 0) {
    for (int k = 0; k < 2; ++k) {
      mbar_init(&qfull[k], gather ? 32 : 1);
      mbar_init(&qempty[k], 2);  // both consumers
    }
    for (int s = 0; s < 2 * SD_RING; ++s) {
      mbar_init(&fulls[s], gather ? 32 : 1);
      mbar_init(&empties[s], 1);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // Unit u of this block's walk: head h of image b, and its slabs [s0, s1).
  auto unit = [&](int u, int& h, int& b, int& s0, int& s1) {
    const int hb = ONEPASS ? u : u / T;
    h = hb % a.H;
    b = hb / a.H;
    s0 = ONEPASS ? 0 : u % T;
    s1 = ONEPASS ? T : s0 + 1;
  };

  if (wg == 0) {  // producer warpgroup: warp c feeds consumer c (warp 0 also Q)
    regs_dec<L::PRODUCER_REGS>();
    if (warp >= 2) return;
    const int c = warp, j0 = c ? T0 : 0, nt = c ? T - T0 : T0;
    const size_t ld = (size_t)3 * C;
    uint8_t* ring = rings + c * SD_RING * TILE_BYTES;
    uint8_t* rpart = rparts + c * SD_RING * XTILE_BYTES;
    uint64_t* full = fulls + c * SD_RING;
    uint64_t* empty = empties + c * SD_RING;
    uint64_t* pending = nullptr;  // gather: the tile whose copies are still in flight
    // gather: signal the pending tile (its copies done and fenced for wgmma)
    auto flush = [&]() {
      if (pending != nullptr) {
        cp_async_wait<0>();
        fence_proxy_async();
        mbar_arrive(pending);
        pending = nullptr;
      }
    };
    // wait for a slot or Q buffer to be freed; the pending tile is signalled
    // first, since the consumer may need it to get there
    auto wait_free = [&](uint64_t* bar, uint32_t parity) {
      flush();
      mbar_wait(bar, parity);
    };
    int i = 0, k = 0, uc = 0;     // ring items, Q tiles and units so far
    for (int u = blockIdx.x; u < a.units; u += gridDim.x) {
      int h, b, s0, s1;
      unit(u, h, b, s0, s1);
      const bf16* src = a.qkv + (size_t)b * a.n_src * ld;
      const int* idx = gather ? a.idx + (size_t)b * n : nullptr;
      // a tile of the head's columns [col, col + D) into dst (and its part)
      auto load = [&](uint8_t* dst, uint8_t* part, uint64_t* bar, int col, int t0) {
        if (!gather) {
          if (lane == 0) {
            mbar_expect_tx(bar, TILE_BYTES + L::X * XTILE_BYTES);
            tma_load_tile(dst, &qkv_map, bar, col, t0, b);
            if constexpr (X) tma_load_tile(part, &x_map, bar, col + TILE, t0, b);
          }
          return;
        }
        if constexpr (X) gather_xpart(part, src, idx, ld, col + TILE, t0, n, lane);
        gather_tile(dst, src, idx, ld, col, t0, n, lane);
        if (pending != nullptr) {
          cp_async_wait<1>();
          fence_proxy_async();
          mbar_arrive(pending);
        }
        pending = bar;
      };
      // one item: K (v = 0) or V (v = 1) of key tile j into the next slot
      auto item = [&](int j, int v) {
        const int stage = i % SD_RING, round = i / SD_RING;
        if (round > 0) wait_free(&empty[stage], (round - 1) & 1);
        load(ring + stage * TILE_BYTES, rpart + stage * XTILE_BYTES, &full[stage],
             (1 + v) * C + h * D, j * TILE);
        ++i;
      };
      if (ONEPASS) {  // the unit's tiles once, resident for all its slabs: K_j0+r in
                      // slot r, V_j0+r in slot NTM + r, one use of each a unit
        for (int r = 0; r < 2 * nt; ++r) {
          const int slot = (r / nt) * NTM + r % nt;
          if (uc > 0) wait_free(&empty[slot], (uc - 1) & 1);
          load(ring + slot * TILE_BYTES, rpart + slot * XTILE_BYTES, &full[slot],
               (1 + r / nt) * C + h * D, (j0 + r % nt) * TILE);
        }
        ++uc;
      }
      for (int sl = s0; sl < s1; ++sl) {
        if (c == 0) {
          if (k >= 2) wait_free(&qempty[k & 1], ((k >> 1) - 1) & 1);
          load(qtiles + (k & 1) * TILE_BYTES, qparts + (k & 1) * XTILE_BYTES, &qfull[k & 1],
               h * D, sl * TILE);
          ++k;
        }
        if (!ONEPASS) {  // K_j0.. (pass 1), then K and V of each tile (pass 2)
          for (int r = 0; r < nt; ++r) item(j0 + r, 0);
          for (int r = 0; r < 2 * nt; ++r) item(j0 + r / 2, r & 1);
        }
      }
    }
    flush();
    return;
  }

  // consumers
  regs_inc<L::CONSUMER_REGS>();
  const int cw = wg - 1;  // consumer 0 or 1
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = (warp & 3) * 16 + g;  // this thread's slab rows r0 and r0 + 8
  const bool leader = (threadIdx.x & 127) == 0;
  const int j0 = cw ? T0 : 0, nt = cw ? T - T0 : T0;
  const float scale = a.phased ? 1.f : a.scale;  // phased: the scale is in the Q tile
  uint8_t* ring = rings + cw * SD_RING * TILE_BYTES;
  uint8_t* rpart = rparts + cw * SD_RING * XTILE_BYTES;
  uint64_t* full = fulls + cw * SD_RING;
  uint64_t* empty = empties + cw * SD_RING;
  int i0 = 0, k = 0, uc = 0;  // ring items before this slab, Q tiles and units so far

  auto wait_item = [&](int i) -> uint8_t* {
    mbar_wait(&full[i % SD_RING], (i / SD_RING) & 1);
    return ring + (i % SD_RING) * TILE_BYTES;
  };
  auto release = [&](int i) {
    if (leader) mbar_arrive(&empty[i % SD_RING]);
  };
  const float sl2 = scale * LOG2E;  // logits in the log2 domain (hopper.cuh)

  // one pass: the unit's resident slots (K_jj in slot jj, V_jj in NTM + jj)
  auto slot = [&](int sl) -> uint8_t* {
    mbar_wait(&full[sl], uc & 1);
    return ring + sl * TILE_BYTES;
  };
  // head_dim 80: a slot's 16-column part (after slot() has waited for it)
  auto part = [&](int sl) -> uint8_t* { return rpart + sl * XTILE_BYTES; };
  for (int u = blockIdx.x; u < a.units; u += gridDim.x, uc += ONEPASS) {
    int h, b, s0, s1;
    unit(u, h, b, s0, s1);
    for (int sl = s0; sl < s1; ++sl, ++k) {
      const int q0 = sl * TILE;
      uint8_t* qtile = qtiles + (k & 1) * TILE_BYTES;
      uint8_t* qpart = qparts + (k & 1) * XTILE_BYTES;
      mbar_wait(&qfull[k & 1], (k >> 1) & 1);
      if (a.phased) {  // q·scale rounded in place: both consumers read this Q, each does half
        scale_q_tile(qtile, TILE_BYTES, a.scale, threadIdx.x - 128, 256);
        if constexpr (X) scale_q_tile(qpart, XTILE_BYTES, a.scale, threadIdx.x - 128, 256);
        named_sync(1, 256);
      }
      const bool last = sl == s1 - 1;
      float o[32], ox[8];  // ox: head_dim 80's columns 64-79

      if constexpr (ONEPASS) {
        // S = Q·Kᵀ, every product issued (a skipped one would make ptxas
        // serialize them): a tile past this consumer's nt reads the Q tile,
        // a finite stand-in whose logits are masked to -inf, so its P is 0.
        // Tiles in pairs (m64n128k16), one group a pair, retired in order so
        // that a tile's masking and max run while later products are in
        // flight.
        float s[NT][32];
#pragma unroll
        for (int jj = 0; jj < NT; ++jj) keep(s[jj]);
        wg_fence();
#pragma unroll
        for (int jj = 0; jj + 1 < NT; jj += 2) {
          if (jj + 1 < nt) slot(jj + 1);
          mma_abt2(s[jj], s[jj + 1], qtile, jj < nt ? slot(jj) : qtile);
          if constexpr (X) mma_abt2_x(s[jj], s[jj + 1], qpart, jj < nt ? part(jj) : qpart);
          wg_commit();
        }
        if (NT & 1) {
          mma_abt(s[NT - 1], qtile, NT - 1 < nt ? slot(NT - 1) : qtile);
          if constexpr (X) mma_abt_x(s[NT - 1], qpart, NT - 1 < nt ? part(NT - 1) : qpart);
          wg_commit();
        }
        float mx[2][4];  // the rows' max raw logit, four chains a row
#pragma unroll
        for (int i = 0; i < 8; ++i) mx[i >> 2][i & 3] = -INFINITY;
#pragma unroll
        for (int jj = 0; jj < NT; ++jj) {
          wg_wait_pending((NT + 1) / 2 - 1 - jj / 2);  // tile jj's group retired
          keep(s[jj]);
          if (last && jj < nt && leader) mbar_arrive(&empty[jj]);
          if (jj >= nt) {
#pragma unroll
            for (int e = 0; e < 32; ++e) s[jj][e] = -INFINITY;
          } else if (j0 + jj == T - 1) {
            mask_tail(s[jj], (T - 1) * TILE, n, t4);
          }
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            float& m = mx[(e >> 1) & 1][(e & 1) | ((e >> 1) & 2)];
            m = fmaxf(m, s[jj][e]);
          }
        }
        if (leader) mbar_arrive(&qempty[k & 1]);
        const float ma = quad_max(fmaxf(fmaxf(mx[0][0], mx[0][1]), fmaxf(mx[0][2], mx[0][3])));
        const float mb = quad_max(fmaxf(fmaxf(mx[1][0], mx[1][1]), fmaxf(mx[1][2], mx[1][3])));
        if (t4 == 0) {
          red_max[cw * 64 + r0] = ma;
          red_max[cw * 64 + r0 + 8] = mb;
        }
        named_sync(1, 256);
        const float ca = fmaxf(red_max[r0], red_max[64 + r0]) * sl2;
        const float cb = fmaxf(red_max[r0 + 8], red_max[64 + r0 + 8]) * sl2;
        float ls[8] = {};  // four partial sums a row
#pragma unroll
        for (int jj = 0; jj < NT; ++jj)
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            const float p = exp_row(s[jj][e], sl2, acc_row8(e) ? cb : ca);
            s[jj][e] = p;
            ls[(e & 3) | ((e >> 2) & 1) << 2] += p;
          }
        const float la = quad_sum((ls[0] + ls[1]) + (ls[4] + ls[5]));
        const float lb = quad_sum((ls[2] + ls[3]) + (ls[6] + ls[7]));
        if (t4 == 0) {
          red_sum[cw * 64 + r0] = la;
          red_sum[cw * 64 + r0 + 8] = lb;
        }
        named_sync(1, 256);
        const float ia = row_recip(red_sum[r0] + red_sum[64 + r0]);
        const float ib = row_recip(red_sum[r0 + 8] + red_sum[64 + r0 + 8]);
        // P·V tile by tile, P normalized and rounded just before its product;
        // two fragment buffers, the product before the last retired each time
        uint32_t pf[2][16];
#pragma unroll
        for (int e = 0; e < 32; ++e) o[e] = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) ox[e] = 0.f;
        keep(o);
        if constexpr (X) keep(ox);
#pragma unroll
        for (int jj = 0; jj < NT; ++jj) {
#pragma unroll
          for (int e = 0; e < 32; ++e) s[jj][e] *= acc_row8(e) ? ib : ia;
          to_frag(pf[jj & 1], s[jj]);
          uint8_t* vt = jj < nt ? slot(NTM + jj) : qtile;
          wg_fence();
          mma_pz(o, pf[jj & 1], vt);
          if constexpr (X) mma_pz_x(ox, pf[jj & 1], jj < nt ? part(NTM + jj) : qpart);
          wg_commit();
          wg_wait1();
          keep(pf[(jj + 1) & 1]);
        }
        wg_wait0();
        keep(o);
        if constexpr (X) keep(ox);
        keep(pf[0]);
        keep(pf[1]);
        if (last && leader)
          for (int jj = 0; jj < nt; ++jj) mbar_arrive(&empty[NTM + jj]);

      } else {
        // (c, Σ) of rows r0, r0 + 8, c the row offset in the log2 domain
        float ca = -INFINITY, cb = -INFINITY, la = 0.f, lb = 0.f;
        for (int jj = 0; jj < nt; ++jj) {  // pass 1: max and Σe
          float s[32];
          keep(s);
          wg_fence();
          mma_abt(s, qtile, wait_item(i0 + jj));
          wg_commit();
          wg_wait0();
          keep(s);
          release(i0 + jj);
          if (j0 + jj == T - 1) mask_tail(s, (T - 1) * TILE, n, t4);
          online_row(ca, la, s, 0, sl2);
          online_row(cb, lb, s, 8, sl2);
        }
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
          merge_row(ca, la, __shfl_xor_sync(0xffffffffu, ca, off),
                    __shfl_xor_sync(0xffffffffu, la, off));
          merge_row(cb, lb, __shfl_xor_sync(0xffffffffu, cb, off),
                    __shfl_xor_sync(0xffffffffu, lb, off));
        }
        if (t4 == 0) {  // the two consumers' halves of the row combined
          red_max[cw * 64 + r0] = ca;
          red_max[cw * 64 + r0 + 8] = cb;
          red_sum[cw * 64 + r0] = la;
          red_sum[cw * 64 + r0 + 8] = lb;
        }
        named_sync(1, 256);
        ca = red_max[r0];
        la = red_sum[r0];
        cb = red_max[r0 + 8];
        lb = red_sum[r0 + 8];
        merge_row(ca, la, red_max[64 + r0], red_sum[64 + r0]);
        merge_row(cb, lb, red_max[64 + r0 + 8], red_sum[64 + r0 + 8]);
        const float ia = row_recip(la), ib = row_recip(lb);
#pragma unroll
        for (int e = 0; e < 32; ++e) o[e] = 0.f;
        keep(o);
        for (int jj = 0; jj < nt; ++jj) {  // pass 2: P·V
          const int ik = i0 + nt + 2 * jj;
          float s[32];
          keep(s);
          wg_fence();
          mma_abt(s, qtile, wait_item(ik));
          wg_commit();
          wg_wait0();
          keep(s);
          release(ik);
          if (j0 + jj == T - 1) mask_tail(s, (T - 1) * TILE, n, t4);
#pragma unroll
          for (int e = 0; e < 32; ++e)
            s[e] = acc_row8(e) ? exp_row(s[e], sl2, cb) * ib : exp_row(s[e], sl2, ca) * ia;
          uint32_t pf[16];
          to_frag(pf, s);
          uint8_t* vt = wait_item(ik + 1);
          wg_fence();
          mma_pz(o, pf, vt);
          wg_commit();
          wg_wait0();
          keep(o);
          keep(pf);
          release(ik + 1);
        }
        if (leader) mbar_arrive(&qempty[k & 1]);
        i0 += 3 * nt;
      }

      // the two partial P·V sums added once, through shared memory: consumer
      // 0 adds and stores rows 0-31, consumer 1 rows 32-63 (warps 0-1 and
      // 2-3 of each own those rows), each handing the other its half
      // warp-uniform (warps 0-1 of a consumer hold rows 0-31), and so seen
      // by ptxas through the shuffle: the row absmax's shuffles below would
      // otherwise make it serialize the wgmma
      const bool mine = __shfl_sync(0xffffffffu, (int)((cw == 0) == (r0 < 32)), 0);
      if (!mine) {
#pragma unroll
        for (int e = 0; e < 32; e += 2)
          *reinterpret_cast<float2*>(xo + (r0 + acc_row8(e)) * SD_XO_LD + acc_col(e, t4)) =
              make_float2(o[e], o[e + 1]);
        if constexpr (X) {
#pragma unroll
          for (int e = 0; e < 8; e += 2)
            *reinterpret_cast<float2*>(xo + (r0 + acc_row8(e)) * SD_XO_LD + TILE +
                                       acc_col(e, t4)) = make_float2(ox[e], ox[e + 1]);
        }
      }
      named_sync(2, 256);
      if (mine) {
#pragma unroll
        for (int e = 0; e < 32; e += 2) {
          const float2 p = *reinterpret_cast<const float2*>(xo + (r0 + acc_row8(e)) * SD_XO_LD +
                                                            acc_col(e, t4));
          o[e] += p.x;
          o[e + 1] += p.y;
        }
        if constexpr (X) {
#pragma unroll
          for (int e = 0; e < 8; e += 2) {
            const float2 p = *reinterpret_cast<const float2*>(
                xo + (r0 + acc_row8(e)) * SD_XO_LD + TILE + acc_col(e, t4));
            ox[e] += p.x;
            ox[e + 1] += p.y;
          }
        }
        OutT* out = static_cast<OutT*>(a.out) + ((size_t)b * n + q0) * C + h * D;
        OutT* ra = q0 + r0 < n ? out + (size_t)r0 * C : nullptr;
        OutT* rb = q0 + r0 + 8 < n ? out + (size_t)(r0 + 8) * C : nullptr;
        store_acc(ra, rb, o, t4);
        if constexpr (X) store_acc(ra ? ra + TILE : nullptr, rb ? rb + TILE : nullptr, ox, t4);
        if constexpr (AMAX) {  // |stored value|'s maximum over the head's columns
          float ma = 0.f, mb = 0.f;
          acc_absmax<OutT>(ma, mb, o);
          if constexpr (X) acc_absmax<OutT>(ma, mb, ox);
          ma = quad_max(ma);
          mb = quad_max(mb);
          if (t4 == 0 && q0 + r0 < n) row_absmax(a.amax, (size_t)b * n + q0 + r0, ma);
          if (t4 == 0 && q0 + r0 + 8 < n) row_absmax(a.amax, (size_t)b * n + q0 + r0 + 8, mb);
        }
      }
    }
  }
}

template <int D, int NT, typename OutT, bool AMAX>
cudaError_t launch_sdpa_wgmma(const CUtensorMap& map, const CUtensorMap& xmap, const SdpaArgs& a,
                              cudaStream_t st) {
  auto kernel = sdpa_wgmma_kernel<D, NT, OutT, AMAX>;
  constexpr int smem = SdpaSmem<D>::BYTES;
  static int done[KERNEL_CACHE_DEVICES] = {};  // one per instantiation
  int sms = 0;
  const cudaError_t e = ready_kernel(kernel, smem, done, &sms);
  if (e != cudaSuccess) return e;
  kernel<<<min(a.units, sms), SD_THREADS, smem, st>>>(map, xmap, a);
  return cudaGetLastError();
}

template <int D, typename OutT, bool AMAX>
cudaError_t sdpa_body(const SdpaArgs& a, int B, cudaStream_t st) {
  CUtensorMap map = {}, xmap = {};
  if (a.idx == nullptr) {  // contiguous tokens: TMA
    cudaError_t e = make_tile_map(&map, a.qkv, 3 * a.C, a.n_src, B);
    if (e == cudaSuccess && xparts<D>() > 0)
      e = make_tile_map(&xmap, a.qkv, 3 * a.C, a.n_src, B, TILE,
                        CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2 * XCOLS);
    if (e != cudaSuccess) return e;
  }
  const int t0 = (a.n + 2 * TILE - 1) / (2 * TILE);  // T0 = ceil(T / 2)
  if constexpr (D == ATTN_D80) {
    if (t0 == SD_NT80) return launch_sdpa_wgmma<D, SD_NT80, OutT, AMAX>(map, xmap, a, st);
    // the int8 tails' instantiations (fp32 output, AMAX) take only T0 = 3,
    // 257-384 tokens: below, every caller's attention is the short-row kernel
    if constexpr (std::is_same_v<OutT, bf16> && !AMAX) {
      if (t0 == 1) return launch_sdpa_wgmma<D, 1, OutT, AMAX>(map, xmap, a, st);
      if (t0 == 2) return launch_sdpa_wgmma<D, 2, OutT, AMAX>(map, xmap, a, st);
    }
    return cudaErrorInvalidValue;
  } else {
    switch (t0) {
      case 1: return launch_sdpa_wgmma<D, 1, OutT, AMAX>(map, xmap, a, st);
      case 2: return launch_sdpa_wgmma<D, 2, OutT, AMAX>(map, xmap, a, st);
      case 3: return launch_sdpa_wgmma<D, 3, OutT, AMAX>(map, xmap, a, st);
      case 4: return launch_sdpa_wgmma<D, 4, OutT, AMAX>(map, xmap, a, st);
      case SD_NT: return launch_sdpa_wgmma<D, SD_NT, OutT, AMAX>(map, xmap, a, st);
      default: return launch_sdpa_wgmma<D, 0, OutT, AMAX>(map, xmap, a, st);
    }
  }
}

}  // namespace
}  // namespace rajni

using namespace rajni;

// The body's launches since the library was loaded. Every caller's launch
// comes through rajni_sdpa_body, so they are counted here, where they happen:
// kernels/attention.py reads this as fused_sdpa's count (rajni_sdpa_launches).
static long long body_launches = 0;  // atomic: serving engines launch from threads

// The body behind common.cuh:launch_sdpa (every caller's attention past
// ATTN_MAX_N tokens): returns a cudaError_t. Head_dim 64, or 80 up to
// SDPA_MAX_N_D80 tokens, there with an fp32 output or the row absmax (the
// int8 tails') only past ATTN_MAX_N.
extern "C" int rajni_sdpa_body(const void* qkv, const int* idx, void* out, float* amax,
                               int out_fp32, int B, int n_src, int n, int C, int H, float scale,
                               int phased, void* stream) {
  const int D = H > 0 && C % H == 0 ? C / H : 0;
  if (n < 1 || n > sdpa_max_n(D) ||
      (D == ATTN_D80 && (out_fp32 || amax != nullptr) && n <= ATTN_MAX_N))
    return (int)cudaErrorInvalidValue;
  const int T = (n + TILE - 1) / TILE;
  const SdpaArgs a{static_cast<const bf16*>(qkv), idx, out, amax, n_src, n, C, H,
                   B * H * (T <= 2 * SD_NT ? 1 : T), scale, phased};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (D == ATTN_D80 && amax != nullptr)
    e = out_fp32 ? sdpa_body<ATTN_D80, float, true>(a, B, st)
                 : sdpa_body<ATTN_D80, bf16, true>(a, B, st);
  else if (D == ATTN_D80)
    e = out_fp32 ? sdpa_body<ATTN_D80, float, false>(a, B, st)
                 : sdpa_body<ATTN_D80, bf16, false>(a, B, st);
  else if (amax != nullptr)
    e = out_fp32 ? sdpa_body<ATTN_D, float, true>(a, B, st)
                 : sdpa_body<ATTN_D, bf16, true>(a, B, st);
  else
    e = out_fp32 ? sdpa_body<ATTN_D, float, false>(a, B, st)
                 : sdpa_body<ATTN_D, bf16, false>(a, B, st);
  if (e == cudaSuccess) __atomic_fetch_add(&body_launches, 1, __ATOMIC_RELAXED);
  return (int)e;
}

extern "C" long long rajni_sdpa_launches() {
  return __atomic_load_n(&body_launches, __ATOMIC_RELAXED);
}

// B6 fused_sdpa (idx and amax null, out_fp32 and phased 0): the attention of
// qkv [B, n_src, 3C] into out [B, n, C] (fp32 when out_fp32, else bf16) by
// this body, token t being row idx[b, t] when idx is given, q·scale rounded
// first with phased, each row's absmax into amax [B·n] (zeroed) when given
// (kernels/attention.py:body_attention and attention_route, which
// chip_smoke.py times against the short-row kernel, contiguous and gathered,
// and holds to _mha's phased form and to the int8 tails' row absmax).
extern "C" int rajni_sdpa(const void* qkv, const void* idx, void* out, void* amax, int out_fp32,
                          int B, int n_src, int n, int C, int H, float scale, int phased,
                          void* stream) {
  const int e = rajni_sdpa_body(qkv, static_cast<const int*>(idx), out, static_cast<float*>(amax),
                                out_fp32, B, n_src, n, C, H, scale, phased, stream);
  return e == 0 ? 0 : fail(static_cast<cudaError_t>(e), 1);
}
