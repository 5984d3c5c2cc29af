// The short-row attention: B6's function (qkv [B, n_src, 3C] → [B, n, C],
// head_dim 64 or 80) for 1 <= n <= ATTN_MAX_N = 256 tokens, token t of image b
// being row idx[b, t] of qkv when idx is given (the one-hot gather of the TPU
// kernels, which is a gather since sel is 0/1), else row t; bf16 or fp32
// output, and with AMAX each output row's absmax over its head's columns
// (common.cuh:row_absmax, the int8 tails' dynamic route). It is the attention
// inside B7 fused_pruned_block_full, B14 fused_pruned_block_full_int8, K1 /
// B20, B5, B11 and B13 through the kept indices, and inside K2 (so B8, B16)
// and the contiguous int8 tails (B10, B15) where common.cuh and int8.cuh
// route them here.
//
// Replaces no TPU kernel of its own: it is the _mha (rajni_tpu/kernels/
// block.py:130) of those kernels, the attention half that each Pallas
// kernel computes in VMEM. Its form: logits q·kᵀ in fp32 from the bf16
// operands, scaled in fp32 (the per-head form), or, where the caller asks
// for _mha's phased form (common.cuh:mha_phased: below 4 MiB at a scale
// that is not a power of two, head_dim 80's 80^-0.5), from q·scale rounded
// to bf16 in the Q tile before the product (at head_dim 64's 1/8 the two
// forms give the same bits); softmax in fp32 with P normalized by 1/Σ
// before it is rounded to bf16, P·V accumulated in fp32 and rounded once.
// Each step is the plain version's operation: l = s·scale and l − max l
// rounded apart, expf, the correctly rounded 1/Σ. B6's ex2
// with log2(e) folded in (hopper.cuh:exp_row) was this kernel's first form:
// each attention held its gates, but over a training step's twelve blocks
// the first-step loss moved 6.0e-4 from the plain versions', twice
// chip_smoke's limit (2.7e-4 with expf); the register kernel it replaced
// took expf and 1/Σ too. expf costs time where the exps bind: at 197
// tokens, C = 768, B = 256 it read 0.211 ms contiguous and 0.249 gathered,
// against 0.154 and 0.197 with ex2 (chip_smoke, two runs, H100 SXM 700 W).
//
// Bound on the H100: bytes. At ViT-B/224 197→187 (B = 256, C = 768) the
// kept q, k and v rows are 220.6 MB and the output 73.5 MB in bf16 (147 MB
// in fp32): 0.088 ms (0.110) at 3.35 TB/s, against 0.028 ms for the 2.8e10
// FLOP and ~0.03 ms for the 1.1e8 exps at the special-function units' rate
// (expf takes about eight more instructions an exp on the other pipes, and
// at 197 tokens the exps bind: below).
//
// Design: persistent blocks (one an SM) of three warpgroups walk the B·H
// (image, head) units. A unit's T = ceil(n/64) tiles of q, k and v (64
// tokens of the head's 64 columns each, at most 96 KB; at head_dim 80 each
// tile also has its 16-column part, hopper.cuh, at most 120 KB) are loaded
// into shared memory once, in wgmma's 128-byte-swizzled K-major layout (the
// parts in the 32-byte swizzle), and serve all T of its 64-query slabs: each
// kept k and v row (and q row) is read from device memory at most once a
// unit, and no tile is transposed.
//   * Warpgroup 0 produces (setmaxnreg 56). Contiguous tokens come by TMA
//     (one thread, the 3-D tensor map over qkv, zero fill past n); tokens
//     through idx by cp.async issued by all 128 threads, each piece's
//     destination swizzled as TMA would place it, zero fill past n (a V row
//     past n must be finite: P is 0 there). A unit's pieces are all in
//     flight at once (n = 187: 3·192·8 = 4,608 pieces, 36 a thread), and the
//     producer signals a unit only after issuing the next one's, so two
//     units are in flight (with one stage, head_dim 80 at T = 4, a unit is
//     signalled before the producer waits for its stage to be freed); its
//     copies are waited on (cp.async.wait_group),
//     fenced for the async proxy and then arrived on the stage's full
//     mbarrier (128 arrivals). As many stages as 216 KB hold, at most 4
//     (head_dim 64: min(4, 9 / T), 96-216 KB; head_dim 80: 4, 3, 2 and 1 at
//     T = 1..4, 120-180 KB), let the loads run ahead of the products.
//   * Warpgroups 1 and 2 consume (setmaxnreg 224), taking whole slabs in
//     turn (slab i of the block's k-th unit is the block's slab kT + i, and
//     consumer c takes those ≡ c mod 2), so no key row is split between them
//     and no max or Σ crosses warpgroups; at T = 1 they take alternate
//     units. In the phased form a slab's consumer first rescales its Q
//     tile in place (scale_q_tile) and syncs its 128 threads.
//     S = Q·Kᵀ is one chain of m64n128k16 (and one m64n64k16 at odd
//     T) products with both operands in shared memory (head_dim 80: a fifth
//     k16 step on the 16-column parts): T·32 fp32 logits a thread (128 at n
//     = 256). The row max and Σe are taken in registers and by quad
//     shuffles, P normalized and rounded in registers is the register A
//     operand of P·V (m64n64k16, and m64n16k16 on V's 16-column part at
//     head_dim 80: 40 accumulators a thread), and V is read MN-major by the
//     descriptor. The two warpgroups run independently, so one's softmax
//     overlaps the other's products.
//   * Each slab's consumer arrives once on its stage's empty mbarrier (T
//     arrivals a unit) when its products have retired; the output goes out
//     from the accumulators in bf16 or fp32 pairs (always compact [B, n,
//     C]). AMAX is an instantiation of its own (the absmax's code slowed the
//     other callers of B6's body when it was not).
// The kernel is instantiated for each head_dim D, T (1..4), output type and
// AMAX (the int8 tails': head_dim 64, and 80 for ViT-H/14's int8 blocks).
#include "hopper.cuh"

namespace rajni {
namespace {

constexpr int SA_THREADS = 384;
constexpr int SA_MAX_T = ATTN_MAX_N / TILE;  // 4 slabs (and key tiles) a unit

// q, k and v of one 64-token tile: 24 KB at head_dim 64, 30 KB at 80.
template <int D>
__host__ __device__ constexpr int sa_unit_tile() {
  return 3 * (TILE_BYTES + xparts<D>() * XTILE_BYTES);
}
// Stages (units in shared memory at once): as many as 216 KB hold, at most 4.
template <int D>
__host__ __device__ constexpr int sa_stages(int T) {
  return (216 * 1024) / (T * sa_unit_tile<D>()) < 4 ? (216 * 1024) / (T * sa_unit_tile<D>()) : 4;
}
template <int D>
__host__ __device__ constexpr int sa_smem(int T) {
  return sa_stages<D>(T) * T * sa_unit_tile<D>() + 1024 + 2 * sa_stages<D>(T) * 8;
}

struct ShortArgs {
  const bf16* qkv;
  const int* idx;  // [B, n] or null (then n == n_src)
  void* out;       // [B, n, C], OutT
  float* amax;     // AMAX: [B·n] row absmax of out, zeroed by the caller
  int n_src, n, C, H, units;  // units = B·H
  float scale;
  int phased;  // q·scale rounded to bf16 before q·kᵀ (common.cuh:mha_phased)
};

// qkv_map: 64-column boxes (128-byte swizzle); x_map (head_dim 80): the
// 16-column parts' boxes (32-byte swizzle).
template <int D, int T, typename OutT, bool AMAX>
__global__ void __launch_bounds__(SA_THREADS, 1)
    short_attn_kernel(const __grid_constant__ CUtensorMap qkv_map,
                      const __grid_constant__ CUtensorMap x_map, ShortArgs a) {
  constexpr bool X = xparts<D>() > 0;
  constexpr int S = sa_stages<D>(T);
  // q tiles [0, T), k tiles [T, 2T), v tiles [2T, 3T); at head_dim 80 their
  // 16-column parts after them, in the same order
  constexpr int STAGE = T * sa_unit_tile<D>();
  constexpr int XOFF = 3 * T * TILE_BYTES;  // the parts' offset in a stage
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_aligned(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + S * STAGE);  // [S]
  uint64_t* empty = full + S;                                    // [S]

  const int n = a.n, C = a.C;
  const int wg = warpgroup_id();
  const bool gather = a.idx != nullptr;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], gather ? 128 : 1);
      mbar_init(&empty[s], T);  // one arrival a slab
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    regs_dec<56>();  // the consumers keep 224: T·32 logits, P·V, two P fragments
    const int tid = threadIdx.x;
    if (!gather && tid != 0) return;
    const size_t ld = (size_t)3 * C;
    const int ch = tid & 7, r8 = tid >> 3;  // this thread's 16-byte piece of rows r8 + 16i
    int pending = -1;                       // gather: the stage whose copies are in flight
    int k = 0;
#pragma unroll 1
    for (int u = blockIdx.x; u < a.units; u += gridDim.x, ++k) {
      const int st = k % S;
      if (k >= S) {
        if (pending == st) {  // one stage (head_dim 80, T = 4): the unit waited on is pending
          cp_async_wait<0>();
          fence_proxy_async();
          mbar_arrive(&full[pending]);
          pending = -1;
        }
        mbar_wait(&empty[st], ((k / S) - 1) & 1);
      }
      const int h = u % a.H, b = u / a.H;
      uint8_t* stage = sm + st * STAGE;
      if (!gather) {
        mbar_expect_tx(&full[st], STAGE);
#pragma unroll
        for (int j = 0; j < T; ++j)
#pragma unroll
          for (int w = 0; w < 3; ++w) {
            tma_load_tile(stage + (w * T + j) * TILE_BYTES, &qkv_map, &full[st],
                          w * C + h * D, j * TILE, b);
            if constexpr (X)
              tma_load_tile(stage + XOFF + (w * T + j) * XTILE_BYTES, &x_map, &full[st],
                            w * C + h * D + TILE, j * TILE, b);
          }
        continue;
      }
      const bf16* head = a.qkv + (size_t)b * a.n_src * ld + h * D;
      const bf16* src = head + ch * 8;
      const int* idx = a.idx + (size_t)b * n;
      int rows[4 * T];  // the unit's source rows of this thread, loaded together
#pragma unroll
      for (int i = 0; i < 4 * T; ++i) {
        const int t = r8 + 16 * i;
        rows[i] = t < n ? __ldg(idx + t) : -1;
      }
#pragma unroll
      for (int i = 0; i < 4 * T; ++i) {
        const int r = r8 + 16 * (i & 3), j = i >> 2;  // row r of tile j is token 16i + r8
        const bool valid = rows[i] >= 0;
        const bf16* row = src + (valid ? (size_t)rows[i] * ld : 0);
        const uint32_t off = sw128(r, ch);
#pragma unroll
        for (int w = 0; w < 3; ++w)
          cp_async16(stage + (w * T + j) * TILE_BYTES + off, row + w * C, valid);
      }
      if constexpr (X) {  // the 16-column parts: row tid / 2 of each tile, piece tid % 2
        const int xr = tid >> 1, xc = tid & 1;
#pragma unroll
        for (int j = 0; j < T; ++j) {
          const int t = j * TILE + xr;
          const bool valid = t < n;
          const bf16* row = head + TILE + xc * 8 + (valid ? (size_t)__ldg(idx + t) * ld : 0);
          const uint32_t off = XOFF + sw32(xr, xc);
#pragma unroll
          for (int w = 0; w < 3; ++w)
            cp_async16(stage + off + (w * T + j) * XTILE_BYTES, row + w * C, valid);
        }
      }
      cp_async_commit();
      if (pending >= 0) {  // the unit before: its group is the older of the two
        cp_async_wait<1>();
        fence_proxy_async();
        mbar_arrive(&full[pending]);
      }
      pending = st;
    }
    if (pending >= 0) {
      cp_async_wait<0>();
      fence_proxy_async();
      mbar_arrive(&full[pending]);
    }
    return;
  }

  // consumers
  regs_inc<224>();
  const int cw = wg - 1;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int r0 = ((threadIdx.x >> 5) & 3) * 16 + g;  // this thread's slab rows r0, r0 + 8
  const bool leader = (threadIdx.x & 127) == 0;
  const float scale = a.phased ? 1.f : a.scale;  // phased: the scale is in the Q tile
  const int units = (a.units - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
#pragma unroll 1
  for (int gs = cw; gs < units * T; gs += 2) {
    const int k = gs / T, i = gs % T, st = k % S;
    const int u = blockIdx.x + k * gridDim.x, h = u % a.H, b = u / a.H;
    uint8_t* stage = sm + st * STAGE;
    const uint8_t* qt = stage + i * TILE_BYTES;
    const uint8_t* kt = stage + T * TILE_BYTES;
    const uint8_t* vt = stage + 2 * T * TILE_BYTES;
    const uint8_t* qx = stage + XOFF + i * XTILE_BYTES;  // head_dim 80: the parts
    const uint8_t* kx = stage + XOFF + T * XTILE_BYTES;
    const uint8_t* vx = stage + XOFF + 2 * T * XTILE_BYTES;
    mbar_wait(&full[st], (k / S) & 1);
    if (a.phased) {  // q·scale rounded in place; this slab's Q is this warpgroup's alone
      scale_q_tile(stage + i * TILE_BYTES, TILE_BYTES, a.scale, threadIdx.x & 127, 128);
      if constexpr (X)
        scale_q_tile(stage + XOFF + i * XTILE_BYTES, XTILE_BYTES, a.scale, threadIdx.x & 127, 128);
      named_sync(1 + cw, 128);
    }

    // S = Q·Kᵀ over the unit's T key tiles, in pairs (m64n128k16)
    float s[T][32];
#pragma unroll
    for (int j = 0; j < T; ++j) keep(s[j]);
    wg_fence();
#pragma unroll
    for (int j = 0; j + 1 < T; j += 2) {
      mma_abt2(s[j], s[j + 1], qt, kt + j * TILE_BYTES);
      if constexpr (X) mma_abt2_x(s[j], s[j + 1], qx, kx + j * XTILE_BYTES);
    }
    if constexpr ((T & 1) == 1) {
      mma_abt(s[T - 1], qt, kt + (T - 1) * TILE_BYTES);
      if constexpr (X) mma_abt_x(s[T - 1], qx, kx + (T - 1) * XTILE_BYTES);
    }
    wg_commit();
    wg_wait0();
#pragma unroll
    for (int j = 0; j < T; ++j) keep(s[j]);
    if (n < T * TILE) mask_tail(s[T - 1], (T - 1) * TILE, n, t4);

    // the rows' max logit and Σ exp(l − max l), l = s·scale, four chains a row
    float mx[2][4];
#pragma unroll
    for (int e = 0; e < 8; ++e) mx[e >> 2][e & 3] = -INFINITY;
#pragma unroll
    for (int j = 0; j < T; ++j)
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        float& m = mx[(e >> 1) & 1][(e & 1) | ((e >> 1) & 2)];
        m = fmaxf(m, s[j][e]);
      }
    const float ca = __fmul_rn(
        quad_max(fmaxf(fmaxf(mx[0][0], mx[0][1]), fmaxf(mx[0][2], mx[0][3]))), scale);
    const float cb = __fmul_rn(
        quad_max(fmaxf(fmaxf(mx[1][0], mx[1][1]), fmaxf(mx[1][2], mx[1][3]))), scale);
    float ls[8] = {};
#pragma unroll
    for (int j = 0; j < T; ++j)
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const float p = expf(__fsub_rn(__fmul_rn(s[j][e], scale), acc_row8(e) ? cb : ca));
        s[j][e] = p;
        ls[(e & 3) | ((e >> 2) & 1) << 2] += p;
      }
    const float ia = __frcp_rn(quad_sum((ls[0] + ls[1]) + (ls[4] + ls[5])));
    const float ib = __frcp_rn(quad_sum((ls[2] + ls[3]) + (ls[6] + ls[7])));

    // O = P·V tile by tile, P normalized and rounded just before its product;
    // two fragment buffers, the product before the last retired each time
    float o[32], ox[8];  // ox: head_dim 80's columns 64-79
    uint32_t pf[2][16];
#pragma unroll
    for (int e = 0; e < 32; ++e) o[e] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) ox[e] = 0.f;
    keep(o);
    if constexpr (X) keep(ox);
#pragma unroll
    for (int j = 0; j < T; ++j) {
#pragma unroll
      for (int e = 0; e < 32; ++e) s[j][e] *= acc_row8(e) ? ib : ia;
      to_frag(pf[j & 1], s[j]);
      wg_fence();
      mma_pz(o, pf[j & 1], vt + j * TILE_BYTES);
      if constexpr (X) mma_pz_x(ox, pf[j & 1], vx + j * XTILE_BYTES);
      wg_commit();
      wg_wait1();
      keep(pf[(j + 1) & 1]);
    }
    wg_wait0();
    keep(o);
    if constexpr (X) keep(ox);
    keep(pf[0]);
    keep(pf[1]);
    if (leader) mbar_arrive(&empty[st]);  // this slab's reads of the stage are done

    const int q0 = i * TILE;
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

template <int D, int T, typename OutT, bool AMAX>
cudaError_t launch_short(const CUtensorMap& map, const CUtensorMap& xmap, const ShortArgs& a,
                         cudaStream_t st) {
  auto kernel = short_attn_kernel<D, T, OutT, AMAX>;
  constexpr int smem = sa_smem<D>(T);
  static int done[KERNEL_CACHE_DEVICES] = {};  // one per instantiation
  int sms = 0;
  const cudaError_t e = ready_kernel(kernel, smem, done, &sms);
  if (e != cudaSuccess) return e;
  kernel<<<min(a.units, sms), SA_THREADS, smem, st>>>(map, xmap, a);
  return cudaGetLastError();
}

template <int D, typename OutT, bool AMAX>
cudaError_t short_body(const ShortArgs& a, int B, cudaStream_t st) {
  CUtensorMap map = {}, xmap = {};
  if (a.idx == nullptr) {  // contiguous tokens: TMA
    cudaError_t e = make_tile_map(&map, a.qkv, 3 * a.C, a.n_src, B);
    if (e == cudaSuccess && xparts<D>() > 0)
      e = make_tile_map(&xmap, a.qkv, 3 * a.C, a.n_src, B, TILE,
                        CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2 * XCOLS);
    if (e != cudaSuccess) return e;
  }
  switch ((a.n + TILE - 1) / TILE) {
    case 1: return launch_short<D, 1, OutT, AMAX>(map, xmap, a, st);
    case 2: return launch_short<D, 2, OutT, AMAX>(map, xmap, a, st);
    case 3: return launch_short<D, 3, OutT, AMAX>(map, xmap, a, st);
    case SA_MAX_T: return launch_short<D, SA_MAX_T, OutT, AMAX>(map, xmap, a, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace rajni

using namespace rajni;

// The kernel's launches since the library was loaded, counted here, where
// every caller's launch happens: kernels/attention.py reads this count
// (rajni_short_attn_launches) as the short-row attention's.
static long long short_launches = 0;  // atomic: serving engines launch from threads

// The body behind common.cuh:launch_short_attention (every caller's attention
// at n <= ATTN_MAX_N): returns a cudaError_t. Head_dim 64 or 80, each with
// or without the row absmax (the int8 tails').
extern "C" int rajni_short_attn_body(const void* qkv, const int* idx, void* out, float* amax,
                                     int out_fp32, int B, int n_src, int n, int C, int H,
                                     float scale, int phased, void* stream) {
  const int D = H > 0 && C % H == 0 ? C / H : 0;
  if (n < 1 || n > ATTN_MAX_N || B < 1 || !attn_head_dim_ok(D) || (idx == nullptr && n != n_src))
    return (int)cudaErrorInvalidValue;
  const ShortArgs a{static_cast<const bf16*>(qkv), idx, out, amax, n_src, n, C, H, B * H, scale,
                    phased};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (D == ATTN_D80 && amax != nullptr)
    e = out_fp32 ? short_body<ATTN_D80, float, true>(a, B, st)
                 : short_body<ATTN_D80, bf16, true>(a, B, st);
  else if (D == ATTN_D80)
    e = out_fp32 ? short_body<ATTN_D80, float, false>(a, B, st)
                 : short_body<ATTN_D80, bf16, false>(a, B, st);
  else if (amax != nullptr)
    e = out_fp32 ? short_body<ATTN_D, float, true>(a, B, st)
                 : short_body<ATTN_D, bf16, true>(a, B, st);
  else
    e = out_fp32 ? short_body<ATTN_D, float, false>(a, B, st)
                 : short_body<ATTN_D, bf16, false>(a, B, st);
  if (e == cudaSuccess) __atomic_fetch_add(&short_launches, 1, __ATOMIC_RELAXED);
  return (int)e;
}

extern "C" long long rajni_short_attn_launches() {
  return __atomic_load_n(&short_launches, __ATOMIC_RELAXED);
}

// The kernel alone (kernels/attention.py:short_attention), for chip_smoke.py's
// gates and the routing measurements: qkv [B, n_src, 3C] bf16, idx [B, n]
// int32 or null, out [B, n, C] (fp32 when out_fp32), amax [B·n] zeroed or
// null, phased as common.cuh:mha_phased decides for the blocks.
extern "C" int rajni_short_attn(const void* qkv, const void* idx, void* out, void* amax,
                                int out_fp32, int B, int n_src, int n, int C, int H, float scale,
                                int phased, void* stream) {
  const int e = rajni_short_attn_body(qkv, static_cast<const int*>(idx), out,
                                      static_cast<float*>(amax), out_fp32, B, n_src, n, C, H,
                                      scale, phased, stream);
  return e == 0 ? 0 : fail(static_cast<cudaError_t>(e), 1);
}
