// The Hopper GEMM of K1 fused_pruned_attn_block (QKV and proj,
// csrc/pruned_attn_block.cu), K2 fused_attn_block (QKV and proj,
// csrc/attn_block.cu), K3 fused_ln_mlp_residual (fc1 and fc2, csrc/mlp.cu),
// B4 fused_ln_qkv (QKV, csrc/ln_qkv.cu) and B5
// fused_gather_sdpa_proj_residual (proj, csrc/gather_attn.cu), and so of
// B7, B8, B16, B19 and B20, which run those entry points:
//   out[M, N] = epilogue(A[M, K] · W[N, K]ᵀ)
// A row-major bf16 (activations), W row-major bf16 [out, in] (nn.Linear):
// both operands are K-major, wgmma's plain SS case, with no transpose. The
// epilogues are common.cuh's (EpilogueArgs, Epilogue): EPI_BIAS, EPI_GELU and
// EPI_RESIDUAL, the residual row either row r of res or, with res_idx (K1,
// B5: the pre-norm x of the kept tokens), row (r / rows_out) · rows_in +
// res_idx[r], as gemm_bf16_kernel reads it. EPI_GELU_SAVE (B17, still on
// common.cuh:gemm_bf16_kernel) returns cudaErrorNotSupported.
// Numerics: bf16 operands, fp32 accumulation, the epilogue in fp32 from the
// fp32 sum and one rounding to bf16, as gemm_bf16_kernel (only the summation
// order differs).
//
// Replaces, inside those entry points, the products of the TPU kernels
// rajni_tpu/kernels/block.py:fused_pruned_attn_block (pallas_call at 1553),
// fused_attn_block (573), fused_ln_qkv (677), fused_gather_sdpa_proj_residual
// (1017, 1056) and rajni_tpu/kernels/mlp.py:fused_ln_mlp_residual (172).
//
// Bound on the H100: operations. At batch 256 and 197 tokens (M = 50432) the
// products have hundreds of FLOP per byte of device memory (fc1 at C=768:
// 2.4e11 FLOP against 0.4 GB). What the design must feed is the tensor cores:
// 989 TFLOP/s is ~4k FLOP a clock an SM, while shared memory gives 128 bytes
// a clock, so a wgmma needs > 32 FLOP per shared byte it reads, and the L2
// must deliver each tile's operands once.
//
// Design (hopper.cuh's building blocks):
//   * Persistent: one block an SM (min(tiles, SMs) blocks) walks the output
//     tiles t = blockIdx.x, + gridDim.x, ...; tile t is row band t / tiles_n
//     and column tile t % tiles_n, so the N tiles of one 128-row band of A
//     run side by side: A is read from device memory about once, and W (at
//     most 8 MB, fc1 at C=1024) stays in the 50 MB L2.
//   * Tile 128 x BN x 64. BN = 256 where N % 256 == 0 (every product of
//     ViT-B and ViT-L, and DeiT-S's fc1), else 128 (DeiT-S's QKV at N=1152
//     and proj/fc2 at N=384 in whole tiles; any other N % 8 == 0 masked). At
//     128 x 256 a k16 step reads (64 + 256)·32 bytes of shared memory for
//     64·256·32 FLOP a consumer (51 FLOP/byte) and the block's tile 85 FLOP a
//     byte of L2; at 128 x 128, 43 and 64.
//   * Warp-specialized, 384 threads. Warpgroup 0 produces (setmaxnreg 40):
//     one thread issues the TMA loads of each k-step's A box {64, 128} and W
//     box {64, BN} (128-byte swizzle, zero fill past M and N) into a ring of
//     192 KB (4 stages at BN = 256, 6 at 128) on full/empty mbarriers, and
//     runs ahead into the next tile while the consumers finish this one.
//     Warpgroups 1 and 2 consume (setmaxnreg 232): consumer c takes rows
//     64c..64c+63 of the tile and all BN columns, m64nBNk16 from shared
//     memory (4 a stage), fp32 accumulators in registers (BN / 2 a thread:
//     128 at BN = 256), one commit group in flight, each stage released to
//     the producer as soon as the products that read it retire.
//   * The epilogue runs from the accumulators in 64-column chunks: bias,
//     GELU, layer scale and residual in fp32, one rounding, each chunk
//     written into a swizzled 8 KB buffer in shared memory (two a consumer,
//     alternating) and stored by TMA, which writes only rows < M and columns
//     < N. The residual chunk comes into the same buffer (chunks 0 and 1
//     while the tile's first products run, each later one as soon as the
//     store two chunks back has read its buffer) and is added in place:
//     contiguous rows by TMA, completing on the buffer's mbarrier; rows
//     through res_idx by cp.async, which can gather where TMA cannot (a
//     Hopper tensor map addresses boxes of contiguous rows). Warp 0 of the
//     consumer gathers: the tile's 64 residual row numbers go to shared
//     memory once a tile, under its first products, when chunks 0 and 1 are
//     gathered. Each lane copies 16 of the chunk's 512 16-byte pieces into
//     their 128-byte-swizzled places (zero past M and N), then arrives on
//     the buffer's mbarrier when its copies land
//     (cp.async.mbarrier.arrive.noinc, 32 arrivals a phase). So, as with
//     TMA, only the issuing warp waits for the store that last read the
//     buffer; the others wait on the mbarrier. Each gathered row is a whole
//     128-byte line, as TMA would read it.
//     Stores and loads straight from the accumulator layout would move 16
//     bytes of each of 8 rows a warp instruction; TMA moves whole 128-byte
//     rows, off the consumers' instruction stream. GELU takes e^-logit by
//     ex2 and 1/(1 + e) by rcp and one Newton step (hopper.cuh: ex2,
//     row_recip): the IEEE division's slow path is a called subroutine, which
//     would spill the live accumulators.
//   What limits it: the epilogue is not overlapped with the tensor cores of
//   its own SM (both consumers finish a tile together); it costs most where a
//   tile's products are short (K = C: QKV, proj, fc1) and in fc1, whose GELU
//   is ~17 instructions an output on the CUDA cores. A ping-pong of the two
//   consumers over alternate tiles would hide it, at half the rows a tile
//   and so more L2 traffic a FLOP. The gathered residual costs more than the
//   TMA-loaded one, and as much through an identity index as through K1's
//   (chip_smoke prints the three side by side): the cp.async path, not the
//   rows' locality.
#pragma once

#include "hopper.cuh"

namespace rajni {
namespace {

constexpr int G9_BM = 128;   // tile rows: 64 a consumer warpgroup
constexpr int G9_BK = 64;    // k depth of a stage: one 128-byte swizzle row of bf16
constexpr int G9_THREADS = 384;
constexpr int G9_RING = 192 * 1024;  // bytes of the stage ring
constexpr int G9_OUT = 64 * 64 * 2;  // an output chunk: 64 rows x 64 columns, 8 KB

template <int BN>
struct G9Tile {
  static constexpr int A_BYTES = G9_BM * G9_BK * 2;  // 16 KB
  static constexpr int STAGE = A_BYTES + BN * G9_BK * 2;
  static constexpr int STAGES = G9_RING / STAGE;  // 4 at BN = 256, 6 at 128
  static constexpr int CHUNKS = BN / 64;          // output chunks of a consumer's rows
  // the ring, two output chunk buffers a consumer, the mbarriers (full and
  // empty a stage, one a chunk buffer), a tile's gathered residual rows (64
  // a consumer)
  static constexpr int SMEM = STAGES * STAGE + 4 * G9_OUT + (2 * STAGES + 4) * 8 + 2 * 64 * 4 +
                              1024;
  static constexpr int ACC = BN / 2;  // fp32 accumulators of a consumer thread
};

// Pin accumulators that a wgmma group reads or writes asynchronously (CUTLASS's
// warpgroup_fence_operand): before the fence and after each wait.
template <int NA>
__device__ __forceinline__ void keep_acc(float (&d)[NA]) {
#pragma unroll
  for (int i = 0; i < NA; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define RJ_F32(d, o)                                                                          \
  "+f"(d[o + 0]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), "+f"(d[o + 4]),             \
      "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7]), "+f"(d[o + 8]), "+f"(d[o + 9]),         \
      "+f"(d[o + 10]), "+f"(d[o + 11]), "+f"(d[o + 12]), "+f"(d[o + 13]), "+f"(d[o + 14]),    \
      "+f"(d[o + 15]), "+f"(d[o + 16]), "+f"(d[o + 17]), "+f"(d[o + 18]), "+f"(d[o + 19]),    \
      "+f"(d[o + 20]), "+f"(d[o + 21]), "+f"(d[o + 22]), "+f"(d[o + 23]), "+f"(d[o + 24]),    \
      "+f"(d[o + 25]), "+f"(d[o + 26]), "+f"(d[o + 27]), "+f"(d[o + 28]), "+f"(d[o + 29]),    \
      "+f"(d[o + 30]), "+f"(d[o + 31])
#define RJ_D64                                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "   \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "    \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "    \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define RJ_D128                                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "   \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "    \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "    \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "    \
  "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, "    \
  "%87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, "      \
  "%103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, "     \
  "%117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}"

// D = A·Bᵀ (+ D when acc != 0), m64n128k16: A 64 rows and B 128 rows, both
// K-major in shared memory; d in the accumulator layout of hopper.cuh's
// header, column block j (8 columns) in d[4j..4j+3].
__device__ __forceinline__ void wgmma_k16(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " RJ_D64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : RJ_F32(d, 0), RJ_F32(d, 32)
      : "l"(da), "l"(db), "r"(acc));
}

// The same with N = 256: B 256 rows.
__device__ __forceinline__ void wgmma_k16(float (&d)[128], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " RJ_D128
      ", %128, %129, p, 1, 1, 0, 0;\n}\n"
      : RJ_F32(d, 0), RJ_F32(d, 32), RJ_F32(d, 64), RJ_F32(d, 96)
      : "l"(da), "l"(db), "r"(acc));
}

#undef RJ_F32
#undef RJ_D64
#undef RJ_D128

// common.cuh:gelu_fast with e^-logit by ex2 and 1/(1 + e) by row_recip
// (1 + e >= 1), each within a few ulp of expf and the quotient.
__device__ __forceinline__ float gelu_fast_epi(float x) {
  const float p0 = 1.595741357441813f, p1 = 0.07277895825923464f,
              p2 = -1.7197148127561505e-4f, p3 = -7.415772250437636e-5f,
              p4 = 2.8973745195906267e-6f;
  const float t = fminf(fmaxf(x, -6.0f), 6.0f);
  const float t2 = t * t;
  const float logit = t * (p0 + t2 * (p1 + t2 * (p2 + t2 * (p3 + t2 * p4))));
  return x * row_recip(1.0f + ex2(-LOG2E * logit));
}

// Arrive on `bar` once this thread's cp.async copies so far have landed (the
// arrival counts against the barrier's expected count: noinc).
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Two bf16 of a vector operand at column c, zero past n (bias, ls, res rows).
__device__ __forceinline__ float2 ld_pair(const bf16* p, int c, int n) {
  return c < n ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + c))
               : make_float2(0.f, 0.f);
}

template <int EPI, int BN>
__global__ void __launch_bounds__(G9_THREADS, 1)
    gemm_sm90_kernel(const __grid_constant__ CUtensorMap amap,
                     const __grid_constant__ CUtensorMap wmap,
                     const __grid_constant__ CUtensorMap omap,
                     const __grid_constant__ CUtensorMap rmap, int M, int N, int K,
                     EpilogueArgs ep) {
  using T = G9Tile<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_aligned(smem_raw);
  uint8_t* outbuf = sm + T::STAGES * T::STAGE;  // consumer c's chunk buffers: 2c, 2c + 1
  uint64_t* full = reinterpret_cast<uint64_t*>(outbuf + 4 * G9_OUT);
  uint64_t* empty = full + T::STAGES;
  uint64_t* resbar = empty + T::STAGES;  // chunk buffer 2c + b holds its residual chunk
  const bool has_res = EPI == EPI_RESIDUAL && ep.res != nullptr;
  const bool gathered = has_res && ep.res_idx != nullptr;  // residual rows through res_idx
  const int tiles_n = (N + BN - 1) / BN, tiles = (M + G9_BM - 1) / G9_BM * tiles_n;
  const int KT = K / G9_BK;
  const int wg = warpgroup_id();

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(&full[s], 1);   // the producer's expect_tx, then the bytes
      mbar_init(&empty[s], 2);  // both consumers
    }
    // a TMA load's expect_tx, or the 32 lanes of the warp that gathers
    for (int b = 0; b < 4; ++b) mbar_init(&resbar[b], gathered ? 32 : 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {  // producer: one thread keeps the ring full, tile after tile
    regs_producer();
    if (threadIdx.x == 0) {
      int s = 0, round = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = t / tiles_n * G9_BM, n0 = t % tiles_n * BN;
        for (int kt = 0; kt < KT; ++kt) {
          if (round > 0) mbar_wait(&empty[s], (round - 1) & 1);
          uint8_t* stage = sm + s * T::STAGE;
          mbar_expect_tx(&full[s], T::STAGE);
          tma_load_tile(stage, &amap, &full[s], kt * G9_BK, m0, 0);
          tma_load_tile(stage + T::A_BYTES, &wmap, &full[s], kt * G9_BK, n0, 0);
          if (++s == T::STAGES) {
            s = 0;
            ++round;
          }
        }
      }
    }
    return;
  }

  // consumers
  regs_consumer();
  const int cw = wg - 1;  // rows 64·cw .. 64·cw + 63 of each tile
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int r0 = ((threadIdx.x >> 5) & 3) * 16 + g;  // rows r0, r0 + 8 of the consumer's 64
  const bool leader = (threadIdx.x & 127) == 0;
  float acc[T::ACC];
  int s = 0, round = 0;
  uint32_t rphase = 0;  // bit b: the parity of chunk buffer b's next residual load
  // the residual of chunk q into its buffer (leader, once the buffer's last
  // store has read it)
  auto load_res = [&](int q, int m0, int n0) {
    const int b = 2 * cw + (q & 1);
    mbar_expect_tx(&resbar[b], G9_OUT);
    tma_load_tile(outbuf + b * G9_OUT, &rmap, &resbar[b], n0 + 64 * q, m0 + cw * 64, 0);
  };
  // the same through res_idx, by warp 0 of the consumer (once the buffer's
  // last store has read it): lane l copies piece l % 8 of the tile's rows
  // (l / 8) + 4i, row r taking residual row s_rrow[r]; its 32 lanes arrive
  // on the buffer's mbarrier as their copies land
  int* s_rrow = reinterpret_cast<int*>(resbar + 4) + 64 * cw;
  const int cwarp = (threadIdx.x >> 5) & 3;
  auto gather_res = [&](int q, int n0) {
    const int b = 2 * cw + (q & 1), piece = lane & 7, c = n0 + 64 * q + 8 * piece;
#pragma unroll 4
    for (int i = 0; i < 16; ++i) {
      const int r = (lane >> 3) + 4 * i, row = s_rrow[r];
      const bool valid = row >= 0 && c < N;
      cp_async16(outbuf + b * G9_OUT + sw128(r, piece),
                 ep.res + (valid ? (size_t)row * N + c : 0), valid);
    }
    cp_async_commit();
    cp_async_mbar_arrive(&resbar[b]);
  };
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = t / tiles_n * G9_BM, n0 = t % tiles_n * BN;
    int prev = 0;  // the stage of the k-step before
#pragma unroll
    for (int i = 0; i < T::ACC; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < KT; ++kt) {
      mbar_wait(&full[s], round & 1);
      const uint8_t* stage = sm + s * T::STAGE;
      const uint64_t da = desc_k(stage + cw * 64 * 128), db = desc_k(stage + T::A_BYTES);
      keep_acc(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < G9_BK / 16; ++kk) wgmma_k16(acc, da + 2 * kk, db + 2 * kk, kt | kk);
      wg_commit();
      if (has_res && kt == 0) {  // chunks 0 and 1's residual, under the products
        if (gathered) {
          if (cwarp == 0) {
            // output row R takes residual row (R / rows_out) * rows_in + res_idx[R]
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int r = lane + 32 * i, R = m0 + cw * 64 + r;
              s_rrow[r] = R < M ? (R / ep.rows_out) * ep.rows_in + __ldg(ep.res_idx + R) : -1;
            }
            if (lane == 0) bulk_wait_read<0>();  // the last tile's stores have read both buffers
            __syncwarp();
            gather_res(0, n0);
            if (T::CHUNKS > 1) gather_res(1, n0);
          }
        } else if (leader) {
          bulk_wait_read<0>();
          load_res(0, m0, n0);
          if (T::CHUNKS > 1) load_res(1, m0, n0);
        }
      }
      wg_wait1();  // the k-step before has retired: its stage is free
      keep_acc(acc);
      if (kt > 0 && leader) mbar_arrive(&empty[prev]);
      prev = s;
      if (++s == T::STAGES) {
        s = 0;
        ++round;
      }
    }
    wg_wait0();
    keep_acc(acc);
    if (leader) mbar_arrive(&empty[prev]);

    // epilogue, chunk by chunk (64 columns: acc[32q..32q+31]): the fp32
    // epilogue from the accumulators, rounded into a swizzled chunk buffer
    // in shared memory (two a consumer, alternating), stored by TMA, which
    // writes only the rows < M and columns < N
#pragma unroll
    for (int q = 0; q < T::CHUNKS; ++q) {
      uint8_t* buf = outbuf + (2 * cw + (q & 1)) * G9_OUT;
      if (has_res) {  // buf holds the chunk's residual
        mbar_wait(&resbar[2 * cw + (q & 1)], (rphase >> (q & 1)) & 1);
        rphase ^= 1u << (q & 1);
      } else {
        if (leader) bulk_wait_read<1>();  // the store two chunks back has read buf
        named_sync(1 + cw, 128);
      }
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = 8 * q + jj, c = n0 + 8 * j + 2 * t4;
        const float2 b = ld_pair(ep.bias, c, N);
        float2 l = make_float2(1.f, 1.f);
        if (EPI == EPI_RESIDUAL && ep.ls != nullptr) l = ld_pair(ep.ls, c, N);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v0 = acc[4 * j + 2 * h] + b.x, v1 = acc[4 * j + 2 * h + 1] + b.y;
          if (EPI == EPI_GELU) {
            v0 = gelu_fast_epi(v0);
            v1 = gelu_fast_epi(v1);
          } else if (EPI == EPI_RESIDUAL) {
            v0 *= l.x;
            v1 *= l.y;
          }
          uint32_t* o = reinterpret_cast<uint32_t*>(buf + sw128(r0 + 8 * h, jj) + 4 * t4);
          if (has_res) {  // the residual in place: the same swizzled position
            const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(o));
            v0 = x.x + v0;
            v1 = x.y + v1;
          }
          *o = pack_bf16x2(v0, v1);
        }
      }
      fence_proxy_async();
      named_sync(1 + cw, 128);
      if (leader) {
        tma_store_tile(&omap, buf, n0 + 64 * q, m0 + cw * 64, 0);
        bulk_commit();
        if (has_res && !gathered && q + 2 < T::CHUNKS) {  // chunk q + 2's residual once buf is read
          bulk_wait_read<0>();
          load_res(q + 2, m0, n0);
        }
      }
      if (gathered && cwarp == 0 && q + 2 < T::CHUNKS) {  // the same, gathered
        if (lane == 0) bulk_wait_read<0>();
        __syncwarp();
        gather_res(q + 2, n0);
      }
    }
  }
  if (leader) bulk_wait_all();
}

template <int EPI, int BN>
inline cudaError_t launch_gemm_sm90_bn(const CUtensorMap& amap, const CUtensorMap& wmap,
                                       const CUtensorMap& omap, const CUtensorMap& rmap, int M,
                                       int N, int K, const EpilogueArgs& ep, cudaStream_t st) {
  auto kernel = gemm_sm90_kernel<EPI, BN>;
  static int done[KERNEL_CACHE_DEVICES] = {};  // one per instantiation
  int sms = 0;
  const cudaError_t e = ready_kernel(kernel, G9Tile<BN>::SMEM, done, &sms);
  if (e != cudaSuccess) return e;
  const int tiles = (M + G9_BM - 1) / G9_BM * ((N + BN - 1) / BN);
  kernel<<<min(tiles, sms), G9_THREADS, G9Tile<BN>::SMEM, st>>>(amap, wmap, omap, rmap, M, N,
                                                                 K, ep);
  return cudaGetLastError();
}

// out[M, N] = epilogue(A[M, K] · W[N, K]ᵀ) on the stream. Takes M >= 1,
// N % 8 == 0, K % 64 == 0 and 16-byte aligned A, W, out and res (every
// caller's operands are contiguous tensors or fresh scratch); with res_idx,
// EPI_RESIDUAL with res, rows_out >= 1 dividing M and rows_in >= 1 (the
// caller keeps each res_idx[r] in [0, rows_in)). Anything else, EPI_GELU_SAVE,
// a tensor map that does not encode, or a launch that fails returns its
// error.
template <int EPI>
inline cudaError_t launch_gemm_sm90(const bf16* A, const bf16* W, bf16* out, int M, int N, int K,
                                    const EpilogueArgs& ep, cudaStream_t st) {
  if constexpr (EPI != EPI_BIAS && EPI != EPI_GELU && EPI != EPI_RESIDUAL) {
    return cudaErrorNotSupported;
  } else {
    const bool gathered = ep.res_idx != nullptr;
    if (M < 1 || N < 8 || N % 8 || K < G9_BK || K % G9_BK) return cudaErrorInvalidValue;
    if (gathered && (EPI != EPI_RESIDUAL || ep.res == nullptr || ep.rows_out < 1 ||
                     ep.rows_in < 1 || M % ep.rows_out))
      return cudaErrorInvalidValue;
    if ((reinterpret_cast<uintptr_t>(A) | reinterpret_cast<uintptr_t>(W) |
         reinterpret_cast<uintptr_t>(out)) & 15)
      return cudaErrorMisalignedAddress;
    const bool wide = N % 256 == 0;
    if (ep.res != nullptr && (reinterpret_cast<uintptr_t>(ep.res) & 15))
      return cudaErrorMisalignedAddress;
    CUtensorMap amap = {}, wmap = {}, omap = {}, rmap = {};
    cudaError_t e = make_tile_map(&amap, A, K, M, 1, G9_BM);
    if (e == cudaSuccess) e = make_tile_map(&wmap, W, K, N, 1, wide ? 256 : 128);
    if (e == cudaSuccess) e = make_tile_map(&omap, out, N, M, 1, 64);
    if (e == cudaSuccess && EPI == EPI_RESIDUAL && ep.res != nullptr && !gathered)
      e = make_tile_map(&rmap, ep.res, N, M, 1, 64);  // gathered rows come by cp.async
    if (e != cudaSuccess) return e;
    return wide ? launch_gemm_sm90_bn<EPI, 256>(amap, wmap, omap, rmap, M, N, K, ep, st)
                : launch_gemm_sm90_bn<EPI, 128>(amap, wmap, omap, rmap, M, N, K, ep, st);
  }
}

}  // namespace
}  // namespace rajni
