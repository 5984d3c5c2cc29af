// The Hopper GEMM, bf16 and int8:
//   out[M, N] = epilogue(A[M, K] · W[N, K]ᵀ)
// A row-major (activations), W row-major [out, in] (nn.Linear, and the
// port's int8 weight record): both operands are K-major, wgmma's plain SS
// case, with no transpose (for 8-bit operands wgmma takes no other layout).
// One kernel, gemm_sm90_kernel<Epi>, serves both: the epilogue policy Epi
// names the operand type, the accumulator, what is stored and how each
// output is computed; the producer, the stage ring, the mainloop and the
// chunked epilogue store path are the same code.
//   * bf16 (Bf16Epi below, launch_gemm_sm90): the products of K1
//     fused_pruned_attn_block (QKV and proj, csrc/pruned_attn_block.cu), K2
//     fused_attn_block (csrc/attn_block.cu), K3 fused_ln_mlp_residual (fc1
//     and fc2, csrc/mlp.cu), B4 fused_ln_qkv (csrc/ln_qkv.cu), B5
//     fused_gather_sdpa_proj_residual (proj, csrc/gather_attn.cu) and B17
//     train_ln_mlp (fc1 and fc2, csrc/train_mlp.cu), and so of B7, B8, B16,
//     B19 and B20. The epilogues are common.cuh's (EpilogueArgs, Epilogue):
//     EPI_BIAS, EPI_GELU, EPI_RESIDUAL, the residual row either row r of res
//     or, with res_idx (K1, B5: the pre-norm x of the kept tokens), row (r /
//     rows_out) · rows_in + res_idx[r]; and EPI_GELU_SAVE (B17), which stores
//     two outputs a chunk, the rounded h to ep.aux and its GELU to out.
//     Numerics: fp32 accumulation, the epilogue in fp32 from the fp32 sum and
//     one rounding to bf16.
//   * int8 (int8.cuh: S8Epi, launch_gemm_s8): every product of the int8
//     kernels B9-B15, s8 x s8 -> s32 (m64nNk32), exact, with int8.cuh's
//     dequantizing epilogues, fc2's grouped fp32 flush and fc1's GELU
//     quantized in the epilogue; and the int8 tails' proj
//     (launch_gemm_s8q), whose A operand is the attention output in bf16 or
//     fp32, quantized per row as it is loaded.
//
// Replaces, inside those entry points, the products of the TPU kernels
// rajni_tpu/kernels/block.py:fused_pruned_attn_block (pallas_call at 1553),
// fused_attn_block (573), fused_ln_qkv (677), fused_gather_sdpa_proj_residual
// (1017, 1056), the int8 kernels there (1304, 1408, 1167, 1865, 2472, 2616)
// rajni_tpu/kernels/mlp.py:fused_ln_mlp_residual (172) and
// fused_ln_mlp_residual_int8 (413, 453), and
// rajni_tpu/kernels/train.py:train_ln_mlp (388).
//
// Bound on the H100: operations (the bf16 rate, or the int8 rate of twice
// it). At batch 256 and 197 tokens (M = 50432) the
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
//   * Tile 128 x BN x 128 bytes of k (64 bf16, 128 int8). BN = 256 where N %
//     256 == 0 (every product of ViT-B and ViT-L, and DeiT-S's fc1), else
//     128 (DeiT-S's QKV at N=1152 and proj/fc2 at N=384 in whole tiles; any
//     other N % 8 == 0 masked). At 128 x 256 a k16 step reads (64 + 256)·32
//     bytes of shared memory for 64·256·32 FLOP a consumer (51 FLOP/byte)
//     and the block's tile 85 FLOP a byte of L2; at 128 x 128, 43 and 64. An
//     int8 stage is the same bytes (a k32 step reads the same 32 bytes of a
//     row as a bf16 k16 step), at twice the operations a byte.
//   * Warp-specialized, 384 threads. Warpgroup 0 produces (setmaxnreg 40):
//     one thread issues the TMA loads of each k-step's A box {128 bytes, 128}
//     and W box {128 bytes, BN} (128-byte swizzle, zero fill past M and N) into a ring of
//     192 KB (4 stages at BN = 256, 6 at 128) on full/empty mbarriers, and
//     runs ahead into the next tile while the consumers finish this one.
//     Warpgroups 1 and 2 consume (setmaxnreg 232): consumer c takes rows
//     64c..64c+63 of the tile and all BN columns, m64nBNk16 from shared
//     memory (m64nBNk32 for int8; 4 a stage), fp32 (int32) accumulators in
//     registers (BN / 2 a thread: 128 at BN = 256), one commit group in
//     flight, each stage released to the producer as soon as the products
//     that read it retire.
//   * The epilogue runs from the accumulators in chunks of 128 bytes of a
//     row (64 bf16, 32 fp32 or 128 int8 columns): bias, GELU, layer scale
//     and residual in fp32, one rounding, each chunk written into a swizzled
//     8 KB buffer in shared memory (two a consumer, alternating) and stored
//     by TMA, which writes only rows < M and columns < N. The residual
//     chunk (bf16) comes into the same buffer (chunks 0 and 1 while the
//     tile's first products run, each later one as soon as the
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
//     would spill the live accumulators. Its products and sums are explicit
//     intrinsics, so that every instantiation rounds the same way (int8.cuh
//     holds two of them to each other bit for bit).
//   * EPI_GELU_SAVE (B17) stores each 128-byte chunk twice: the rounded h
//     through the chunk buffer to ep.aux (the tensor map in the residual's
//     slot, which B17 does not use), then its GELU through the other buffer
//     to out, so a chunk is two turns of the same alternating buffers.
//   * A quantized on load (QUANT_A, the int8 tails' proj): the producer
//     loads the raw A tile (bf16 or fp32, two or four 128-byte boxes a
//     stage) beside W, and each consumer thread reads its own A fragments
//     from it (wgmma's register layout for 8-bit A, as mma.m16n8k32's),
//     multiplies by its row's 127 / absmax, rounds, clips and packs them,
//     and issues the s8 products with A from registers (the RS form), one
//     k32 step a commit group, retired before the next step's fragment is
//     made (four registers: the consumers' 168 hold the BN = 256
//     accumulators with little to spare); each stage is freed as soon as
//     its last step retires, so the ring of two or three stages double-
//     buffers the loads. The row scale for the dequant is read again after
//     the mainloop, not held through it.
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

#include <type_traits>

#include "hopper.cuh"

namespace rajni {
namespace {

constexpr int G9_BM = 128;         // tile rows: 64 a consumer warpgroup
constexpr int G9_BKB = 128;        // bytes of k a stage: one 128-byte swizzle row
constexpr int G9_THREADS = 384;
constexpr int G9_RING = 192 * 1024;  // bytes of the stage ring
constexpr int G9_OUT = 64 * 128;     // an output chunk: 64 rows of 128 bytes, 8 KB

// ASZ: 128-byte boxes of A a stage (1; 2 or 4 for an A of bf16 or fp32
// quantized on load to int8)
template <int BN, int ASZ = 1>
struct G9Tile {
  static constexpr int A_BYTES = G9_BM * G9_BKB * ASZ;  // 16 KB a box
  static constexpr int STAGE = A_BYTES + BN * G9_BKB;
  // 4 at BN = 256, 6 at 128; A quantized on load 3 (bf16) or 2 (fp32)
  static constexpr int STAGES = G9_RING / STAGE;
  static_assert(STAGES >= 2, "the ring needs two stages");
  // the ring, two output chunk buffers a consumer, the mbarriers (full and
  // empty a stage, one a chunk buffer), a tile's gathered residual rows (64
  // a consumer)
  static constexpr int SMEM = STAGES * STAGE + 4 * G9_OUT + (2 * STAGES + 4) * 8 + 2 * 64 * 4 +
                              1024;
  static constexpr int ACC = BN / 2;  // accumulators of a consumer thread
};

// Pin accumulators that a wgmma group reads or writes asynchronously (CUTLASS's
// warpgroup_fence_operand): before the fence and after each wait.
template <int NA>
__device__ __forceinline__ void keep_acc(float (&d)[NA]) {
#pragma unroll
  for (int i = 0; i < NA; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int NA>
__device__ __forceinline__ void keep_acc(int (&d)[NA]) {
#pragma unroll
  for (int i = 0; i < NA; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define RJ_F32(d, o)                                                                          \
  "+f"(d[o + 0]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), "+f"(d[o + 4]),             \
      "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7]), "+f"(d[o + 8]), "+f"(d[o + 9]),         \
      "+f"(d[o + 10]), "+f"(d[o + 11]), "+f"(d[o + 12]), "+f"(d[o + 13]), "+f"(d[o + 14]),    \
      "+f"(d[o + 15]), "+f"(d[o + 16]), "+f"(d[o + 17]), "+f"(d[o + 18]), "+f"(d[o + 19]),    \
      "+f"(d[o + 20]), "+f"(d[o + 21]), "+f"(d[o + 22]), "+f"(d[o + 23]), "+f"(d[o + 24]),    \
      "+f"(d[o + 25]), "+f"(d[o + 26]), "+f"(d[o + 27]), "+f"(d[o + 28]), "+f"(d[o + 29]),    \
      "+f"(d[o + 30]), "+f"(d[o + 31])
#define RJ_S32(d, o)                                                                          \
  "+r"(d[o + 0]), "+r"(d[o + 1]), "+r"(d[o + 2]), "+r"(d[o + 3]), "+r"(d[o + 4]),             \
      "+r"(d[o + 5]), "+r"(d[o + 6]), "+r"(d[o + 7]), "+r"(d[o + 8]), "+r"(d[o + 9]),         \
      "+r"(d[o + 10]), "+r"(d[o + 11]), "+r"(d[o + 12]), "+r"(d[o + 13]), "+r"(d[o + 14]),    \
      "+r"(d[o + 15]), "+r"(d[o + 16]), "+r"(d[o + 17]), "+r"(d[o + 18]), "+r"(d[o + 19]),    \
      "+r"(d[o + 20]), "+r"(d[o + 21]), "+r"(d[o + 22]), "+r"(d[o + 23]), "+r"(d[o + 24]),    \
      "+r"(d[o + 25]), "+r"(d[o + 26]), "+r"(d[o + 27]), "+r"(d[o + 28]), "+r"(d[o + 29]),    \
      "+r"(d[o + 30]), "+r"(d[o + 31])
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

// One 32-byte k-step of a consumer's rows, D = A·Bᵀ (+ D when acc != 0), A
// 64 rows and B BN rows, both K-major in shared memory; d in the accumulator
// layout of hopper.cuh's header, column block j (8 columns) in d[4j..4j+3].
// bf16 (fp32 accumulators): m64nBNk16.
__device__ __forceinline__ void wgmma_step(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " RJ_D64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : RJ_F32(d, 0), RJ_F32(d, 32)
      : "l"(da), "l"(db), "r"(acc));
}
__device__ __forceinline__ void wgmma_step(float (&d)[128], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " RJ_D128
      ", %128, %129, p, 1, 1, 0, 0;\n}\n"
      : RJ_F32(d, 0), RJ_F32(d, 32), RJ_F32(d, 64), RJ_F32(d, 96)
      : "l"(da), "l"(db), "r"(acc));
}
// int8 (int32 accumulators, exact): m64nBNk32. For 8-bit operands wgmma
// takes no scale or transpose arguments.
__device__ __forceinline__ void wgmma_step(int (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " RJ_D64 ", %64, %65, p;\n}\n"
      : RJ_S32(d, 0), RJ_S32(d, 32)
      : "l"(da), "l"(db), "r"(acc));
}
__device__ __forceinline__ void wgmma_step(int (&d)[128], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 " RJ_D128 ", %128, %129, p;\n}\n"
      : RJ_S32(d, 0), RJ_S32(d, 32), RJ_S32(d, 64), RJ_S32(d, 96)
      : "l"(da), "l"(db), "r"(acc));
}

// The same with A from registers (the RS form): a holds this thread's
// fragment of the 64 x 32 int8 A (mma.m16n8k32's layout per warp).
__device__ __forceinline__ void wgmma_step_rs(int (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                              int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " RJ_D64
      ", {%64, %65, %66, %67}, %68, p;\n}\n"
      : RJ_S32(d, 0), RJ_S32(d, 32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}
__device__ __forceinline__ void wgmma_step_rs(int (&d)[128], const uint32_t (&a)[4], uint64_t db,
                                              int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 " RJ_D128
      ", {%128, %129, %130, %131}, %132, p;\n}\n"
      : RJ_S32(d, 0), RJ_S32(d, 32), RJ_S32(d, 64), RJ_S32(d, 96)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

#undef RJ_F32
#undef RJ_S32
#undef RJ_D64
#undef RJ_D128

// common.cuh:gelu_fast with e^-logit by ex2 and 1/(1 + e) by row_recip
// (1 + e >= 1), each within a few ulp of expf and the quotient; every
// product and sum an explicit intrinsic, so no instantiation contracts it
// otherwise than another.
__device__ __forceinline__ float gelu_fast_epi(float x) {
  const float p0 = 1.595741357441813f, p1 = 0.07277895825923464f,
              p2 = -1.7197148127561505e-4f, p3 = -7.415772250437636e-5f,
              p4 = 2.8973745195906267e-6f;
  const float t = fminf(fmaxf(x, -6.0f), 6.0f);
  const float t2 = __fmul_rn(t, t);
  float p = __fmaf_rn(t2, p4, p3);
  p = __fmaf_rn(t2, p, p2);
  p = __fmaf_rn(t2, p, p1);
  p = __fmaf_rn(t2, p, p0);
  const float logit = __fmul_rn(t, p);
  return __fmul_rn(x, row_recip(__fadd_rn(1.0f, ex2(__fmul_rn(-LOG2E, logit)))));
}

// kernels/math.py:gelu_fast as PyTorch evaluates it on the card, for B17's
// GELU of the rounded h (EPI_GELU_SAVE): each operation rounded once, in the
// Python expression's order (p3 + t2·p4 first, then t · p), the coefficients
// the Python floats rounded to fp32 as PyTorch rounds a scalar operand, and
// torch.sigmoid's 1 / (1 + expf(-logit)). Every input of this epilogue is a
// bf16 value, so chip_smoke holds it to PyTorch's gelu_fast of the stored h
// bit for bit. 1 + e lies in [1, 1 + e^33) (|logit| <= 32.4 at the clamp),
// far from the reciprocal's special cases.
__device__ __forceinline__ float gelu_fast_torch(float x) {
  const float p0 = (float)1.595741357441813, p1 = (float)0.07277895825923464,
              p2 = (float)-1.7197148127561505e-4, p3 = (float)-7.415772250437636e-5,
              p4 = (float)2.8973745195906267e-6;
  const float t = fminf(fmaxf(x, -6.0f), 6.0f);
  const float t2 = __fmul_rn(t, t);
  float p = __fadd_rn(__fmul_rn(t2, p4), p3);
  p = __fadd_rn(__fmul_rn(t2, p), p2);
  p = __fadd_rn(__fmul_rn(t2, p), p1);
  p = __fadd_rn(__fmul_rn(t2, p), p0);
  const float logit = __fmul_rn(t, p);
  return __fmul_rn(x, __frcp_rn(__fadd_rn(1.0f, expf(-logit))));
}

// Four raw A values (bf16 or fp32) at row r (0..127) and k .. k + 3 of a
// stage's raw A tile: 128-byte boxes of 128 rows, box j holding k
// [j·E, (j + 1)·E), E = 128 / sizeof(T), in the 128-byte swizzle.
template <typename T>
__device__ __forceinline__ float4 raw4(const uint8_t* tile, int r, int k) {
  constexpr int E = G9_BKB / (int)sizeof(T);
  const int byte = (k % E) * (int)sizeof(T);
  const uint8_t* p = tile + (k / E) * (G9_BM * G9_BKB) + sw128(r, byte >> 4) + (byte & 15);
  if constexpr (std::is_same_v<T, float>) {
    return *reinterpret_cast<const float4*>(p);
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
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
// The same of an fp32 vector operand (the int8 epilogues' scales and bias).
__device__ __forceinline__ float2 ld_pair(const float* p, int c, int n) {
  return c < n ? *reinterpret_cast<const float2*>(p + c) : make_float2(0.f, 0.f);
}

// int8.cuh's quant1(v) in the low byte of the result, with no conversion
// instruction: clipped first (rint and the clip commute at integer bounds),
// then rounded half to even by the addition itself, at 1.5·2^23, where the
// ulp is 1, so the float's bits are 0x4B400000 + the integer. The
// epilogue's I2F, ex2 and reciprocal already queue on the quarter-rate unit
// that FRND and F2I would take.
__device__ __forceinline__ uint32_t quant1_bits(float v) {
  return __float_as_uint(__fadd_rn(fminf(fmaxf(v, -127.f), 127.f), 12582912.f));
}

// Four values times mul, each rounded half to even and clipped (quant1),
// packed as int8 in k order (lowest k in the lowest byte).
__device__ __forceinline__ uint32_t quant4(float4 v, float mul) {
  const uint32_t a = quant1_bits(__fmul_rn(v.x, mul)), b = quant1_bits(__fmul_rn(v.y, mul)),
                 c = quant1_bits(__fmul_rn(v.z, mul)), d = quant1_bits(__fmul_rn(v.w, mul));
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// Pin an A fragment that a wgmma read asynchronously: a use after the wait
// that retired it, so that its registers are not reused before.
__device__ __forceinline__ void keep_frag(const uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" ::"r"(a[i]) : "memory");
}

// One k32 step's A fragment of a consumer thread, quantized from the stage's
// raw A tile: register 0 row r, k .. k + 3; 1 row r + 8; 2 and 3 the same at
// k + 16 (r = the thread's first row in the tile, k = 32·step + 4·(lane %
// 4)); rows r and r + 8 take mul0 and mul1.
template <typename T>
__device__ __forceinline__ void quant_frag(uint32_t (&a)[4], const uint8_t* tile, int r, int k,
                                           float mul0, float mul1) {
  a[0] = quant4(raw4<T>(tile, r, k), mul0);
  a[1] = quant4(raw4<T>(tile, r + 8, k), mul1);
  a[2] = quant4(raw4<T>(tile, r, k + 16), mul0);
  a[3] = quant4(raw4<T>(tile, r + 8, k + 16), mul1);
}

// Two adjacent outputs into an output chunk at o: bf16 (rounded), fp32, or
// int8 (the value already scaled; rounded half to even and clipped).
template <typename Out>
__device__ __forceinline__ void store2(uint8_t* o, float2 v) {
  if constexpr (std::is_same_v<Out, bf16>) {
    *reinterpret_cast<uint32_t*>(o) = pack_bf16x2(v.x, v.y);
  } else if constexpr (std::is_same_v<Out, float>) {
    *reinterpret_cast<float2*>(o) = v;
  } else {
    *reinterpret_cast<uint16_t*>(o) =
        (uint16_t)__byte_perm(quant1_bits(v.x), quant1_bits(v.y), 0x0040);
  }
}

// Two adjacent sums (accumulator element i and i + 1) in fp32: the flushed
// fp32 sums of a grouped product, else the accumulators converted.
template <bool GROUPED, int NA, int NF, typename Acc>
__device__ __forceinline__ float2 acc_pair(const Acc (&acc)[NA], const float (&accf)[NF], int i) {
  if constexpr (GROUPED) {
    return make_float2(accf[i], accf[i + 1]);
  } else if constexpr (std::is_same_v<Acc, int>) {
    return make_float2(__int2float_rn(acc[i]), __int2float_rn(acc[i + 1]));
  } else {
    return make_float2(acc[i], acc[i + 1]);
  }
}

template <typename T>
constexpr CUtensorMapDataType tile_map_type() {
  return std::is_same_v<T, int8_t>  ? CU_TENSOR_MAP_DATA_TYPE_UINT8
         : std::is_same_v<T, float> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                    : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// The kernel's epilogue policy. Every Epi has
//   In, Acc    the operand type and its accumulator (bf16 and float, or
//              int8_t and int): a stage is 128 bytes of k of either;
//   ARaw, QUANT_A  A's type in device memory: In, or (QUANT_A, int8 only)
//              bf16 or fp32 quantized on load with each row's Rows::mul;
//   Out        what a chunk holds, 128 bytes of a row (64 bf16, 32 fp32 or
//              128 int8 columns);
//   BN         the column tile; RESIDUAL (the bf16 residual is read into
//              the chunk buffer and added in place), GROUPED (int8 fc2: the
//              int32 sums are flushed to fp32 every group_k of k),
//              ROW_MAX (each row's |output| maximum over the tile goes to
//              row_max: int8.cuh's GELU absmax) and SAVE (EPI_GELU_SAVE:
//              apply's value rounded to the aux map, then second(value) to
//              out);
//   Args       its arguments, with the residual's res, res_idx, rows_out,
//              rows_in and group_k;
//   Rows rows(ep, r, M, N, n0, t4)   per-row values of the tile at n0;
//   Cols cols(ep, c, N)              per-column values of columns c, c + 1;
//   apply(ep, v, cols, rows)         the epilogue of two adjacent sums;
//   add_res(x, v)                    x + v, the residual added;
// and a grouped one group_scale(ep, r, M, groups, grp) and flush(ep, accf,
// acc, ga), a ROW_MAX one row_max(ep, r, M, N, n0, m, t4).
template <int EPI, int BN_>
struct Bf16Epi {
  using In = bf16;
  using Acc = float;
  using Out = bf16;
  using ARaw = bf16;
  using Args = EpilogueArgs;
  static constexpr int BN = BN_;
  static constexpr bool RESIDUAL = EPI == EPI_RESIDUAL, GROUPED = false, ROW_MAX = false,
                        QUANT_A = false, SAVE = EPI == EPI_GELU_SAVE;
  struct Rows {};
  struct Cols {
    float2 b, l;
  };
  __device__ static Rows rows(const Args&, int, int, int, int, int) { return {}; }
  __device__ static Cols cols(const Args& ep, int c, int N) {
    Cols k{ld_pair(ep.bias, c, N), make_float2(1.f, 1.f)};
    if (EPI == EPI_RESIDUAL && ep.ls != nullptr) k.l = ld_pair(ep.ls, c, N);
    return k;
  }
  __device__ static float2 apply(const Args&, float2 v, const Cols& k, const Rows&) {
    v.x += k.b.x;
    v.y += k.b.y;
    if (EPI == EPI_GELU) {
      v.x = gelu_fast_epi(v.x);
      v.y = gelu_fast_epi(v.y);
    } else if (EPI == EPI_RESIDUAL) {
      v.x *= k.l.x;
      v.y *= k.l.y;
    }
    return v;
  }
  __device__ static float2 add_res(float2 x, float2 v) { return make_float2(x.x + v.x, x.y + v.y); }
  // EPI_GELU_SAVE's second output: the GELU of h = apply's value rounded
  __device__ static float2 second(float2 h) {
    return make_float2(gelu_fast_torch(__bfloat162float(__float2bfloat16_rn(h.x))),
                       gelu_fast_torch(__bfloat162float(__float2bfloat16_rn(h.y))));
  }
};

template <class Epi>
__global__ void __launch_bounds__(G9_THREADS, 1)
    gemm_sm90_kernel(const __grid_constant__ CUtensorMap amap,
                     const __grid_constant__ CUtensorMap wmap,
                     const __grid_constant__ CUtensorMap omap,
                     const __grid_constant__ CUtensorMap rmap, int M, int N, int K,
                     const typename Epi::Args ep) {
  constexpr int BN = Epi::BN;
  using ARaw = typename Epi::ARaw;
  constexpr int ASZ = (int)(sizeof(ARaw) / sizeof(typename Epi::In));  // A's boxes a stage
  using T = G9Tile<BN, ASZ>;
  using Acc = typename Epi::Acc;
  using Out = typename Epi::Out;
  constexpr int KB = G9_BKB / (int)sizeof(typename Epi::In);  // k elements of a stage
  constexpr int CB = 16 / (int)sizeof(Out);  // 8-column blocks of an output chunk
  constexpr int CHUNKS = BN / (8 * CB);
  constexpr int PARTS = Epi::SAVE ? 2 : 1;  // outputs a chunk: EPI_GELU_SAVE's h and GELU
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_aligned(smem_raw);
  uint8_t* outbuf = sm + T::STAGES * T::STAGE;  // consumer c's chunk buffers: 2c, 2c + 1
  uint64_t* full = reinterpret_cast<uint64_t*>(outbuf + 4 * G9_OUT);
  uint64_t* empty = full + T::STAGES;
  uint64_t* resbar = empty + T::STAGES;  // chunk buffer 2c + b holds its residual chunk
  const bool has_res = Epi::RESIDUAL && ep.res != nullptr;
  const bool gathered = has_res && ep.res_idx != nullptr;  // residual rows through res_idx
  const int tiles_n = (N + BN - 1) / BN, tiles = (M + G9_BM - 1) / G9_BM * tiles_n;
  const int KT = K / KB;
  int GS = KT;  // k-steps of a flushed group
  if constexpr (Epi::GROUPED) GS = ep.group_k / KB;
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
#pragma unroll
          for (int j = 0; j < ASZ; ++j)  // A's boxes: k [kt·KB, (kt + 1)·KB) of ARaw
            tma_load_tile(stage + j * G9_BM * G9_BKB, &amap, &full[s],
                          (kt * ASZ + j) * (G9_BKB / (int)sizeof(ARaw)), m0, 0);
          tma_load_tile(stage + T::A_BYTES, &wmap, &full[s], kt * KB, n0, 0);
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
  Acc acc[T::ACC];
  float accf[Epi::GROUPED ? T::ACC : 1];
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
    const int rb = m0 + cw * 64 + r0;  // this thread's rows rb, rb + 8
    // per-row values first, while no accumulator is live
    typename Epi::Rows rw[2] = {Epi::rows(ep, rb, M, N, n0, t4),
                                Epi::rows(ep, rb + 8, M, N, n0, t4)};
    float ga[2] = {1.f, 1.f};  // a grouped product: its group's row scales
    int prev = 0;  // the stage of the k-step before
#pragma unroll
    for (int i = 0; i < T::ACC; ++i) acc[i] = 0;
    if constexpr (Epi::GROUPED) {
#pragma unroll
      for (int i = 0; i < T::ACC; ++i) accf[i] = 0.f;
    }
    for (int kt = 0; kt < KT; ++kt) {
      mbar_wait(&full[s], round & 1);
      const uint8_t* stage = sm + s * T::STAGE;
      const uint64_t db = desc_k(stage + T::A_BYTES);
      const int kg = Epi::GROUPED ? kt % GS : kt;  // 0: a group's sums start anew
      if constexpr (Epi::QUANT_A) {
        // k32 step by step, the products from registers: one 4-register
        // fragment, retired before the next is made (the other consumer's
        // products run meanwhile); the stage is free once its last step
        // has retired. Making step kk + 1's fragment under step kk's
        // products (8 fragment registers) spilled 28-36 bytes at BN = 256
        // and read no faster (chip_smoke's tail phase, H100).
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t f[4];
          quant_frag<ARaw>(f, stage, cw * 64 + r0, 32 * kk + 4 * t4, rw[0].mul, rw[1].mul);
          keep_acc(acc);
          wg_fence();
          wgmma_step_rs(acc, f, db + 2 * kk, kg | kk);
          wg_commit();
          wg_wait0();
          keep_acc(acc);
          keep_frag(f);
        }
        if (leader) mbar_arrive(&empty[s]);
      } else {
        const uint64_t da = desc_k(stage + cw * 64 * 128);
        keep_acc(acc);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_step(acc, da + 2 * kk, db + 2 * kk, kg | kk);
        wg_commit();
      }
      if constexpr (Epi::GROUPED) {
        if (kg == 0) {  // the group's row scales, read under its products
          const int groups = K / ep.group_k, grp = kt / GS;
          ga[0] = Epi::group_scale(ep, rb, M, groups, grp);
          ga[1] = Epi::group_scale(ep, rb + 8, M, groups, grp);
        }
      }
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
            if (CHUNKS > 1) gather_res(1, n0);
          }
        } else if (leader) {
          bulk_wait_read<0>();
          load_res(0, m0, n0);
          if (CHUNKS > 1) load_res(1, m0, n0);
        }
      }
      if constexpr (!Epi::QUANT_A) {
        if (Epi::GROUPED && kg == GS - 1) {
          // the group's last products: flush its exact sums to fp32
          wg_wait0();
          keep_acc(acc);
          if constexpr (Epi::GROUPED) Epi::flush(ep, accf, acc, ga);
        } else {
          wg_wait1();  // the k-step before has retired: its stage is free
          keep_acc(acc);
        }
        if (kt > 0 && leader) mbar_arrive(&empty[prev]);
        prev = s;
      }
      if (++s == T::STAGES) {
        s = 0;
        ++round;
      }
    }
    wg_wait0();
    keep_acc(acc);
    if (!Epi::QUANT_A && leader) mbar_arrive(&empty[prev]);

    if constexpr (Epi::QUANT_A) {  // the row scales, not held through the mainloop
      Epi::dequant_rows(ep, rw[0], rb, M);
      Epi::dequant_rows(ep, rw[1], rb + 8, M);
    }
    {
      // epilogue, chunk by chunk (8·CB columns: acc[4·CB·q ..]): the fp32
      // epilogue from the accumulators, rounded into a swizzled chunk
      // buffer in shared memory (two a consumer, alternating), stored by
      // TMA, which writes only the rows < M and columns < N; with ROW_MAX,
      // each row's |output| maximum over the tile too; with SAVE, PARTS = 2
      // turns u a chunk (h to the aux map, then its GELU to out)
      float mx[2] = {0.f, 0.f};
#pragma unroll
      for (int u = 0; u < CHUNKS * PARTS; ++u) {
        const int q = u / PARTS;  // the chunk; u == q but with SAVE
        const bool gelu_turn = Epi::SAVE && (u & 1);
        uint8_t* buf = outbuf + (2 * cw + (u & 1)) * G9_OUT;
        if (has_res) {  // buf holds the chunk's residual
          mbar_wait(&resbar[2 * cw + (q & 1)], (rphase >> (q & 1)) & 1);
          rphase ^= 1u << (q & 1);
        } else {
          if (leader) bulk_wait_read<1>();  // the store two chunks back has read buf
          named_sync(1 + cw, 128);
        }
#pragma unroll
        for (int jj = 0; jj < CB; ++jj) {
          const int j = CB * q + jj;
          const auto k = Epi::cols(ep, n0 + 8 * j + 2 * t4, N);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float2 v = Epi::apply(ep, acc_pair<Epi::GROUPED>(acc, accf, 4 * j + 2 * h), k, rw[h]);
            if constexpr (Epi::SAVE) {
              if (gelu_turn) v = Epi::second(v);
            }
            if constexpr (Epi::ROW_MAX) mx[h] = fmaxf(mx[h], fmaxf(fabsf(v.x), fabsf(v.y)));
            const int byte = (8 * jj + 2 * t4) * (int)sizeof(Out);
            uint8_t* o = buf + sw128(r0 + 8 * h, byte >> 4) + (byte & 15);
            if constexpr (Epi::RESIDUAL) {
              if (has_res) {  // the residual in place: the same swizzled position
                v = Epi::add_res(
                    __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(o)), v);
              }
            }
            store2<Out>(o, v);
          }
        }
        fence_proxy_async();
        named_sync(1 + cw, 128);
        if (leader) {
          // SAVE's h goes to the aux map, in the residual's slot
          tma_store_tile(Epi::SAVE && !gelu_turn ? &rmap : &omap, buf, n0 + 8 * CB * q,
                         m0 + cw * 64, 0);
          bulk_commit();
          if (has_res && !gathered && q + 2 < CHUNKS) {  // chunk q + 2's residual once buf is read
            bulk_wait_read<0>();
            load_res(q + 2, m0, n0);
          }
        }
        if (gathered && cwarp == 0 && q + 2 < CHUNKS) {  // the same, gathered
          if (lane == 0) bulk_wait_read<0>();
          __syncwarp();
          gather_res(q + 2, n0);
        }
      }
      if constexpr (Epi::ROW_MAX) {  // reduced over the four threads of each row
        Epi::row_max(ep, rb, M, N, n0, quad_max(mx[0]), t4);
        Epi::row_max(ep, rb + 8, M, N, n0, quad_max(mx[1]), t4);
      }
    }
  }
  if (leader) bulk_wait_all();
}

template <class Epi>
inline cudaError_t launch_gemm_g9(const CUtensorMap& amap, const CUtensorMap& wmap,
                                  const CUtensorMap& omap, const CUtensorMap& rmap, int M, int N,
                                  int K, const typename Epi::Args& ep, cudaStream_t st) {
  auto kernel = gemm_sm90_kernel<Epi>;
  constexpr int SMEM =
      G9Tile<Epi::BN, sizeof(typename Epi::ARaw) / sizeof(typename Epi::In)>::SMEM;
  static int done[KERNEL_CACHE_DEVICES] = {};  // one per instantiation
  int sms = 0;
  const cudaError_t e = ready_kernel(kernel, SMEM, done, &sms);
  if (e != cudaSuccess) return e;
  const int tiles = (M + G9_BM - 1) / G9_BM * ((N + Epi::BN - 1) / Epi::BN);
  kernel<<<min(tiles, sms), G9_THREADS, SMEM, st>>>(amap, wmap, omap, rmap, M, N, K, ep);
  return cudaGetLastError();
}

// Operands the kernel takes: M >= 1, K a positive multiple of kb (the k
// elements of a stage), 16-byte aligned A, W, out and res; with res_idx, the
// residual's res, rows_out >= 1 dividing M and rows_in >= 1 (the caller keeps
// each res_idx[r] in [0, rows_in)).
inline cudaError_t check_gemm_g9(const void* A, const void* W, const void* out, int M, int K,
                                 int kb, const bf16* res, const int* res_idx, int rows_out,
                                 int rows_in) {
  if (M < 1 || K < kb || K % kb) return cudaErrorInvalidValue;
  if (res_idx != nullptr && (res == nullptr || rows_out < 1 || rows_in < 1 || M % rows_out))
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(A) | reinterpret_cast<uintptr_t>(W) |
       reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(res)) & 15)
    return cudaErrorMisalignedAddress;
  return cudaSuccess;
}

// The tensor maps of a launch: A [M, K] of TA and W [N, K] of TW (box rows
// 128 and BN), out [M, N] of Out (box rows 64; none when out is null), and a
// contiguous residual res [M, N] of bf16 (none when it is gathered).
template <typename TA, typename TW, typename Out>
inline cudaError_t make_gemm_maps(CUtensorMap (&maps)[4], const TA* A, const TW* W, const Out* out,
                                  const bf16* res, bool gathered, int M, int N, int K, int BN) {
  cudaError_t e = make_tile_map(&maps[0], A, K, M, 1, G9_BM, tile_map_type<TA>());
  if (e == cudaSuccess) e = make_tile_map(&maps[1], W, K, N, 1, BN, tile_map_type<TW>());
  if (e == cudaSuccess && out != nullptr)
    e = make_tile_map(&maps[2], out, N, M, 1, 64, tile_map_type<Out>());
  if (e == cudaSuccess && res != nullptr && !gathered)
    e = make_tile_map(&maps[3], res, N, M, 1, 64);  // gathered rows come by cp.async
  return e;
}

// out[M, N] = epilogue(A[M, K] · W[N, K]ᵀ), bf16, on the stream. Takes
// check_gemm_g9's operands with K % 64 == 0 and N % 8 == 0; with res_idx,
// EPI_RESIDUAL; EPI_GELU_SAVE with a 16-byte aligned ep.aux [M, N]. Anything
// else, a tensor map that does not encode, or a launch that fails returns
// its error.
template <int EPI>
inline cudaError_t launch_gemm_sm90(const bf16* A, const bf16* W, bf16* out, int M, int N, int K,
                                    const EpilogueArgs& ep, cudaStream_t st) {
  static_assert(EPI == EPI_BIAS || EPI == EPI_GELU || EPI == EPI_RESIDUAL || EPI == EPI_GELU_SAVE,
                "an epilogue of common.cuh:Epilogue");
  if (N < 8 || N % 8 || (ep.res_idx != nullptr && EPI != EPI_RESIDUAL) ||
      (EPI == EPI_GELU_SAVE && ep.aux == nullptr))
    return cudaErrorInvalidValue;
  if (EPI == EPI_GELU_SAVE && (reinterpret_cast<uintptr_t>(ep.aux) & 15))
    return cudaErrorMisalignedAddress;
  const bf16* res = EPI == EPI_RESIDUAL ? ep.res : nullptr;
  cudaError_t e = check_gemm_g9(A, W, out, M, K, G9_BKB / 2, res, ep.res_idx, ep.rows_out,
                                ep.rows_in);
  if (e != cudaSuccess) return e;
  const bool wide = N % 256 == 0;
  CUtensorMap maps[4] = {};
  e = make_gemm_maps(maps, A, W, out, res, ep.res_idx != nullptr, M, N, K, wide ? 256 : 128);
  if (e == cudaSuccess && EPI == EPI_GELU_SAVE)
    e = make_tile_map(&maps[3], ep.aux, N, M, 1, 64);  // h, stored as out is
  if (e != cudaSuccess) return e;
  return wide ? launch_gemm_g9<Bf16Epi<EPI, 256>>(maps[0], maps[1], maps[2], maps[3], M, N, K,
                                                  ep, st)
              : launch_gemm_g9<Bf16Epi<EPI, 128>>(maps[0], maps[1], maps[2], maps[3], M, N, K,
                                                  ep, st);
}

}  // namespace
}  // namespace rajni
