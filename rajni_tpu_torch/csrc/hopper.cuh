// Hopper (sm_90a) building blocks of the attention kernels B6 (sdpa.cu, the
// long-sequence attention of every path past ATTN_MAX_N tokens), the
// short-row attention (short_attn.cu, every path's up to ATTN_MAX_N) and B18
// (sdpa_bwd.cu), and of the bf16 and int8 GEMM (gemm_sm90.cuh, whose TMA
// boxes are 128 bytes x 128 and 128 bytes x 256): mbarriers; loads of 64x64 bf16 tiles
// (64 tokens of one head's 64 columns) into shared memory in the 128-byte
// swizzle, by TMA where the tokens are contiguous rows and by cp.async where
// they come through an index; wgmma descriptors; and the two m64n64k16
// products the attention kernels use:
//   * wgmma_ss: D (+)= A·Bᵀ with A and B both tiles [token][dim] in shared
//     memory, the reduction over the 64 head dims (q·kᵀ, dO·vᵀ, k·qᵀ, v·dOᵀ);
//   * wgmma_rs_t: D += P·Z with P bf16 in registers (the A-fragment layout,
//     which is the accumulator layout of a product before it, so a softmax
//     row never leaves the registers) and Z a tile [token][dim] read
//     transposed by the tensor cores (the MN-major descriptor), the reduction
//     over tokens (p·v, dsb·k, pbᵀ·dO, dsbᵀ·q). No tile is transposed by
//     scalar stores.
// Accumulator layout of m64n64 (128 threads, 32 fp32 each): warp w of the
// warpgroup holds rows 16w + g and 16w + g + 8 (g = lane / 4); element e is
// row + 8·((e >> 1) & 1), column 8·(e >> 2) + 2·(lane % 4) + (e & 1); m64n16
// is the same with 8 elements (columns 0-15).
//
// Head_dim 80 (ViT-H/14): a 64-token tile of a head's 80 columns is the
// 64-column tile above (dims 0-63, 8 KB, 128-byte swizzle) and a 16-column
// part (dims 64-79, 2 KB: rows of 32 bytes in the 32-byte swizzle, TMA's
// CU_TENSOR_MAP_SWIZZLE_32B), since a 128-byte-swizzled operand is built of
// 64-element atoms and a 160-byte row fits no swizzle span. q·kᵀ takes a
// fifth k16 step on the 16-column parts (K-major, one descriptor of the
// 32-byte layout), P·V an m64n16k16 product beside the m64n64k16 one (V's
// part read MN-major). Padding the head to 128 columns would cost 1.6x the
// bytes and products.
#pragma once

#include <cuda.h>  // CUtensorMap (the encoder is reached through the runtime)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace rajni {
namespace {

constexpr int TILE = 64;                     // tokens a tile (and head_dim)
constexpr int TILE_BYTES = TILE * TILE * 2;  // 8 KB, 1024-byte aligned in shared memory
constexpr int XCOLS = 16;                    // head_dim 80: the columns past the 64-column tile
constexpr int XTILE_BYTES = TILE * XCOLS * 2;  // 2 KB, 256-byte aligned in shared memory

// The 16-column parts a 64-token tile has at head_dim D (64 or 80).
template <int D>
__host__ __device__ constexpr int xparts() {
  static_assert(D == 64 || D == 80, "the attention kernels take head_dim 64 and 80");
  return D == 80 ? 1 : 0;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Dynamic shared memory rounded up to the 1024 bytes the 128-byte swizzle
// repeats over (the launch asks for 1 KB more than it uses).
__device__ __forceinline__ uint8_t* smem_aligned(uint8_t* raw) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                    ~static_cast<uintptr_t>(1023));
}

// ---------------------------------------------------------------------------
// mbarriers and named barriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// Wait until the phase of parity `parity` has completed. The loop is in one
// asm block, so the compiler sees no divergent branch before the wgmma that
// follows (which would make it serialize them). A wait that lasts past 2^26
// polls (seconds) traps: a lost arrival fails the launch with an error
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\n.reg .pred P2;\n.reg .u32 c;\nmov.u32 c, 0;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nadd.u32 c, c, 1;\nsetp.eq.u32 P2, c, 67108864;\n@P2 trap;\n"
      "bra LAB_WAIT;\nDONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// The warpgroup of this thread, warp-uniform in the compiler's eyes (the
// shuffle): role branches on it keep the wgmma paths convergent.
__device__ __forceinline__ int warpgroup_id() {
  return __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
}
// Barrier `id` (1..15) over the `threads` consumer threads only.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Register budget of a warp-specialized block of three warpgroups (384
// threads, 168 registers a thread at launch): the producer warpgroup gives
// back all but 40, the two consumer warpgroups take 232.
__device__ __forceinline__ void regs_producer() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
}
__device__ __forceinline__ void regs_consumer() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
}
// Other splits of the same block, (168 − P)·128 >= (Q − 168)·256: the
// producer warpgroup gives back all but P, the consumers take Q.
template <int P>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(P) : "memory");
}
template <int Q>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(Q) : "memory");
}

// ---------------------------------------------------------------------------
// Tile loads
// ---------------------------------------------------------------------------

// Byte offset of 16-byte chunk `ch` (0..7) of row `r` in a 64x64 bf16 tile in
// the 128-byte swizzle (the layout TMA's CU_TENSOR_MAP_SWIZZLE_128B writes).
__device__ __forceinline__ uint32_t sw128(int r, int ch) {
  return static_cast<uint32_t>(r * 128 + ((ch ^ (r & 7)) << 4));
}

// Byte offset of 16-byte chunk `ch` (0..1) of row `r` in a 64x16 bf16 part in
// the 32-byte swizzle (CU_TENSOR_MAP_SWIZZLE_32B: address bit 4 ^= bit 7).
__device__ __forceinline__ uint32_t sw32(int r, int ch) {
  return static_cast<uint32_t>(r * 32 + ((ch ^ ((r >> 2) & 1)) << 4));
}

// TMA: box {64 columns, 64 rows, 1} of a 3-D tensor map at (c0, c1, c2),
// completing on `bar` (whose expected bytes the caller has set).
__device__ __forceinline__ void tma_load_tile(void* dst, const CUtensorMap* map, uint64_t* bar,
                                              int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// cp.async by one warp: tokens t0..t0+63 of the columns [col, col + 64) of
// rows idx[t] of `src` (row stride `ld` elements), zero for t >= n. Not
// complete until cp_async_wait and the proxy fence below.
__device__ __forceinline__ void gather_tile(uint8_t* dst, const bf16* src, const int* idx,
                                            size_t ld, int col, int t0, int n, int lane) {
#pragma unroll 4
  for (int i = 0; i < 16; ++i) {
    const int c = lane + 32 * i, r = c >> 3, ch = c & 7, t = t0 + r;
    const bool valid = t < n;
    const bf16* g = src + (valid ? (size_t)idx[t] * ld + col + ch * 8 : 0);
    cp_async16(dst + sw128(r, ch), g, valid);
  }
  cp_async_commit();
}

// The same for the 16 columns [col, col + 16) into a 32-byte-swizzled part
// (head_dim 80); committed with the tile's own group (no commit here).
__device__ __forceinline__ void gather_xpart(uint8_t* dst, const bf16* src, const int* idx,
                                             size_t ld, int col, int t0, int n, int lane) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = lane + 32 * i, r = c >> 1, ch = c & 1, t = t0 + r;
    const bool valid = t < n;
    const bf16* g = src + (valid ? (size_t)idx[t] * ld + col + ch * 8 : 0);
    cp_async16(dst + sw32(r, ch), g, valid);
  }
}

// Make this thread's completed generic-proxy writes to shared memory (cp.async)
// visible to the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The phased form of the TPU kernels' _mha (rajni_tpu/kernels/block.py:136):
// q·scale in fp32, rounded to bf16, before q·kᵀ. Thread tid of nthreads
// rescales its 16-byte pieces of a Q tile (or part) of `bytes` in shared
// memory in place (elementwise, so the swizzle does not matter) and fences
// them for wgmma; the caller then passes a barrier of those threads before
// any of them issues a product on the tile.
__device__ __forceinline__ void scale_q_tile(uint8_t* tile, int bytes, float scale, int tid,
                                             int nthreads) {
  for (int o = tid * 16; o < bytes; o += nthreads * 16) {
    uint4 v = *reinterpret_cast<const uint4*>(tile + o);
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      h[i] = __floats2bfloat162_rn(__fmul_rn(f.x, scale), __fmul_rn(f.y, scale));
    }
    *reinterpret_cast<uint4*>(tile + o) = v;
  }
  fence_proxy_async();
}

// TMA store: the box of a 3-D tensor map at (c0, c1, c2) from shared memory
// (written by this block's threads, each of which has run fence_proxy_async
// before a barrier the issuing thread passed), in this thread's bulk group.
// Elements past the tensor's edges are not written.
__device__ __forceinline__ void tma_store_tile(const CUtensorMap* map, const void* src, int c0,
                                               int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Until at most N of this thread's bulk groups still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// Until this thread's bulk groups are complete (their writes done).
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Host: a tensor map over [batch][rows][inner] (row-major) of bf16 (or of
// `type`: UINT8 for int8, FLOAT32), box 128 bytes x box_rows x 1 (64 bf16,
// 128 int8 or 32 fp32 columns; box_rows <= 256), 128-byte swizzle, zero
// fill past every edge; with box_bytes 32, a box 32 bytes wide (16 bf16
// columns) in the 32-byte swizzle (head_dim 80's 16-column parts).
inline cudaError_t make_tile_map(CUtensorMap* map, const void* base, int inner, int rows,
                                 int batch, int box_rows = TILE,
                                 CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                                 int box_bytes = 128) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  // looked up once: a function-local static's initializer runs once even
  // when threads meet here on their first launches (C++11)
  static const Encode encode = []() -> Encode {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    return reinterpret_cast<Encode>(fn);
  }();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t esize = type == CU_TENSOR_MAP_DATA_TYPE_UINT8     ? 1
                           : type == CU_TENSOR_MAP_DATA_TYPE_FLOAT32 ? 4
                                                                     : 2;
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)rows, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)inner * esize, (cuuint64_t)rows * inner * esize};
  const cuuint32_t box[3] = {(cuuint32_t)(box_bytes / esize), (cuuint32_t)box_rows, 1},
                   estr[3] = {1, 1, 1};
  const CUresult r = encode(map, type, 3, const_cast<void*>(base),
                            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            box_bytes == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                                            : CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Host: raise a kernel's dynamic shared memory limit to smem and read the
// current device's SM count into *sms, once per device: `done` is the
// kernel's own function-local static, the SM count of each device it was
// readied on (0 before). A launch after the first costs one cudaGetDevice.
// Threads whose first launches meet may both ready the kernel (the same
// attribute, the same count): `done` is read and written atomically.
constexpr int KERNEL_CACHE_DEVICES = 16;
template <typename Kernel>
inline cudaError_t ready_kernel(Kernel kernel, int smem, int (&done)[KERNEL_CACHE_DEVICES],
                                int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const bool cached = dev < KERNEL_CACHE_DEVICES;
  const int known = cached ? __atomic_load_n(&done[dev], __ATOMIC_ACQUIRE) : 0;
  if (known > 0) {
    *sms = known;
    return cudaSuccess;
  }
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && cached) __atomic_store_n(&done[dev], *sms, __ATOMIC_RELEASE);
  return e;
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptor of a 1024-byte aligned tile in the 128-byte
// swizzle; strides in 16-byte units.
__device__ __forceinline__ uint64_t desc_sw128(const void* tile, uint32_t lbo, uint32_t sbo) {
  const uint64_t a = smem_u32(tile);
  return ((a & 0x3FFFF) >> 4) | ((uint64_t)lbo << 16) | ((uint64_t)sbo << 32) | (1ull << 62);
}
// K-major (reduction along a 128-byte row, 8-row groups 1024 bytes apart);
// k-step kk of 16 elements: + 2·kk.
__device__ __forceinline__ uint64_t desc_k(const void* tile) { return desc_sw128(tile, 1, 64); }
// MN-major (reduction down the rows; the 64 columns are one swizzle span, so
// the MN stride is unused and set like the 1024-byte K-group stride); k-step
// kk of 16 rows: + 128·kk.
__device__ __forceinline__ uint64_t desc_mn(const void* tile) { return desc_sw128(tile, 64, 64); }
// A 64x16 part in the 32-byte swizzle (layout type 3), 8-row groups 256 bytes
// apart. K-major: a row is one k16 step (q·kᵀ's fifth at head_dim 80).
// MN-major: the 16 columns are one swizzle span (the MN stride unused);
// k-step kk of 16 rows: + 32·kk.
__device__ __forceinline__ uint64_t desc_x(const void* part) {
  const uint64_t a = smem_u32(part);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | (16ull << 32) | (3ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}
// Wait until at most `n` groups are pending; n a compile-time constant after
// unrolling, 0..7.
__device__ __forceinline__ void wg_wait_pending(int n) {
  switch (n) {
    case 0: asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); break;
    case 1: asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory"); break;
    case 2: asm volatile("wgmma.wait_group.sync.aligned 2;\n" ::: "memory"); break;
    case 3: asm volatile("wgmma.wait_group.sync.aligned 3;\n" ::: "memory"); break;
    case 4: asm volatile("wgmma.wait_group.sync.aligned 4;\n" ::: "memory"); break;
    case 5: asm volatile("wgmma.wait_group.sync.aligned 5;\n" ::: "memory"); break;
    case 6: asm volatile("wgmma.wait_group.sync.aligned 6;\n" ::: "memory"); break;
    default: asm volatile("wgmma.wait_group.sync.aligned 7;\n" ::: "memory"); break;
  }
}

// Pin registers a wgmma reads or writes asynchronously: before wg_fence, so
// that the accumulators count as defined before the products start (else
// ptxas serializes them), and after the wait, so that nothing reads an
// accumulator early or reuses an A fragment's register while the product may
// still read it.
template <int NE>
__device__ __forceinline__ void keep(float (&d)[NE]) {
#pragma unroll
  for (int i = 0; i < NE; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// A fragments are only read by the product: pinned by a use, not a
// redefinition (which ptxas would count as a write inside the wgmma stage).
__device__ __forceinline__ void keep(const uint32_t (&a)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" ::"r"(a[i]) : "memory");
}

#define RJ_ACC32(d)                                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),         \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),           \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define RJ_D32                                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "   \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// D = A·B (+ D when acc != 0), A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " RJ_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : RJ_ACC32(d)
      : "l"(da), "l"(db), "r"(acc));
}

// D += A·B, A bf16 fragments in registers, B from shared memory MN-major.
__device__ __forceinline__ void wgmma_rs_t(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2,
                                           uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " RJ_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : RJ_ACC32(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// D = A·B (+ D when acc != 0) with N = 128: B is two adjacent 64-row tiles, D
// their two 64x64 accumulators side by side (d0 columns 0-63, d1 64-127).
__device__ __forceinline__ void wgmma_ss_n128(float (&d0)[32], float (&d1)[32], uint64_t da,
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, "
      "%37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, "
      "%55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : RJ_ACC32(d0), RJ_ACC32(d1)
      : "l"(da), "l"(db), "r"(acc));
}

// D += A·B with N = 16 (head_dim 80's last 16 columns of P·V), A bf16
// fragments in registers, B from shared memory MN-major.
__device__ __forceinline__ void wgmma_rs_t_n16(float (&d)[8], uint32_t a0, uint32_t a1,
                                               uint32_t a2, uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

#undef RJ_ACC32
#undef RJ_D32

// d = a·bᵀ over the 64 head dims, a and b tiles [token][dim] (not committed).
__device__ __forceinline__ void mma_abt(float (&d)[32], const void* a, const void* b) {
  const uint64_t da = desc_k(a), db = desc_k(b);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_ss(d, da + 2 * kk, db + 2 * kk, kk);
}

// d0 | d1 = a·bᵀ over the 64 head dims, b two adjacent tiles (128 tokens):
// one m64n128k16 product a step reads a once for twice the columns.
__device__ __forceinline__ void mma_abt2(float (&d0)[32], float (&d1)[32], const void* a,
                                         const void* b) {
  const uint64_t da = desc_k(a), db = desc_k(b);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_ss_n128(d0, d1, da + 2 * kk, db + 2 * kk, kk);
}

// d += the fifth k16 step of a·bᵀ at head_dim 80 (dims 64-79), a and b the
// 16-column parts (b two adjacent parts for d0 | d1) (not committed).
__device__ __forceinline__ void mma_abt_x(float (&d)[32], const void* ax, const void* bx) {
  wgmma_ss(d, desc_x(ax), desc_x(bx), 1);
}
__device__ __forceinline__ void mma_abt2_x(float (&d0)[32], float (&d1)[32], const void* ax,
                                           const void* bx) {
  wgmma_ss_n128(d0, d1, desc_x(ax), desc_x(bx), 1);
}

// d += p·z over the 64 tokens of tile z [token][dim]; p the bf16 A fragments
// of a 64x64 accumulator (to_frag) (not committed).
__device__ __forceinline__ void mma_pz(float (&d)[32], const uint32_t (&p)[16], const void* z) {
  const uint64_t dz = desc_mn(z);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs_t(d, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3], dz + 128 * kk);
}
// The same over a 16-column part zx (head_dim 80's dims 64-79).
__device__ __forceinline__ void mma_pz_x(float (&d)[8], const uint32_t (&p)[16], const void* zx) {
  const uint64_t dz = desc_x(zx);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs_t_n16(d, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3], dz + 32 * kk);
}

// A fragments of the k16 steps of a 64x64 fp32 accumulator, rounded to bf16:
// step kk takes column blocks 2kk and 2kk + 1, which are elements 8kk..8kk+7,
// so fragment register m packs elements 2m and 2m + 1.
__device__ __forceinline__ void to_frag(uint32_t (&p)[16], const float (&d)[32]) {
#pragma unroll
  for (int m = 0; m < 16; ++m) p[m] = pack_bf16x2(d[2 * m], d[2 * m + 1]);
}

// Column (0..63) of accumulator element e; its row is r0 + acc_row8(e).
__device__ __forceinline__ int acc_col(int e, int t4) { return 8 * (e >> 2) + 2 * t4 + (e & 1); }
__device__ __forceinline__ int acc_row8(int e) { return (e & 2) ? 8 : 0; }

// The int8 tails' row absmax: this thread's |stored value| maxima over the
// accumulator d (a 64-column tile, or head_dim 80's 16-column part), row r0
// into ma and r0 + 8 into mb.
template <typename OutT, int NE>
__device__ __forceinline__ void acc_absmax(float& ma, float& mb, const float (&d)[NE]) {
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    float& m = acc_row8(e) ? mb : ma;
    m = fmaxf(m, fabsf(stored<OutT>(d[e])));
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Softmax in the log2 domain. A row's logits are l = s·scale, s the raw fp32
// q·k sum; with sl2 = scale·log2(e) and the row offset c = max(s)·sl2,
// exp(l − max l) = 2^(s·sl2 − c): one FFMA and one ex2 a logit (max(s·scale)
// is max(s)·scale exactly, scale > 0). Within a few ulp of expf(l − max l);
// P is still normalized by 1/Σ in fp32 before it is rounded.
constexpr float LOG2E = 1.4426950408889634f;
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float exp_row(float s, float sl2, float c) {
  return ex2(fmaf(s, sl2, -c));
}

// 1/x for a softmax row sum (>= 1): rcp.approx and one Newton step, within
// 1 ulp of the IEEE quotient. Not `1.0f / x`, whose slow path is a called
// subroutine: a call where a whole row of logits is live spills it.
__device__ __forceinline__ float row_recip(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return fmaf(r, fmaf(-x, r, 1.0f), r);
}

// Raw logits of a key tile whose tokens start at t0, -inf from token n on.
__device__ __forceinline__ void mask_tail(float (&s)[32], int t0, int n, int t4) {
#pragma unroll
  for (int e = 0; e < 32; ++e)
    if (t0 + acc_col(e, t4) >= n) s[e] = -INFINITY;
}

// (c, l) of two partial rows merged, c in the log2 domain:
// l = l1·2^(c1−c) + l2·2^(c2−c).
__device__ __forceinline__ void merge_row(float& c, float& l, float c2, float l2) {
  const float mx = fmaxf(c, c2);
  l = (l > 0.f ? l * ex2(c - mx) : 0.f) + (l2 > 0.f ? l2 * ex2(c2 - mx) : 0.f);
  c = mx;
}

// Online (c, Σ 2^(s·sl2 − c)) of one row over the raw logits of a tile whose
// row offset is `half` (0: rows r0, 8: rows r0 + 8); -inf logits add 0.
__device__ __forceinline__ void online_row(float& c, float& l, const float (&s)[32], int half,
                                           float sl2) {
  float t = -INFINITY;
#pragma unroll
  for (int e = 0; e < 32; ++e)
    if (acc_row8(e) == half) t = fmaxf(t, s[e]);
  t *= sl2;
  if (t > c) {
    l *= ex2(c - t);
    c = t;
  }
  if (c == -INFINITY) return;
#pragma unroll
  for (int e = 0; e < 32; ++e)
    if (acc_row8(e) == half) l += exp_row(s[e], sl2, c);
}

// A warpgroup's 64x64 (NE = 32) or 64x16 (NE = 8) fp32 accumulator stored to
// rows r0 / r0 + 8 (null: skip) of a [token][dim] output, from `a` / `b`.
template <typename OutT, int NE>
__device__ __forceinline__ void store_acc(OutT* a, OutT* b, const float (&d)[NE], int t4) {
#pragma unroll
  for (int e = 0; e < NE; e += 2) {
    OutT* p = acc_row8(e) ? b : a;
    if (p != nullptr) store_pair(p + acc_col(e, t4), d[e], d[e + 1]);
  }
}

}  // namespace
}  // namespace rajni
