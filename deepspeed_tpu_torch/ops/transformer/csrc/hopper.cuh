// Hopper (sm_90a) building blocks as inline PTX: mbarriers, TMA tile loads,
// wgmma shared-memory descriptors and the m64n64k16 bf16 and fp16 warpgroup
// products; and, on the host, the TMA tensor maps. Shared by flash_attention.cu and
// ../../sparse_attention/csrc/block_sparse_attention.cu.
//
// Tiles live in shared memory as 128-byte-swizzled panels: a panel holds 64
// 2-byte (bf16 or fp16) columns of every row of a tile, one 128-byte row per tile row, and
// starts at a 1024-byte-aligned address. TMA writes that layout
// (CU_TENSOR_MAP_SWIZZLE_128B with a 64-column box), and the same panel is
// read by wgmma either K-major (the 64 columns are the reduction axis) or
// MN-major (the rows are the reduction axis), through the descriptors below.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; nothing here links libcuda
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

constexpr int kPanelCols = 64;     // bf16 columns of one swizzled panel
constexpr int kRowBytes = 128;     // bytes of one panel row
constexpr int kGroupBytes = 1024;  // 8 panel rows: one swizzle period

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// one arrival that also expects `bytes` of TMA transactions in this phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// waits until the phase of parity `parity` has completed (the n-th
// completion of a barrier has parity n & 1)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------
// one box of a 3-D tensor map at coordinates (c0 innermost, c1, c2) into
// shared memory at `dst`; completes `bar`'s transaction count by the box's
// bytes (elements outside the tensor arrive as zeros)
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                            int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------
// Descriptor of a 128-byte-swizzled operand starting at shared address
// `addr` (16 bf16 of K for K-major, 16 rows of K for MN-major, 8 rows of M/N
// per 1024-byte group). Bits: start >> 4 at [0, 14), leading byte offset >> 4
// at [16, 30), stride byte offset >> 4 at [32, 46), swizzle mode 1 (128 B)
// at [62, 64). The stride byte offset, 1024, steps from one 8-row group to
// the next. For K-major operands the leading offset is not read. For
// MN-major operands of 64 columns (one panel) it is not read either under
// one reading of the ISA and is the 8-row step under the other; passing
// 1024 there is right under both.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo_bytes >> 4) << 16) |
         (static_cast<uint64_t>(kGroupBytes >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) { return desc_sw128(addr, 16); }
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr) { return desc_sw128(addr, kGroupBytes); }

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across the wait that ends it.
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

#define HOPPER_D32(d)                                                                                   \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),        \
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),          \
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),        \
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]),        \
      "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

#define HOPPER_D32_LIST                                                                                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, "   \
  "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d(64x64, fp32) (+)= A(64x16) . B(16x64), A and B bf16 (fp16 when kHalf) in
// shared memory, both K-major (B stored as its N rows of K values: the
// product is A . B^T of two row-major tiles). Accumulator layout (per thread
// t of the warpgroup, warp w = t / 32, lane l = t % 32): d[4j + 2h + e] is
// row 16w + l/4 + 8h, column 8j + 2(l%4) + e.
template <bool kHalf = false>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  if constexpr (kHalf) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " HOPPER_D32_LIST
        ", %32, %33, p, 1, 1, 0, 0;\n"
        "}\n"
        : HOPPER_D32(d)
        : "l"(desc_a), "l"(desc_b), "r"(accumulate));
  } else {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_D32_LIST
        ", %32, %33, p, 1, 1, 0, 0;\n"
        "}\n"
        : HOPPER_D32(d)
        : "l"(desc_a), "l"(desc_b), "r"(accumulate));
  }
}

// d(64x64, fp32) += A(64x16) . B(16x64), A bf16 (fp16 when kHalf) in
// registers, B of the same type in shared memory MN-major (stored as its K
// rows of N values: a row-major tile used as it is). a[0..3] hold, as pairs
// (low half first): (row l/4, columns 2(l%4) + {0,1}), (row l/4 + 8, same),
// (row l/4, 8 + 2(l%4) + {0,1}), (row l/4 + 8, same) of warp w's 16 rows: the
// accumulator layout above, so an fp32 accumulator converts pairwise into
// the A operand of the next product.
template <bool kHalf = false>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
  if constexpr (kHalf) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " HOPPER_D32_LIST
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
        "}\n"
        : HOPPER_D32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  } else {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_D32_LIST
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
        "}\n"
        : HOPPER_D32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  }
}

#undef HOPPER_D32
#undef HOPPER_D32_LIST

// 64-column panels of a tile at head_dim D (the last one zero-padded)
template <int D>
__host__ __device__ constexpr int tc_panels() {
  return (D + kPanelCols - 1) / kPanelCols;
}

// column of accumulator register i within its 64 columns, for the thread
// with c_off = 2 (lane % 4) (see wgmma_ss)
__device__ __forceinline__ int tc_col(int i, int c_off) { return 8 * (i >> 2) + c_off + (i & 1); }

// max and sum over the 4 lanes that hold one accumulator row
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

constexpr float kLog2e = 1.4426950408889634f;  // exp(x) = exp2(x log2(e))

// two fp32 values as one bf16 pair, round to nearest even; `lo` in the low
// half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// the same as one fp16 pair (fp16's ulp is 2^-11 of a value, bf16's 2^-8)
__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.f16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// ---------------------------------------------------------------------------
// TMA tensor maps (host)
// ---------------------------------------------------------------------------
// cuTensorMapEncodeTiled, reached through the runtime's driver entry point
// so that a library does not link libcuda itself
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault,
                                                       &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// A 3-D map over a (bh, rows, D) tensor of 2-byte elements (bf16, or
// `type` fp16) whose boxes are (1, box_rows,
// 64) in 128-byte-swizzled panels; out-of-range rows and columns read as
// zero. False when the map cannot be made (a pointer that is not 16-byte
// aligned, or a driver without cuTensorMapEncodeTiled).
template <int D>
bool make_tile_map(CUtensorMap* map, const void* ptr, int rows, int bh, int box_rows,
                   CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)rows * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kPanelCols, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = encode(map, type, 3, const_cast<void*>(ptr), dims, strides, box,
                            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS;
}

}  // namespace hopper
