// Hopper (sm_90a) building blocks shared by the warp-specialised kernels:
// TMA tensor maps and loads, mbarriers, register reallocation and wgmma (bf16,
// and tf32 with its rounding and three-product split), the shared-memory
// address and bf16 packing, the backward kernels' gradient rows and the ring
// step's carry in device memory.
//
// Operand tiles live in shared memory in the layout a 128-byte-swizzled TMA
// box writes: a panel of R rows x 64 bf16 (128 bytes a row, 16-byte chunk c
// of row r stored at chunk c ^ (r & 7)), so a 128-wide head row spans two
// panels. Panels start on 1024-byte boundaries, as the swizzle needs. wgmma
// reads such a panel through a descriptor with the 128-byte swizzle mode:
// K-major (the reduction runs along the row) with SBO = 1024 bytes (the next
// 8 rows) and the start address stepped 32 bytes per k16 step; MN-major (the
// reduction runs down the rows) with SBO = 1024 bytes (the next 8 rows of
// the reduction), LBO = the panel size (the next 64 columns) and the start
// stepped 2048 bytes per k16 step. A 16-column panel (32 bytes a row, the
// 32-byte swizzle: chunk c of row r at c ^ ((r >> 2) & 1)) is read the same
// way with the 32-byte mode and SBO = 256 bytes (8 rows): K-major one k16
// step is the whole row; MN-major the start steps 512 bytes per k16 step.
// (The PTX ISA's canonical layouts, in 16-byte units T: K-major
// ((8,m),(T,2k)):((2T|8T, SBO),(1,T)), MN-major ((T,2|8,m),(8,k)):
// ((1,T,LBO),(2T|8T,SBO)) for the 32- and 128-byte swizzles.)
//
// The host encodes one tensor map per operand and panel of the packed
// [B, L, N, D] layout as a 4-D map (D, N, L, B), so a box that runs past L,
// or past column D, is zero-filled by the hardware instead of reading the
// next batch row's tokens or the next head's columns. The grouped products
// (gmm.cu) map their rows and each bank of E matrices as 3-D maps, so that a
// box of one expert's matrix never reads the next one's.
// cuTensorMapEncodeTiled comes from the CUDA driver through the runtime's
// cudaGetDriverEntryPoint, so the library links without -lcuda.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---- device: addresses and packing ------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- host: tensor maps ------------------------------------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    return (err == cudaSuccess && status == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// A map over one packed operand [B, L, N, D] (bf16, or f32 where `dtype`
// says so), box = `rows` rows x `cols` columns of one head (128 bytes a row
// with the 128-byte swizzle, 32 with the 32-byte one), zero fill past L and
// past D. Returns false if the CUDA driver refuses it (alignment, sizes: a
// head row's bytes must be a multiple of 16).
bool encode_packed_map(CUtensorMap* map, const void* base, int B, int L, int N, int D, int rows,
                       int cols, CUtensorMapSwizzle swizzle,
                       CUtensorMapDataType dtype = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  const EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr || reinterpret_cast<uintptr_t>(base) % 16 != 0) return false;
  const cuuint64_t esize = dtype == CU_TENSOR_MAP_DATA_TYPE_FLOAT32 ? 4 : 2;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(L), static_cast<cuuint64_t>(B)};
  const cuuint64_t row_bytes = static_cast<cuuint64_t>(N) * D * esize;
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * esize, row_bytes,
                                 row_bytes * static_cast<cuuint64_t>(L)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols), 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, dtype, 4, const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the 128-byte-swizzled map of a 128-wide head (the backward kernels')
bool encode_packed_map(CUtensorMap* map, const void* base, int B, int L, int N, int rows) {
  return encode_packed_map(map, base, B, L, N, 128, rows, 64, CU_TENSOR_MAP_SWIZZLE_128B);
}

// the 128-byte-swizzled map of a 128-wide f32 head: a box is 32 columns
// (128 bytes), so a head row spans four panels
bool encode_packed_map_f32(CUtensorMap* map, const void* base, int B, int L, int N, int rows) {
  return encode_packed_map(map, base, B, L, N, 128, rows, 32, CU_TENSOR_MAP_SWIZZLE_128B,
                           CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
}

// A map over a bank of E row-major matrices [E, rows, cols] (bf16, or f32
// where `f32`) as a 3-D map (cols, rows, E), box = `box_rows` rows x 128
// bytes of columns (64 bf16 or 32 f32, the 128-byte swizzle) of one matrix:
// a box that runs past `rows` or `cols` is zero-filled instead of reading
// the next matrix. The row stride must be a multiple of 16 bytes.
bool encode_bank_map(CUtensorMap* map, const void* base, int E, int rows, int cols, int box_rows,
                     bool f32 = false) {
  const EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr || reinterpret_cast<uintptr_t>(base) % 16 != 0) return false;
  const cuuint64_t esize = f32 ? 4 : 2;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(E)};
  const cuuint64_t row_bytes = static_cast<cuuint64_t>(cols) * esize;
  const cuuint64_t strides[2] = {row_bytes, row_bytes * static_cast<cuuint64_t>(rows)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(128 / esize),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the same over one row-major matrix [rows, cols] (the grouped products'
// rows), as a bank of one
bool encode_rows_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows,
                     bool f32 = false) {
  return encode_bank_map(map, base, 1, rows, cols, box_rows, f32);
}

// ---- device: TMA and mbarriers ----------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// arrive and add `bytes` to the transaction count the phase waits for
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// spin until the phase with this parity has completed (no timeout: a trap
// on this path cost the consumer warpgroups ~50 registers of spills)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a packed map: columns d0..d0+63 of head h, rows row..row+rows-1
// of batch row b, into `dst` (1024-byte aligned); completes on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int d0,
                                         int h, int row, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(d0), "r"(h), "r"(row), "r"(b),
      "r"(smem_u32(bar))
      : "memory");
}

// one box of a bank map: the box's columns from c, rows from row, of matrix e
// (0 for a rows map)
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c,
                                            int row, int e) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(row), "r"(e), "r"(smem_u32(bar))
      : "memory");
}

// fetch a tensor map (a __grid_constant__ parameter) ahead of its first TMA
__device__ __forceinline__ void prefetch_tensormap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// one box of a bank map from shared memory (`src`, 1024-byte aligned, in the
// box's swizzled layout) to its columns from c, rows from row, of matrix e; the
// parts past the map's edges are not written. Completes in this thread's
// bulk group.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c,
                                             int row, int e) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c), "r"(row), "r"(e)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// this thread's bulk stores have read their shared memory (it may be rewritten)
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// this thread's bulk stores are complete
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ---- device: warpgroups ------------------------------------------------------

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_operands(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// shared-memory descriptor as two halves: the low word holds the start
// address and LBO, the high word SBO and the layout (1: 128-byte swizzle,
// 3: 32-byte swizzle). A k step adds (bytes >> 4) to the low word only.
constexpr uint32_t kSwizzle128 = 1, kSwizzle32 = 3;

__host__ __device__ constexpr uint32_t wgmma_desc_hi(uint32_t sbo, uint32_t layout = kSwizzle128) {
  return ((sbo >> 4) & 0x3FFF) | (layout << 30);
}

__device__ __forceinline__ uint32_t wgmma_desc_lo(uint32_t addr, uint32_t lbo) {
  return ((addr & 0x3FFFF) >> 4) | (((lbo >> 4) & 0x3FFF) << 16);
}

__device__ __forceinline__ uint64_t wgmma_desc(uint32_t lo, uint32_t hi) {
  return (static_cast<uint64_t>(hi) << 32) | lo;
}

// d (64 x 64, f32) = (scale_d ? d : 0) + A·B; A and B in shared memory, each K-major, or
// MN-major where its flag TA / TB is 1 (the transpose bits, for bf16 only)
template <int TA = 0, int TB = 0>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// d (64 x 256, f32) = (scale_d ? d : 0) + A·B; A and B in shared memory, each K-major, or
// MN-major where its flag TA / TB is 1 (the transpose bits, for bf16 only)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n256(float (&d)[128], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87,"
      " %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103,"
      " %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119,"
      " %120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
        "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// d (64 x 192, f32) = (scale_d ? d : 0) + A·B; A and B in shared memory, each K-major, or
// MN-major where its flag TA / TB is 1 (the transpose bits, for bf16 only)
template <int TA = 0, int TB = 0>
__device__ __forceinline__ void wgmma_ss_n192(float (&d)[96], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87,"
      " %88, %89, %90, %91, %92, %93, %94, %95},"
      " %96, %97, p, 1, 1, %99, %100;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
        "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// d (64 x 128, f32) = (scale_d ? d : 0) + A·B; A and B in shared memory, each K-major, or
// MN-major where its flag TA / TB is 1 (the transpose bits, for bf16 only)
template <int TA = 0, int TB = 0>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// d (64 x N, f32) = (scale_d ? d : 0) + A·B at N = 64, 128, 192 or 256 (the forms above)
template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int scale_d) {
  static_assert(N == 64 || N == 128 || N == 192 || N == 256, "no wgmma_ss form of this width");
  if constexpr (N == 64)
    wgmma_ss_n64<TA, TB>(d, da, db, scale_d);
  else if constexpr (N == 128)
    wgmma_ss_n128<TA, TB>(d, da, db, scale_d);
  else if constexpr (N == 192)
    wgmma_ss_n192<TA, TB>(d, da, db, scale_d);
  else
    wgmma_ss_n256<TA, TB>(d, da, db, scale_d);
}

// d (64 x 128, f32) += A·B; A (64 x 16 bf16) from registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n128_tb(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[O..O+31] (64 x 64, f32) += A·B; A (64 x 16 bf16) from registers, B MN-major in shared memory
template <int O, int NA>
__device__ __forceinline__ void wgmma_rs_n64_tb(float (&d)[NA], const uint32_t (&a)[4],
                                                uint64_t db) {
  static_assert(O + 32 <= NA, "accumulator slice out of range");
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[O + 0]), "+f"(d[O + 1]), "+f"(d[O + 2]), "+f"(d[O + 3]), "+f"(d[O + 4]),
        "+f"(d[O + 5]), "+f"(d[O + 6]), "+f"(d[O + 7]), "+f"(d[O + 8]), "+f"(d[O + 9]),
        "+f"(d[O + 10]), "+f"(d[O + 11]), "+f"(d[O + 12]), "+f"(d[O + 13]), "+f"(d[O + 14]),
        "+f"(d[O + 15]), "+f"(d[O + 16]), "+f"(d[O + 17]), "+f"(d[O + 18]), "+f"(d[O + 19]),
        "+f"(d[O + 20]), "+f"(d[O + 21]), "+f"(d[O + 22]), "+f"(d[O + 23]), "+f"(d[O + 24]),
        "+f"(d[O + 25]), "+f"(d[O + 26]), "+f"(d[O + 27]), "+f"(d[O + 28]), "+f"(d[O + 29]),
        "+f"(d[O + 30]), "+f"(d[O + 31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[O..O+7] (64 x 16, f32) += A·B; A (64 x 16 bf16) from registers, B MN-major in shared memory
template <int O, int NA>
__device__ __forceinline__ void wgmma_rs_n16_tb(float (&d)[NA], const uint32_t (&a)[4],
                                                uint64_t db) {
  static_assert(O + 8 <= NA, "accumulator slice out of range");
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7},"
      " {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[O + 0]), "+f"(d[O + 1]), "+f"(d[O + 2]), "+f"(d[O + 3]), "+f"(d[O + 4]),
        "+f"(d[O + 5]), "+f"(d[O + 6]), "+f"(d[O + 7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ---- device: tf32 products ---------------------------------------------------
//
// wgmma on .tf32 operands reads A and B K-major only (the transpose bits are
// for 16-bit types). A k8 step is 32 bytes, as a bf16 k16 step, so the
// descriptors above carry over: a 128-byte-swizzled panel holds 32 f32 a row.
// A register fragment (64 x 8) is four f32 per thread: rows g and g + 8 of
// the warp's 16 (g = lane / 4), columns t and t + 4 (t = lane % 4), as
// a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4).

// x rounded to the nearest tf32 (10 fraction bits; ties away from zero), as an
// f32 whose low 13 bits are 0, so the tensor cores read it exactly
__device__ __forceinline__ float tf32_round(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

// The three-product split: x = hi + lo with hi = tf32(x) and lo = tf32(x − hi)
// (x − hi is exact in f32), so a product a·b to f32 accuracy is a_lo·b_hi +
// a_hi·b_lo + a_hi·b_hi, leaving out a_lo·b_lo (~2^-21 of |a|·|b| a term)
__device__ __forceinline__ void tf32_split(float x, float& hi, float& lo) {
  hi = tf32_round(x);
  lo = tf32_round(x - hi);
}

// the split of four values: hi returned, lo through `lo`
__device__ __forceinline__ float4 tf32_split4(float4 x, float4& lo) {
  float4 hi;
  tf32_split(x.x, hi.x, lo.x);
  tf32_split(x.y, hi.y, lo.y);
  tf32_split(x.z, hi.z, lo.z);
  tf32_split(x.w, hi.w, lo.w);
  return hi;
}

// byte offset of (row r, f32 column c < 32) in a 128-byte-swizzled panel
__device__ __forceinline__ uint32_t swz128(int r, int c) {
  return r * 128 + ((((c >> 2) ^ r) & 7) << 4) + ((c & 3) << 2);
}

// The position at which a transposed (K-major over keys) tf32 panel holds key
// `key` of a 32-key tile: position t of each group of 8 holds key 2t, t + 4
// key 2t + 1. A 64 x 32 f32 accumulator holds columns 2t and 2t + 1 of each
// group in a thread's registers, which are then the A fragment's k indices t
// and t + 4 (ring_step_f32.cu's P), so no shuffle is needed.
__device__ __forceinline__ int tf32_key_pos(int key) {
  return (key & ~7) | ((key & 7) >> 1) | ((key & 1) << 2);
}

// d (64 x 32, f32) = (scale_d ? d : 0) + A·B; A and B K-major tf32 in shared memory
__device__ __forceinline__ void wgmma_tf32_ss_n32(float (&d)[16], uint64_t da, uint64_t db,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15},"
      " %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 32, f32) = (scale_d ? d : 0) + A·B; A (64 x 8 tf32) from registers,
// B K-major tf32 in shared memory
__device__ __forceinline__ void wgmma_tf32_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15},"
      " {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (64 x 64, f32) = (scale_d ? d : 0) + A·B; A (64 x 8 tf32) from registers,
// B K-major tf32 in shared memory
__device__ __forceinline__ void wgmma_tf32_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (64 x 128, f32) = (scale_d ? d : 0) + A·B; A (64 x 8 tf32) from registers,
// B K-major tf32 in shared memory
__device__ __forceinline__ void wgmma_tf32_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                                   uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// ---- device: operand tiles, proxy fence, named barriers ---------------------

constexpr uint32_t kPanel = 64 * 128;   // 64 rows x 64 bf16, 8 KiB
constexpr uint32_t kTile = 2 * kPanel;  // 64 rows x 128 bf16 (two panels), 16 KiB
constexpr uint32_t kKMajorSbo = 1024;   // next 8 rows of a swizzled panel

// order this thread's generic-proxy writes to shared memory before later
// async-proxy accesses (wgmma reads, TMA writes) of the same bytes
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// barrier `id` (1..15; 0 is __syncthreads) over `count` threads
__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// arrive on barrier `id` without waiting; `count` as the waiters' bar.sync gives it
__device__ __forceinline__ void named_bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// the A fragment (64 x 16 bf16, registers) of k16 step kk from a 64 x N f32
// accumulator: the accumulator's two n8 column groups 2kk and 2kk+1
template <int NACC>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&d)[NACC], int kk) {
  a[0] = pack_bf16(d[8 * kk + 0], d[8 * kk + 1]);
  a[1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
}

// ---- device: the backward kernels' gradient rows ------------------------------
//
// dq, dk and dv are [B, L, N, 128] f32, packed like q (row stride ld floats);
// g points at one (b, head)'s column 0.

// rows row0..row0 + rows − 1 of one head set to 0, those below n; the whole
// block takes part
__device__ __forceinline__ void zero_head_rows(float* __restrict__ g, int row0, int rows, int n,
                                               int ld) {
  for (int i = threadIdx.x; i < rows * 32; i += blockDim.x) {
    const int row = row0 + i / 32;
    if (row < n)
      *reinterpret_cast<float4*>(g + static_cast<size_t>(row) * ld + (i % 32) * 4) =
          make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// a consumer thread's rows row_a and row_a + 8 of its 64 x (NACC / 2) f32
// accumulator (entry 4i + 2r + {0, 1}: row row_a + 8r, columns 8i +
// 2(lane % 4) + {0, 1}; 128 columns for NACC 64), those below n
template <int NACC>
__device__ __forceinline__ void store_head_rows(float* __restrict__ g, const float (&acc)[NACC],
                                                int row_a, int n, int ld, int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + r * 8;
    if (row >= n) continue;
    float* out = g + static_cast<size_t>(row) * ld + (lane % 4) * 2;
#pragma unroll
    for (int i = 0; i < NACC / 4; ++i)
      *reinterpret_cast<float2*>(out + i * 8) = make_float2(acc[4 * i + 2 * r], acc[4 * i + 2 * r + 1]);
  }
}

// ---- device: the ring step's carry -------------------------------------------
//
// m, l [B, N, Lq] and acc [B, Lq, N, 128] f32 in device memory (acc packed like
// q); in registers, a consumer thread's rows row_a and row_a + 8 in the 64 x 128
// f32 accumulator layout (entry 4i + 2r + {0, 1}: row row_a + 8r, columns
// 8i + 2(lane % 4) + {0, 1}), and l on one lane of each quad so that the quad's
// shares sum to the row's l. A row past Lq reads m = −1e30 (no key seen), l = 0.

__device__ __forceinline__ void ring_carry_load(float (&acc)[64], float (&m)[2], float (&l)[2],
                                                const float* m_c, const float* l_c,
                                                const float* acc_c, int Lq, int N, int b, int h,
                                                int row_a, int lane) {
  const size_t stat0 = (static_cast<size_t>(b) * N + h) * Lq;
  const size_t ld = static_cast<size_t>(N) * 128;
  const float* accg = acc_c + static_cast<size_t>(b) * Lq * ld + static_cast<size_t>(h) * 128 +
                      (lane % 4) * 2;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + r * 8;
    const bool ok = row < Lq;
    m[r] = ok ? m_c[stat0 + row] : -1e30f;
    l[r] = ok && lane % 4 == 0 ? l_c[stat0 + row] : 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float2 a = ok ? *reinterpret_cast<const float2*>(accg + row * ld + i * 8)
                          : make_float2(0.f, 0.f);
      acc[4 * i + 2 * r] = a.x;
      acc[4 * i + 2 * r + 1] = a.y;
    }
  }
}

// the carry out, in place, for the rows below Lq (l already summed over the quad)
__device__ __forceinline__ void ring_carry_store(const float (&acc)[64], const float (&m)[2],
                                                 const float (&l)[2], float* m_c, float* l_c,
                                                 float* acc_c, int Lq, int N, int b, int h,
                                                 int row_a, int lane) {
  const size_t stat0 = (static_cast<size_t>(b) * N + h) * Lq;
  const size_t ld = static_cast<size_t>(N) * 128;
  float* accg = acc_c + static_cast<size_t>(b) * Lq * ld + static_cast<size_t>(h) * 128 +
                (lane % 4) * 2;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + r * 8;
    if (row >= Lq) continue;
    if (lane % 4 == 0) {
      m_c[stat0 + row] = m[r];
      l_c[stat0 + row] = l[r];
    }
#pragma unroll
    for (int i = 0; i < 16; ++i)
      *reinterpret_cast<float2*>(accg + row * ld + i * 8) =
          make_float2(acc[4 * i + 2 * r], acc[4 * i + 2 * r + 1]);
  }
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace
