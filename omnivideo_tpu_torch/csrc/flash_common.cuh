// Device helpers shared by the CUDA kernels: the shared-memory address and
// bf16 packing every kernel uses, and the mma.sync pieces of the causal
// prefill kernel (flash_fwd.cu, row 2).
//
// A tile there is 64 rows of one head (128 bf16 values each) staged in
// shared memory with cp.async and read with ldmatrix; products run on
// mma.sync.m16n8k16 (bf16 in, f32 accumulators). Each of the 4 warps of a
// block owns 16 rows of the "A" side; an accumulator fragment float[4] holds
// rows lane/4 and lane/4 + 8, columns (lane%4)·2 and +1 of an 8-wide n tile,
// which is also the A-operand layout of the next product (FA2's register
// reuse of p).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;  // q rows per block (4 warps x 16)
constexpr int BK = 64;  // rows per streamed tile
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

constexpr int kHead = 128;  // head dim of the mma.sync kernel

// element offset of 16-byte chunk `chunk` of row `row` of a [rows, 128] tile:
// the chunks of a 256-byte row are XOR-swizzled by row & 7, so the eight
// rows an ldmatrix reads fall in eight distinct 16-byte bank groups
__device__ __forceinline__ int tile_off(int row, int chunk) {
  return row * kHead + ((chunk ^ (row & 7)) << 3);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const int n = pred ? 16 : 0;  // 0 bytes read -> the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a·b, m16n8k16, bf16 inputs, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Stage rows [row0, row0+64) of one head (row stride ld elements) into a
// [64, 128] tile; rows >= nvalid are zero-filled.
__device__ __forceinline__ void load_tile(__nv_bfloat16* s, const __nv_bfloat16* g, int row0,
                                          int nvalid, int ld) {
  constexpr int C = kHead / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < BK * C; i += kThreads) {
    const int r = i / C, c = i % C;
    const bool ok = row0 + r < nvalid;
    const __nv_bfloat16* src = ok ? g + static_cast<size_t>(row0 + r) * ld + c * 8 : g;
    cp_async16(s + tile_off(r, c), src, ok);
  }
}

}  // namespace
