// Fused q/k attention prologue for the Wan DiT, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel omnivideo_tpu/ops/pallas/qk_prep.py::_qk_prep_kernel
// (called from qk_prep, pallas_call at qk_prep.py:117). Per row of a q or k
// projection x [B, L, d] (bf16), in the JAX op order:
//   1. f32 sum of squares, rs = 1/sqrt(mean + eps);
//   2. xh = bf16(x·rs), then bf16(xh·gain) (gain in bf16);
//   3. interleaved-pair RoPE in f32: y[2j] = a·c − b·s, y[2j+1] = b·c + a·s,
//      with (c, s) = cos/sin[row, j] from [Lr, hd/2] tables; rows ≥ Lr, and
//      every row when with_rope == 0, pass unrotated;
//   4. store bf16(y);
//   5. per head, the f32 row norm² of the pre-cast y; the block writes the
//      max over its rows, sqrt'ed, to tile_max [B, n_tiles, n_heads]. The
//      wrapper reduces the tiles with one amax and the (1 + 2^-7) slack, so
//      the result is deterministic (no float atomics).
//
// Bound on the H100: memory. One read and one write of [B, L, d] bf16 (plus
// the cos/sin rows); at [2, 32760, 1536] that is ~201 MB, ~60 us at 3.35 TB/s.
// Design: one warp per row, 8 rows per block; a lane moves 16-byte vectors
// (8 bf16, i.e. 4 RoPE pairs that never straddle a head since hd % 8 == 0).
// The row is read twice (sum of squares, then normalize); the second read
// hits L1/L2, so DRAM sees one read. Products and sums of the rotation use
// __fmul_rn/__fadd_rn so nvcc does not contract them into FMAs: the rounding
// then equals the plain PyTorch version's separate multiply and add.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // rows per block, one warp per row

__global__ void __launch_bounds__(kWarps * 32)
qk_prep_kernel(const __nv_bfloat16* __restrict__ x,
               const __nv_bfloat16* __restrict__ gain,
               const float* __restrict__ cos_t,
               const float* __restrict__ sin_t,
               __nv_bfloat16* __restrict__ y,
               float* __restrict__ tile_max,
               int L, int d, int n_heads, int Lr, int with_rope, float eps) {
  extern __shared__ float smem[];
  const int nvec = d / 8;
  const int hd = d / n_heads;
  const int half = hd / 2;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int b = blockIdx.y;
  const int tile = blockIdx.x;
  const int row = tile * kWarps + warp;
  float* part = smem + warp * nvec;               // [kWarps][nvec]
  float* head_sq = smem + kWarps * nvec;          // [kWarps][n_heads]

  if (row < L) {
    const size_t off = (static_cast<size_t>(b) * L + row) * d;
    const uint4* xr = reinterpret_cast<const uint4*>(x + off);
    const uint4* gr = reinterpret_cast<const uint4*>(gain);
    uint4* yr = reinterpret_cast<uint4*>(y + off);

    float ss = 0.f;
    for (int v = lane; v < nvec; v += 32) {
      uint4 u = xr[v];
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float2 f = __bfloat1622float2(p[i]);
        ss += f.x * f.x + f.y * f.y;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    const float rs = 1.0f / sqrtf(ss / static_cast<float>(d) + eps);

    const bool rope = with_rope != 0 && row < Lr;
    const float* crow = cos_t + static_cast<size_t>(row) * half;
    const float* srow = sin_t + static_cast<size_t>(row) * half;
    for (int v = lane; v < nvec; v += 32) {
      uint4 u = xr[v];
      uint4 g = gr[v];
      uint4 out;
      const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&u);
      const __nv_bfloat162* gp = reinterpret_cast<const __nv_bfloat162*>(&g);
      __nv_bfloat162* op = reinterpret_cast<__nv_bfloat162*>(&out);
      const int j0 = ((v * 8) % hd) / 2;  // first pair of this vector in its head
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float2 xf = __bfloat1622float2(xp[i]);
        float2 gf = __bfloat1622float2(gp[i]);
        float a = __bfloat162float(__float2bfloat16_rn(__fmul_rn(xf.x, rs)));
        float c = __bfloat162float(__float2bfloat16_rn(__fmul_rn(xf.y, rs)));
        a = __bfloat162float(__float2bfloat16_rn(__fmul_rn(a, gf.x)));
        c = __bfloat162float(__float2bfloat16_rn(__fmul_rn(c, gf.y)));
        float ya = a, yb = c;
        if (rope) {
          const float cs = crow[j0 + i];
          const float sn = srow[j0 + i];
          ya = __fadd_rn(__fmul_rn(a, cs), __fmul_rn(-c, sn));
          yb = __fadd_rn(__fmul_rn(c, cs), __fmul_rn(a, sn));
        }
        s += ya * ya + yb * yb;
        op[i] = __floats2bfloat162_rn(ya, yb);
      }
      yr[v] = out;
      part[v] = s;
    }
    __syncwarp();
    const int vph = hd / 8;  // vectors per head
    for (int h = lane; h < n_heads; h += 32) {
      float acc = 0.f;
      for (int v = h * vph; v < (h + 1) * vph; ++v) acc += part[v];
      head_sq[warp * n_heads + h] = acc;
    }
  } else {
    for (int h = lane; h < n_heads; h += 32) head_sq[warp * n_heads + h] = 0.f;
  }
  __syncthreads();
  for (int h = threadIdx.x; h < n_heads; h += blockDim.x) {
    float m = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, head_sq[w * n_heads + h]);
    tile_max[(static_cast<size_t>(b) * gridDim.x + tile) * n_heads + h] = sqrtf(m);
  }
}

}  // namespace

// Row tiles of the grid for L rows: tile_max [B, tiles, n_heads] is sized by
// the caller from this, so the tile height is decided here alone.
extern "C" int qk_prep_tiles(int L) { return (L + kWarps - 1) / kWarps; }

extern "C" int qk_prep_launch(const void* x, const void* gain, const void* cos_t,
                              const void* sin_t, void* y, void* tile_max, int B,
                              int L, int d, int n_heads, int Lr, int with_rope,
                              float eps, void* stream) {
  const dim3 grid(qk_prep_tiles(L), B);
  const size_t smem = sizeof(float) * kWarps * (d / 8 + n_heads);
  qk_prep_kernel<<<grid, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(gain),
      static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
      static_cast<__nv_bfloat16*>(y), static_cast<float*>(tile_max), L, d,
      n_heads, Lr, with_rope, eps);
  return static_cast<int>(cudaGetLastError());
}
