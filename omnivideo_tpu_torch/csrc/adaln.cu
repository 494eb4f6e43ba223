// Fused residual + LayerNorm + AdaLN modulation for the Wan DiT, CUDA C++
// for sm_90a.
//
// Replaces the TPU kernel omnivideo_tpu/ops/pallas/adaln.py::_adaln_kernel
// (called from fused_adaln_pallas, pallas_call at adaln.py:165). Per row of
// the f32 residual stream x [B, L, d], in the op order of the JAX reference
// (ops/fused_adaln.py::_ref_impl):
//   1. optional residual: x_new = x + o·gate (o bf16 or f32, gate [B, d] f32
//      optional), stored f32;
//   2. mean = Σx/d, xc = x − mean, var = Σxc²/d (two passes over the row held
//      in registers: centred variance, never E[x²] − mean²);
//   3. y = xc · 1/sqrt(var + eps), then optional affine y·ln_scale + ln_bias
//      ([d] f32), then optional modulation y·(1 + mod_scale) + mod_shift
//      ([B, d] f32);
//   4. store y in bf16 or f32.
// Per-batch vectors are indexed by the row's batch b = row / L, never by the
// block. Products and sums outside the two reductions use __fmul_rn /
// __fadd_rn so nvcc does not contract them into FMAs: x_new equals the plain
// PyTorch twin bit for bit, and y differs from it only through the row sums,
// which run in another order than torch.mean.
//
// Bound on the H100: memory. Each element is read once (x, o) and written
// once (x_new, y): 6 to 12 bytes per element, ~0.6 to 1.2 ms at [2, 32760,
// 5120] at 3.35 TB/s; the arithmetic is ~10 f32 operations per element.
// Design: one block of 128 threads per row; a thread holds up to ten float4
// groups of the row in registers (d ≤ 4·128·10 = 5120, d % 128 == 0 as the
// JAX kernel asks), so the row is read from device memory once, and both
// reductions are a warp shuffle plus one 4-way shared-memory sum whose order
// is fixed (the same result in every thread). Rows are independent, so the
// last rows need no mask.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroups = 10;  // float4 groups per thread

__device__ __forceinline__ float4 load_f32x4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load_bf16x4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store_bf16x4(__nv_bfloat16* p, float4 v) {
  uint2 u;
  *reinterpret_cast<__nv_bfloat162*>(&u.x) = __floats2bfloat162_rn(v.x, v.y);
  *reinterpret_cast<__nv_bfloat162*>(&u.y) = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y), __fmul_rn(a.z, b.z),
                     __fmul_rn(a.w, b.w));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

// Sum over the block; every thread gets the same value.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += red[w];
  __syncthreads();  // red is reused by the next reduction
  return t;
}

__global__ void __launch_bounds__(kThreads)
adaln_kernel(const float* __restrict__ x, const void* __restrict__ o,
             const float* __restrict__ gate, const float* __restrict__ ln_scale,
             const float* __restrict__ ln_bias, const float* __restrict__ mod_scale,
             const float* __restrict__ mod_shift, float* __restrict__ x_new,
             void* __restrict__ y, int L, int d, int o_f32, int y_f32, float eps) {
  __shared__ float red[kWarps];
  const size_t row = blockIdx.x;
  const int b = static_cast<int>(row / L);
  const int groups = d / 4;
  const size_t off = row * d;
  const size_t voff = static_cast<size_t>(b) * d;

  float4 v[kMaxGroups];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxGroups; ++i) {
    const int c = 4 * (threadIdx.x + i * kThreads);
    if (c < d) {
      float4 a = load_f32x4(x + off + c);
      if (o != nullptr) {
        float4 r = o_f32 ? load_f32x4(static_cast<const float*>(o) + off + c)
                         : load_bf16x4(static_cast<const __nv_bfloat16*>(o) + off + c);
        if (gate != nullptr) r = mul4(r, load_f32x4(gate + voff + c));
        a = add4(a, r);
        *reinterpret_cast<float4*>(x_new + off + c) = a;
      }
      v[i] = a;
      s += (a.x + a.y) + (a.z + a.w);
    }
  }
  const float mean = __fdiv_rn(block_sum(s, red), static_cast<float>(d));

  float q = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxGroups; ++i) {
    if (4 * (threadIdx.x + i * kThreads) < d) {
      float4 c = make_float4(__fsub_rn(v[i].x, mean), __fsub_rn(v[i].y, mean),
                             __fsub_rn(v[i].z, mean), __fsub_rn(v[i].w, mean));
      v[i] = c;
      q += (c.x * c.x + c.y * c.y) + (c.z * c.z + c.w * c.w);
    }
  }
  const float var = __fdiv_rn(block_sum(q, red), static_cast<float>(d));
  const float rs = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));
  const float4 rs4 = make_float4(rs, rs, rs, rs);
  const float4 one = make_float4(1.f, 1.f, 1.f, 1.f);

#pragma unroll
  for (int i = 0; i < kMaxGroups; ++i) {
    const int c = 4 * (threadIdx.x + i * kThreads);
    if (c < d) {
      float4 t = mul4(v[i], rs4);
      if (ln_scale != nullptr) t = add4(mul4(t, load_f32x4(ln_scale + c)), load_f32x4(ln_bias + c));
      if (mod_scale != nullptr) {
        t = add4(mul4(t, add4(one, load_f32x4(mod_scale + voff + c))),
                 load_f32x4(mod_shift + voff + c));
      }
      if (y_f32) {
        *reinterpret_cast<float4*>(static_cast<float*>(y) + off + c) = t;
      } else {
        store_bf16x4(static_cast<__nv_bfloat16*>(y) + off + c, t);
      }
    }
  }
}

}  // namespace

// The widest row the kernel holds in registers (the wrapper checks d).
extern "C" int adaln_max_dim() { return 4 * kThreads * kMaxGroups; }

extern "C" int adaln_launch(const void* x, const void* o, const void* gate,
                            const void* ln_scale, const void* ln_bias,
                            const void* mod_scale, const void* mod_shift, void* x_new,
                            void* y, int rows, int L, int d, int o_f32, int y_f32,
                            float eps, void* stream) {
  adaln_kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), o, static_cast<const float*>(gate),
      static_cast<const float*>(ln_scale), static_cast<const float*>(ln_bias),
      static_cast<const float*>(mod_scale), static_cast<const float*>(mod_shift),
      static_cast<float*>(x_new), y, L, d, o_f32, y_f32, eps);
  return static_cast<int>(cudaGetLastError());
}
