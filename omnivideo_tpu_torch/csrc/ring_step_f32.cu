// One ring-attention step on f32 operands, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel omnivideo_tpu/ops/pallas/ring_attention.py::
// _step_kernel (pallas_call at :249) where its operands are f32: the Pallas
// kernel casts q, k and v to f32 and takes its products in f32, so an f32
// model's attention never passes through bf16 there. ring_step.cu (row 8)
// reads bf16 operands for the tensor cores; this file is the same step with
// f32 products on the CUDA cores, for the trainable ring under an f32 model
// (the SFT's `--sp`). Rounding q, k and v to bf16 moves an f32 model's
// attention output by ~1e-3 of itself, enough to flip a Qwen3 MoE router's
// top-k choice for some tokens, which moves the experts' gradients by
// percents; here the step agrees with its plain twin to f32 rounding.
//
// The step and the carry are ring_step.cu's: for every (b, h, q row) and
// visible key column c, in the exp2 domain with s = (q·scale·log2e)·k,
//   m' = max(m, max_c s),  l' = l·2^(m−m') + Σ 2^(s−m'),
//   acc' = acc·2^(m−m') + Σ 2^(s−m')·v_c,
// m, l [B, N, Lq] f32 and acc [B, Lq, N, D] f32 updated in place, and the
// visibility modes 0-4 (none, block, token, stripe, zigzag) and step_lens
// as there. p is not rounded: the plain twin is ring_step_plain on f32
// inputs.
//
// Design, the simple one first: a block of 256 threads takes 64 q rows of
// one (b, h); 4 threads share a row. The q tile (pre-scaled) stays in
// shared memory; K and V tiles of 32 keys pass through it. Each thread
// forms 8 of its row's 32 logits, the row's max and sum meet by shuffles
// among its 4 threads, the row's p go to shared memory, and each thread
// accumulates 32 of the 128 output columns (columns sub + 4i, so the four
// threads of a row read four banks). Rows of shared memory are padded to
// 129 floats, so the 8 rows of a warp fall in 8 banks. A row's visible keys
// are a prefix of the shard in every mode, so the loop ends at the first
// tile that the block's last row cannot see.
//
// Bound on the H100: operations, 4·B·N·Lq·Lk_visible·D FLOPs at the CUDA
// cores' f32 rate (67 TFLOP/s).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kD = 128;
constexpr int kRows = 64;   // q rows per block
constexpr int kKeys = 32;   // keys per tile
constexpr int kThreads = 256;
constexpr int kPad = kD + 1;  // shared-memory row stride, in floats
constexpr int kPPad = kKeys + 1;
constexpr float kNegInf = -INFINITY;

// Is key column `col` of the visiting shard visible to q row `row`?
__device__ __forceinline__ bool visible(int mode, int row, int col, int my, int src, int n,
                                        int zz) {
  switch (mode) {
    case 1:
      return src <= my;
    case 2:
      return src < my || (src == my && col <= row);
    case 3:
      return col + (src > my ? 1 : 0) <= row;
    case 4: {
      const bool q2 = row >= zz, k2 = col >= zz;
      const int qc = q2 ? 2 * n - 1 - my : my;
      const int kc = k2 ? 2 * n - 1 - src : src;
      if (kc != qc) return kc < qc;
      return col - (k2 ? zz : 0) <= row - (q2 ? zz : 0);
    }
    default:
      return true;
  }
}

__global__ void __launch_bounds__(kThreads) ring_step_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ m_c, float* __restrict__ l_c, float* __restrict__ acc_c,
    const int* __restrict__ step_lens, int Lq, int Lk, int N, int mode, int my, int src, int n,
    int zz, float qscale) {
  extern __shared__ float smem[];
  float* qs = smem;                     // [kRows][kPad]
  float* ks = qs + kRows * kPad;        // [kKeys][kPad]
  float* vs = ks + kKeys * kPad;        // [kKeys][kPad]
  float* ps = vs + kKeys * kPad;        // [kRows][kPPad]

  const int tid = threadIdx.x, r = tid / 4, sub = tid % 4;
  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int row = q0 + r;
  const bool row_ok = row < Lq;
  const int klen = step_lens != nullptr ? min(step_lens[b], Lk) : Lk;
  const int last = min(q0 + kRows, Lq) - 1;  // the block's last row sees the most keys
  const size_t ld = static_cast<size_t>(N) * kD;
  const float* qg = q + static_cast<size_t>(b) * Lq * ld + static_cast<size_t>(h) * kD;
  const float* kg = k + static_cast<size_t>(b) * Lk * ld + static_cast<size_t>(h) * kD;
  const float* vg = v + static_cast<size_t>(b) * Lk * ld + static_cast<size_t>(h) * kD;

  // the tiles this block sees: a prefix of the shard
  int n_tiles = 0;
  while (n_tiles * kKeys < klen && visible(mode, last, n_tiles * kKeys, my, src, n, zz))
    ++n_tiles;
  if (n_tiles == 0) return;  // nothing visible: the carry stays as it is

  for (int e = tid; e < kRows * kD; e += kThreads) {
    const int i = e / kD, d = e % kD;
    qs[i * kPad + d] = q0 + i < Lq ? qg[static_cast<size_t>(q0 + i) * ld + d] * qscale : 0.f;
  }
  const size_t stat = (static_cast<size_t>(b) * N + h) * Lq + row;
  float m = row_ok ? m_c[stat] : -1e30f;
  float l = row_ok ? l_c[stat] : 0.f;
  float acc[kD / 4];
  float* accg = acc_c + static_cast<size_t>(b) * Lq * ld + static_cast<size_t>(row) * ld +
                static_cast<size_t>(h) * kD;
#pragma unroll
  for (int i = 0; i < kD / 4; ++i) acc[i] = row_ok ? accg[sub + 4 * i] : 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = t * kKeys;
    __syncthreads();  // the previous tile's K/V are read
    for (int e = tid; e < kKeys * kD; e += kThreads) {
      const int j = e / kD, d = e % kD;
      const bool ok = kv0 + j < klen;  // V rows past the valid keys are zeroed
      ks[j * kPad + d] = ok ? kg[static_cast<size_t>(kv0 + j) * ld + d] : 0.f;
      vs[j * kPad + d] = ok ? vg[static_cast<size_t>(kv0 + j) * ld + d] : 0.f;
    }
    __syncthreads();

    float s[kKeys / 4];
    float tmax = kNegInf;
#pragma unroll
    for (int u = 0; u < kKeys / 4; ++u) {
      const int j = sub + 4 * u, col = kv0 + j;
      float dot = kNegInf;
      if (row_ok && col < klen && visible(mode, row, col, my, src, n, zz)) {
        dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < kD; ++d) dot = fmaf(qs[r * kPad + d], ks[j * kPad + d], dot);
      }
      s[u] = dot;
      tmax = fmaxf(tmax, dot);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m, tmax);
    const float alpha = exp2f(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int u = 0; u < kKeys / 4; ++u) {
      const float p = exp2f(s[u] - m_new);  // a masked logit (−inf) adds exactly 0
      ps[r * kPPad + sub + 4 * u] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();  // a row's p come from its own 4 threads, in this warp
#pragma unroll
    for (int i = 0; i < kD / 4; ++i) acc[i] *= alpha;
    for (int j = 0; j < kKeys; ++j) {
      const float p = ps[r * kPPad + j];
#pragma unroll
      for (int i = 0; i < kD / 4; ++i) acc[i] = fmaf(p, vs[j * kPad + sub + 4 * i], acc[i]);
    }
  }

  if (!row_ok) return;
  if (sub == 0) {
    m_c[stat] = m;
    l_c[stat] = l;
  }
#pragma unroll
  for (int i = 0; i < kD / 4; ++i) accg[sub + 4 * i] = acc[i];
}

}  // namespace

// q [B, Lq, N, 128] and k/v [B, Lk, N, 128] packed f32; m, l [B, N, Lq] f32
// and acc [B, Lq, N, 128] f32 updated in place; step_lens [B] int32 or null.
// mode: 0 none, 1 block, 2 token, 3 stripe, 4 zigzag (zz = chunk length).
// Returns the CUDA error code.
extern "C" int ring_step_f32_launch(const void* q, const void* k, const void* v, void* m,
                                    void* l, void* acc, const void* step_lens, int B, int Lq,
                                    int Lk, int N, int head_dim, int mode, int my, int src, int n,
                                    int zz, float qscale, void* stream) {
  if (head_dim != kD || mode < 0 || mode > 4 || (mode == 4 && zz <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = (kRows * kPad + 2 * kKeys * kPad + kRows * kPPad) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(ring_step_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Lq + kRows - 1) / kRows, N, B);
  ring_step_f32_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(m), static_cast<float*>(l), static_cast<float*>(acc),
      static_cast<const int*>(step_lens), Lq, Lk, N, mode, my, src, n, zz, qscale);
  return static_cast<int>(cudaGetLastError());
}
