// Flash-attention forward, CUDA C++ for sm_90a (bf16 in, bf16 out).
//
// Replaces the TPU kernel omnivideo_tpu/ops/pallas/flash_attention.py::
// _fa_kernel in four of its uses. The inference forward, driven by
// _flash_fwd_unpadded (pallas_call at :328, reached through
// flash_attention_infer :582): online softmax in the exp2 domain with
// scale·log2(e) folded into q (q rounded to bf16 after the scaling, as at
// :100); kv_lens masking with the out-of-range V rows zeroed and wholly dead
// KV tiles skipped; fully masked rows give 0; and the bounded softmax
// (:116-132): when the device flag `safe` is set, p = exp2(s − mb[b, h])
// with the per-(b, h) Cauchy–Schwarz bound mb and no running max or
// rescale; otherwise the usual max-tracked form. The flag and the bound are
// computed on the device by the wrapper and read by the kernel, so choosing
// the mode costs no host sync. Three entries of the port's table:
// - row 1, D = 128, non-causal: the Wan DiT's self- and cross-attention;
// - row 3a, D = 72, non-causal: the Qwen3-VL vision tower. The TPU needed a
//   head-major transpose for D % 128 ≠ 0 (:308-318, 128-lane tiles); here
//   the tensor maps read the 144-byte head rows in place;
// - row 2, D = 128, CAUSAL: the Qwen3 text prefill, _fa_kernel(causal=True):
//   col ≤ row (:111-114), KV tiles that start past the q tile's last row
//   skipped, only the tile straddling the diagonal masked; kv_lens still
//   applies.
// And the training forward (row 3b), _fa_kernel(with_lse=True) via
// _flash_fwd_impl (pallas_call at :430, reached through the custom-VJP rule
// _fa_fwd :628): always max-tracked, and it also writes the natural-log row
// logsumexp LSE = m·ln2 + ln(max(l, 1e-30)) (:174-175) to lse [B, N, Lq]
// f32, the residual the backward kernels of flash_train.cu read. A row with
// no live key keeps m = −1e30, l = 0 and gets o = 0.
//
// Rows 1, 3a and 3b run the Hopper forward mainloop of flash_fwd_hopper.cuh
// (wgmma fed by TMA through an mbarrier ring, one producer and two consumer
// warpgroups that take turns, the exponentials of one tile under the
// products of another), each with this file's epilogue policy: InferOut for
// rows 1 and 3a (o only; bounded or max-tracked as `safe` says), LseOut for
// row 3b. Row 3a runs it on an 80-wide tile: a 64-column panel with the
// 128-byte swizzle and a 16-column panel with the 32-byte swizzle, whose
// columns 72..79 TMA fills with zeros, so q·kᵀ is five k16 steps instead of
// eight and P·V an n64 and an n16 product per k16 step (O is 40 f32 a
// thread). Bound on the H100: operations, 4·B·N·Lq·Lk·D FLOPs on the bf16
// tensor cores (989 TFLOP/s): row 1's self-attention at [2, 32760, 12, 128]
// is 13.2 TFLOP, 13.3 ms; its cross-attention over 6,272 keys 2.55 ms; row
// 3a at [3, 1560, 16, 72] 0.034 ms; row 3b at [1, 32760, 12, 128] 6.7 ms.
//
// Row 2 still runs the first design (mma.sync, FA2-style): grid (Lq/64, N,
// B), 4 warps per block, each warp owns 16 q rows whose bf16 fragments stay
// in registers; K/V tiles of 64 rows are staged in shared memory,
// double-buffered with cp.async so the next tile's load overlaps this tile's
// math; mma.sync.m16n8k16 bf16 with f32 accumulation for both S = q·kᵀ and
// O += bf16(p)·v; 256-byte rows XOR-swizzled by 16-byte chunk. Its bound is
// half the logits of row 1's at the same shape.
//
// Layout: q/k/v/o are read and written in place as packed [B, L, N·D] — the
// layout the projection GEMMs produce (a row is N·D elements, a head's slice
// starts at n·D: 16-byte aligned for D = 72 and 128).

#include "flash_common.cuh"
#include "flash_fwd_hopper.cuh"

namespace {

constexpr int kTileRows = BQ + 4 * BK;  // the causal kernel's smem rows: q + 2 stages of K and of V
constexpr float kLn2 = 0.6931471805599453f;

// o = acc / l in bf16 over the head's D columns of rows row_a and row_a + 8
// (the accumulator's column 8·(i / 4) + 2·(lane % 4) + (i & 1) for entry i,
// as wgmma lays it out); rows past Lq are not stored, a row with l = 0 (no
// live key) gets 0.
template <int D, int NA>
__device__ __forceinline__ void store_o(__nv_bfloat16* o, const float (&acc)[NA],
                                        const float (&l)[2], int b, int h, int row_a, int lane,
                                        int Lq, int N) {
  static_assert(D % 8 == 0 && D / 2 <= NA, "the head's columns are in the accumulator");
  const size_t ld = static_cast<size_t>(N) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + r * 8;
    if (row >= Lq) continue;
    const float denom = l[r] == 0.f ? 1.f : l[r];
    __nv_bfloat16* out = o + (static_cast<size_t>(b) * Lq + row) * ld +
                         static_cast<size_t>(h) * D + (lane % 4) * 2;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(out + i * 8) = __floats2bfloat162_rn(
          __fdiv_rn(acc[4 * i + 2 * r], denom), __fdiv_rn(acc[4 * i + 2 * r + 1], denom));
  }
}

// Rows 1 and 3a's hooks into the Hopper mainloop: every key below kv_len,
// bounded when the device flag `safe` is set (m is the bound mb[b, h] from
// the first tile on), else max-tracked from −1e30; the epilogue writes o
// only. kSkipEmpty is false: a batch row with kv_len = 0 still writes its
// zeros. A head of 72 runs on the 80-wide tile (measured against 72 padded
// to 128: PERF.md).
template <int HD>
struct InferOut {
  static constexpr int D = HD;
  using P = fwdh::Panels<HD <= 80 ? 16 : 64>;
  __nv_bfloat16* o;
  const int* kv_lens;
  const int* mbound;
  const int* safe;
  int Lq, Lk, N;
  static constexpr bool kSkipEmpty = false;

  __device__ int kv_len(int b) const { return kv_lens != nullptr ? kv_lens[b] : Lk; }
  __device__ int live_tiles(int, int n_tiles) const { return n_tiles; }
  __device__ fwdh::TileMask mask(int, int) const { return {false, false, 0, 0, 0}; }
  __device__ bool bounded() const { return safe != nullptr && *safe != 0; }

  __device__ void load(float (&acc)[P::kAcc], float (&m)[2], float (&l)[2], int b, int h, int,
                       int) const {
#pragma unroll
    for (int i = 0; i < P::kAcc; ++i) acc[i] = 0.f;
    m[0] = m[1] = bounded() ? static_cast<float>(mbound[b * N + h]) : fwdh::kInitMax;
    l[0] = l[1] = 0.f;
  }

  __device__ void store(const float (&acc)[P::kAcc], const float (&)[2], const float (&l)[2],
                        int b, int h, int row_a, int lane, bool) const {
    store_o<D>(o, acc, l, b, h, row_a, lane, Lq, N);
  }
};

// Row 3b's hooks into the Hopper mainloop: every key below kv_len, the state
// starts empty, always max-tracked, and the epilogue writes o and the
// natural-log LSE.
struct LseOut {
  static constexpr int D = 128;
  using P = fwdh::Panels<64>;
  __nv_bfloat16* o;
  float* lse;
  const int* kv_lens;
  int Lq, Lk, N;
  static constexpr bool kSkipEmpty = false;

  __device__ int kv_len(int b) const { return kv_lens != nullptr ? kv_lens[b] : Lk; }
  __device__ int live_tiles(int, int n_tiles) const { return n_tiles; }
  __device__ fwdh::TileMask mask(int, int) const { return {false, false, 0, 0, 0}; }
  __device__ bool bounded() const { return false; }

  __device__ void load(float (&acc)[64], float (&m)[2], float (&l)[2], int, int, int,
                       int) const {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    m[0] = m[1] = fwdh::kInitMax;
    l[0] = l[1] = 0.f;
  }

  __device__ void store(const float (&acc)[64], const float (&m)[2], const float (&l)[2], int b,
                        int h, int row_a, int lane, bool) const {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_a + r * 8;
      if (row < Lq && lane % 4 == 0)  // m is in log2 units, l domain-free
        lse[(static_cast<size_t>(b) * N + h) * Lq + row] = m[r] * kLn2 + logf(fmaxf(l[r], 1e-30f));
    }
    store_o<D>(o, acc, l, b, h, row_a, lane, Lq, N);
  }
};

// Row 2: the causal prefill on mma.sync at head dim 128.
__global__ void __launch_bounds__(kThreads)
flash_causal_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                    const int* __restrict__ kv_lens, const int* __restrict__ mbound,
                    const int* __restrict__ safe, int Lq, int Lk, int N, float qscale) {
  constexpr int D = kHead;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + BQ * D;      // 2 stages
  __nv_bfloat16* sV = sK + 2 * BK * D;  // 2 stages

  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ld = N * D;
  int kv_len = kv_lens != nullptr ? kv_lens[b] : Lk;
  kv_len = min(max(kv_len, 0), Lk);
  const bool bounded = safe != nullptr && *safe != 0;
  const float mb = bounded ? static_cast<float>(mbound[b * N + h]) : 0.f;

  const size_t head_off = static_cast<size_t>(h) * D;
  const __nv_bfloat16* qg = q + static_cast<size_t>(b) * Lq * ld + head_off;
  const __nv_bfloat16* kg = k + static_cast<size_t>(b) * Lk * ld + head_off;
  const __nv_bfloat16* vg = v + static_cast<size_t>(b) * Lk * ld + head_off;
  const int q0 = blockIdx.x * BQ;
  // tiles below kv_len with a column <= the q tile's last row
  const int n_tiles = min((kv_len + BK - 1) / BK, (q0 + BQ + BK - 1) / BK);

  load_tile(sQ, qg + static_cast<size_t>(q0) * ld, 0, Lq - q0, ld);
  cp_async_commit();
  if (n_tiles > 0) {
    load_tile(sK, kg, 0, kv_len, ld);
    load_tile(sV, vg, 0, kv_len, ld);
  }
  cp_async_commit();
  cp_async_wait<1>();  // the q tile has landed
  __syncthreads();

  // q fragments (A operand, 16 rows x D) in registers, pre-scaled by
  // scale·log2(e) in f32 and rounded back to bf16
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    ldmatrix_x4(qf[kk], sQ + tile_off(warp * 16 + (lane % 16), kk * 2 + lane / 16));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 t = *reinterpret_cast<__nv_bfloat162*>(&qf[kk][i]);
      float2 f = __bfloat1622float2(t);
      qf[kk][i] = pack_bf16(__fmul_rn(f.x, qscale), __fmul_rn(f.y, qscale));
    }
  }

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_r[2] = {kNegInf, kNegInf};  // running max of rows lane/4 and lane/4+8
  float l_r[2] = {0.f, 0.f};          // this thread's share of the row sums
  const int row_a = q0 + warp * 16 + lane / 4;  // this thread's first row

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    if (j + 1 < n_tiles) {
      load_tile(sK + (st ^ 1) * BK * D, kg, (j + 1) * BK, kv_len, ld);
      load_tile(sV + (st ^ 1) * BK * D, vg, (j + 1) * BK, kv_len, ld);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile j has landed; tile j+1 may be in flight
    __syncthreads();
    const __nv_bfloat16* cK = sK + st * BK * D;
    const __nv_bfloat16* cV = sV + st * BK * D;

    // S = q·kᵀ for this warp's 16 rows x 64 kv columns
    float s[BK / 8][4];
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t kb[4];
        ldmatrix_x4(kb, cK + tile_off(np * 16 + (lane / 16) * 8 + (lane % 8),
                                      kk * 2 + ((lane / 8) & 1)));
        mma_bf16(s[2 * np], qf[kk], kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qf[kk], kb[2], kb[3]);
      }
    }

    // only the last tile can straddle kv_len or the diagonal
    const int kv0 = j * BK;
    if (kv0 + BK > kv_len || kv0 + BK - 1 > q0) {
#pragma unroll
      for (int nb = 0; nb < BK / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = kv0 + nb * 8 + (lane % 4) * 2 + (e & 1);
          const int row = row_a + (e >> 1) * 8;
          if (col >= kv_len || col > row) s[nb][e] = kNegInf;
        }
    }

    if (bounded) {
#pragma unroll
      for (int nb = 0; nb < BK / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[nb][e] - mb);
          l_r[e >> 1] += p;
          s[nb][e] = p;
        }
    } else {
      float mc[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int nb = 0; nb < BK / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) mc[e >> 1] = fmaxf(mc[e >> 1], s[nb][e]);
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mc[r] = fmaxf(mc[r], __shfl_xor_sync(0xffffffffu, mc[r], 1));
        mc[r] = fmaxf(mc[r], __shfl_xor_sync(0xffffffffu, mc[r], 2));
        const float m_new = fmaxf(m_r[r], mc[r]);
        alpha[r] = exp2f(m_r[r] - m_new);
        m_r[r] = m_new;
        l_r[r] *= alpha[r];
      }
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        acc[i][0] *= alpha[0];
        acc[i][1] *= alpha[0];
        acc[i][2] *= alpha[1];
        acc[i][3] *= alpha[1];
      }
#pragma unroll
      for (int nb = 0; nb < BK / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[nb][e] - m_r[e >> 1]);
          l_r[e >> 1] += p;
          s[nb][e] = p;
        }
    }

    // O += bf16(p)·v; the S accumulator layout is the A operand layout
#pragma unroll
    for (int kj = 0; kj < BK / 16; ++kj) {
      uint32_t pa[4] = {pack_bf16(s[2 * kj][0], s[2 * kj][1]),
                        pack_bf16(s[2 * kj][2], s[2 * kj][3]),
                        pack_bf16(s[2 * kj + 1][0], s[2 * kj + 1][1]),
                        pack_bf16(s[2 * kj + 1][2], s[2 * kj + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, cV + tile_off(kj * 16 + ((lane >> 3) & 1) * 8 + (lane & 7),
                                            dp * 2 + (lane >> 4)));
        mma_bf16(acc[2 * dp], pa, vb[0], vb[1]);
        mma_bf16(acc[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // every warp is done with stage st before it is refilled
  }

  float denom[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    denom[r] = l == 0.f ? 1.f : l;  // fully masked rows -> 0
  }
  __nv_bfloat16* og = o + static_cast<size_t>(b) * Lq * ld + head_off + (lane % 4) * 2;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + r * 8;
    if (row >= Lq) continue;
    __nv_bfloat16* orow = og + static_cast<size_t>(row) * ld;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      *reinterpret_cast<__nv_bfloat162*>(orow + i * 8) = __floats2bfloat162_rn(
          __fdiv_rn(acc[i][2 * r], denom[r]), __fdiv_rn(acc[i][2 * r + 1], denom[r]));
    }
  }
}

int launch_causal(const void* q, const void* k, const void* v, void* o, const void* kv_lens,
                  const void* mbound, const void* safe, int B, int Lq, int Lk, int N,
                  float qscale, cudaStream_t stream) {
  constexpr size_t smem = sizeof(__nv_bfloat16) * kTileRows * kHead;
  // set on every call: the attribute is per device, and the call is cheap
  const cudaError_t err = cudaFuncSetAttribute(
      flash_causal_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Lq + BQ - 1) / BQ, N, B);
  flash_causal_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<const int*>(kv_lens), static_cast<const int*>(mbound),
      static_cast<const int*>(safe), Lq, Lk, N, qscale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_infer(const void* q, const void* k, const void* v, void* o, const void* kv_lens,
                 const void* mbound, const void* safe, int B, int Lq, int Lk, int N,
                 float qscale, cudaStream_t stream) {
  const InferOut<HD> pol{static_cast<__nv_bfloat16*>(o), static_cast<const int*>(kv_lens),
                            static_cast<const int*>(mbound), static_cast<const int*>(safe),
                            Lq, Lk, N};
  return fwdh::launch(q, k, v, pol, B, qscale, stream);
}

}  // namespace

// q/k/v/o packed [B, L, N, head_dim], 16-byte aligned. Returns the CUDA
// error code (cudaErrorInvalidValue for a (head_dim, causal) pair without a
// kernel, or operands the tensor maps refuse).
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v, void* o,
                                const void* kv_lens, const void* mbound, const void* safe,
                                int B, int Lq, int Lk, int N, int head_dim, int causal,
                                float qscale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 128 && !causal)
    return launch_infer<128>(q, k, v, o, kv_lens, mbound, safe, B, Lq, Lk, N, qscale, s);
  if (head_dim == 128 && causal)
    return launch_causal(q, k, v, o, kv_lens, mbound, safe, B, Lq, Lk, N, qscale, s);
  if (head_dim == 72 && !causal)
    return launch_infer<72>(q, k, v, o, kv_lens, mbound, safe, B, Lq, Lk, N, qscale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The training forward (row 3b), on the Hopper mainloop: max-tracked, o and
// lse [B, N, Lq] f32. Head dim 128 only, operands 16-byte aligned; returns
// the CUDA error code.
extern "C" int flash_fwd_lse_launch(const void* q, const void* k, const void* v, void* o,
                                    void* lse, const void* kv_lens, int B, int Lq, int Lk,
                                    int N, int head_dim, float qscale, void* stream) {
  if (head_dim != 128) return static_cast<int>(cudaErrorInvalidValue);
  const LseOut pol{static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
                   static_cast<const int*>(kv_lens), Lq, Lk, N};
  return fwdh::launch(q, k, v, pol, B, qscale, static_cast<cudaStream_t>(stream));
}
