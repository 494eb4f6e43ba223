// Flash-attention backward, CUDA C++ for sm_90a: two kernels, as the TPU's
// flash_bwd_core has (omnivideo_tpu/ops/pallas/flash_attention.py:640):
//
// - flash_bwd_dq: replaces _fa_bwd_dq_kernel (:485, pallas_call at :670).
//   One block per 64 q rows of one (b, head) walks the KV tiles up to kv_len:
//   s = (q·kᵀ)·scale in f32 from the UNSCALED q, p = exp(s − LSE),
//   dp = dO·vᵀ, ds = p·(dp − delta)·scale, dq += bf16(ds)·k.
// - flash_bwd_dkv: replaces _fa_bwd_dkv_kernel (:530, pallas_call at :691).
//   One block per 64 KV rows of one (b, head) walks every q tile:
//   dv += bf16(p)ᵀ·dO, dk += bf16(ds)ᵀ·q. Blocks that start at or past
//   kv_len write zeros.
//
// Both recompute p from the forward's natural-log LSE (row 3b, flash_fwd.cu)
// and take delta = rowsum(dO·O) in f32 from the wrapper; LSE and delta are
// [B, N, Lq] f32. Columns past kv_len give p = 0, so masked keys get zero dk
// and dv, and a batch row with kv_len = 0 gets zero dq. q, k, v and dO are
// bf16, read in place as packed [B, L, N·D] rows (D = 128); dq, dk and dv are
// written in f32 in the same packed layout, so the wrapper casts them once to
// the caller's dtype. Two kernels instead of one with atomic dq: each output
// is written by exactly one block, deterministically, and the ring step (row
// 8) can run them once per ring step with global LSE/delta.
//
// Bound on the H100: operations, on the bf16 tensor cores (989 TFLOP/s):
// dq does three products (6·B·N·Lq·Lk·D FLOPs), dk/dv four (8·B·N·Lq·Lk·D).
// Design (simple first, FA2-style, as flash_fwd.cu): 4 warps per block, each
// owning 16 rows of the block's own side, whose A-operand fragments are read
// with ldmatrix from a tile that stays in shared memory; the walked side's
// tiles are double-buffered with cp.async; mma.sync.m16n8k16 bf16 with f32
// accumulators. In dk/dv each warp takes the transposed view (its KV rows
// are the M side: sᵀ = k·qᵀ, dpᵀ = v·dOᵀ), so pᵀ and dsᵀ leave the
// accumulators already in the A layout of dv += pᵀ·dO and dk += dsᵀ·q; the
// q tile is taken in two 32-column halves to keep dk and dv (128 f32
// registers) live without spilling. wgmma/TMA are left for a later change.

#include "flash_common.cuh"

namespace {

constexpr int D = 128;
using T = Tile<D>;
constexpr int kTileElems = BK * T::LDS;
constexpr size_t kSmemBytes = sizeof(__nv_bfloat16) * 6 * kTileElems;  // 96 KiB
constexpr size_t kSmemBytesDkv = kSmemBytes + 2 * 2 * BK * sizeof(float);  // + lse, delta

// acc (16 x NC) = A(16 rows of sA from a0, D wide) · B(rows b0..b0+NC of sB)ᵀ
template <int NC>
__device__ __forceinline__ void mma_abt(float (&acc)[NC / 8][4], const __nv_bfloat16* sA,
                                        int a0, const __nv_bfloat16* sB, int b0, int lane) {
#pragma unroll
  for (int i = 0; i < NC / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, sA + T::off(a0 + (lane % 16), kk * 2 + lane / 16));
#pragma unroll
    for (int np = 0; np < NC / 16; ++np) {
      uint32_t b[4];
      ldmatrix_x4(b, sB + T::off(b0 + np * 16 + (lane / 16) * 8 + (lane % 8),
                                 kk * 2 + ((lane / 8) & 1)));
      mma_bf16(acc[2 * np], a, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// acc (16 x D) += bf16(p) (16 x NC, accumulator layout) · B(rows b0..b0+NC of sB)
template <int NC>
__device__ __forceinline__ void mma_pb(float (&acc)[D / 8][4], const float (&p)[NC / 8][4],
                                       const __nv_bfloat16* sB, int b0, int lane) {
#pragma unroll
  for (int kj = 0; kj < NC / 16; ++kj) {
    const uint32_t pa[4] = {pack_bf16(p[2 * kj][0], p[2 * kj][1]),
                            pack_bf16(p[2 * kj][2], p[2 * kj][3]),
                            pack_bf16(p[2 * kj + 1][0], p[2 * kj + 1][1]),
                            pack_bf16(p[2 * kj + 1][2], p[2 * kj + 1][3])};
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, sB + T::off(b0 + kj * 16 + ((lane >> 3) & 1) * 8 + (lane & 7),
                                        dp * 2 + (lane >> 4)));
      mma_bf16(acc[2 * dp], pa, vb[0], vb[1]);
      mma_bf16(acc[2 * dp + 1], pa, vb[2], vb[3]);
    }
  }
}

// rows row_a and row_a + 8 of this thread's accumulator (16 x D) → f32 out
__device__ __forceinline__ void store_rows(float* __restrict__ g, const float (&acc)[D / 8][4],
                                           int row_a, int nrows, int ld, int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + r * 8;
    if (row >= nrows) continue;
    float* out = g + static_cast<size_t>(row) * ld + (lane % 4) * 2;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<float2*>(out + i * 8) = make_float2(acc[i][2 * r], acc[i][2 * r + 1]);
  }
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, const int* __restrict__ kv_lens, int Lq, int Lk,
                    int N, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sDO = sQ + kTileElems;
  __nv_bfloat16* sK = sDO + kTileElems;      // 2 stages
  __nv_bfloat16* sV = sK + 2 * kTileElems;   // 2 stages

  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ld = N * D;
  int kv_len = kv_lens != nullptr ? kv_lens[b] : Lk;
  kv_len = min(max(kv_len, 0), Lk);
  const size_t head_off = static_cast<size_t>(h) * D;
  const size_t q_off = static_cast<size_t>(b) * Lq * ld + head_off;
  const __nv_bfloat16* kg = k + static_cast<size_t>(b) * Lk * ld + head_off;
  const __nv_bfloat16* vg = v + static_cast<size_t>(b) * Lk * ld + head_off;
  const int q0 = blockIdx.x * BQ;
  const int n_tiles = (kv_len + BK - 1) / BK;

  load_tile<D>(sQ, q + q_off + static_cast<size_t>(q0) * ld, 0, Lq - q0, ld);
  load_tile<D>(sDO, dout + q_off + static_cast<size_t>(q0) * ld, 0, Lq - q0, ld);
  cp_async_commit();
  if (n_tiles > 0) {
    load_tile<D>(sK, kg, 0, kv_len, ld);
    load_tile<D>(sV, vg, 0, kv_len, ld);
  }
  cp_async_commit();

  const int row_a = q0 + warp * 16 + lane / 4;  // this thread's rows: row_a, row_a + 8
  const float* lse_bh = lse + (static_cast<size_t>(b) * N + h) * Lq;
  const float* delta_bh = delta + (static_cast<size_t>(b) * N + h) * Lq;
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + r * 8;
    lse_r[r] = row < Lq ? lse_bh[row] : 0.f;
    delta_r[r] = row < Lq ? delta_bh[row] : 0.f;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    if (j + 1 < n_tiles) {
      load_tile<D>(sK + (st ^ 1) * kTileElems, kg, (j + 1) * BK, kv_len, ld);
      load_tile<D>(sV + (st ^ 1) * kTileElems, vg, (j + 1) * BK, kv_len, ld);
    }
    cp_async_commit();
    cp_async_wait<1>();  // q, dO and tile j have landed; tile j+1 may be in flight
    __syncthreads();
    const __nv_bfloat16* cK = sK + st * kTileElems;
    const __nv_bfloat16* cV = sV + st * kTileElems;

    float s[BK / 8][4], dp[BK / 8][4];
    mma_abt<BK>(s, sQ, warp * 16, cK, 0, lane);    // q·kᵀ
    mma_abt<BK>(dp, sDO, warp * 16, cV, 0, lane);  // dO·vᵀ
    const int kv0 = j * BK;
#pragma unroll
    for (int nb = 0; nb < BK / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kv0 + nb * 8 + (lane % 4) * 2 + (e & 1);
        const int r = e >> 1;
        const float p = col < kv_len ? expf(s[nb][e] * scale - lse_r[r]) : 0.f;
        s[nb][e] = p * (dp[nb][e] - delta_r[r]) * scale;  // ds
      }
    mma_pb<BK>(acc, s, cK, 0, lane);  // dq += ds·k
    __syncthreads();  // every warp is done with stage st before it is refilled
  }
  store_rows(dq + q_off, acc, row_a, Lq, ld, lane);
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv,
                     const int* __restrict__ kv_lens, int Lq, int Lk, int N, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + kTileElems;
  __nv_bfloat16* sQ = sV + kTileElems;       // 2 stages
  __nv_bfloat16* sDO = sQ + 2 * kTileElems;  // 2 stages
  float* sL = reinterpret_cast<float*>(sDO + 2 * kTileElems);  // 2 stages of BQ lse
  float* sD = sL + 2 * BQ;                                      // 2 stages of BQ delta

  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ld = N * D;
  int kv_len = kv_lens != nullptr ? kv_lens[b] : Lk;
  kv_len = min(max(kv_len, 0), Lk);
  const size_t head_off = static_cast<size_t>(h) * D;
  const size_t kv_off = static_cast<size_t>(b) * Lk * ld + head_off;
  const int k0 = blockIdx.x * BK;
  const int row_a = k0 + warp * 16 + lane / 4;  // this thread's KV rows: row_a, row_a + 8

  float acc_k[D / 8][4], acc_v[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[i][e] = acc_v[i][e] = 0.f;
  if (k0 >= kv_len) {  // no live key in this block: zero gradient
    store_rows(dk + kv_off, acc_k, row_a, Lk, ld, lane);
    store_rows(dv + kv_off, acc_v, row_a, Lk, ld, lane);
    return;
  }

  const size_t q_off = static_cast<size_t>(b) * Lq * ld + head_off;
  const __nv_bfloat16* qg = q + q_off;
  const __nv_bfloat16* dog = dout + q_off;
  const float* lse_bh = lse + (static_cast<size_t>(b) * N + h) * Lq;
  const float* delta_bh = delta + (static_cast<size_t>(b) * N + h) * Lq;
  const int n_tiles = (Lq + BQ - 1) / BQ;

  // K/V rows past kv_len are zero-filled; q/dO rows past Lq too, with lse =
  // delta = 0 there: p = 1 against a zero dO row and dp − delta = 0, so
  // those rows add exactly nothing to dk or dv
  auto stage_rows = [&](int st, int t) {
    for (int i = threadIdx.x; i < BQ; i += kThreads) {
      const int row = t * BQ + i;
      sL[st * BQ + i] = row < Lq ? lse_bh[row] : 0.f;
      sD[st * BQ + i] = row < Lq ? delta_bh[row] : 0.f;
    }
  };
  load_tile<D>(sK, k + kv_off + static_cast<size_t>(k0) * ld, 0, kv_len - k0, ld);
  load_tile<D>(sV, v + kv_off + static_cast<size_t>(k0) * ld, 0, kv_len - k0, ld);
  cp_async_commit();
  load_tile<D>(sQ, qg, 0, Lq, ld);
  load_tile<D>(sDO, dog, 0, Lq, ld);
  cp_async_commit();
  stage_rows(0, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    if (j + 1 < n_tiles) {
      load_tile<D>(sQ + (st ^ 1) * kTileElems, qg, (j + 1) * BQ, Lq, ld);
      load_tile<D>(sDO + (st ^ 1) * kTileElems, dog, (j + 1) * BQ, Lq, ld);
      stage_rows(st ^ 1, j + 1);
    }
    cp_async_commit();
    cp_async_wait<1>();  // K, V and q tile j have landed; tile j+1 may be in flight
    __syncthreads();
    const __nv_bfloat16* cQ = sQ + st * kTileElems;
    const __nv_bfloat16* cDO = sDO + st * kTileElems;
    const float* cL = sL + st * BQ;
    const float* cD = sD + st * BQ;

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      constexpr int NC = BQ / 2;
      const int c0 = half * NC;
      float pt[NC / 8][4], dst[NC / 8][4];
      mma_abt<NC>(pt, sK, warp * 16, cQ, c0, lane);    // sᵀ = k·qᵀ
      mma_abt<NC>(dst, sV, warp * 16, cDO, c0, lane);  // dpᵀ = v·dOᵀ
#pragma unroll
      for (int nb = 0; nb < NC / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = c0 + nb * 8 + (lane % 4) * 2 + (e & 1);  // q row in the tile
          const int row = row_a + (e >> 1) * 8;                  // KV row
          const float p = row < kv_len ? expf(pt[nb][e] * scale - cL[c]) : 0.f;
          pt[nb][e] = p;
          dst[nb][e] = p * (dst[nb][e] - cD[c]) * scale;  // dsᵀ
        }
      mma_pb<NC>(acc_v, pt, cDO, c0, lane);  // dv += pᵀ·dO
      mma_pb<NC>(acc_k, dst, cQ, c0, lane);  // dk += dsᵀ·q
    }
    __syncthreads();  // every warp is done with stage st before it is refilled
  }
  store_rows(dk + kv_off, acc_k, row_a, Lk, ld, lane);
  store_rows(dv + kv_off, acc_v, row_a, Lk, ld, lane);
}

}  // namespace

// q/k/v/dout packed [B, L, N, 128] bf16; lse/delta [B, N, Lq] f32; dq
// [B, Lq, N, 128] f32. kv_lens [B] int32 or null. Returns the CUDA error code.
extern "C" int flash_bwd_dq_launch(const void* q, const void* k, const void* v, const void* dout,
                                   const void* lse, const void* delta, void* dq,
                                   const void* kv_lens, int B, int Lq, int Lk, int N,
                                   int head_dim, float scale, void* stream) {
  if (head_dim != D) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Lq + BQ - 1) / BQ, N, B);
  flash_bwd_dq_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<float*>(dq),
      static_cast<const int*>(kv_lens), Lq, Lk, N, scale);
  return static_cast<int>(cudaGetLastError());
}

// as above; dk/dv [B, Lk, N, 128] f32.
extern "C" int flash_bwd_dkv_launch(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    void* dk, void* dv, const void* kv_lens, int B, int Lq,
                                    int Lk, int N, int head_dim, float scale, void* stream) {
  if (head_dim != D) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytesDkv));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Lk + BK - 1) / BK, N, B);
  flash_bwd_dkv_kernel<<<grid, kThreads, kSmemBytesDkv, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<float*>(dk),
      static_cast<float*>(dv), static_cast<const int*>(kv_lens), Lq, Lk, N, scale);
  return static_cast<int>(cudaGetLastError());
}
