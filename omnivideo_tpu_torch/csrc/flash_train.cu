// Flash-attention backward, CUDA C++ for sm_90a: two kernels, as the TPU's
// flash_bwd_core has (omnivideo_tpu/ops/pallas/flash_attention.py:640):
//
// - flash_bwd_dq: replaces _fa_bwd_dq_kernel (:485, pallas_call at :670).
//   A block owns 128 q rows of one (b, head) and walks the KV tiles up to
//   kv_len: s = q·kᵀ in f32 from the UNSCALED q, p = exp(s·scale − LSE),
//   dp = dO·vᵀ, ds = p·(dp − delta)·scale, dq += bf16(ds)·k.
// - flash_bwd_dkv: replaces _fa_bwd_dkv_kernel (:530, pallas_call at :691).
//   A block owns 128 KV rows of one (b, head) and walks every q tile:
//   dv += bf16(p)ᵀ·dO, dk += bf16(ds)ᵀ·q. Blocks that start at or past
//   kv_len write zeros without loading.
//
// Both recompute p from the forward's natural-log LSE (row 3b, flash_fwd.cu)
// and take delta = rowsum(dO·O) in f32 from the wrapper; LSE and delta are
// [B, N, Lq] f32. Columns past kv_len give p = 0, so masked keys get zero dk
// and dv, and a batch row with kv_len = 0 gets zero dq. q, k, v and dO are
// bf16, read in place as packed [B, L, N·D] rows (D = 128); dq, dk and dv are
// written in f32 in the same packed layout, so the wrapper casts them once to
// the caller's dtype. Two kernels instead of one with atomic dq: each output
// is written by exactly one block, so every run gives the same bits, and the
// ring backward can run them once per ring step with global LSE/delta.
//
// Bound on the H100: operations, on the bf16 tensor cores (989 TFLOP/s):
// dq does three products (6·B·N·Lq·Lk·D FLOPs), dk/dv four (8·B·N·Lq·Lk·D),
// and p costs one exponential per (q row, key) in each kernel.
//
// Design (hopper_common.cuh holds the building blocks): a block is one
// producer warpgroup and two consumer warpgroups (384 threads, one block per
// SM). The producer keeps TMA loads of the streamed side in flight through
// a ring of kStages shared-memory stages tracked by full/empty mbarriers, and
// gives its registers to the consumers (setmaxnreg 40 / 232). Each consumer
// warpgroup owns 64 rows of the block's stationary side, loaded once by TMA,
// and runs every product as wgmma: s (or sᵀ) and dp (or dpᵀ) as 64x64 SS
// products over D, then the gradient product from registers (RS, 64x128),
// the streamed tile read MN-major through wgmma's transpose bit. The f32
// accumulator of s/dp is already the register A layout of the next product,
// so p and ds never touch shared memory. In dk/dv the consumers take the
// transposed view (their KV rows are the M side: sᵀ = k·qᵀ, dpᵀ = v·dOᵀ);
// the q tile's LSE (pre-scaled by log2 e, so p is one FMA and one ex2) and
// delta are staged beside it by the producer warp. The two consumers read
// the same stage, so one warpgroup's exponentials overlap the other's
// products. A 128-row stationary side halves the L2 reads of the streamed
// side against a 64-row one; a head's blocks are adjacent in launch order
// (tile index fastest) so the streamed side stays in L2. Accumulators per
// consumer thread: dk and dv 64 f32 each, sᵀ and dpᵀ 32 each (dq: 64 + 32 +
// 32). Edges: TMA zero-fills rows past L (q and dO rows past Lq, with LSE =
// delta = 0, add exactly nothing), and rows past the output's length are not
// stored.

#include "hopper_common.cuh"

namespace {

constexpr int D = 128;
constexpr int kRows = 64;             // rows per consumer warpgroup and per streamed tile
constexpr int kStationary = 2 * kRows;  // rows a block owns
constexpr int kStages = 3;
constexpr int kThreadsWS = 384;       // producer warpgroup + two consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kProducerRegs = 40;  // 128·40 + 256·232 = 384·168, the registers the block launches with
constexpr int kConsumerRegs = 232;

// shared-memory layout: two stationary 128-row tiles ([warpgroup][panel]),
// kStages stages of two streamed tiles, then (dk/dv) per-stage LSE/delta,
// then the barriers
constexpr uint32_t kStationaryBytes = 2 * 2 * kTile;
constexpr uint32_t kStageBytes = 2 * kTile;
constexpr uint32_t kStatsOff = kStationaryBytes + kStages * kStageBytes;
constexpr uint32_t kBarOff = kStatsOff + kStages * 2 * kRows * sizeof(float);
constexpr size_t kSmemBytes = kBarOff + (1 + 2 * kStages) * sizeof(uint64_t) + 1024;  // + align

struct Smem {
  unsigned char* base;  // 1024-byte aligned
  __device__ unsigned char* stat(int i) const { return base + i * kTile * 2; }
  __device__ unsigned char* stage(int s, int i) const {
    return base + kStationaryBytes + s * kStageBytes + i * kTile;
  }
  __device__ float* stats(int s) const {
    return reinterpret_cast<float*>(base + kStatsOff) + s * 2 * kRows;
  }
  __device__ uint64_t* bar(int i) const { return reinterpret_cast<uint64_t*>(base + kBarOff) + i; }
  __device__ uint64_t* stat_full() const { return bar(0); }
  __device__ uint64_t* full(int s) const { return bar(1 + s); }
  __device__ uint64_t* empty(int s) const { return bar(1 + kStages + s); }
};

__device__ __forceinline__ Smem smem_layout() {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t a = smem_u32(smem_raw);
  return Smem{smem_raw + (((a + 1023) & ~1023u) - a)};
}

__device__ __forceinline__ void init_barriers(const Smem& sm, int full_count) {
  if (threadIdx.x == 0) {
    mbar_init(sm.stat_full(), 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(sm.full(s), full_count);
      mbar_init(sm.empty(s), kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();
}

// rows row0..row0+127 of one head (row stride ld floats) set to 0, rows < n
__device__ __forceinline__ void zero_rows(float* __restrict__ g, int row0, int n, int ld) {
  for (int i = threadIdx.x; i < kStationary * (D / 4); i += blockDim.x) {
    const int row = row0 + i / (D / 4);
    if (row < n)
      *reinterpret_cast<float4*>(g + static_cast<size_t>(row) * ld + (i % (D / 4)) * 4) =
          make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// a consumer thread's rows row_a and row_a + 8 of its 64 x 128 accumulator
__device__ __forceinline__ void store_acc(float* __restrict__ g, const float (&acc)[64], int row_a,
                                          int n, int ld, int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + r * 8;
    if (row >= n) continue;
    float* out = g + static_cast<size_t>(row) * ld + (lane % 4) * 2;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<float2*>(out + i * 8) = make_float2(acc[4 * i + 2 * r], acc[4 * i + 2 * r + 1]);
  }
}

// the stationary side of one consumer warpgroup: tiles i (two 128-row tiles
// of the block) at rows row0 + 64·wg, both panels, onto `bar`
__device__ __forceinline__ void load_stationary(const Smem& sm, int i, const CUtensorMap* map,
                                                int h, int row0, int b) {
#pragma unroll
  for (int wg = 0; wg < 2; ++wg)
#pragma unroll
    for (int p = 0; p < 2; ++p)
      tma_load(sm.stat(i) + wg * kTile + p * kPanel, map, sm.stat_full(), p * 64, h,
               row0 + wg * kRows, b);
}

__device__ __forceinline__ void load_streamed(void* dst, const CUtensorMap* map, uint64_t* bar,
                                              int h, int row0, int b) {
#pragma unroll
  for (int p = 0; p < 2; ++p)
    tma_load(static_cast<unsigned char*>(dst) + p * kPanel, map, bar, p * 64, h, row0, b);
}

// d (64 x 64) = A (64 rows at a, K-major) · B (64 rows at b, K-major)ᵀ over D
__device__ __forceinline__ void gemm_abt(float (&d)[32], uint32_t a, uint32_t b) {
  constexpr uint32_t hi = wgmma_desc_hi(kKMajorSbo);
  const uint32_t la = wgmma_desc_lo(a, 16), lb = wgmma_desc_lo(b, 16);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < D / 16; ++k) {
    const uint32_t off = ((k / 4) * kPanel + (k % 4) * 32) >> 4;
    wgmma_ss_n64(d, wgmma_desc(la + off, hi), wgmma_desc(lb + off, hi), k > 0);
  }
  wgmma_commit();
}

// d (64 x 128) += A (64 x 64, registers) · B (64 rows at b, MN-major)
__device__ __forceinline__ void gemm_pb(float (&d)[64], const uint32_t (&a)[4][4], uint32_t b) {
  constexpr uint32_t hi = wgmma_desc_hi(kKMajorSbo);
  const uint32_t lb = wgmma_desc_lo(b, kPanel);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs_n128_tb(d, a[kk], wgmma_desc(lb + ((kk * 2048) >> 4), hi));
}

// the operands of an RS batch held in place: the accumulators and A
// fragments are neither read nor written by other code while it runs
__device__ __forceinline__ void fence_batch(float (&d0)[64], float (&d1)[64], uint32_t (&a0)[4][4],
                                            uint32_t (&a1)[4][4]) {
  fence_operands(d0);
  fence_operands(d1);
  fence_operands(a0);
  fence_operands(a1);
}

__global__ void __launch_bounds__(kThreadsWS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, const int* __restrict__ kv_lens, int Lq, int Lk,
                    int N, float scale) {
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * kStationary;
  const int ld = N * D;
  int kv_len = kv_lens != nullptr ? kv_lens[b] : Lk;
  kv_len = min(max(kv_len, 0), Lk);
  const int n_tiles = (kv_len + kRows - 1) / kRows;
  float* dq_bh = dq + static_cast<size_t>(b) * Lq * ld + static_cast<size_t>(h) * D;
  if (n_tiles == 0) {  // no key: zero gradient
    zero_rows(dq_bh, q0, Lq, ld);
    return;
  }
  const Smem sm = smem_layout();
  init_barriers(sm, 1);

  if (threadIdx.x < 128) {  // producer warpgroup: one thread starts every load
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(sm.stat_full(), kStationaryBytes);
      load_stationary(sm, 0, &tq, h, q0, b);
      load_stationary(sm, 1, &tdo, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        mbar_wait(sm.empty(s), ((j / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(sm.full(s), kStageBytes);
        load_streamed(sm.stage(s, 0), &tk, sm.full(s), h, j * kRows, b);
        load_streamed(sm.stage(s, 1), &tv, sm.full(s), h, j * kRows, b);
      }
    }
  } else {  // consumer warpgroups: 64 q rows each
    setmaxnreg_inc<kConsumerRegs>();
    const int cw = threadIdx.x / 128 - 1;
    const int t = threadIdx.x % 128, lane = t % 32;
    const int row_a = q0 + cw * kRows + (t / 32) * 16 + lane / 4;  // rows row_a, row_a + 8
    const float* lse_bh = lse + (static_cast<size_t>(b) * N + h) * Lq;
    const float* delta_bh = delta + (static_cast<size_t>(b) * N + h) * Lq;
    float lse2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_a + r * 8;
      lse2[r] = row < Lq ? lse_bh[row] * kLog2e : 0.f;
      dl[r] = row < Lq ? delta_bh[row] : 0.f;
    }
    const float sl2 = scale * kLog2e;
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    const uint32_t sq = smem_u32(sm.stat(0) + cw * kTile), sdo = smem_u32(sm.stat(1) + cw * kTile);
    mbar_wait(sm.stat_full(), 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      mbar_wait(sm.full(s), (j / kStages) & 1);
      const uint32_t sk = smem_u32(sm.stage(s, 0)), sv = smem_u32(sm.stage(s, 1));
      float sc[32], dp[32];
      gemm_abt(sc, sq, sk);   // q·kᵀ
      gemm_abt(dp, sdo, sv);  // dO·vᵀ
      wgmma_wait<1>();
      fence_operands(sc);
      const int c0 = j * kRows + (lane % 4) * 2;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = c0 + (i / 4) * 8 + (i & 1);
        sc[i] = col < kv_len ? fast_exp2(fmaf(sc[i], sl2, -lse2[(i >> 1) & 1])) : 0.f;
      }
      wgmma_wait<0>();
      fence_operands(dp);
      uint32_t da[4][4];
#pragma unroll
      for (int i = 0; i < 32; ++i) dp[i] = sc[i] * (dp[i] - dl[(i >> 1) & 1]) * scale;  // ds
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) acc_to_a(da[kk], dp, kk);
      fence_operands(acc);
      fence_operands(da);
      wgmma_fence();
      gemm_pb(acc, da, sk);  // dq += ds·k
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(acc);
      fence_operands(da);
      __syncwarp();
      if (lane == 0) mbar_arrive(sm.empty(s));
    }
    store_acc(dq_bh, acc, row_a, Lq, ld, lane);
  }
}

__global__ void __launch_bounds__(kThreadsWS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv,
                     const int* __restrict__ kv_lens, int Lq, int Lk, int N, float scale) {
  const int h = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * kStationary;
  const int ld = N * D;
  int kv_len = kv_lens != nullptr ? kv_lens[b] : Lk;
  kv_len = min(max(kv_len, 0), Lk);
  const size_t kv_off = static_cast<size_t>(b) * Lk * ld + static_cast<size_t>(h) * D;
  if (k0 >= kv_len) {  // no live key in this block: zero gradient
    zero_rows(dk + kv_off, k0, Lk, ld);
    zero_rows(dv + kv_off, k0, Lk, ld);
    return;
  }
  const int n_tiles = (Lq + kRows - 1) / kRows;
  const Smem sm = smem_layout();
  init_barriers(sm, 32);

  if (threadIdx.x < 128) {  // producer warpgroup: warp 0 stages LSE/delta, lane 0 the TMA
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      const float* lse_bh = lse + (static_cast<size_t>(b) * N + h) * Lq;
      const float* delta_bh = delta + (static_cast<size_t>(b) * N + h) * Lq;
      if (lane == 0) {
        mbar_arrive_expect_tx(sm.stat_full(), kStationaryBytes);
        load_stationary(sm, 0, &tk, h, k0, b);
        load_stationary(sm, 1, &tv, h, k0, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        mbar_wait(sm.empty(s), ((j / kStages) & 1) ^ 1);
        float* st = sm.stats(s);
        for (int i = lane; i < kRows; i += 32) {  // q rows past Lq: LSE = delta = 0
          const int row = j * kRows + i;
          st[i] = row < Lq ? lse_bh[row] * kLog2e : 0.f;
          st[kRows + i] = row < Lq ? delta_bh[row] : 0.f;
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(sm.full(s), kStageBytes);
          load_streamed(sm.stage(s, 0), &tq, sm.full(s), h, j * kRows, b);
          load_streamed(sm.stage(s, 1), &tdo, sm.full(s), h, j * kRows, b);
        } else {
          mbar_arrive(sm.full(s));
        }
      }
    }
  } else {  // consumer warpgroups: 64 KV rows each, the transposed view
    setmaxnreg_inc<kConsumerRegs>();
    const int cw = threadIdx.x / 128 - 1;
    const int t = threadIdx.x % 128, lane = t % 32;
    const int row_a = k0 + cw * kRows + (t / 32) * 16 + lane / 4;  // KV rows row_a, row_a + 8
    const bool live[2] = {row_a < kv_len, row_a + 8 < kv_len};
    const float sl2 = scale * kLog2e;
    float acc_k[64], acc_v[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc_k[i] = acc_v[i] = 0.f;
    const uint32_t sk = smem_u32(sm.stat(0) + cw * kTile), sv = smem_u32(sm.stat(1) + cw * kTile);
    mbar_wait(sm.stat_full(), 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      mbar_wait(sm.full(s), (j / kStages) & 1);
      const uint32_t sq = smem_u32(sm.stage(s, 0)), sdo = smem_u32(sm.stage(s, 1));
      const float* st = sm.stats(s);
      float pt[32], dst[32];
      gemm_abt(pt, sk, sq);    // sᵀ = k·qᵀ
      gemm_abt(dst, sv, sdo);  // dpᵀ = v·dOᵀ
      wgmma_wait<1>();
      fence_operands(pt);
      const int c0 = (lane % 4) * 2;  // this thread's q columns: c0 + 8·n8 + {0, 1}
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8) {
        const float2 l2 = *reinterpret_cast<const float2*>(st + c0 + n8 * 8);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = fast_exp2(fmaf(pt[4 * n8 + e], sl2, -((e & 1) ? l2.y : l2.x)));
          pt[4 * n8 + e] = live[e >> 1] ? p : 0.f;
        }
      }
      wgmma_wait<0>();
      fence_operands(dst);
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8) {
        const float2 dl = *reinterpret_cast<const float2*>(st + kRows + c0 + n8 * 8);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dst[4 * n8 + e] = pt[4 * n8 + e] * (dst[4 * n8 + e] - ((e & 1) ? dl.y : dl.x)) * scale;
      }
      uint32_t pa[4][4], da[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        acc_to_a(pa[kk], pt, kk);
        acc_to_a(da[kk], dst, kk);
      }
      fence_batch(acc_v, acc_k, pa, da);
      wgmma_fence();
      gemm_pb(acc_v, pa, sdo);  // dv += pᵀ·dO
      gemm_pb(acc_k, da, sq);   // dk += dsᵀ·q
      wgmma_commit();
      wgmma_wait<0>();
      fence_batch(acc_v, acc_k, pa, da);
      __syncwarp();
      if (lane == 0) mbar_arrive(sm.empty(s));
    }
    store_acc(dk + kv_off, acc_k, row_a, Lk, ld, lane);
    store_acc(dv + kv_off, acc_v, row_a, Lk, ld, lane);
  }
}

// the four operand maps of one launch; false if the CUDA driver refuses one
bool encode_maps(CUtensorMap (&maps)[4], const void* q, const void* k, const void* v,
                 const void* dout, int B, int Lq, int Lk, int N) {
  return encode_packed_map(&maps[0], q, B, Lq, N, kRows) &&
         encode_packed_map(&maps[1], k, B, Lk, N, kRows) &&
         encode_packed_map(&maps[2], v, B, Lk, N, kRows) &&
         encode_packed_map(&maps[3], dout, B, Lq, N, kRows);
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(kSmemBytes));
}

}  // namespace

// q/k/v/dout packed [B, L, N, 128] bf16 (16-byte aligned); lse/delta
// [B, N, Lq] f32; dq [B, Lq, N, 128] f32. kv_lens [B] int32 or null.
// Returns the CUDA error code (cudaErrorInvalidValue for a head dim other
// than 128 or operands the TMA cannot describe).
extern "C" int flash_bwd_dq_launch(const void* q, const void* k, const void* v, const void* dout,
                                   const void* lse, const void* delta, void* dq,
                                   const void* kv_lens, int B, int Lq, int Lk, int N,
                                   int head_dim, float scale, void* stream) {
  CUtensorMap maps[4];
  if (head_dim != D || !encode_maps(maps, q, k, v, dout, B, Lq, Lk, N))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = set_smem(flash_bwd_dq_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Lq + kStationary - 1) / kStationary, N, B);
  flash_bwd_dq_kernel<<<grid, kThreadsWS, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq), static_cast<const int*>(kv_lens),
      Lq, Lk, N, scale);
  return static_cast<int>(cudaGetLastError());
}

// as above; dk/dv [B, Lk, N, 128] f32.
extern "C" int flash_bwd_dkv_launch(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    void* dk, void* dv, const void* kv_lens, int B, int Lq,
                                    int Lk, int N, int head_dim, float scale, void* stream) {
  CUtensorMap maps[4];
  if (head_dim != D || !encode_maps(maps, q, k, v, dout, B, Lq, Lk, N))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = set_smem(flash_bwd_dkv_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Lk + kStationary - 1) / kStationary, N, B);
  flash_bwd_dkv_kernel<<<grid, kThreadsWS, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk), static_cast<float*>(dv),
      static_cast<const int*>(kv_lens), Lq, Lk, N, scale);
  return static_cast<int>(cudaGetLastError());
}
