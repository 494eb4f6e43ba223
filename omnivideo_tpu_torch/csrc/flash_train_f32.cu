// Flash-attention backward on f32 operands, CUDA C++ for sm_90a: the TF32
// tensor cores with a three-product split, held to f32. Two kernels, as the
// TPU's flash_bwd_core has (omnivideo_tpu/ops/pallas/flash_attention.py:640),
// for the calls whose q, k, v and dO are f32:
//
// - flash_bwd_dq_f32: replaces _fa_bwd_dq_kernel (:485, pallas_call at :670).
//   A block owns 64 q rows of one (b, head) and walks the keys up to kv_len
//   in tiles of 32: s = q·kᵀ from the UNSCALED q, p = exp(s·scale − LSE),
//   dp = dO·vᵀ, ds = p·(dp − delta)·scale, dq += ds·k.
// - flash_bwd_dkv_f32: replaces _fa_bwd_dkv_kernel (:530, pallas_call at
//   :691). A block owns 64 KV rows of one (b, head) and walks every q row in
//   tiles of 32: dv += pᵀ·dO, dk += dsᵀ·q. Blocks that start at or past
//   kv_len write zeros.
//
// With f32 operands the Pallas kernels take f32 products and their
// `ds.astype(k.dtype)` and `p.astype(do.dtype)` are no-ops, so p and ds stay
// f32; the ring backward of an f32 model (the SFT's `--sp`) runs them on
// every earlier shard. flash_train.cu (rows 4 and 5) reads bf16 and rounds p
// and ds to bf16; this file is the same contract with f32-accurate products:
// packed [B, L, N·D] rows (D = 128), the natural-log LSE and delta [B, N, Lq]
// f32, keys past kv_len (kv_lens [B] or null) giving p = 0, dq, dk and dv
// written once each in f32 (every run gives the same bits), and zero rows for
// a batch row without keys (dq) and for KV rows past kv_len (dk, dv). The
// plain twin is flash_bwd_plain on f32 inputs.
//
// Arithmetic. Every product is a three-product split on the TF32 tensor
// cores (hopper_common.cuh tf32_split, as ring_step_f32.cu): x = hi + lo,
// a·b ≈ a_lo·b_hi + a_hi·b_lo + a_hi·b_hi summed in f32. p and ds are split
// in registers before their products (tf32_frags), never rounded to bf16.
// The tensor cores round their f32 accumulator toward zero at each k8 step,
// so a gradient carried through them over many tiles would drift one way:
// each tile's product (12 k8 steps, a quarter of the 128 columns at a time)
// starts from zero and is added to the f32 register sum by a rounded add, as
// ring_step_f32.cu folds P·V (tests/test_torch_flash_bwd_f32_split.py
// emulates this arithmetic, tile order and index maps on the CPU).
//
// Operand layout. wgmma on tf32 reads A and B K-major only (no transpose
// bit). s = q·kᵀ and dp = dO·vᵀ (dsᵀ = k·qᵀ and dpᵀ = v·dOᵀ in dk/dv) reduce
// over D and read every operand in its natural row layout. The gradient
// products reduce over keys (dq: ds·k) or q rows (dk/dv: pᵀ·dO, dsᵀ·q), so
// their B operand is staged transposed: 128 rows of 32 keys (or q rows),
// each at its tf32_key_pos position, so the 64 x 32 accumulator of p or ds
// is already the A fragment of the product. The stationary side (q and dO,
// or k and v: 64 rows each) is split once into hi and lo K-major tiles; the
// products are SS (s, dp) and RS (the gradients).
//
// Design: a simple first form. A block is one warpgroup (128 threads). One
// thread loads every tile by TMA (f32 maps over the packed layout, 32-column
// boxes, the 128-byte swizzle; zeros past L) onto an mbarrier; the whole
// block then splits the tile (keys or rows past the valid length as zeros:
// whatever those rows hold adds nothing) and runs the products, with
// __syncthreads between the two. Shared memory, 224 KiB: dq holds q and dO
// hi/lo (128 KiB; TMA writes the raw rows into the hi tiles, split in place)
// and per tile k hi/lo, v hi/lo and kᵀ hi/lo (96 KiB); the next k and v land
// in their hi tiles once s and dp are done, under the dq product. dk/dv
// holds k and v hi/lo (128 KiB), per tile q and dO hi/lo (64 KiB), whose
// space takes qᵀ and dOᵀ hi/lo once sᵀ and dpᵀ are done, and the raw q and
// dO (32 KiB), which take the next tile under the dk and dv products. One
// block per SM; the transposed stores put a lane on each row, so a warp's
// stores hit 32 banks. Measured on the H100 (PERF.md): at the 4-card SFT
// step's earlier shards, [2, 512, 32, 128], dq 0.24 ms and dk/dv 0.37 ms
// against bounds of 0.078 and 0.104, and f32 SDPA's backward 0.83 ms.
//
// Bound on the H100: operations, 3 TF32 products of 6·B·N·Lq·Lk·D (dq) and
// 8·B·N·Lq·Lk·D (dk/dv) FLOPs at the tensor cores' 495 TFLOP/s, over the
// (row, key) pairs below kv_len; the bytes (q, k, v, dO read once, the
// gradients written once, f32) take less at the SFT's shapes.

#include <math.h>

#include "hopper_common.cuh"

namespace {

constexpr int kD = 128;
constexpr int kRows = 64;      // stationary rows per block (one warpgroup's M)
constexpr int kTileRows = 32;  // streamed rows (keys or q rows) per tile
constexpr int kThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;

constexpr uint32_t kRowBytes = 128;                  // a swizzled row: 32 f32
constexpr uint32_t kSPanel = kRows * kRowBytes;      // 64 rows x 32 columns, 8 KiB
constexpr uint32_t kSTile = 4 * kSPanel;             // 64 rows x 128 columns, 32 KiB
constexpr uint32_t kTPanel = kTileRows * kRowBytes;  // 32 rows x 32 columns, 4 KiB
constexpr uint32_t kTTile = 4 * kTPanel;             // 32 rows x 128 columns, 16 KiB
constexpr uint32_t kTrTile = kD * kRowBytes;         // 128 columns x 32 rows, 16 KiB
static_assert(kTTile == kTrTile, "a transposed tile takes a K-major tile's place");

// dq: q hi/lo, dO hi/lo; per tile k hi/lo, v hi/lo, kᵀ hi/lo (TMA writes the
// raw q, dO, k and v into their hi tiles, split in place); two mbarriers
constexpr uint32_t kStream = 4 * kSTile;
constexpr uint32_t kDqBars = kStream + 6 * kTTile;
// dk/dv: k hi/lo, v hi/lo; per tile q hi/lo and dO hi/lo, then qᵀ and dOᵀ
// hi/lo; the raw q and dO tiles as TMA wrote them; two mbarriers
constexpr uint32_t kDkvRaw = kStream + 4 * kTTile;
constexpr uint32_t kDkvBars = kDkvRaw + 2 * kTTile;
constexpr size_t kDqSmem = kDqBars + 2 * sizeof(uint64_t) + 1024;  // + align
constexpr size_t kDkvSmem = kDkvBars + 2 * sizeof(uint64_t) + 1024;
static_assert(kDqSmem <= 232448 && kDkvSmem <= 232448, "the tiles fit a block's shared memory");

// a split operand in shared memory: hi and lo, same layout
struct Split {
  unsigned char* hi;
  unsigned char* lo;
};

__device__ __forceinline__ unsigned char* smem_base() {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t a = smem_u32(smem_raw);
  return smem_raw + (((a + 1023) & ~1023u) - a);
}

// byte offset of (row r, 16-byte chunk c < 32) in a K-major tile of R rows:
// panel c / 8 holds columns 32(c / 8)..+31, the chunk swizzled by the row
template <int R>
__device__ __forceinline__ uint32_t kmajor_off(int r, int c) {
  return (c >> 3) * (R * kRowBytes) + r * kRowBytes + ((((c & 7) ^ r) & 7) << 4);
}

// Rows row0..row0 + R − 1 of a raw K-major tile (`raw`, as TMA wrote it;
// rows at or past n read as zeros) split into hi and lo: as a K-major tile
// (KM; its hi may be `raw` itself, split in place) and/or transposed into
// 128 x 32 panels at tf32_key_pos positions (TR, R = 32). The whole block
// takes part, a thread a 16-byte chunk c of row r at a time: without TR a
// warp takes one row, with TR a lane takes a row and warp w the chunks w,
// w + 4, ..., so a warp's transposed stores write 32 positions of one
// panel row, on 32 banks.
template <int R, bool KM, bool TR>
__device__ __forceinline__ void split_tile(const unsigned char* raw, int row0, int n, Split km,
                                           Split tr) {
  static_assert(!TR || R == kTileRows, "transposed panels hold one tile");
  constexpr int kChunks = kD / 4;
#pragma unroll
  for (int it = 0; it < R * kChunks / kThreads; ++it) {
    const int i = it * kThreads + threadIdx.x;
    const int r = TR ? threadIdx.x % 32 : i / kChunks;
    const int c = TR ? threadIdx.x / 32 + (kThreads / 32) * it : i % kChunks;
    const uint32_t off = kmajor_off<R>(r, c);
    const float4 x = row0 + r < n ? *reinterpret_cast<const float4*>(raw + off)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
    float4 lo;
    const float4 hi = tf32_split4(x, lo);
    if (KM) {
      *reinterpret_cast<float4*>(km.hi + off) = hi;
      *reinterpret_cast<float4*>(km.lo + off) = lo;
    }
    if (TR) {
      const int pos = tf32_key_pos(r);
      const float h[4] = {hi.x, hi.y, hi.z, hi.w}, l[4] = {lo.x, lo.y, lo.z, lo.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t o = swz128(4 * c + e, pos);
        *reinterpret_cast<float*>(tr.hi + o) = h[e];
        *reinterpret_cast<float*>(tr.lo + o) = l[e];
      }
    }
  }
}

// one R-row tile of head h, rows from row0, of batch row b: its four
// 32-column panels by TMA onto `bar`
template <int R>
__device__ __forceinline__ void tma_tile(unsigned char* dst, const CUtensorMap* map, uint64_t* bar,
                                         int h, int row0, int b) {
#pragma unroll
  for (int p = 0; p < 4; ++p) tma_load(dst + p * R * kRowBytes, map, bar, 32 * p, h, row0, b);
}

// d (64 x 32) = A·Bᵀ over D to f32 accuracy, a_lo·b_hi + a_hi·b_lo +
// a_hi·b_hi (the small terms first): A a 64-row split K-major tile, B a
// 32-row one. Issued, not committed.
__device__ __forceinline__ void gemm_abt(float (&d)[16], Split a, Split b) {
  constexpr uint32_t hi = wgmma_desc_hi(kKMajorSbo);
  uint32_t ah = smem_u32(a.hi), al = smem_u32(a.lo), bh = smem_u32(b.hi), bl = smem_u32(b.lo);
  // the addresses pass an empty asm at each call, so the compiler derives the
  // descriptors here rather than holding all of them across the tile loop
  asm volatile("" : "+r"(ah), "+r"(al), "+r"(bh), "+r"(bl));
  ah = wgmma_desc_lo(ah, 16), al = wgmma_desc_lo(al, 16);
  bh = wgmma_desc_lo(bh, 16), bl = wgmma_desc_lo(bl, 16);
#pragma unroll
  for (int kk = 0; kk < 16; ++kk)
    wgmma_tf32_ss_n32(d, wgmma_desc(al + (((kk >> 2) * kSPanel + (kk & 3) * 32) >> 4), hi),
                      wgmma_desc(bh + (((kk >> 2) * kTPanel + (kk & 3) * 32) >> 4), hi), kk > 0);
#pragma unroll
  for (int kk = 0; kk < 16; ++kk)
    wgmma_tf32_ss_n32(d, wgmma_desc(ah + (((kk >> 2) * kSPanel + (kk & 3) * 32) >> 4), hi),
                      wgmma_desc(bl + (((kk >> 2) * kTPanel + (kk & 3) * 32) >> 4), hi), 1);
#pragma unroll
  for (int kk = 0; kk < 16; ++kk)
    wgmma_tf32_ss_n32(d, wgmma_desc(ah + (((kk >> 2) * kSPanel + (kk & 3) * 32) >> 4), hi),
                      wgmma_desc(bh + (((kk >> 2) * kTPanel + (kk & 3) * 32) >> 4), hi), 1);
}

// acc (64 x 128) += X·B to f32 accuracy, X (64 x 32) the f32 accumulator x
// of p or ds, B the transposed panels (128 columns x 32 rows of the tile). A
// quarter of the columns at a time: the tile's product from zero (12 k8
// steps), added to acc by a rounded add.
__device__ __forceinline__ void gemm_fold(float (&acc)[64], const float (&x)[16], Split bt) {
  constexpr uint32_t hi = wgmma_desc_hi(kKMajorSbo);
  uint32_t bh = smem_u32(bt.hi), bl = smem_u32(bt.lo);
  asm volatile("" : "+r"(bh), "+r"(bl));  // as in gemm_abt
  bh = wgmma_desc_lo(bh, 16), bl = wgmma_desc_lo(bl, 16);
  uint32_t xh[4][4], xl[4][4];
  tf32_frags(x, xh, xl);
  fence_operands(xh);
  fence_operands(xl);
#pragma unroll
  for (int qt = 0; qt < 4; ++qt) {
    float pv[16];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t off = (qt * 32 * kRowBytes + kk * 32) >> 4;
      wgmma_tf32_rs_n32(pv, xl[kk], wgmma_desc(bh + off, hi), kk > 0);
      wgmma_tf32_rs_n32(pv, xh[kk], wgmma_desc(bl + off, hi), 1);
      wgmma_tf32_rs_n32(pv, xh[kk], wgmma_desc(bh + off, hi), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(pv);
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[16 * qt + i] += pv[i];
  }
  fence_operands(xh);
  fence_operands(xl);
}

struct Maps {  // the f32 packed operands, stationary boxes of kRows rows, streamed of kTileRows
  CUtensorMap q, k, v, dout;
};

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;
  const float* lse;
  const float* delta;
  const int* kv_lens;
  int Lq, Lk, N;
  float scale;
};

__device__ __forceinline__ int kv_len_of(const Args& a, int b) {
  const int len = a.kv_lens != nullptr ? a.kv_lens[b] : a.Lk;
  return min(max(len, 0), a.Lk);
}

__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_f32_kernel(const __grid_constant__ Maps maps, const Args a, float* __restrict__ dq) {
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * kRows;
  const int ld = a.N * kD;
  const int kv_len = kv_len_of(a, b);
  const size_t q_off = static_cast<size_t>(b) * a.Lq * ld + static_cast<size_t>(h) * kD;
  if (kv_len == 0) {  // no key: zero gradient
    zero_head_rows(dq + q_off, q0, kRows, a.Lq, ld);
    return;
  }
  unsigned char* sm = smem_base();
  const Split q{sm, sm + kSTile}, dO{sm + 2 * kSTile, sm + 3 * kSTile};
  const Split k{sm + kStream, sm + kStream + kTTile};
  const Split v{sm + kStream + 2 * kTTile, sm + kStream + 3 * kTTile};
  const Split kt{sm + kStream + 4 * kTTile, sm + kStream + 5 * kTTile};
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + kDqBars);  // stationary, streamed
  const int n_tiles = (kv_len + kTileRows - 1) / kTileRows;
  if (threadIdx.x == 0) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(&bars[0], 2 * kSTile);
    tma_tile<kRows>(q.hi, &maps.q, &bars[0], h, q0, b);
    tma_tile<kRows>(dO.hi, &maps.dout, &bars[0], h, q0, b);
    mbar_arrive_expect_tx(&bars[1], 2 * kTTile);
    tma_tile<kTileRows>(k.hi, &maps.k, &bars[1], h, 0, b);
    tma_tile<kTileRows>(v.hi, &maps.v, &bars[1], h, 0, b);
  }
  mbar_wait(&bars[0], 0);  // rows past Lq: TMA's zeros
  split_tile<kRows, true, false>(q.hi, q0, a.Lq, q, q);
  split_tile<kRows, true, false>(dO.hi, q0, a.Lq, dO, dO);

  const int t = threadIdx.x, lane = t % 32;
  const int row_a = q0 + (t / 32) * 16 + lane / 4;  // this thread's rows: row_a, row_a + 8
  const float* lse_bh = a.lse + (static_cast<size_t>(b) * a.N + h) * a.Lq;
  const float* delta_bh = a.delta + (static_cast<size_t>(b) * a.N + h) * a.Lq;
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + r * 8;
    lse2[r] = row < a.Lq ? lse_bh[row] * kLog2e : 0.f;
    dl[r] = row < a.Lq ? delta_bh[row] : 0.f;
  }
  const float sl2 = a.scale * kLog2e;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int j = 0; j < n_tiles; ++j) {
    const int kv0 = j * kTileRows;
    if (j > 0) __syncthreads();  // every warp's products of the last tile are done
    mbar_wait(&bars[1], j & 1);
    split_tile<kTileRows, true, true>(k.hi, kv0, kv_len, k, kt);  // keys past kv_len: zeros
    split_tile<kTileRows, true, false>(v.hi, kv0, kv_len, v, v);
    fence_proxy_async();  // the generic writes before wgmma reads them
    __syncthreads();
    float sc[16], dp[16];
    wgmma_fence();
    gemm_abt(sc, q, k);   // q·kᵀ
    gemm_abt(dp, dO, v);  // dO·vᵀ
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(sc);
    fence_operands(dp);
    __syncthreads();  // every warp's products have read k and v: the next tile's loads start
    if (threadIdx.x == 0 && j + 1 < n_tiles) {
      mbar_arrive_expect_tx(&bars[1], 2 * kTTile);
      tma_tile<kTileRows>(k.hi, &maps.k, &bars[1], h, kv0 + kTileRows, b);
      tma_tile<kTileRows>(v.hi, &maps.v, &bars[1], h, kv0 + kTileRows, b);
    }
    // entry i: row row_a + 8((i >> 1) & 1), key kv0 + 8(i / 4) + 2(lane % 4) + (i & 1)
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int col = kv0 + (i / 4) * 8 + (lane % 4) * 2 + (i & 1);
      const int r = (i >> 1) & 1;
      const float p = col < kv_len ? exp2f(fmaf(sc[i], sl2, -lse2[r])) : 0.f;
      dp[i] = p * (dp[i] - dl[r]) * a.scale;  // ds
    }
    gemm_fold(acc, dp, kt);  // dq += ds·k
  }
  store_head_rows(dq + q_off, acc, row_a, a.Lq, ld, lane);
}

__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_f32_kernel(const __grid_constant__ Maps maps, const Args a, float* __restrict__ dk,
                         float* __restrict__ dv) {
  const int h = blockIdx.y, b = blockIdx.z, k0 = blockIdx.x * kRows;
  const int ld = a.N * kD;
  const int kv_len = kv_len_of(a, b);
  const size_t k_off = static_cast<size_t>(b) * a.Lk * ld + static_cast<size_t>(h) * kD;
  if (k0 >= kv_len) {  // no live key in this block: zero gradient
    zero_head_rows(dk + k_off, k0, kRows, a.Lk, ld);
    zero_head_rows(dv + k_off, k0, kRows, a.Lk, ld);
    return;
  }
  unsigned char* sm = smem_base();
  const Split k{sm, sm + kSTile}, v{sm + 2 * kSTile, sm + 3 * kSTile};
  const Split q{sm + kStream, sm + kStream + kTTile};
  const Split dO{sm + kStream + 2 * kTTile, sm + kStream + 3 * kTTile};
  const Split& qt = q;    // qᵀ and dOᵀ take the tile's place once sᵀ and dpᵀ are done
  const Split& dOt = dO;
  unsigned char* q_raw = sm + kDkvRaw;
  unsigned char* do_raw = sm + kDkvRaw + kTTile;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + kDkvBars);  // stationary, streamed
  const int n_tiles = (a.Lq + kTileRows - 1) / kTileRows;
  if (threadIdx.x == 0) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(&bars[0], 2 * kSTile);
    tma_tile<kRows>(k.hi, &maps.k, &bars[0], h, k0, b);
    tma_tile<kRows>(v.hi, &maps.v, &bars[0], h, k0, b);
    mbar_arrive_expect_tx(&bars[1], 2 * kTTile);
    tma_tile<kTileRows>(q_raw, &maps.q, &bars[1], h, 0, b);
    tma_tile<kTileRows>(do_raw, &maps.dout, &bars[1], h, 0, b);
  }
  mbar_wait(&bars[0], 0);
  split_tile<kRows, true, false>(k.hi, k0, kv_len, k, k);  // rows past kv_len: zeros
  split_tile<kRows, true, false>(v.hi, k0, kv_len, v, v);

  const int t = threadIdx.x, lane = t % 32;
  const int row_a = k0 + (t / 32) * 16 + lane / 4;  // this thread's KV rows: row_a, row_a + 8
  const bool live[2] = {row_a < kv_len, row_a + 8 < kv_len};
  const float* lse_bh = a.lse + (static_cast<size_t>(b) * a.N + h) * a.Lq;
  const float* delta_bh = a.delta + (static_cast<size_t>(b) * a.N + h) * a.Lq;
  const float sl2 = a.scale * kLog2e;
  float acc_k[64], acc_v[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc_k[i] = acc_v[i] = 0.f;
  for (int j = 0; j < n_tiles; ++j) {
    const int q0 = j * kTileRows;
    if (j > 0) __syncthreads();  // every warp's products of the last tile are done
    mbar_wait(&bars[1], j & 1);  // q rows past Lq: TMA's zeros
    split_tile<kTileRows, true, false>(q_raw, q0, a.Lq, q, q);
    split_tile<kTileRows, true, false>(do_raw, q0, a.Lq, dO, dO);
    fence_proxy_async();
    __syncthreads();
    float pt[16], dst[16];
    wgmma_fence();
    gemm_abt(pt, k, q);    // sᵀ = k·qᵀ
    gemm_abt(dst, v, dO);  // dpᵀ = v·dOᵀ
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(pt);
    fence_operands(dst);
    // entry i: KV row row_a + 8((i >> 1) & 1), q row q0 + 8(i / 4) + 2(lane % 4) + (i & 1);
    // a q row past Lq takes LSE = +inf, so its p is 0
    float l2[8], dl[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = q0 + (c / 2) * 8 + (lane % 4) * 2 + (c & 1);
      l2[c] = col < a.Lq ? lse_bh[col] * kLog2e : INFINITY;
      dl[c] = col < a.Lq ? delta_bh[col] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int c = (i / 4) * 2 + (i & 1);
      const float p = live[(i >> 1) & 1] ? exp2f(fmaf(pt[i], sl2, -l2[c])) : 0.f;
      pt[i] = p;
      dst[i] = p * (dst[i] - dl[c]) * a.scale;  // dsᵀ
    }
    __syncthreads();  // every warp's products have read the tiles: their space takes the panels
    split_tile<kTileRows, false, true>(q_raw, q0, a.Lq, qt, qt);
    split_tile<kTileRows, false, true>(do_raw, q0, a.Lq, dOt, dOt);
    fence_proxy_async();
    __syncthreads();  // the raw tiles are read: the next tile's loads start
    if (threadIdx.x == 0 && j + 1 < n_tiles) {
      mbar_arrive_expect_tx(&bars[1], 2 * kTTile);
      tma_tile<kTileRows>(q_raw, &maps.q, &bars[1], h, q0 + kTileRows, b);
      tma_tile<kTileRows>(do_raw, &maps.dout, &bars[1], h, q0 + kTileRows, b);
    }
    gemm_fold(acc_v, pt, dOt);  // dv += pᵀ·dO
    gemm_fold(acc_k, dst, qt);  // dk += dsᵀ·q
  }
  store_head_rows(dk + k_off, acc_k, row_a, a.Lk, ld, lane);
  store_head_rows(dv + k_off, acc_v, row_a, a.Lk, ld, lane);
}

// the launch's arguments; false where the kernels cannot take the operands
bool make_args(Args& a, const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, const void* kv_lens, int Lq, int Lk, int N,
               int head_dim, float scale) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout);
  if (bits % 16 != 0) return false;
  a = Args{static_cast<const float*>(q),     static_cast<const float*>(k),
           static_cast<const float*>(v),     static_cast<const float*>(dout),
           static_cast<const float*>(lse),   static_cast<const float*>(delta),
           static_cast<const int*>(kv_lens), Lq, Lk, N, scale};
  return head_dim == kD;
}

}  // namespace

// q/dout [B, Lq, N, 128] and k/v [B, Lk, N, 128] packed f32 (16-byte
// aligned); lse/delta [B, N, Lq] f32; dq [B, Lq, N, 128] f32. kv_lens [B]
// int32 or null. Returns the CUDA error code (cudaErrorInvalidValue for a
// head dim other than 128 or an unaligned operand).
extern "C" int flash_bwd_dq_f32_launch(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       void* dq, const void* kv_lens, int B, int Lq, int Lk,
                                       int N, int head_dim, float scale, void* stream) {
  Args a;
  Maps maps;
  if (!make_args(a, q, k, v, dout, lse, delta, kv_lens, Lq, Lk, N, head_dim, scale) ||
      !encode_packed_map_f32(&maps.q, q, B, Lq, N, kRows) ||
      !encode_packed_map_f32(&maps.dout, dout, B, Lq, N, kRows) ||
      !encode_packed_map_f32(&maps.k, k, B, Lk, N, kTileRows) ||
      !encode_packed_map_f32(&maps.v, v, B, Lk, N, kTileRows))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kDqSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Lq + kRows - 1) / kRows, N, B);
  flash_bwd_dq_f32_kernel<<<grid, kThreads, kDqSmem, static_cast<cudaStream_t>(stream)>>>(
      maps, a, static_cast<float*>(dq));
  return static_cast<int>(cudaGetLastError());
}

// as above; dk/dv [B, Lk, N, 128] f32.
extern "C" int flash_bwd_dkv_f32_launch(const void* q, const void* k, const void* v,
                                        const void* dout, const void* lse, const void* delta,
                                        void* dk, void* dv, const void* kv_lens, int B, int Lq,
                                        int Lk, int N, int head_dim, float scale, void* stream) {
  Args a;
  Maps maps;
  if (!make_args(a, q, k, v, dout, lse, delta, kv_lens, Lq, Lk, N, head_dim, scale) ||
      !encode_packed_map_f32(&maps.q, q, B, Lq, N, kTileRows) ||
      !encode_packed_map_f32(&maps.dout, dout, B, Lq, N, kTileRows) ||
      !encode_packed_map_f32(&maps.k, k, B, Lk, N, kRows) ||
      !encode_packed_map_f32(&maps.v, v, B, Lk, N, kRows))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kDkvSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Lk + kRows - 1) / kRows, N, B);
  flash_bwd_dkv_f32_kernel<<<grid, kThreads, kDkvSmem, static_cast<cudaStream_t>(stream)>>>(
      maps, a, static_cast<float*>(dk), static_cast<float*>(dv));
  return static_cast<int>(cudaGetLastError());
}
