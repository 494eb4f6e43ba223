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
// a·b ≈ a_lo·b_hi + a_hi·b_lo + a_hi·b_hi summed in f32. p and ds (pᵀ, dsᵀ)
// are split into hi and lo before their products, never rounded to bf16.
// The tensor cores round their f32 accumulator toward zero at each k8 step,
// so a gradient carried through them over many tiles would drift one way:
// each tile's product (12 k8 steps, 64 columns of Gᵀ at a time) starts from
// zero and is added to the f32 register sum by a rounded add, as
// ring_step_f32.cu folds P·V (tests/test_torch_flash_bwd_f32_split.py
// emulates this arithmetic, the data flow between the warpgroups, tile order
// and index maps on the CPU).
//
// Operand layout. wgmma on tf32 reads A and B K-major only (no transpose
// bit). s = q·kᵀ and dp = dO·vᵀ (sᵀ = k·qᵀ and dpᵀ = v·dOᵀ in dk/dv) reduce
// over D and read every operand in its natural row layout. The gradient
// products reduce over the tile's keys (dq) or q rows (dk/dv), so they are
// taken transposed, Gᵀ (D rows x the block's 64 rows) += Xᵀ·Yᵀ: A = Xᵀ, the
// split streamed tile (kᵀ; dOᵀ for dv, qᵀ for dk), read by each consumer
// thread into its register fragments straight from the natural tile
// (frags_t), and B = ds, pᵀ or dsᵀ, which the consumers write split into a
// K-major 64 x 32 panel. Nothing is staged transposed.
//
// Design: warp-specialised, in ring_step_f32.cu's form. 384 threads: a
// producer warpgroup (setmaxnreg 40) and two consumer warpgroups (232) on the
// same 64 stationary rows, one per stationary operand. Producer warp 0 loads
// the two stationary tiles once and keeps two stages of streamed tiles in
// flight by TMA (f32 maps over the packed layout, 32-column boxes, the
// 128-byte swizzle; zeros past L; full / ready / empty mbarriers); warps 1-3
// split each streamed tile in place once it lands, a lane a row: hi over
// TMA's raw rows, lo beside it, keys past kv_len as zeros. A consumer splits
// its stationary tile once: hi into 64 registers of A fragments, lo back in
// place, so s (or dp) is one SS and two RS terms, 48 m64n32k8 a tile. The
// consumers issue wgmma and do the p/ds arithmetic only, and hand p, dp or
// pᵀ to each other through shared memory and named barriers. Each tile's
// fold is 12 m64n64k8 steps from zero, added to the f32 sum by a rounded add.
//
// - dq: warpgroup 0 holds q_hi and computes s and p, warpgroup 1 holds dO_hi
//   and computes dp; they swap p and dp, both form the same ds, 0 writes its
//   hi and 1 its lo into the B panel, and each folds dqᵀ for 64 of the 128 D
//   rows. Shared memory, 224 KiB: q and dO lo (64), two stages of k and v
//   hi/lo (128), the swap (16), the ds panel (16).
// - dk/dv: warpgroup 0 holds k_hi, computes sᵀ → pᵀ, writes it split and
//   folds dvᵀ += dOᵀ·pᵀ; warpgroup 1 holds v_hi, computes dpᵀ, reads pᵀ back
//   as hi + lo (2^-22 of p off p), forms dsᵀ and folds dkᵀ += qᵀ·dsᵀ. Each
//   keeps one 64-register accumulator (two D blocks of 64) and issues 96
//   wgmma a tile. Shared memory, 224 KiB: k and v lo (64), two stages of q
//   and dO hi/lo (128), the pᵀ and dsᵀ panels (32).
//
// A stage is released by the 8 consumer warps once the products and the
// fragments have read it. mbarrier.arrive (and bar.arrive) does not wait
// for the thread's shared-memory loads in flight; ptxas issues the
// fragments' loads right before it, and a stage released under them was
// rewritten by the next tile's TMA and split (dk's columns of two warps off
// by up to 5e-2 in some runs): each warp fences its own loads first.
//
// Measured on the H100 (PERF.md, rows 4 (f32) and 5 (f32)): at the 4-card
// SFT step's earlier shards, [2, 512, 32, 128], dq 0.219 ms and dk/dv 0.266
// against bounds of 0.078 and 0.104 (36% and 39%), and f32 SDPA's backward
// 0.795. What holds them, measured by leaving parts out: the consumers'
// lock-stepped hand-overs (barriers, the swap, the fragment loads), not the
// products.
//
// Bound on the H100: operations, 3 TF32 products of 6·B·N·Lq·Lk·D (dq) and
// 8·B·N·Lq·Lk·D (dk/dv) FLOPs at the tensor cores' 495 TFLOP/s, over the
// (row, key) pairs below kv_len; the bytes (q, k, v, dO read once, the
// gradients written once, f32) take less at the SFT's shapes.

#include <math.h>

#include "hopper_common.cuh"

namespace {

constexpr int kD = 128;
constexpr int kRows = 64;       // stationary rows per block (each consumer's M)
constexpr int kTileRows = 32;   // streamed rows (keys or q rows) per tile
constexpr int kStages = 2;      // streamed tiles in flight
constexpr int kThreads = 384;   // producer warpgroup + two consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr int kPrepWarps = 3;   // producer warps 1-3
constexpr int kProducerRegs = 40;  // 128·40 + 256·232 = 384·168
constexpr int kConsumerRegs = 232;
constexpr float kLog2e = 1.4426950408889634f;
// named barriers (0 is __syncthreads): the consumers' hand-overs over 256
// threads, and a consumer warpgroup's own over 128
constexpr int kSwapBar = 1, kOperandBar = 2, kSplitBar = 3;  // 3, 4: one a warpgroup
constexpr int kOwnBar = 5;

constexpr uint32_t kRowBytes = 128;                  // a swizzled row: 32 f32
constexpr uint32_t kSPanel = kRows * kRowBytes;      // 64 rows x 32 columns, 8 KiB
constexpr uint32_t kSTile = 4 * kSPanel;             // 64 rows x 128 columns, 32 KiB
constexpr uint32_t kTPanel = kTileRows * kRowBytes;  // 32 rows x 32 columns, 4 KiB
constexpr uint32_t kTTile = 4 * kTPanel;             // 32 rows x 128 columns, 16 KiB
constexpr uint32_t kStage = 4 * kTTile;              // two streamed operands, hi and lo
// shared memory of both kernels: the two stationary tiles (raw, then lo;
// consumer 0 and 1), kStages stages, two pairs of 64 x 32 panels (dq: p and
// dp, then ds hi and lo; dk/dv: pᵀ hi and lo, dsᵀ hi and lo), the mbarriers
constexpr uint32_t kStages0 = 2 * kSTile;
constexpr uint32_t kPairs = kStages0 + kStages * kStage;
constexpr uint32_t kBarOff = kPairs + 4 * kSPanel;
constexpr size_t kSmemBytes = kBarOff + (1 + 3 * kStages) * sizeof(uint64_t) + 1024;  // + align
static_assert(kSmemBytes <= 232448, "the tiles fit a block's shared memory");

struct Smem {
  unsigned char* base;  // 1024-byte aligned
  __device__ unsigned char* stat(int cw) const { return base + cw * kSTile; }
  __device__ unsigned char* stage(int s) const { return base + kStages0 + s * kStage; }
  __device__ unsigned char* pair(int i) const { return base + kPairs + i * 2 * kSPanel; }
  __device__ uint64_t* bar(int i) const { return reinterpret_cast<uint64_t*>(base + kBarOff) + i; }
  __device__ uint64_t* stat_full() const { return bar(0); }
  __device__ uint64_t* full(int s) const { return bar(1 + s); }    // TMA's raw rows landed
  __device__ uint64_t* ready(int s) const { return bar(3 + s); }   // split in place
  __device__ uint64_t* empty(int s) const { return bar(5 + s); }   // the consumers read it
};

__device__ __forceinline__ Smem smem_layout() {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t a = smem_u32(smem_raw);
  return Smem{smem_raw + (((a + 1023) & ~1023u) - a)};
}

// byte offset of (row r, 16-byte chunk c < 32) in a K-major streamed tile:
// panel c / 8 holds columns 32(c / 8)..+31, the chunk swizzled by the row
__device__ __forceinline__ uint32_t kmajor_off(int r, int c) {
  return (c >> 3) * kTPanel + r * kRowBytes + ((((c & 7) ^ r) & 7) << 4);
}

// One streamed operand's preparation by producer warp w (of kPrepWarps), a
// lane a row, the warp taking the 16-byte chunks w, w + 3, ...: row `lane`
// of the raw K-major tile at `hi` (as TMA wrote it; zeros where !live) split
// into hi in place and lo in the tile after it.
__device__ __forceinline__ void split_rows(unsigned char* hi, int lane, int w, bool live) {
  for (int c = w; c < kD / 4; c += kPrepWarps) {
    const uint32_t off = kmajor_off(lane, c);
    float4* x = reinterpret_cast<float4*>(hi + off);
    float4 lo;
    *x = tf32_split4(live ? *x : make_float4(0.f, 0.f, 0.f, 0.f), lo);
    *reinterpret_cast<float4*>(hi + kTTile + off) = lo;
  }
}

// This thread's share of a consumer's stationary tile (64 rows x 128, K-major
// as TMA wrote it; rows from row0, those at or past n as zeros): hi to the A
// fragments of the 16 k8 steps (a[kk]: rows r0, r0 + 8, columns 8kk + t,
// 8kk + t + 4), lo back in place, so the tile holds the lo half.
__device__ __forceinline__ void split_stationary(uint32_t (&a)[16][4], unsigned char* tile, int r0,
                                                 int t, int row0, int n) {
#pragma unroll
  for (int kk = 0; kk < 16; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + 8 * (e & 1), c = 8 * (kk & 3) + t + 4 * (e >> 1);
      float* p = reinterpret_cast<float*>(tile + (kk >> 2) * kSPanel + swz128(r, c));
      float hi, lo;
      tf32_split(row0 + r < n ? *p : 0.f, hi, lo);
      a[kk][e] = __float_as_uint(hi);
      *p = lo;
    }
  }
}

// The A fragments (hi, lo) of the 4 k8 steps of a product whose A is a split
// streamed tile X (32 rows x 128, K-major, hi at `x`, lo a tile after it)
// transposed: A = Xᵀ, this thread's rows d0 and d0 + 8 of the 128 columns, k
// indices the tile's rows: a[kk][e] = X[8kk + t + 4(e >> 1)][d0 + 8(e & 1)].
__device__ __forceinline__ void frags_t(uint32_t (&h)[4][4], uint32_t (&l)[4][4],
                                        const unsigned char* x, int d0, int t) {
  const unsigned char* panel = x + (d0 >> 5) * kTPanel;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t o = swz128(8 * kk + t + 4 * (e >> 1), (d0 + 8 * (e & 1)) & 31);
      h[kk][e] = *reinterpret_cast<const uint32_t*>(panel + o);
      l[kk][e] = *reinterpret_cast<const uint32_t*>(panel + kTTile + o);
    }
}

// entry i of a 64 x 32 accumulator: row r0 + 8((i >> 1) & 1), column
// 8(i / 4) + 2t + (i & 1), as a word of a K-major 64 x 32 panel
__device__ __forceinline__ uint32_t entry_off(int r0, int t, int i) {
  return swz128(r0 + 8 * ((i >> 1) & 1), 8 * (i / 4) + 2 * t + (i & 1));
}

// This thread's entries of a 64 x 32 f32 accumulator split into a K-major
// panel: hi at `panel`, lo a panel after it (the B operand of a product over
// the accumulator's columns)
__device__ __forceinline__ void put_split(unsigned char* panel, const float (&x)[16], int r0,
                                          int t) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    float hi, lo;
    tf32_split(x[i], hi, lo);
    *reinterpret_cast<float*>(panel + entry_off(r0, t, i)) = hi;
    *reinterpret_cast<float*>(panel + kSPanel + entry_off(r0, t, i)) = lo;
  }
}

// d (64 x 32) = A·Bᵀ over D to f32 accuracy, a_lo·b_hi (SS, the stationary
// lo tile at a_lo) + a_hi·b_lo + a_hi·b_hi (RS, a_hi the A fragments), the
// small terms first; B a 32-row split K-major tile. Issued and committed.
__device__ __forceinline__ void gemm_abt(float (&d)[16], const uint32_t (&ah)[16][4],
                                         uint32_t a_lo, uint32_t b_hi) {
  constexpr uint32_t hi = wgmma_desc_hi(kKMajorSbo);
  // the addresses pass an empty asm at each call, so the compiler derives the
  // descriptors here rather than holding all of them across the tile loop
  asm volatile("" : "+r"(a_lo), "+r"(b_hi));
  const uint32_t al = wgmma_desc_lo(a_lo, 16), bh = wgmma_desc_lo(b_hi, 16);
  const uint32_t bl = wgmma_desc_lo(b_hi + kTTile, 16);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 16; ++kk)
    wgmma_tf32_ss_n32(d, wgmma_desc(al + (((kk >> 2) * kSPanel + (kk & 3) * 32) >> 4), hi),
                      wgmma_desc(bh + (((kk >> 2) * kTPanel + (kk & 3) * 32) >> 4), hi), kk > 0);
#pragma unroll
  for (int kk = 0; kk < 16; ++kk)
    wgmma_tf32_rs_n32(d, ah[kk], wgmma_desc(bl + (((kk >> 2) * kTPanel + (kk & 3) * 32) >> 4), hi),
                      1);
#pragma unroll
  for (int kk = 0; kk < 16; ++kk)
    wgmma_tf32_rs_n32(d, ah[kk], wgmma_desc(bh + (((kk >> 2) * kTPanel + (kk & 3) * 32) >> 4), hi),
                      1);
  wgmma_commit();
}

// acc (64 x 64) += A·B to f32 accuracy over one tile's 32 rows: A the split
// fragments (ah, al) of a transposed streamed tile (frags_t), B a split
// 64 x 32 K-major panel (hi at b_hi, lo a panel after it), a_lo·b_hi +
// a_hi·b_lo + a_hi·b_hi at each k8 step, the tile's product from zero (12
// m64n64k8 steps) added to acc by a rounded add.
__device__ __forceinline__ void gemm_fold(float (&acc)[32], uint32_t (&ah)[4][4],
                                          uint32_t (&al)[4][4], uint32_t b_hi) {
  constexpr uint32_t hi = wgmma_desc_hi(kKMajorSbo);
  asm volatile("" : "+r"(b_hi));  // as in gemm_abt
  const uint32_t bh = wgmma_desc_lo(b_hi, 16), bl = wgmma_desc_lo(b_hi + kSPanel, 16);
  fence_operands(ah);
  fence_operands(al);
  float pv[32];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t off = (kk * 32) >> 4;
    wgmma_tf32_rs_n64(pv, al[kk], wgmma_desc(bh + off, hi), kk > 0);
    wgmma_tf32_rs_n64(pv, ah[kk], wgmma_desc(bl + off, hi), 1);
    wgmma_tf32_rs_n64(pv, ah[kk], wgmma_desc(bh + off, hi), 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(pv);
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] += pv[i];
  fence_operands(ah);
  fence_operands(al);
}

// a consumer thread's share of a transposed 64 x 64 gradient block, the
// accumulator of Gᵀ (entry 16c + i: column d0 + 8((i >> 1) & 1) of G, row
// row0 + 32c + 8(i / 4) + 2t + (i & 1)), for the rows below n
__device__ __forceinline__ void store_t(float* __restrict__ g, const float (&acc)[32], int d0,
                                        int row0, int n, int ld, int t) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int row = row0 + 32 * (i / 16) + 8 * ((i % 16) / 4) + 2 * t + (i & 1);
    if (row < n) g[static_cast<size_t>(row) * ld + d0 + 8 * ((i >> 1) & 1)] = acc[i];
  }
}

// a warp's arrival on an mbarrier counted in warps, once its shared-memory
// accesses are performed: the arrive does not wait for the thread's loads in
// flight (ptxas issues the fragments' LDS right before it), and a stage
// released under them is rewritten by the next tile's TMA and split
__device__ __forceinline__ void warp_arrive(uint64_t* bar, int lane) {
  __threadfence_block();
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
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

// one R-row tile of head h, rows from row0, of batch row b: its four
// 32-column panels by TMA onto `bar`
template <int R>
__device__ __forceinline__ void tma_tile(unsigned char* dst, const CUtensorMap* map, uint64_t* bar,
                                         int h, int row0, int b) {
#pragma unroll
  for (int p = 0; p < 4; ++p) tma_load(dst + p * R * kRowBytes, map, bar, 32 * p, h, row0, b);
}

// The producer warpgroup of both kernels: warp 0 loads the two stationary
// tiles (stat0, stat1: 64 rows from row0) once and keeps kStages streamed
// tiles of the two operands (str0, str1: 32 rows) in flight; warps 1-3 split
// each streamed tile in place once it lands, rows at or past `live_n` as zeros.
__device__ __forceinline__ void produce(const Smem& sm, const CUtensorMap* stat0,
                                        const CUtensorMap* stat1, const CUtensorMap* str0,
                                        const CUtensorMap* str1, int h, int b, int row0,
                                        int n_tiles, int live_n) {
  setmaxnreg_dec<kProducerRegs>();
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (w == 0) {  // one thread starts every load
    if (lane == 0) {
      mbar_arrive_expect_tx(sm.stat_full(), 2 * kSTile);
      tma_tile<kRows>(sm.stat(0), stat0, sm.stat_full(), h, row0, b);
      tma_tile<kRows>(sm.stat(1), stat1, sm.stat_full(), h, row0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        mbar_wait(sm.empty(s), ((j / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(sm.full(s), 2 * kTTile);
        tma_tile<kTileRows>(sm.stage(s), str0, sm.full(s), h, j * kTileRows, b);
        tma_tile<kTileRows>(sm.stage(s) + 2 * kTTile, str1, sm.full(s), h, j * kTileRows, b);
      }
    }
    return;
  }
  for (int j = 0; j < n_tiles; ++j) {  // warps 1-3
    const int s = j % kStages;
    mbar_wait(sm.full(s), (j / kStages) & 1);
    const bool live = j * kTileRows + lane < live_n;
    split_rows(sm.stage(s), lane, w - 1, live);
    split_rows(sm.stage(s) + 2 * kTTile, lane, w - 1, live);
    fence_proxy_async();  // the generic writes before wgmma reads them
    warp_arrive(sm.ready(s), lane);
  }
}

__device__ __forceinline__ void init_barriers(const Smem& sm) {
  if (threadIdx.x == 0) {
    mbar_init(sm.stat_full(), 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(sm.full(s), 1);
      mbar_init(sm.ready(s), kPrepWarps);
      mbar_init(sm.empty(s), kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();
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
  const Smem sm = smem_layout();
  const int n_tiles = (kv_len + kTileRows - 1) / kTileRows;
  init_barriers(sm);
  if (threadIdx.x < 128) {  // keys past kv_len: zeros
    produce(sm, &maps.q, &maps.dout, &maps.k, &maps.v, h, b, q0, n_tiles, kv_len);
    return;
  }

  // consumer warpgroups on the same 64 q rows: 0 holds q and computes s and
  // p, 1 holds dO and computes dp; they swap p and dp, both form ds, 0
  // writes its hi and 1 its lo, and each folds dqᵀ for 64 of the 128 columns
  setmaxnreg_inc<kConsumerRegs>();
  const int cw = threadIdx.x / 128 - 1;
  const int t = threadIdx.x % 128, lane = t % 32;
  const int r0 = (t / 32) * 16 + lane / 4;  // this thread's rows in the tile: r0, r0 + 8
  const int row_a = q0 + r0;
  const int d0 = cw * kRows + r0;  // its dq columns: d0, d0 + 8
  uint32_t ah[16][4];
  mbar_wait(sm.stat_full(), 0);  // rows past Lq: TMA's zeros
  split_stationary(ah, sm.stat(cw), r0, lane % 4, q0, a.Lq);
  fence_proxy_async();  // the lo tile's generic writes before wgmma reads them
  named_bar_sync(kSplitBar + cw, 128);

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
  const uint32_t a_lo = smem_u32(sm.stat(cw));
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages, kv0 = j * kTileRows;
    unsigned char* stage = sm.stage(s);  // k hi, k lo, v hi, v lo
    mbar_wait(sm.ready(s), (j / kStages) & 1);
    float x[16];  // s (consumer 0) or dp (1)
    gemm_abt(x, ah, a_lo, smem_u32(stage + cw * 2 * kTTile));
    wgmma_wait<0>();
    fence_operands(x);
    // entry i: row row_a + 8((i >> 1) & 1), key kv0 + 8(i / 4) + 2(lane % 4) + (i & 1)
    if (cw == 0) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int col = kv0 + (i / 4) * 8 + (lane % 4) * 2 + (i & 1);
        x[i] = col < kv_len ? exp2f(fmaf(x[i], sl2, -lse2[(i >> 1) & 1])) : 0.f;  // p
      }
    }
    // p and dp swapped through pair 0, entry i of thread t at word i·128 + t;
    // the words are free once both consumers passed the last tile's
    // kOperandBar, after they were read
    float* swap = reinterpret_cast<float*>(sm.pair(0));
#pragma unroll
    for (int i = 0; i < 16; ++i) swap[cw * (kSPanel / 4) + i * 128 + t] = x[i];
    named_bar_sync(kSwapBar, 256);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float y = swap[(1 - cw) * (kSPanel / 4) + i * 128 + t];
      const float p = cw ? y : x[i], dp = cw ? x[i] : y;
      x[i] = p * (dp - dl[(i >> 1) & 1]) * a.scale;  // ds, the same bits in both
    }
    // ds as the fold's B operand (rows q, columns keys): consumer 0 writes
    // its hi, 1 its lo; both folds of the last tile are done (kSwapBar)
    unsigned char* ds_panel = sm.pair(1);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      float hi, lo;
      tf32_split(x[i], hi, lo);
      *reinterpret_cast<float*>(ds_panel + cw * kSPanel + entry_off(r0, lane % 4, i)) =
          cw ? lo : hi;
    }
    fence_proxy_async();
    uint32_t kh[4][4], kl[4][4];  // kᵀ, rows d0 and d0 + 8 of this consumer's 64
    frags_t(kh, kl, stage, d0, lane % 4);
    warp_arrive(sm.empty(s), lane);  // s or dp and the kᵀ fragments have read the stage
    named_bar_sync(kOperandBar, 256);
    gemm_fold(acc, kh, kl, smem_u32(ds_panel));  // dqᵀ += kᵀ·dsᵀ
  }
  store_t(dq + q_off, acc, d0, q0, a.Lq, ld, lane % 4);
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
  const Smem sm = smem_layout();
  const int n_tiles = (a.Lq + kTileRows - 1) / kTileRows;
  init_barriers(sm);
  if (threadIdx.x < 128) {  // q rows past Lq: TMA's zeros
    produce(sm, &maps.k, &maps.v, &maps.q, &maps.dout, h, b, k0, n_tiles, a.Lq);
    return;
  }

  // consumer warpgroups on the same 64 KV rows: 0 holds k, computes sᵀ and
  // pᵀ and folds dvᵀ += dOᵀ·pᵀ; 1 holds v, computes dpᵀ, takes pᵀ from 0,
  // forms dsᵀ and folds dkᵀ += qᵀ·dsᵀ
  setmaxnreg_inc<kConsumerRegs>();
  const int cw = threadIdx.x / 128 - 1;
  const int t = threadIdx.x % 128, lane = t % 32;
  const int r0 = (t / 32) * 16 + lane / 4;  // this thread's KV rows in the tile: r0, r0 + 8
  const int row_a = k0 + r0;
  uint32_t ah[16][4];
  mbar_wait(sm.stat_full(), 0);
  split_stationary(ah, sm.stat(cw), r0, lane % 4, k0, kv_len);  // rows past kv_len: zeros
  fence_proxy_async();
  named_bar_sync(kSplitBar + cw, 128);

  const bool live[2] = {row_a < kv_len, row_a + 8 < kv_len};
  const float* lse_bh = a.lse + (static_cast<size_t>(b) * a.N + h) * a.Lq;
  const float* delta_bh = a.delta + (static_cast<size_t>(b) * a.N + h) * a.Lq;
  const float sl2 = a.scale * kLog2e;
  const uint32_t a_lo = smem_u32(sm.stat(cw));
  unsigned char* panel = sm.pair(cw);  // pᵀ (consumer 0) or dsᵀ (1), hi and lo
  float acc0[32], acc1[32];  // dvᵀ (consumer 0) or dkᵀ (1): columns 0-63, 64-127 of the gradient
#pragma unroll
  for (int i = 0; i < 32; ++i) acc0[i] = acc1[i] = 0.f;
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages, q0 = j * kTileRows;
    unsigned char* stage = sm.stage(s);  // q hi, q lo, dO hi, dO lo
    mbar_wait(sm.ready(s), (j / kStages) & 1);
    float x[16];  // sᵀ (consumer 0) or dpᵀ (1)
    gemm_abt(x, ah, a_lo, smem_u32(stage + cw * 2 * kTTile));
    wgmma_wait<0>();
    fence_operands(x);
    // entry i: KV row row_a + 8((i >> 1) & 1), q row q0 + 8(i / 4) + 2(lane % 4) + (i & 1)
    // (column c = 2(i / 4) + (i & 1) of this thread's 8)
    if (cw == 0) {
      float l2[8];  // a q row past Lq takes LSE = +inf, so its p is 0
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = q0 + (c / 2) * 8 + (lane % 4) * 2 + (c & 1);
        l2[c] = col < a.Lq ? lse_bh[col] * kLog2e : INFINITY;
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int c = (i / 4) * 2 + (i & 1);
        x[i] = live[(i >> 1) & 1] ? exp2f(fmaf(x[i], sl2, -l2[c])) : 0.f;  // pᵀ
      }
      if (j > 0) named_bar_sync(kOperandBar, 256);  // 1 has read the last tile's pᵀ
      put_split(panel, x, r0, lane % 4);
      fence_proxy_async();
      named_bar_sync(kSwapBar, 256);  // pᵀ in place for both consumers
    } else {
      float dl[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = q0 + (c / 2) * 8 + (lane % 4) * 2 + (c & 1);
        dl[c] = col < a.Lq ? delta_bh[col] : 0.f;
      }
      named_bar_sync(kSwapBar, 256);
      const unsigned char* pt = sm.pair(0);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float p = *reinterpret_cast<const float*>(pt + entry_off(r0, lane % 4, i)) +
                        *reinterpret_cast<const float*>(pt + kSPanel + entry_off(r0, lane % 4, i));
        x[i] = p * (x[i] - dl[(i / 4) * 2 + (i & 1)]) * a.scale;  // dsᵀ, from pᵀ as hi + lo
      }
      // as warp_arrive: the pᵀ loads are performed before 0 may write the
      // next tile's pᵀ
      __threadfence_block();
      if (j + 1 < n_tiles) named_bar_arrive(kOperandBar, 256);
      put_split(panel, x, r0, lane % 4);  // this warpgroup's last fold is done
      fence_proxy_async();
      named_bar_sync(kOwnBar, 128);
    }
    // dvᵀ += dOᵀ·pᵀ (consumer 0), dkᵀ += qᵀ·dsᵀ (1): the gradient's columns
    // 0-63, then 64-127, A the transposed stage tile's fragments
    const unsigned char* xt = stage + (1 - cw) * 2 * kTTile;  // dO (0) or q (1)
    uint32_t fh[4][4], fl[4][4];
    frags_t(fh, fl, xt, r0, lane % 4);
    gemm_fold(acc0, fh, fl, smem_u32(panel));
    frags_t(fh, fl, xt, kRows + r0, lane % 4);
    warp_arrive(sm.empty(s), lane);  // the products and fragments have read the stage
    gemm_fold(acc1, fh, fl, smem_u32(panel));
  }
  float* g = (cw ? dk : dv) + k_off;
  store_t(g, acc0, r0, k0, a.Lk, ld, lane % 4);
  store_t(g, acc1, kRows + r0, k0, a.Lk, ld, lane % 4);
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
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Lq + kRows - 1) / kRows, N, B);
  flash_bwd_dq_f32_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
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
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Lk + kRows - 1) / kRows, N, B);
  flash_bwd_dkv_f32_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      maps, a, static_cast<float*>(dk), static_cast<float*>(dv));
  return static_cast<int>(cudaGetLastError());
}
