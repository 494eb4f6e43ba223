// Attention forward for Hopper (sm_90a): the mainloop shared by every
// attention forward of the port, five kernel rows, each of which gives it
// its own epilogue policy (and, for the causal prefill and the ring, its own
// visibility rules):
//
// - rows 1 and 3a, the inference forward at head dim 128 (the Wan DiT) and
//   72 (the Qwen3-VL vision tower) (flash_fwd.cu, flash_fwd_launch, policy
//   InferOut): replace omnivideo_tpu/ops/pallas/flash_attention.py:42
//   `_fa_kernel` via `_flash_fwd_unpadded` (pallas_call at :328; D = 72 is
//   its head-major branch, :308-318);
// - row 2, the Qwen3 text prefill (flash_fwd.cu, flash_fwd_launch with
//   causal set, CausalOut): `_fa_kernel` with causal=True (col <= row,
//   :111-114), the same pallas_call;
// - row 3b, the training forward (flash_fwd.cu, flash_fwd_lse_launch,
//   LseOut): `_fa_kernel` with with_lse=True, via the pallas_call at :430
//   (`_flash_fwd_impl`);
// - row 8, one ring-attention step merged into a carried (m, l, acc)
//   (ring_step.cu, ring_step_launch, RingCarry): replaces
//   omnivideo_tpu/ops/pallas/ring_attention.py:36 `_step_kernel`, via the
//   pallas_call at :249.
//
// What it computes, for every (b, h, q row) and every key c it sees:
// s = bf16(q·scale·log2e)·k (the exp2 domain, q rounded to bf16 once after
// the scaling, as the plain twins do), and either the max-tracked online
// softmax m' = max(m, max_c s), l' = l·2^(m−m') + Σ 2^(s−m'),
// acc' = acc·2^(m−m') + Σ bf16(2^(s−m'))·v_c, or, where the policy says
// `bounded` (rows 1, 2 and 3a when the device flag `safe` is set), the bounded
// softmax of flash_attention.py:116-132: m is the per-(b, h) bound mb from
// the start and stays, l' = l + Σ 2^(s−mb), acc' = acc + Σ bf16(2^(s−mb))·v_c,
// with no row max and no rescale of O. The mode is one uniform branch in the
// softmax and around the rescale, away from every wgmma. A masked key's
// logit is −inf while m is finite (−1e30 before the first key, a carry's m,
// or mb), so it adds exactly 0; V rows past the key length are zeroed in
// shared memory before the PV product, so a NaN or Inf stored there adds
// nothing either.
//
// Bound on the H100: operations, 4·B·N·Lq·Lk_seen·D FLOPs on the bf16 tensor
// cores (989 TFLOP/s) plus one exponential per (q row, key): 13.3 ms for the
// DiT's self-attention at [2, 32760, 12, 128], 6.7 ms at batch 1, 0.034 ms
// for the vision tower's [3, 1560, 16, 72], 0.018 ms for the causal prefill's
// [1, 1481, 32, 128].
//
// Design (FA3's, from hopper_common.cuh's pieces): a block owns 128 q rows of
// one (b, head), tile index fastest in launch order so a head's K/V stays in
// L2 (the causal policy takes the q tiles heaviest first across every head:
// block_coords); 384 threads: one producer warpgroup (setmaxnreg 40) whose one thread
// loads the q tile once and keeps K/V tiles of 128 keys in flight by TMA
// through a ring of kStages stages (full/empty mbarriers; 4-D maps over the
// packed [B, L, N, D] layout, one per operand and panel, zero fill past L
// and past D), and two consumer warpgroups (setmaxnreg 232) of 64 q rows
// each that read the same stages. A consumer pre-scales its q tile in shared
// memory once, then per tile: S = q·kᵀ by wgmma (SS, 64 x 128, K K-major),
// the softmax in registers (row max over the quad shuffles, ex2), p to the
// bf16 A fragments (acc_to_a), and O += p·V by wgmma (RS, V read MN-major).
// Inside a warpgroup the products overlap the exponentials: S of tile j+1 is
// issued together with P·V of tile j, and the softmax of tile j+1 runs while
// P·V of tile j is in flight (the rescale of O waits for it). Across the two
// warpgroups, FA3's ping-pong: they take turns to issue their products, so
// one's exponentials run under the other's products. The head's columns sit
// in two panels (Panels<W>): at D = 128 two 64-column panels with the
// 128-byte swizzle; at D = 72 an 80-wide tile, one 64-column panel and one
// 16-column panel with the 32-byte swizzle (TMA writes zeros in columns
// 72..79), so q·kᵀ takes five k16 steps instead of eight, P·V one n64 and
// one n16 product per k16 step on the same P fragment, and a stage 40 KiB
// instead of 64. Per consumer thread: O 64 f32 (40 at D = 72), S 64 f32, p
// 32 bf16 pairs; 168 registers at launch and no spill. The last tile is
// peeled out of the loop: a wgmma issued under a runtime branch made ptxas
// serialise every wgmma (C7520). Measured on the H100 (PERF.md): 128-key
// tiles with 3 stages beat 64-key tiles by 7–10% (with 2 stages they lost
// 20%: a stage is refilled only once both consumers are done with it, so
// two stages leave one tile of look-ahead), and the ping-pong gained 2–5%.
//
// Visibility is a prefix of the 64-key halves of the key tiles for every 64
// q rows in every mode the entry points have (kv_len; the causal prefill's
// col <= row; the ring's block, token, stripe and zigzag rules), and each
// half keeps its own relation (a
// zigzag chunk boundary may split a 128-key tile). Each consumer walks its
// own prefix of tiles, the producer loads the longer of the two, and a
// consumer drains (waits, then releases) the stages the other half saw and
// it did not, taking its turns all the same, so the mbarrier phases and the
// ping-pong stay in step.

#pragma once

#include <math.h>

#include "hopper_common.cuh"

namespace {
namespace fwdh {

constexpr int kRows = 64;                // q rows per consumer warpgroup; keys per half tile
constexpr int kKeys = 128;               // keys per K/V tile
constexpr int kBlockRows = 2 * kRows;    // q rows per block
constexpr int kStages = 3;               // K/V tiles in flight
constexpr int kThreadsWS = 384;          // producer warpgroup + two consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr int kProducerRegs = 40;        // 128·40 + 256·232 = 384·168
constexpr int kConsumerRegs = 232;
constexpr float kInitMax = -1e30f;       // m of a row that has seen no key

// How a head's columns sit in shared memory: panel 0 holds columns 0..63
// (128-byte rows, 128-byte swizzle), panel 1 the next W: 64 for a 128-wide
// tile (128-byte swizzle), or 16 for the 80-wide tile of head dim 72 (32-byte
// rows, 32-byte swizzle; TMA fills columns 72..79 with zeros). A q tile is
// 64 rows, a K or V tile 128; panel 1 follows panel 0 in each.
template <int W>
struct Panels {
  static_assert(W == 64 || W == 16, "panel 1 is 64 or 16 columns wide");
  static constexpr int kWidth = 64 + W;       // columns of the tile
  static constexpr int kAcc = kWidth / 2;     // O accumulator, f32 per consumer thread
  static constexpr int kQkSteps = kWidth / 16;
  static constexpr uint32_t kRow1 = 2 * W;    // bytes of a panel-1 row
  static constexpr uint32_t kQ1 = kRows * 128;   // panel 1 in a q tile
  static constexpr uint32_t kK1 = kKeys * 128;   // panel 1 in a K/V tile
  static constexpr uint32_t kQTile = kQ1 + kRows * kRow1;
  static constexpr uint32_t kKTile = kK1 + kKeys * kRow1;
  // the two consumers' q tiles, kStages stages of K and V, the barriers:
  // 225 KiB of 227 at W = 64, 141 KiB at W = 16
  static constexpr uint32_t kQBytes = 2 * kQTile;
  static constexpr uint32_t kStageBytes = 2 * kKTile;
  static constexpr uint32_t kBarOff = kQBytes + kStages * kStageBytes;
  static constexpr size_t kSmemBytes = kBarOff + (1 + 2 * kStages) * sizeof(uint64_t) + 1024;
  static constexpr CUtensorMapSwizzle kSwizzle1 =
      W == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B;
  static constexpr uint32_t kHi1 = wgmma_desc_hi(8 * kRow1, W == 64 ? kSwizzle128 : kSwizzle32);
  static_assert(kQTile % 1024 == 0 && kKTile % 1024 == 0, "panels on 1024-byte boundaries");
};

// The keys of one 64-key half tile that 64 q rows see: none, or every key
// below kv_len and, when `diag`, only those with (col − kb) + shift <= (row − qb).
struct TileMask {
  bool none, diag;
  int qb, kb, shift;
};

// the tensor maps of q, k and v, one per panel
struct Maps {
  CUtensorMap q[2], k[2], v[2];
};

template <class P>
struct Smem {
  unsigned char* base;  // 1024-byte aligned
  __device__ unsigned char* q(int wg) const { return base + wg * P::kQTile; }
  __device__ unsigned char* k(int s) const { return base + P::kQBytes + s * P::kStageBytes; }
  __device__ unsigned char* v(int s) const { return k(s) + P::kKTile; }
  __device__ uint64_t* bar(int i) const {
    return reinterpret_cast<uint64_t*>(base + P::kBarOff) + i;
  }
  __device__ uint64_t* q_full() const { return bar(0); }
  __device__ uint64_t* full(int s) const { return bar(1 + s); }
  __device__ uint64_t* empty(int s) const { return bar(1 + kStages + s); }
};

template <class P>
__device__ __forceinline__ Smem<P> smem_layout() {
  extern __shared__ __align__(1024) unsigned char fwdh_smem[];
  const uint32_t a = smem_u32(fwdh_smem);
  return Smem<P>{fwdh_smem + (((a + 1023) & ~1023u) - a)};
}

// q·qscale rounded to bf16, in place, over one q tile (the element order
// does not matter, so the swizzle does not either; the zero pad stays 0)
template <class P>
__device__ __forceinline__ void prescale_q(unsigned char* tile, float qscale, int t) {
  uint4* q4 = reinterpret_cast<uint4*>(tile);
  for (int i = t; i < static_cast<int>(P::kQTile / 16); i += 128) {
    uint4 u = q4[i];
    uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w[e]));
      w[e] = pack_bf16(__fmul_rn(f.x, qscale), __fmul_rn(f.y, qscale));
    }
    q4[i] = u;
  }
}

// rows r0..127 of a K/V tile set to 0 in both panels (a swizzle moves
// chunks only within a row)
template <class P>
__device__ __forceinline__ void zero_tail(unsigned char* tile, int r0, int t) {
  const int n0 = (kKeys - r0) * 8, n1 = (kKeys - r0) * static_cast<int>(P::kRow1 / 16);
  uint4* p0 = reinterpret_cast<uint4*>(tile + r0 * 128);
  uint4* p1 = reinterpret_cast<uint4*>(tile + P::kK1 + r0 * P::kRow1);
  for (int i = t; i < n0 + n1; i += 128) (i < n0 ? p0[i] : p1[i - n0]) = make_uint4(0u, 0u, 0u, 0u);
}

// S (64 x 128) = q (64 rows at a, K-major) · K (128 rows at b, K-major)ᵀ over
// the tile's columns: four k16 steps in panel 0, the rest in panel 1; issued
// and committed as one group
template <class P>
__device__ __forceinline__ void gemm_qk(float (&d)[64], uint32_t a, uint32_t b) {
  constexpr uint32_t hi0 = wgmma_desc_hi(kKMajorSbo);
  const uint32_t la0 = wgmma_desc_lo(a, 16), lb0 = wgmma_desc_lo(b, 16);
  const uint32_t la1 = wgmma_desc_lo(a + P::kQ1, 16), lb1 = wgmma_desc_lo(b + P::kK1, 16);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < P::kQkSteps; ++k) {
    if (k < 4)
      wgmma_ss_n128(d, wgmma_desc(la0 + ((k * 32) >> 4), hi0),
                    wgmma_desc(lb0 + ((k * 32) >> 4), hi0), k > 0);
    else
      wgmma_ss_n128(d, wgmma_desc(la1 + (((k - 4) * 32) >> 4), P::kHi1),
                    wgmma_desc(lb1 + (((k - 4) * 32) >> 4), P::kHi1), 1);
  }
  wgmma_commit();
}

// O (64 x width) += P (64 x 128 keys, registers) · V (128 rows at b,
// MN-major): 128 wide, one n128 product per k16 step across both panels;
// 80 wide, one n64 product on panel 0 and one n16 on panel 1 sharing the P
// fragment. Issued only: the caller fences, commits and waits.
template <class P>
__device__ __forceinline__ void gemm_pv(float (&d)[P::kAcc], const uint32_t (&a)[8][4],
                                        uint32_t b) {
  constexpr uint32_t hi0 = wgmma_desc_hi(kKMajorSbo);
  const uint32_t lb0 = wgmma_desc_lo(b, P::kK1);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    if constexpr (P::kWidth == 128) {
      wgmma_rs_n128_tb(d, a[kk], wgmma_desc(lb0 + ((kk * 2048) >> 4), hi0));
    } else {
      const uint32_t lb1 = wgmma_desc_lo(b + P::kK1, 16 * P::kRow1);
      wgmma_rs_n64_tb<0>(d, a[kk], wgmma_desc(lb0 + ((kk * 2048) >> 4), hi0));
      wgmma_rs_n16_tb<32>(d, a[kk], wgmma_desc(lb1 + ((kk * 16 * P::kRow1) >> 4), P::kHi1));
    }
  }
}

// FA3's ping-pong: the two consumer warpgroups take turns to issue their
// products (named barriers 1 and 2), so that one's exponentials run while
// the other's products hold the tensor cores. Warpgroup 0 goes first; each
// takes `left` turns, the same number for both, and warpgroup 1 leaves out
// its last arrival so that no barrier is left half-arrived.
struct Turns {
  int cw, left;
  __device__ void begin() const { named_bar_sync(1 + cw, 256); }
  __device__ void end() {
    if (cw == 0 || left > 1) named_bar_arrive(2 - cw, 256);
    --left;
  }
};

// One tile's softmax on this thread's share of the 64 x 128 S accumulator
// (entry i: row row_a + 8·((i >> 1) & 1), column kv0 + 8·(i / 4) + 2·(lane % 4)
// + (i & 1), in half i / 32): masks the keys the rows do not see where `edge`;
// max-tracked, moves the running max, rescales l and returns alpha = 2^(m − m')
// per row; bounded, m holds the bound and stays (no alpha). s becomes p.
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], bool bounded, bool edge,
                                             const TileMask (&tm)[2], int kv0, int kv_len,
                                             int row_a, int lane) {
  if (edge) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const TileMask& t = tm[i / 32];
      const int col = kv0 + (i / 4) * 8 + (lane % 4) * 2 + (i & 1);
      const int row = row_a + ((i >> 1) & 1) * 8;
      if (t.none || col >= kv_len || (t.diag && (col - t.kb) + t.shift > (row - t.qb)))
        s[i] = -INFINITY;
    }
  }
  if (!bounded) {
    float mc[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 64; ++i) mc[(i >> 1) & 1] = fmaxf(mc[(i >> 1) & 1], s[i]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mc[r] = fmaxf(mc[r], __shfl_xor_sync(0xffffffffu, mc[r], 1));
      mc[r] = fmaxf(mc[r], __shfl_xor_sync(0xffffffffu, mc[r], 2));
      const float m_new = fmaxf(m[r], mc[r]);  // >= −1e30: finite
      alpha[r] = fast_exp2(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const float p = fast_exp2(s[i] - m[(i >> 1) & 1]);  // a masked key: exactly 0
    l[(i >> 1) & 1] += p;
    s[i] = p;
  }
}

// syncs the 128 threads of this consumer warpgroup (named barrier 3 + cw)
__device__ __forceinline__ void consumer_sync() {
  named_bar_sync(3 + threadIdx.x / 128 - 1, 128);
}

template <int NA>
__device__ __forceinline__ void rescale(float (&acc)[NA], const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] *= alpha[(i >> 1) & 1];
}

// The (q tile, head, batch row) of this block: blockIdx's own, or, heavy
// first, the q tiles of every (b, h) in decreasing order: block i (launch
// order) takes tile nx − 1 − i / (N·B) of head-and-row i % (N·B), so that
// under a causal mask, where tile j walks j + 1 key tiles, the blocks that
// walk the most start first and the lightest make the last wave.
template <bool kHeavyFirst>
__device__ __forceinline__ int3 block_coords() {
  if constexpr (!kHeavyFirst) {
    return make_int3(blockIdx.x, blockIdx.y, blockIdx.z);
  } else {
    const int hb = gridDim.y * gridDim.z;
    const int i = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
    return make_int3(gridDim.x - 1 - i / hb, (i % hb) % gridDim.y, (i % hb) / gridDim.y);
  }
}

// Policy (the hooks an entry point gives the mainloop):
//   static constexpr int D;             head dim (the maps' columns)
//   using P = Panels<W>;                the tile's panel layout (P::kWidth >= D)
//   int Lq, Lk, N;                      shapes
//   static constexpr bool kSkipEmpty;   a block that sees no key returns at once
//   static constexpr bool kHeavyFirst;  the blocks in decreasing q tile order (block_coords)
//   int kv_len(b);                      keys of batch row b before any clamp
//   int live_tiles(q0, n);              the prefix of the n 64-key half tiles
//                                       below kv_len that the 64 rows at q0 see
//   TileMask mask(q0, kv0);             how the half tile at kv0 shows to them
//   bool bounded();                     the bounded softmax (uniform over the grid)
//   void load(acc, m, l, b, h, row_a, lane);          the state before the first tile
//                                                     (bounded: m = the bound)
//   void store(acc, m, l, b, h, row_a, lane, seen, tile);   the epilogue (l summed over the
//                                     quad; tile: this warpgroup's q tile, free by then)
template <class Policy>
__global__ void __launch_bounds__(kThreadsWS, 1)
attn_fwd_kernel(const __grid_constant__ Maps maps, const Policy pol, float qscale) {
  using P = typename Policy::P;
  const int3 tile_h_b = block_coords<Policy::kHeavyFirst>();
  const int h = tile_h_b.y, b = tile_h_b.z;
  const int q0 = tile_h_b.x * kBlockRows;
  const int kv_len = min(max(pol.kv_len(b), 0), pol.Lk);
  const int n_halves = (kv_len + kRows - 1) / kRows;
  const int n0 = (pol.live_tiles(q0, n_halves) + 1) / 2;  // 128-key tiles
  const int n1 = q0 + kRows < pol.Lq ? (pol.live_tiles(q0 + kRows, n_halves) + 1) / 2 : 0;
  const int n_blk = max(n0, n1);
  if (Policy::kSkipEmpty && n_blk == 0) return;
  const Smem<P> sm = smem_layout<P>();
  if (threadIdx.x == 0) {
    mbar_init(sm.q_full(), 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(sm.full(s), 1);
      mbar_init(sm.empty(s), kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup: one thread starts every load
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0 && n_blk > 0) {
      mbar_arrive_expect_tx(sm.q_full(), P::kQBytes);
#pragma unroll
      for (int wg = 0; wg < 2; ++wg)
#pragma unroll
        for (int p = 0; p < 2; ++p)
          tma_load(sm.q(wg) + p * P::kQ1, &maps.q[p], sm.q_full(), p * 64, h, q0 + wg * kRows,
                   b);
      for (int j = 0; j < n_blk; ++j) {
        const int s = j % kStages;
        mbar_wait(sm.empty(s), ((j / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(sm.full(s), P::kStageBytes);
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          tma_load(sm.k(s) + p * P::kK1, &maps.k[p], sm.full(s), p * 64, h, j * kKeys, b);
          tma_load(sm.v(s) + p * P::kK1, &maps.v[p], sm.full(s), p * 64, h, j * kKeys, b);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();  // consumer warpgroups: 64 q rows each
  const int cw = threadIdx.x / 128 - 1;
  const int t = threadIdx.x % 128, lane = t % 32;
  const int q0c = q0 + cw * kRows;
  const int row_a = q0c + (t / 32) * 16 + lane / 4;  // this thread's rows: row_a, row_a + 8
  const int n = cw ? n1 : n0;
  const bool bounded = pol.bounded();
  Turns turns{cw, n_blk > 0 ? n_blk + 1 : 0};
  if (cw == 1 && turns.left > 0) named_bar_arrive(1, 256);
  float acc[P::kAcc], m[2], l[2];
  pol.load(acc, m, l, b, h, row_a, lane);
  if (n > 0) {
    unsigned char* q_tile = sm.q(cw);
    mbar_wait(sm.q_full(), 0);
    prescale_q<P>(q_tile, qscale, t);
    fence_proxy_async();  // the generic writes before wgmma reads them
    named_bar_sync(3 + cw, 128);
    const uint32_t sq = smem_u32(q_tile);
    float s[64], alpha[2];
    uint32_t pa[8][4];
    // mask and softmax of the tile at kv0, whose S is in s
    auto softmax_at = [&](int kv0) {
      const TileMask tm[2] = {pol.mask(q0c, kv0), pol.mask(q0c, kv0 + kRows)};
      bool edge = kv0 + kKeys > kv_len;
#pragma unroll
      for (int u = 0; u < 2; ++u)
        edge |= tm[u].none || (tm[u].diag && (kv0 + u * kRows - tm[u].kb) + kRows - 1 +
                                                     tm[u].shift > q0c - tm[u].qb);
      softmax_tile(s, m, l, alpha, bounded, edge, tm, kv0, kv_len, row_a, lane);
    };
    mbar_wait(sm.full(0), 0);
    turns.begin();
    gemm_qk<P>(s, sq, smem_u32(sm.k(0)));
    turns.end();
    wgmma_wait<0>();
    fence_operands(s);
    softmax_at(0);
    if (!bounded) rescale(acc, alpha);
    // tiles 0..n-2: P·V of tile j and S of tile j+1 in flight together, the
    // softmax of tile j+1 under P·V of tile j
    for (int j = 0; j + 1 < n; ++j) {
      const int st = j % kStages, sn = (j + 1) % kStages;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) acc_to_a(pa[kk], s, kk);
      mbar_wait(sm.full(sn), ((j + 1) / kStages) & 1);
      fence_operands(acc);
      fence_operands(pa);
      turns.begin();
      gemm_qk<P>(s, sq, smem_u32(sm.k(sn)));    // S of tile j+1 (fences, commits)
      gemm_pv<P>(acc, pa, smem_u32(sm.v(st)));  // O += P·V of tile j
      wgmma_commit();
      turns.end();
      wgmma_wait<1>();
      fence_operands(s);
      softmax_at((j + 1) * kKeys);
      wgmma_wait<0>();
      fence_operands(acc);
      fence_operands(pa);
      __syncwarp();
      if (lane == 0) mbar_arrive(sm.empty(st));
      if (!bounded) rescale(acc, alpha);
    }
    // the last tile: only it can straddle kv_len (n <= the tiles below kv_len)
    const int st = (n - 1) % kStages, kv0 = (n - 1) * kKeys;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) acc_to_a(pa[kk], s, kk);
    if (kv0 + kKeys > kv_len) {  // the keys past kv_len add exactly 0, whatever V holds
      zero_tail<P>(sm.v(st), kv_len - kv0, t);
      fence_proxy_async();
      named_bar_sync(3 + cw, 128);
    }
    fence_operands(acc);
    fence_operands(pa);
    turns.begin();
    wgmma_fence();
    gemm_pv<P>(acc, pa, smem_u32(sm.v(st)));
    wgmma_commit();
    turns.end();
    wgmma_wait<0>();
    fence_operands(acc);
    fence_operands(pa);
    __syncwarp();
    if (lane == 0) mbar_arrive(sm.empty(st));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  pol.store(acc, m, l, b, h, row_a, lane, n > 0, sm.q(cw));
  for (int j = n; j < n_blk; ++j) {  // the tiles only the other half sees
    const int s = j % kStages;
    mbar_wait(sm.full(s), (j / kStages) & 1);
    turns.begin();
    turns.end();
    __syncwarp();
    if (lane == 0) mbar_arrive(sm.empty(s));
  }
  while (turns.left > 0) {  // a warpgroup that saw no tile
    turns.begin();
    turns.end();
  }
}

// Launch over q [B, Lq, N, D] and k/v [B, Lk, N, D] packed bf16 (16-byte
// aligned), D = Policy::D. Returns the CUDA error code (cudaErrorInvalidValue
// where the CUDA driver refuses a tensor map).
template <class Policy>
int launch(const void* q, const void* k, const void* v, const Policy& pol, int B, float qscale,
           cudaStream_t stream) {
  using P = typename Policy::P;
  static_assert(Policy::D <= P::kWidth && Policy::D > 64, "the head fits the tile");
  Maps maps;
  // Lk = 0: no key is read, and the K/V maps describe q so that they encode
  const int Lkv = pol.Lk > 0 ? pol.Lk : pol.Lq;
  const void* kk = pol.Lk > 0 ? k : q;
  const void* vv = pol.Lk > 0 ? v : q;
  for (int p = 0; p < 2; ++p) {
    const int cols = p == 0 ? 64 : P::kWidth - 64;
    const CUtensorMapSwizzle sw = p == 0 ? CU_TENSOR_MAP_SWIZZLE_128B : P::kSwizzle1;
    if (!encode_packed_map(&maps.q[p], q, B, pol.Lq, pol.N, Policy::D, kRows, cols, sw) ||
        !encode_packed_map(&maps.k[p], kk, B, Lkv, pol.N, Policy::D, kKeys, cols, sw) ||
        !encode_packed_map(&maps.v[p], vv, B, Lkv, pol.N, Policy::D, kKeys, cols, sw))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_kernel<Policy>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(P::kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((pol.Lq + kBlockRows - 1) / kBlockRows, pol.N, B);
  attn_fwd_kernel<Policy><<<grid, kThreadsWS, P::kSmemBytes, stream>>>(maps, pol, qscale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fwdh
}  // namespace
