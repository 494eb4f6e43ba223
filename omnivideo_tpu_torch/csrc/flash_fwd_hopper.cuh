// Attention forward for Hopper (sm_90a), head dim 128: the mainloop shared by
// two entry points, each of which gives it its own epilogue (and, for the
// ring, its own visibility rules):
//
// - row 3b, the training forward (flash_fwd.cu, flash_fwd_lse_launch):
//   replaces omnivideo_tpu/ops/pallas/flash_attention.py:42 `_fa_kernel`
//   with with_lse=True, via the pallas_call at :430 (`_flash_fwd_impl`);
// - row 8, one ring-attention step merged into a carried (m, l, acc)
//   (ring_step.cu, ring_step_launch): replaces
//   omnivideo_tpu/ops/pallas/ring_attention.py:36 `_step_kernel`, via the
//   pallas_call at :249.
//
// What it computes, for every (b, h, q row) and every key c it sees:
// s = bf16(q·scale·log2e)·k (the exp2 domain, q rounded to bf16 once after
// the scaling, as the plain twins do), the max-tracked online softmax
// m' = max(m, max_c s), l' = l·2^(m−m') + Σ 2^(s−m'),
// acc' = acc·2^(m−m') + Σ bf16(2^(s−m'))·v_c. A masked key's logit is −inf
// while m starts at −1e30 (or arrives finite in a carry), so it adds exactly
// 0; V rows past the key length are zeroed in shared memory before the PV
// product, so a NaN or Inf stored there adds nothing either.
//
// Bound on the H100: operations, 4·B·N·Lq·Lk_seen·D FLOPs on the bf16 tensor
// cores (989 TFLOP/s) plus one exponential per (q row, key): 13.3 ms for the
// DiT's self-attention at [2, 32760, 12, 128], 6.7 ms at batch 1.
//
// Design (FA3's, from hopper_common.cuh's pieces): a block owns 128 q rows of
// one (b, head), tile index fastest in launch order so a head's K/V stays in
// L2; 384 threads: one producer warpgroup (setmaxnreg 40) whose one thread
// loads the q tile once and keeps K/V tiles of 128 keys in flight by TMA
// through a ring of kStages stages (full/empty mbarriers; 4-D maps over the
// packed [B, L, N, D] layout, 128-byte swizzle, zero fill past L), and two
// consumer warpgroups (setmaxnreg 232) of 64 q rows each that read the same
// stages. A consumer pre-scales its q tile in shared memory once, then per
// tile: S = q·kᵀ by wgmma (SS, 64 x 128, K K-major), the softmax in
// registers (row max over the quad shuffles, ex2), p to the bf16 A fragments
// (acc_to_a), and O += p·V by wgmma (RS, V read MN-major). Inside a
// warpgroup the products overlap the exponentials: S of tile j+1 is issued
// together with P·V of tile j, and the softmax of tile j+1 runs while P·V of
// tile j is in flight (the rescale of O waits for it). Across the two
// warpgroups, FA3's ping-pong: they take turns to issue their products, so
// one's exponentials run under the other's products. Per consumer thread:
// O 64 f32, S 64 f32, p 32 bf16 pairs; 168 registers at launch and no
// spill. The last tile is peeled out of the loop: a wgmma issued under a
// runtime branch made ptxas serialise every wgmma (C7520). Measured on the
// H100 (PERF.md): 128-key tiles with 3 stages beat 64-key tiles by 7–10%
// (with 2 stages they lost 20%: a stage is refilled only once both
// consumers are done with it, so two stages leave one tile of look-ahead),
// and the ping-pong gained 2–5%.
//
// Visibility is a prefix of the 64-key halves of the key tiles for every 64
// q rows in every mode the entry points have (kv_len; the ring's block,
// token, stripe and zigzag rules), and each half keeps its own relation (a
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

constexpr int D = 128;
constexpr int kRows = 64;                // q rows per consumer warpgroup; keys per half tile
constexpr int kKeys = 128;               // keys per K/V tile
constexpr int kBlockRows = 2 * kRows;    // q rows per block
constexpr int kStages = 3;
constexpr int kThreadsWS = 384;          // producer warpgroup + two consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr int kProducerRegs = 40;        // 128·40 + 256·232 = 384·168
constexpr int kConsumerRegs = 232;
constexpr float kInitMax = -1e30f;       // m of a row that has seen no key

// shared memory: the two consumers' q tiles (two 64-row panels each), kStages
// stages of K and V (two 128-row panels each), the barriers: 225 KiB of 227
constexpr uint32_t kKPanel = kKeys * 128;  // 128 rows x 64 bf16, 16 KiB
constexpr uint32_t kKTile = 2 * kKPanel;   // 128 rows x 128 bf16, 32 KiB
constexpr uint32_t kQBytes = 2 * kTile;
constexpr uint32_t kStageBytes = 2 * kKTile;
constexpr uint32_t kBarOff = kQBytes + kStages * kStageBytes;
constexpr size_t kSmemBytes = kBarOff + (1 + 2 * kStages) * sizeof(uint64_t) + 1024;  // + align

// The keys of one 64-key half tile that 64 q rows see: none, or every key
// below kv_len and, when `diag`, only those with (col − kb) + shift <= (row − qb).
struct TileMask {
  bool none, diag;
  int qb, kb, shift;
};

struct Smem {
  unsigned char* base;  // 1024-byte aligned
  __device__ unsigned char* q(int wg) const { return base + wg * kTile; }
  __device__ unsigned char* k(int s) const { return base + kQBytes + s * kStageBytes; }
  __device__ unsigned char* v(int s) const { return k(s) + kKTile; }
  __device__ uint64_t* bar(int i) const { return reinterpret_cast<uint64_t*>(base + kBarOff) + i; }
  __device__ uint64_t* q_full() const { return bar(0); }
  __device__ uint64_t* full(int s) const { return bar(1 + s); }
  __device__ uint64_t* empty(int s) const { return bar(1 + kStages + s); }
};

__device__ __forceinline__ Smem smem_layout() {
  extern __shared__ __align__(1024) unsigned char fwdh_smem[];
  const uint32_t a = smem_u32(fwdh_smem);
  return Smem{fwdh_smem + (((a + 1023) & ~1023u) - a)};
}

// q·qscale rounded to bf16, in place, over one 64 x 128 tile (the element
// order does not matter, so the swizzle does not either)
__device__ __forceinline__ void prescale_q(unsigned char* tile, float qscale, int t) {
  uint4* q4 = reinterpret_cast<uint4*>(tile);
  for (int i = t; i < static_cast<int>(kTile / 16); i += 128) {
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

// rows r0..127 of a 128-key tile (both panels; a row is 128 bytes of a panel) set to 0
__device__ __forceinline__ void zero_tail(unsigned char* tile, int r0, int t) {
  const int n16 = (kKeys - r0) * 8;  // 16-byte chunks per panel
  for (int i = t; i < 2 * n16; i += 128) {
    const int p = i / n16, c = i % n16;
    reinterpret_cast<uint4*>(tile + p * kKPanel + r0 * 128)[c] = make_uint4(0u, 0u, 0u, 0u);
  }
}

// S (64 x 128) = q (64 rows at a, K-major) · K (128 rows at b, K-major)ᵀ over
// D; issued and committed as one group
__device__ __forceinline__ void gemm_qk(float (&d)[64], uint32_t a, uint32_t b) {
  constexpr uint32_t hi = wgmma_desc_hi(kKMajorSbo);
  const uint32_t la = wgmma_desc_lo(a, 16), lb = wgmma_desc_lo(b, 16);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < 8; ++k)
    wgmma_ss_n128(d, wgmma_desc(la + (((k / 4) * kPanel + (k % 4) * 32) >> 4), hi),
                  wgmma_desc(lb + (((k / 4) * kKPanel + (k % 4) * 32) >> 4), hi), k > 0);
  wgmma_commit();
}

// O (64 x 128) += P (64 x 128 keys, registers) · V (128 rows at b, MN-major);
// issued only: the caller fences, commits and waits
__device__ __forceinline__ void gemm_pv(float (&d)[64], const uint32_t (&a)[8][4], uint32_t b) {
  constexpr uint32_t hi = wgmma_desc_hi(kKMajorSbo);
  const uint32_t lb = wgmma_desc_lo(b, kKPanel);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_rs_n128_tb(d, a[kk], wgmma_desc(lb + ((kk * 2048) >> 4), hi));
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
// + (i & 1), in half i / 32): masks the keys the rows do not see where `edge`,
// moves the running max, rescales l and returns alpha = 2^(m − m') per row;
// s becomes p.
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], bool edge,
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
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const float p = fast_exp2(s[i] - m[(i >> 1) & 1]);  // a masked key: exactly 0
    l[(i >> 1) & 1] += p;
    s[i] = p;
  }
}

__device__ __forceinline__ void rescale(float (&acc)[64], const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] *= alpha[(i >> 1) & 1];
}

// Policy (the hooks an entry point gives the mainloop):
//   int Lq, Lk, N;                      shapes
//   static constexpr bool kSkipEmpty;   a block that sees no key returns at once
//   int kv_len(b);                      keys of batch row b before any clamp
//   int live_tiles(q0, n);              the prefix of the n 64-key half tiles
//                                       below kv_len that the 64 rows at q0 see
//   TileMask mask(q0, kv0);             how the half tile at kv0 shows to them
//   void load(acc, m, l, b, h, row_a, lane);          the state before the first tile
//   void store(acc, m, l, b, h, row_a, lane, seen);   the epilogue (l summed over the quad)
template <class Policy>
__global__ void __launch_bounds__(kThreadsWS, 1)
attn_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const Policy pol, float qscale) {
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * kBlockRows;
  const int kv_len = min(max(pol.kv_len(b), 0), pol.Lk);
  const int n_halves = (kv_len + kRows - 1) / kRows;
  const int n0 = (pol.live_tiles(q0, n_halves) + 1) / 2;  // 128-key tiles
  const int n1 = q0 + kRows < pol.Lq ? (pol.live_tiles(q0 + kRows, n_halves) + 1) / 2 : 0;
  const int n_blk = max(n0, n1);
  if (Policy::kSkipEmpty && n_blk == 0) return;
  const Smem sm = smem_layout();
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
      mbar_arrive_expect_tx(sm.q_full(), kQBytes);
#pragma unroll
      for (int wg = 0; wg < 2; ++wg)
#pragma unroll
        for (int p = 0; p < 2; ++p)
          tma_load(sm.q(wg) + p * kPanel, &tq, sm.q_full(), p * 64, h, q0 + wg * kRows, b);
      for (int j = 0; j < n_blk; ++j) {
        const int s = j % kStages;
        mbar_wait(sm.empty(s), ((j / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(sm.full(s), kStageBytes);
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          tma_load(sm.k(s) + p * kKPanel, &tk, sm.full(s), p * 64, h, j * kKeys, b);
          tma_load(sm.v(s) + p * kKPanel, &tv, sm.full(s), p * 64, h, j * kKeys, b);
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
  Turns turns{cw, n_blk > 0 ? n_blk + 1 : 0};
  if (cw == 1 && turns.left > 0) named_bar_arrive(1, 256);
  float acc[64], m[2], l[2];
  pol.load(acc, m, l, b, h, row_a, lane);
  if (n > 0) {
    unsigned char* q_tile = sm.q(cw);
    mbar_wait(sm.q_full(), 0);
    prescale_q(q_tile, qscale, t);
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
      softmax_tile(s, m, l, alpha, edge, tm, kv0, kv_len, row_a, lane);
    };
    mbar_wait(sm.full(0), 0);
    turns.begin();
    gemm_qk(s, sq, smem_u32(sm.k(0)));
    turns.end();
    wgmma_wait<0>();
    fence_operands(s);
    softmax_at(0);
    rescale(acc, alpha);
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
      gemm_qk(s, sq, smem_u32(sm.k(sn)));    // S of tile j+1 (fences, commits)
      gemm_pv(acc, pa, smem_u32(sm.v(st)));  // O += P·V of tile j
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
      rescale(acc, alpha);
    }
    // the last tile: only it can straddle kv_len (n <= the tiles below kv_len)
    const int st = (n - 1) % kStages, kv0 = (n - 1) * kKeys;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) acc_to_a(pa[kk], s, kk);
    if (kv0 + kKeys > kv_len) {  // the keys past kv_len add exactly 0, whatever V holds
      zero_tail(sm.v(st), kv_len - kv0, t);
      fence_proxy_async();
      named_bar_sync(3 + cw, 128);
    }
    fence_operands(acc);
    fence_operands(pa);
    turns.begin();
    wgmma_fence();
    gemm_pv(acc, pa, smem_u32(sm.v(st)));
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
  pol.store(acc, m, l, b, h, row_a, lane, n > 0);
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

// Launch over q [B, Lq, N, 128] and k/v [B, Lk, N, 128] packed bf16 (16-byte
// aligned). Returns the CUDA error code (cudaErrorInvalidValue where the
// CUDA driver refuses a tensor map).
template <class Policy>
int launch(const void* q, const void* k, const void* v, const Policy& pol, int B, float qscale,
           cudaStream_t stream) {
  CUtensorMap maps[3];
  // Lk = 0: no key is read, and the K/V maps describe q so that they encode
  const int Lkv = pol.Lk > 0 ? pol.Lk : pol.Lq;
  if (!encode_packed_map(&maps[0], q, B, pol.Lq, pol.N, kRows) ||
      !encode_packed_map(&maps[1], pol.Lk > 0 ? k : q, B, Lkv, pol.N, kKeys) ||
      !encode_packed_map(&maps[2], pol.Lk > 0 ? v : q, B, Lkv, pol.N, kKeys))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_kernel<Policy>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((pol.Lq + kBlockRows - 1) / kBlockRows, pol.N, B);
  attn_fwd_kernel<Policy><<<grid, kThreadsWS, kSmemBytes, stream>>>(maps[0], maps[1], maps[2],
                                                                    pol, qscale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fwdh
}  // namespace
