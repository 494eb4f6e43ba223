// One ring-attention step on f32 operands, CUDA C++ for sm_90a: the TF32
// tensor cores with a three-product split, held to f32.
//
// Replaces the TPU kernel omnivideo_tpu/ops/pallas/ring_attention.py::
// _step_kernel (pallas_call at :249) where its operands are f32: the Pallas
// kernel casts q, k and v to f32 and takes its products in f32, so an f32
// model's attention never passes through bf16 there. ring_step.cu (row 8)
// reads bf16 operands; this file is the same step with f32-accurate products,
// for the trainable ring under an f32 model (the SFT's `--sp`). Rounding q, k
// and v to bf16 moves an f32 model's attention output by ~1e-3 of itself,
// enough to flip a Qwen3 MoE router's top-k choice for some tokens, which
// moves the experts' gradients by percents.
//
// The step and the carry are ring_step.cu's: for every (b, h, q row) and
// visible key column c, in the exp2 domain with s = (q·scale·log2e)·k,
//   m' = max(m, max_c s),  l' = l·2^(m−m') + Σ 2^(s−m'),
//   acc' = acc·2^(m−m') + Σ 2^(s−m')·v_c,
// m, l [B, N, Lq] f32 and acc [B, Lq, N, D] f32 updated in place, and the
// visibility modes 0-4 (none, block, token, stripe, zigzag with any chunk
// length zz) and step_lens as there. p is not rounded to a narrower type:
// the plain twin is ring_step_plain on f32 inputs.
//
// The split. An f32 x is hi + lo with hi = tf32(x) and lo = tf32(x − hi)
// (x − hi is exact in f32), both rounded to nearest (tf32_round), so every
// operand the tensor cores read is an exact tf32 value and the result does
// not depend on how they treat an operand's low 13 bits. A product takes three
// tf32 products summed in f32, a_hi·b_hi + a_hi·b_lo + a_lo·b_hi, leaving
// out a_lo·b_lo: ~2^-21 of |a|·|b| per term, against ~2^-11 for one TF32
// pass (tests/test_torch_ring_f32_split.py emulates this arithmetic on the
// CPU and holds it to the f32 plain twin within 1e-5, where one pass fails).
// S = q_hi·k_hiᵀ + q_hi·k_loᵀ + q_lo·k_hiᵀ with q split after the pre-scaling,
// and O += P_hi·V_hi + P_hi·V_lo + P_lo·V_hi.
//
// Design. A block owns 128 q rows of one (b, head); 384 threads: a producer
// warpgroup (setmaxnreg 40) and two consumer warpgroups (setmaxnreg 232) of
// 64 q rows each, the q tiles of every (b, head) in decreasing order. Producer warp 0 has one thread load both q tiles once and
// keep K/V tiles of 32 keys in flight by TMA (f32 4-D maps over the packed
// [B, L, N, D] layout, 32-column boxes, the 128-byte swizzle: a 128-wide row
// is four panels) through kStages stages (raw_full / ready / empty
// mbarriers). wgmma on tf32 reads only K-major operands: q and K rows are
// D-contiguous, so S = q·kᵀ reads them as TMA wrote them, but V is
// MN-major for P·V. So producer warps 1-3 prepare each stage once TMA lands
// it: K rounded in place to hi, K lo beside it, and V transposed into two
// 128 x 32 panels Vᵀ hi and Vᵀ lo (keys contiguous, one 128-byte swizzled row
// per column of V), with the keys past step_lens zeroed there, so whatever
// those V rows hold adds nothing. The transpose also permutes the keys in
// each group of 8 (position t ← key 2t, t + 4 ← key 2t + 1): the S
// accumulator holds columns 2t and 2t + 1 in a thread's registers, which
// are then the P·V A fragment's k indices t and t + 4, so P goes from S to
// the tensor cores without a shuffle or a trip through shared memory. A
// consumer splits its q tile once (q_hi to 64 registers of A fragments, q_lo
// back in place in shared memory), then per tile: S (64 x 32) by 16 k8 steps
// of q_lo·k_hi (SS), q_hi·k_lo and q_hi·k_hi (RS); the mask, where the tile
// meets a boundary; the online softmax in registers (row max over the quad
// shuffles, exp2); P split into hi and lo fragments; P·V (64 x 128) by 4 k8
// steps of the three products (RS). The tensor cores round their f32
// accumulator toward zero at each step, so an O carried through them over a
// row's keys drifts one way (the same test file emulates it: 1.5e-5 of a
// row's max over 1,024 keys, 32 tiles of 12 steps). So each tile's P·V starts
// from zero instead (four 64 x 32 quarters of the columns, 16 registers
// each) and is added to O by a rounded FMA, O = O·alpha + PV, which keeps
// the drift to one tile's 12 steps. The two consumers overlap each other's
// softmax with their products. Shared memory: the q_lo tiles 64 KiB, and per
// stage K hi, K lo and raw V 16 KiB each, Vᵀ hi and lo 16 KiB each: 224 KiB
// of the 227 with 2 stages, which is why a tile is 32 keys. Measured on the
// H100 (PERF.md): 0.83 ms for the SFT's [2, 2048, 32, 128] token-causal step,
// half its bound, against 7.83 ms for the SIMT kernel this file held before
// and 1.69 ms for f32 SDPA. P·V in quarters (16 accumulator registers at a
// time) and the descriptor bases behind an empty asm keep the consumers within
// 232 registers (4 bytes of spill).
//
// A row's visible keys are a prefix of the shard, and a key a row sees every
// later row sees too, in every mode, so a consumer walks the tiles its last
// row sees, masks only the tiles that its first row does not see whole, and
// a block whose rows see no key returns at once (its carry stays as it is).
// The producer loads the longer of the two consumers' walks; a consumer drains
// (waits, then releases) the stages only the other one uses.
//
// Bound on the H100: operations, 3 tf32 products of 4·B·N·Σ_rows(keys seen)·D
// FLOPs at the tensor cores' 495 TFLOP/s (the f32-accurate rate), or the
// bytes of q, k, v and the carry at 3.35 TB/s where those are more.

#include <math.h>

#include "hopper_common.cuh"

namespace {

constexpr int kD = 128;
constexpr int kRows = 64;               // q rows per consumer warpgroup
constexpr int kBlockRows = 2 * kRows;   // q rows per block
constexpr int kKeys = 32;               // keys per K/V tile
constexpr int kStages = 2;              // K/V tiles in flight
constexpr int kThreads = 384;           // producer warpgroup + two consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr int kPrepWarps = 3;           // producer warps 1-3
constexpr int kProducerRegs = 40;       // 128·40 + 256·232 = 384·168
constexpr int kConsumerRegs = 232;

constexpr uint32_t kRowBytes = 128;               // a swizzled row: 32 f32
constexpr uint32_t kQPanel = kRows * kRowBytes;   // 64 rows x 32 columns, 8 KiB
constexpr uint32_t kQTile = 4 * kQPanel;          // 64 rows x 128 columns
constexpr uint32_t kKPanel = kKeys * kRowBytes;   // 32 keys x 32 columns, 4 KiB
constexpr uint32_t kKTile = 4 * kKPanel;          // 32 keys x 128 columns, 16 KiB
constexpr uint32_t kVtTile = kD * kRowBytes;      // 128 columns of V x 32 keys, 16 KiB
// a stage: K (rounded in place to hi), K lo, V as TMA wrote it, Vᵀ hi, Vᵀ lo
constexpr uint32_t kKHi = 0, kKLo = kKTile, kVRaw = 2 * kKTile, kVtHi = 3 * kKTile;
constexpr uint32_t kVtLo = kVtHi + kVtTile;
constexpr uint32_t kStageBytes = kVtLo + kVtTile;
constexpr uint32_t kQBytes = 2 * kQTile;
constexpr uint32_t kBarOff = kQBytes + kStages * kStageBytes;
constexpr size_t kSmemBytes = kBarOff + (1 + 3 * kStages) * sizeof(uint64_t) + 1024;
static_assert(kSmemBytes <= 232448, "the tiles fit a block's shared memory");
static_assert(kQPanel % 1024 == 0 && kKPanel % 1024 == 0 && kStageBytes % 1024 == 0,
              "panels on 1024-byte boundaries");

struct Maps {
  CUtensorMap q, k, v;
};

struct Step {
  float* m_c;
  float* l_c;
  float* acc_c;
  const int* step_lens;
  int Lq, Lk, N, mode, my, src, n, zz;
  float qscale;
};

struct Smem {
  unsigned char* base;  // 1024-byte aligned
  __device__ unsigned char* q(int wg) const { return base + wg * kQTile; }
  __device__ unsigned char* stage(int s) const { return base + kQBytes + s * kStageBytes; }
  __device__ uint64_t* bar(int i) const {
    return reinterpret_cast<uint64_t*>(base + kBarOff) + i;
  }
  __device__ uint64_t* q_full() const { return bar(0); }
  __device__ uint64_t* raw_full(int s) const { return bar(1 + s); }
  __device__ uint64_t* ready(int s) const { return bar(1 + kStages + s); }
  __device__ uint64_t* empty(int s) const { return bar(1 + 2 * kStages + s); }
};

// Is key column `col` of the visiting shard visible to q row `row`?
__device__ __forceinline__ bool visible(const Step& st, int row, int col) {
  switch (st.mode) {
    case 1:
      return st.src <= st.my;
    case 2:
      return st.src < st.my || (st.src == st.my && col <= row);
    case 3:
      return col + (st.src > st.my ? 1 : 0) <= row;
    case 4: {
      const bool q2 = row >= st.zz, k2 = col >= st.zz;
      const int qc = q2 ? 2 * st.n - 1 - st.my : st.my;
      const int kc = k2 ? 2 * st.n - 1 - st.src : st.src;
      if (kc != qc) return kc < qc;
      return col - (k2 ? st.zz : 0) <= row - (q2 ? st.zz : 0);
    }
    default:
      return true;
  }
}

// The tiles the 64 rows at q0 see: the tiles below klen whose first key the
// last row sees (a prefix, found by bisection).
__device__ int live_tiles(const Step& st, int q0, int klen) {
  const int last = min(q0 + kRows, st.Lq) - 1;
  int lo = 0, hi = (klen + kKeys - 1) / kKeys;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (visible(st, last, mid * kKeys))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// One stage's preparation by a producer warp (w of kPrepWarps), one lane per
// key: K rounded to hi in place and K lo beside it; V split and transposed
// into Vᵀ hi and Vᵀ lo at the key's permuted position, zero where the key is
// past klen (`live` false). Each 16-byte chunk c of a key's row (columns
// 4c..4c+3) is read once; a warp's stores to Vᵀ hit 32 positions of one row.
__device__ __forceinline__ void prep_stage(unsigned char* stage, int key, int w, bool live) {
  const int pos = tf32_key_pos(key);
  for (int c = w; c < kD / 4; c += kPrepWarps) {
    const uint32_t off = (c >> 3) * kKPanel + key * kRowBytes + ((((c & 7) ^ key) & 7) << 4);
    float4* kp = reinterpret_cast<float4*>(stage + kKHi + off);
    float4 lo;
    const float4 hi = tf32_split4(*kp, lo);
    *kp = hi;
    *reinterpret_cast<float4*>(stage + kKLo + off) = lo;
    const float4 v = live ? *reinterpret_cast<const float4*>(stage + kVRaw + off)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    const float ve[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 4 * c + e;
      const uint32_t vo = swz128(d, pos);
      float vh, vl;
      tf32_split(ve[e], vh, vl);
      *reinterpret_cast<float*>(stage + kVtHi + vo) = vh;
      *reinterpret_cast<float*>(stage + kVtLo + vo) = vl;
    }
  }
}

// q·qscale split, over this thread's share of its warpgroup's q tile: hi to
// the A fragments of the 16 k8 steps (qa[kk]: rows r0, r0 + 8, columns
// 8kk + t, 8kk + t + 4), lo back in place, so the tile holds q_lo.
__device__ __forceinline__ void split_q(uint32_t (&qa)[16][4], unsigned char* tile, float qscale,
                                        int r0, int t) {
#pragma unroll
  for (int kk = 0; kk < 16; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + 8 * (e & 1), c = 8 * (kk & 3) + t + 4 * (e >> 1);
      float* p = reinterpret_cast<float*>(tile + (kk >> 2) * kQPanel + swz128(r, c));
      float hi, lo;
      tf32_split(*p * qscale, hi, lo);
      qa[kk][e] = __float_as_uint(hi);
      *p = lo;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
ring_step_f32_kernel(const __grid_constant__ Maps maps, const Step st) {
  // heaviest first: block i (launch order) takes q tile nx − 1 − i / (N·B) of
  // head-and-row i % (N·B), so under a causal mask the blocks that walk the
  // most key tiles start first and the lightest make the last wave
  const int hb = gridDim.y * gridDim.z;
  const int blk = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  const int h = (blk % hb) % gridDim.y, b = (blk % hb) / gridDim.y;
  const int q0 = (gridDim.x - 1 - blk / hb) * kBlockRows;
  const int klen = max(0, st.step_lens != nullptr ? min(st.step_lens[b], st.Lk) : st.Lk);
  const int n0 = live_tiles(st, q0, klen);
  const int n1 = q0 + kRows < st.Lq ? live_tiles(st, q0 + kRows, klen) : 0;
  const int n_blk = max(n0, n1);
  if (n_blk == 0) return;  // no row sees a key: the carry stays as it is
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t a0 = smem_u32(smem_raw);
  const Smem sm{smem_raw + (((a0 + 1023) & ~1023u) - a0)};
  if (threadIdx.x == 0) {
    mbar_init(sm.q_full(), 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(sm.raw_full(s), 1);
      mbar_init(sm.ready(s), kPrepWarps);
      mbar_init(sm.empty(s), kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup
    setmaxnreg_dec<kProducerRegs>();
    const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (w == 0) {  // one thread starts every load
      if (lane == 0) {
        mbar_arrive_expect_tx(sm.q_full(), kQBytes);
#pragma unroll
        for (int wg = 0; wg < 2; ++wg)
#pragma unroll
          for (int p = 0; p < 4; ++p)
            tma_load(sm.q(wg) + p * kQPanel, &maps.q, sm.q_full(), 32 * p, h, q0 + wg * kRows, b);
        for (int j = 0; j < n_blk; ++j) {
          const int s = j % kStages;
          unsigned char* stage = sm.stage(s);
          mbar_wait(sm.empty(s), ((j / kStages) & 1) ^ 1);
          mbar_arrive_expect_tx(sm.raw_full(s), 2 * kKTile);
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            tma_load(stage + kKHi + p * kKPanel, &maps.k, sm.raw_full(s), 32 * p, h, j * kKeys, b);
            tma_load(stage + kVRaw + p * kKPanel, &maps.v, sm.raw_full(s), 32 * p, h, j * kKeys,
                     b);
          }
        }
      }
    } else {  // warps 1-3 prepare each stage once it lands
      for (int j = 0; j < n_blk; ++j) {
        const int s = j % kStages;
        mbar_wait(sm.raw_full(s), (j / kStages) & 1);
        prep_stage(sm.stage(s), lane, w - 1, j * kKeys + lane < klen);
        fence_proxy_async();  // the generic writes before wgmma reads them
        __syncwarp();
        if (lane == 0) mbar_arrive(sm.ready(s));
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();  // consumer warpgroups: 64 q rows each
  const int cw = threadIdx.x / 128 - 1;
  const int t = threadIdx.x % 128, lane = t % 32;
  const int q0c = q0 + cw * kRows;
  const int r0 = (t / 32) * 16 + lane / 4;  // this thread's rows in the tile: r0, r0 + 8
  const int row_a = q0c + r0;
  const int n = cw ? n1 : n0;
  float acc[64], m[2], l[2];
  ring_carry_load(acc, m, l, st.m_c, st.l_c, st.acc_c, st.Lq, st.N, b, h, row_a, lane);
  if (n > 0) {
    unsigned char* q_tile = sm.q(cw);
    uint32_t qa[16][4];
    mbar_wait(sm.q_full(), 0);
    split_q(qa, q_tile, st.qscale, r0, lane % 4);
    fence_proxy_async();  // q_lo's generic writes before wgmma reads them
    named_bar_sync(3 + cw, 128);
    constexpr uint32_t hi = wgmma_desc_hi(kKMajorSbo);
    const uint32_t qlo0 = wgmma_desc_lo(smem_u32(q_tile), 16);
    for (int j = 0; j < n; ++j) {
      const int s = j % kStages, kv0 = j * kKeys;
      // the bases pass an empty asm each tile, so the compiler derives the
      // descriptors here rather than holding all of them across the loop
      uint32_t base = smem_u32(sm.stage(s)), qlo = qlo0;
      asm volatile("" : "+r"(base), "+r"(qlo));
      const uint32_t khi = wgmma_desc_lo(base + kKHi, 16), klo = wgmma_desc_lo(base + kKLo, 16);
      const uint32_t vhi = wgmma_desc_lo(base + kVtHi, 16), vlo = wgmma_desc_lo(base + kVtLo, 16);
      mbar_wait(sm.ready(s), (j / kStages) & 1);
      // S (64 x 32) = q_lo·k_hiᵀ + q_hi·k_loᵀ + q_hi·k_hiᵀ, the small terms first
      float sc[16];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 16; ++kk)
        wgmma_tf32_ss_n32(sc, wgmma_desc(qlo + (((kk >> 2) * kQPanel + (kk & 3) * 32) >> 4), hi),
                          wgmma_desc(khi + (((kk >> 2) * kKPanel + (kk & 3) * 32) >> 4), hi),
                          kk > 0);
#pragma unroll
      for (int kk = 0; kk < 16; ++kk)
        wgmma_tf32_rs_n32(sc, qa[kk],
                          wgmma_desc(klo + (((kk >> 2) * kKPanel + (kk & 3) * 32) >> 4), hi), 1);
#pragma unroll
      for (int kk = 0; kk < 16; ++kk)
        wgmma_tf32_rs_n32(sc, qa[kk],
                          wgmma_desc(khi + (((kk >> 2) * kKPanel + (kk & 3) * 32) >> 4), hi), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(sc);
      // entry i: row row_a + 8·((i >> 1) & 1), key kv0 + 8·(i / 4) + 2·(lane % 4) + (i & 1)
      const bool whole = kv0 + kKeys <= klen && visible(st, q0c, kv0 + kKeys - 1);
      if (!whole) {
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int col = kv0 + (i / 4) * 8 + (lane % 4) * 2 + (i & 1);
          if (col >= klen || !visible(st, row_a + ((i >> 1) & 1) * 8, col)) sc[i] = -INFINITY;
        }
      }
      float mc[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 16; ++i) mc[(i >> 1) & 1] = fmaxf(mc[(i >> 1) & 1], sc[i]);
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mc[r] = fmaxf(mc[r], __shfl_xor_sync(0xffffffffu, mc[r], 1));
        mc[r] = fmaxf(mc[r], __shfl_xor_sync(0xffffffffu, mc[r], 2));
        const float m_new = fmaxf(m[r], mc[r]);  // >= −1e30: finite
        alpha[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
      // P split into the A fragments of the 4 k8 steps of P·V: a0..a3 take
      // entries 0, 2, 1, 3 of each n8 group (keys 2t and 2t + 1 of rows r0 and
      // r0 + 8), which the Vᵀ panels hold at positions t and t + 4
      uint32_t ph[4][4], pl[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * kk + ((e & 1) << 1) + (e >> 1);
          const float p = exp2f(sc[i] - m[(i >> 1) & 1]);  // a masked key: exactly 0
          l[(i >> 1) & 1] += p;
          float p_hi, p_lo;
          tf32_split(p, p_hi, p_lo);
          ph[kk][e] = __float_as_uint(p_hi);
          pl[kk][e] = __float_as_uint(p_lo);
        }
      }
      fence_operands(ph);
      fence_operands(pl);
      // O = O·alpha + (P_lo·V_hi + P_hi·V_lo + P_hi·V_hi), a quarter of the
      // columns at a time: the tile's product in a fresh accumulator (64 x 32;
      // Vᵀ rows 32·qt..), folded into O by a rounded FMA
#pragma unroll
      for (int qt = 0; qt < 4; ++qt) {
        float pv[16];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint32_t off = (qt * 32 * kRowBytes + kk * 32) >> 4;
          wgmma_tf32_rs_n32(pv, pl[kk], wgmma_desc(vhi + off, hi), kk > 0);
          wgmma_tf32_rs_n32(pv, ph[kk], wgmma_desc(vlo + off, hi), 1);
          wgmma_tf32_rs_n32(pv, ph[kk], wgmma_desc(vhi + off, hi), 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(pv);
#pragma unroll
        for (int i = 0; i < 16; ++i)
          acc[16 * qt + i] = fmaf(acc[16 * qt + i], alpha[(i >> 1) & 1], pv[i]);
      }
      fence_operands(ph);
      fence_operands(pl);
      __syncwarp();
      if (lane == 0) mbar_arrive(sm.empty(s));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    ring_carry_store(acc, m, l, st.m_c, st.l_c, st.acc_c, st.Lq, st.N, b, h, row_a, lane);
  }
  for (int j = n; j < n_blk; ++j) {  // the tiles only the other warpgroup sees
    const int s = j % kStages;
    mbar_wait(sm.ready(s), (j / kStages) & 1);
    __syncwarp();
    if (lane == 0) mbar_arrive(sm.empty(s));
  }
}

}  // namespace

// q [B, Lq, N, 128] and k/v [B, Lk, N, 128] packed f32 (16-byte aligned); m, l
// [B, N, Lq] f32 and acc [B, Lq, N, 128] f32 updated in place; step_lens [B]
// int32 or null. mode: 0 none, 1 block, 2 token, 3 stripe, 4 zigzag (zz =
// chunk length, any positive value). Returns the CUDA error code
// (cudaErrorInvalidValue where the CUDA driver refuses a tensor map).
extern "C" int ring_step_f32_launch(const void* q, const void* k, const void* v, void* m,
                                    void* l, void* acc, const void* step_lens, int B, int Lq,
                                    int Lk, int N, int head_dim, int mode, int my, int src, int n,
                                    int zz, float qscale, void* stream) {
  if (head_dim != kD || mode < 0 || mode > 4 || (mode == 4 && zz <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  Maps maps;
  if (!encode_packed_map_f32(&maps.q, q, B, Lq, N, kRows) ||
      !encode_packed_map_f32(&maps.k, k, B, Lk, N, kKeys) ||
      !encode_packed_map_f32(&maps.v, v, B, Lk, N, kKeys))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(ring_step_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const Step st{static_cast<float*>(m), static_cast<float*>(l), static_cast<float*>(acc),
                static_cast<const int*>(step_lens), Lq, Lk, N, mode, my, src, n, zz, qscale};
  const dim3 grid((Lq + kBlockRows - 1) / kBlockRows, N, B);
  ring_step_f32_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(maps,
                                                                                         st);
  return static_cast<int>(cudaGetLastError());
}
