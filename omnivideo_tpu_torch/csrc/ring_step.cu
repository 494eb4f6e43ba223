// One ring-attention step, CUDA C++ for sm_90a (bf16 q/k/v, f32 carry).
//
// Replaces the TPU kernel omnivideo_tpu/ops/pallas/ring_attention.py::
// _step_kernel (pallas_call at :249, driven by ring_flash_attention_shard
// :291): flash attention of this rank's q shard against the K/V shard that
// is visiting on this step, merged into the carried online-softmax state.
// For every (b, h, q row) and visible key column c:
//   m' = max(m, max_c s),  l' = l·2^(m−m') + Σ 2^(s−m'),
//   acc' = acc·2^(m−m') + Σ bf16(2^(s−m'))·v_c,
// with s = bf16(q·scale·log2e)·k in the exp2 domain, as flash_fwd.cu keeps
// it: m is in log2 units of the scaled logits, l and acc are domain-free.
// The carry lives in device memory and is updated in place: m, l [B, N, Lq]
// f32 (no lane broadcast), acc [B, Lq, N, D] f32 packed like q. A step whose
// every tile is invisible to a block leaves that block's carry untouched.
//
// Visibility (the Pallas kernel's rules, :126-185), with `my` this rank,
// `src` the rank the visiting shard came from, n ranks, positions local to
// the shards:
//   mode 0: every key;
//   mode 1, block-causal: the whole shard iff src <= my;
//   mode 2, token-causal: src < my all, src == my col <= row, src > my none;
//   mode 3, stripe: col + (src > my) <= row;
//   mode 4, zigzag: each shard holds chunks (r, 2n−1−r) of length zz; the
//           chunk ids compare, and equal chunks take the triangle on the
//           offsets inside the chunk (zz % 64 == 0, so no 64-key half of a
//           tile straddles).
// step_lens[b] masks columns >= it (the valid keys of the visiting shard,
// from the global kv_lens of contiguous end padding); the V rows past it are
// zeroed in shared memory, so whatever they hold adds nothing. Tiles with no
// visible key are skipped, never loaded; only tiles that straddle a boundary
// are masked. A masked logit is −inf while the carry's m starts at −1e30, so a
// masked key adds exactly 0: a row that has seen no key yet keeps m = −1e30,
// l = 0, acc = 0 (the Pallas kernel carries phantom mass there until the
// first real key wipes it; valid rows agree either way).
//
// Bound on the H100: operations, 4·B·N·Lq·Lk_visible·D FLOPs on the bf16
// tensor cores (989 TFLOP/s): the sp phase's step ([2, 32760, 12, 128] q
// against 32,760 keys) 13.2 TFLOP, 13.3 ms; at the 1.3B DiT's sp = 4 shape
// ([2, 8190, 12, 128] q against 8,190 keys) 0.83 ms. Design: the Hopper
// forward mainloop of flash_fwd_hopper.cuh (wgmma fed by TMA through an
// mbarrier ring, one producer and two consumer warpgroups of 64 q rows, the
// exponentials of one tile under the products of another) with this file's
// hooks: the visibility rules, taken per consumer warpgroup on its own 64
// rows (a 128-row block straddles a zigzag chunk boundary when zz % 128 ==
// 64, and the stripe and token diagonals fall in different tiles for the two
// halves), and the carry, loaded into the registers of the O accumulator at
// the start and stored back at the end. The K/V send to the next rank is not
// in the kernel: it is NCCL point-to-point, posted before the launch on its
// own stream (ops/ring_attention.py).

#include <math.h>

#include "flash_fwd_hopper.cuh"

namespace {

using fwdh::kRows;
using fwdh::TileMask;

enum Kind { kNone = 0, kFull = 1, kDiag = 2 };

// How the keys of the 64-column tile at kv0 relate to the 64 q rows at q0:
// none visible, all visible, or the triangle (col − kb) + shift <= (row − qb).
struct Rel {
  int kind, qb, kb, shift;
};

__device__ __forceinline__ Rel relation(int mode, int q0, int kv0, int my, int src, int n,
                                        int zz) {
  switch (mode) {
    case 1:
      return {src <= my ? kFull : kNone, 0, 0, 0};
    case 2:
      return {src < my ? kFull : (src == my ? kDiag : kNone), 0, 0, 0};
    case 3:
      return {kDiag, 0, 0, src > my ? 1 : 0};
    case 4: {
      const bool q2 = q0 >= zz, k2 = kv0 >= zz;
      const int qc = q2 ? 2 * n - 1 - my : my;
      const int kc = k2 ? 2 * n - 1 - src : src;
      if (kc != qc) return {kc < qc ? kFull : kNone, 0, 0, 0};
      return {kDiag, q2 ? zz : 0, k2 ? zz : 0, 0};
    }
    default:
      return {kFull, 0, 0, 0};
  }
}

// Row 8's hooks into the Hopper mainloop.
struct RingCarry {
  static constexpr int D = 128;
  using P = fwdh::Panels<64>;
  float* m_c;
  float* l_c;
  float* acc_c;
  const int* step_lens;
  int Lq, Lk, N, mode, my, src, n, zz;
  static constexpr bool kSkipEmpty = true;  // no visible tile: the carry stays as it is
  static constexpr bool kHeavyFirst = false;

  __device__ int kv_len(int b) const { return step_lens != nullptr ? step_lens[b] : Lk; }
  __device__ bool bounded() const { return false; }  // the carry is max-tracked

  // a tile is live when one of its keys is visible to one of the 64 rows at q0
  __device__ bool live(int q0, int j) const {
    const Rel r = relation(mode, q0, j * kRows, my, src, n, zz);
    if (r.kind == kNone) return false;
    return r.kind == kFull || (j * kRows - r.kb) + r.shift <= (q0 - r.qb) + kRows - 1;
  }

  // In every mode the live 64-key tiles of 64 rows are a prefix (a zigzag
  // shard's first chunk id is below its second), so the first dead tile is
  // found by bisection.
  __device__ int live_tiles(int q0, int n_tiles) const {
    int lo = 0, hi = n_tiles;
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (live(q0, mid))
        lo = mid + 1;
      else
        hi = mid;
    }
    return lo;
  }

  __device__ TileMask mask(int q0, int kv0) const {
    const Rel r = relation(mode, q0, kv0, my, src, n, zz);
    return {r.kind == kNone, r.kind == kDiag, r.qb, r.kb, r.shift};
  }

  // carry in: rows row_a and row_a + 8; l goes to one lane of each quad so
  // the quad's shares still sum to the row's l
  __device__ void load(float (&acc)[64], float (&m)[2], float (&l)[2], int b, int h, int row_a,
                       int lane) const {
    const size_t stat0 = (static_cast<size_t>(b) * N + h) * Lq;
    const size_t ld = static_cast<size_t>(N) * D;
    const float* accg = acc_c + static_cast<size_t>(b) * Lq * ld + static_cast<size_t>(h) * D +
                        (lane % 4) * 2;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_a + r * 8;
      const bool ok = row < Lq;
      m[r] = ok ? m_c[stat0 + row] : fwdh::kInitMax;
      l[r] = ok && lane % 4 == 0 ? l_c[stat0 + row] : 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float2 a = ok ? *reinterpret_cast<const float2*>(accg + row * ld + i * 8)
                            : make_float2(0.f, 0.f);
        acc[4 * i + 2 * r] = a.x;
        acc[4 * i + 2 * r + 1] = a.y;
      }
    }
  }

  // carry out, in place, where this warpgroup saw a tile
  __device__ void store(const float (&acc)[64], const float (&m)[2], const float (&l)[2], int b,
                        int h, int row_a, int lane, bool seen, unsigned char*) const {
    if (!seen) return;
    const size_t stat0 = (static_cast<size_t>(b) * N + h) * Lq;
    const size_t ld = static_cast<size_t>(N) * D;
    float* accg = acc_c + static_cast<size_t>(b) * Lq * ld + static_cast<size_t>(h) * D +
                  (lane % 4) * 2;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_a + r * 8;
      if (row >= Lq) continue;
      if (lane % 4 == 0) {
        m_c[stat0 + row] = m[r];
        l_c[stat0 + row] = l[r];
      }
#pragma unroll
      for (int i = 0; i < 16; ++i)
        *reinterpret_cast<float2*>(accg + row * ld + i * 8) =
            make_float2(acc[4 * i + 2 * r], acc[4 * i + 2 * r + 1]);
    }
  }
};

}  // namespace

// q [B, Lq, N, 128] and k/v [B, Lk, N, 128] packed bf16 (16-byte aligned);
// m, l [B, N, Lq] f32 and acc [B, Lq, N, 128] f32 updated in place;
// step_lens [B] int32 or null. mode: 0 none, 1 block, 2 token, 3 stripe,
// 4 zigzag (zz = chunk length, a multiple of 64). Returns the CUDA error code.
extern "C" int ring_step_launch(const void* q, const void* k, const void* v, void* m, void* l,
                                void* acc, const void* step_lens, int B, int Lq, int Lk, int N,
                                int head_dim, int mode, int my, int src, int n, int zz,
                                float qscale, void* stream) {
  if (head_dim != RingCarry::D || mode < 0 || mode > 4 || (mode == 4 && (zz <= 0 || zz % kRows != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const RingCarry pol{static_cast<float*>(m), static_cast<float*>(l), static_cast<float*>(acc),
                      static_cast<const int*>(step_lens), Lq, Lk, N, mode, my, src, n, zz};
  return fwdh::launch(q, k, v, pol, B, qscale, static_cast<cudaStream_t>(stream));
}
