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
// - row 2, D = 128, CAUSAL: the Qwen3 text prefill, _fa_kernel(causal=True):
//   col ≤ row (:111-114), kv_lens still applies; the key tiles that start
//   past a consumer's last row are not loaded, and only the tile that holds
//   the diagonal is masked;
// - row 3a, D = 72, non-causal: the Qwen3-VL vision tower. The TPU needed a
//   head-major transpose for D % 128 ≠ 0 (:308-318, 128-lane tiles); here
//   the tensor maps read the 144-byte head rows in place.
// And the training forward (row 3b), _fa_kernel(with_lse=True) via
// _flash_fwd_impl (pallas_call at :430, reached through the custom-VJP rule
// _fa_fwd :628): always max-tracked, and it also writes the natural-log row
// logsumexp LSE = m·ln2 + ln(max(l, 1e-30)) (:174-175) to lse [B, N, Lq]
// f32, the residual the backward kernels of flash_train.cu read. A row with
// no live key keeps m = −1e30, l = 0 and gets o = 0.
//
// All four run the Hopper forward mainloop of flash_fwd_hopper.cuh (wgmma
// fed by TMA through an mbarrier ring, one producer and two consumer
// warpgroups that take turns, the exponentials of one tile under the
// products of another), each with this file's epilogue policy: InferOut for
// rows 1 and 3a (o only; bounded or max-tracked as `safe` says), CausalOut
// for row 2 (InferOut's state with the causal visibility, the q tiles with
// the most key tiles launched first, o staged through shared memory), LseOut
// for row 3b.
// Row 3a runs it on an 80-wide tile: a 64-column panel with the 128-byte
// swizzle and a 16-column panel with the 32-byte swizzle, whose columns
// 72..79 TMA fills with zeros, so q·kᵀ is five k16 steps instead of eight
// and P·V an n64 and an n16 product per k16 step (O is 40 f32 a thread).
// Bound on the H100: operations, 4·B·N·D FLOPs per visible (q row, key)
// pair on the bf16 tensor cores (989 TFLOP/s): row 1's self-attention at
// [2, 32760, 12, 128] is 13.2 TFLOP, 13.3 ms; its cross-attention over 6,272
// keys 2.55 ms; row 2 at [1, 1481, 32, 128] (1481·1482/2 pairs a head)
// 0.018 ms; row 3a at [3, 1560, 16, 72] 0.034 ms; row 3b at
// [1, 32760, 12, 128] 6.7 ms.
//
// Layout: q/k/v/o are read and written in place as packed [B, L, N·D] — the
// layout the projection GEMMs produce (a row is N·D elements, a head's slice
// starts at n·D: 16-byte aligned for D = 72 and 128).

#include "flash_fwd_hopper.cuh"

namespace {

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

// o = acc / l in bf16 for a consumer warpgroup's 64 rows at head dim 128,
// staged in its q tile (64 rows of 256 bytes; free once its last product is
// done): each thread writes its two rows as bf16 pairs, 16-byte chunk c of
// tile row r at chunk c ^ (r & 7) (a warp's 8 rows × 4 lanes then fall in 32
// distinct banks), the warpgroup syncs, and each thread stores whole chunks,
// a warp two full 256-byte rows per store. One reciprocal per row. Rows past
// Lq are not stored, a row with l = 0 gets 0. Against store_o, whose stores
// are 4 bytes of 8 rows a warp after an IEEE division per entry, it takes
// most of the causal prefill's epilogue away (PERF.md).
__device__ __forceinline__ void store_o_staged(__nv_bfloat16* o, unsigned char* tile,
                                               const float (&acc)[64], const float (&l)[2], int b,
                                               int h, int row_a, int lane, int Lq, int N) {
  const int t = threadIdx.x % 128;
  const int q0c = row_a - (t / 32) * 16 - lane / 4;  // the warpgroup's first row
  if (q0c >= Lq) return;  // uniform over the warpgroup
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a - q0c + r * 8;
    const float inv = l[r] == 0.f ? 1.f : __frcp_rn(l[r]);
    unsigned char* dst = tile + row * 256 + (lane % 4) * 4;
#pragma unroll
    for (int i = 0; i < 16; ++i)
      *reinterpret_cast<uint32_t*>(dst + ((i ^ (row & 7)) << 4)) =
          pack_bf16(__fmul_rn(acc[4 * i + 2 * r], inv), __fmul_rn(acc[4 * i + 2 * r + 1], inv));
  }
  fwdh::consumer_sync();
  const size_t ld = static_cast<size_t>(N) * 128;
  __nv_bfloat16* out =
      o + (static_cast<size_t>(b) * Lq + q0c) * ld + static_cast<size_t>(h) * 128;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int row = (t + 128 * k) / 16, c = t % 16;
    if (q0c + row < Lq)
      *reinterpret_cast<uint4*>(out + row * ld + c * 8) =
          *reinterpret_cast<const uint4*>(tile + row * 256 + ((c ^ (row & 7)) << 4));
  }
}

// Rows 1 and 3a's hooks into the Hopper mainloop (and row 2's state, through
// CausalOut): every key below kv_len, bounded when the device flag `safe` is set (m is the bound mb[b, h] from
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
  static constexpr bool kHeavyFirst = false;

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
                        int b, int h, int row_a, int lane, bool, unsigned char*) const {
    store_o<D>(o, acc, l, b, h, row_a, lane, Lq, N);
  }
};

// Row 2's hooks into the Hopper mainloop: InferOut<128>'s state (bounded or
// max-tracked as `safe` says; a batch row with kv_len = 0 writes zeros) under
// token causality, col <= row. The 64 rows at q0 see the 64-key halves that
// start at or before their last row; the mainloop masks only a half whose
// last key lies past q0, with the triangle (col − kb) + shift <= (row − qb)
// at qb = kb = shift = 0, which is col <= row (as the ring's token mode has
// it for its own shard). The q tile j walks j + 1 key tiles: kHeavyFirst
// launches the heaviest tiles of every head first. A block walks 6.5 key
// tiles on average at the prefill's 1,481 tokens, so its epilogue weighs:
// o goes out through store_o_staged.
struct CausalOut : InferOut<128> {
  static constexpr bool kHeavyFirst = true;

  __device__ int live_tiles(int q0, int n_tiles) const {
    return min(n_tiles, q0 / fwdh::kRows + 1);
  }
  __device__ fwdh::TileMask mask(int q0, int kv0) const {
    return {kv0 > q0 + fwdh::kRows - 1, true, 0, 0, 0};
  }

  __device__ void store(const float (&acc)[64], const float (&)[2], const float (&l)[2], int b,
                        int h, int row_a, int lane, bool, unsigned char* tile) const {
    store_o_staged(o, tile, acc, l, b, h, row_a, lane, Lq, N);
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
  static constexpr bool kHeavyFirst = false;

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
                        int h, int row_a, int lane, bool, unsigned char*) const {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_a + r * 8;
      if (row < Lq && lane % 4 == 0)  // m is in log2 units, l domain-free
        lse[(static_cast<size_t>(b) * N + h) * Lq + row] = m[r] * kLn2 + logf(fmaxf(l[r], 1e-30f));
    }
    store_o<D>(o, acc, l, b, h, row_a, lane, Lq, N);
  }
};

// InferOut<HD> over flash_fwd_launch's arguments
template <int HD>
InferOut<HD> infer_out(void* o, const void* kv_lens, const void* mbound, const void* safe,
                       int Lq, int Lk, int N) {
  return {static_cast<__nv_bfloat16*>(o), static_cast<const int*>(kv_lens),
          static_cast<const int*>(mbound), static_cast<const int*>(safe), Lq, Lk, N};
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
  if (head_dim == 128) {
    const InferOut<128> pol = infer_out<128>(o, kv_lens, mbound, safe, Lq, Lk, N);
    return causal ? fwdh::launch(q, k, v, CausalOut{pol}, B, qscale, s)
                  : fwdh::launch(q, k, v, pol, B, qscale, s);
  }
  if (head_dim == 72 && !causal)
    return fwdh::launch(q, k, v, infer_out<72>(o, kv_lens, mbound, safe, Lq, Lk, N), B, qscale,
                        s);
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
