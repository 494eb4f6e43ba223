// Grouped matrix products of the Qwen3 MoE (rows 9 and 9b), CUDA C++ for sm_90a.
//
// Replaces the TPU kernels of JAX's megablox grouped GEMM, which the JAX
// package reaches from omnivideo_tpu/models/qwen3vl/text_model.py:135
// (`_grouped_matmul`, moe_impl="megablox"), and megablox's custom VJP
// (megablox/ops.py:63 `_gmm_bwd`):
//   gmm   megablox/gmm.py:314 (pallas_call :526): for each group e,
//         out[rows_e] = lhs[rows_e] · rhs[e], lhs [m, k], rhs [E, k, n] (or,
//         with transpose_rhs, · rhs[e]ᵀ with rhs [E, n, k]) → out [m, n];
//   tgmm  megablox/gmm.py:573 (pallas_call :763): out[e] = lhs[rows_e]ᵀ ·
//         rhs[rows_e], lhs [m, k], rhs [m, n] → out [E, k, n]. Megablox takes
//         lhs already transposed ([k, m]); this kernel reads the [m, k] rows
//         as they are.
// rows_e = [off_e, off_e + group_sizes[e]), off the exclusive scan of the
// group sizes, clamped to [0, m]. Products accumulate in f32 and round once
// to the operands' type (bf16 or f32), as megablox's f32 acc_scratch does.
// gmm writes the rows past the sum of the group sizes as zero (what
// jax.lax.ragged_dot gives them; megablox leaves them unwritten unless the
// experts are sharded); tgmm writes an empty group's block as zero. No
// atomics: every output element is written by one thread, so a call is
// bitwise repeatable.
//
// Bound on the H100. gmm at the Qwen3-VL-30B-A3B prefill (m = 11,848 rows of
// top-8 over 1,481 tokens, E = 128, 2,048 → 768) is memory-bound: 403 MB of
// expert weights against 3.7e10 FLOP (~0.14 ms at 3.35 TB/s, 0.04 ms of bf16
// tensor-core time); the decode (m = 8) reads 8 experts' weights, ~25 MB. The
// SFT's f32 products (m = 16,384) are bound by FFMA (67 TFLOP/s): no TF32,
// as in every f32 path of the port.
//
// Design. The work list is built on the device, so nothing is read back to
// the host: `gmm_meta_kernel` (one block) scans the group sizes and counts
// each group's 128-row tiles (tiles are aligned to multiples of 128 rows,
// so a group boundary inside a tile puts that tile in both groups'
// lists), as megablox's make_group_metadata (gmm.py:79) does. The main grid
// is sized by the static bound ceil(m / 128) + E − 1 of that list, and a
// block past the list's real length exits; ceil(m / 128) more blocks zero
// the rows past the group sum. A block finds its group by a binary search
// of the tile prefix sums, masks its loads to the group's rows (other rows
// read as zero through cp.async's zero fill) and stores only those rows.
// Each block computes a 128 × 128 tile of out through a two-stage cp.async
// pipeline of 16-byte chunks, every operand copied in its own layout:
// bf16 on the tensor cores (mma.sync m16n8k16, f32 accumulators, 8 warps
// of 64 × 32), its fragments read from shared memory as 32-bit words where
// the contraction is contiguous and as two 16-bit reads otherwise; f32 by
// FFMA, 8 × 8 outputs a thread. tgmm runs one block per (group, 128 rows of
// k, 128 columns of n), looping over the group's rows. Simple and right
// first: no TMA, no wgmma, no persistent grid (a later PR's work).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTile = 128;     // rows and columns of an output tile
constexpr int kThreads = 256;  // 8 warps
constexpr int kMaxGroups = 1024;

template <typename T>
struct Cfg;
template <>
struct Cfg<__nv_bfloat16> {
  static constexpr int BK = 32;  // contraction per stage
  static constexpr int VEC = 8;  // elements per 16-byte chunk
};
template <>
struct Cfg<float> {
  static constexpr int BK = 16;
  static constexpr int VEC = 4;
};

// One operand's stage in shared memory: kTile output rows × BK contraction,
// contraction-contiguous (KC: [kTile][BK + VEC]) or row-contiguous
// ([BK][kTile + VEC]); the VEC padding keeps the fragment reads free of
// bank conflicts and every row 16-byte aligned.
template <typename T, bool KC>
struct Tile {
  static constexpr int BK = Cfg<T>::BK;
  static constexpr int VEC = Cfg<T>::VEC;
  static constexpr int LD = KC ? BK + VEC : kTile + VEC;
  static constexpr int SIZE = KC ? kTile * LD : BK * LD;
  __device__ static int at(int r, int kk) { return KC ? r * LD + kk : kk * LD + r; }
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;  // 0: the 16 bytes are zero-filled, nothing is read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::); }

// Copy one stage: 512 chunks of 16 bytes, two a thread. src(r, kk) gives the
// global address of the chunk at output row r, contraction kk (a multiple
// of VEC along the contiguous axis), or nullptr where it lies outside the
// operand or the group; `base` is any valid address for those.
template <typename T, bool KC, typename Src>
__device__ __forceinline__ void load_stage(T* s, const T* base, Src src) {
  using L = Tile<T, KC>;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = threadIdx.x + i * kThreads;
    int r, kk;
    if (KC) {
      r = c / (L::BK / L::VEC);
      kk = (c % (L::BK / L::VEC)) * L::VEC;
    } else {
      kk = c / (kTile / L::VEC);
      r = (c % (kTile / L::VEC)) * L::VEC;
    }
    const T* g = src(r, kk);
    cp_async16(s + L::at(r, kk), g ? g : base, g != nullptr);
  }
}

template <typename T>
__device__ __forceinline__ T from_f32(float v) {
  if constexpr (std::is_same<T, float>::value) {
    return v;
  } else {
    return __float2bfloat16(v);
  }
}

// Elements (r, kk) and (r, kk + 1) of a bf16 stage as one 32-bit fragment
// register, the lower contraction index in the lower half.
template <bool KC>
__device__ __forceinline__ uint32_t pair(const __nv_bfloat16* s, int r, int kk) {
  using L = Tile<__nv_bfloat16, KC>;
  if (KC) return *reinterpret_cast<const uint32_t*>(s + L::at(r, kk));
  const uint32_t lo = *reinterpret_cast<const uint16_t*>(s + L::at(r, kk));
  const uint32_t hi = *reinterpret_cast<const uint16_t*>(s + L::at(r, kk + 1));
  return lo | (hi << 16);
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The accumulators of one thread and the products of one stage.
// bf16: warp w owns rows (w / 4)·64 + [0, 64) and columns (w % 4)·32 +
// [0, 32): 4 × 4 m16n8 tiles, acc[mi][ni][0..3] at rows +g, +g+8 and
// columns +2c, +2c+1 (g = lane / 4, c = lane % 4), the PTX fragment layout.
// f32: thread (tx, ty) = (t % 16, t / 16) owns rows ty + 16i, columns
// tx + 16j, i, j < 8.
template <typename T>
struct Core;

template <>
struct Core<__nv_bfloat16> {
  float acc[4][4][4];
  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
  }
  template <bool A_KC, bool B_KC>
  __device__ void step(const __nv_bfloat16* sa, const __nv_bfloat16* sb) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, c = lane & 3;
    const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
#pragma unroll
    for (int ks = 0; ks < Cfg<__nv_bfloat16>::BK; ks += 16) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int r = wm + mi * 16 + g;
        a[mi][0] = pair<A_KC>(sa, r, ks + 2 * c);
        a[mi][1] = pair<A_KC>(sa, r + 8, ks + 2 * c);
        a[mi][2] = pair<A_KC>(sa, r, ks + 2 * c + 8);
        a[mi][3] = pair<A_KC>(sa, r + 8, ks + 2 * c + 8);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = wn + ni * 8 + g;
        b[ni][0] = pair<B_KC>(sb, col, ks + 2 * c);
        b[ni][1] = pair<B_KC>(sb, col, ks + 2 * c + 8);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni]);
    }
  }
  // put(r, col, v0, v1): the tile's row r, columns col and col + 1 (col even)
  template <typename Put>
  __device__ void store(Put put) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, c = lane & 3;
    const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int r = wm + mi * 16 + g, col = wn + ni * 8 + 2 * c;
        put(r, col, acc[mi][ni][0], acc[mi][ni][1]);
        put(r + 8, col, acc[mi][ni][2], acc[mi][ni][3]);
      }
  }
};

template <>
struct Core<float> {
  float acc[8][8];
  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  template <bool A_KC, bool B_KC>
  __device__ void step(const float* sa, const float* sb) {
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
    for (int kk = 0; kk < Cfg<float>::BK; ++kk) {
      float a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = sa[Tile<float, A_KC>::at(ty + 16 * i, kk)];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = sb[Tile<float, B_KC>::at(tx + 16 * j, kk)];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  // put(r, col, v): one element
  template <typename Put>
  __device__ void store(Put put) const {
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) put(ty + 16 * i, tx + 16 * j, acc[i][j]);
  }
};

// One tile of out = A · B over `steps` stages of the contraction: a_src and
// b_src give the global chunk addresses of stage t (see load_stage).
template <typename T, bool A_KC, bool B_KC, typename ASrc, typename BSrc>
__device__ __forceinline__ void mainloop(Core<T>& core, int steps, const T* a_base,
                                         const T* b_base, ASrc a_src, BSrc b_src) {
  using TA = Tile<T, A_KC>;
  using TB = Tile<T, B_KC>;
  __shared__ __align__(16) T sa[2][TA::SIZE];
  __shared__ __align__(16) T sb[2][TB::SIZE];
  core.zero();
  if (steps <= 0) return;
  load_stage<T, A_KC>(sa[0], a_base, [&](int r, int kk) { return a_src(0, r, kk); });
  load_stage<T, B_KC>(sb[0], b_base, [&](int r, int kk) { return b_src(0, r, kk); });
  cp_async_commit();
  for (int t = 0; t < steps; ++t) {
    if (t + 1 < steps) {
      const int s = (t + 1) & 1;
      load_stage<T, A_KC>(sa[s], a_base, [&](int r, int kk) { return a_src(t + 1, r, kk); });
      load_stage<T, B_KC>(sb[s], b_base, [&](int r, int kk) { return b_src(t + 1, r, kk); });
    }
    cp_async_commit();  // an empty group on the last stage keeps the count uniform
    cp_async_wait1();   // stage t has landed
    __syncthreads();
    core.template step<A_KC, B_KC>(sa[t & 1], sb[t & 1]);
    __syncthreads();  // stage t is read before the next iteration refills it
  }
}

// The device-side work list: meta[0..E] = group row offsets (clamped to
// [0, m]; meta[E] = min(sum, m)), meta[E+1..2E+1] = each group's first tile
// in the list and (last) the list's length. One block of a power of two
// ≥ E threads; Hillis–Steele scans in shared memory.
__global__ void gmm_meta_kernel(const int* __restrict__ sizes, int E, int m,
                                int* __restrict__ meta) {
  __shared__ long long rows[kMaxGroups];
  __shared__ int tiles[kMaxGroups];
  const int e = threadIdx.x;
  const long long g = e < E ? max(sizes[e], 0) : 0;
  rows[e] = g;
  __syncthreads();
  for (int d = 1; d < blockDim.x; d <<= 1) {
    const long long v = e >= d ? rows[e - d] : 0;
    __syncthreads();
    rows[e] += v;
    __syncthreads();
  }
  const int start = static_cast<int>(min(rows[e] - g, static_cast<long long>(m)));
  const int end = static_cast<int>(min(rows[e], static_cast<long long>(m)));
  const int mine = end > start ? (end - 1) / kTile - start / kTile + 1 : 0;
  tiles[e] = mine;
  __syncthreads();
  for (int d = 1; d < blockDim.x; d <<= 1) {
    const int v = e >= d ? tiles[e - d] : 0;
    __syncthreads();
    tiles[e] += v;
    __syncthreads();
  }
  if (e < E) {
    meta[e] = start;
    meta[E + 1 + e] = tiles[e] - mine;
  }
  if (e == E - 1) {
    meta[E] = end;
    meta[2 * E + 1] = tiles[e];
  }
}

// gmm: blockIdx.x < work_slots is a slot of the work list (one 128-row tile
// of one group), else a 128-row tile whose rows past the group sum are
// zeroed; blockIdx.y picks 128 output columns.
template <typename T, bool TRANS>
__global__ void __launch_bounds__(kThreads)
gmm_kernel(const T* __restrict__ lhs, const T* __restrict__ rhs, T* __restrict__ out,
           const int* __restrict__ meta, int E, int m, int k, int n, int work_slots) {
  const int* offs = meta;
  const int* first = meta + E + 1;
  const int slot = blockIdx.x;
  const int n0 = blockIdx.y * kTile;
  if (slot >= work_slots) {
    const int z = slot - work_slots;
    const int lo = max(offs[E], z * kTile), hi = min(m, (z + 1) * kTile);
    const T zero = from_f32<T>(0.f);
    for (int i = threadIdx.x; i < (hi - lo) * kTile; i += kThreads) {
      const int col = n0 + i % kTile;
      if (col < n) out[static_cast<size_t>(lo + i / kTile) * n + col] = zero;
    }
    return;
  }
  if (slot >= first[E]) return;
  int lo = 0, hi = E - 1;  // the last group whose first tile is at or before this slot
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (first[mid] <= slot) lo = mid;
    else hi = mid - 1;
  }
  const int e = lo;
  const int start = offs[e], end = offs[e + 1];
  const int row0 = (start / kTile + slot - first[e]) * kTile;
  const int r0 = max(start, row0), r1 = min(end, row0 + kTile);
  const T* w = rhs + static_cast<size_t>(e) * k * n;
  constexpr int BK = Cfg<T>::BK;
  auto a_src = [&](int t, int r, int kk) -> const T* {
    const int row = row0 + r, kc = t * BK + kk;
    return row >= r0 && row < r1 && kc < k ? lhs + static_cast<size_t>(row) * k + kc : nullptr;
  };
  auto b_src = [&](int t, int r, int kk) -> const T* {  // r: output column
    const int col = n0 + r, kc = t * BK + kk;
    if (col >= n || kc >= k) return nullptr;
    return TRANS ? w + static_cast<size_t>(col) * k + kc : w + static_cast<size_t>(kc) * n + col;
  };
  Core<T> core;
  mainloop<T, true, TRANS>(core, (k + BK - 1) / BK, lhs, w, a_src, b_src);
  if constexpr (std::is_same<T, float>::value) {
    core.store([&](int r, int col, float v) {
      const int row = row0 + r, c = n0 + col;
      if (row >= r0 && row < r1 && c < n) out[static_cast<size_t>(row) * n + c] = v;
    });
  } else {
    core.store([&](int r, int col, float v0, float v1) {
      const int row = row0 + r, c = n0 + col;  // n % 8 == 0: c < n implies c + 1 < n
      if (row >= r0 && row < r1 && c < n)
        *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(row) * n + c) =
            __floats2bfloat162_rn(v0, v1);
    });
  }
}

// tgmm: block (e, kb, nb) computes out[e][kb·128 + [0, 128)][nb·128 + [0, 128)]
// = lhs[rows_e, k-slice]ᵀ · rhs[rows_e, n-slice], zero for an empty group.
template <typename T>
__global__ void __launch_bounds__(kThreads)
tgmm_kernel(const T* __restrict__ lhs, const T* __restrict__ rhs, T* __restrict__ out,
            const int* __restrict__ meta, int k, int n) {
  const int e = blockIdx.x, k0 = blockIdx.y * kTile, n0 = blockIdx.z * kTile;
  const int start = meta[e], end = meta[e + 1];
  constexpr int BK = Cfg<T>::BK;
  auto a_src = [&](int t, int r, int kk) -> const T* {  // r: output row (k), kk: row of lhs
    const int row = start + t * BK + kk, kc = k0 + r;
    return row < end && kc < k ? lhs + static_cast<size_t>(row) * k + kc : nullptr;
  };
  auto b_src = [&](int t, int r, int kk) -> const T* {  // r: output column (n)
    const int row = start + t * BK + kk, col = n0 + r;
    return row < end && col < n ? rhs + static_cast<size_t>(row) * n + col : nullptr;
  };
  Core<T> core;
  mainloop<T, false, false>(core, (end - start + BK - 1) / BK, lhs, rhs, a_src, b_src);
  T* o = out + static_cast<size_t>(e) * k * n;
  if constexpr (std::is_same<T, float>::value) {
    core.store([&](int r, int col, float v) {
      const int kr = k0 + r, c = n0 + col;
      if (kr < k && c < n) o[static_cast<size_t>(kr) * n + c] = v;
    });
  } else {
    core.store([&](int r, int col, float v0, float v1) {
      const int kr = k0 + r, c = n0 + col;
      if (kr < k && c < n)
        *reinterpret_cast<__nv_bfloat162*>(o + static_cast<size_t>(kr) * n + c) =
            __floats2bfloat162_rn(v0, v1);
    });
  }
}

cudaError_t launch_meta(const void* sizes, void* meta, int E, int m, cudaStream_t st) {
  if (E < 1 || E > kMaxGroups) return cudaErrorInvalidValue;
  int threads = 32;
  while (threads < E) threads <<= 1;
  gmm_meta_kernel<<<1, threads, 0, st>>>(static_cast<const int*>(sizes), E, m,
                                        static_cast<int*>(meta));
  return cudaGetLastError();
}

template <typename T, bool TRANS>
void launch_gmm(const void* lhs, const void* rhs, void* out, const void* meta, int m, int k,
                int n, int E, cudaStream_t st) {
  const int row_tiles = (m + kTile - 1) / kTile;
  const int work_slots = row_tiles + E - 1;  // the work list's static bound
  const dim3 grid(work_slots + row_tiles, (n + kTile - 1) / kTile);
  gmm_kernel<T, TRANS><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(lhs), static_cast<const T*>(rhs), static_cast<T*>(out),
      static_cast<const int*>(meta), E, m, k, n, work_slots);
}

template <typename T>
void launch_tgmm(const void* lhs, const void* rhs, void* out, const void* meta, int k, int n,
                 int E, cudaStream_t st) {
  const dim3 grid(E, (k + kTile - 1) / kTile, (n + kTile - 1) / kTile);
  tgmm_kernel<T><<<grid, kThreads, 0, st>>>(static_cast<const T*>(lhs),
                                            static_cast<const T*>(rhs), static_cast<T*>(out),
                                            static_cast<const int*>(meta), k, n);
}

}  // namespace

// Words of int32 scratch the caller allocates for `meta` (the work list).
extern "C" int gmm_meta_words(int E) { return 2 * E + 2; }

// out [m, n] = the grouped product of lhs [m, k] and rhs [E, k, n] (with
// transpose_rhs, rhs [E, n, k]); group_sizes [E] int32 on the device. All
// contiguous, 16-byte aligned, k and n multiples of 8 (bf16) or 4 (f32).
extern "C" int gmm_launch(const void* lhs, const void* rhs, const void* group_sizes, void* out,
                          void* meta, int m, int k, int n, int E, int transpose_rhs, int is_f32,
                          void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = launch_meta(group_sizes, meta, E, m, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (is_f32) {
    if (transpose_rhs) launch_gmm<float, true>(lhs, rhs, out, meta, m, k, n, E, st);
    else launch_gmm<float, false>(lhs, rhs, out, meta, m, k, n, E, st);
  } else {
    if (transpose_rhs) launch_gmm<__nv_bfloat16, true>(lhs, rhs, out, meta, m, k, n, E, st);
    else launch_gmm<__nv_bfloat16, false>(lhs, rhs, out, meta, m, k, n, E, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// out [E, k, n] = per group lhs[rows_e]ᵀ · rhs[rows_e], lhs [m, k], rhs [m, n].
extern "C" int tgmm_launch(const void* lhs, const void* rhs, const void* group_sizes, void* out,
                           void* meta, int m, int k, int n, int E, int is_f32, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = launch_meta(group_sizes, meta, E, m, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (is_f32) launch_tgmm<float>(lhs, rhs, out, meta, k, n, E, st);
  else launch_tgmm<__nv_bfloat16>(lhs, rhs, out, meta, k, n, E, st);
  return static_cast<int>(cudaGetLastError());
}
