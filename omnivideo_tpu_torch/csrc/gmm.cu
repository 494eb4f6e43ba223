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
// experts are sharded); tgmm writes an empty group's block as zero. No float
// atomics: every output element is summed by one thread in a fixed order,
// so a call is bitwise repeatable.
//
// One launch a call. Every block reads the group sizes itself (the many-row
// kernels: warp 0 scans a copy in shared memory into the rows of each group
// and the work list, megablox's make_group_metadata, gmm.py:79; the few-row
// kernel: one warp finds its own group straight from global memory); nothing
// is read back to the host and no second kernel builds the list.
//
// Bounds on the H100 at Qwen3-VL-30B-A3B's MoE (128 experts, top-8, 2,048 →
// 768 → 2,048), and at the banks split over n cards by `--vlm_fsdp n` (768 /
// n columns of every bank a card: n = 2, 4 give 384 and 192), and what each
// schedule (ops/gmm.py `gmm_schedule`, from the static shape) does about them:
// - bf16 gmm at many rows (the prefill: 11,848 rows, ~80 experts hit) is
//   bound by bytes: each hit expert's bank once, the rows and the output
//   (~318 MB, 0.095 ms at 3.35 TB/s, against 0.04 ms of bf16 tensor-core
//   time; split over 2 / 4 cards ~188 / ~118 MB, 0.056 / 0.035 ms).
//   `gmm_wgmma_kernel<BN>`: a persistent grid (one block an SM) walks the
//   work list of (group, 128 rows from the group's first row) × BN output
//   columns, neighbouring blocks on one group's tiles so that its bank is read
//   from HBM about once and then from the 50 MB L2. It is held by what it
//   keeps in flight (two stages instead of four nearly halve its rate): a
//   producer warp keeps as many 64-deep k panels in flight by TMA as fit
//   (128-byte swizzle, a 2-D map over the rows and a 3-D map over the bank,
//   so a box never crosses into the next expert; the k tail and rows past m
//   zero-filled; a tile whose second 64 rows are all the next group's loads
//   one A box); two consumer warpgroups run wgmma m64nBNk16 on them, the bank
//   read MN-major through the transpose bit (K-major under transpose_rhs).
//   The column tile BN is 256, 192 or 128, so that no tile computes more
//   than a 64-column box past n (at 384 and 192 columns a 256-column tile
//   left a quarter of its products idle): 192 at n = 768, 384 and 192 (four
//   stages against 256's three), 256 at n = 2,048. A tile starts at its
//   group's first row, so the rows of the next group inside it are
//   multiplied and not stored (megablox masks its stores the same way). Each
//   consumer stages its 64 x BN tile in shared memory as bf16 and one thread
//   stores it by TMA (where the tile ends inside the next group, its threads
//   copy the group's rows out in 16-byte chunks), so it issues the next
//   tile's products while the store drains: at the down projection's 3–12 k
//   steps a tile, the 4-byte stores from the fragments held the consumers
//   (0.131–0.137 against 0.150–0.163 ms at 2,048 columns, the same tiles).
// - bf16 gmm at few rows (m <= 64, the decode: 8 rows, one a group) is a
//   weight stream: 8 banks, 25 MB (12.6 / 6.3 MB split over 2 / 4 cards),
//   7.5 µs (3.8 / 1.9 µs) at 3.35 TB/s, and at these sizes a block's fixed
//   cost (the launch, the first loads' latency, the sum) is of the same order.
//   `gmm_splitk_kernel<BN>`: block (group j, BN = 128 or 64 columns, split
//   s) finds group j with one warp, issues every k step of its split at once
//   where shared memory holds them (an A box of m rounded up to 8 rows, not
//   64, and BN columns of the bank a stage) and runs wgmma m64nBNk16 on
//   them. With one split (the down projection at k = 192–768) it stores its
//   tile itself; with S > 1 the S blocks of a tile form a thread-block
//   cluster that sums its f32 partials through distributed shared memory in
//   split order (every split's value requested at once), so the result is
//   the same bits every run with no workspace and no counter. The schedule
//   keeps the clusters to what the card holds in one wave: a cluster's
//   blocks share a GPC, and clusters of 5 or 8 that overfilled it ran as two
//   waves at twice the time.
// - bf16 tgmm (the bank gradient at the prefill's rows) is bound by writing
//   the whole [E, k, n] output (403 MB of ~470, 0.14 ms). `tgmm_wgmma_kernel`:
//   a persistent grid over (group, 128 rows of k, 256 columns of n); both
//   operands are read MN-major along the contraction (the group's rows)
//   through the transpose bits, in 64-row TMA steps from the group's first
//   row. The last step of a group holds the next group's rows: the consumers
//   zero them in both operands before wgmma reads the stage (then
//   fence.proxy.async), so no foreign row, and no NaN in one, reaches the sum.
//   An empty group's tiles are written as zero without a load.
// - f32 (the SFT: 16,384 rows, 2,048 → 768) runs on the tensor cores as
//   TF32 with a three-product split (below), held to f32: 3 × 5.15e10 FLOP at
//   495 TFLOP/s is 0.312 ms at the forward, where FFMA's bound is 0.769 ms.
//   `gmm_tf32_kernel` / `tgmm_tf32_kernel` take the bf16 kernels' persistent
//   walks at 128 × 128 tiles and 32-deep stages (3 of 64 KiB), with the work
//   in the split and the layouts: see the TF32 section.

#include <cooperative_groups.h>

#include <atomic>
#include <type_traits>

#include "hopper_common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kMaxGroups = 1024;
constexpr unsigned kAllLanes = 0xffffffffu;

// ---- the group scan ----------------------------------------------------------

// the last group whose first work slot is at or before `slot` (first[] non-decreasing)
__device__ __forceinline__ int group_of(const int* first, int E, int slot) {
  int lo = 0, hi = E - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (first[mid] <= slot)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

// rows [r0, m) of out [m, n] set to zero, the grid's blocks sharing the
// 16-byte chunks (n % 8 == 0 for bf16, % 4 for f32: each row is whole chunks)
template <typename T>
__device__ __forceinline__ void zero_rows(T* out, int r0, int m, int n) {
  const size_t chunks = static_cast<size_t>(m - r0) * n * sizeof(T) / 16;
  uint4* p = reinterpret_cast<uint4*>(out + static_cast<size_t>(r0) * n);
  for (size_t c = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; c < chunks;
       c += static_cast<size_t>(gridDim.x) * blockDim.x)
    p[c] = make_uint4(0u, 0u, 0u, 0u);
}

// ---- bf16 on wgmma: shared pieces -------------------------------------------

constexpr int kBK = 64;                 // contraction per stage: one 128-byte swizzled row
constexpr uint32_t kBox = 64 * 128;     // a 64 x 64 bf16 TMA box, 8 KiB
constexpr uint32_t kSbo = 1024;         // next 8 rows of a swizzled box
constexpr uint32_t kDescHi = wgmma_desc_hi(kSbo);

struct Maps {
  CUtensorMap a, b, c;  // lhs, rhs, and tgmm's output
};

struct Args {
  const int* sizes;
  __nv_bfloat16* out;
  int E, m, k, n;
};

// A box at `addr` as a wgmma operand at k16 step kk: K-major (the
// contraction along the 128-byte row: the start steps 32 bytes) or MN-major
// (the contraction down the rows: the start steps 16 rows, 2048 bytes; the
// next 64 columns are the next box, kBox bytes on).
template <bool MN>
__device__ __forceinline__ uint64_t box_desc(uint32_t addr, int kk) {
  return MN ? wgmma_desc(wgmma_desc_lo(addr + kk * 2048, kBox), kDescHi)
            : wgmma_desc(wgmma_desc_lo(addr + kk * 32, 16), kDescHi);
}

// `stages` stages of `stage_bytes` from `base` and their full / empty barriers
struct Ring {
  unsigned char* base;  // 1024-byte aligned
  uint32_t stage_bytes;
  uint64_t* bars;  // 2 · stages
  int stages;
  __device__ unsigned char* stage(int s) const { return base + s * stage_bytes; }
  __device__ uint64_t* full(int s) const { return bars + s; }
  __device__ uint64_t* empty(int s) const { return bars + stages + s; }
  __device__ void init(int consumer_warps) const {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), consumer_warps);
    }
    mbar_fence_init();
  }
  // one arrival a consumer warp: the stage may be refilled
  __device__ void release(int s) const {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty(s));
  }
};

__device__ __forceinline__ unsigned char* aligned_smem() {
  extern __shared__ __align__(1024) unsigned char gmm_smem[];
  const uint32_t a = smem_u32(gmm_smem);
  return gmm_smem + (((a + 1023) & ~1023u) - a);
}

// rows r0..63 of one 64 x 64 box set to zero (a swizzle moves 16-byte chunks
// only within a 128-byte row), by the 128 threads of a warpgroup
__device__ __forceinline__ void zero_box_rows(unsigned char* box, int r0, int t) {
  uint4* p = reinterpret_cast<uint4*>(box + r0 * 128);
  for (int i = t; i < (64 - r0) * 8; i += 128) p[i] = make_uint4(0u, 0u, 0u, 0u);
}

// store one consumer's 64 x N f32 accumulator (the PTX layout: entry 4i + 2h
// + c at row (t / 32)·16 + lane / 4 + 8h, column 8i + 2·(lane % 4) + c) as T
// (bf16 or f32) at o, rows below `rows` and columns below `cols` only (cols
// even)
template <typename T, int NACC>
__device__ __forceinline__ void store_acc(const float (&acc)[NACC], T* o, size_t ld, int rows,
                                          int cols, int t) {
  const int lane = t % 32;
  const int r = (t / 32) * 16 + lane / 4, c0 = 2 * (lane % 4);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (r + 8 * h >= rows) continue;
    T* row = o + static_cast<size_t>(r + 8 * h) * ld;
#pragma unroll
    for (int i = 0; i < NACC / 4; ++i) {
      const int c = 8 * i + c0;
      if (c >= cols) continue;
      const float x = acc[4 * i + 2 * h], y = acc[4 * i + 2 * h + 1];
      if constexpr (std::is_same<T, float>::value)
        *reinterpret_cast<float2*>(row + c) = make_float2(x, y);
      else
        *reinterpret_cast<__nv_bfloat162*>(row + c) = __floats2bfloat162_rn(x, y);
    }
  }
}

// The block's work list in shared memory, from the group sizes: the whole
// block copies them into `s_sizes` (E ints of scratch, one round trip) and
// warp 0 scans the copy into offs[0..E], each group's first row clamped to
// [0, m] (offs[E] where the rows end), and, where `first` is given,
// first[0..E], the exclusive prefix of each group's ceil(rows / kRows) tiles
// (first[E] the list's length). Call from every thread; published by the
// caller's next __syncthreads.
template <int kRows>
__device__ __forceinline__ void work_list(const int* __restrict__ sizes, int* s_sizes, int E,
                                          int m, int* offs, int* first) {
  for (int e = threadIdx.x; e < E; e += blockDim.x) s_sizes[e] = max(sizes[e], 0);
  __syncthreads();
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  long long rows = 0;
  int tiles = 0;
  for (int base = 0; base < E; base += 32) {
    const int e = base + lane;
    const long long g = e < E ? s_sizes[e] : 0;
    long long incl = g;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const long long v = __shfl_up_sync(kAllLanes, incl, d);
      if (lane >= d) incl += v;
    }
    const int start = static_cast<int>(min(rows + incl - g, static_cast<long long>(m)));
    const int end = static_cast<int>(min(rows + incl, static_cast<long long>(m)));
    const int c = e < E && end > start ? (end - start + kRows - 1) / kRows : 0;
    int cincl = c;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kAllLanes, cincl, d);
      if (lane >= d) cincl += v;
    }
    if (e < E) {
      offs[e] = start;
      if (first != nullptr) first[e] = tiles + cincl - c;
    }
    rows += __shfl_sync(kAllLanes, incl, 31);
    tiles += __shfl_sync(kAllLanes, cincl, 31);
  }
  if (lane == 0) {
    offs[E] = static_cast<int>(min(rows, static_cast<long long>(m)));
    if (first != nullptr) first[E] = tiles;
  }
}

// work item `item` of a gmm walk over CT column tiles: the group, its tile's
// first row and first column
struct RowTile {
  int e, row0, n0;
};
template <int kRows, int kCols>
__device__ __forceinline__ RowTile row_tile(const int* offs, const int* first, int E, int item,
                                            int CT) {
  const int slot = item / CT, e = group_of(first, E, slot);
  return {e, offs[e] + (slot - first[e]) * kRows, (item % CT) * kCols};
}

// work item `item` of a tgmm walk over KB x NB tiles of each group's block
struct BankTile {
  int e, k0, n0;
};
template <int kRows, int kCols>
__device__ __forceinline__ BankTile bank_tile(int item, int KB, int NB) {
  const int kb = item % (KB * NB);
  return {item / (KB * NB), (kb / NB) * kRows, (kb % NB) * kCols};
}

// ---- gmm at many rows: persistent, warp-specialised, wgmma m64nBNk16 ----------

namespace wide {
constexpr int kBM = 128;
constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr uint32_t kA = 2 * kBox;  // A: 128 rows (two boxes of 64) x 64
constexpr uint32_t kLists = 2 * (kMaxGroups + 1) * sizeof(int);
// a stage at column tile BN: A and BN / 64 boxes of the bank
template <int BN>
__host__ __device__ constexpr uint32_t stage_bytes() {
  return kA + BN / 64 * kBox;
}
// one consumer's 64 x BN output, staged in BN / 64 swizzled boxes
template <int BN>
__host__ __device__ constexpr uint32_t out_bytes() {
  return BN / 64 * kBox;
}
// the stages, their barriers, both consumers' staged outputs, the two lists
// and 1 KiB of alignment (ops/gmm.py `_wide_smem` is the same sum)
template <int BN>
__host__ __device__ constexpr size_t smem_bytes(int stages) {
  return stages * (stage_bytes<BN>() + 2 * sizeof(uint64_t)) + 2 * out_bytes<BN>() + kLists +
         1024;
}
}  // namespace wide

// tgmm: 256 columns, three stages, and each consumer's 64 x 256 output
// staged for its TMA store
namespace tg {
constexpr int kBN = 256, kStages = 3;
constexpr uint32_t kStage = wide::stage_bytes<kBN>();
constexpr uint32_t kOut = wide::out_bytes<kBN>();
constexpr uint32_t kOutOff = kStages * kStage;
constexpr uint32_t kBarOff = kOutOff + 2 * kOut;
constexpr uint32_t kListOff = kBarOff + 2 * kStages * sizeof(uint64_t);
constexpr size_t kSmemBytes = kListOff + (kMaxGroups + 1) * sizeof(int) + 1024;
static_assert(kSmemBytes <= 232448, "the stages fit a block's shared memory");
}  // namespace tg

// A consumer's 64 x 2·NACC accumulator as bf16 into its swizzled output
// boxes of 64 x 64 (chunk c of row r at c ^ (r & 7), as TMA reads a
// 128-byte-swizzled box; a warp's 8 rows hit 8 different chunks, so no bank
// conflict).
template <int NACC>
__device__ __forceinline__ void stage_out(const float (&acc)[NACC], unsigned char* ob, int t) {
  const int lane = t % 32;
  const int r = (t / 32) * 16 + lane / 4, c0 = 2 * (lane % 4);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r + 8 * h;
#pragma unroll
    for (int i = 0; i < NACC / 4; ++i) {
      const int c = (8 * i + c0) % 64;  // column in box i / 8
      const uint32_t off = (i / 8) * kBox + row * 128 + ((((c >> 3) ^ row) & 7) << 4) + (c & 7) * 2;
      *reinterpret_cast<uint32_t*>(ob + off) =
          pack_bf16(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
    }
  }
}

// rows [0, rows) of a consumer's staged 64 x BN output (columns below `cols`)
// to o, row stride ld, in 16-byte chunks: eight threads a box's row
template <int BN>
__device__ __forceinline__ void copy_rows(const unsigned char* ob, __nv_bfloat16* o, size_t ld,
                                          int rows, int cols, int t) {
  constexpr int kChunks = BN / 8;
  for (int i = t; i < rows * kChunks; i += 128) {
    const int r = i / kChunks, c = i % kChunks;
    if (8 * c >= cols) continue;
    *reinterpret_cast<uint4*>(o + r * ld + 8 * c) = *reinterpret_cast<const uint4*>(
        ob + (c / 8) * kBox + r * 128 + ((((c % 8) ^ r) & 7) << 4));
  }
}

// One tile: out[row0 + [0, 128)][n0 + [0, BN)] of group e, the rows of the
// group only. Work item i (of len · CT, len the work list's length) is slot
// i / CT of the list, columns (i % CT)·BN; the list gives a group
// ceil(size / 128) slots from its first row. A tile whose second 64 rows
// hold none of the group's rows loads only its first A box. Each consumer
// stages its 64 x BN result in shared memory; one thread stores it by TMA
// where its 64 rows are all the group's (or past m, which the store clips),
// and its threads copy the group's rows out in 16-byte chunks where the box
// holds the next group's first rows. Either way the consumers issue the next
// tile's products while the stores drain.
template <int BN, bool TRANS>
__global__ void __launch_bounds__(wide::kThreads, 1)
gmm_wgmma_kernel(const __grid_constant__ Maps maps, const Args args, int stages) {
  using namespace wide;
  constexpr uint32_t kStage = stage_bytes<BN>(), kOut = out_bytes<BN>();
  unsigned char* base = aligned_smem();
  const uint32_t out_off = stages * kStage;
  const Ring ring{base, kStage, reinterpret_cast<uint64_t*>(base + out_off + 2 * kOut), stages};
  int* offs = reinterpret_cast<int*>(ring.bars + 2 * stages);  // [E + 1]
  int* first = offs + kMaxGroups + 1;                           // [E + 1]
  const int E = args.E;
  work_list<kBM>(args.sizes, reinterpret_cast<int*>(base), E, args.m, offs, first);
  if (threadIdx.x == 0) ring.init(8);
  fence_proxy_async();  // the sizes' copy in stage 0 before TMA overwrites it
  __syncthreads();
  zero_rows(args.out, offs[E], args.m, args.n);
  const int CT = (args.n + BN - 1) / BN, KT = (args.k + kBK - 1) / kBK;
  const int items = first[E] * CT;

  if (threadIdx.x < 128) {  // producer warpgroup: one thread starts every load
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int it = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const RowTile tl = row_tile<kBM, BN>(offs, first, E, item, CT);
        const bool half = offs[tl.e + 1] - tl.row0 <= 64;
        for (int kt = 0; kt < KT; ++kt, ++it) {
          const int s = it % stages;
          unsigned char* st = ring.stage(s);
          mbar_wait(ring.empty(s), ((it / stages) & 1) ^ 1);
          mbar_arrive_expect_tx(ring.full(s), half ? kStage - kBox : kStage);
          tma_load_3d(st, &maps.a, ring.full(s), kt * kBK, tl.row0, 0);
          if (!half) tma_load_3d(st + kBox, &maps.a, ring.full(s), kt * kBK, tl.row0 + 64, 0);
          if (TRANS) {  // rhs [E, n, k]: one box of BN rows of n
            tma_load_3d(st + kA, &maps.b, ring.full(s), kt * kBK, tl.n0, tl.e);
          } else {  // rhs [E, k, n]: BN / 64 boxes of 64 columns
#pragma unroll
            for (int p = 0; p < BN / 64; ++p)
              tma_load_3d(st + kA + p * kBox, &maps.b, ring.full(s), tl.n0 + 64 * p, kt * kBK,
                          tl.e);
          }
        }
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();  // consumer warpgroups: 64 rows of the tile each
  const int cw = threadIdx.x / 128 - 1, t = threadIdx.x % 128;
  unsigned char* ob = base + out_off + cw * kOut;
  int it = 0;
  float acc[BN / 2];
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const RowTile tl = row_tile<kBM, BN>(offs, first, E, item, CT);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < KT; ++kt, ++it) {
      const int s = it % stages;
      const uint32_t a = smem_u32(ring.stage(s)) + cw * kBox, b = a - cw * kBox + kA;
      mbar_wait(ring.full(s), (it / stages) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_ss<BN, 0, TRANS ? 0 : 1>(acc, box_desc<false>(a, kk), box_desc<!TRANS>(b, kk), 1);
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done
      if (kt > 0) ring.release((it - 1) % stages);
    }
    wgmma_wait<0>();
    fence_operands(acc);
    ring.release((it - 1) % stages);
    const int row0 = tl.row0 + cw * 64, end = offs[tl.e + 1];
    const int rows = min(64, end - row0);
    if (rows <= 0) continue;  // this consumer's rows are all the next group's
    if (t == 0) bulk_wait_read();  // the previous store has read the staging
    named_bar_sync(2 + cw, 128);   // ... and so have the previous copy's threads
    stage_out(acc, ob, t);
    if (rows == 64 || end == args.m) {
      fence_proxy_async();  // the generic writes before the TMA store reads them
      named_bar_sync(2 + cw, 128);
      if (t == 0) {
        for (int p = 0; p < BN / 64 && tl.n0 + 64 * p < args.n; ++p)
          tma_store_3d(&maps.c, ob + p * kBox, tl.n0 + 64 * p, row0, 0);
        bulk_commit();
      }
    } else {
      named_bar_sync(2 + cw, 128);
      copy_rows<BN>(ob, args.out + static_cast<size_t>(row0) * args.n + tl.n0, args.n, rows,
                    args.n - tl.n0, t);
    }
  }
  if (t == 0) bulk_wait();
}

// ---- tgmm: persistent, warp-specialised, wgmma n256 on MN-major operands ------

// One tile: out[e][k0 + [0, 128)][n0 + [0, 256)] = lhs[rows_e, k0..]ᵀ ·
// rhs[rows_e, n0..], over 64-row steps from the group's first row. Work item
// i is group i / (KB·NB), then 128 rows of k, then 256 columns of n. Each
// consumer stages its half of the tile in shared memory and one thread
// stores it by TMA (clipped at k and n), which drains under the next tile.
__global__ void __launch_bounds__(wide::kThreads, 1)
tgmm_wgmma_kernel(const __grid_constant__ Maps maps, const Args args) {
  using wide::kA;
  using wide::kBM;
  using namespace tg;
  unsigned char* base = aligned_smem();
  const Ring ring{base, kStage, reinterpret_cast<uint64_t*>(base + kBarOff), kStages};
  int* offs = reinterpret_cast<int*>(base + kListOff);  // [E + 1]
  const int E = args.E;
  work_list<kBM>(args.sizes, reinterpret_cast<int*>(base), E, args.m, offs, nullptr);
  if (threadIdx.x == 0) ring.init(8);
  fence_proxy_async();
  __syncthreads();
  const int KB = (args.k + kBM - 1) / kBM, NB = (args.n + kBN - 1) / kBN;
  const int items = E * KB * NB;

  if (threadIdx.x < 128) {
    setmaxnreg_dec<wide::kProducerRegs>();
    if (threadIdx.x == 0) {
      int it = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const BankTile tl = bank_tile<kBM, kBN>(item, KB, NB);
        for (int r0 = offs[tl.e]; r0 < offs[tl.e + 1]; r0 += kBK, ++it) {
          const int s = it % kStages;
          unsigned char* st = ring.stage(s);
          mbar_wait(ring.empty(s), ((it / kStages) & 1) ^ 1);
          mbar_arrive_expect_tx(ring.full(s), kStage);
          tma_load_3d(st, &maps.a, ring.full(s), tl.k0, r0, 0);
          tma_load_3d(st + kBox, &maps.a, ring.full(s), tl.k0 + 64, r0, 0);
#pragma unroll
          for (int p = 0; p < 4; ++p)
            tma_load_3d(st + kA + p * kBox, &maps.b, ring.full(s), tl.n0 + 64 * p, r0, 0);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<wide::kConsumerRegs>();
  const int cw = threadIdx.x / 128 - 1, t = threadIdx.x % 128;
  unsigned char* ob = base + kOutOff + cw * kOut;
  int it = 0;
  float acc[128];
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const BankTile tl = bank_tile<kBM, kBN>(item, KB, NB);
    const int end = offs[tl.e + 1];
    int r0 = offs[tl.e];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    for (; r0 < end; r0 += kBK, ++it) {
      const int s = it % kStages;
      unsigned char* st = ring.stage(s);
      mbar_wait(ring.full(s), (it / kStages) & 1);
      if (end - r0 < kBK) {  // the group's last step: the next group's rows read as zero
        zero_box_rows(st + cw * kBox, end - r0, t);
        zero_box_rows(st + kA + (2 * cw) * kBox, end - r0, t);
        zero_box_rows(st + kA + (2 * cw + 1) * kBox, end - r0, t);
        fence_proxy_async();
        named_bar_sync(1, 256);
      }
      const uint32_t a = smem_u32(st) + cw * kBox, b = smem_u32(st) + kA;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_ss_n256<1, 1>(acc, box_desc<true>(a, kk), box_desc<true>(b, kk), 1);
      wgmma_commit();
      wgmma_wait<1>();
      if (r0 > offs[tl.e]) ring.release((it - 1) % kStages);
    }
    wgmma_wait<0>();
    fence_operands(acc);
    if (end > offs[tl.e]) ring.release((it - 1) % kStages);
    const int row0 = tl.k0 + cw * 64;
    if (row0 >= args.k) continue;  // this consumer's rows are all past k
    if (t == 0) bulk_wait_read();  // the previous tile's store has read the staging
    named_bar_sync(2 + cw, 128);
    stage_out(acc, ob, t);
    fence_proxy_async();  // the generic writes before the TMA store reads them
    named_bar_sync(2 + cw, 128);
    if (t == 0) {
      for (int p = 0; p < 4 && tl.n0 + 64 * p < args.n; ++p)
        tma_store_3d(&maps.c, ob + p * kBox, tl.n0 + 64 * p, row0, tl.e);
      bulk_commit();
    }
  }
  if (t == 0) bulk_wait();
}

// ---- gmm at few rows: split k, every k step of a block in flight --------------

namespace narrow {
constexpr int kThreads = 160;  // a consumer warpgroup and a producer warp
constexpr int kMaxSplits = 8;  // a cluster's portable size
}

// Group j of a call (the j-th group with rows below m), found by one warp
// from the sizes in global memory: lane l holds groups [l·c, l·c + c), c =
// ceil(E / 32), and warp scans of their rows and of how many of them have
// rows give each lane its first row and the rank of its first such group.
// e = -1 where there is no group j; rows_end = min(sum of the sizes, m).
// The result is the same in every lane.
struct Pick {
  int e, start, end, rows_end;
};
__device__ __forceinline__ Pick pick_group(const int* __restrict__ sizes, int E, int m, int j) {
  const int lane = threadIdx.x % 32, c = (E + 31) / 32;
  const int e0 = min(E, lane * c), e1 = min(E, e0 + c);
  long long rows = 0;
  int hits = 0;
  for (int e = e0; e < e1; ++e) {
    const int g = __ldg(sizes + e);
    rows += max(g, 0);
    hits += g > 0;
  }
  long long rincl = rows;
  int hincl = hits;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long rv = __shfl_up_sync(kAllLanes, rincl, d);
    const int hv = __shfl_up_sync(kAllLanes, hincl, d);
    if (lane >= d) {
      rincl += rv;
      hincl += hv;
    }
  }
  const long long total = __shfl_sync(kAllLanes, rincl, 31);
  int own_e = -1, own_g = 0;
  long long own_r = 0;
  if (hincl - hits <= j && j < hincl) {  // group j is among this lane's
    long long r = rincl - rows;
    for (int e = e0, h = hincl - hits; e < e1; ++e) {
      const int g = max(__ldg(sizes + e), 0);
      if (g > 0 && h++ == j) {
        own_e = e;
        own_r = r;
        own_g = g;
        break;
      }
      r += g;
    }
  }
  Pick p{-1, 0, 0, static_cast<int>(min(total, static_cast<long long>(m)))};
  const unsigned own = __ballot_sync(kAllLanes, own_e >= 0);
  if (own != 0) {
    const int src = __ffs(own) - 1;
    const long long r = __shfl_sync(kAllLanes, own_r, src);
    const long long g = __shfl_sync(kAllLanes, own_g, src);
    p.start = static_cast<int>(min(r, static_cast<long long>(m)));
    p.end = static_cast<int>(min(r + g, static_cast<long long>(m)));
    if (p.end > p.start) p.e = __shfl_sync(kAllLanes, own_e, src);
  }
  return p;
}

// Block (tile, split) with tile = j·CT + (column tile of BN), blockIdx.x =
// tile·S + split: group j's rows (m <= 64, so they fit one 64-row tile from
// the group's first row) times k steps [s·P, s·P + P) of its bank, through
// `stages` stages (all of them in flight where P <= stages). A stage holds
// an A box of a_rows = m rounded up to 8 rows and BN columns of the bank;
// wgmma reads 64 rows from the A box on, and the rows past it (the bank's
// bytes) give rows that are never stored. With S > 1 the S splits of a tile
// are one cluster, which sums its f32 partials through distributed shared
// memory in split order; with S = 1 the block has no cluster and stores its
// tile from its registers.
template <int BN, bool TRANS>
__global__ void __launch_bounds__(narrow::kThreads, 3)
gmm_splitk_kernel(const __grid_constant__ Maps maps, const Args args, int S, int P, int CT,
                  int stages, int a_rows) {
  using namespace narrow;
  const uint32_t a_bytes = a_rows * 128, stage = a_bytes + BN / 64 * kBox;
  unsigned char* base = aligned_smem();
  float* part = reinterpret_cast<float*>(base + stages * stage);  // [a_rows][BN] where S > 1
  const Ring ring{base, stage,
                  reinterpret_cast<uint64_t*>(base + stages * stage +
                                              (S > 1 ? a_rows * BN * sizeof(float) : 0)),
                  stages};
  int* found = reinterpret_cast<int*>(ring.bars + 2 * stages);  // e, start, end, rows_end
  const int split = blockIdx.x % S, tile = blockIdx.x / S;
  const int j = tile / CT, n0 = (tile % CT) * BN;
  if (threadIdx.x >= 128) {  // the producer warp finds the block's group
    if (threadIdx.x == 128) {
      prefetch_tensormap(&maps.a);
      prefetch_tensormap(&maps.b);
    }
    const Pick pk = pick_group(args.sizes, args.E, args.m, j);
    if (threadIdx.x == 128) {
      found[0] = pk.e;
      found[1] = pk.start;
      found[2] = pk.end;
      found[3] = pk.rows_end;
      ring.init(4);
    }
  }
  __syncthreads();
  const int e = found[0], start = found[1], rows = found[2] - start;
  zero_rows(args.out, found[3], args.m, args.n);
  if (e < 0) return;  // the whole cluster: j is the cluster's
  const int KT = (args.k + kBK - 1) / kBK;
  const int kt0 = split * P, kt1 = min(KT, kt0 + P);

  if (threadIdx.x >= 128) {  // producer warp
    if (threadIdx.x == 128) {
      for (int kt = kt0, i = 0; kt < kt1; ++kt, ++i) {
        const int s = i % stages;
        unsigned char* st = ring.stage(s);
        mbar_wait(ring.empty(s), ((i / stages) & 1) ^ 1);
        mbar_arrive_expect_tx(ring.full(s), stage);
        tma_load_3d(st, &maps.a, ring.full(s), kt * kBK, start, 0);
        if (TRANS) {
          tma_load_3d(st + a_bytes, &maps.b, ring.full(s), kt * kBK, n0, e);
        } else {
#pragma unroll
          for (int p = 0; p < BN / 64; ++p)
            tma_load_3d(st + a_bytes + p * kBox, &maps.b, ring.full(s), n0 + 64 * p, kt * kBK,
                        e);
        }
      }
    }
    __syncwarp();
  } else {  // consumer warpgroup
    const int t = threadIdx.x;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int kt = kt0, i = 0; kt < kt1; ++kt, ++i) {
      const int s = i % stages;
      const uint32_t a = smem_u32(ring.stage(s)), b = a + a_bytes;
      mbar_wait(ring.full(s), (i / stages) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_ss<BN, 0, TRANS ? 0 : 1>(acc, box_desc<false>(a, kk), box_desc<!TRANS>(b, kk), 1);
      wgmma_commit();
      wgmma_wait<1>();
      if (i > 0) ring.release((i - 1) % stages);
    }
    wgmma_wait<0>();
    fence_operands(acc);
    if (S == 1) {
      store_acc(acc, args.out + static_cast<size_t>(start) * args.n + n0, args.n, rows,
                args.n - n0, t);
    } else {  // this split's partial, the group's rows only
      const int lane = t % 32, r = (t / 32) * 16 + lane / 4;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (r + 8 * h >= rows) continue;
#pragma unroll
        for (int q = 0; q < BN / 8; ++q)
          *reinterpret_cast<float2*>(part + (r + 8 * h) * BN + 8 * q + 2 * (lane % 4)) =
              make_float2(acc[4 * q + 2 * h], acc[4 * q + 2 * h + 1]);
      }
    }
  }
  if (S == 1) return;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every split's partial is written
  const int cols = min(BN, args.n - n0);
  for (int idx = split * kThreads + threadIdx.x; idx < rows * BN; idx += S * kThreads) {
    const int r = idx / BN, c = idx % BN;
    if (c >= cols) continue;
    float v[kMaxSplits];  // every split's value requested at once, then summed in split order
#pragma unroll
    for (int q = 0; q < kMaxSplits; ++q) v[q] = q < S ? cluster.map_shared_rank(part, q)[idx] : 0.f;
    float sum = 0.f;
#pragma unroll
    for (int q = 0; q < kMaxSplits; ++q)
      if (q < S) sum += v[q];
    args.out[static_cast<size_t>(start + r) * args.n + n0 + c] = __float2bfloat16(sum);
  }
  cluster.sync();  // no block leaves while another reads its partial
}

// ---- f32 on the tensor cores: TF32 with a three-product split ------------------
//
// An f32 x is hi + lo with hi = tf32(x) and lo = tf32(x − hi), both rounded to
// nearest (tf32_round), so every operand the tensor cores read is an exact tf32
// value; a product is a_lo·b_hi + a_hi·b_lo + a_hi·b_hi (the small terms
// first), leaving out a_lo·b_lo, ~2^-21 of |a|·|b| a term (ring_step_f32.cu's
// split). wgmma on .tf32 reads K-major operands only, so A goes to the
// tensor cores from registers (each consumer reads and splits its fragments
// from the raw stage, K-major for gmm, a transposed read for tgmm) and B from
// K-major hi and lo panels that producer warps 1-3 write from the raw stage
// (the bank of gmm and both tgmm operands run MN-major: transposed there).
// The tensor cores round their accumulator toward zero, so each 32-deep
// stage's 12 products start from zero and fold into an f32 register sum by
// round-to-nearest adds.

namespace tf {
constexpr int kBM = 128, kBN = 128, kKStep = 32;  // kKStep f32: one 128-byte swizzled row
constexpr int kStages = 3;
constexpr int kThreads = 384;
constexpr int kPrepWarps = 3;
constexpr uint32_t kBox32 = 32 * 128;  // 32 rows x 32 f32, 4 KiB
// a stage: A as TMA wrote it, B as TMA wrote it, B's K-major hi and lo panels
constexpr uint32_t kARaw = 0, kBRaw = 4 * kBox32, kBHi = 8 * kBox32, kBLo = 12 * kBox32;
constexpr uint32_t kStage = 16 * kBox32;  // 64 KiB
constexpr uint32_t kBarOff = kStages * kStage;
constexpr uint32_t kListOff = kBarOff + 3 * kStages * sizeof(uint64_t);
constexpr size_t kSmemBytes = kListOff + 2 * (kMaxGroups + 1) * sizeof(int) + 1024;
static_assert(kSmemBytes <= 232448, "the stages fit a block's shared memory");

// Producer warp w (0..kPrepWarps-1), lane = k, writes B's hi and lo panels
// ([128 columns of n][32 of k], K-major) from the raw stage: MN, four boxes
// of [32 k][32 n] (transposed here), or K-major [128 n][32 k] as it is. Rows
// of k at or past `kvalid` are written as zero.
template <bool MN>
__device__ __forceinline__ void prep_b(unsigned char* st, int w, int lane, int kvalid) {
  if (MN) {
    const bool live = lane < kvalid;
    for (int c4 = w; c4 < kBN / 4; c4 += kPrepWarps) {
      const float4 x = live ? *reinterpret_cast<const float4*>(
                                  st + kBRaw + (c4 / 8) * kBox32 + lane * 128 +
                                  ((((c4 % 8) ^ lane) & 7) << 4))
                            : make_float4(0.f, 0.f, 0.f, 0.f);
      float4 lo;
      const float4 hi = tf32_split4(x, lo);
      const float h[4] = {hi.x, hi.y, hi.z, hi.w}, l[4] = {lo.x, lo.y, lo.z, lo.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t o = swz128(4 * c4 + e, lane);
        *reinterpret_cast<float*>(st + kBHi + o) = h[e];
        *reinterpret_cast<float*>(st + kBLo + o) = l[e];
      }
    }
  } else {
    for (int i = w * 32 + lane; i < kBN * 8; i += kPrepWarps * 32) {
      const uint32_t o = (i / 8) * 128 + ((((i % 8) ^ (i / 8)) & 7) << 4);
      float4 lo;
      const float4 hi = tf32_split4(*reinterpret_cast<const float4*>(st + kBRaw + o), lo);
      *reinterpret_cast<float4*>(st + kBHi + o) = hi;
      *reinterpret_cast<float4*>(st + kBLo + o) = lo;
    }
  }
}

// A consumer's A fragments of one stage, split: (hi, lo)[kk] for the four k8
// steps, rows r and r + 8 of its 64, k columns 8kk + t and 8kk + t + 4 (t =
// lane % 4). gmm: its 64 rows K-major (one 8 KiB box of 64 rows at `a`);
// tgmm: columns 64cw.. of four MN boxes [32 k][32 columns] at `a`, k at or
// past `kvalid` read as zero.
template <bool MN>
__device__ __forceinline__ void load_a(uint32_t (&ah)[4][4], uint32_t (&al)[4][4],
                                       const unsigned char* a, int cw, int r, int t,
                                       int kvalid) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = r + 8 * (q & 1), k = 8 * kk + t + 4 * (q >> 1);
      float x;
      if (MN) {
        const int col = 64 * cw + row;
        x = k < kvalid ? *reinterpret_cast<const float*>(a + (col / 32) * kBox32 + swz128(k, col % 32))
                       : 0.f;
      } else {
        x = *reinterpret_cast<const float*>(a + swz128(row, k));
      }
      float hi, lo;
      tf32_split(x, hi, lo);
      ah[kk][q] = __float_as_uint(hi);
      al[kk][q] = __float_as_uint(lo);
    }
}

// sum += this stage's product (64 x 128): 12 wgmma from zero, then a
// round-to-nearest fold
__device__ __forceinline__ void mma_stage(float (&sum)[64], float (&acc)[64],
                                          const uint32_t (&ah)[4][4], const uint32_t (&al)[4][4],
                                          uint32_t bhi, uint32_t blo) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_tf32_rs_n128(acc, al[kk], box_desc<false>(bhi, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_tf32_rs_n128(acc, ah[kk], box_desc<false>(blo, kk), 1);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_tf32_rs_n128(acc, ah[kk], box_desc<false>(bhi, kk), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(acc);
#pragma unroll
  for (int i = 0; i < 64; ++i) sum[i] = __fadd_rn(sum[i], acc[i]);
}

struct Args {
  const int* sizes;
  float* out;
  int E, m, k, n;
};

// the stages and their full / ready / empty barriers
struct Stages {
  unsigned char* base;
  __device__ unsigned char* stage(int s) const { return base + s * kStage; }
  __device__ uint64_t* bar(int i) const {
    return reinterpret_cast<uint64_t*>(base + kBarOff) + i;
  }
  __device__ uint64_t* full(int s) const { return bar(s); }
  __device__ uint64_t* ready(int s) const { return bar(kStages + s); }
  __device__ uint64_t* empty(int s) const { return bar(2 * kStages + s); }
  __device__ void init() const {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(ready(s), kPrepWarps);
      mbar_init(empty(s), 8);
    }
    mbar_fence_init();
  }
};

}  // namespace tf

// gmm on f32: a persistent grid over the work list of (group, 128 rows from
// its first row) × 128 columns, as gmm_wgmma_kernel's, k in 32-deep stages.
template <bool TRANS>
__global__ void __launch_bounds__(tf::kThreads, 1)
gmm_tf32_kernel(const __grid_constant__ Maps maps, const tf::Args args) {
  using namespace tf;
  unsigned char* base = aligned_smem();
  const Stages sm{base};
  int* offs = reinterpret_cast<int*>(base + kListOff);  // [E + 1]
  int* first = offs + kMaxGroups + 1;                   // [E + 1]
  const int E = args.E;
  work_list<kBM>(args.sizes, reinterpret_cast<int*>(base), E, args.m, offs, first);
  if (threadIdx.x == 0) sm.init();
  fence_proxy_async();
  __syncthreads();
  zero_rows(args.out, offs[E], args.m, args.n);
  const int CT = (args.n + kBN - 1) / kBN, KT = (args.k + kKStep - 1) / kKStep;
  const int items = first[E] * CT;

  if (threadIdx.x < 128) {  // producer warpgroup: warp 0 loads, warps 1-3 prepare B
    setmaxnreg_dec<wide::kProducerRegs>();
    const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
    int it = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const RowTile tl = row_tile<kBM, kBN>(offs, first, E, item, CT);
      for (int kt = 0; kt < KT; ++kt, ++it) {
        const int s = it % kStages, ph = (it / kStages) & 1;
        unsigned char* st = sm.stage(s);
        if (w == 0) {
          if (lane == 0) {
            mbar_wait(sm.empty(s), ph ^ 1);
            mbar_arrive_expect_tx(sm.full(s), 8 * kBox32);
            tma_load_3d(st + kARaw, &maps.a, sm.full(s), kt * kKStep, tl.row0, 0);
            tma_load_3d(st + kARaw + 2 * kBox32, &maps.a, sm.full(s), kt * kKStep,
                        tl.row0 + 64, 0);
            if (TRANS) {
              tma_load_3d(st + kBRaw, &maps.b, sm.full(s), kt * kKStep, tl.n0, tl.e);
            } else {
#pragma unroll
              for (int p = 0; p < 4; ++p)
                tma_load_3d(st + kBRaw + p * kBox32, &maps.b, sm.full(s), tl.n0 + 32 * p,
                            kt * kKStep, tl.e);
            }
          }
        } else {
          mbar_wait(sm.full(s), ph);
          prep_b<!TRANS>(st, w - 1, lane, kKStep);
          fence_proxy_async();  // the generic writes before wgmma reads them
          __syncwarp();
          if (lane == 0) mbar_arrive(sm.ready(s));
        }
      }
    }
    return;
  }

  setmaxnreg_inc<wide::kConsumerRegs>();
  const int cw = threadIdx.x / 128 - 1, t = threadIdx.x % 128, lane = t % 32;
  const int r = (t / 32) * 16 + lane / 4;
  int it = 0;
  float sum[64], acc[64];
  uint32_t ah[4][4], al[4][4];
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const RowTile tl = row_tile<kBM, kBN>(offs, first, E, item, CT);
    const int rows = min(kBM, offs[tl.e + 1] - tl.row0) - cw * 64;
#pragma unroll
    for (int i = 0; i < 64; ++i) sum[i] = 0.f;
    for (int kt = 0; kt < KT; ++kt, ++it) {
      const int s = it % kStages, ph = (it / kStages) & 1;
      unsigned char* st = sm.stage(s);
      mbar_wait(sm.full(s), ph);
      load_a<false>(ah, al, st + kARaw + cw * 2 * kBox32, cw, r, lane % 4, kKStep);
      mbar_wait(sm.ready(s), ph);
      mma_stage(sum, acc, ah, al, smem_u32(st + kBHi), smem_u32(st + kBLo));
      __syncwarp();
      if (lane == 0) mbar_arrive(sm.empty(s));
    }
    store_acc(sum, args.out + static_cast<size_t>(tl.row0 + cw * 64) * args.n + tl.n0, args.n,
              rows, args.n - tl.n0, t);
  }
}

// tgmm on f32: a persistent grid over (group, 128 rows of k, 128 columns of
// n), the group's rows in 32-row stages from its first; rows past the group
// read as zero in both operands.
__global__ void __launch_bounds__(tf::kThreads, 1)
tgmm_tf32_kernel(const __grid_constant__ Maps maps, const tf::Args args) {
  using namespace tf;
  unsigned char* base = aligned_smem();
  const Stages sm{base};
  int* offs = reinterpret_cast<int*>(base + kListOff);  // [E + 1]
  const int E = args.E;
  work_list<kBM>(args.sizes, reinterpret_cast<int*>(base), E, args.m, offs, nullptr);
  if (threadIdx.x == 0) sm.init();
  fence_proxy_async();
  __syncthreads();
  const int KB = (args.k + kBM - 1) / kBM, NB = (args.n + kBN - 1) / kBN;
  const int items = E * KB * NB;

  if (threadIdx.x < 128) {
    setmaxnreg_dec<wide::kProducerRegs>();
    const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
    int it = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const BankTile tl = bank_tile<kBM, kBN>(item, KB, NB);
      const int end = offs[tl.e + 1];
      for (int r0 = offs[tl.e]; r0 < end; r0 += kKStep, ++it) {
        const int s = it % kStages, ph = (it / kStages) & 1;
        unsigned char* st = sm.stage(s);
        if (w == 0) {
          if (lane == 0) {
            mbar_wait(sm.empty(s), ph ^ 1);
            mbar_arrive_expect_tx(sm.full(s), 8 * kBox32);
#pragma unroll
            for (int p = 0; p < 4; ++p) {
              tma_load_3d(st + kARaw + p * kBox32, &maps.a, sm.full(s), tl.k0 + 32 * p, r0, 0);
              tma_load_3d(st + kBRaw + p * kBox32, &maps.b, sm.full(s), tl.n0 + 32 * p, r0, 0);
            }
          }
        } else {
          mbar_wait(sm.full(s), ph);
          prep_b<true>(st, w - 1, lane, end - r0);
          fence_proxy_async();
          __syncwarp();
          if (lane == 0) mbar_arrive(sm.ready(s));
        }
      }
    }
    return;
  }

  setmaxnreg_inc<wide::kConsumerRegs>();
  const int cw = threadIdx.x / 128 - 1, t = threadIdx.x % 128, lane = t % 32;
  const int r = (t / 32) * 16 + lane / 4;
  int it = 0;
  float sum[64], acc[64];
  uint32_t ah[4][4], al[4][4];
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const BankTile tl = bank_tile<kBM, kBN>(item, KB, NB);
    const int end = offs[tl.e + 1];
#pragma unroll
    for (int i = 0; i < 64; ++i) sum[i] = 0.f;
    for (int r0 = offs[tl.e]; r0 < end; r0 += kKStep, ++it) {
      const int s = it % kStages, ph = (it / kStages) & 1;
      unsigned char* st = sm.stage(s);
      mbar_wait(sm.full(s), ph);
      load_a<true>(ah, al, st + kARaw, cw, r, lane % 4, end - r0);
      mbar_wait(sm.ready(s), ph);
      mma_stage(sum, acc, ah, al, smem_u32(st + kBHi), smem_u32(st + kBLo));
      __syncwarp();
      if (lane == 0) mbar_arrive(sm.empty(s));
    }
    store_acc(sum,
              args.out + (static_cast<size_t>(tl.e) * args.k + tl.k0 + cw * 64) * args.n + tl.n0,
              args.n, args.k - tl.k0 - cw * 64, args.n - tl.n0, t);
  }
}

// ---- host ------------------------------------------------------------------------

// the kernel's dynamic shared memory raised to `bytes`, once a device
template <auto Kernel>
cudaError_t allow_smem(size_t bytes) {
  static std::atomic<unsigned> done{0};  // bit d: set on device d
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (done.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

constexpr size_t kMaxSmem = 232448;  // a block's dynamic shared memory on sm_90

template <int BN, bool TRANS>
cudaError_t launch_wide(const void* lhs, const void* rhs, const Args& args, int stages, int sms,
                        cudaStream_t st) {
  const size_t smem = wide::smem_bytes<BN>(stages);
  if (stages < 2 || smem > kMaxSmem) return cudaErrorInvalidValue;
  Maps maps;
  if (!encode_rows_map(&maps.a, lhs, args.m, args.k, 64) ||
      !(TRANS ? encode_bank_map(&maps.b, rhs, args.E, args.n, args.k, BN)
              : encode_bank_map(&maps.b, rhs, args.E, args.k, args.n, kBK)) ||
      !encode_rows_map(&maps.c, args.out, args.m, args.n, 64))
    return cudaErrorInvalidValue;
  const cudaError_t err = allow_smem<gmm_wgmma_kernel<BN, TRANS>>(kMaxSmem);
  if (err != cudaSuccess) return err;
  // the work list holds at most ceil(m / 128) + min(E, m) slots
  const long long slots = (args.m + wide::kBM - 1) / wide::kBM + min(args.E, args.m);
  const long long items = slots * ((args.n + BN - 1) / BN);
  const int grid = static_cast<int>(max(1LL, min(static_cast<long long>(sms), items)));
  gmm_wgmma_kernel<BN, TRANS><<<grid, wide::kThreads, smem, st>>>(maps, args, stages);
  return cudaGetLastError();
}

// the split-k kernel's dynamic shared memory (ops/gmm.py `_split_smem` is the
// same sum): the stages, the partial where there is a cluster, the
// barriers, the group found and 1 KiB of alignment
template <int BN>
size_t narrow_smem(int stages, int a_rows, int splits) {
  return stages * (a_rows * 128 + BN / 64 * kBox + 2 * sizeof(uint64_t)) +
         (splits > 1 ? a_rows * BN * sizeof(float) : 0) + 4 * sizeof(int) + 1024;
}

template <int BN, bool TRANS>
cudaError_t launch_narrow(const void* lhs, const void* rhs, const Args& args, int splits,
                          int stages, cudaStream_t st) {
  const int KT = (args.k + kBK - 1) / kBK;
  const int a_rows = (args.m + 7) / 8 * 8;  // the A box: the call's rows, whole 8-row groups
  const size_t smem = narrow_smem<BN>(stages, a_rows, splits);
  if (splits < 1 || splits > narrow::kMaxSplits || splits > KT || args.m > 64 || smem > kMaxSmem)
    return cudaErrorInvalidValue;
  const int P = (KT + splits - 1) / splits;
  if (stages < min(2, P))  // a stage is released after the next one's products: one cannot cycle
    return cudaErrorInvalidValue;
  Maps maps;
  if (!encode_rows_map(&maps.a, lhs, args.m, args.k, a_rows) ||
      !(TRANS ? encode_bank_map(&maps.b, rhs, args.E, args.n, args.k, BN)
              : encode_bank_map(&maps.b, rhs, args.E, args.k, args.n, kBK)))
    return cudaErrorInvalidValue;
  const cudaError_t err = allow_smem<gmm_splitk_kernel<BN, TRANS>>(kMaxSmem);
  if (err != cudaSuccess) return err;
  const int CT = (args.n + BN - 1) / BN;
  const int groups = min(args.E, args.m);  // at most this many groups have rows
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits * groups * CT);
  cfg.blockDim = dim3(narrow::kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;  // one split: no cluster
  return cudaLaunchKernelEx(&cfg, gmm_splitk_kernel<BN, TRANS>, maps, args, splits, P, CT,
                            stages, a_rows);
}

// the bf16 kernel of the schedule: splits = 0 the many-row one at column tile
// 256, 192 or 128, else the few-row one at 128 or 64
template <bool TRANS>
cudaError_t launch_bf16(const void* lhs, const void* rhs, const Args& args, int splits,
                        int tile_n, int stages, int sms, cudaStream_t st) {
  if (splits > 0) {
    if (tile_n == 128) return launch_narrow<128, TRANS>(lhs, rhs, args, splits, stages, st);
    if (tile_n == 64) return launch_narrow<64, TRANS>(lhs, rhs, args, splits, stages, st);
  } else {
    if (tile_n == 256) return launch_wide<256, TRANS>(lhs, rhs, args, stages, sms, st);
    if (tile_n == 192) return launch_wide<192, TRANS>(lhs, rhs, args, stages, sms, st);
    if (tile_n == 128) return launch_wide<128, TRANS>(lhs, rhs, args, stages, sms, st);
  }
  return cudaErrorInvalidValue;
}

template <bool TRANS>
cudaError_t launch_tf32(const void* lhs, const void* rhs, const tf::Args& args, int sms,
                        cudaStream_t st) {
  Maps maps;
  if (!encode_rows_map(&maps.a, lhs, args.m, args.k, 64, true) ||
      !(TRANS ? encode_bank_map(&maps.b, rhs, args.E, args.n, args.k, tf::kBN, true)
              : encode_bank_map(&maps.b, rhs, args.E, args.k, args.n, tf::kKStep, true)))
    return cudaErrorInvalidValue;
  const cudaError_t err = allow_smem<gmm_tf32_kernel<TRANS>>(tf::kSmemBytes);
  if (err != cudaSuccess) return err;
  const long long slots = (args.m + tf::kBM - 1) / tf::kBM + min(args.E, args.m);
  const long long items = slots * ((args.n + tf::kBN - 1) / tf::kBN);
  const int grid = static_cast<int>(max(1LL, min(static_cast<long long>(sms), items)));
  gmm_tf32_kernel<TRANS><<<grid, tf::kThreads, tf::kSmemBytes, st>>>(maps, args);
  return cudaGetLastError();
}

}  // namespace

// out [m, n] = the grouped product of lhs [m, k] and rhs [E, k, n] (with
// transpose_rhs, rhs [E, n, k]); group_sizes [E] int32 on the device, 1 <= E
// <= 1024. All contiguous, 16-byte aligned, k and n multiples of 8 (bf16) or
// 4 (f32). One launch. bf16 runs the schedule ops/gmm.py `gmm_schedule`
// gives: splits = 0 the many-row kernel at column tile `tile_n` (256, 192 or
// 128) with `stages` stages on a grid of at most `sms` blocks; splits = S in
// 1..8 the few-row one (m <= 64) at column tile 128 or 64, k split S ways,
// `stages` stages a block. f32 runs the TF32 kernel on at most `sms` blocks
// (tile_n and stages unread). Returns the CUDA error code.
extern "C" int gmm_launch(const void* lhs, const void* rhs, const void* group_sizes, void* out,
                          int m, int k, int n, int E, int transpose_rhs, int is_f32, int splits,
                          int tile_n, int stages, int sms, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (E < 1 || E > kMaxGroups || m < 1 || k < 1 || n < 1 || sms < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (is_f32) {
    const tf::Args args{static_cast<const int*>(group_sizes), static_cast<float*>(out), E, m, k,
                        n};
    err = transpose_rhs ? launch_tf32<true>(lhs, rhs, args, sms, st)
                        : launch_tf32<false>(lhs, rhs, args, sms, st);
  } else {
    const Args args{static_cast<const int*>(group_sizes), static_cast<__nv_bfloat16*>(out), E,
                    m, k, n};
    err = transpose_rhs ? launch_bf16<true>(lhs, rhs, args, splits, tile_n, stages, sms, st)
                        : launch_bf16<false>(lhs, rhs, args, splits, tile_n, stages, sms, st);
  }
  return static_cast<int>(err);
}

// *out = how many clusters of the few-row kernel's launch at m rows, column
// tile `tile_n`, `splits` blocks a cluster and `stages` stages a block the
// current device holds at once (cudaOccupancyMaxActiveClusters): what
// ops/gmm.py's CLUSTER_FILL margin assumes, checked on the card. Returns the
// CUDA error code.
extern "C" int gmm_max_clusters(int m, int tile_n, int splits, int stages, int* out) {
  if (m < 1 || m > 64 || splits < 1 || splits > narrow::kMaxSplits || stages < 1 ||
      (tile_n != 64 && tile_n != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const int a_rows = (m + 7) / 8 * 8;
  const void* kernel = tile_n == 128 ? reinterpret_cast<const void*>(gmm_splitk_kernel<128, false>)
                                     : reinterpret_cast<const void*>(gmm_splitk_kernel<64, false>);
  cudaError_t err = tile_n == 128 ? allow_smem<gmm_splitk_kernel<128, false>>(kMaxSmem)
                                  : allow_smem<gmm_splitk_kernel<64, false>>(kMaxSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits * 256);
  cfg.blockDim = dim3(narrow::kThreads);
  cfg.dynamicSmemBytes = tile_n == 128 ? narrow_smem<128>(stages, a_rows, splits)
                                       : narrow_smem<64>(stages, a_rows, splits);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(out, kernel, &cfg));
}

// out [E, k, n] = per group lhs[rows_e]ᵀ · rhs[rows_e], lhs [m, k], rhs [m, n];
// one launch on a grid of at most `sms` blocks. Returns the CUDA error code.
extern "C" int tgmm_launch(const void* lhs, const void* rhs, const void* group_sizes, void* out,
                           int m, int k, int n, int E, int is_f32, int sms, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (E < 1 || E > kMaxGroups || m < 1 || k < 1 || n < 1 || sms < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Maps maps;
  cudaError_t err;
  long long items;
  if (is_f32) {
    if (!encode_rows_map(&maps.a, lhs, m, k, tf::kKStep, true) ||
        !encode_rows_map(&maps.b, rhs, m, n, tf::kKStep, true))
      return static_cast<int>(cudaErrorInvalidValue);
    err = allow_smem<tgmm_tf32_kernel>(tf::kSmemBytes);
    items = static_cast<long long>(E) * ((k + tf::kBM - 1) / tf::kBM) *
            ((n + tf::kBN - 1) / tf::kBN);
  } else {
    if (!encode_rows_map(&maps.a, lhs, m, k, kBK) || !encode_rows_map(&maps.b, rhs, m, n, kBK) ||
        !encode_bank_map(&maps.c, out, E, k, n, 64))
      return static_cast<int>(cudaErrorInvalidValue);
    err = allow_smem<tgmm_wgmma_kernel>(tg::kSmemBytes);
    items = static_cast<long long>(E) * ((k + wide::kBM - 1) / wide::kBM) *
            ((n + tg::kBN - 1) / tg::kBN);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = static_cast<int>(min(static_cast<long long>(sms), items));
  if (is_f32) {
    const tf::Args args{static_cast<const int*>(group_sizes), static_cast<float*>(out), E, m, k,
                        n};
    tgmm_tf32_kernel<<<grid, tf::kThreads, tf::kSmemBytes, st>>>(maps, args);
  } else {
    const Args args{static_cast<const int*>(group_sizes), static_cast<__nv_bfloat16*>(out), E, m,
                    k, n};
    tgmm_wgmma_kernel<<<grid, wide::kThreads, tg::kSmemBytes, st>>>(maps, args);
  }
  return static_cast<int>(cudaGetLastError());
}
