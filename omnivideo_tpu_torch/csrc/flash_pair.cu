// The i2v split cross-attention in one launch, CUDA C++ for sm_90a (bf16 in,
// bf16 out): o = bf16(bf16(A_txt) + bf16(A_img)) for q [B, Lq, N, 128] over
// two key sets, the text (k_txt, v_txt) [B, Lt, N, 128] and the CLIP image
// tokens (k_img, v_img) [B, Li, N, 128]. Each A is row 1's attention
// (flash_fwd.cu, InferOut<128>) with its own per-(b, h) bound mb and its own
// guard `safe`: bounded where that context's guard holds, max-tracked where
// it fails; each is normalised and rounded to bf16 on its own, and the two
// are added in f32 and rounded once, which is the two-call form exactly.
//
// Replaces the TPU kernel omnivideo_tpu/ops/pallas/flash_attention.py::
// _fa_kernel (:42) in the i2v DiT's cross-attention, where JAX
// `_cross_attn_unfused` (models/wan_dit.py:436-456) calls it twice through
// `_flash_fwd_unpadded` (pallas_call at :328) on the same q and sums the
// outputs: rows 1x (257 image keys) and 1t (512 text keys) of the port's
// table, as one kernel.
//
// Bound on the H100: operations, 4·B·N·Lq·(Lt + Li)·D FLOPs on the bf16
// tensor cores (989 TFLOP/s): at I2V-14B's [2, 32760, 40, 128] over 512 +
// 257 keys 1.032e12 FLOP, 1.043 ms; its bytes (q and o once, the four K/V
// tensors once) are 1.374 GB, 0.410 ms at 3.35 TB/s.
//
// Design, for these shapes (a few hundred keys against 32,760 q rows; the
// two-launch form spent ~5.7 µs a block on fixed costs, 60% of row 1x):
// - One persistent block per SM walks work items (128 q rows, head, batch
//   row), q tile fastest, so the blocks in flight share one or two heads'
//   K/V in L2. The producer thread loads an item's q tile once, then its
//   text tiles and its image tiles by TMA, K one tile ahead of V, through
//   two rings: K tiles in kKStages slots (a slot is free once both
//   warpgroups' S of its tile is done), V tiles in kVStages (free once their
//   P·V is done). The rings' mbarrier phases run on across items with no
//   drain. (One ring of three K+V stages leaves no room for the text
//   output; two such stages leave one tile of look-ahead.)
// - The two consumer warpgroups (64 q rows each, FA3's ping-pong as in the
//   Hopper mainloop, flash_fwd_hopper.cuh) pre-scale their q rows once an
//   item and make two softmax passes over them, text then image, each with
//   its own (m, l, acc). Between the passes the text output is normalised,
//   rounded to bf16 and written to the warpgroup's o tile in shared memory
//   (store_o_staged's layout); after the image pass each thread adds its own
//   entries of the image output to it, and the warpgroup stores whole
//   256-byte rows. (Parked in o instead, by 4-byte stores and loads, the
//   text output cost a quarter of the kernel's time; held in registers, it
//   spilled.)
// - A context's keys are full 128-key tiles, the last one masked where it
//   passes the key count, and, where 1..16 keys remain, a narrow tile: a
//   16-row TMA box, S by m64n16k16 products into an accumulator of its own
//   (S's 64 registers as its accumulator made ptxas serialise every wgmma,
//   C7511) and P·V by one k16 step. At 257 image keys a q tile spends
//   products on 512 + 256 + 16 = 784 keys for 769 live ones (the two-launch
//   form: 896).
// - The q tile goes back to the producer as soon as the item's last S
//   product is done, so the next item's q load runs under this item's last
//   softmax, its last P·V and its epilogue.
// - Every wgmma is issued and waited for inside one branch (the narrow tile
//   is peeled, as the mainloop peels its last tile): a wgmma in flight
//   across a branch made ptxas serialise them all (C7520).
// Times on the H100, and the variants tried (tools/pair_variants.py): PERF.md.

#include "flash_fwd_hopper.cuh"

namespace {

using P = fwdh::Panels<64>;
constexpr int kNarrow = 16;  // keys of a narrow tail tile
constexpr uint32_t kNarrowBytes = 2 * kNarrow * 128;  // a narrow K or V tile, two panels
constexpr int kKStages = 3, kVStages = 2;
constexpr uint32_t kOTile = fwdh::kRows * 256;  // a warpgroup's staged o rows
constexpr uint32_t kKOff = P::kQBytes + 2 * kOTile;
constexpr uint32_t kVOff = kKOff + kKStages * P::kKTile;
constexpr uint32_t kBarOff = kVOff + kVStages * P::kKTile;
constexpr int kBars = 2 + 2 * (kKStages + kVStages);
constexpr size_t kPairSmemBytes = kBarOff + kBars * sizeof(uint64_t) + 1024;  // 225 KiB of 227

// one map per operand (both 64-column panels, told apart by the column), the
// K/V maps per context [text, image]: 128-key boxes and the narrow 16-key ones
struct PairMaps {
  CUtensorMap q, k[2], v[2], kn[2], vn[2];
};

// A context's schedule: nf full-width tiles (the last masked where it passes
// L), then nn (0 or 1) narrow tiles; its bound and guard on the device.
struct Context {
  int L, nf, nn;
  const int* mb;    // [B, N] int32
  const int* safe;  // [1] int32
};

struct PairArgs {
  __nv_bfloat16* o;
  Context c[2];  // text, image
  int Lq, N, n_qt, n_items;
  float qscale;
};

struct PairSmem {
  unsigned char* base;  // 1024-byte aligned
  __device__ unsigned char* q(int wg) const { return base + wg * P::kQTile; }
  __device__ unsigned char* o(int wg) const { return base + P::kQBytes + wg * kOTile; }
  __device__ unsigned char* k(int s) const { return base + kKOff + s * P::kKTile; }
  __device__ unsigned char* v(int s) const { return base + kVOff + s * P::kKTile; }
  __device__ uint64_t* bar(int i) const { return reinterpret_cast<uint64_t*>(base + kBarOff) + i; }
  __device__ uint64_t* q_full() const { return bar(0); }
  __device__ uint64_t* q_empty() const { return bar(1); }
  __device__ uint64_t* k_full(int s) const { return bar(2 + s); }
  __device__ uint64_t* k_empty(int s) const { return bar(2 + kKStages + s); }
  __device__ uint64_t* v_full(int s) const { return bar(2 + 2 * kKStages + s); }
  __device__ uint64_t* v_empty(int s) const { return bar(2 + 2 * kKStages + kVStages + s); }
};

__device__ __forceinline__ PairSmem pair_smem() {
  extern __shared__ __align__(1024) unsigned char pair_smem_raw[];
  const uint32_t a = smem_u32(pair_smem_raw);
  return PairSmem{pair_smem_raw + (((a + 1023) & ~1023u) - a)};
}

// (q tile, head, batch row) of work item i, q tile fastest
__device__ __forceinline__ int3 item_coords(int i, int n_qt, int N) {
  return make_int3(i % n_qt, (i / n_qt) % N, i / (n_qt * N));
}

// d (64 x 16, f32) = (scale_d ? d : 0) + A·B; A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n16(float (&d)[8], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7},"
      " %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

// S (64 x 16) = q (64 rows at a) · K (the narrow tile's 16 rows at b)ᵀ: eight
// k16 steps over both panels, issued and committed as one group
__device__ __forceinline__ void gemm_qk_narrow(float (&d)[8], uint32_t a, uint32_t b) {
  constexpr uint32_t hi = wgmma_desc_hi(kKMajorSbo);
  const uint32_t la0 = wgmma_desc_lo(a, 16), lb0 = wgmma_desc_lo(b, 16);
  const uint32_t la1 = wgmma_desc_lo(a + P::kQ1, 16), lb1 = wgmma_desc_lo(b + P::kK1, 16);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (k < 4)
      wgmma_ss_n16(d, wgmma_desc(la0 + ((k * 32) >> 4), hi), wgmma_desc(lb0 + ((k * 32) >> 4), hi),
                   k > 0);
    else
      wgmma_ss_n16(d, wgmma_desc(la1 + (((k - 4) * 32) >> 4), hi),
                   wgmma_desc(lb1 + (((k - 4) * 32) >> 4), hi), 1);
  }
  wgmma_commit();
}

// O += P (64 x 16 keys, the fragment a) · V (the narrow tile's 16 rows at b,
// MN-major): one k16 step. Issued only.
__device__ __forceinline__ void gemm_pv_narrow(float (&d)[64], const uint32_t (&a)[4], uint32_t b) {
  wgmma_rs_n128_tb(d, a, wgmma_desc(wgmma_desc_lo(b, P::kK1), wgmma_desc_hi(kKMajorSbo)));
}

// The narrow tile's softmax on its S (entry i: row row_a + 8·((i >> 1) & 1),
// key kv0 + 8·(i / 4) + 2·(lane % 4) + (i & 1)), the keys from L masked; as
// fwdh::softmax_tile otherwise.
__device__ __forceinline__ void softmax_narrow(float (&s)[8], float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], bool bounded, int kv0, int L,
                                               int lane) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (kv0 + (i / 4) * 8 + (lane % 4) * 2 + (i & 1) >= L) s[i] = -INFINITY;
  if (!bounded) {
    float mc[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 8; ++i) mc[(i >> 1) & 1] = fmaxf(mc[(i >> 1) & 1], s[i]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mc[r] = fmaxf(mc[r], __shfl_xor_sync(0xffffffffu, mc[r], 1));
      mc[r] = fmaxf(mc[r], __shfl_xor_sync(0xffffffffu, mc[r], 2));
      const float m_new = fmaxf(m[r], mc[r]);
      alpha[r] = fast_exp2(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float p = fast_exp2(s[i] - m[(i >> 1) & 1]);
    l[(i >> 1) & 1] += p;
    s[i] = p;
  }
}

// A consumer warpgroup's state and turn-keeping across items.
struct Consumer {
  PairSmem sm;
  uint32_t sq;    // this warpgroup's q tile
  int cw, lane, row_a;
  int k;          // tiles consumed so far (the rings' position)
  fwdh::Turns turns;

  __device__ void wait_k(int j) const {
    mbar_wait(sm.k_full((k + j) % kKStages), ((k + j) / kKStages) & 1);
  }
  __device__ void wait_v(int j) const {
    mbar_wait(sm.v_full((k + j) % kVStages), ((k + j) / kVStages) & 1);
  }
  __device__ uint32_t k_at(int j) const { return smem_u32(sm.k((k + j) % kKStages)); }
  __device__ uint32_t v_at(int j) const { return smem_u32(sm.v((k + j) % kVStages)); }
  __device__ void release_v(int j) const {
    __syncwarp();
    if (lane == 0) mbar_arrive(sm.v_empty((k + j) % kVStages));
  }
  // S of tile j is done: its K slot back to the producer, and after the
  // item's last S the q tile too
  __device__ void s_done(int j, bool last_s) const {
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(sm.k_empty((k + j) % kKStages));
      if (last_s) mbar_arrive(sm.q_empty());
    }
  }

  // One context's pass over its tiles (ring positions k..k+n−1, every slot
  // released by the end): on return acc and l (summed over the quad) hold
  // its sums. `last`: the item's last context (its last S frees q).
  __device__ __forceinline__ void attend(const Context& cx, bool last, int b, int h, int N,
                                         float (&acc)[64], float (&s)[64], float (&l)[2],
                                         uint32_t (&pa)[8][4]) {
    const bool bounded = cx.safe != nullptr && *cx.safe != 0;
    const int n = cx.nf + cx.nn;
    float m[2], alpha[2], sn[8];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    m[0] = m[1] = bounded ? static_cast<float>(cx.mb[b * N + h]) : fwdh::kInitMax;
    l[0] = l[1] = 0.f;
    const fwdh::TileMask tm[2] = {{false, false, 0, 0, 0}, {false, false, 0, 0, 0}};
    wait_k(0);
    turns.begin();
    if (cx.nf > 0) {
      fwdh::gemm_qk<P>(s, sq, k_at(0));
      turns.end();
      wgmma_wait<0>();
      fence_operands(s);
      s_done(0, last && n == 1);
      fwdh::softmax_tile(s, m, l, alpha, bounded, fwdh::kKeys > cx.L, tm, 0, cx.L, row_a, lane);
    } else {
      gemm_qk_narrow(sn, sq, k_at(0));
      turns.end();
      wgmma_wait<0>();
      fence_operands(sn);
      s_done(0, last);
      softmax_narrow(sn, m, l, alpha, bounded, 0, cx.L, lane);
    }
    // full tiles 1..nf−1: S of tile j+1 with P·V of tile j, the softmax of
    // tile j+1 under P·V of tile j
    for (int j = 0; j + 1 < cx.nf; ++j) {
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) acc_to_a(pa[kk], s, kk);
      wait_k(j + 1);
      wait_v(j);
      fence_operands(acc);
      fence_operands(pa);
      turns.begin();
      fwdh::gemm_qk<P>(s, sq, k_at(j + 1));
      fwdh::gemm_pv<P>(acc, pa, v_at(j));
      wgmma_commit();
      turns.end();
      wgmma_wait<1>();
      fence_operands(s);
      s_done(j + 1, last && j + 2 == n);
      const int kv0 = (j + 1) * fwdh::kKeys;
      fwdh::softmax_tile(s, m, l, alpha, bounded, kv0 + fwdh::kKeys > cx.L, tm, kv0, cx.L, row_a,
                         lane);
      wgmma_wait<0>();
      fence_operands(acc);
      fence_operands(pa);
      release_v(j);
      if (!bounded) fwdh::rescale(acc, alpha);
    }
    if (cx.nn && cx.nf > 0) {  // the narrow tile's S with the last full tile's P·V
      const int j = cx.nf - 1;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) acc_to_a(pa[kk], s, kk);
      wait_k(j + 1);
      wait_v(j);
      fence_operands(acc);
      fence_operands(pa);
      turns.begin();
      gemm_qk_narrow(sn, sq, k_at(j + 1));
      fwdh::gemm_pv<P>(acc, pa, v_at(j));
      wgmma_commit();
      turns.end();
      wgmma_wait<1>();
      fence_operands(sn);
      s_done(j + 1, last);
      softmax_narrow(sn, m, l, alpha, bounded, cx.nf * fwdh::kKeys, cx.L, lane);
      wgmma_wait<0>();
      fence_operands(acc);
      fence_operands(pa);
      release_v(j);
      if (!bounded) fwdh::rescale(acc, alpha);
    }
    // the last tile's P·V
    wait_v(n - 1);
    if (cx.nn) {
      acc_to_a(pa[0], sn, 0);
      fence_operands(acc);
      fence_operands(pa);
      turns.begin();
      wgmma_fence();
      gemm_pv_narrow(acc, pa[0], v_at(n - 1));
      wgmma_commit();
      turns.end();
      wgmma_wait<0>();
    } else {
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) acc_to_a(pa[kk], s, kk);
      fence_operands(acc);
      fence_operands(pa);
      turns.begin();
      wgmma_fence();
      fwdh::gemm_pv<P>(acc, pa, v_at(n - 1));
      wgmma_commit();
      turns.end();
      wgmma_wait<0>();
    }
    fence_operands(acc);
    fence_operands(pa);
    release_v(n - 1);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
  }
};

// this thread's two rows of acc / l rounded to bf16 pairs, at their places in
// the warpgroup's staged o tile (64 rows of 256 bytes, 16-byte chunk c of row
// r at c ^ (r & 7): a warp's stores fall in 32 distinct banks); with `add`,
// added in f32 to the bf16 pairs already there and rounded once
template <bool add>
__device__ __forceinline__ void stage_o(unsigned char* tile, const float (&acc)[64],
                                        const float (&l)[2], int t, int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = (t / 32) * 16 + lane / 4 + r * 8;
    const float inv = l[r] == 0.f ? 1.f : __frcp_rn(l[r]);
    unsigned char* dst = tile + row * 256 + (lane % 4) * 4;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      uint32_t* w = reinterpret_cast<uint32_t*>(dst + ((i ^ (row & 7)) << 4));
      const float x = __fmul_rn(acc[4 * i + 2 * r], inv);
      const float y = __fmul_rn(acc[4 * i + 2 * r + 1], inv);
      if constexpr (add) {
        const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(w));
        const float2 b = __bfloat1622float2(__floats2bfloat162_rn(x, y));
        *w = pack_bf16(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
      } else {
        *w = pack_bf16(x, y);
      }
    }
  }
}

// Per item: text pass, its output staged, image pass, the sum staged and
// stored as whole rows.
__global__ void __launch_bounds__(fwdh::kThreadsWS, 1)
flash_pair_kernel(const __grid_constant__ PairMaps maps, const PairArgs args) {
  const PairSmem sm = pair_smem();
  if (threadIdx.x == 0) {
    mbar_init(sm.q_full(), 1);
    mbar_init(sm.q_empty(), fwdh::kConsumerWarps);
    for (int s = 0; s < kKStages; ++s) {
      mbar_init(sm.k_full(s), 1);
      mbar_init(sm.k_empty(s), fwdh::kConsumerWarps);
    }
    for (int s = 0; s < kVStages; ++s) {
      mbar_init(sm.v_full(s), 1);
      mbar_init(sm.v_empty(s), fwdh::kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int n_mine = (args.n_items - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  const int nt = args.c[0].nf + args.c[0].nn, n_tiles = nt + args.c[1].nf + args.c[1].nn;

  if (threadIdx.x < 128) {  // producer warpgroup: one thread starts every load
    setmaxnreg_dec<fwdh::kProducerRegs>();
    if (threadIdx.x != 0) return;
    // tile t of an item (text first) at ring position g: K or V, full or narrow
    auto load = [&](bool is_v, int g, int t, int h, int b) {
      const bool img = t >= nt;  // selects, not a runtime index into the parameters
      const int j = img ? t - nt : t;
      const bool narrow = j == (img ? args.c[1].nf : args.c[0].nf);
      const int st = is_v ? kVStages : kKStages;
      uint64_t* full = is_v ? sm.v_full(g % st) : sm.k_full(g % st);
      mbar_wait(is_v ? sm.v_empty(g % st) : sm.k_empty(g % st), ((g / st) & 1) ^ 1);
      mbar_arrive_expect_tx(full, narrow ? kNarrowBytes : P::kKTile);
      const PairMaps& mp = maps;
      const CUtensorMap* map =
          is_v ? (narrow ? (img ? &mp.vn[1] : &mp.vn[0]) : (img ? &mp.v[1] : &mp.v[0]))
               : (narrow ? (img ? &mp.kn[1] : &mp.kn[0]) : (img ? &mp.k[1] : &mp.k[0]));
      unsigned char* dst = is_v ? sm.v(g % st) : sm.k(g % st);
#pragma unroll
      for (int p = 0; p < 2; ++p)
        tma_load(dst + p * P::kK1, map, full, p * 64, h, j * fwdh::kKeys, b);
    };
    for (int it = 0; it < n_mine; ++it) {
      const int3 c = item_coords(blockIdx.x + it * gridDim.x, args.n_qt, args.N);
      const int g0 = it * n_tiles;
      if (it > 0) mbar_wait(sm.q_empty(), (it - 1) & 1);
      mbar_arrive_expect_tx(sm.q_full(), P::kQBytes);
#pragma unroll
      for (int wg = 0; wg < 2; ++wg)
#pragma unroll
        for (int p = 0; p < 2; ++p)
          tma_load(sm.q(wg) + p * P::kQ1, &maps.q, sm.q_full(), p * 64, c.y,
                   c.x * fwdh::kBlockRows + wg * fwdh::kRows, c.z);
      load(false, g0, 0, c.y, c.z);
      for (int t = 0; t < n_tiles; ++t) {  // K one tile ahead of V, as S runs ahead of P·V
        if (t + 1 < n_tiles) load(false, g0 + t + 1, t + 1, c.y, c.z);
        load(true, g0 + t, t, c.y, c.z);
      }
    }
    return;
  }

  setmaxnreg_inc<fwdh::kConsumerRegs>();  // consumer warpgroups: 64 q rows each
  const int cw = threadIdx.x / 128 - 1;
  const int t = threadIdx.x % 128, lane = t % 32;
  Consumer cs{sm, smem_u32(sm.q(cw)), cw, lane, 0, 0, fwdh::Turns{cw, n_mine * (n_tiles + 2)}};
  if (cw == 1 && cs.turns.left > 0) named_bar_arrive(1, 256);
  const size_t ld = static_cast<size_t>(args.N) * 128;
  unsigned char* otile = sm.o(cw);
  float acc[64], s[64], l[2];
  uint32_t pa[8][4];
  for (int it = 0; it < n_mine; ++it) {
    const int3 c = item_coords(blockIdx.x + it * gridDim.x, args.n_qt, args.N);
    const int q0c = c.x * fwdh::kBlockRows + cw * fwdh::kRows;
    cs.row_a = q0c + (t / 32) * 16 + lane / 4;
    mbar_wait(sm.q_full(), it & 1);
    fwdh::prescale_q<P>(sm.q(cw), args.qscale, t);
    fence_proxy_async();  // the generic writes before wgmma reads them
    fwdh::consumer_sync();  // also: the last item's staged rows are all read

    cs.attend(args.c[0], false, c.z, c.y, args.N, acc, s, l, pa);
    cs.k += nt;
    stage_o<false>(otile, acc, l, t, lane);
    cs.attend(args.c[1], true, c.z, c.y, args.N, acc, s, l, pa);
    cs.k += n_tiles - nt;
    stage_o<true>(otile, acc, l, t, lane);
    fwdh::consumer_sync();
    __nv_bfloat16* out = args.o + (static_cast<size_t>(c.z) * args.Lq + q0c) * ld +
                         static_cast<size_t>(c.y) * 128;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const int row = (t + 128 * kk) / 16, ch = t % 16;
      if (q0c + row < args.Lq)
        *reinterpret_cast<uint4*>(out + row * ld + ch * 8) =
            *reinterpret_cast<const uint4*>(otile + row * 256 + ((ch ^ (row & 7)) << 4));
    }
  }
}

// the schedule of a context of L >= 1 keys: full tiles, and a narrow tile
// where 1..16 keys remain
Context context(int L, const void* mb, const void* safe) {
  const int r = L % fwdh::kKeys;
  return {L, L / fwdh::kKeys + (r > kNarrow ? 1 : 0), (r >= 1 && r <= kNarrow) ? 1 : 0,
          static_cast<const int*>(mb), static_cast<const int*>(safe)};
}

}  // namespace

// q/o packed [B, Lq, N, 128], k_txt/v_txt [B, Lt, N, 128], k_img/v_img
// [B, Li, N, 128], bf16, 16-byte aligned; mb_* [B, N] and safe_* [1] int32
// on the device (softmax_bound's). Lq, Lt, Li >= 1. Returns the CUDA error
// code (cudaErrorInvalidValue for another head dim, an empty key set or
// operands the tensor maps refuse).
extern "C" int flash_pair_launch(const void* q, const void* k_txt, const void* v_txt,
                                 const void* k_img, const void* v_img, void* o,
                                 const void* mb_txt, const void* safe_txt, const void* mb_img,
                                 const void* safe_img, int B, int Lq, int Lt, int Li, int N,
                                 int head_dim, float qscale, void* stream) {
  if (head_dim != 128 || Lq < 1 || Lt < 1 || Li < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  PairMaps maps;
  const void* ks[2] = {k_txt, k_img};
  const void* vs[2] = {v_txt, v_img};
  const int Ls[2] = {Lt, Li};
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  if (!encode_packed_map(&maps.q, q, B, Lq, N, 128, fwdh::kRows, 64, sw))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int c = 0; c < 2; ++c)
    if (!encode_packed_map(&maps.k[c], ks[c], B, Ls[c], N, 128, fwdh::kKeys, 64, sw) ||
        !encode_packed_map(&maps.v[c], vs[c], B, Ls[c], N, 128, fwdh::kKeys, 64, sw) ||
        !encode_packed_map(&maps.kn[c], ks[c], B, Ls[c], N, 128, kNarrow, 64, sw) ||
        !encode_packed_map(&maps.vn[c], vs[c], B, Ls[c], N, 128, kNarrow, 64, sw))
      return static_cast<int>(cudaErrorInvalidValue);
  PairArgs args;
  args.o = static_cast<__nv_bfloat16*>(o);
  args.c[0] = context(Lt, mb_txt, safe_txt);
  args.c[1] = context(Li, mb_img, safe_img);
  args.Lq = Lq;
  args.N = N;
  args.n_qt = (Lq + fwdh::kBlockRows - 1) / fwdh::kBlockRows;
  args.n_items = args.n_qt * N * B;
  args.qscale = qscale;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_pair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kPairSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = args.n_items < sms ? args.n_items : sms;
  flash_pair_kernel<<<grid, fwdh::kThreadsWS, kPairSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      maps, args);
  return static_cast<int>(cudaGetLastError());
}
