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
//           offsets inside the chunk (zz % 64 == 0, so no tile straddles).
// step_lens[b] masks columns >= it (the valid keys of the visiting shard,
// from the global kv_lens of contiguous end padding). Tiles with no visible
// key are skipped, never loaded; only tiles that straddle a boundary are
// masked. A masked logit is −inf while the carry's m starts at −1e30, so a
// masked key adds exactly 0: a row that has seen no key yet keeps m = −1e30,
// l = 0, acc = 0 (the Pallas kernel carries phantom mass there until the
// first real key wipes it; valid rows agree either way).
//
// Bound on the H100: operations, 4·B·N·Lq·Lk_visible·D FLOPs on the bf16
// tensor cores (989 TFLOP/s): at the 1.3B DiT's sp = 4 shape ([2, 8190, 12,
// 128] q against 8,190 keys) 3.3 TFLOP per step, 3.3 ms. Design: the flash
// forward's (flash_fwd.cu) grid (Lq/64, N, B), 4 warps of 16 q rows each,
// mma.sync.m16n8k16 with f32 accumulators, K/V tiles of 64 rows
// double-buffered with cp.async, plus the carry loaded into the registers
// the accumulators already occupy and stored back at the end. The K/V send
// to the next rank is not in the kernel: it is NCCL point-to-point, posted
// before the launch on its own stream (ops/ring_attention.py).

#include <math.h>

#include "flash_common.cuh"

namespace {

constexpr int D = 128;
using T = Tile<D>;
constexpr int kRows = BQ + 4 * BK;  // smem tile rows: q + 2 stages of K and of V
constexpr size_t kSmem = sizeof(__nv_bfloat16) * kRows * T::LDS;

enum Kind { kNone = 0, kFull = 1, kDiag = 2 };

// How the keys of the 64-column tile at kv0 relate to the q rows of the
// tile at q0: none visible, all visible, or the triangle
// (col − kb) + shift <= (row − qb).
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

__global__ void __launch_bounds__(kThreads)
ring_step_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, float* __restrict__ m_c,
                 float* __restrict__ l_c, float* __restrict__ acc_c,
                 const int* __restrict__ step_lens, int Lq, int Lk, int N, int mode, int my,
                 int src, int n, int zz, float qscale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + BQ * T::LDS;      // 2 stages
  __nv_bfloat16* sV = sK + 2 * BK * T::LDS;  // 2 stages

  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ld = N * D;
  int kv_len = step_lens != nullptr ? step_lens[b] : Lk;
  kv_len = min(max(kv_len, 0), Lk);
  const int q0 = blockIdx.x * BQ;
  const int n_tiles = (kv_len + BK - 1) / BK;

  // a tile is live when at least one of its keys is visible to a row of ours
  auto live = [&](int j) {
    const Rel r = relation(mode, q0, j * BK, my, src, n, zz);
    if (r.kind == kNone) return false;
    return r.kind == kFull || (j * BK - r.kb) + r.shift <= (q0 - r.qb) + BQ - 1;
  };
  auto next_live = [&](int j) {
    while (j < n_tiles && !live(j)) ++j;
    return j;
  };
  int j = next_live(0);
  if (j >= n_tiles) return;  // nothing visible: the carry stays as it is

  const size_t head_off = static_cast<size_t>(h) * D;
  const __nv_bfloat16* qg = q + static_cast<size_t>(b) * Lq * ld + head_off;
  const __nv_bfloat16* kg = k + static_cast<size_t>(b) * Lk * ld + head_off;
  const __nv_bfloat16* vg = v + static_cast<size_t>(b) * Lk * ld + head_off;

  load_tile<D>(sQ, qg + static_cast<size_t>(q0) * ld, 0, Lq - q0, ld);
  cp_async_commit();
  load_tile<D>(sK, kg, j * BK, kv_len, ld);
  load_tile<D>(sV, vg, j * BK, kv_len, ld);
  cp_async_commit();
  cp_async_wait<1>();  // the q tile has landed
  __syncthreads();

  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    ldmatrix_x4(qf[kk], sQ + T::off(warp * 16 + (lane % 16), kk * 2 + lane / 16));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 t = *reinterpret_cast<__nv_bfloat162*>(&qf[kk][i]);
      float2 f = __bfloat1622float2(t);
      qf[kk][i] = pack_bf16(__fmul_rn(f.x, qscale), __fmul_rn(f.y, qscale));
    }
  }

  // carry in: rows row_a and row_a + 8; l goes to one lane of each quad so
  // the quad's shares still sum to the row's l
  const int row_a = q0 + warp * 16 + lane / 4;
  const size_t stat0 = (static_cast<size_t>(b) * N + h) * Lq;
  float* accg = acc_c + static_cast<size_t>(b) * Lq * ld + head_off + (lane % 4) * 2;
  float m_r[2], l_r[2];
  float acc[D / 8][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + r * 8;
    const bool ok = row < Lq;
    m_r[r] = ok ? m_c[stat0 + row] : kNegInf;
    l_r[r] = ok && lane % 4 == 0 ? l_c[stat0 + row] : 0.f;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      float2 a = ok ? *reinterpret_cast<const float2*>(accg + static_cast<size_t>(row) * ld + i * 8)
                    : make_float2(0.f, 0.f);
      acc[i][2 * r] = a.x;
      acc[i][2 * r + 1] = a.y;
    }
  }

  int st = 0;
  while (j < n_tiles) {
    const int jn = next_live(j + 1);
    if (jn < n_tiles) {
      load_tile<D>(sK + (st ^ 1) * BK * T::LDS, kg, jn * BK, kv_len, ld);
      load_tile<D>(sV + (st ^ 1) * BK * T::LDS, vg, jn * BK, kv_len, ld);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile j has landed; tile jn may be in flight
    __syncthreads();
    const __nv_bfloat16* cK = sK + st * BK * T::LDS;
    const __nv_bfloat16* cV = sV + st * BK * T::LDS;

    float s[BK / 8][4];
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t kb[4];
        ldmatrix_x4(kb, cK + T::off(np * 16 + (lane / 16) * 8 + (lane % 8),
                                    kk * 2 + ((lane / 8) & 1)));
        mma_bf16(s[2 * np], qf[kk], kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qf[kk], kb[2], kb[3]);
      }
    }

    // mask the tile where it straddles kv_len or the triangle
    const int kv0 = j * BK;
    const Rel rel = relation(mode, q0, kv0, my, src, n, zz);
    const bool diag_part = rel.kind == kDiag && (kv0 - rel.kb) + BK - 1 + rel.shift > (q0 - rel.qb);
    if (kv0 + BK > kv_len || diag_part) {
#pragma unroll
      for (int nb = 0; nb < BK / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = kv0 + nb * 8 + (lane % 4) * 2 + (e & 1);
          const int row = row_a + (e >> 1) * 8;
          if (col >= kv_len || (diag_part && (col - rel.kb) + rel.shift > (row - rel.qb)))
            s[nb][e] = -INFINITY;
        }
    }

    float mc[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nb = 0; nb < BK / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) mc[e >> 1] = fmaxf(mc[e >> 1], s[nb][e]);
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mc[r] = fmaxf(mc[r], __shfl_xor_sync(0xffffffffu, mc[r], 1));
      mc[r] = fmaxf(mc[r], __shfl_xor_sync(0xffffffffu, mc[r], 2));
      const float m_new = fmaxf(m_r[r], mc[r]);  // >= −1e30: finite
      alpha[r] = exp2f(m_r[r] - m_new);
      m_r[r] = m_new;
      l_r[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      acc[i][0] *= alpha[0];
      acc[i][1] *= alpha[0];
      acc[i][2] *= alpha[1];
      acc[i][3] *= alpha[1];
    }
#pragma unroll
    for (int nb = 0; nb < BK / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[nb][e] - m_r[e >> 1]);  // a masked key: exactly 0
        l_r[e >> 1] += p;
        s[nb][e] = p;
      }

    // acc += bf16(p)·v; the S accumulator layout is the A operand layout
#pragma unroll
    for (int kj = 0; kj < BK / 16; ++kj) {
      uint32_t pa[4] = {pack_bf16(s[2 * kj][0], s[2 * kj][1]),
                        pack_bf16(s[2 * kj][2], s[2 * kj][3]),
                        pack_bf16(s[2 * kj + 1][0], s[2 * kj + 1][1]),
                        pack_bf16(s[2 * kj + 1][2], s[2 * kj + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, cV + T::off(kj * 16 + ((lane >> 3) & 1) * 8 + (lane & 7),
                                          dp * 2 + (lane >> 4)));
        mma_bf16(acc[2 * dp], pa, vb[0], vb[1]);
        mma_bf16(acc[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // every warp is done with stage st before it is refilled
    j = jn;
    st ^= 1;
  }

  // carry out, in place
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + r * 8;
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (row >= Lq) continue;
    if (lane % 4 == 0) {
      m_c[stat0 + row] = m_r[r];
      l_c[stat0 + row] = l;
    }
    float* arow = accg + static_cast<size_t>(row) * ld;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<float2*>(arow + i * 8) = make_float2(acc[i][2 * r], acc[i][2 * r + 1]);
  }
}

}  // namespace

// q [B, Lq, N, 128] and k/v [B, Lk, N, 128] packed bf16; m, l [B, N, Lq] f32
// and acc [B, Lq, N, 128] f32 updated in place; step_lens [B] int32 or null.
// mode: 0 none, 1 block, 2 token, 3 stripe, 4 zigzag (zz = chunk length,
// a multiple of 64). Returns the CUDA error code.
extern "C" int ring_step_launch(const void* q, const void* k, const void* v, void* m, void* l,
                                void* acc, const void* step_lens, int B, int Lq, int Lk, int N,
                                int head_dim, int mode, int my, int src, int n, int zz,
                                float qscale, void* stream) {
  if (head_dim != D || mode < 0 || mode > 4 || (mode == 4 && (zz <= 0 || zz % BK != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      ring_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Lq + BQ - 1) / BQ, N, B);
  ring_step_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<float*>(m), static_cast<float*>(l),
      static_cast<float*>(acc), static_cast<const int*>(step_lens), Lq, Lk, N, mode, my, src, n,
      zz, qscale);
  return static_cast<int>(cudaGetLastError());
}
