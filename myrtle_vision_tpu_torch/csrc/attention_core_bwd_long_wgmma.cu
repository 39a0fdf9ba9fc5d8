// attention_core_bwd above 256 tokens on Hopper: the per-head part of the
// TPU attention block's backward (myrtle_vision_tpu/ops/fused_attention_block.py
// `_bwd_one_image`, the loop over heads) for sequences longer than the
// one-CTA kernel of attention_core_bwd_wgmma.cu takes.  The function and
// its roundings are the TPU kernel's, from the forward's saved rowmax m
// and reciprocal rowsum rs (B, H, N) fp32, the qkv rows (B, N, 3C) bf16
// and d_o = do @ Wp^T (B, N, C) fp32:
//   qs  = bf16(q * scale)            du = bf16(d_o_h * rs)
//   s   = qs . k^T      (fp32)       e  = exp(s - m)   (the saved m)
//   dp  = du . v^T      (fp32)       r  = rowsum(dp * e), the whole row
//   ds  = e * (dp - r * rs)          dsb = bf16(ds),  eb = bf16(e)
//   dq  = (dsb . k) * scale          dk = dsb^T . qs    dv = eb^T . du
// into dqkv (B, N, 3C) bf16, each fp32 value rounded once, and the fp32
// column sums of the unrounded values per image (B, 3C).  e is
// 2^(s log2 e - m log2 e) (one FFMA, then MUFU.EX2), exp(s - m) up to an
// fp32 rounding of its argument.  r is summed over the fp32 dp * e of the
// whole row, as the TPU kernel does; the flash backward's rowsum(do * o)
// rounds elsewhere and o is not an input here, so r takes a walk over
// every key before any ds exists.
//
// The fused block runs up to the `fuses_at` gate of
// myrtle_vision_tpu/ops/fused_attention_block.py, 701 tokens at 6 heads of
// 64: YOLOS-S training at 256-384 px (357-677 tokens) runs every block's
// core backward here.
//
// What bounds it on the H100: the algorithm's five N x N x D products per
// (image, head) are 10 B H N^2 D = 14.1 GFLOP at (8 images, 6 heads of
// 64, N = 677), 0.0142 ms at 989 TFLOP/s, against 41.5 MB of qkv, d_o,
// dqkv and the statistics (0.0124 ms at 3.35 TB/s): the tensor cores.
//
// Four kernels, no atomics, every sum in a fixed order, so results are
// bitwise reproducible (core_long_wgmma.cuh holds the CTA's roles, 64
// own rows a CTA of one consumer warpgroup and a producer warp, two CTAs
// an SM):
// - prep: qs and du, (B, N, C) bf16 each (16-byte loads and stores), and
//   m log2(e) in rows of n_pad = N rounded up to 64 per (image, head),
//   zero past N, so that each 64-row tile of them starts 256-byte aligned
//   for its 1-D TMA box;
// - dq: a CTA per 64 queries; the producer loads their qs and du once
//   and walks the 64-key tiles of K and V twice through a ring.  Walk 1:
//   S = qs K^T and dP = du V^T (SS wgmma m64n64), e and the rows' partial
//   r in registers.  Between the walks each row's T = r rs goes into the
//   second half of the statistics' rows.  Walk 2: S and dP again, ds =
//   e (dp - T) in registers, rounded to bf16 as the register A operand of
//   dQ += dsb K (K read MN-major through the transpose bit), in flight
//   under the next tile's S and dP;
// - dk / dv: a CTA per 64 keys; the producer loads their K and V once and
//   keeps a ring of query tiles full: 64 rows of qs and du and their m
//   log2(e) and T (1-D tensor maps over the statistics' rows).  Per tile
//   S^T = K qs^T and dP^T = V du^T (SS), e^T and ds^T in registers, then
//   dV += eb^T du and dK += dsb^T qs as register-A wgmma with du and qs
//   MN-major: the transposed key pass of attention_core_bwd_wgmma.cu over
//   a sequence of any length;
// - colsum: each dq and dk / dv CTA writes the column sums of its 64 rows
//   (its warps' in order), and the last pass adds the tiles per image in
//   tile order.
// Products per 64 x 64 tile pair: S and dP in each of the dq kernel's two
// walks, dQ, then S^T, dP^T, dV and dK: nine, where the algorithm needs
// five, in exchange for no atomics and no (N, N) matrix in memory; the
// mma.sync route this replaces (flash_bwd_tiles.cuh) also did nine, each
// waited on.  ptxas -v (sm_90a, nvcc 12.9): dq 141 registers a thread
// at D = 64 (125 at 32), dk / dv 164 (136), no spills.  On one H100 at
// 700 W the four kernels take 0.0832 ms on the device clock at (8, 677),
// the route they replaced 0.2684 (tools/perf/core_long_bench.py): dq
// 0.0386, dk / dv 0.0338, prep 0.0081, column sums 0.0028.
#include "core_long_wgmma.cuh"

namespace {

using mvt::bf16;
namespace sm = mvt::sm90;
namespace fw = mvt::flashw;
namespace cl = mvt::core_long;

constexpr int kLaunches = 4;

// qs[i] = bf16(q * scale) and du[i] = bf16(d_o * rs) for the (B N C / 8)
// 8-column groups i, then stats[row] = m log2(e) for the (B H n_pad) rows
// (zero past N), one grid-stride walk over both
template <int D>
__global__ void __launch_bounds__(256)
core_long_prep_kernel(const bf16* __restrict__ qkv,
                      const float* __restrict__ d_o,
                      const float* __restrict__ m,
                      const float* __restrict__ rs, bf16* __restrict__ qs,
                      bf16* __restrict__ du, float* __restrict__ stats, int N,
                      int heads, int n_pad, long long groups, long long rows,
                      float scale) {
  const int C = heads * D;
  const int cg = C / 8;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < groups + rows; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    if (i < groups) {
      const long long bn = i / cg;
      const int col = static_cast<int>(i % cg) * 8;
      const long long b = bn / N;
      const int row = static_cast<int>(bn % N);
      const uint4 qv =
          *reinterpret_cast<const uint4*>(qkv + bn * 3 * C + col);
      const float* dr = d_o + bn * C + col;
      const float4 d0 = *reinterpret_cast<const float4*>(dr);
      const float4 d1 = *reinterpret_cast<const float4*>(dr + 4);
      const float r = rs[(b * heads + col / D) * N + row];
      const __nv_bfloat162* qe = reinterpret_cast<const __nv_bfloat162*>(&qv);
      uint4 qo, uo;
      float2 f;
      f = __bfloat1622float2(qe[0]);
      qo.x = sm::pack_bf16(f.x * scale, f.y * scale);
      f = __bfloat1622float2(qe[1]);
      qo.y = sm::pack_bf16(f.x * scale, f.y * scale);
      f = __bfloat1622float2(qe[2]);
      qo.z = sm::pack_bf16(f.x * scale, f.y * scale);
      f = __bfloat1622float2(qe[3]);
      qo.w = sm::pack_bf16(f.x * scale, f.y * scale);
      uo.x = sm::pack_bf16(d0.x * r, d0.y * r);
      uo.y = sm::pack_bf16(d0.z * r, d0.w * r);
      uo.z = sm::pack_bf16(d1.x * r, d1.y * r);
      uo.w = sm::pack_bf16(d1.z * r, d1.w * r);
      *reinterpret_cast<uint4*>(qs + bn * C + col) = qo;
      *reinterpret_cast<uint4*>(du + bn * C + col) = uo;
    } else {
      const long long w = i - groups;
      const long long bh = w / n_pad;
      const int row = static_cast<int>(w % n_pad);
      stats[w] = row < N ? m[bh * N + row] * cl::kLog2e : 0.f;
    }
  }
}

// dbias[b, c] = sum over the tiles t, in order, of colpart[b, t, c]
__global__ void __launch_bounds__(256)
core_long_colsum_kernel(const float* __restrict__ colpart,
                        float* __restrict__ dbias, int tiles, int cols,
                        int images) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= images * cols) return;
  const int b = i / cols, c = i % cols;
  float s = 0.f;
  for (int t = 0; t < tiles; ++t)
    s += colpart[(static_cast<size_t>(b) * tiles + t) * cols + c];
  dbias[i] = s;
}

struct BwdArgs {
  const float* m;      // (B, H, N), the forward's rowmax
  const float* rs;     // (B, H, N), the forward's reciprocal rowsum
  float* stats;        // m log2(e), then T = r rs, rows of n_pad
  bf16* dqkv;          // (B, N, 3C)
  float* colpart;      // (B, n_pad / 64, 3C)
  int heads, n, n_pad;
  float scale;
  fw::Axes axes;       // the (B, H, N, D) views of the qkv rows
  fw::Axes s_axes;     // those of the qs and du scratch
};

// Stores a 64-row accumulator tile (times `mul`) as bf16 pairs into
// section `sec` of head h of the dqkv rows ra, ra + 8 (those below n), and
// the stored fp32 values' column sums over the CTA's rows, its warps in
// order, into its tile's row of colpart.  Every consumer thread calls it.
template <int D>
__device__ __forceinline__ void store_section(const float (&acc)[D / 2],
                                              float mul, const BwdArgs& a,
                                              int b, int h, int sec, int ra,
                                              float* colbuf, int warp, int g,
                                              int t, int tid) {
  const int C = a.heads * D;
  const size_t row_stride = static_cast<size_t>(3) * C;
  float col[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) col[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = ra + 8 * i;
    if (row >= a.n) continue;
    bf16* dst = a.dqkv + (static_cast<size_t>(b) * a.n + row) * row_stride +
                sec * C + h * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float x0 = acc[4 * j + 2 * i] * mul;
      const float x1 = acc[4 * j + 2 * i + 1] * mul;
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j + 2 * t) =
          __floats2bfloat162_rn(x0, x1);
      col[2 * j] += x0;
      col[2 * j + 1] += x1;
    }
  }
  sm::warp_colsums<D>(col, colbuf, warp, sec, g, t);
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
  if (tid < D) {
    float v = 0.f;
#pragma unroll
    for (int wi = 0; wi < cl::kConsumerWarps; ++wi)
      v += colbuf[(wi * 3 + sec) * D + tid];
    const int tiles = a.n_pad / cl::kRows;
    a.colpart[(static_cast<size_t>(b) * tiles + blockIdx.x) * row_stride +
              sec * C + h * D + tid] = v;
  }
}

// e = 2^(s log2 e - m log2 e) in place of a 64 x 64 score tile of the dq
// kernel (s[4 jj + e]: row ra (e < 2) or ra + 8, key k0 + 8 jj + 2 t +
// (e % 2)), zero for keys at or past n and for rows that are not valid
__device__ __forceinline__ void exp_tile(float (&s)[cl::kBwdTile / 2],
                                         const float (&m2)[2],
                                         const bool (&valid)[2], int k0,
                                         int n, int t) {
#pragma unroll
  for (int jj = 0; jj < cl::kBwdTile / 8; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool v = valid[e >> 1] && k0 + 8 * jj + 2 * t + (e & 1) < n;
      const float x =
          sm::exp2_approx(fmaf(s[4 * jj + e], cl::kLog2e, -m2[e >> 1]));
      s[4 * jj + e] = v ? x : 0.f;
    }
}

template <int D>
__global__ void __launch_bounds__(cl::kThreads, cl::kCtasPerSm)
core_long_dq_kernel(const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const __grid_constant__ CUtensorMap map_qs,
                    const __grid_constant__ CUtensorMap map_du,
                    const BwdArgs a) {
  using L = cl::DqLayout<D>;
  constexpr int S = cl::kBwdStages, BK = cl::kBwdTile, kRow = L::kRow;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = fw::aligned_smem(smem_raw);
  unsigned char* Qs = smem;
  unsigned char* Us = smem + L::kOwn;
  unsigned char* ring = smem + 2 * L::kOwn;
  uint64_t* own_full = reinterpret_cast<uint64_t*>(smem + L::kBarOff);
  uint64_t* full = own_full + 1;
  uint64_t* empty = full + S;
  float* colbuf = reinterpret_cast<float*>(smem + L::kColOff);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y, b = bh / a.heads, h = bh % a.heads;
  const int q0 = blockIdx.x * cl::kRows;
  const int n_kt = (a.n + BK - 1) / BK;

  if (tid == 0) {
    sm::mbar_init(own_full, 1);
    for (int s = 0; s < S; ++s) {
      sm::mbar_init(&full[s], 1);
      sm::mbar_init(&empty[s], cl::kConsumerWarps);
    }
    sm::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= cl::kConsumerWarps) {
    // the producer warp: the CTA's qs and du, then the key tiles twice
    if (lane == 0) {
      sm::mbar_expect_tx(own_full, 2 * L::kOwn);
      fw::load_rows(Qs, &map_qs, own_full, a.s_axes, q0, h, b);
      fw::load_rows(Us, &map_du, own_full, a.s_axes, q0, h, b);
      for (int it = 0; it < 2 * n_kt; ++it) {
        const int s = it % S, j = it < n_kt ? it : it - n_kt;
        const uint32_t use = it / S;
        if (use > 0) sm::mbar_wait(&empty[s], (use - 1) & 1);
        unsigned char* st = ring + s * L::kStage;
        sm::mbar_expect_tx(&full[s], 2 * L::kTile);
        fw::load_rows(st, &map_k, &full[s], a.axes, j * BK, h, b);
        fw::load_rows(st + L::kTile, &map_v, &full[s], a.axes, j * BK, h, b);
      }
    }
    return;
  }

  // the consumer warpgroup: rows ra = q0 + 16 w + g and ra + 8
  const int g = lane >> 2, t = lane & 3;
  const int ra = q0 + 16 * warp + g;
  bool valid[2];
  float m2[2], rsr[2], r[2] = {0.f, 0.f}, tr[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = ra + 8 * i;
    valid[i] = row < a.n;
    const size_t si = static_cast<size_t>(bh) * a.n + row;
    m2[i] = valid[i] ? a.m[si] * cl::kLog2e : 0.f;
    rsr[i] = valid[i] ? a.rs[si] : 0.f;
  }
  const uint64_t dqa = sm::rows_desc<D>(Qs, 0);
  const uint64_t dua = sm::rows_desc<D>(Us, 0);
  float s[BK / 2], dp[BK / 2];
  sm::mbar_wait(own_full, 0);
  // walk 1: r = rowsum(dp e) of the rows, this thread's columns in order
  for (int j = 0; j < n_kt; ++j) {
    const int si = j % S;
    const unsigned char* st = ring + si * L::kStage;
    sm::mbar_wait(&full[si], (j / S) & 1);
    fw::issue_pair<D>(s, dqa, sm::rows_desc<D>(st, 0), dp, dua,
                      sm::rows_desc<D>(st + L::kTile, 0));
    sm::wgmma_wait<1>();
    sm::fence_regs(s);
    exp_tile(s, m2, valid, j * BK, a.n, t);
    sm::wgmma_wait<0>();
    sm::fence_regs(dp);
    fw::release(&empty[si], lane);
    // dp past n is finite (zero rows of V), e there zero
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) r[(i >> 1) & 1] += dp[i] * s[i];
  }
  // T = r rs, for ds here and for the dk / dv kernel (rows past n zero)
  {
    const size_t rows = static_cast<size_t>(gridDim.y) * a.n_pad;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      r[i] += __shfl_xor_sync(0xffffffffu, r[i], 1);
      r[i] += __shfl_xor_sync(0xffffffffu, r[i], 2);
      tr[i] = r[i] * rsr[i];
      if (t == 0)
        a.stats[rows + static_cast<size_t>(bh) * a.n_pad + ra + 8 * i] =
            tr[i];
    }
  }
  // walk 2: ds = e (dp - T) and dQ += dsb K, in flight under the next
  // tile's S and dP.  dQ is zeroed here, and pinned, so that the zeros
  // are not placed among the first tile's products (ptxas then
  // serialises every product, C7515)
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  uint32_t da[BK / 16][4] = {};
  sm::fence_regs(dq);
  for (int j = 0; j < n_kt; ++j) {
    const int it = n_kt + j, si = it % S;
    const unsigned char* st = ring + si * L::kStage;
    const uint64_t dkt = sm::rows_desc<D>(st, 0);
    sm::mbar_wait(&full[si], (it / S) & 1);
    fw::issue_pair<D>(s, dqa, dkt, dp, dua,
                      sm::rows_desc<D>(st + L::kTile, 0));
    sm::wgmma_wait<1>();
    sm::fence_regs(s);
    sm::fence_regs(dq);
#pragma unroll
    for (int kt = 0; kt < BK / 16; ++kt) sm::fence_regs(da[kt]);
    // the stage of the last dQ is free once that product is done
    if (j > 0) fw::release(&empty[(it - 1) % S], lane);
    exp_tile(s, m2, valid, j * BK, a.n, t);
    sm::wgmma_wait<0>();
    sm::fence_regs(dp);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)
      dp[i] = s[i] * (dp[i] - tr[(i >> 1) & 1]);
    fw::pack_frags(dp, da);
    // dQ += dsb K: K MN-major
    sm::wgmma_fence();
#pragma unroll
    for (int kt = 0; kt < BK / 16; ++kt)
      sm::WgmmaRS<D>::template mma<1>(dq, da[kt],
                                      sm::desc_add(dkt, kt * 16 * kRow), 1);
    sm::wgmma_commit();
  }
  sm::wgmma_wait<0>();
  sm::fence_regs(dq);
#pragma unroll
  for (int kt = 0; kt < BK / 16; ++kt) sm::fence_regs(da[kt]);
  store_section<D>(dq, a.scale, a, b, h, 0, ra, colbuf, warp, g, t, tid);
}

template <int D>
__global__ void __launch_bounds__(cl::kThreads, cl::kCtasPerSm)
core_long_dkdv_kernel(const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      const __grid_constant__ CUtensorMap map_qs,
                      const __grid_constant__ CUtensorMap map_du,
                      const __grid_constant__ CUtensorMap map_m2,
                      const __grid_constant__ CUtensorMap map_t,
                      const BwdArgs a) {
  using L = cl::DkdvLayout<D>;
  constexpr int S = cl::kBwdStages, BQ = cl::kBwdTile, kRow = L::kRow;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = fw::aligned_smem(smem_raw);
  unsigned char* Ks = smem;
  unsigned char* Vs = smem + L::kOwn;
  unsigned char* ring = smem + 2 * L::kOwn;
  uint64_t* own_full = reinterpret_cast<uint64_t*>(smem + L::kBarOff);
  uint64_t* full = own_full + 1;
  uint64_t* empty = full + S;
  float* colbuf = reinterpret_cast<float*>(smem + L::kColOff);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y, b = bh / a.heads, h = bh % a.heads;
  const int k0 = blockIdx.x * cl::kRows;
  const int n_qt = (a.n + BQ - 1) / BQ;

  if (tid == 0) {
    sm::mbar_init(own_full, 1);
    for (int s = 0; s < S; ++s) {
      sm::mbar_init(&full[s], 1);
      sm::mbar_init(&empty[s], cl::kConsumerWarps);
    }
    sm::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= cl::kConsumerWarps) {
    // the producer warp: the CTA's K and V, then the query tiles
    if (lane == 0) {
      sm::mbar_expect_tx(own_full, 2 * L::kOwn);
      fw::load_rows(Ks, &map_k, own_full, a.axes, k0, h, b);
      fw::load_rows(Vs, &map_v, own_full, a.axes, k0, h, b);
      for (int i = 0; i < n_qt; ++i) {
        const int s = i % S;
        const uint32_t use = i / S;
        if (use > 0) sm::mbar_wait(&empty[s], (use - 1) & 1);
        unsigned char* st = ring + s * L::kStage;
        sm::mbar_expect_tx(&full[s], 2 * L::kTile + 2 * BQ * 4);
        fw::load_rows(st, &map_qs, &full[s], a.s_axes, i * BQ, h, b);
        fw::load_rows(st + L::kTile, &map_du, &full[s], a.s_axes, i * BQ, h,
                      b);
        const int row = bh * a.n_pad + i * BQ;
        sm::tma_load_1d(st + 2 * L::kTile, &map_m2, &full[s], row);
        sm::tma_load_1d(st + 2 * L::kTile + BQ * 4, &map_t, &full[s], row);
      }
    }
    return;
  }

  // the consumer warpgroup: keys ka = k0 + 16 w + g and ka + 8
  const int g = lane >> 2, t = lane & 3;
  const int ka = k0 + 16 * warp + g;
  const bool va = ka < a.n, vb = ka + 8 < a.n;
  const uint64_t dka = sm::rows_desc<D>(Ks, 0);
  const uint64_t dva = sm::rows_desc<D>(Vs, 0);
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  float s[BQ / 2], dp[BQ / 2];
  uint32_t pa[BQ / 16][4] = {}, da[BQ / 16][4] = {};
  sm::mbar_wait(own_full, 0);
  for (int i = 0; i < n_qt; ++i) {
    const int si = i % S;
    const unsigned char* st = ring + si * L::kStage;
    const float* m2_s = reinterpret_cast<const float*>(st + 2 * L::kTile);
    const float* t_s = m2_s + BQ;
    const uint64_t dqt = sm::rows_desc<D>(st, 0);
    const uint64_t dut = sm::rows_desc<D>(st + L::kTile, 0);
    sm::mbar_wait(&full[si], (i / S) & 1);
    // S^T = K qs^T, dP^T = V du^T
    fw::issue_pair<D>(s, dka, dqt, dp, dva, dut);
    sm::wgmma_wait<1>();
    sm::fence_regs(s);
    if (i > 0) fw::release(&empty[(i - 1) % S], lane);
    // s[4 j + e]: key ka (e < 2) or ka + 8, query q0 + 8 j + 2 t + (e % 2)
    const int q0 = i * BQ;
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const int qc = 8 * j + 2 * t;
      const float2 mq = *reinterpret_cast<const float2*>(m2_s + qc);
      const float mm[2] = {mq.x, mq.y};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool v = ((e & 2) ? vb : va) && q0 + qc + (e & 1) < a.n;
        const float x =
            sm::exp2_approx(fmaf(s[4 * j + e], cl::kLog2e, -mm[e & 1]));
        s[4 * j + e] = v ? x : 0.f;
      }
    }
    fw::pack_frags(s, pa);
    sm::wgmma_wait<0>();
    sm::fence_regs(dp);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const float2 tq = *reinterpret_cast<const float2*>(t_s + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[4 * j + e] =
            s[4 * j + e] * (dp[4 * j + e] - ((e & 1) ? tq.y : tq.x));
    }
    fw::pack_frags(dp, da);
    // dV += eb^T du, dK += dsb^T qs: du and qs MN-major
    sm::wgmma_fence();
#pragma unroll
    for (int kt = 0; kt < BQ / 16; ++kt)
      sm::WgmmaRS<D>::template mma<1>(dv, pa[kt],
                                      sm::desc_add(dut, kt * 16 * kRow), 1);
#pragma unroll
    for (int kt = 0; kt < BQ / 16; ++kt)
      sm::WgmmaRS<D>::template mma<1>(dk, da[kt],
                                      sm::desc_add(dqt, kt * 16 * kRow), 1);
    sm::wgmma_commit();
    // waited here, as the flash backward's dk / dv kernel does: in flight
    // under the next tile's S^T and dP^T, dK and dV, their operands and
    // those two accumulators leave too few registers
    sm::wgmma_wait<0>();
    sm::fence_regs(dk);
    sm::fence_regs(dv);
#pragma unroll
    for (int kt = 0; kt < BQ / 16; ++kt) {
      sm::fence_regs(pa[kt]);
      sm::fence_regs(da[kt]);
    }
  }
  // sections 1 and 2 take their own rows of the column sums' buffer
  store_section<D>(dk, 1.0f, a, b, h, 1, ka, colbuf, warp, g, t, tid);
  store_section<D>(dv, 1.0f, a, b, h, 2, ka, colbuf, warp, g, t, tid);
}

template <int D>
int launch(const void* qkv, const void* d_o, const void* m, const void* rs,
           void* dqkv, void* dbias, void* qd, void* stats, void* colpart,
           int B, int N, int heads, float scale, cudaStream_t stream) {
  BwdArgs a;
  a.m = static_cast<const float*>(m);
  a.rs = static_cast<const float*>(rs);
  a.stats = static_cast<float*>(stats);
  a.dqkv = static_cast<bf16*>(dqkv);
  a.colpart = static_cast<float*>(colpart);
  a.heads = heads;
  a.n = N;
  a.n_pad = cl::n_pad(N);
  a.scale = scale;
  const long long C = static_cast<long long>(heads) * D;
  const long long rows = static_cast<long long>(B) * heads * a.n_pad;
  const long long groups = static_cast<long long>(B) * N * C / 8;
  const bf16* base = static_cast<const bf16*>(qkv);
  bf16* qs = static_cast<bf16*>(qd);
  bf16* du = qs + static_cast<long long>(B) * N * C;

  const long long work = groups + rows;
  const int blocks = static_cast<int>((work + 255) / 256 < 4096
                                          ? (work + 255) / 256
                                          : 4096);
  core_long_prep_kernel<D><<<blocks, 256, 0, stream>>>(
      base, static_cast<const float*>(d_o), a.m, a.rs, qs, du, a.stats, N,
      heads, a.n_pad, groups, rows, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  // K and V: (B, H, N, D) views of the qkv rows; qs and du: those of the
  // (B, N, C) scratch; 64-row boxes, own rows and walked tiles alike
  CUtensorMap mk, mv, mq, mu, mm, mt;
  int err = fw::encode_rows<D>(&mk, base + C, B, heads, N, N * 3 * C, D,
                               3 * C, cl::kBwdTile, &a.axes);
  if (err == 0)
    err = fw::encode_rows<D>(&mv, base + 2 * C, B, heads, N, N * 3 * C, D,
                             3 * C, cl::kBwdTile, &a.axes);
  if (err == 0)
    err = fw::encode_rows<D>(&mq, qs, B, heads, N, N * C, D, C, cl::kBwdTile,
                             &a.s_axes);
  if (err == 0)
    err = fw::encode_rows<D>(&mu, du, B, heads, N, N * C, D, C, cl::kBwdTile,
                             &a.s_axes);
  if (err == 0) err = fw::encode_stats(&mm, a.stats, rows);
  if (err == 0) err = fw::encode_stats(&mt, a.stats + rows, rows);
  if (err != 0) return err;
  const dim3 grid(a.n_pad / cl::kRows, B * heads);

  constexpr int smem_q = cl::DqLayout<D>::kBytes;
  e = cudaFuncSetAttribute(core_long_dq_kernel<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_q);
  if (e != cudaSuccess) return static_cast<int>(e);
  core_long_dq_kernel<D><<<grid, cl::kThreads, smem_q, stream>>>(mk, mv, mq,
                                                                 mu, a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  constexpr int smem_kv = cl::DkdvLayout<D>::kBytes;
  e = cudaFuncSetAttribute(core_long_dkdv_kernel<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_kv);
  if (e != cudaSuccess) return static_cast<int>(e);
  core_long_dkdv_kernel<D><<<grid, cl::kThreads, smem_kv, stream>>>(
      mk, mv, mq, mu, mm, mt, a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  const int cols = static_cast<int>(3 * C);
  core_long_colsum_kernel<<<(B * cols + 255) / 256, 256, 0, stream>>>(
      a.colpart, static_cast<float*>(dbias), a.n_pad / cl::kRows, cols, B);
  return static_cast<int>(cudaGetLastError());
}

// the figures of one backward kernel: query or key tiles per (image,
// head), the CTA's rows, the walked tile's rows, threads, stages, dynamic
// shared memory and the CTAs an SM that the runtime fits
int figures(const void* fn, int smem, int N, int* f) {
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int ctas = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, fn, cl::kThreads,
                                                      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int v[7] = {cl::n_pad(N) / cl::kRows, cl::kRows, cl::kBwdTile,
                    cl::kThreads, cl::kBwdStages, smem, ctas};
  for (int i = 0; i < 7; ++i) f[i] = v[i];
  return 0;
}

template <int D>
int figures_d(int N, int* f) {
  int err = figures(reinterpret_cast<const void*>(core_long_dq_kernel<D>),
                    cl::DqLayout<D>::kBytes, N, f);
  if (err == 0)
    err = figures(reinterpret_cast<const void*>(core_long_dkdv_kernel<D>),
                  cl::DkdvLayout<D>::kBytes, N, f + 7);
  f[14] = kLaunches;
  return err;
}

}  // namespace

// the dq and the dk / dv kernel's figures, then the kernels a call
// launches, into f[0..14] (mvt_attention_core_long_plan)
int core_long_bwd_figures(int N, int D, int* f) {
  if (D == 64) return figures_d<64>(N, f);
  if (D == 32) return figures_d<32>(N, f);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The long route at any N: scratch qd (2, B, N, C) bf16 (qs, then du),
// stats (2, B heads n_pad) fp32 (n_pad = N rounded up to 64; m log2(e),
// then r rs), colpart (B, n_pad / 64, 3C) fp32; qkv, d_o and qd 16-byte
// aligned, stats too (its TMA boxes).  *launched receives the kernels
// launched, 4.
MVT_EXPORT int mvt_attention_core_bwd_tiled(
    const void* qkv, const void* d_o, const void* m, const void* rs,
    void* dqkv, void* dbias, void* qd, void* stats, void* colpart, int B,
    int N, int heads, int D, float scale, int* launched, void* stream) {
  *launched = 0;
  if (B <= 0 || heads <= 0 || N <= 0 ||
      static_cast<long long>(B) * heads > 65535 || qd == nullptr ||
      stats == nullptr || colpart == nullptr ||
      2LL * B * heads * cl::n_pad(N) > 2147483647LL ||
      reinterpret_cast<uintptr_t>(qkv) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(d_o) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(qd) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(stats) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (D == 64)
    err = launch<64>(qkv, d_o, m, rs, dqkv, dbias, qd, stats, colpart, B, N,
                     heads, scale, s);
  else if (D == 32)
    err = launch<32>(qkv, d_o, m, rs, dqkv, dbias, qd, stats, colpart, B, N,
                     heads, scale, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (err == 0) *launched = kLaunches;
  return err;
}
