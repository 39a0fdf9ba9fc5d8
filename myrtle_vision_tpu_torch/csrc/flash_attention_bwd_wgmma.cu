// flash_attention_bwd on Hopper: the backward of flash_attention_fwd over
// (B, H, N, D) bf16 q, k, v, keys and query rows at or past n_valid
// masked: from the forward's output o, its fp32 LSE (B, H, N) and the
// output gradient do, the bf16 dq, dk and dv.
//
// Replaces both TPU flash backwards of myrtle_vision_tpu/ops/flash_attention.py:
// the unblocked `_bwd_kernel` (K8, n_pad <= 1536: p = e / rowsum(e) over
// the whole row, recomputed) and the blocked `_blk_bwd_kernel` (K7: p =
// exp(s - lse) per KV tile, dq accumulated over the tiles).  Both compute
// the same function from the same residuals; since the forward kernel
// emits the LSE in both regimes, these kernels take p = exp(scale s - lse)
// in both, as 2^(s scale log2(e) - lse log2(e)) (one FFMA, then MUFU.EX2),
// which moves p by an fp32 rounding against K8.  Every other rounding is
// the TPU kernels': do in bf16, dsum = rowsum(do * o) in fp32, bf16(p)
// before dv = p^T do, ds = p (dp - dsum) in fp32 and bf16(ds) before dq =
// ds k and dk = ds^T q, fp32 accumulation, dq and dk times the scale, each
// output rounded once.
//
// What bounds it on the H100: five N x N x D products per (image, head) in
// the algorithm (10 N^2 D flops) against the bytes of q, k, v, o, do, dq,
// dk, dv and the LSE, so at the YOLOS-S training shapes (8, 6, 1545, 64)
// the tensor cores (0.074 ms at 989 TFLOP/s) and not the memory (0.023 ms
// at 3.35 TB/s); the 2 x 115 M exponentials (both kernels recompute p)
// add about 0.055 ms on the SFUs.
//
// Three kernels, no atomics, every sum in a fixed order, so results are
// bitwise reproducible:
// - a pre-pass, D / 8 lanes a row: dsum, and the LSE times log2(e), each
//   into rows of n_pad = N rounded up to 64 per (image, head), zero past
//   N, so that a tile of them starts 256-byte aligned (a 1-D TMA box
//   whose start is not 16-byte aligned never lands);
// - dk/dv (flash_wgmma.cuh roles): a CTA per 128 keys of one (image,
//   head); the producer loads K and V of those keys once and keeps a
//   ring of query tiles full: 64 rows of q and of do and their LSE and
//   dsum (1-D tensor maps over the pre-pass's rows); each consumer
//   warpgroup takes 64 keys and walks the query tiles: S^T = K q^T and
//   dP^T = V do^T (SS wgmma m64n64), P^T and dS^T in registers from the
//   tile's LSE and dsum, then dV += bf16(P^T) do and dK += bf16(dS^T) q as
//   register-A wgmma with do and q read MN-major through the transpose
//   bit: the transposed key pass of attention_core_bwd_wgmma.cu over a
//   sequence of any length;
// - dq: a CTA per 128 queries; the producer loads q and do of those rows
//   once and keeps a ring of key tiles (64 rows of K and V) full; each
//   consumer warpgroup takes 64 queries and walks the key tiles: S and dP
//   (SS), P and dS in registers from the rows' LSE and dsum, dQ +=
//   bf16(dS) K as register-A wgmma with K read MN-major.
// Seven products where five would do (S and dP in both kernels), in
// exchange for no atomics.  In both walks the exponentials of a tile run
// while its second product is on the tensor cores; in the dq walk the
// tile's dQ product also runs on while the next tile's S and dP are
// issued; the two warpgroups' products fill each other's softmax.  A tile wholly at or past n_valid
// is never loaded; a CTA whose own rows all lie there writes zeros.
#include "flash_wgmma.cuh"

namespace {

using mvt::bf16;
namespace sm = mvt::sm90;
namespace fw = mvt::flashw;

// stats[row] = lse[row] * log2(e) and stats[rows + row] = dsum = sum_d
// do[row, d] * o[row, d] in fp32 for the (B * H * n_pad) rows, D / 8
// lanes a row (16-byte loads), both zero for the rows from N to n_pad
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_dsum_kernel(const bf16* __restrict__ o, const bf16* __restrict__ d_o,
                      const float* __restrict__ lse, float* __restrict__ stats,
                      long long o_image, int o_head, int o_row,
                      long long u_image, int u_head, int u_row, int heads,
                      int n, int n_pad, long long rows) {
  constexpr int kLanes = D / 8;
  const long long w = (static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x) / kLanes;
  const int part = threadIdx.x % kLanes;
  // every lane of the warp reaches the shuffles
  const bool in = w < rows;
  const int bh = static_cast<int>(w / n_pad), row = static_cast<int>(w % n_pad);
  float acc = 0.f;
  if (in && row < n) {
    const int b = bh / heads, h = bh % heads;
    const uint4 ov = *reinterpret_cast<const uint4*>(
        o + b * o_image + static_cast<long long>(h) * o_head +
        static_cast<long long>(row) * o_row + 8 * part);
    const uint4 uv = *reinterpret_cast<const uint4*>(
        d_o + b * u_image + static_cast<long long>(h) * u_head +
        static_cast<long long>(row) * u_row + 8 * part);
    const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* up = reinterpret_cast<const __nv_bfloat162*>(&uv);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 a = __bfloat1622float2(op[e]), c = __bfloat1622float2(up[e]);
      acc += a.x * c.x;
      acc += a.y * c.y;
    }
  }
#pragma unroll
  for (int m = kLanes / 2; m > 0; m >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (in && part == 0) {
    stats[w] = row < n ? lse[static_cast<size_t>(bh) * n + row] * fw::kLog2e
                       : 0.f;
    stats[rows + w] = acc;
  }
}

struct BwdArgs {
  bf16* dq;
  bf16* dk;
  bf16* dv;
  const float* stats;  // the pre-pass's LSE log2(e), then dsum rows
  long long out_image;  // element strides of dq, dk and dv
  int out_head, out_row;
  int heads, n, n_valid, n_pad;
  float scale;
  fw::Axes in_axes;  // q, k and v
  fw::Axes u_axes;   // do
};

// a 64-row accumulator tile (times `mul`) as bf16 pairs into rows r, r + 8
// (those below n) of one head of the (B, N, H, D) outputs
template <int D>
__device__ __forceinline__ void store_tile(const float (&acc)[D / 2],
                                           float mul, bf16* base, int r,
                                           int n, int row_stride, int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r + 8 * i;
    if (row >= n) continue;
    bf16* dst = base + static_cast<size_t>(row) * row_stride;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j + 2 * t) =
          __floats2bfloat162_rn(acc[4 * j + 2 * i] * mul,
                                acc[4 * j + 2 * i + 1] * mul);
  }
}

template <int D>
__global__ void __launch_bounds__(fw::kThreads, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                            const __grid_constant__ CUtensorMap map_k,
                            const __grid_constant__ CUtensorMap map_v,
                            const __grid_constant__ CUtensorMap map_u,
                            const __grid_constant__ CUtensorMap map_lse,
                            const __grid_constant__ CUtensorMap map_dsum,
                            const BwdArgs a) {
  using L = fw::DkdvLayout<D>;
  constexpr int S = fw::kBwdStages, BQ = fw::kBwdTile, kRow = L::kRow;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = fw::aligned_smem(smem_raw);
  unsigned char* Ks = smem;
  unsigned char* Vs = smem + L::kOwn;
  unsigned char* ring = smem + 2 * L::kOwn;
  uint64_t* own_full = reinterpret_cast<uint64_t*>(smem + L::kBarOff);
  uint64_t* full = own_full + 1;
  uint64_t* empty = full + S;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y, b = bh / a.heads, h = bh % a.heads;
  const int k0 = blockIdx.x * fw::kRowsCta;
  // keys at or past n_valid get zero gradients: no query tile to walk
  const int n_qt = k0 < a.n_valid ? (a.n_valid + BQ - 1) / BQ : 0;

  if (tid == 0) {
    sm::mbar_init(own_full, 1);
    for (int s = 0; s < S; ++s) {
      sm::mbar_init(&full[s], 1);
      sm::mbar_init(&empty[s], fw::kConsumerWarps);
    }
    sm::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= fw::kConsumerWarps) {
    sm::setmaxnreg_dec<fw::kProducerRegs>();
    if (warp == fw::kConsumerWarps && lane == 0 && n_qt > 0) {
      sm::mbar_expect_tx(own_full, 2 * L::kOwn);
      fw::load_rows(Ks, &map_k, own_full, a.in_axes, k0, h, b);
      fw::load_rows(Vs, &map_v, own_full, a.in_axes, k0, h, b);
      for (int i = 0; i < n_qt; ++i) {
        const int s = i % S;
        const uint32_t use = i / S;
        if (use > 0) sm::mbar_wait(&empty[s], (use - 1) & 1);
        unsigned char* st = ring + s * L::kStage;
        sm::mbar_expect_tx(&full[s], 2 * L::kTile + 2 * BQ * 4);
        fw::load_rows(st, &map_q, &full[s], a.in_axes, i * BQ, h, b);
        fw::load_rows(st + L::kTile, &map_u, &full[s], a.u_axes, i * BQ, h,
                      b);
        const int row = bh * a.n_pad + i * BQ;
        sm::tma_load_1d(st + 2 * L::kTile, &map_lse, &full[s], row);
        sm::tma_load_1d(st + 2 * L::kTile + BQ * 4, &map_dsum, &full[s],
                        row);
      }
    }
    return;
  }

  // the consumers: warpgroup wg takes keys k0 + 64 wg ... + 63
  sm::setmaxnreg_inc<fw::kConsumerRegs>();
  const int wg = warp >> 2, w = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const float c = a.scale * fw::kLog2e;
  const int ka = k0 + 64 * wg + 16 * w + g;
  const bool va = ka < a.n_valid, vb = ka + 8 < a.n_valid;
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  if (n_qt > 0) {
    const uint64_t dka = sm::rows_desc<D>(Ks, 64 * wg);
    const uint64_t dva = sm::rows_desc<D>(Vs, 64 * wg);
    float s[BQ / 2], dp[BQ / 2];
    uint32_t pa[BQ / 16][4] = {}, da[BQ / 16][4] = {};
    sm::mbar_wait(own_full, 0);
    for (int i = 0; i < n_qt; ++i) {
      const int si = i % S;
      const unsigned char* st = ring + si * L::kStage;
      const float* lse_s = reinterpret_cast<const float*>(st + 2 * L::kTile);
      const float* dsum_s = lse_s + BQ;
      const uint64_t dqt = sm::rows_desc<D>(st, 0);
      const uint64_t dut = sm::rows_desc<D>(st + L::kTile, 0);
      sm::mbar_wait(&full[si], (i / S) & 1);
      // S^T = K q^T, dP^T = V do^T
      fw::issue_pair<D>(s, dka, dqt, dp, dva, dut);
      sm::wgmma_wait<1>();
      sm::fence_regs(s);
      if (i > 0) fw::release(&empty[(i - 1) % S], lane);
      // s[4 j + e]: key ka (e < 2) or ka + 8, query q0 + 8 j + 2 t + (e % 2)
      const int q0 = i * BQ;
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const int qc = 8 * j + 2 * t;
        const float2 lq = *reinterpret_cast<const float2*>(lse_s + qc);
        const float l2[2] = {lq.x, lq.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool v =
              ((e & 2) ? vb : va) && q0 + qc + (e & 1) < a.n_valid;
          const float x = sm::exp2_approx(fmaf(s[4 * j + e], c, -l2[e & 1]));
          s[4 * j + e] = v ? x : 0.f;
        }
      }
      fw::pack_frags(s, pa);
      sm::wgmma_wait<0>();
      sm::fence_regs(dp);
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const float2 dq2 =
            *reinterpret_cast<const float2*>(dsum_s + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[4 * j + e] =
              s[4 * j + e] * (dp[4 * j + e] - ((e & 1) ? dq2.y : dq2.x));
      }
      fw::pack_frags(dp, da);
      // dV += bf16(P^T) do, dK += bf16(dS^T) q: do and q MN-major
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
      // waited here: kept in flight under the next tile's S^T and dP^T,
      // dK and dV, their operands and those two accumulators leave ptxas
      // too few registers, and it serializes every product (C7512)
      sm::wgmma_wait<0>();
      sm::fence_regs(dk);
      sm::fence_regs(dv);
#pragma unroll
      for (int kt = 0; kt < BQ / 16; ++kt) {
        sm::fence_regs(pa[kt]);
        sm::fence_regs(da[kt]);
      }
    }
  }
  const size_t out0 = static_cast<size_t>(b) * a.out_image +
                      static_cast<size_t>(h) * a.out_head;
  store_tile<D>(dk, a.scale, a.dk + out0, ka, a.n, a.out_row, t);
  store_tile<D>(dv, 1.0f, a.dv + out0, ka, a.n, a.out_row, t);
}

template <int D>
__global__ void __launch_bounds__(fw::kThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const __grid_constant__ CUtensorMap map_u,
                          const BwdArgs a) {
  using L = fw::DqLayout<D>;
  constexpr int S = fw::kBwdStages, BK = fw::kBwdTile, kRow = L::kRow;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = fw::aligned_smem(smem_raw);
  unsigned char* Qs = smem;
  unsigned char* Us = smem + L::kOwn;
  unsigned char* ring = smem + 2 * L::kOwn;
  uint64_t* own_full = reinterpret_cast<uint64_t*>(smem + L::kBarOff);
  uint64_t* full = own_full + 1;
  uint64_t* empty = full + S;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y, b = bh / a.heads, h = bh % a.heads;
  const int q0 = blockIdx.x * fw::kRowsCta;
  // query rows at or past n_valid get zero gradients: no key tile to walk
  const int n_kt = q0 < a.n_valid ? (a.n_valid + BK - 1) / BK : 0;

  if (tid == 0) {
    sm::mbar_init(own_full, 1);
    for (int s = 0; s < S; ++s) {
      sm::mbar_init(&full[s], 1);
      sm::mbar_init(&empty[s], fw::kConsumerWarps);
    }
    sm::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= fw::kConsumerWarps) {
    sm::setmaxnreg_dec<fw::kProducerRegs>();
    if (warp == fw::kConsumerWarps && lane == 0 && n_kt > 0) {
      sm::mbar_expect_tx(own_full, 2 * L::kOwn);
      fw::load_rows(Qs, &map_q, own_full, a.in_axes, q0, h, b);
      fw::load_rows(Us, &map_u, own_full, a.u_axes, q0, h, b);
      for (int j = 0; j < n_kt; ++j) {
        const int s = j % S;
        const uint32_t use = j / S;
        if (use > 0) sm::mbar_wait(&empty[s], (use - 1) & 1);
        unsigned char* st = ring + s * L::kStage;
        sm::mbar_expect_tx(&full[s], 2 * L::kTile);
        fw::load_rows(st, &map_k, &full[s], a.in_axes, j * BK, h, b);
        fw::load_rows(st + L::kTile, &map_v, &full[s], a.in_axes, j * BK, h,
                      b);
      }
    }
    return;
  }

  // the consumers: warpgroup wg takes queries q0 + 64 wg ... + 63
  sm::setmaxnreg_inc<fw::kConsumerRegs>();
  const int wg = warp >> 2, w = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const float c = a.scale * fw::kLog2e;
  const int ra = q0 + 64 * wg + 16 * w + g;
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  if (n_kt > 0) {
    // the rows' LSE (times log2(e)) and dsum; rows at or past n_valid
    // take p = 0
    const size_t rows = static_cast<size_t>(gridDim.y) * a.n_pad;
    bool valid[2];
    float l2[2], dsr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = ra + 8 * i;
      valid[i] = row < a.n_valid;
      const size_t si = static_cast<size_t>(bh) * a.n_pad + row;
      l2[i] = valid[i] ? a.stats[si] : 0.f;
      dsr[i] = valid[i] ? a.stats[rows + si] : 0.f;
    }
    const uint64_t dqa = sm::rows_desc<D>(Qs, 64 * wg);
    const uint64_t dua = sm::rows_desc<D>(Us, 64 * wg);
    float s[BK / 2], dp[BK / 2];
    uint32_t da[BK / 16][4] = {};
    sm::mbar_wait(own_full, 0);
    for (int j = 0; j < n_kt; ++j) {
      const int sj = j % S;
      const unsigned char* st = ring + sj * L::kStage;
      const uint64_t dkt = sm::rows_desc<D>(st, 0);
      const uint64_t dvt = sm::rows_desc<D>(st + L::kTile, 0);
      sm::mbar_wait(&full[sj], (j / S) & 1);
      // S = q K^T, dP = do V^T; the last tile's dQ runs on
      fw::issue_pair<D>(s, dqa, dkt, dp, dua, dvt);
      sm::wgmma_wait<1>();
      sm::fence_regs(s);
      sm::fence_regs(dq);
#pragma unroll
      for (int kt = 0; kt < BK / 16; ++kt) sm::fence_regs(da[kt]);
      if (j > 0) fw::release(&empty[(j - 1) % S], lane);
      // s[4 jj + e]: row ra (e < 2) or ra + 8, key j BK + 8 jj + 2 t + (e % 2)
      const int k0 = j * BK;
#pragma unroll
      for (int jj = 0; jj < BK / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool v =
              valid[e >> 1] && k0 + 8 * jj + 2 * t + (e & 1) < a.n_valid;
          const float x =
              sm::exp2_approx(fmaf(s[4 * jj + e], c, -l2[e >> 1]));
          s[4 * jj + e] = v ? x : 0.f;
        }
      sm::wgmma_wait<0>();
      sm::fence_regs(dp);
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        dp[i] = s[i] * (dp[i] - dsr[(i >> 1) & 1]);
      fw::pack_frags(dp, da);
      // dQ += bf16(dS) K: K MN-major
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
  }
  const size_t out0 = static_cast<size_t>(b) * a.out_image +
                      static_cast<size_t>(h) * a.out_head;
  store_tile<D>(dq, a.scale, a.dq + out0, ra, a.n, a.out_row, t);
}

struct Strides {
  long long image;
  int head, row;
};

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* d_o, const float* lse, float* stats,
           const BwdArgs& base, Strides in, Strides os, Strides us, int B,
           cudaStream_t stream) {
  BwdArgs a = base;
  const int n = a.n, H = a.heads;
  const long long rows = static_cast<long long>(B) * H * a.n_pad;
  constexpr int kRowsPerBlock = 256 / (D / 8);
  flash_bwd_dsum_kernel<D><<<static_cast<int>((rows + kRowsPerBlock - 1) /
                                              kRowsPerBlock),
                             256, 0, stream>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(d_o), lse,
      stats, os.image, os.head, os.row, us.image, us.head, us.row, H, n,
      a.n_pad, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  // dk/dv: own rows (K, V) in boxes of the CTA's 128, q and do in tiles
  CUtensorMap mq, mk, mv, mu, ml, md;
  int err = fw::encode_rows<D>(&mk, k, B, H, n, in.image, in.head, in.row,
                               fw::kRowsCta, &a.in_axes);
  if (err == 0)
    err = fw::encode_rows<D>(&mv, v, B, H, n, in.image, in.head, in.row,
                             fw::kRowsCta, &a.in_axes);
  if (err == 0)
    err = fw::encode_rows<D>(&mq, q, B, H, n, in.image, in.head, in.row,
                             fw::kBwdTile, &a.in_axes);
  if (err == 0)
    err = fw::encode_rows<D>(&mu, d_o, B, H, n, us.image, us.head, us.row,
                             fw::kBwdTile, &a.u_axes);
  if (err == 0) err = fw::encode_stats(&ml, stats, rows);
  if (err == 0) err = fw::encode_stats(&md, stats + rows, rows);
  if (err != 0) return err;
  const dim3 grid((n + fw::kRowsCta - 1) / fw::kRowsCta, B * H);
  constexpr int smem_kv = fw::DkdvLayout<D>::kBytes;
  e = cudaFuncSetAttribute(flash_bwd_dkdv_wgmma_kernel<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_kv);
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_dkdv_wgmma_kernel<D><<<grid, fw::kThreads, smem_kv, stream>>>(
      mq, mk, mv, mu, ml, md, a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  // dq: own rows (q, do) in boxes of 128, K and V in tiles
  err = fw::encode_rows<D>(&mq, q, B, H, n, in.image, in.head, in.row,
                           fw::kRowsCta, &a.in_axes);
  if (err == 0)
    err = fw::encode_rows<D>(&mu, d_o, B, H, n, us.image, us.head, us.row,
                             fw::kRowsCta, &a.u_axes);
  if (err == 0)
    err = fw::encode_rows<D>(&mk, k, B, H, n, in.image, in.head, in.row,
                             fw::kBwdTile, &a.in_axes);
  if (err == 0)
    err = fw::encode_rows<D>(&mv, v, B, H, n, in.image, in.head, in.row,
                             fw::kBwdTile, &a.in_axes);
  if (err != 0) return err;
  constexpr int smem_q = fw::DqLayout<D>::kBytes;
  e = cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_q);
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_dq_wgmma_kernel<D><<<grid, fw::kThreads, smem_q, stream>>>(
      mq, mk, mv, mu, a);
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
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, fn, fw::kThreads,
                                                      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int v[7] = {(N + fw::kRowsCta - 1) / fw::kRowsCta, fw::kRowsCta,
                    fw::kBwdTile, fw::kThreads, fw::kBwdStages, smem, ctas};
  for (int i = 0; i < 7; ++i) f[i] = v[i];
  return 0;
}

template <int D>
int figures_d(int N, int* f) {
  int err = figures(reinterpret_cast<const void*>(
                        flash_bwd_dkdv_wgmma_kernel<D>),
                    fw::DkdvLayout<D>::kBytes, N, f);
  if (err == 0)
    err = figures(reinterpret_cast<const void*>(flash_bwd_dq_wgmma_kernel<D>),
                  fw::DqLayout<D>::kBytes, N, f + 7);
  f[14] = 3;
  return err;
}

}  // namespace

// q, k, v share the element strides (in_*); o, do and the outputs dq, dk,
// dv have their own (o_*, u_*, out_*); every row 16-byte aligned with the
// head dimension contiguous; lse is the forward's (B, H, N) fp32 (read by
// plain loads), stats fp32 scratch of 2 B H n_pad values (n_pad = N
// rounded up to 64), 16-byte aligned for its TMA boxes.  *launched
// receives the kernels launched (3).
MVT_EXPORT int mvt_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* d_o, const void* lse, void* stats, void* dq, void* dk,
    void* dv, long long in_image, int in_head, int in_row, long long o_image,
    int o_head, int o_row, long long u_image, int u_head, int u_row,
    long long out_image, int out_head, int out_row, int B, int H, int N,
    int D, int n_valid, float scale, int* launched, void* stream) {
  *launched = 0;
  const int n_pad = (N + fw::kBwdTile - 1) / fw::kBwdTile * fw::kBwdTile;
  if (B <= 0 || H <= 0 || N <= 0 || n_valid <= 0 || n_valid > N ||
      static_cast<long long>(B) * H > 65535 ||
      2LL * B * H * n_pad > 2147483647LL ||
      reinterpret_cast<uintptr_t>(stats) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a;
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.stats = static_cast<const float*>(stats);
  a.out_image = out_image;
  a.out_head = out_head;
  a.out_row = out_row;
  a.heads = H;
  a.n = N;
  a.n_valid = n_valid;
  a.n_pad = n_pad;
  a.scale = scale;
  const Strides in{in_image, in_head, in_row}, os{o_image, o_head, o_row},
      us{u_image, u_head, u_row};
  const float* l = static_cast<const float*>(lse);
  float* st = static_cast<float*>(stats);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (D == 64)
    err = launch<64>(q, k, v, o, d_o, l, st, a, in, os, us, B, s);
  else if (D == 32)
    err = launch<32>(q, k, v, o, d_o, l, st, a, in, os, us, B, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (err == 0) *launched = 3;
  return err;
}

// The launch figures of N tokens at head width D into f[0..14]: the dk/dv
// kernel's seven (as mvt_flash_attention_fwd_plan's), the dq kernel's
// seven, then the kernels a call launches; returns a cudaError_t value.
MVT_EXPORT int mvt_flash_attention_bwd_plan(int N, int D, int* f) {
  if (N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (D == 64) return figures_d<64>(N, f);
  if (D == 32) return figures_d<32>(N, f);
  return static_cast<int>(cudaErrorInvalidValue);
}
