// attention_core_f32_bwd above 256 tokens on Hopper: the per-head part of
// the TPU attention block's backward in a stateless float format, INT8 QAT
// or float32 compute, fp32 throughout, from 257 to 1837 tokens.
//
// Replaces the loop over heads of `_bwd_one_image` with qspec set
// (myrtle_vision_tpu/ops/fused_attention_block.py) wherever the JAX
// package fuses, up to 701 tokens at 6 heads of 64, 1017 at 3 heads of
// 64, 1837 at one head of 32.  No shared buffer grows with N: every
// kernel walks 64-row tiles through its ring, and the scratch (the split
// operands, rt, colpart) and the tensor map are sized from N_pad.  Inputs: qkv (B, N,
// 3C) fp32 in feature order [3][h][d] (the forward's snapped rows), d_o =
// do @ Wp^T (B, N, C) fp32, and the forward's rowmax m and reciprocal
// rowsum rs (B, H, N) fp32 (attention_core_f32_long_wgmma.cu with
// statistics); D = 32 or 64.  The function of
// attention_core_f32_bwd_wgmma.cu, every product the 3-pass split-bf16
// high3 of attention_f32_tiles.cuh:
//   s   = high3(q, k^T) * scale       e  = exp(s - m)     (the saved m)
//   du  = d_o_h * rs                  dp = high3(du, v^T)
//   r   = rowsum(dp * e)              ds = e * (dp - r * rs)
//   dq  = high3(ds, k) * scale        dk = high3(ds^T, q) * scale
//   dv  = high3(e^T, du)
// Outputs: dqkv (B, N, 3C) fp32 in the same column order, and its column
// sums per image, (B, 3C) fp32.
//
// r needs every key of a row before its ds exists, so after a split pass
// three kernels (f32_long_wgmma.cuh holds the shapes), each CTA one
// warpgroup that owns 64 rows of one (image, head), two CTAs an SM:
//   split the bf16 halves of q, k, v and du = d_o * rs, once a call, into
//         a scratch of (8, B, H, N_pad, D) bf16, rows past N zero (the
//         first design split every tile in every CTA that used it, 11
//         times at N = 677);
//   dq    per 64-query tile: q's and du's halves loaded once, then the
//         64-key tiles of K and V walked twice through a ring: the first
//         walk recomputes S = high3(Q, K^T) and dP = high3(du, V^T) and
//         sums r of each row, which it keeps as r * rs in the scratch
//         `rt` (rows of N_pad per image and head); the second recomputes
//         them, forms ds in registers and runs dQ += high3(ds, K);
//   dk/dv per 64-key tile: K's and V's halves loaded once, then a ring of
//         the 64-query chunks of q and du: S^T = high3(K, q^T) and dP^T =
//         high3(V, du^T) with the A and B roles swapped (the short
//         backward's key pass), e^T and ds^T from the saved m and the dq
//         launch's r * rs, then dV += high3(e^T, du) and dK +=
//         high3(ds^T, q);
//   sums  each tile's column sums (written by the two kernels above into
//         `colpart`, (B, N_pad / 64, 3C)) added per image in tile order.
// Each CTA's TMA loads (64-row tiles of the split scratch, hi and lo,
// through one 2-D tensor map) land on full mbarriers: thread 0 issues the
// first, and the last warp to release a stage, right after the product
// that last reads it, refills it while the next tile's products run.  No
// producer warp: beside a warpgroup at two CTAs an SM a fifth warp caps a
// thread at 168 registers (ten warps put three on one of an SM's four
// register files), and these kernels hold two 64 x 64 fp32 tiles, a 64 x D
// accumulator (two in dk / dv) and the next product's split A fragments.
// Each tile's next products are issued as soon as this tile's last product
// is (dQ, or dV and dK, then the next S and dP), so they queue on the
// tensor cores while the other CTA of the SM forms its ds or sums r; the
// two chains of a pair (S and dP, dV and dK) run step by step in turn.
// The recomputed s follows the forward's chain: the same split operands,
// the same pass order (hi.lo, lo.hi, hi.hi over the 16-deep steps of D),
// then the same fp32 scale and expf; only the forward reads q from
// registers.  Nothing clamps e or divides by it.  Every chain's fragments
// are formed before its first product and nothing is written until it
// completes (ptxas's C7513 note), and every sum runs in a fixed order, so
// results are bitwise reproducible and those of the first design.  The
// dQ, dK and dV chains add their 64-row tiles in turn (each tile's three
// passes, then the next tile's), which rounds in another order than the
// short backward's one chain over all keys: fp32 roundoff, under the
// gradients' bars.
// What bounds it: at (8, 677), 6 heads of 64, the algorithm's five
// products of three passes are 3 x 5 x 8 x 6 x 677^2 x 64 x 2 = 42 GFLOP
// of bf16 tensor-core work (0.0427 ms at 989 TFLOP/s); the kernels run
// nine (S and dP twice in the dq kernel and once in dk / dv, then dQ, dV
// and dK), 76 GFLOP at N = 677 and 82 at N_pad = 704.  On one H100 80GB
// HBM3 at 700 W (tools/perf/core_long_bench.py, 3 rounds) a call takes
// 0.2671 ms (device 0.2664: the split pass 0.0227, dq 0.1437, dk / dv
// 0.0968, the sums 0.0032) against 0.4065 for the design that split
// every tile in its threads and 0.4978 for fp32 SDPA's backward; at (8,
// 577) 0.2341.  The ALU work between the products bounds it: e = exp(s -
// m), ds and the bf16 splits, two warps an SMSP: in a scratch copy with
// cycle counters a dq CTA spent about 72k of its 120k cycles there and a
// dk / dv CTA 47k of 82k, the waits on products and loads under 4k each;
// interleaving the chains of a pair changed neither kernel by 2%.  ptxas
// -v: dq 181 registers a thread at D = 64 (146 at 32), dk / dv 251 (204),
// no spills; 102,440 bytes of dynamic shared memory a CTA at D = 64.
#include <cstdint>

#include "f32_long_wgmma.cuh"

namespace {

using namespace mvt::f32attn;
namespace sm = mvt::sm90;
namespace fl = mvt::f32long;

constexpr int kThreads = fl::kBwdThreads;
constexpr int kLaunches = 4;

__device__ __forceinline__ int tiles_of(int n) {
  return (n + kLongTile - 1) / kLongTile;
}

// q's, k's, v's and du's halves of every (image, head), split once a call
template <int D>
__global__ void __launch_bounds__(256)
f32_long_bwd_split_kernel(const float* __restrict__ qkv,
                          const float* __restrict__ d_o,
                          const float* __restrict__ rs,
                          uint4* __restrict__ split, int B, int N,
                          int heads) {
  fl::split_operands<D>(qkv, d_o, rs, split, B, N, heads, fl::kOpQ, 4);
}

// issues the two recomputed products of a 64 x 64 (rows, walked tile)
// block as one group, each a chain of 3 D / 16 products into one
// accumulator, the two chains' steps in turn (chain3_pair): s = A0 B0^T,
// p = A1 B1^T, with A0, A1 the rows' (q, du) and B0, B1 the tile's (K, V),
// or with the roles swapped for the transposed block; a0..b1 are the hi halves' descriptors, the lo halves one split
// half further.  Each chain's first product ignores what its accumulator
// held: no instruction but the chains defines s or p while a product is in
// flight (zeroing them there made ptxas serialise the products, C7515).
template <int D>
__device__ __forceinline__ void issue_two(float (&s)[32], float (&p)[32],
                                          uint64_t a0, uint64_t a1,
                                          uint64_t b0, uint64_t b1,
                                          bool swap) {
  constexpr uint32_t kLo = fl::Tiles<D>::kSub >> 4;  // descriptor units
  sm::wgmma_fence();
  // a: the half of the rows' operand (q or du), bl: that of the tile's;
  // the transposed block issues the tile's operand as A
  chain3_pair<D / 16>(
      [&](int a, int bl, int kk) {
        const uint64_t x = a0 + (a ? kLo : 0) + kk * 2;
        const uint64_t y = b0 + (bl ? kLo : 0) + kk * 2;
        sm::WgmmaSS<64>::template mma<0, 0>(s, swap ? y : x, swap ? x : y,
                                            chain_first(a, bl, kk) ? 0 : 1);
      },
      [&](int a, int bl, int kk) {
        const uint64_t x = a1 + (a ? kLo : 0) + kk * 2;
        const uint64_t y = b1 + (bl ? kLo : 0) + kk * 2;
        sm::WgmmaSS<64>::template mma<0, 0>(p, swap ? y : x, swap ? x : y,
                                            chain_first(a, bl, kk) ? 0 : 1);
      });
  sm::wgmma_commit();
}

// the CTA's column sums of sections [sec0, sec0 + count) of colbuf (4 warps
// x 3 sections x D), its warps in order, into its tile's row of colpart
template <int D>
__device__ __forceinline__ void tile_colsums(const float* colbuf, int sec0,
                                             int count, float* row, int C,
                                             int h) {
  for (int c = threadIdx.x; c < count * D; c += kThreads) {
    const int sec = sec0 + c / D, d = c % D;
    float v = 0.f;
    for (int wi = 0; wi < 4; ++wi)
      v = __fadd_rn(v, colbuf[(wi * 3 + sec) * D + d]);
    row[sec * C + h * D + d] = v;
  }
}

struct Args {
  const float* qkv;  // (B, N, 3C)
  const float* m;    // (B, H, N)
  const float* rs;   // (B, H, N)
  float* dqkv;       // (B, N, 3C)
  float* rt;         // (B, H, N_pad): r * rs of each row, 0 past N
  float* colpart;    // (B, N_pad / 64, 3C)
  int n, heads;
  float scale;
};

// The ring of one kernel's CTA: the stages of `count` tiles in a row,
// each tile two split operands (four 64-row halves of the scratch, arrays
// a0, a0 + 1 and a1, a1 + 1, at the rows row0(it)), loaded on full[s].  A
// stage is refilled by the last of the four warps to release it (a count
// in shared memory), so no warp waits for the others to refill: with
// thread 0 refilling on an empty barrier, its warp waited for the slowest
// (13k of the dq kernel's 120k cycles a CTA at (8, 677)).
template <int D, int S>
struct Ring {
  unsigned char* stages;
  uint64_t* full;
  unsigned* count;
  const CUtensorMap* map;
  int a0, a1, bh, bh_count, np, total;  // total: the tiles it loads

  __device__ __forceinline__ unsigned char* stage(int it) const {
    return stages + (it % S) * fl::BwdLayout<D>::kStage;
  }
  // tile `it` (rows row0) into its stage, which no product reads
  __device__ __forceinline__ void load(int it, int row0) const {
    uint64_t* bar = &full[it % S];
    sm::mbar_expect_tx(bar, fl::BwdLayout<D>::kStage);
    unsigned char* dst = stage(it);
    fl::load_pair<D>(dst, map, bar, a0, bh, bh_count, np, row0);
    fl::load_pair<D>(dst + fl::Tiles<D>::kPair, map, bar, a1, bh, bh_count,
                     np, row0);
  }
  __device__ __forceinline__ void wait(int it) const {
    sm::mbar_wait(&full[it % S], (it / S) & 1);
  }
  // a warp is done with tile it's stage; the last of the four refills it
  // with tile next (rows row0), where there is one
  __device__ __forceinline__ void release(int it, int next, int row0,
                                         int lane) const {
    __syncwarp();
    if (lane == 0 &&
        atomicAdd(&count[it % S], 1u) == fl::kBwdConsumerWarps - 1) {
      count[it % S] = 0;
      if (next < total) load(next, row0);
    }
  }
};

// the shared memory of either kernel: own rows, ring, barriers and the
// ring's release counts, column sums
template <int D>
struct Smem {
  using L = fl::BwdLayout<D>;
  unsigned char* own;
  unsigned char* ring;
  uint64_t* own_full;
  uint64_t* full;
  unsigned* count;
  float* colbuf;

  __device__ __forceinline__ explicit Smem(unsigned char* raw) {
    unsigned char* smem = raw + ((1024 - (sm::smem_u32(raw) & 1023)) & 1023);
    own = smem;
    ring = smem + L::kOwn;
    own_full = reinterpret_cast<uint64_t*>(smem + L::kBarOff);
    full = own_full + 1;
    count = reinterpret_cast<unsigned*>(full + L::kStages);
    colbuf = reinterpret_cast<float*>(smem + L::kColOff);
    if (threadIdx.x == 0) {
      sm::mbar_init(own_full, 1);
      for (int s = 0; s < L::kStages; ++s) {
        sm::mbar_init(&full[s], 1);
        count[s] = 0;
      }
      sm::fence_barrier_init();
    }
    __syncthreads();
  }
};

template <int D>
__global__ void __launch_bounds__(kThreads, fl::kBwdCtasPerSm)
f32_long_dq_kernel(const __grid_constant__ CUtensorMap map, Args a) {
  using L = fl::BwdLayout<D>;
  using T = fl::Tiles<D>;
  constexpr int S = L::kStages, kRow = T::kRow;
  extern __shared__ unsigned char smem_raw[];
  const Smem<D> sh(smem_raw);

  const int tid = threadIdx.x, warp = tid >> 5;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int N = a.n, heads = a.heads, tiles = tiles_of(N);
  const int np = tiles * kLongTile;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int C = heads * D;
  const size_t row_stride = static_cast<size_t>(3) * C;
  const size_t stat0 = static_cast<size_t>(bh) * N;
  const int q0 = kLongTile * blockIdx.x;
  const int ra = q0 + 16 * warp + g, rb = ra + 8;
  const bool va = ra < N, vb = rb < N;
  const float ma = va ? a.m[stat0 + ra] : 0.f;
  const float mb = vb ? a.m[stat0 + rb] : 0.f;

  // K and V of key tile (it mod tiles): the walks' 2 tiles tiles in a row
  const int walked = 2 * tiles;
  const Ring<D, S> ring{sh.ring,
                        sh.full,
                        sh.count,
                        &map,
                        2 * fl::kOpK,
                        2 * fl::kOpV,
                        bh,
                        static_cast<int>(gridDim.y),
                        np,
                        walked};
  // the walks' tile it is key tile it mod tiles
  auto release = [&](int it) {
    ring.release(it, it + S, kLongTile * ((it + S) % tiles), lane);
  };
  if (tid == 0) {
    sm::mbar_expect_tx(sh.own_full, L::kOwn);
    fl::load_pair<D>(sh.own, &map, sh.own_full, 2 * fl::kOpQ, bh, gridDim.y,
                     np, q0);
    fl::load_pair<D>(sh.own + T::kPair, &map, sh.own_full, 2 * fl::kOpDu, bh,
                     gridDim.y, np, q0);
  }
  if (tid == 0)
    for (int it = 0; it < S && it < walked; ++it)
      ring.load(it, kLongTile * (it % tiles));

  const uint64_t dq_h = sm::rows_desc<D>(sh.own, 0);
  const uint64_t du_h = sm::rows_desc<D>(sh.own + T::kPair, 0);
  auto issue = [&](float (&s)[32], float (&p)[32], int it) {
    ring.wait(it);
    const unsigned char* st = ring.stage(it);
    issue_two<D>(s, p, dq_h, du_h, sm::rows_desc<D>(st, 0),
                 sm::rows_desc<D>(st + T::kPair, 0), false);
  };
  // e and dp of element i of the tile from key k0, zero past N in either
  // (s[4 j + e]: row ra (e < 2) or rb, key k0 + 8 j + 2 t + (e % 2)); s and
  // p are only read: an accumulator written by anything but its chain
  // makes ptxas serialise the products (C7515)
  auto e_dp = [&](const float (&s)[32], const float (&p)[32], int k0, int i,
                  float& e, float& dp) {
    const int j = i >> 2, c = i & 3;
    const bool v = k0 + 8 * j + 2 * t + (c & 1) < N && ((c & 2) ? vb : va);
    e = v ? exp_shift(scaled(s[i], a.scale), (c & 2) ? mb : ma) : 0.f;
    dp = v ? p[i] : 0.f;
  };
  sm::mbar_wait(sh.own_full, 0);

  // ---- walk 1: r = rowsum(dp * e), kept as r * rs; each tile's stage is
  // released, and refilled, as soon as its products are done ----
  float r0 = 0.f, r1 = 0.f;
  {
    float s[32], p[32];
    for (int j = 0; j < tiles; ++j) {
      issue(s, p, j);
      sm::wgmma_wait<0>();
      sm::fence_regs(s);
      sm::fence_regs(p);
      release(j);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        float e, dp;
        e_dp(s, p, kLongTile * j, i, e, dp);
        if (i & 2)
          r1 = __fadd_rn(r1, __fmul_rn(dp, e));
        else
          r0 = __fadd_rn(r0, __fmul_rn(dp, e));
      }
    }
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    r0 = __fadd_rn(r0, __shfl_xor_sync(0xffffffffu, r0, o));
    r1 = __fadd_rn(r1, __shfl_xor_sync(0xffffffffu, r1, o));
  }
  const float rt0 = va ? __fmul_rn(r0, a.rs[stat0 + ra]) : 0.f;
  const float rt1 = vb ? __fmul_rn(r1, a.rs[stat0 + rb]) : 0.f;
  if (t == 0) {
    float* rt = a.rt + static_cast<size_t>(bh) * np;
    rt[ra] = rt0;
    rt[rb] = rt1;
  }

  // ---- walk 2: ds = e (dp - r rs), dQ += high3(ds, K); tile j + 1's S
  // and dP are issued right behind tile j's dQ.  dQ is zeroed here, and
  // pinned, so that the zeros are not placed among the products ----
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  sm::fence_regs(dq);
  {
    float s[32], p[32];
    uint32_t ah[4][4], al[4][4];
    issue(s, p, tiles);
    for (int j = 0; j < tiles; ++j) {
      const int it = tiles + j;
      if (j > 0) {
        // the last dQ, issued before this tile's S and dP, is done with
        // its K tile
        sm::wgmma_wait<1>();
        sm::fence_regs(dq);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          sm::fence_regs(ah[ks]);
          sm::fence_regs(al[ks]);
        }
        release(it - 1);
      }
      sm::wgmma_wait<0>();
      sm::fence_regs(s);
      sm::fence_regs(p);
      // ds split into the A fragments of the tile's 16-key steps
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
        for (int wd = 0; wd < 4; ++wd) {
          const int i = 8 * ks + 2 * wd;
          const float rt = (wd & 1) ? rt1 : rt0;
          float e0, d0, e1, d1;
          e_dp(s, p, kLongTile * j, i, e0, d0);
          e_dp(s, p, kLongTile * j, i + 1, e1, d1);
          sm::split_bf16x2(__fmul_rn(e0, __fsub_rn(d0, rt)),
                           __fmul_rn(e1, __fsub_rn(d1, rt)), ah[ks][wd],
                           al[ks][wd]);
        }
      }
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        sm::fence_regs(ah[ks]);
        sm::fence_regs(al[ks]);
      }
      // K read MN-major (the transpose bit), 16 keys a step
      const unsigned char* st = ring.stage(it);
      const uint64_t dk_h = sm::rows_desc<D>(st, 0);
      const uint64_t dk_l = sm::rows_desc<D>(st + T::kSub, 0);
      sm::wgmma_fence();
      chain3<4>([&](int x, int bl, int ks) {
        sm::WgmmaRS<D>::template mma<1>(
            dq, x ? al[ks] : ah[ks],
            sm::desc_add(bl ? dk_l : dk_h, ks * 16 * kRow), 1);
      });
      sm::wgmma_commit();
      if (j + 1 < tiles) issue(s, p, it + 1);
    }
    sm::wgmma_wait<0>();
    sm::fence_regs(dq);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      sm::fence_regs(ah[ks]);
      sm::fence_regs(al[ks]);
    }
  }

  float col[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) col[i] = 0.f;
  float* out = a.dqkv + static_cast<size_t>(b) * N * row_stride;
  store_rows<D>(dq, a.scale, out + static_cast<size_t>(ra) * row_stride + h * D,
                va, vb, row_stride, t, col);
  sm::warp_colsums<D>(col, sh.colbuf, warp, 0, g, t);
  __syncthreads();
  tile_colsums<D>(sh.colbuf, 0, 1,
                  a.colpart + (static_cast<size_t>(b) * tiles + blockIdx.x) *
                                  row_stride,
                  C, h);
}

template <int D>
__global__ void __launch_bounds__(kThreads, fl::kBwdCtasPerSm)
f32_long_dkdv_kernel(const __grid_constant__ CUtensorMap map, Args a) {
  using L = fl::BwdLayout<D>;
  using T = fl::Tiles<D>;
  constexpr int S = L::kStages, kRow = T::kRow;
  extern __shared__ unsigned char smem_raw[];
  const Smem<D> sh(smem_raw);

  const int tid = threadIdx.x, warp = tid >> 5;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int N = a.n, heads = a.heads, tiles = tiles_of(N);
  const int np = tiles * kLongTile;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int C = heads * D;
  const size_t row_stride = static_cast<size_t>(3) * C;
  const size_t stat0 = static_cast<size_t>(bh) * N;
  const float* rt = a.rt + static_cast<size_t>(bh) * np;
  const int k0 = kLongTile * blockIdx.x;
  const int ka = k0 + 16 * warp + g;
  const bool va = ka < N, vb = ka + 8 < N;

  // q and du of query chunk it
  const Ring<D, S> ring{sh.ring,
                        sh.full,
                        sh.count,
                        &map,
                        2 * fl::kOpQ,
                        2 * fl::kOpDu,
                        bh,
                        static_cast<int>(gridDim.y),
                        np,
                        tiles};
  if (tid == 0) {
    sm::mbar_expect_tx(sh.own_full, L::kOwn);
    fl::load_pair<D>(sh.own, &map, sh.own_full, 2 * fl::kOpK, bh, gridDim.y,
                     np, k0);
    fl::load_pair<D>(sh.own + T::kPair, &map, sh.own_full, 2 * fl::kOpV, bh,
                     gridDim.y, np, k0);
  }
  if (tid == 0)
    for (int it = 0; it < S && it < tiles; ++it)
      ring.load(it, kLongTile * it);

  const uint64_t dk_h = sm::rows_desc<D>(sh.own, 0);
  const uint64_t dv_h = sm::rows_desc<D>(sh.own + T::kPair, 0);
  auto issue = [&](float (&s)[32], float (&p)[32], int qt) {
    ring.wait(qt);
    const unsigned char* st = ring.stage(qt);
    issue_two<D>(s, p, sm::rows_desc<D>(st, 0),
                 sm::rows_desc<D>(st + T::kPair, 0), dk_h, dv_h, true);
  };
  sm::mbar_wait(sh.own_full, 0);

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  sm::fence_regs(dk);
  sm::fence_regs(dv);
  float s[32], p[32];
  uint32_t eh[4][4], el[4][4], dh[4][4], dl[4][4];
  issue(s, p, 0);
  for (int qt = 0; qt < tiles; ++qt) {
    const int qc = kLongTile * qt;
    if (qt > 0) {
      // the last chunk's dV and dK, issued before this chunk's S^T and
      // dP^T, are done with its q and du
      sm::wgmma_wait<1>();
      sm::fence_regs(dk);
      sm::fence_regs(dv);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        sm::fence_regs(eh[ks]);
        sm::fence_regs(el[ks]);
        sm::fence_regs(dh[ks]);
        sm::fence_regs(dl[ks]);
      }
      ring.release(qt - 1, qt - 1 + S, kLongTile * (qt - 1 + S), lane);
    }
    // S^T = K q^T and dP^T = V du^T: s[4 j + e] is key ka (e < 2) or ka +
    // 8, query qc + 8 j + 2 t + (e % 2)
    sm::wgmma_wait<0>();
    sm::fence_regs(s);
    sm::fence_regs(p);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      float ev[8], ds[8];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int q = qc + 16 * ks + 8 * half + 2 * t;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 8 * ks + 4 * half + e;
          const int qe = q + (e & 1);
          const bool v = qe < N && ((e & 2) ? vb : va);
          const float x =
              v ? exp_shift(scaled(s[i], a.scale), a.m[stat0 + qe]) : 0.f;
          ev[4 * half + e] = x;
          ds[4 * half + e] = v ? __fmul_rn(x, __fsub_rn(p[i], rt[qe])) : 0.f;
        }
      }
#pragma unroll
      for (int wd = 0; wd < 4; ++wd) {
        sm::split_bf16x2(ev[2 * wd], ev[2 * wd + 1], eh[ks][wd], el[ks][wd]);
        sm::split_bf16x2(ds[2 * wd], ds[2 * wd + 1], dh[ks][wd], dl[ks][wd]);
      }
    }
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      sm::fence_regs(eh[ks]);
      sm::fence_regs(el[ks]);
      sm::fence_regs(dh[ks]);
      sm::fence_regs(dl[ks]);
    }
    // du and q read MN-major (the transpose bit), 16 queries a step
    const unsigned char* st = ring.stage(qt);
    const uint64_t dq_h = sm::rows_desc<D>(st, 0);
    const uint64_t dq_l = sm::rows_desc<D>(st + T::kSub, 0);
    const uint64_t du_h = sm::rows_desc<D>(st + T::kPair, 0);
    const uint64_t du_l = sm::rows_desc<D>(st + T::kPair + T::kSub, 0);
    sm::wgmma_fence();
    chain3_pair<4>(
        [&](int x, int bl, int ks) {
          sm::WgmmaRS<D>::template mma<1>(
              dv, x ? el[ks] : eh[ks],
              sm::desc_add(bl ? du_l : du_h, ks * 16 * kRow), 1);
        },
        [&](int x, int bl, int ks) {
          sm::WgmmaRS<D>::template mma<1>(
              dk, x ? dl[ks] : dh[ks],
              sm::desc_add(bl ? dq_l : dq_h, ks * 16 * kRow), 1);
        });
    sm::wgmma_commit();
    if (qt + 1 < tiles) issue(s, p, qt + 1);
  }
  sm::wgmma_wait<0>();
  sm::fence_regs(dk);
  sm::fence_regs(dv);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    sm::fence_regs(eh[ks]);
    sm::fence_regs(el[ks]);
    sm::fence_regs(dh[ks]);
    sm::fence_regs(dl[ks]);
  }

  float colk[D / 4], colv[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) colk[i] = colv[i] = 0.f;
  float* row = a.dqkv + (static_cast<size_t>(b) * N + ka) * row_stride;
  store_rows<D>(dk, a.scale, row + C + h * D, va, vb, row_stride, t, colk);
  store_rows<D>(dv, 1.0f, row + 2 * C + h * D, va, vb, row_stride, t, colv);
  sm::warp_colsums<D>(colk, sh.colbuf, warp, 1, g, t);
  sm::warp_colsums<D>(colv, sh.colbuf, warp, 2, g, t);
  __syncthreads();
  tile_colsums<D>(sh.colbuf, 1, 2,
                  a.colpart + (static_cast<size_t>(b) * tiles + blockIdx.x) *
                                  row_stride,
                  C, h);
}

// dbias[b, c] = the sum of colpart[b, :, c], the tiles in order
__global__ void f32_long_colsum_kernel(const float* __restrict__ colpart,
                                       float* __restrict__ dbias, int tiles,
                                       int cols, int images) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= images * cols) return;
  const int b = i / cols, c = i % cols;
  float s = 0.f;
  for (int k = 0; k < tiles; ++k)
    s = __fadd_rn(s, colpart[(static_cast<size_t>(b) * tiles + k) * cols + c]);
  dbias[i] = s;
}

template <int D>
int set_smem() {
  static unsigned dq = 0, dkdv = 0;
  const int e = fl::allow_smem_once(
      reinterpret_cast<const void*>(f32_long_dq_kernel<D>), &dq);
  return e != 0 ? e
                : fl::allow_smem_once(
                      reinterpret_cast<const void*>(f32_long_dkdv_kernel<D>),
                      &dkdv);
}

template <int D>
int launch(const Args& a, const float* d_o, float* dbias, void* split,
           int B, int* launched, cudaStream_t stream) {
  CUtensorMap map;
  int err = fl::encode_split<D>(&map, split, 8, B, a.heads, a.n);
  if (err == 0) err = set_smem<D>();
  if (err != 0) return err;
  f32_long_bwd_split_kernel<D>
      <<<fl::split_blocks(B, a.n, a.heads, D, 4), 256, 0, stream>>>(
          a.qkv, d_o, a.rs, static_cast<uint4*>(split), B, a.n, a.heads);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  *launched = 1;
  const int smem = fl::BwdLayout<D>::kBytes;
  const int tiles = (a.n + kLongTile - 1) / kLongTile;
  const dim3 grid(tiles, B * a.heads);
  f32_long_dq_kernel<D><<<grid, kThreads, smem, stream>>>(map, a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  *launched = 2;
  f32_long_dkdv_kernel<D><<<grid, kThreads, smem, stream>>>(map, a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  *launched = 3;
  const int cols = 3 * a.heads * D;
  f32_long_colsum_kernel<<<(B * cols + 255) / 256, 256, 0, stream>>>(
      a.colpart, dbias, tiles, cols, B);
  e = cudaGetLastError();
  if (e == cudaSuccess) *launched = kLaunches;
  return static_cast<int>(e);
}

// the figures of one backward kernel: key or query tiles per (image, head),
// the CTA's rows, the walked tile's rows, threads, stages, dynamic shared
// memory and the CTAs an SM that the runtime fits
int figures(const void* fn, int smem, int stages, int N, int* f) {
  int ctas = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &ctas, fn, kThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int v[7] = {(N + kLongTile - 1) / kLongTile, kLongTile, kLongTile,
                    kThreads, stages, smem, ctas};
  for (int i = 0; i < 7; ++i) f[i] = v[i];
  return 0;
}

template <int D>
int figures_d(int N, int* f) {
  using L = fl::BwdLayout<D>;
  int err = set_smem<D>();
  if (err == 0)
    err = figures(reinterpret_cast<const void*>(f32_long_dq_kernel<D>),
                  L::kBytes, L::kStages, N, f);
  if (err == 0)
    err = figures(reinterpret_cast<const void*>(f32_long_dkdv_kernel<D>),
                  L::kBytes, L::kStages, N, f + 7);
  f[14] = kLaunches;
  return err;
}

}  // namespace

// the dq and the dk / dv kernel's figures, then the kernels a call
// launches, into f[0..14] (mvt_attention_core_f32_long_plan)
int f32_long_bwd_figures(int N, int D, int* f) {
  if (D == 64) return figures_d<64>(N, f);
  if (D == 32) return figures_d<32>(N, f);
  return static_cast<int>(cudaErrorInvalidValue);
}

MVT_EXPORT int mvt_attention_core_f32_bwd_long_max_n() { return kLongMaxN; }

// qkv (B, N, 3C), d_o (B, N, C), m and rs (B, heads, N) fp32 -> dqkv (B, N,
// 3C) fp32 and dbias (B, 3C) fp32, the column sums of each image's dqkv;
// scratch split (8, B, heads, N_pad, D) bf16 (q's, k's, v's and du's
// halves), rt (B, heads, N_pad) and colpart (B, N_pad / 64, 3C) fp32, N_pad
// = N rounded up to 64; D = C / heads of 32 or 64, 1 <= N <=
// mvt_attention_core_f32_bwd_long_max_n(); qkv, d_o and split 16-byte
// aligned.  *launched: the kernels launched (4 on success).
MVT_EXPORT int mvt_attention_core_f32_bwd_long(
    const void* qkv, const void* d_o, const void* m, const void* rs,
    void* dqkv, void* dbias, void* split, void* rt, void* colpart, int B,
    int N, int heads, int D, float scale, int* launched, void* stream) {
  *launched = 0;
  if (B <= 0 || heads <= 0 || N <= 0 || N > kLongMaxN ||
      static_cast<long long>(B) * heads > 65535 || split == nullptr ||
      rt == nullptr || colpart == nullptr ||
      reinterpret_cast<uintptr_t>(qkv) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(d_o) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(split) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(qkv), static_cast<const float*>(m),
               static_cast<const float*>(rs),  static_cast<float*>(dqkv),
               static_cast<float*>(rt),        static_cast<float*>(colpart),
               N,                              heads,
               scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch<64>(a, static_cast<const float*>(d_o),
                      static_cast<float*>(dbias), split, B, launched, s);
  if (D == 32)
    return launch<32>(a, static_cast<const float*>(d_o),
                      static_cast<float*>(dbias), split, B, launched, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
