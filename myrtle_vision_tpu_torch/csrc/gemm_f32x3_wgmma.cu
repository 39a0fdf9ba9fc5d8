// gemm_f32x3_epilogue on Hopper: the fp32 products of the float-format and
// INT8 QAT block halves, forward and backward, out[M, N] = epilogue(A[M, K]
// @ B[K, N] (+ bias[N])).
//
// The products inside the TPU block kernels with qspec set (a float format,
// or "int8", the two-pass INT8 QAT variants `fused_attention_block_i8` and
// `fused_mlp_block_i8`)
// (myrtle_vision_tpu/ops/fused_attention_block.py `_qkv_rows`, the output
// projection of `_fwd_kernel` and the products of `_bwd_one_image`;
// myrtle_vision_tpu/ops/fused_mlp.py `fc1`, `fc2` and `_bwd_one_image`):
// fp32 operands through the 3-pass bf16 product of `dot_high3`
// (myrtle_vision_tpu/ops/high_precision.py).  Each operand, the incoming
// gradient included, is split as it is staged, x = hi + lo with hi =
// bf16(x), lo = bf16(x - hi); the three products ah.bh, ah.bl and al.bh
// each run over the whole K (or the whole K chunk) on the tensor cores
// (wgmma, bf16 in, fp32 accumulators: every term is exact, only the fp32
// sum order is the hardware's), each into its own accumulator, and are
// added as (P1 + P2) + P3, the order of `dot_high3`.  Epilogues, with the
// snap policies of fake_quant.cuh (a float format's qspec = (exp_bits,
// man_bits, all_sites), or PyTorchINT8's frozen observer sites, site0 and
// site1 the epilogue's first and second; each snap the identity under the
// other policy), each rounding in the plain version's order:
//   0  site0(snap_all(P + bias))                             (QKV)
//   1  h = site0(snap_all(P + bias)), site1(snap(snap_all(GELU(h))))
//      (fc1: fc1 act_out, GELU act_out, fc2 act_in; the polynomial erf,
//      exact divide)
//   2  site1(snap_all(residual + site0(snap_all(P + bias))))  (output
//      projection and fc2: act_out, then the residual add's functional site)
//   3  P, no bias, no snap                 (d_o, dxn, dg and the weight
//      gradients; with split K, one partial product per K chunk)
//   4  h = site0(snap_all(P + bias)): site1(snap(snap_all(GELU(h)))) out and
//      GELU'(h) into `aux`     (the backward's fc1 recompute, one erf)
//   5  P * aux, and the fp32 column sums of that per 128-row tile into
//      `colpart`               (dh = dg * GELU'(h), db1)
// Layouts are read in place: A is row-major (M, K), or column-major -- the
// (K, M) activation as it is stored, for a weight gradient dW^T = dY^T X --
// and B is read as the (N, K) torch (out, in) weight row-major (the forward
// epilogues 0, 1, 2, 4: the (in, out) view of the weight) or row-major (K,
// N) (3 and 5: the weight as it is stored, for dX = dY W^T, and an
// activation for a weight gradient); no transposed copy is ever made.
//
// What bounds it: the three passes triple the bf16 tensor-core work of the
// FP32 format's products, 3 x 2MNK operations against 4 (MK + NK + MN)
// bytes, so at ViT-S/16 shapes (M = 50432, K and N in {384, 1152, 1536})
// the bound is the operations.  On the card the first limit is the
// traffic from L2 into the SMs: every output tile reads its fp32 rows of
// A and columns of B, (1 / BN + 1 / BM) 4 K bytes an output, twice what
// bf16 operands cost, so the tile is as wide as the registers allow.  The
// second is the GELU epilogues' long arithmetic, which the tensor cores
// wait for.  The WMMA design it replaced reached 75-134
// TFLOP/s.
//
// Design.  The output is cut into 128 x 128 tiles, 192 x 64 for the two
// GELU epilogues (and a weight gradient's K into chunks, `gemm_f32x3_plan`
// in ops/_kernels.py); one persistent CTA an SM walks them, tile c,
// c + grid, ...  A producer warpgroup and a consumer warpgroup for each 64
// rows of the tile.  The producer warp issues TMA loads of the fp32
// operands, 32 deep (one 128-byte swizzled row), into a four-stage ring on
// mbarriers, running on from one output tile into the next.  The
// warpgroup's three other warps split each stage's B tile (BN x 32) into
// bf16 hi and lo tiles in a ring of their own, always in the MN-major
// 128-byte swizzle that the wgmma descriptor reads with its transpose bit
// (a K-major (N, K) weight is transposed as it is split; a quarter warp's
// 16-byte loads and stores meet no bank conflict), then fence the async
// proxy before they signal the tile.  Each consumer warpgroup reads its 64
// rows of the fp32 A stage straight into the register A fragment of
// m64k16, splits it there (bit for bit the WMMA design's split4), and runs
// wgmma m64nBNk16 with A in registers: ah.bh, ah.bl and al.bh into three
// accumulators.  A alone needs no bf16 tile, so only B's split goes
// through shared memory.  The three accumulators of a 64 x 128 warpgroup
// tile take 192 registers, so the producer warpgroup gives its registers
// away (setmaxnreg: 40 a thread; the consumers 232, or 152 with the GELU
// tiles' three warpgroups of 64 x 64, whose extra warps hide the GELU's
// latency).  Each 16-deep step's fragments and descriptors are pinned
// before its products are issued, and the products completed (wait 0)
// before the next step writes registers: a register written while a
// product that reads registers is in flight makes ptxas serialise every
// product.  The warpgroups take turns on the tensor cores.  The epilogue
// works on the accumulator fragments in registers, two adjacent columns of
// a row a thread; the INT8 sites' rows are read after the main loop.  The
// column sums of epilogue 5 are reduced across the tile's 128 rows through
// shared memory in a fixed order, without atomics; a weight gradient's
// partial products are summed in order by colsum_rows, so every result is
// the same run to run.  Tensor maps are encoded on the host for each
// launch (sm90.cuh) and passed as __grid_constant__ parameters.
//
// ptxas -v (sm_90a, nvcc 12.9): 168 registers a thread at launch (the
// setmaxnreg counts above after it); four of the eleven instantiations
// spill 8 bytes; 201,856 bytes of dynamic shared memory (168,064 for the
// GELU tiles), so one CTA an SM.
#include "fake_quant.cuh"
#include "sm90.cuh"

namespace {

namespace sm = mvt::sm90;

constexpr int BK = 32;             // BK fp32: one 128-byte row
constexpr int kStages = 4;
constexpr int kSplitters = 96;     // the producer warpgroup's warps 1-3
constexpr int kProducerRegs = 40;  // registers a producer-warpgroup thread keeps
constexpr int kBox = 32 * BK * 4;           // an MN-major box, 32 x 32 fp32
constexpr int kChunk = BK * 64 * 2;         // a 64-wide MN-major bf16 chunk

enum Epilogue {
  kBiasSnap = 0,
  kBiasSnapGeluSnap = 1,
  kBiasSnapResidualSnap = 2,
  kF32 = 3,
  kBiasSnapGeluSnapGrad = 4,
  kMulAux = 5,
};

// The output tile: 128 x 128, but 192 x 64 for the GELU epilogues, whose
// long per-element arithmetic needs registers to interleave beside the
// accumulators and more warps to hide its latency: three consumer
// warpgroups of 64 x 64 instead of two of 64 x 128
__host__ __device__ constexpr bool gelu_epi(int epi) {
  return epi == kBiasSnapGeluSnap || epi == kBiasSnapGeluSnapGrad;
}
__host__ __device__ constexpr int bm_of(int epi) {
  return gelu_epi(epi) ? 192 : 128;
}
__host__ __device__ constexpr int bn_of(int epi) {
  return gelu_epi(epi) ? 64 : 128;
}

// the layout of a BM x BN tile: a consumer warpgroup for each 64 rows and
// the producer warpgroup (the producer warp and the splitters), the
// consumers' share of the registers, and in shared memory the fp32 A and
// B of a stage, the bf16 hi and lo tiles of B; the fp32 ring, the split
// ring, four barriers a stage and the column sums' buffer (a row a
// consumer warp)
template <int kBM, int kBN>
struct Cfg {
  static constexpr int BM = kBM, BN = kBN;
  static constexpr int kConsumers = 2 * BM;
  static constexpr int kProducerWarp = kConsumers / 32;
  static constexpr int kThreads = kConsumers + 128;
  static constexpr int kConsumerRegs =
      (65536 - 128 * kProducerRegs) / kConsumers / 8 * 8 > 232
          ? 232
          : (65536 - 128 * kProducerRegs) / kConsumers / 8 * 8;
  static constexpr int kTileA = BM * BK * 4;
  static constexpr int kTileB = BN * BK * 4;
  static constexpr int kStageBytes = kTileA + kTileB;
  static constexpr int kHalf = (BN / 64) * kChunk;
  static constexpr int kSplitBytes = 2 * kHalf;
  static constexpr size_t kSmemBytes =
      1024 + kStages * (kStageBytes + kSplitBytes) +
      4 * kStages * sizeof(uint64_t) + sizeof(float) * (kConsumers / 32) * BN;
};

template <int kEpi>
using CfgOf = Cfg<bm_of(kEpi), bn_of(kEpi)>;

// byte offset of 16-byte chunk c of row r in a tile swizzled in 128-byte
// rows (the TMA and wgmma 128-byte swizzle: chunks XOR the row mod 8)
__device__ __forceinline__ int swz(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// hi = bf16(x), lo = bf16(x - hi) of a pair, as packed words (x in the low
// half): the arithmetic of `dot_high3`'s `_split`
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const __nv_bfloat162 l = __floats2bfloat162_rn(
      __fsub_rn(x, __low2float(h)), __fsub_rn(y, __high2float(h)));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// The m64k16 A fragment of 16-deep step kk from the fp32 stage, split:
// thread (warp w of the warpgroup, lane 4 g + t) holds rows r and r + 8
// (r = 16 w + g of the warpgroup's 64) at columns 2 t, 2 t + 1 and 2 t + 8,
// 2 t + 9 of the step.  K-major A: 64 rows of 32 fp32; MN-major A: two
// 32-row-wide boxes of 32 K rows.
template <bool kAMn>
__device__ __forceinline__ void load_a(const unsigned char* a_s, int r,
                                       int kk, int t, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  float v[8];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int row = r + 8 * (q & 1);
    const int k = 16 * kk + 2 * t + 8 * (q >> 1);
    if (kAMn) {
      const unsigned char* box = a_s + (row >> 5) * kBox;
      const int m = row & 31;
#pragma unroll
      for (int e = 0; e < 2; ++e)
        v[2 * q + e] = *reinterpret_cast<const float*>(
            box + swz(k + e, m >> 2) + (m & 3) * 4);
    } else {
      const float2 p = *reinterpret_cast<const float2*>(
          a_s + swz(row, k >> 2) + (k & 3) * 4);
      v[2 * q] = p.x;
      v[2 * q + 1] = p.y;
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) split2(v[2 * q], v[2 * q + 1], hi[q], lo[q]);
}

// 16-byte chunk `ng` (columns 8 ng .. 8 ng + 7) of K row k of a bf16
// MN-major tile: 64-wide chunks, each 32 rows of 128 bytes
__device__ __forceinline__ int split_at(int k, int ng) {
  return (ng >> 3) * kChunk + swz(k, ng & 7);
}

// The splitters' share of one stage: B's BN x 32 fp32 into the bf16 hi
// and lo tiles, MN-major.  i is the splitter's index, 0-95.  Eight
// neighbouring threads (a quarter warp, whose 16-byte accesses share a
// cycle) read and write eight distinct 16-byte bank groups.
template <int BN, bool kBMn>
__device__ __forceinline__ void split_b(const unsigned char* b_s,
                                        unsigned char* hi_s, int i) {
  unsigned char* lo_s = hi_s + (BN / 64) * kChunk;
  if (kBMn) {
    // (K, N) stored: boxes of 32 columns; an item is 8 columns of
    // one K row, its two 16-byte halves read in the order that keeps a
    // quarter warp's boxes on distinct banks
    for (int item = i; item < BK * (BN / 8); item += kSplitters) {
      const int k = item / (BN / 8), ng = item % (BN / 8);
      const unsigned char* box = b_s + (ng >> 2) * kBox;
      const int odd = (ng >> 2) & 1;
      const float4 xa = *reinterpret_cast<const float4*>(
          box + swz(k, 2 * (ng & 3) + odd));
      const float4 xb = *reinterpret_cast<const float4*>(
          box + swz(k, 2 * (ng & 3) + 1 - odd));
      const float4 x0 = odd ? xb : xa, x1 = odd ? xa : xb;
      uint4 h, l;
      split2(x0.x, x0.y, h.x, l.x);
      split2(x0.z, x0.w, h.y, l.y);
      split2(x1.x, x1.y, h.z, l.z);
      split2(x1.z, x1.w, h.w, l.w);
      *reinterpret_cast<uint4*>(hi_s + split_at(k, ng)) = h;
      *reinterpret_cast<uint4*>(lo_s + split_at(k, ng)) = l;
    }
  } else {
    // (N, K) stored: BN rows of 32 K; an item is 8 rows (columns of the
    // output) by 2 K, written as one 16-byte chunk per K row
    for (int item = i; item < (BK / 2) * (BN / 8); item += kSplitters) {
      const int kh = item & 15;
      const int ng = (kh >> 2) ^ (item >> 4);
      float2 x[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        x[j] = *reinterpret_cast<const float2*>(
            b_s + swz(8 * ng + j, kh >> 1) + (kh & 1) * 8);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        uint32_t h[4], l[4];
#pragma unroll
        for (int p = 0; p < 4; ++p)
          split2(e ? x[2 * p].y : x[2 * p].x,
                 e ? x[2 * p + 1].y : x[2 * p + 1].x, h[p], l[p]);
        const int k = 2 * kh + e;
        *reinterpret_cast<uint4*>(hi_s + split_at(k, ng)) =
            make_uint4(h[0], h[1], h[2], h[3]);
        *reinterpret_cast<uint4*>(lo_s + split_at(k, ng)) =
            make_uint4(l[0], l[1], l[2], l[3]);
      }
    }
  }
}

// the tile's place: column tile x, row tile y, K chunk z of tile index
// z tiles_n tiles_m + y tiles_n + x, and its K steps
template <int BM, int BN>
struct Tile {
  int n0, tile_m, m0, split, k_begin, k_tiles;
  __device__ Tile(int tile, int tiles_n, int tiles_m, int K, int k_split) {
    n0 = (tile % tiles_n) * BN;
    tile_m = tile / tiles_n % tiles_m;
    m0 = tile_m * BM;
    split = tile / (tiles_n * tiles_m);
    k_begin = split * k_split;
    k_tiles = (min(K, k_begin + k_split) - k_begin + BK - 1) / BK;
  }
};

// kAMn: A stored (K, M); kBMn: B stored (K, N).
template <bool kAMn, bool kBMn, int kEpi, class Snaps>
__global__ void __launch_bounds__(CfgOf<kEpi>::kThreads, 1)
gemm_f32x3_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                        const __grid_constant__ CUtensorMap map_b,
                        const float* __restrict__ bias,
                        const float* __restrict__ residual,
                        float* __restrict__ out, float* __restrict__ aux,
                        float* __restrict__ colpart, int M, int N, int K,
                        int k_split, Snaps policy) {
  using C = CfgOf<kEpi>;
  constexpr int BM = C::BM, BN = C::BN;
  constexpr int kConsumers = C::kConsumers, kTileA = C::kTileA;
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the rings to it
  unsigned char* smem =
      smem_raw + ((1024 - (sm::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* split_ring = smem + kStages * C::kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(split_ring +
                                               kStages * C::kSplitBytes);
  uint64_t* empty = full + kStages;
  uint64_t* split_full = empty + kStages;
  uint64_t* split_empty = split_full + kStages;
  float* colbuf = reinterpret_cast<float*>(split_empty + kStages);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int tiles_n = (N + BN - 1) / BN, tiles_m = (M + BM - 1) / BM;
  const int tiles = tiles_n * tiles_m * ((K + k_split - 1) / k_split);

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      sm::mbar_init(&full[s], 1);
      // the fp32 stage is read by the consumer warps (A) and the
      // splitter warps (B)
      sm::mbar_init(&empty[s], kConsumers / 32 + kSplitters / 32);
      sm::mbar_init(&split_full[s], kSplitters / 32);
      sm::mbar_init(&split_empty[s], kConsumers / 32);
    }
    sm::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= C::kProducerWarp) {
    // the producer warpgroup gives registers to the consumers (inside its
    // own branch, so that ptxas sees where each count holds)
    sm::setmaxnreg_dec<kProducerRegs>();
    int s = 0, phase = 0;
    if (warp == C::kProducerWarp) {
      // the producer: one thread keeps the fp32 ring full
      if (lane != 0) return;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const Tile<BM, BN> tl(tile, tiles_n, tiles_m, K, k_split);
        for (int kt = 0; kt < tl.k_tiles; ++kt) {
          sm::mbar_wait(&empty[s], phase ^ 1);
          unsigned char* a_s = smem + s * C::kStageBytes;
          unsigned char* b_s = a_s + kTileA;
          const int k0 = tl.k_begin + kt * BK;
          sm::mbar_expect_tx(&full[s], C::kStageBytes);
          if (kAMn) {
#pragma unroll
            for (int j = 0; j < BM / 32; ++j)
              sm::tma_load_2d(a_s + j * kBox, &map_a, &full[s],
                              tl.m0 + 32 * j, k0);
          } else {
            sm::tma_load_2d(a_s, &map_a, &full[s], k0, tl.m0);
          }
          if (kBMn) {
#pragma unroll
            for (int j = 0; j < BN / 32; ++j)
              sm::tma_load_2d(b_s + j * kBox, &map_b, &full[s],
                              tl.n0 + 32 * j, k0);
          } else {
            sm::tma_load_2d(b_s, &map_b, &full[s], k0, tl.n0);
          }
          if (++s == kStages) {
            s = 0;
            phase ^= 1;
          }
        }
      }
      return;
    }
    // the splitters: B of each stage into the split ring
    const int i = tid - (kConsumers + 32);
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const Tile<BM, BN> tl(tile, tiles_n, tiles_m, K, k_split);
      for (int kt = 0; kt < tl.k_tiles; ++kt) {
        sm::mbar_wait(&full[s], phase);
        sm::mbar_wait(&split_empty[s], phase ^ 1);
        split_b<BN, kBMn>(smem + s * C::kStageBytes + kTileA,
                          split_ring + s * C::kSplitBytes, i);
        // the wgmma reads these tiles through the async proxy
        sm::fence_proxy_async();
        __syncwarp();
        if (lane == 0) {
          sm::mbar_arrive(&split_full[s]);
          sm::mbar_arrive(&empty[s]);
        }
        if (++s == kStages) {
          s = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg takes rows 64 wg .. 64 wg + 63 of a tile
  sm::setmaxnreg_inc<C::kConsumerRegs>();
  const int wg = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int r = wg * 64 + (warp & 3) * 16 + g;  // and r + 8
  int s = 0, phase = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const Tile<BM, BN> tl(tile, tiles_n, tiles_m, K, k_split);
    float hh[BN / 2], hl[BN / 2], lh[BN / 2];
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) hh[e] = hl[e] = lh[e] = 0.f;
    for (int kt = 0; kt < tl.k_tiles; ++kt) {
      sm::mbar_wait(&split_full[s], phase);
      sm::mbar_wait(&full[s], phase);
      const unsigned char* a_s =
          smem + s * C::kStageBytes + (kAMn ? wg * 2 * kBox : wg * 64 * 128);
      const unsigned char* bh_s = split_ring + s * C::kSplitBytes;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t ah[4], al[4];
        load_a<kAMn>(a_s, r - wg * 64, kk, t, ah, al);
        if (kk == 1) {
          // the fp32 stage is read: the producer may refill it
          __syncwarp();
          if (lane == 0) sm::mbar_arrive(&empty[s]);
        }
        // MN-major bf16 B: 64-wide chunks kChunk apart, 128-byte rows,
        // 8-deep groups 1024 apart, a 16-deep step 2048 bytes
        uint64_t dbh = sm::make_desc(bh_s + kk * 2048, kChunk, 1024, 128);
        uint64_t dbl =
            sm::make_desc(bh_s + C::kHalf + kk * 2048, kChunk, 1024, 128);
        // every input of the products is in place before they are issued
        sm::fence_regs(ah);
        sm::fence_regs(al);
        sm::fence_reg(dbh);
        sm::fence_reg(dbl);
        sm::wgmma_fence();
        sm::WgmmaRS<BN>::mma<1>(hh, ah, dbh, 1);
        sm::WgmmaRS<BN>::mma<1>(hl, ah, dbl, 1);
        sm::WgmmaRS<BN>::mma<1>(lh, al, dbh, 1);
        sm::wgmma_commit();
        sm::wgmma_wait<0>();
      }
      // the split tile is read
      __syncwarp();
      if (lane == 0) sm::mbar_arrive(&split_empty[s]);
      if (++s == kStages) {
        s = 0;
        phase ^= 1;
      }
    }
    sm::fence_regs(hh);
    sm::fence_regs(hl);
    sm::fence_regs(lh);

    // epilogue on the fragments: d[4 j + e] is row m0 + r + 8 (e / 2),
    // column n0 + 8 j + 2 t + (e % 2); two adjacent columns a store where
    // N is even, one at a time where it is odd
    const auto q = mvt::resolve(policy);
    const bool pairs = (N & 1) == 0;
    const size_t out_base =
        kEpi == kF32 ? static_cast<size_t>(tl.split) * M * N : 0;
    float csum[BN / 8][2];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      csum[j][0] = csum[j][1] = 0.f;
      const int col = tl.n0 + 8 * j + 2 * t;
      if (col >= N) continue;
      const bool second = col + 1 < N;
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int row = tl.m0 + r + 8 * h2;
        if (row >= M) continue;
        const size_t o = static_cast<size_t>(row) * N + col;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h2 + e;
          v[e] = __fadd_rn(__fadd_rn(hh[i], hl[i]), lh[i]);
        }
        float x[2] = {0.f, 0.f}, gp[2] = {0.f, 0.f};
        if (kEpi == kMulAux || kEpi == kBiasSnapResidualSnap) {
          const float* src = kEpi == kMulAux ? aux : residual;
          if (pairs) {
            const float2 p = *reinterpret_cast<const float2*>(src + o);
            x[0] = p.x;
            x[1] = p.y;
          } else {
            x[0] = src[o];
            if (second) x[1] = src[o + 1];
          }
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (kEpi == kF32) continue;
          if (kEpi == kMulAux) {
            v[e] = __fmul_rn(v[e], x[e]);
            if (e == 0 || second) csum[j][e] += v[e];
            continue;
          }
          const float b = e == 0 || second ? __ldg(bias + col + e) : 0.f;
          float u = mvt::site(mvt::snap_all(__fadd_rn(v[e], b), q), q, 0);
          if (kEpi == kBiasSnapGeluSnap) {
            u = mvt::site(mvt::snap(mvt::snap_all(mvt::gelu_poly(u), q), q),
                          q, 1);
          } else if (kEpi == kBiasSnapGeluSnapGrad) {
            u = mvt::site(mvt::snap(mvt::snap_all(
                                        mvt::gelu_and_grad_poly(u, &gp[e]),
                                        q),
                                    q),
                          q, 1);
          } else if (kEpi == kBiasSnapResidualSnap) {
            u = mvt::site(mvt::snap_all(__fadd_rn(x[e], u), q), q, 1);
          }
          v[e] = u;
        }
        float* dst = out + out_base + o;
        if (pairs) {
          *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
          if (kEpi == kBiasSnapGeluSnapGrad)
            *reinterpret_cast<float2*>(aux + o) = make_float2(gp[0], gp[1]);
        } else {
          dst[0] = v[0];
          if (second) dst[1] = v[1];
          if (kEpi == kBiasSnapGeluSnapGrad) {
            aux[o] = gp[0];
            if (second) aux[o + 1] = gp[1];
          }
        }
      }
    }
    if (kEpi == kMulAux) {
      // the warp's 16-row sums (lanes 4 g + t, g = 0 keeps them), then the
      // eight warps' in order; the buffer is free again after the second
      // barrier
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = csum[j][e];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (g == 0) colbuf[warp * BN + 8 * j + 2 * t + e] = v;
        }
      }
      asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
      if (tid < BN && tl.n0 + tid < N) {
        float v = 0.f;
#pragma unroll
        for (int w = 0; w < kConsumers / 32; ++w) v += colbuf[w * BN + tid];
        colpart[static_cast<size_t>(tl.tile_m) * N + tl.n0 + tid] = v;
      }
      asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
    }
  }
}

// The tensor maps of A and B, fp32, 128-byte swizzle: a K-major operand
// in boxes of 32 K by its tile's rows (BN columns for B), an MN-major one
// in 32 x 32 boxes.
int encode_maps(CUtensorMap* ma, CUtensorMap* mb, const void* a,
                const void* b, int M, int N, int K, int BM, int BN,
                bool a_mn, bool b_mn) {
  const uint64_t m = M, n = N, k = K;
  uint64_t dims[2], strides[1];
  uint32_t box[2];
  if (a_mn) {
    dims[0] = m, dims[1] = k, strides[0] = 4 * m, box[0] = 32, box[1] = BK;
  } else {
    dims[0] = k, dims[1] = m, strides[0] = 4 * k, box[0] = BK;
    box[1] = static_cast<uint32_t>(BM);
  }
  int err = sm::encode_f32(ma, a, 2, dims, strides, box, 128);
  if (err != 0) return err;
  if (b_mn) {
    dims[0] = n, dims[1] = k, strides[0] = 4 * n, box[0] = 32, box[1] = BK;
  } else {
    dims[0] = k, dims[1] = n, strides[0] = 4 * k, box[0] = BK;
    box[1] = static_cast<uint32_t>(BN);
  }
  return sm::encode_f32(mb, b, 2, dims, strides, box, 128);
}

// the SMs of the current device (one persistent CTA on each)
int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (counts[dev] == 0 &&
      cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    counts[dev] = 132;
  return counts[dev];
}

template <bool kAMn, bool kBMn, int kEpi, class Snaps = mvt::QSpec>
int launch(cudaStream_t stream, const void* a, const void* b,
           const void* bias, const void* residual, void* out, void* aux,
           void* colpart, int M, int N, int K, int k_split, Snaps q) {
  using C = CfgOf<kEpi>;
  constexpr int BM = C::BM, BN = C::BN;
  CUtensorMap ma, mb;
  int err = encode_maps(&ma, &mb, a, b, M, N, K, BM, BN, kAMn, kBMn);
  if (err != 0) return err;
  const long long tiles = static_cast<long long>((N + BN - 1) / BN) *
                          ((M + BM - 1) / BM) *
                          ((K + k_split - 1) / k_split);
  const dim3 grid(static_cast<unsigned>(tiles < sm_count() ? tiles
                                                           : sm_count()));
  auto kernel = gemm_f32x3_wgmma_kernel<kAMn, kBMn, kEpi, Snaps>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::kSmemBytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, C::kThreads, C::kSmemBytes, stream>>>(
      ma, mb, static_cast<const float*>(bias),
      static_cast<const float*>(residual), static_cast<float*>(out),
      static_cast<float*>(aux), static_cast<float*>(colpart), M, N, K,
      k_split, q);
  return static_cast<int>(cudaGetLastError());
}

// the forward epilogues (0, 1, 2, 4) under snap policy q: A row-major, B
// the (N, K) weight
template <class Snaps>
int launch_snapping(cudaStream_t s, int epilogue, const void* a,
                    const void* b, const void* bias, const void* residual,
                    void* out, void* aux, int M, int N, int K, Snaps q) {
  switch (epilogue) {
    case kBiasSnap:
      return launch<false, false, kBiasSnap>(s, a, b, bias, residual, out,
                                             aux, nullptr, M, N, K, K, q);
    case kBiasSnapGeluSnap:
      return launch<false, false, kBiasSnapGeluSnap>(
          s, a, b, bias, residual, out, aux, nullptr, M, N, K, K, q);
    case kBiasSnapResidualSnap:
      return launch<false, false, kBiasSnapResidualSnap>(
          s, a, b, bias, residual, out, aux, nullptr, M, N, K, K, q);
    default:
      return launch<false, false, kBiasSnapGeluSnapGrad>(
          s, a, b, bias, residual, out, aux, nullptr, M, N, K, K, q);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// The output tile and the K step: 0 rows, 1 columns, 2 BK; 3 the rows and
// 4 the columns of the GELU epilogues' tile (1 and 4).
MVT_EXPORT int mvt_gemm_f32x3_tile(int which) {
  return which == 0   ? bm_of(kF32)
         : which == 1 ? bn_of(kF32)
         : which == 2 ? BK
         : which == 3 ? bm_of(kBiasSnapGeluSnap)
                      : bn_of(kBiasSnapGeluSnap);
}

// a (M, K) fp32 row-major, 16-byte aligned; b fp32, 16-byte aligned: the
// (N, K) torch weight row-major for epilogues 0, 1, 2 and 4 (b_row_major
// 0), a row-major (K, N) matrix for 3 and 5 (b_row_major 1); bias fp32 (N,)
// (0, 1, 2, 4); residual fp32 (M, N) (2); aux fp32 (M, N), written by 4 and
// read by 5; colpart fp32 (ceil(M / 128), N) (5); out fp32 (M, N).  The
// snap policy of 0, 1, 2 and 4: site0 (and for 1, 2, 4 site1), (3,) fp32
// rows (scale, zero point, has_stats) of the INT8 site table on the device,
// or site0 null for the float format qspec (exp_bits, man_bits,
// all_sites).  K % 4 == 0, and N % 4 == 0 for a row-major b (TMA's 16-byte
// row strides).
MVT_EXPORT int mvt_gemm_f32x3(const void* a, const void* b, const void* bias,
                              const void* residual, void* out, void* aux,
                              void* colpart, int M, int N, int K,
                              int b_row_major, int epilogue, int exp_bits,
                              int man_bits, int all_sites, const void* site0,
                              const void* site1, void* stream) {
  const bool row_b = epilogue == kF32 || epilogue == kMulAux;
  const bool int8 = site0 != nullptr;
  if (M <= 0 || N <= 0 || K <= 0 || K % 4 != 0 || epilogue < kBiasSnap ||
      epilogue > kMulAux || (b_row_major != 0) != row_b ||
      (row_b && N % 4 != 0) || (!row_b && bias == nullptr) ||
      !aligned16(a) || !aligned16(b) ||
      (epilogue == kBiasSnapResidualSnap && residual == nullptr) ||
      ((epilogue == kBiasSnapGeluSnapGrad || epilogue == kMulAux) &&
       aux == nullptr) ||
      (epilogue == kMulAux && colpart == nullptr) ||
      (int8 && (row_b || (epilogue != kBiasSnap && site1 == nullptr))) ||
      (!int8 && !row_b && !mvt::float_fmt_ok(exp_bits, man_bits)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const mvt::QSpec none(8, 10, 0);  // the unsnapped epilogues read no snap
  if (epilogue == kF32)
    return launch<false, true, kF32>(s, a, b, bias, residual, out, aux,
                                     colpart, M, N, K, K, none);
  if (epilogue == kMulAux)
    return launch<false, true, kMulAux>(s, a, b, bias, residual, out, aux,
                                        colpart, M, N, K, K, none);
  if (int8)
    return launch_snapping(
        s, epilogue, a, b, bias, residual, out, aux, M, N, K,
        mvt::Int8Sites{static_cast<const float*>(site0),
                       static_cast<const float*>(site1)});
  return launch_snapping(s, epilogue, a, b, bias, residual, out, aux, M, N,
                         K, mvt::QSpec(exp_bits, man_bits, all_sites));
}

// Weight gradient: out = A^T-stored x B, i.e. A stored (K, M) row-major and
// B (K, N) row-major, K ragged, fp32 out, no epilogue.  K is split into
// chunks of k_split rows (a multiple of BK); chunk z writes out[z] of
// (splits, M, N).  M % 4 == 0 and N % 4 == 0.
MVT_EXPORT int mvt_gemm_f32x3_at(const void* a, const void* b, void* out,
                                 int M, int N, int K, int k_split,
                                 void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || M % 4 != 0 || N % 4 != 0 ||
      !aligned16(a) || !aligned16(b) || k_split <= 0 || k_split % BK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<true, true, kF32>(static_cast<cudaStream_t>(stream), a, b,
                                  nullptr, nullptr, out, nullptr, nullptr, M,
                                  N, K, k_split, mvt::QSpec(8, 10, 0));
}
