// attention_core_f32 above 256 tokens on Hopper: the fp32 softmax
// attention core of the float-format and INT8 QAT attention blocks (and of
// float32 compute, whose site table snaps nothing), ending on the
// to_out.act_in snap or the quant_out site, and of the converted INT8
// attention block, ending on the int8 grid of its quant_out site, from 257
// to 1837 tokens: the score-block design up to 768, the three-sweep design
// above it.
//
// The per-head loop of the TPU kernels `_attn_heads_fwd` with qspec set,
// followed by the snap of `_fwd_kernel`
// (myrtle_vision_tpu/ops/fused_attention_block.py; a float format's, or
// `_snap_int8` with qspec "int8"), and `_attn_kernel`
// (myrtle_vision_tpu/ops/fused_int8_block.py), which the JAX package runs
// wherever `fuses_at` holds: up to 701 tokens at 6 heads of 64 (the
// YOLOS-S train step's 256-608 px canvases give 357-677, ViT-S/16 at 384
// px 577), 1017 at 3 heads of 64 (YOLOS-Ti's 416-480 px canvases give
// 777-1001, ViT-Ti/16 at 448-496 px 785-962), 1837 at one head of 32.
// Input qkv (B, N, 3C) fp32, feature order [3][h][d], D = 32 or
// 64; output (B, N, C), head h at columns h*D...; with statistics also the
// rowmax m and rs = 1 / sum, (B, H, N) fp32.  The function of
// attention_core_f32_wgmma.cu, for each query row:
//   s   = high3(q, k^T) * scale, the scale after the product
//   m   = rowmax(s), e = exp(s - m), sum = rowsum(e)
//   p   = e / sum                    a true fp32 divide over the whole row
//   ctx = high3(p, v)
//   snap modes: out = snap(ctx), fp32: a float format's FloatingPoint
//               snap, or INT8 QAT's affine site snap with the quant_out
//               row (`snap_int8`, no change where the site has no
//               statistics)
//   int8 mode:  out = clip(rint(ctx / s) + zp, 0, 255) - 128, int8 (the
//               quant_out grid; without statistics scale 1 and zero point
//               128, the guard of `_quantize_i8`)
// with high3 the 3-pass split-bf16 product of attention_f32_tiles.cuh.
//
// The arithmetic.  The divide needs the sum of the whole row, so a
// rescaled online softmax (which rounds differently from JAX's e / sum) is
// not an option, and at N_pad = 704 a head's split K and V (4 N_pad D
// bf16, 352 KiB at D = 64) exceed an SM.  One CTA takes 64 queries of one
// (image, head) and keeps its 64 x N_pad fp32 scores in shared memory
// (176 KiB at N_pad = 704), each thread the values of its own accumulator
// fragments (a float4 per 8-key block), so no thread reads another's and
// the row statistics need only the quad shuffles:
//   scores   S = high3(Q, K^T) as one chain of 3 D / 16 products m64n64k16
//            a 64-key tile, in the pass order hi.lo, lo.hi, hi.hi, q
//            split in registers as the A operand (the forward core's
//            chain); s is scaled, keys past N set to -inf (e = 0), and
//            stored;
//   softmax  the row max, then e = exp(s - m) in place with the rowsum in
//            the same four partial sums a row, added in the same order,
//            as attention_core_f32_wgmma.cu;
//   P V      one walk over the 64-key V tiles: each tile's A fragments
//            of p = e / sum (the true divide, formed here) split in
//            registers, its chain3 (the tile's 4 steps of hi.lo, then
//            lo.hi, then hi.hi) into a fresh accumulator, which is then
//            added to the context rounded once.
// Why not one chain over every key, as the short core runs it: on the
// tensor cores a chain of 3 x 44 steps rounds each step at the running
// sum's scale, and at N = 677-701 the snapped context then parts from the
// plain version's by a format step in up to the whole 0.2% that the float
// formats' bar allows; per-tile chains added in fp32 part about as often
// as the plain version itself parts from the same operations summed in
// fp64.  The recomputed S of the backward keeps the short core's chain
// (attention_f32_tiles.cuh).  Three sweeps that recompute the scores would
// keep no score block, but cost two more S products.
//
// The score-block design (f32_long_wgmma.cuh), two launches a call, up to
// kBlockMaxN = 768 tokens.  A split pass
// writes K's and V's bf16 halves once into a scratch of (4, B, H, N_pad,
// D) bf16, rows past N zero; the first design split each tile in every
// query tile's CTA, 11 times a row at N = 677, waiting on its threads
// before each product.  The core's CTA is a consumer warpgroup and a
// producer warp whose lane 0 streams the K tiles, then the V tiles, each
// a tile's hi and lo halves by TMA, through a ring of 2-4 stages (what
// the score block leaves of the 227 KiB: 4 up to N_pad 640, 3 at 704, 2 at
// 768) on full and empty mbarriers, so the V tiles land while the softmax
// runs.  The warpgroup issues the score chains of two tiles at a time,
// their steps in turn, before it scales, masks and stores the two before
// (copied out of the accumulators), and forms tile kt + 1's P V fragments
// (the divides and splits) while tile kt's chain runs.  Every chain is issued outside any branch and its
// accumulator written by nothing else: either made ptxas serialise the
// products (C7518, C7515).  The separate divide pass over the score block is gone: p
// is formed in registers with the same __fdiv_rn, so the outputs are
// those of the first design bit for bit (tools/perf/core_long_bench.py
// compares them).  The int8 modes change only the epilogue: the same
// scores, softmax and per-tile P V, then the site's rint and clip on the
// accumulator.
// What bounds it: at (8, 677), 6 heads of 64, the two products are 3 x
// 2 x 8 x 6 x 677^2 x 64 x 2 = 16.9 GFLOP of bf16 tensor-core work
// (0.0171 ms at 989 TFLOP/s) and the qkv rows, context and statistics 34
// MB (0.0100 ms at 3.35 TB/s).  On one H100 80GB HBM3 at 700 W
// (tools/perf/core_long_bench.py, 3 rounds) the call takes 0.1171 ms
// (device 0.1130: the split pass 0.0111, the core 0.1019) against 0.2460
// for the design that split every tile in its threads and 0.2350 for
// fp32 SDPA; at (8, 577) the site mode 0.1044 and the int8 mode 0.0977.
// One CTA an SM, so a CTA's phases run in series: about 8.8 us of scores,
// 3.4 of exponentials, 8.7 of P V and 3.2 of epilogue at (8, 677)
// (%globaltimer stamps in a scratch copy).  Its m64n64k16 steps, from one
// warpgroup, take about 115 cycles each, some 28% of the tensor cores'
// rate: two chains in flight and tiles resident in L2 changed the score
// and P V phases by under 5%, so neither a chain's latency nor the loads
// bound them; the divides of P V did (18.6 us with __fdiv_rn, hence
// RowDivisor).  ptxas -v: 222 registers a thread at D = 64 (194 at 32),
// no spills; 230,464 bytes of dynamic shared memory at D = 64 and N_pad
// 640-768 (4, 3, 2 stages).
//
// The three-sweep design (attention_core_f32_sweep_kernel below), the same
// two launches, above 768 tokens: the same CTA without the score block,
// which walks the K tiles three times (the row max; the exponentials and
// rowsum; the exponentials again, the divide and P V), so its shared
// memory is a ring of four stages and the CTA's q rows whatever N.  Its
// scores are not a tensor-core chain but the plain version's in-order
// fp32 sums on the FMA units (see there: at one head past 1000 tokens the
// chain's truncation alone put the snapped context over the float
// formats' bar), computed three times; P V stays on wgmma.
#include <cstdint>

#include "f32_long_wgmma.cuh"
#include "fake_quant.cuh"

namespace {

using namespace mvt::f32attn;
namespace sm = mvt::sm90;
namespace fl = mvt::f32long;

// kInt8: int8 out on the grid of `site`; kSnapFloat: fp32 out through the
// float format `qs`; kSnapSite: fp32 out through the INT8 site `site` (the
// modes of attention_core_f32_wgmma.cu)
enum Mode { kInt8 = 0, kSnapFloat = 1, kSnapSite = 2 };

// K's and V's halves of every (image, head), split once a call
template <int D>
__global__ void __launch_bounds__(256)
f32_long_kv_split_kernel(const float* __restrict__ qkv,
                         uint4* __restrict__ split, int B, int N,
                         int heads) {
  fl::split_operands<D>(qkv, nullptr, nullptr, split, B, N, heads, fl::kOpK,
                        2);
}

struct Args {
  const float* qkv;  // (B, N, 3C)
  const float* site;
  void* out;
  float* m_out;
  float* rs_out;
  int n, heads, stages, mode;
  float scale;
};

// a consumer warp's lane 0 releases a stage once the warp is done with it
__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) sm::mbar_arrive(bar);
}

// the two bf16 values at byte offset `off` (4-byte aligned) of a tile
// swizzled as TMA writes it, as fp32
template <int kRow>
__device__ __forceinline__ float2 bf16x2_at(const unsigned char* tile,
                                            uint32_t off) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(
      tile + sm::swizzle_chunk<kRow>(off));
  return make_float2(__uint_as_float(w << 16),
                     __uint_as_float(w & 0xffff0000u));
}

// The context rows ra and rb of the CTA's 64 (those below N) through the
// mode's epilogue into out, and with statistics the rowmax and reciprocal
// rowsum: u[4 j + e] is row ra (e < 2) or rb, column 8 j + 2 t + (e % 2)
template <int D>
__device__ __forceinline__ void store_context(
    const Args& a, const mvt::QSpec& qs, const float (&u)[D / 2], int b,
    int h, int bh, int ra, int rb, int t, float mx0, float mx1, float sum0,
    float sum1) {
  const int N = a.n, C = a.heads * D;
  // the output grid (int8) or site (INT8 QAT) row
  float s_site = 1.0f, zp_site = 128.0f, has_site = 0.f;
  if (a.mode != kSnapFloat && a.site[2] > 0.5f) {
    s_site = a.site[0];
    zp_site = a.site[1];
    has_site = a.site[2];
  }
  const size_t oa = (static_cast<size_t>(b) * N + ra) * C + h * D;
  const size_t ob = oa + static_cast<size_t>(8) * C;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int d = 8 * j + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if ((half ? rb : ra) >= N) continue;
      const size_t o = (half ? ob : oa) + d;
      const float x0 = u[4 * j + 2 * half], x1 = u[4 * j + 2 * half + 1];
      if (a.mode == kInt8) {
        const float y0 = fminf(
            fmaxf(__fadd_rn(rintf(__fdiv_rn(x0, s_site)), zp_site), 0.f),
            255.f);
        const float y1 = fminf(
            fmaxf(__fadd_rn(rintf(__fdiv_rn(x1, s_site)), zp_site), 0.f),
            255.f);
        char2 c;
        c.x = static_cast<signed char>(static_cast<int>(y0) - 128);
        c.y = static_cast<signed char>(static_cast<int>(y1) - 128);
        *reinterpret_cast<char2*>(static_cast<signed char*>(a.out) + o) = c;
      } else {
        float2 y;
        if (a.mode == kSnapFloat) {
          y.x = mvt::snap(x0, qs);
          y.y = mvt::snap(x1, qs);
        } else {
          y.x = mvt::int8_site_snap(x0, s_site, zp_site, has_site);
          y.y = mvt::int8_site_snap(x1, s_site, zp_site, has_site);
        }
        *reinterpret_cast<float2*>(static_cast<float*>(a.out) + o) = y;
      }
    }
  }
  if (a.m_out != nullptr && t == 0) {
    const size_t o = static_cast<size_t>(bh) * N;
    if (ra < N) {
      a.m_out[o + ra] = mx0;
      a.rs_out[o + ra] = __fdiv_rn(1.0f, sum0);
    }
    if (rb < N) {
      a.m_out[o + rb] = mx1;
      a.rs_out[o + rb] = __fdiv_rn(1.0f, sum1);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(fl::kFwdThreads, 1)
attention_core_f32_long_kernel(const __grid_constant__ CUtensorMap map,
                               const Args a, const mvt::QSpec qs) {
  using T = fl::Tiles<D>;
  constexpr int kRow = T::kRow;
  constexpr int kConsumers = 32 * fl::kFwdConsumerWarps;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (sm::smem_u32(smem_raw) & 1023)) & 1023);
  const int N = a.n, heads = a.heads, S = a.stages;
  const int tiles = (N + kLongTile - 1) / kLongTile, np = tiles * kLongTile;
  unsigned char* ring = smem;
  float4* S4 = reinterpret_cast<float4*>(smem + S * T::kPair);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + S * T::kPair + fl::fwd_score_bytes(N));
  uint64_t* empty = full + fl::kFwdMaxStages;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      sm::mbar_init(&full[s], 1);
      sm::mbar_init(&empty[s], fl::kFwdConsumerWarps);
    }
    sm::fence_barrier_init();
  }
  __syncthreads();

  if (warp == fl::kFwdConsumerWarps) {
    // the producer warp: K tiles 0 .. tiles - 1, then the V tiles, each
    // into the next stage once the warpgroup has released it
    if (lane == 0) {
      for (int it = 0; it < 2 * tiles; ++it) {
        const int s = it % S, use = it / S, v = it >= tiles ? 1 : 0;
        if (use > 0) sm::mbar_wait(&empty[s], (use - 1) & 1);
        sm::mbar_expect_tx(&full[s], T::kPair);
        fl::load_pair<D>(ring + s * T::kPair, &map, &full[s],
                         2 * v, bh, gridDim.y, np,
                         kLongTile * (it - v * tiles));
      }
    }
    return;
  }

  const int C = heads * D;
  const size_t row_stride = static_cast<size_t>(3) * C;
  const float* base = a.qkv + static_cast<size_t>(b) * N * row_stride + h * D;

  // this thread's rows and its A fragments of q, split (the forward core's)
  const int ra = kLongTile * blockIdx.x + 16 * warp + g, rb = ra + 8;
  uint32_t qh[D / 16][4], ql[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int r = (w & 1) ? rb : ra;
      const int d = 16 * kk + 8 * (w >> 1) + 2 * t;
      float2 v = make_float2(0.f, 0.f);
      if (r < N)
        v = *reinterpret_cast<const float2*>(
            base + static_cast<size_t>(r) * row_stride + d);
      sm::split_bf16x2(v.x, v.y, qh[kk][w], ql[kk][w]);
    }
  }

  // ---- scores: s[4 j + e] of a tile is row ra (e < 2) or rb, key 64 kt +
  // 8 j + 2 t + (e % 2); stored as the float4 S4[(8 kt + j) * 128 + tid] ----
  float mx0 = mvt::neg_inf(), mx1 = mvt::neg_inf();
  // tiles k and k1 = min(k + 1, tiles - 1) issued as one group, the two
  // chains' steps in turn (chain3_pair: each chain in its own order, two
  // products in flight), into sb0 and sb1; their first products ignore
  // what the accumulators held
  float sa0[32], sa1[32], sb0[32], sb1[32];
  auto issue_scores = [&](int k) {
    const int k1 = k + 1 < tiles ? k + 1 : k;
    sm::mbar_wait(&full[k % S], (k / S) & 1);
    sm::mbar_wait(&full[k1 % S], (k1 / S) & 1);
    const unsigned char* t0 = ring + (k % S) * T::kPair;
    const unsigned char* t1 = ring + (k1 % S) * T::kPair;
    const uint64_t d0h = sm::rows_desc<D>(t0, 0);
    const uint64_t d0l = sm::rows_desc<D>(t0 + T::kSub, 0);
    const uint64_t d1h = sm::rows_desc<D>(t1, 0);
    const uint64_t d1l = sm::rows_desc<D>(t1 + T::kSub, 0);
    sm::wgmma_fence();
    chain3_pair<D / 16>(
        [&](int x, int bl, int kk) {
          sm::WgmmaRS<64>::template mma<0>(
              sb0, x ? ql[kk] : qh[kk], sm::desc_add(bl ? d0l : d0h, kk * 32),
              chain_first(x, bl, kk) ? 0 : 1);
        },
        [&](int x, int bl, int kk) {
          sm::WgmmaRS<64>::template mma<0>(
              sb1, x ? ql[kk] : qh[kk], sm::desc_add(bl ? d1l : d1h, kk * 32),
              chain_first(x, bl, kk) ? 0 : 1);
        });
    sm::wgmma_commit();
  };
  // the pair's chains are done: copied out into sa0 and sa1, its stages
  // released
  auto take_scores = [&](int k) {
    sm::wgmma_wait<0>();
    sm::fence_regs(sb0);
    sm::fence_regs(sb1);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      sa0[i] = sb0[i];
      sa1[i] = sb1[i];
    }
    release(&empty[k % S], lane);
    if (k + 1 < tiles) release(&empty[(k + 1) % S], lane);
  };
  // tile kt's scores: scaled, keys past N masked, stored, the row maxima
  auto store_scores = [&](const float (&s)[32], int kt) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int key = kLongTile * kt + 8 * j + 2 * t;
      float4 v;
      v.x = key < N ? scaled(s[4 * j], a.scale) : mvt::neg_inf();
      v.y = key + 1 < N ? scaled(s[4 * j + 1], a.scale) : mvt::neg_inf();
      v.z = key < N ? scaled(s[4 * j + 2], a.scale) : mvt::neg_inf();
      v.w = key + 1 < N ? scaled(s[4 * j + 3], a.scale) : mvt::neg_inf();
      mx0 = fmaxf(fmaxf(mx0, v.x), v.y);
      mx1 = fmaxf(fmaxf(mx1, v.z), v.w);
      S4[(8 * kt + j) * kConsumers + tid] = v;
    }
  };
  // tiles kt + 2 and kt + 3's chains run while tiles kt and kt + 1's
  // scores, copied out of their accumulators, are stored: a chain is never
  // issued under a branch, and no accumulator is written by anything but
  // its chain, or ptxas serialises the products (C7518, C7515)
  {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      sm::fence_regs(qh[kk]);
      sm::fence_regs(ql[kk]);
    }
    issue_scores(0);
    take_scores(0);
    int kt = 0;
    for (; kt + 2 < tiles; kt += 2) {
      issue_scores(kt + 2);
      store_scores(sa0, kt);
      store_scores(sa1, kt + 1);
      take_scores(kt + 2);
    }
    store_scores(sa0, kt);
    if (kt + 1 < tiles) store_scores(sa1, kt + 1);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      sm::fence_regs(qh[kk]);
      sm::fence_regs(ql[kk]);
    }
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
  }

  // ---- e = exp(s - m) and the rowsums, in the short core's order: four
  // partial sums a row (by the parity of the 8-key block and the pair
  // element), the blocks in key order, then pairwise, then the quad ----
  float part[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) part[r][c] = 0.f;
  for (int kt = 0; kt < tiles; ++kt) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float4& cell = S4[(8 * kt + j) * kConsumers + tid];
      float4 v = cell;
      v.x = exp_shift(v.x, mx0);
      v.y = exp_shift(v.y, mx0);
      v.z = exp_shift(v.z, mx1);
      v.w = exp_shift(v.w, mx1);
      const int c = 2 * (j & 1);
      part[0][c] = __fadd_rn(part[0][c], v.x);
      part[0][c + 1] = __fadd_rn(part[0][c + 1], v.y);
      part[1][c] = __fadd_rn(part[1][c], v.z);
      part[1][c + 1] = __fadd_rn(part[1][c + 1], v.w);
      cell = v;
    }
  }
  float sum0 = __fadd_rn(__fadd_rn(part[0][0], part[0][1]),
                         __fadd_rn(part[0][2], part[0][3]));
  float sum1 = __fadd_rn(__fadd_rn(part[1][0], part[1][1]),
                         __fadd_rn(part[1][2], part[1][3]));
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    sum0 = __fadd_rn(sum0, __shfl_xor_sync(0xffffffffu, sum0, o));
    sum1 = __fadd_rn(sum1, __shfl_xor_sync(0xffffffffu, sum1, o));
  }

  // ---- U = high3(P, V), one 64-key V tile at a time: the tile's A
  // fragments of p = e / sum split into hi and lo (step ks holds its
  // values 8 ks + 2 w + {0, 1}, word w rows ra (w even) or rb), its
  // `chain3` of 3 x 4 products into a fresh accumulator, added to u
  // rounded once; tile kt + 1's fragments are formed under tile kt's
  // chain, then copied into the chain's operands
  const fl::RowDivisor div0(sum0), div1(sum1);
  auto form = [&](uint32_t (&ph)[4][4], uint32_t (&pl)[4][4], int kt) {
    float p[32];
    bool slow = false;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 x = S4[(8 * kt + j) * kConsumers + tid];
      p[4 * j] = div0.div(x.x, slow);
      p[4 * j + 1] = div0.div(x.y, slow);
      p[4 * j + 2] = div1.div(x.z, slow);
      p[4 * j + 3] = div1.div(x.w, slow);
    }
    if (slow) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 x = S4[(8 * kt + j) * kConsumers + tid];
        p[4 * j] = __fdiv_rn(x.x, sum0);
        p[4 * j + 1] = __fdiv_rn(x.y, sum0);
        p[4 * j + 2] = __fdiv_rn(x.z, sum1);
        p[4 * j + 3] = __fdiv_rn(x.w, sum1);
      }
    }
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int i = 8 * ks + 2 * w;
        sm::split_bf16x2(p[i], p[i + 1], ph[ks][w], pl[ks][w]);
      }
  };
  float u[D / 2], acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) u[i] = 0.f;
  // V read MN-major (the transpose bit), 16 keys a step, into a fresh
  // accumulator (the chain's first product ignores what acc held)
  auto issue_pv = [&](uint32_t (&ph)[4][4], uint32_t (&pl)[4][4], int kt) {
    const int it = tiles + kt, st = it % S;
    sm::mbar_wait(&full[st], (it / S) & 1);
    const unsigned char* th = ring + st * T::kPair;
    const uint64_t dth = sm::rows_desc<D>(th, 0);
    const uint64_t dtl = sm::rows_desc<D>(th + T::kSub, 0);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      sm::fence_regs(ph[ks]);
      sm::fence_regs(pl[ks]);
    }
    sm::wgmma_fence();
    chain3<4>([&](int x, int bl, int ks) {
      sm::WgmmaRS<D>::template mma<1>(
          acc, x ? pl[ks] : ph[ks],
          sm::desc_add(bl ? dtl : dth, ks * 16 * kRow),
          chain_first(x, bl, ks) ? 0 : 1);
    });
    sm::wgmma_commit();
  };
  auto finish_pv = [&](uint32_t (&ph)[4][4], uint32_t (&pl)[4][4], int kt) {
    sm::wgmma_wait<0>();
    sm::fence_regs(acc);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      sm::fence_regs(ph[ks]);
      sm::fence_regs(pl[ks]);
    }
    release(&empty[(tiles + kt) % S], lane);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) u[i] = __fadd_rn(u[i], acc[i]);
  };
  {
    uint32_t fah[4][4], fal[4][4], fbh[4][4], fbl[4][4];
    form(fah, fal, 0);
    for (int kt = 0; kt < tiles; ++kt) {
      issue_pv(fah, fal, kt);
      if (kt + 1 < tiles) form(fbh, fbl, kt + 1);
      finish_pv(fah, fal, kt);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          fah[ks][w] = fbh[ks][w];
          fal[ks][w] = fbl[ks][w];
        }
    }
  }

  store_context<D>(a, qs, u, b, h, bh, ra, rb, t, mx0, mx1, sum0, sum1);
}

// The three-sweep design: the same function without the score block.  The
// CTA (a consumer warpgroup that owns 64 queries of one (image, head) and a
// producer warp) walks the K tiles three times and the V tiles once, each
// tile's hi and lo halves loaded by TMA from the split scratch through a
// ring of kFwdMaxStages stages, in the order K 0 .. K T-1, K 0 .. K T-1, K 0,
// V 0, K 1, V 1, ..., K T-1, V T-1:
//   sweep 1  S -> the row max;
//   sweep 2  S again -> e = exp(s - m) and the rowsum, four compensated
//            partial sums a row;
//   sweep 3  S again -> e -> p = e / sum (the true divide) split in
//            registers, the tile's chain3 of P V into a fresh accumulator,
//            added to the context rounded once; tile kt + 1's S runs on the
//            FMA units while tile kt's P V chain runs on the tensor cores.
// S here is not the tensor cores' chain: each of its passes is the sum
// over d in order, one fp32 FMA a term (each product of two bf16 halves is
// exact), then (hi.hi + hi.lo) + lo.hi and the scale: the plain version's
// arithmetic, whose cuBLAS products on the card sum each pass in exactly
// that order (measured bit for bit at 197-1837 tokens, D 32 and 64).  The
// tensor cores truncate as they accumulate: their S sits about half an ulp
// below the plain version's at the row max, and every score's ulp of error
// moves p; past 1000 tokens at one head that alone put 0.20-0.21% of a
// snapped context a format step from the plain version's, over the float
// formats' 0.2% bar.  With the same S, m and e are the plain version's bit
// for bit, and only the rowsum (compensated, to a few tenths of an ulp of
// the plain version's) and P V part from it.  The S of the three sweeps
// costs 3 x 3 x D FMAs a score on the FMA units, with q's halves in shared
// memory beside the ring.  Its outputs are therefore not the score-block
// design's bits (tests/test_torch_kernels_cuda.py measures the two against
// each other and against the plain version at N <= 768).
template <int D>
__global__ void __launch_bounds__(fl::kFwdThreads, 1)
attention_core_f32_sweep_kernel(const __grid_constant__ CUtensorMap map,
                                const Args a, const mvt::QSpec qs) {
  using T = fl::Tiles<D>;
  constexpr int kRow = T::kRow;
  constexpr int S = fl::kFwdMaxStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (sm::smem_u32(smem_raw) & 1023)) & 1023);
  const int N = a.n, heads = a.heads;
  const int tiles = (N + kLongTile - 1) / kLongTile, np = tiles * kLongTile;
  unsigned char* ring = smem;
  unsigned char* qtile = smem + S * T::kPair;  // q's hi, then lo half
  uint64_t* full = reinterpret_cast<uint64_t*>(qtile + T::kPair);
  uint64_t* empty = full + S;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int q0 = kLongTile * blockIdx.x;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      sm::mbar_init(&full[s], 1);
      sm::mbar_init(&empty[s], fl::kFwdConsumerWarps);
    }
    sm::fence_barrier_init();
  }
  // the CTA's 64 query rows, split into swizzled hi and lo tiles (rows past
  // N zero)
  split_rows<D>(qtile, qtile + T::kSub,
                a.qkv + static_cast<size_t>(b) * N * 3 * heads * D + h * D,
                static_cast<size_t>(3) * heads * D, q0, kLongTile, N,
                nullptr, tid, fl::kFwdThreads);
  __syncthreads();

  if (warp == fl::kFwdConsumerWarps) {
    // the producer warp: the 4 T tiles in the order above, each into the
    // next stage once the warpgroup has released it
    if (lane == 0) {
      for (int it = 0; it < 4 * tiles; ++it) {
        const int s = it % S, use = it / S;
        int array = 0, tile = it < tiles ? it : it - tiles;
        if (it >= 2 * tiles) {
          tile = (it - 2 * tiles) >> 1;
          array = ((it - 2 * tiles) & 1) ? 2 : 0;
        }
        if (use > 0) sm::mbar_wait(&empty[s], (use - 1) & 1);
        sm::mbar_expect_tx(&full[s], T::kPair);
        fl::load_pair<D>(ring + s * T::kPair, &map, &full[s], array, bh,
                         gridDim.y, np, kLongTile * tile);
      }
    }
    return;
  }

  const int ra = q0 + 16 * warp + g, rb = ra + 8;
  // the raw scores of the K tile in `tile` (hi, then lo half) for rows ra
  // and rb, s[4 j + e]: row ra (e < 2) or rb, the tile's key 8 j + 2 t + (e
  // % 2) (the wgmma accumulator's layout, which P V's A fragments take):
  // each pass summed over d in order, two d a load of each bf16 pair
  auto scores = [&](const unsigned char* tile, float (&s)[32]) {
    float hh[32], hl[32], lh[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) hh[i] = hl[i] = lh[i] = 0.f;
    const uint32_t oa = (16 * warp + g) * kRow, ob = oa + 8 * kRow;
#pragma unroll 2
    for (int d = 0; d < D; d += 2) {
      const float2 qha = bf16x2_at<kRow>(qtile, oa + 2 * d);
      const float2 qla = bf16x2_at<kRow>(qtile + T::kSub, oa + 2 * d);
      const float2 qhb = bf16x2_at<kRow>(qtile, ob + 2 * d);
      const float2 qlb = bf16x2_at<kRow>(qtile + T::kSub, ob + 2 * d);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e1 = 0; e1 < 2; ++e1) {
          const uint32_t ok = (8 * j + 2 * t + e1) * kRow + 2 * d;
          const float2 kh = bf16x2_at<kRow>(tile, ok);
          const float2 kl = bf16x2_at<kRow>(tile + T::kSub, ok);
          const int ia = 4 * j + e1, ib = ia + 2;
          hh[ia] = __fmaf_rn(qha.y, kh.y, __fmaf_rn(qha.x, kh.x, hh[ia]));
          hl[ia] = __fmaf_rn(qha.y, kl.y, __fmaf_rn(qha.x, kl.x, hl[ia]));
          lh[ia] = __fmaf_rn(qla.y, kh.y, __fmaf_rn(qla.x, kh.x, lh[ia]));
          hh[ib] = __fmaf_rn(qhb.y, kh.y, __fmaf_rn(qhb.x, kh.x, hh[ib]));
          hl[ib] = __fmaf_rn(qhb.y, kl.y, __fmaf_rn(qhb.x, kl.x, hl[ib]));
          lh[ib] = __fmaf_rn(qlb.y, kh.y, __fmaf_rn(qlb.x, kh.x, lh[ib]));
        }
    }
#pragma unroll
    for (int i = 0; i < 32; ++i)
      s[i] = __fadd_rn(__fadd_rn(hh[i], hl[i]), lh[i]);
  };
  // tile kt's score s[i] scaled, or -inf past N
  auto masked = [&](const float (&s)[32], int kt, int i) {
    const int key = kLongTile * kt + 8 * (i >> 2) + 2 * t + (i & 1);
    return key < N ? scaled(s[i], a.scale) : mvt::neg_inf();
  };
  // the K tiles at ring tiles base .. base + tiles - 1, visit(s, kt) on each
  // tile's scores in key order
  auto walk = [&](int base, const auto& visit) {
    for (int kt = 0; kt < tiles; ++kt) {
      const int k = base + kt;
      sm::mbar_wait(&full[k % S], (k / S) & 1);
      float s[32];
      scores(ring + (k % S) * T::kPair, s);
      release(&empty[k % S], lane);
      visit(s, kt);
    }
  };

  float mx0 = mvt::neg_inf(), mx1 = mvt::neg_inf();
  walk(0, [&](const float (&s)[32], int kt) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(fmaxf(mx0, masked(s, kt, 4 * j)), masked(s, kt, 4 * j + 1));
      mx1 = fmaxf(fmaxf(mx1, masked(s, kt, 4 * j + 2)),
                  masked(s, kt, 4 * j + 3));
    }
  });
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
  }

  // four partial sums a row (by the parity of the 8-key block and the pair
  // element), each compensated (Kahan: c carries what the last add lost)
  float part[2][4], comp[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) part[r][c] = comp[r][c] = 0.f;
  auto kahan = [](float& sum, float& c, float x) {
    const float y = __fsub_rn(x, c);
    const float t2 = __fadd_rn(sum, y);
    c = __fsub_rn(__fsub_rn(t2, sum), y);
    sum = t2;
  };
  walk(tiles, [&](const float (&s)[32], int kt) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 2 * (j & 1);
      kahan(part[0][c], comp[0][c], exp_shift(masked(s, kt, 4 * j), mx0));
      kahan(part[0][c + 1], comp[0][c + 1],
            exp_shift(masked(s, kt, 4 * j + 1), mx0));
      kahan(part[1][c], comp[1][c],
            exp_shift(masked(s, kt, 4 * j + 2), mx1));
      kahan(part[1][c + 1], comp[1][c + 1],
            exp_shift(masked(s, kt, 4 * j + 3), mx1));
    }
  });
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    sum0 = __fadd_rn(sum0, __fsub_rn(part[0][c], comp[0][c]));
    sum1 = __fadd_rn(sum1, __fsub_rn(part[1][c], comp[1][c]));
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    sum0 = __fadd_rn(sum0, __shfl_xor_sync(0xffffffffu, sum0, o));
    sum1 = __fadd_rn(sum1, __shfl_xor_sync(0xffffffffu, sum1, o));
  }

  // ---- sweep 3: K tile kt at ring tile 2 T + 2 kt, V tile kt at 2 T + 2
  // kt + 1 ----
  const fl::RowDivisor div0(sum0), div1(sum1);
  auto e_of = [&](const float (&s)[32], int kt, int i) {
    return exp_shift(masked(s, kt, i), (i & 2) ? mx1 : mx0);
  };
  // tile kt's A fragments of p = e / sum from its scores s, split
  auto form = [&](const float (&s)[32], int kt, uint32_t (&ph)[4][4],
                  uint32_t (&pl)[4][4]) {
    float p[32];
    bool slow = false;
#pragma unroll
    for (int i = 0; i < 32; ++i)
      p[i] = ((i & 2) ? div1 : div0).div(e_of(s, kt, i), slow);
    if (slow) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        p[i] = __fdiv_rn(e_of(s, kt, i), (i & 2) ? sum1 : sum0);
    }
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int i = 8 * ks + 2 * w;
        sm::split_bf16x2(p[i], p[i + 1], ph[ks][w], pl[ks][w]);
      }
  };
  auto scores_at = [&](int k, float (&s)[32]) {
    sm::mbar_wait(&full[k % S], (k / S) & 1);
    scores(ring + (k % S) * T::kPair, s);
    release(&empty[k % S], lane);
  };
  float u[D / 2], acc[D / 2], sc[32];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) u[i] = 0.f;
  scores_at(2 * tiles, sc);
  {
    uint32_t ph[4][4], pl[4][4];
    for (int kt = 0; kt < tiles; ++kt) {
      form(sc, kt, ph, pl);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        sm::fence_regs(ph[ks]);
        sm::fence_regs(pl[ks]);
      }
      // tile kt's P V on the tensor cores, V read MN-major (the transpose
      // bit), 16 keys a step, into a fresh accumulator
      const int iv = 2 * tiles + 2 * kt + 1, st = iv % S;
      sm::mbar_wait(&full[st], (iv / S) & 1);
      const unsigned char* th = ring + st * T::kPair;
      const uint64_t dth = sm::rows_desc<D>(th, 0);
      const uint64_t dtl = sm::rows_desc<D>(th + T::kSub, 0);
      sm::wgmma_fence();
      chain3<4>([&](int x, int bl, int ks) {
        sm::WgmmaRS<D>::template mma<1>(
            acc, x ? pl[ks] : ph[ks],
            sm::desc_add(bl ? dtl : dth, ks * 16 * kRow),
            chain_first(x, bl, ks) ? 0 : 1);
      });
      sm::wgmma_commit();
      // tile kt + 1's S while it runs
      if (kt + 1 < tiles) scores_at(2 * tiles + 2 * kt + 2, sc);
      sm::wgmma_wait<0>();
      sm::fence_regs(acc);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        sm::fence_regs(ph[ks]);
        sm::fence_regs(pl[ks]);
      }
      release(&empty[st], lane);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) u[i] = __fadd_rn(u[i], acc[i]);
    }
  }
  store_context<D>(a, qs, u, b, h, bh, ra, rb, t, mx0, mx1, sum0, sum1);
}

template <int D>
const void* kernel_of(bool sweep) {
  return sweep ? reinterpret_cast<const void*>(
                     attention_core_f32_sweep_kernel<D>)
               : reinterpret_cast<const void*>(
                     attention_core_f32_long_kernel<D>);
}

template <int D>
int set_smem(bool sweep) {
  static unsigned done[2] = {0, 0};
  return fl::allow_smem_once(kernel_of<D>(sweep), &done[sweep ? 1 : 0]);
}

// the core kernel's ring stages and dynamic shared memory at N tokens
template <int D>
int stages_of(int N, bool sweep) {
  return sweep ? fl::kFwdMaxStages : fl::fwd_stages<D>(N);
}
template <int D>
int smem_of(int N, bool sweep) {
  return sweep ? fl::sweep_smem<D>() : fl::fwd_smem<D>(N);
}

template <int D>
int launch(const void* qkv, const void* site, void* out, void* m, void* rs,
           void* split, int B, int N, int heads, float scale, int mode,
           mvt::QSpec qs, bool sweep, int* launched, cudaStream_t stream) {
  CUtensorMap map;
  int err = fl::encode_split<D>(&map, split, 4, B, heads, N);
  if (err == 0) err = set_smem<D>(sweep);
  if (err != 0) return err;
  f32_long_kv_split_kernel<D>
      <<<fl::split_blocks(B, N, heads, D, 2), 256, 0, stream>>>(
          static_cast<const float*>(qkv), static_cast<uint4*>(split), B, N,
          heads);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  *launched = 1;
  Args a;
  a.qkv = static_cast<const float*>(qkv);
  a.site = static_cast<const float*>(site);
  a.out = out;
  a.m_out = static_cast<float*>(m);
  a.rs_out = static_cast<float*>(rs);
  a.n = N;
  a.heads = heads;
  a.stages = stages_of<D>(N, sweep);
  a.mode = mode;
  a.scale = scale;
  const dim3 grid((N + kLongTile - 1) / kLongTile, B * heads);
  if (sweep)
    attention_core_f32_sweep_kernel<D>
        <<<grid, fl::kFwdThreads, fl::sweep_smem<D>(), stream>>>(map, a, qs);
  else
    attention_core_f32_long_kernel<D>
        <<<grid, fl::kFwdThreads, fl::fwd_smem<D>(N), stream>>>(map, a, qs);
  e = cudaGetLastError();
  if (e == cudaSuccess) *launched = 2;
  return static_cast<int>(e);
}

// the three-sweep design above kBlockMaxN, or at any N where forced
int launch_d(const void* qkv, const void* site, void* out, void* m,
             void* rs, void* split, int B, int N, int heads, int D,
             float scale, int mode, mvt::QSpec qs, int force_sweep,
             int* launched, cudaStream_t stream) {
  *launched = 0;
  if (B <= 0 || heads <= 0 || N <= 0 || N > kLongMaxN ||
      static_cast<long long>(B) * heads > 65535 ||
      (m == nullptr) != (rs == nullptr) || split == nullptr ||
      reinterpret_cast<uintptr_t>(qkv) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(split) % 16 != 0 ||
      (mode != kSnapFloat && site == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool sweep = force_sweep != 0 || N > kBlockMaxN;
  if (D == 64)
    return launch<64>(qkv, site, out, m, rs, split, B, N, heads, scale, mode,
                      qs, sweep, launched, stream);
  if (D == 32)
    return launch<32>(qkv, site, out, m, rs, split, B, N, heads, scale, mode,
                      qs, sweep, launched, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int D>
int fwd_figures(int N, bool sweep, int* f) {
  int err = set_smem<D>(sweep);
  int ctas = 0;
  if (err == 0)
    err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &ctas, kernel_of<D>(sweep), fl::kFwdThreads, smem_of<D>(N, sweep)));
  if (err != 0) return err;
  const int v[7] = {(N + kLongTile - 1) / kLongTile, kLongTile, kLongTile,
                    fl::kFwdThreads, stages_of<D>(N, sweep),
                    smem_of<D>(N, sweep), ctas};
  for (int i = 0; i < 7; ++i) f[i] = v[i];
  return 0;
}

}  // namespace

MVT_EXPORT int mvt_attention_core_f32_long_max_n() { return kLongMaxN; }

// the longest sequence of the forward's score-block design; above it, the
// three-sweep design
MVT_EXPORT int mvt_attention_core_f32_long_block_max_n() { return kBlockMaxN; }

// qkv (B, N, 3C) fp32, 16-byte aligned; out (B, N, C) fp32, the context
// through the snap policy: site, the (3,) fp32 row (scale, zero point,
// has_stats) of the INT8 site table on the device, or null for the
// FloatingPoint(exp_bits, man_bits) snap; m and rs (B, H, N) fp32, the
// rowmax and reciprocal rowsum, or both null; split the scratch (4, B, H,
// N_pad, D) bf16 of K's and V's halves, 16-byte aligned; D = C / heads of
// 32 or 64, 1 <= N <= mvt_attention_core_f32_long_max_n(); sweep nonzero
// takes the three-sweep design at any N (above
// mvt_attention_core_f32_long_block_max_n() it always does).  *launched:
// the kernels launched (2 on success).
MVT_EXPORT int mvt_attention_core_f32_long(const void* qkv, void* out,
                                           void* m, void* rs, void* split,
                                           int B, int N, int heads, int D,
                                           float scale, int exp_bits,
                                           int man_bits, const void* site,
                                           int sweep, int* launched,
                                           void* stream) {
  *launched = 0;
  if (site == nullptr && !mvt::float_fmt_ok(exp_bits, man_bits))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_d(qkv, site, out, m, rs, split, B, N, heads, D, scale,
                  site != nullptr ? kSnapSite : kSnapFloat,
                  site != nullptr ? mvt::QSpec(8, 22, 0)
                                  : mvt::QSpec(exp_bits, man_bits, 0),
                  sweep, launched, static_cast<cudaStream_t>(stream));
}

// qkv (B, N, 3C) fp32, 16-byte aligned; site the (scale, zero point,
// has_stats) fp32 row of the output grid; out (B, N, C) int8 (the
// converted INT8 block's core, mvt_attention_core_f32 above its limit);
// split, sweep and *launched as for mvt_attention_core_f32_long
MVT_EXPORT int mvt_attention_core_f32_long_i8(const void* qkv,
                                              const void* site, void* out,
                                              void* split, int B, int N,
                                              int heads, int D, float scale,
                                              int sweep, int* launched,
                                              void* stream) {
  return launch_d(qkv, site, out, nullptr, nullptr, split, B, N, heads, D,
                  scale, kInt8, mvt::QSpec(8, 22, 0), sweep, launched,
                  static_cast<cudaStream_t>(stream));
}

// the backward's figures into f[0..14] (attention_core_f32_bwd_long_wgmma.cu)
int f32_long_bwd_figures(int N, int D, int* f);

// The launch figures of N tokens at head width D into f[0..22]: for the
// forward's core kernel (the three-sweep design where sweep is nonzero or
// N > mvt_attention_core_f32_long_block_max_n()), the dq and the dk / dv
// kernel in turn, seven each: CTAs per (image, head), the CTA's own rows,
// the walked tile's rows, threads, ring stages, dynamic shared memory
// bytes and the CTAs an SM that the runtime fits; then the kernels a
// backward call launches and a forward call launches.  Returns a
// cudaError_t value.
MVT_EXPORT int mvt_attention_core_f32_long_plan(int N, int D, int sweep,
                                                int* f) {
  if (N <= 0 || N > kLongMaxN || (D != 64 && D != 32))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool sw = sweep != 0 || N > kBlockMaxN;
  const int err = D == 64 ? fwd_figures<64>(N, sw, f)
                          : fwd_figures<32>(N, sw, f);
  if (err != 0) return err;
  f[22] = 2;
  return f32_long_bwd_figures(N, D, f + 7);
}
