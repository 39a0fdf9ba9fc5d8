// attention_core_f32 above 256 tokens on Hopper: the fp32 softmax
// attention core of the float-format and INT8 QAT attention blocks (and of
// float32 compute, whose site table snaps nothing), ending on the
// to_out.act_in snap or the quant_out site, and of the converted INT8
// attention block, ending on the int8 grid of its quant_out site, from 257
// to 1837 tokens: the score-block design up to 768, the cluster design
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
// (attention_f32_tiles.cuh).
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
// The cluster design (attention_core_f32_cluster_kernel below), the same
// two launches, above 768 tokens: a cluster of up to 8 CTAs shares 64
// queries and splits the keys, each CTA holding its keys' slice of the
// score block, so every score is computed once.  Its scores are not a
// tensor-core chain but the plain version's in-order fp32 sums on the FMA
// units (see there); P V stays on wgmma.  What bounds it: at (2, 3, 1001,
// 64) S once is 1.18e9 fp32 FMAs (keys padded to the tile; 0.035 ms at
// 67 TFLOP/s), the bf16 tensor-core work of S and P V 0.0047 ms.  On one
// H100 80GB HBM3 at 700 W the core takes about 0.14 ms there (0.48 for a
// design that computed S three times): 384 CTAs of 4-CTA clusters, 120 at
// once (the runtime fits 30 such clusters), so 4 waves of about 34 us.  A
// CTA's phases run in series (cycles, tools/perf/cluster_stamps.py):
// S 38K at about 64% of an SM's FMA rate, the K tiles' conversion 4.6K,
// the q rows 2.7K, the exponentials and rowsum 5.3K, P V 5.1K, the three
// cluster barriers with their exchanges 1.6-4.3K each, the epilogue 1.4K.
// The S loop alone runs at 68% of the FMA rate, 78% with half its shared
// memory loads, 55% with a 4 x 4 register tile and 58% with q in
// registers and K broadcast (tools/perf/s_loop_bench.py).
// ptxas -v: 254 registers a thread, no spills; 231,488 bytes of dynamic
// shared memory at D = 64 and 4 key tiles a CTA.
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
  int cluster;  // the cluster design's CTAs a cluster (1 for the score block)
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

// the output grid's (int8) or the INT8 QAT site's row: scale 1 and zero
// point 128 where the site has no statistics (the guard of `_quantize_i8`)
struct Site {
  float s = 1.0f, zp = 128.0f, has = 0.f;
  __device__ __forceinline__ explicit Site(const Args& a) {
    if (a.mode != kSnapFloat && a.site[2] > 0.5f) {
      s = a.site[0];
      zp = a.site[1];
      has = a.site[2];
    }
  }
};

// a context value on the int8 grid: clip(rint(x / s) + zp, 0, 255) - 128
__device__ __forceinline__ signed char grid_int8(float x, const Site& st) {
  const float y =
      fminf(fmaxf(__fadd_rn(rintf(__fdiv_rn(x, st.s)), st.zp), 0.f), 255.f);
  return static_cast<signed char>(static_cast<int>(y) - 128);
}

// a context value through the snap modes' epilogue
__device__ __forceinline__ float snapped(const Args& a, const mvt::QSpec& qs,
                                         float x, const Site& st) {
  return a.mode == kSnapFloat ? mvt::snap(x, qs)
                              : mvt::int8_site_snap(x, st.s, st.zp, st.has);
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
  const Site st(a);
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
        char2 c;
        c.x = grid_int8(x0, st);
        c.y = grid_int8(x1, st);
        *reinterpret_cast<char2*>(static_cast<signed char*>(a.out) + o) = c;
      } else {
        *reinterpret_cast<float2*>(static_cast<float*>(a.out) + o) =
            make_float2(snapped(a, qs, x0, st), snapped(a, qs, x1, st));
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

// ---- the cluster design: its cluster and distributed shared memory ----

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}

// every thread of every CTA of the cluster arrives and waits; the shared
// memory that each wrote before is then visible to the others' loads
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// the address of `p`, in this CTA's shared memory, in CTA `rank`'s
__device__ __forceinline__ uint32_t at_rank(const void* p, int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"(sm::smem_u32(p)), "r"(rank));
  return a;
}

__device__ __forceinline__ float ld_cluster(uint32_t a) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v)
               : "r"(a)
               : "memory");
  return v;
}

__device__ __forceinline__ float2 ld_cluster2(uint32_t a) {
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(a)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_cluster2(uint32_t a, float x, float y) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(a),
               "f"(x), "f"(y)
               : "memory");
}

// the bf16 values of a packed pair as fp32: the low half, the high half
__device__ __forceinline__ float bf16_low(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_high(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// component e (0-3, a constant once unrolled) of a float4
__device__ __forceinline__ float lane_of(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// A compensated sum as a pair (hi, lo), hi + lo the sum to about twice
// fp32's precision: hi the running fp32 sum, lo the exact errors of its
// adds (TwoSum) summed.  pair_add(a, b) and pair_add(b, a) give the same
// bits (TwoSum's error is exact), so the lanes of a butterfly agree.
__device__ __forceinline__ void pair_add(float& hi, float& lo, float h2,
                                         float l2) {
  const float t = __fadd_rn(hi, h2);
  const float bp = __fsub_rn(t, hi);
  const float err =
      __fadd_rn(__fsub_rn(hi, __fsub_rn(t, bp)), __fsub_rn(h2, bp));
  hi = t;
  lo = __fadd_rn(__fadd_rn(lo, l2), err);
}

// The cluster design (above kBlockMaxN, or forced): the same function,
// each score computed once.  A cluster of CL CTAs (fl::sweep_cluster: 1, 2,
// 4 or 8 by the key tiles, the (image, head) pairs and the SMs) shares 64
// queries of one (image, head); CTA `rank` holds the keys of RT = ceil(tiles
// / CL) consecutive 64-key tiles from tile rank RT (the last ranks fewer,
// or none), eight warps, two an SMSP.  Thread 0 issues every K tile's
// load at once, each into a ring stage of its own, then each V tile into
// the same stage once its K tile is read.
//   S        two K tiles at a time: their bf16 halves converted once to
//            fp32 rows in shared memory (no FMA waits on a conversion),
//            then warps 0-3 the first tile, 4-7 the second, a thread 4 rows
//            x 8 keys, three passes of 32 accumulators: the plain version's
//            in-order fp32 sums over d, one FMA a term (each product of two
//            bf16 halves is exact), q and K read four d at a time (16-byte
//            loads, the 8 rows or 4 keys of a load at distinct bank quads),
//            then (hi.hi + hi.lo) + lo.hi and the scale, keys past N -inf,
//            stored in the CTA's 64 x 64 RT fp32 score block; the thread's
//            row maxima on the way;
//   max      the CTA's row maxima, then the cluster's, read through
//            distributed shared memory (the max is exact in any order);
//   sum      e = exp(s - m) in place, with the row's final m; each lane a
//            compensated (hi, lo) pair over its keys for 8 rows at once,
//            the lanes' pairs and then the ranks' in rank order, exactly,
//            so that every rank holds the same sum = hi + lo, within about
//            half an ulp of the exact sum of the e (a rescaled online sum
//            would move every p);
//   P V      warpgroup w of each CTA the first or second half of its
//            tiles: the tile's A fragments of p = e / sum (the true divide,
//            RowDivisor) split in registers, its chain3 into a fresh
//            accumulator added to the warpgroup's context rounded once, the
//            next tile's fragments formed while the chain runs;
//   context  each warpgroup's partial context, (64, D) fp32, pushed to the
//            rank that owns its rows (rank r the rows r 64 / CL ...), which
//            adds the 2 CL partials in (rank, warpgroup) order and runs the
//            mode's epilogue.
// Three cluster barriers: after the CTAs' maxima, their rowsums, and the
// pushed partials; after the last no CTA reads another's shared memory.
// No atomics: two calls give the same bits.  S, m and e are the plain
// version's bit for bit; the rowsum and P V part from it by fp32 roundoff
// (tests/test_torch_f32_sweep_order.py emulates this order on the CPU).
// The tensor cores truncate as they accumulate, so S does not run on
// them: at one head past 1000 tokens their scores alone put 0.20-0.21% of
// a snapped context a format step from the plain version's, over the float
// formats' 0.2% bar.
template <int D>
__global__ void __launch_bounds__(fl::kSweepThreads, 1)
attention_core_f32_cluster_kernel(const __grid_constant__ CUtensorMap map,
                                  const Args a, const mvt::QSpec qs) {
  using T = fl::Tiles<D>;
  constexpr int kRow = T::kRow;
  constexpr int kThreads = fl::kSweepThreads;
  constexpr int kChunks = D / 4;  // 16-byte chunks of a fp32 row
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (sm::smem_u32(smem_raw) & 1023)) & 1023);
  const int N = a.n, heads = a.heads, RT = a.stages, CL = a.cluster;
  const int tiles = (N + kLongTile - 1) / kLongTile, np = tiles * kLongTile;
  const int SLD = fl::sweep_score_ld(RT);
  unsigned char* ring = smem;
  float* q32 = reinterpret_cast<float*>(smem + RT * T::kPair);  // (2, 64, D)
  float* k32 = q32 + 2 * kLongTile * D;  // (2, 128, D)
  float* sc = k32 + 2 * 2 * kLongTile * D;
  uint64_t* full = reinterpret_cast<uint64_t*>(sc + kLongTile * SLD);
  // once S is done: the row statistics in the K rows' room, the pushed
  // partial contexts (2 CL, 64 / CL, D), slot 2 rank + warpgroup, in q's
  float* wmax = k32;  // (8 warps, 32 rows)
  float* xmax = wmax + fl::kSweepWarps * 32;
  float2* xsum = reinterpret_cast<float2*>(xmax + kLongTile);
  float* mfin = reinterpret_cast<float*>(xsum + kLongTile);
  float* sfin = mfin + kLongTile;
  float* part = q32;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int rank = cluster_rank();
  const int q0 = kLongTile * (blockIdx.x / CL);
  const int first = rank * RT;  // the rank's first key tile
  const int own = max(0, min(RT, tiles - first));

  if (tid == 0) {
    for (int i = 0; i < own; ++i) sm::mbar_init(&full[i], 1);
    sm::fence_barrier_init();
    for (int i = 0; i < own; ++i) {
      sm::mbar_expect_tx(&full[i], T::kPair);
      fl::load_pair<D>(ring + i * T::kPair, &map, &full[i], 0, bh, gridDim.y,
                       np, kLongTile * (first + i));
    }
  }
  // the 64 query rows' hi and lo halves as fp32 rows (rows past N zero)
  {
    const size_t ld = static_cast<size_t>(3) * heads * D;
    const float* base = a.qkv + static_cast<size_t>(b) * N * ld + h * D;
#pragma unroll
    for (int k = 0; k < kLongTile * kChunks / kThreads; ++k) {
      const int it = tid + k * kThreads;
      const int r = it / kChunks, j = it % kChunks;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q0 + r < N)
        x = *reinterpret_cast<const float4*>(base + (q0 + r) * ld + 4 * j);
      uint32_t h0, l0, h1, l1;
      sm::split_bf16x2(x.x, x.y, h0, l0);
      sm::split_bf16x2(x.z, x.w, h1, l1);
      float* dst = q32 + r * D + 4 * (j ^ (r & 7));
      *reinterpret_cast<float4*>(dst) = make_float4(
          bf16_low(h0), bf16_high(h0), bf16_low(h1), bf16_high(h1));
      *reinterpret_cast<float4*>(dst + kLongTile * D) = make_float4(
          bf16_low(l0), bf16_high(l0), bf16_low(l1), bf16_high(l1));
    }
  }
  __syncthreads();

  // ---- S, two tiles a step: warp w the step's tile w / 4, its rows 32
  // ((w / 2) % 2) + g + 8 x and keys 32 (w % 2) + c + 4 y (x < 4, y < 8) ----
  const int g = lane >> 2, c = lane & 3;
  const int sub = warp >> 2;
  const int r0 = 32 * ((warp >> 1) & 1) + g, k0 = 32 * (warp & 1) + c;
  float mx[4];
#pragma unroll
  for (int x = 0; x < 4; ++x) mx[x] = mvt::neg_inf();
  for (int i = 0; i < own; i += 2) {
    const int pair = min(2, own - i);
    for (int p = 0; p < pair; ++p) sm::mbar_wait(&full[i + p], 0);
    {
      // every chunk read first, then every chunk written
      constexpr int kHalf = kLongTile * (D / 8);  // 16-byte chunks a half
      constexpr int kEach = 2 * 2 * kHalf / kThreads;
      uint4 w[kEach];
#pragma unroll
      for (int k = 0; k < kEach; ++k) {
        const int it = tid + k * kThreads;
        const int p = it / (2 * kHalf), half = (it / kHalf) & 1;
        const int r = (it % kHalf) / (D / 8), c8 = it % (D / 8);
        if (p < pair)
          w[k] = *reinterpret_cast<const uint4*>(
              ring + (i + p) * T::kPair + half * T::kSub +
              sm::swizzle_chunk<kRow>(r * kRow + 16 * c8));
      }
#pragma unroll
      for (int k = 0; k < kEach; ++k) {
        const int it = tid + k * kThreads;
        const int p = it / (2 * kHalf), half = (it / kHalf) & 1;
        const int r = (it % kHalf) / (D / 8), c8 = it % (D / 8);
        const int key = kLongTile * p + r;
        float* dst = k32 + (half * 2 * kLongTile + key) * D;
        if (p < pair) {
          *reinterpret_cast<float4*>(dst + 4 * ((2 * c8) ^ (key & 7))) =
              make_float4(bf16_low(w[k].x), bf16_high(w[k].x),
                          bf16_low(w[k].y), bf16_high(w[k].y));
          *reinterpret_cast<float4*>(dst + 4 * ((2 * c8 + 1) ^ (key & 7))) =
              make_float4(bf16_low(w[k].z), bf16_high(w[k].z),
                          bf16_low(w[k].w), bf16_high(w[k].w));
        }
      }
    }
    __syncthreads();
    if (tid == 0) {
      // the stages are read: the V tiles land there while S runs
      sm::fence_proxy_async();
      for (int p = 0; p < pair; ++p) {
        sm::mbar_expect_tx(&full[i + p], T::kPair);
        fl::load_pair<D>(ring + (i + p) * T::kPair, &map, &full[i + p], 2,
                         bh, gridDim.y, np, kLongTile * (first + i + p));
      }
    }
    if (sub < pair) {
      float hh[4][8], hl[4][8], lh[4][8];
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 8; ++y) hh[x][y] = hl[x][y] = lh[x][y] = 0.f;
      const float* qa = q32 + r0 * D;
      const float* ka = k32 + (kLongTile * sub + k0) * D;
#pragma unroll 2
      for (int j = 0; j < kChunks; ++j) {
        // row r0 + 8 x has r0 % 8 = g; key k0 + 4 y has (c + 4 y) % 8
        float4 qh[4], ql[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const float* row = qa + 8 * x * D + 4 * (j ^ g);
          qh[x] = *reinterpret_cast<const float4*>(row);
          ql[x] = *reinterpret_cast<const float4*>(row + kLongTile * D);
        }
#pragma unroll
        for (int y = 0; y < 8; ++y) {
          const float* key = ka + 4 * y * D + 4 * (j ^ ((c + 4 * y) & 7));
          const float4 kh = *reinterpret_cast<const float4*>(key);
          const float4 kl =
              *reinterpret_cast<const float4*>(key + 2 * kLongTile * D);
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int x = 0; x < 4; ++x) {
              const float a_h = lane_of(qh[x], e), a_l = lane_of(ql[x], e);
              const float b_h = lane_of(kh, e), b_l = lane_of(kl, e);
              hh[x][y] = __fmaf_rn(a_h, b_h, hh[x][y]);
              hl[x][y] = __fmaf_rn(a_h, b_l, hl[x][y]);
              lh[x][y] = __fmaf_rn(a_l, b_h, lh[x][y]);
            }
        }
      }
      const int t0 = i + sub;  // the CTA's tile
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 8; ++y) {
          const int key = k0 + 4 * y;
          const float s =
              kLongTile * (first + t0) + key < N
                  ? scaled(__fadd_rn(__fadd_rn(hh[x][y], hl[x][y]), lh[x][y]),
                           a.scale)
                  : mvt::neg_inf();
          sc[(r0 + 8 * x) * SLD + kLongTile * t0 + key] = s;
          mx[x] = fmaxf(mx[x], s);
        }
    }
    __syncthreads();  // the scores stored, the K rows free again
  }

  // ---- the row max: the CTA's (the warps' maxima, 4 warps a row), then
  // the cluster's, read from every rank ----
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    mx[x] = fmaxf(mx[x], __shfl_xor_sync(0xffffffffu, mx[x], 1));
    mx[x] = fmaxf(mx[x], __shfl_xor_sync(0xffffffffu, mx[x], 2));
    if (c == 0) wmax[warp * 32 + g + 8 * x] = mx[x];
  }
  __syncthreads();
  if (tid < kLongTile) {
    float m = mvt::neg_inf();
    for (int w = 0; w < fl::kSweepWarps; ++w)
      if (((w >> 1) & 1) == (tid >> 5)) m = fmaxf(m, wmax[w * 32 + (tid & 31)]);
    xmax[tid] = m;
  }
  cluster_sync();
  if (tid < kLongTile) {
    // every rank's value read first, then reduced
    float v[fl::kSweepMaxCluster];
#pragma unroll
    for (int q = 0; q < fl::kSweepMaxCluster; ++q)
      if (q < CL) v[q] = ld_cluster(at_rank(xmax + tid, q));
    float m = mvt::neg_inf();
#pragma unroll
    for (int q = 0; q < fl::kSweepMaxCluster; ++q)
      if (q < CL) m = fmaxf(m, v[q]);
    mfin[tid] = m;
  }
  __syncthreads();

  // ---- e = exp(s - m) in place and the rowsum: warp w's rows 8 w .. 8 w
  // + 7 at once, a compensated pair a lane and row, the lanes' pairs, then
  // the ranks' in rank order ----
  {
    const int keys = kLongTile * own;
    float m[8], hi[8], lo[8];
#pragma unroll
    for (int rr = 0; rr < 8; ++rr) {
      m[rr] = mfin[8 * warp + rr];
      hi[rr] = lo[rr] = 0.f;
    }
    float* cell = sc + 8 * warp * SLD + lane;
    for (int k = lane; k < keys; k += 32, cell += 32) {
      // the 8 rows' scores read first, then exponentiated and written back
      float e[8];
#pragma unroll
      for (int rr = 0; rr < 8; ++rr) e[rr] = cell[rr * SLD];
#pragma unroll
      for (int rr = 0; rr < 8; ++rr) {
        e[rr] = exp_shift(e[rr], m[rr]);
        cell[rr * SLD] = e[rr];
        pair_add(hi[rr], lo[rr], e[rr], 0.f);
      }
    }
#pragma unroll
    for (int rr = 0; rr < 8; ++rr) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float oh = __shfl_xor_sync(0xffffffffu, hi[rr], o);
        const float ol = __shfl_xor_sync(0xffffffffu, lo[rr], o);
        pair_add(hi[rr], lo[rr], oh, ol);
      }
      if (lane == 0) xsum[8 * warp + rr] = make_float2(hi[rr], lo[rr]);
    }
  }
  cluster_sync();
  if (tid < kLongTile) {
    float2 v[fl::kSweepMaxCluster];
#pragma unroll
    for (int q = 0; q < fl::kSweepMaxCluster; ++q)
      if (q < CL) v[q] = ld_cluster2(at_rank(xsum + tid, q));
    float hi = 0.f, lo = 0.f;
#pragma unroll
    for (int q = 0; q < fl::kSweepMaxCluster; ++q)
      if (q < CL) pair_add(hi, lo, v[q].x, v[q].y);
    sfin[tid] = __fadd_rn(hi, lo);
  }
  __syncthreads();

  // ---- P V: warpgroup wg the tiles [lo_t, hi_t) of the CTA's; a tile's A
  // fragments (step ks holds its keys 16 ks + 8 (w / 2) + 2 t + {0, 1}, word
  // w rows ra (w even) or rb) of p = e / sum, split; V read MN-major (the
  // transpose bit), 16 keys a step, into a fresh accumulator ----
  const int wg = warp >> 2, t = lane & 3;
  const int ra = 16 * (warp & 3) + g, rb = ra + 8;
  const float sum0 = sfin[ra], sum1 = sfin[rb];
  const fl::RowDivisor div0(sum0), div1(sum1);
  const int mid = (own + 1) / 2;
  const int lo_t = wg ? mid : 0, hi_t = wg ? own : mid;
  auto form = [&](uint32_t (&ph)[4][4], uint32_t (&pl)[4][4], int i) {
    float p[32];
    bool slow = false;
    const float* ea = sc + ra * SLD + kLongTile * i + 2 * t;
    const float* eb = sc + rb * SLD + kLongTile * i + 2 * t;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 xa = *reinterpret_cast<const float2*>(ea + 8 * j);
      const float2 xb = *reinterpret_cast<const float2*>(eb + 8 * j);
      p[4 * j] = div0.div(xa.x, slow);
      p[4 * j + 1] = div0.div(xa.y, slow);
      p[4 * j + 2] = div1.div(xb.x, slow);
      p[4 * j + 3] = div1.div(xb.y, slow);
    }
    if (slow) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 xa = *reinterpret_cast<const float2*>(ea + 8 * j);
        const float2 xb = *reinterpret_cast<const float2*>(eb + 8 * j);
        p[4 * j] = __fdiv_rn(xa.x, sum0);
        p[4 * j + 1] = __fdiv_rn(xa.y, sum0);
        p[4 * j + 2] = __fdiv_rn(xb.x, sum1);
        p[4 * j + 3] = __fdiv_rn(xb.y, sum1);
      }
    }
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int k = 8 * ks + 2 * w;
        sm::split_bf16x2(p[k], p[k + 1], ph[ks][w], pl[ks][w]);
      }
  };
  float u[D / 2], acc[D / 2];
#pragma unroll
  for (int k = 0; k < D / 2; ++k) u[k] = 0.f;
  {
    uint32_t fah[4][4], fal[4][4], fbh[4][4], fbl[4][4];
    if (lo_t < hi_t) form(fah, fal, lo_t);
    for (int i = lo_t; i < hi_t; ++i) {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        sm::fence_regs(fah[ks]);
        sm::fence_regs(fal[ks]);
      }
      sm::mbar_wait(&full[i], 1);
      const unsigned char* tv = ring + i * T::kPair;
      const uint64_t dth = sm::rows_desc<D>(tv, 0);
      const uint64_t dtl = sm::rows_desc<D>(tv + T::kSub, 0);
      sm::wgmma_fence();
      chain3<4>([&](int x, int bl, int ks) {
        sm::WgmmaRS<D>::template mma<1>(
            acc, x ? fal[ks] : fah[ks],
            sm::desc_add(bl ? dtl : dth, ks * 16 * kRow),
            chain_first(x, bl, ks) ? 0 : 1);
      });
      sm::wgmma_commit();
      // the next tile's fragments while the chain runs
      if (i + 1 < hi_t) form(fbh, fbl, i + 1);
      sm::wgmma_wait<0>();
      sm::fence_regs(acc);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        sm::fence_regs(fah[ks]);
        sm::fence_regs(fal[ks]);
      }
#pragma unroll
      for (int k = 0; k < D / 2; ++k) u[k] = __fadd_rn(u[k], acc[k]);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          fah[ks][w] = fbh[ks][w];
          fal[ks][w] = fbl[ks][w];
        }
    }
  }

  // ---- the partial context to the ranks that own its rows, u[4 j + e]
  // row ra (e < 2) or rb, column 8 j + 2 t + (e % 2) ----
  const int rows = kLongTile / CL;  // a rank's rows
  {
    const int slot = 2 * rank + wg;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = half ? rb : ra;
      const int owner = row / rows;
      float* dst = part + (slot * rows + row % rows) * D + 2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        st_cluster2(at_rank(dst + 8 * j, owner), u[4 * j + 2 * half],
                    u[4 * j + 2 * half + 1]);
    }
  }
  cluster_sync();

  // ---- this rank's rows: the 2 CL partials in (rank, warpgroup) order,
  // four columns a step, then the epilogue ----
  {
    const int C = heads * D;
    const Site st(a);
    for (int it = tid; it < rows * (D / 4); it += kThreads) {
      const int r = it / (D / 4), col = 4 * (it % (D / 4));
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int slot = 0; slot < 2 * CL; ++slot) {
        const float4 x =
            *reinterpret_cast<const float4*>(part + (slot * rows + r) * D + col);
        v = make_float4(__fadd_rn(v.x, x.x), __fadd_rn(v.y, x.y),
                        __fadd_rn(v.z, x.z), __fadd_rn(v.w, x.w));
      }
      const int lr = rank * rows + r, row = q0 + lr;
      if (row >= N) continue;
      const size_t o = (static_cast<size_t>(b) * N + row) * C + h * D + col;
      if (a.mode == kInt8) {
        *reinterpret_cast<char4*>(static_cast<signed char*>(a.out) + o) =
            make_char4(grid_int8(v.x, st), grid_int8(v.y, st),
                       grid_int8(v.z, st), grid_int8(v.w, st));
      } else {
        *reinterpret_cast<float4*>(static_cast<float*>(a.out) + o) =
            make_float4(snapped(a, qs, v.x, st), snapped(a, qs, v.y, st),
                        snapped(a, qs, v.z, st), snapped(a, qs, v.w, st));
      }
      if (a.m_out != nullptr && col == 0) {
        const size_t so = static_cast<size_t>(bh) * N + row;
        a.m_out[so] = mfin[lr];
        a.rs_out[so] = __fdiv_rn(1.0f, sfin[lr]);
      }
    }
  }
}

template <int D>
const void* kernel_of(bool sweep) {
  return sweep ? reinterpret_cast<const void*>(
                     attention_core_f32_cluster_kernel<D>)
               : reinterpret_cast<const void*>(
                     attention_core_f32_long_kernel<D>);
}

template <int D>
int set_smem(bool sweep) {
  static unsigned done[2] = {0, 0};
  return fl::allow_smem_once(kernel_of<D>(sweep), &done[sweep ? 1 : 0]);
}

// the SMs of the current device, read once a device; 0 on an error
inline int device_sms() {
  static int sms[32] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  int& n = sms[dev & 31];
  if (n == 0 &&
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    n = 0;
  return n;
}

// How the core kernel covers N tokens of bh (image, head) pairs: its
// cluster, ring stages (the cluster design's key tiles a CTA), CTAs per
// (image, head), threads and dynamic shared memory
struct Shape {
  int cluster, stages, grid, threads, smem;
};

template <int D>
Shape shape_of(int N, int bh, bool sweep) {
  const int tiles = (N + kLongTile - 1) / kLongTile;
  if (!sweep)
    return {1, fl::fwd_stages<D>(N), tiles, fl::kFwdThreads,
            fl::fwd_smem<D>(N)};
  const int cl =
      fl::sweep_cluster(tiles, bh, device_sms(), fl::sweep_max_tiles<D>());
  const int rt = (tiles + cl - 1) / cl;
  return {cl, rt, tiles * cl, fl::kSweepThreads, fl::sweep_smem<D>(rt)};
}

// the core kernel's launch configuration (its cluster attribute in `attr`)
inline cudaLaunchConfig_t config_of(const Shape& sh, int bh,
                                    cudaLaunchAttribute* attr,
                                    cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(sh.grid, bh);
  cfg.blockDim = dim3(sh.threads);
  cfg.dynamicSmemBytes = sh.smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = sh.cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int D>
int launch(const void* qkv, const void* site, void* out, void* m, void* rs,
           void* split, int B, int N, int heads, float scale, int mode,
           mvt::QSpec qs, bool sweep, int* launched, cudaStream_t stream) {
  CUtensorMap map;
  int err = fl::encode_split<D>(&map, split, 4, B, heads, N);
  if (err == 0) err = set_smem<D>(sweep);
  if (err != 0) return err;
  const Shape sh = shape_of<D>(N, B * heads, sweep);
  if (sh.cluster == 0) return static_cast<int>(cudaErrorInvalidValue);
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
  a.stages = sh.stages;
  a.mode = mode;
  a.cluster = sh.cluster;
  a.scale = scale;
  if (sweep) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = config_of(sh, B * heads, &attr, stream);
    void* args[3] = {&map, &a, &qs};
    e = cudaLaunchKernelExC(&cfg, kernel_of<D>(true), args);
  } else {
    attention_core_f32_long_kernel<D>
        <<<dim3(sh.grid, B * heads), sh.threads, sh.smem, stream>>>(map, a,
                                                                    qs);
    e = cudaGetLastError();
  }
  if (e == cudaSuccess) *launched = 2;
  return static_cast<int>(e);
}

// the cluster design above kBlockMaxN, or at any N where forced
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
int fwd_figures(int N, int bh, bool sweep, int* f) {
  int err = set_smem<D>(sweep);
  if (err != 0) return err;
  const Shape sh = shape_of<D>(N, bh, sweep);
  if (sh.cluster == 0) return static_cast<int>(cudaErrorInvalidValue);
  int ctas = 0, clusters = 0;
  err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &ctas, kernel_of<D>(sweep), sh.threads, sh.smem));
  if (err == 0 && sweep) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = config_of(sh, bh, &attr, nullptr);
    err = static_cast<int>(
        cudaOccupancyMaxActiveClusters(&clusters, kernel_of<D>(true), &cfg));
  }
  if (err != 0) return err;
  const int v[7] = {sh.grid,   kLongTile, kLongTile, sh.threads,
                    sh.stages, sh.smem,   ctas};
  for (int i = 0; i < 7; ++i) f[i] = v[i];
  f[23] = sh.cluster;
  f[24] = clusters;
  return 0;
}

}  // namespace

MVT_EXPORT int mvt_attention_core_f32_long_max_n() { return kLongMaxN; }

// the longest sequence of the forward's score-block design; above it, the
// cluster design
MVT_EXPORT int mvt_attention_core_f32_long_block_max_n() { return kBlockMaxN; }

// qkv (B, N, 3C) fp32, 16-byte aligned; out (B, N, C) fp32, the context
// through the snap policy: site, the (3,) fp32 row (scale, zero point,
// has_stats) of the INT8 site table on the device, or null for the
// FloatingPoint(exp_bits, man_bits) snap; m and rs (B, H, N) fp32, the
// rowmax and reciprocal rowsum, or both null; split the scratch (4, B, H,
// N_pad, D) bf16 of K's and V's halves, 16-byte aligned; D = C / heads of
// 32 or 64, 1 <= N <= mvt_attention_core_f32_long_max_n(); sweep nonzero
// takes the cluster design at any N (above
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

// The launch figures of N tokens of bh (image, head) pairs at head width
// D into f[0..24]: for the forward's core kernel (the cluster design where
// sweep is nonzero or N > mvt_attention_core_f32_long_block_max_n()), the
// dq and the dk / dv kernel in turn, seven each: CTAs per (image, head),
// the CTA's own rows, the walked tile's rows, threads, ring stages,
// dynamic shared memory bytes and the CTAs an SM that the runtime fits;
// then the kernels a backward call launches and a forward call launches;
// then the forward's cluster size (1 for the score-block design) and the
// clusters of that size that the runtime fits on the device at once (0
// for the score-block design).  Returns a cudaError_t value.
MVT_EXPORT int mvt_attention_core_f32_long_plan(int N, int D, int sweep,
                                                int bh, int* f) {
  if (N <= 0 || N > kLongMaxN || (D != 64 && D != 32) || bh <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool sw = sweep != 0 || N > kBlockMaxN;
  const int err = D == 64 ? fwd_figures<64>(N, bh, sw, f)
                          : fwd_figures<32>(N, bh, sw, f);
  if (err != 0) return err;
  f[22] = 2;
  return f32_long_bwd_figures(N, D, f + 7);
}
