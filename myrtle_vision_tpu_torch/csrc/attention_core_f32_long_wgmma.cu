// attention_core_f32 above 256 tokens on Hopper: the fp32 softmax
// attention core of the float-format and INT8 QAT attention blocks, ending
// on the to_out.act_in snap or the quant_out site, and of the converted
// INT8 attention block, ending on the int8 grid of its quant_out site,
// from 257 to 768 tokens.
//
// The per-head loop of the TPU kernels `_attn_heads_fwd` with qspec set,
// followed by the snap of `_fwd_kernel`
// (myrtle_vision_tpu/ops/fused_attention_block.py; a float format's, or
// `_snap_int8` with qspec "int8"), and `_attn_kernel`
// (myrtle_vision_tpu/ops/fused_int8_block.py), which the JAX package runs
// wherever `fuses_at` holds: up to 701 tokens at 6 heads of 64 (the
// YOLOS-S train step's 256-608 px canvases give 357-677, ViT-S/16 at 384
// px 577).  Input qkv (B, N, 3C) fp32, feature order [3][h][d], D = 32 or
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
// Design.  The divide needs the sum of the whole row, so a rescaled online
// softmax (which rounds differently from JAX's e / sum) is not an option,
// and at N_pad = 704 a head's split K and V (4 N_pad D bf16, 352 KiB at D
// = 64) exceed an SM.  One CTA of one warpgroup takes 64 queries of one
// (image, head) and keeps its 64 x N_pad fp32 scores in shared memory
// (176 KiB at N_pad = 704), each thread the values of its own accumulator
// fragments, so no thread reads another's and the row statistics need only
// the quad shuffles:
//   scores   the threads split each 64-key K tile into hi and lo bf16
//            tiles (rows past N zero) and S = high3(Q, K^T) runs as one
//            chain of 3 D / 16 products m64n64k16, q split in registers
//            as the A operand (the forward core's chain); s is scaled,
//            keys past N set to -inf (e = 0), and stored;
//   softmax  the row max, then e = exp(s - m) in place with the rowsum in
//            the same four partial sums a row, added in the same order,
//            as attention_core_f32_wgmma.cu, then p = e / sum in place;
//   P V      one walk over the 64-key V tiles: each tile's A fragments
//            of p split in registers, its chain3 (the tile's 4 steps of
//            hi.lo, then lo.hi, then hi.hi) into a fresh accumulator,
//            which is then added to the context rounded once.
// Why not one chain over every key, as the short core runs it: on the
// tensor cores a chain of 3 x 44 steps rounds each step at the running
// sum's scale, and at N = 677-701 the snapped context then parts from the
// plain version's by a format step in up to the whole 0.2% that the float
// formats' bar allows; per-tile chains added in fp32 part about as often
// as the plain version itself parts from the same operations summed in
// fp64 (an ulp-level difference of p moves its bf16 split, and so the
// 3-pass product, by up to 2^-16 of a term).  The recomputed S of the
// backward keeps the short core's chain (attention_f32_tiles.cuh).
// Three sweeps that recompute the scores would keep no score block, but
// cost two more S products; the score block costs one CTA an SM instead.
// What bounds it: at (8, 677), 6 heads of 64, the two products are 3 x
// 2 x 8 x 6 x 677^2 x 64 x 2 = 4.2 GFLOP of bf16 tensor-core work and the
// qkv rows and context 58 MB, both well under 0.02 ms on an H100; the
// kernel is latency-bound instead: each tile is split by the threads and
// waited on before its products, one CTA an SM.  A simple kernel first:
// a ring of pre-split tiles fed by TMA is the next step.
// The int8 modes change only the epilogue: the same scores, softmax and
// per-tile P V, then the site's rint and clip on the accumulator.
#include <cstdint>

#include "attention_f32_tiles.cuh"
#include "fake_quant.cuh"

namespace {

using namespace mvt::f32attn;
namespace sm = mvt::sm90;

constexpr int kThreads = 128;  // one warpgroup

// kInt8: int8 out on the grid of `site`; kSnapFloat: fp32 out through the
// float format `qs`; kSnapSite: fp32 out through the INT8 site `site` (the
// modes of attention_core_f32_wgmma.cu)
enum Mode { kInt8 = 0, kSnapFloat = 1, kSnapSite = 2 };

template <int D>
__host__ __device__ constexpr size_t tile_bytes() {
  return static_cast<size_t>(kLongTile) * 2 * D;  // a 64-row split half
}

// the aligned region, a K or V tile's hi and lo halves, then the scores:
// 32 fp32 values a thread for each 64-key tile
template <int D>
__host__ __device__ constexpr size_t smem_bytes(int tiles) {
  return 1024 + 2 * tile_bytes<D>() +
         static_cast<size_t>(tiles) * 32 * kThreads * 4;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
attention_core_f32_long_kernel(const float* __restrict__ qkv,
                               const float* __restrict__ site,
                               void* __restrict__ out,
                               float* __restrict__ m_out,
                               float* __restrict__ rs_out, int N, int heads,
                               float scale, int mode, mvt::QSpec qs) {
  constexpr int kRow = 2 * D;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (sm::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* Th = smem;
  unsigned char* Tl = Th + tile_bytes<D>();
  float* S = reinterpret_cast<float*>(Tl + tile_bytes<D>());

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int tiles = (N + kLongTile - 1) / kLongTile;
  const int C = heads * D;
  const size_t row_stride = static_cast<size_t>(3) * C;
  const float* base = qkv + static_cast<size_t>(b) * N * row_stride + h * D;
  const uint64_t dth = sm::rows_desc<D>(Th, 0), dtl = sm::rows_desc<D>(Tl, 0);

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
  // 8 j + 2 t + (e % 2); stored at S[(32 kt + 4 j + e) * 128 + tid] ----
  float mx0 = mvt::neg_inf(), mx1 = mvt::neg_inf();
  for (int kt = 0; kt < tiles; ++kt) {
    __syncthreads();  // the previous tile's products are done with it
    split_rows<D>(Th, Tl, base + C, row_stride, kLongTile * kt, kLongTile, N,
                  nullptr, tid, kThreads);
    sm::fence_proxy_async();
    __syncthreads();
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      sm::fence_regs(qh[kk]);
      sm::fence_regs(ql[kk]);
    }
    sm::wgmma_fence();
    chain3<D / 16>([&](int a, int bl, int kk) {
      sm::WgmmaRS<64>::template mma<0>(s, a ? ql[kk] : qh[kk],
                                       sm::desc_add(bl ? dtl : dth, kk * 32),
                                       1);
    });
    sm::wgmma_commit();
    sm::wgmma_wait<0>();
    sm::fence_regs(s);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      sm::fence_regs(qh[kk]);
      sm::fence_regs(ql[kk]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        const int key = kLongTile * kt + 8 * j + 2 * t + (e & 1);
        const float v = key < N ? scaled(s[i], scale) : mvt::neg_inf();
        S[(32 * kt + i) * kThreads + tid] = v;
        if (e & 2)
          mx1 = fmaxf(mx1, v);
        else
          mx0 = fmaxf(mx0, v);
      }
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
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& v = S[(32 * kt + 4 * j + e) * kThreads + tid];
        v = exp_shift(v, (e & 2) ? mx1 : mx0);
        float& acc = part[e >> 1][2 * (j & 1) + (e & 1)];
        acc = __fadd_rn(acc, v);
      }
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
  // p = e / sum, a true divide
  for (int kt = 0; kt < tiles; ++kt) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float& v = S[(32 * kt + i) * kThreads + tid];
      v = __fdiv_rn(v, (i & 2) ? sum1 : sum0);
    }
  }

  // ---- U = high3(P, V), one 64-key V tile at a time: the tile's A
  // fragments of p split into hi and lo (step ks holds its values 8 ks +
  // 2 w + {0, 1}, word w rows ra (w even) or rb), its `chain3` of 3 x 4
  // products into a fresh accumulator, added to u rounded once ----
  float u[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) u[i] = 0.f;
  for (int kt = 0; kt < tiles; ++kt) {
    __syncthreads();  // the previous tile's products are done with it
    split_rows<D>(Th, Tl, base + 2 * C, row_stride, kLongTile * kt,
                  kLongTile, N, nullptr, tid, kThreads);
    sm::fence_proxy_async();
    __syncthreads();
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int i = 32 * kt + 8 * ks + 2 * w;
        sm::split_bf16x2(S[i * kThreads + tid], S[(i + 1) * kThreads + tid],
                         ph[ks][w], pl[ks][w]);
      }
    }
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      sm::fence_regs(ph[ks]);
      sm::fence_regs(pl[ks]);
    }
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    // V read MN-major (the transpose bit), 16 keys a step
    sm::wgmma_fence();
    chain3<4>([&](int a, int bl, int ks) {
      sm::WgmmaRS<D>::template mma<1>(
          acc, a ? pl[ks] : ph[ks],
          sm::desc_add(bl ? dtl : dth, ks * 16 * kRow), 1);
    });
    sm::wgmma_commit();
    sm::wgmma_wait<0>();
    sm::fence_regs(acc);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      sm::fence_regs(ph[ks]);
      sm::fence_regs(pl[ks]);
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) u[i] = __fadd_rn(u[i], acc[i]);
  }

  // the output grid (int8) or site (INT8 QAT) row
  float s_site = 1.0f, zp_site = 128.0f, has_site = 0.f;
  if (mode != kSnapFloat && site[2] > 0.5f) {
    s_site = site[0];
    zp_site = site[1];
    has_site = site[2];
  }
  // u[4 j + e]: row ra (e < 2) or rb, column 8 j + 2 t + (e % 2)
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
      if (mode == kInt8) {
        const float y0 = fminf(
            fmaxf(__fadd_rn(rintf(__fdiv_rn(x0, s_site)), zp_site), 0.f),
            255.f);
        const float y1 = fminf(
            fmaxf(__fadd_rn(rintf(__fdiv_rn(x1, s_site)), zp_site), 0.f),
            255.f);
        char2 c;
        c.x = static_cast<signed char>(static_cast<int>(y0) - 128);
        c.y = static_cast<signed char>(static_cast<int>(y1) - 128);
        *reinterpret_cast<char2*>(static_cast<signed char*>(out) + o) = c;
      } else {
        float2 y;
        if (mode == kSnapFloat) {
          y.x = mvt::snap(x0, qs);
          y.y = mvt::snap(x1, qs);
        } else {
          y.x = mvt::int8_site_snap(x0, s_site, zp_site, has_site);
          y.y = mvt::int8_site_snap(x1, s_site, zp_site, has_site);
        }
        *reinterpret_cast<float2*>(static_cast<float*>(out) + o) = y;
      }
    }
  }
  if (m_out != nullptr && t == 0) {
    const size_t o = static_cast<size_t>(bh) * N;
    if (ra < N) {
      m_out[o + ra] = mx0;
      rs_out[o + ra] = __fdiv_rn(1.0f, sum0);
    }
    if (rb < N) {
      m_out[o + rb] = mx1;
      rs_out[o + rb] = __fdiv_rn(1.0f, sum1);
    }
  }
}

template <int D>
int launch(const void* qkv, const void* site, void* out, void* m, void* rs,
           int B, int N, int heads, float scale, int mode, mvt::QSpec qs,
           cudaStream_t stream) {
  const int tiles = (N + kLongTile - 1) / kLongTile;
  const size_t smem = smem_bytes<D>(tiles);
  auto* kernel = attention_core_f32_long_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<dim3(tiles, B * heads), kThreads, smem, stream>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(site), out,
      static_cast<float*>(m), static_cast<float*>(rs), N, heads, scale, mode,
      qs);
  return static_cast<int>(cudaGetLastError());
}

int launch_d(const void* qkv, const void* site, void* out, void* m,
             void* rs, int B, int N, int heads, int D, float scale, int mode,
             mvt::QSpec qs, cudaStream_t stream) {
  if (B <= 0 || heads <= 0 || N <= 0 || N > kLongMaxN ||
      static_cast<long long>(B) * heads > 65535 ||
      (m == nullptr) != (rs == nullptr) ||
      reinterpret_cast<uintptr_t>(qkv) % 16 != 0 ||
      (mode != kSnapFloat && site == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (D == 64)
    return launch<64>(qkv, site, out, m, rs, B, N, heads, scale, mode, qs,
                      stream);
  if (D == 32)
    return launch<32>(qkv, site, out, m, rs, B, N, heads, scale, mode, qs,
                      stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

MVT_EXPORT int mvt_attention_core_f32_long_max_n() { return kLongMaxN; }

// qkv (B, N, 3C) fp32, 16-byte aligned; out (B, N, C) fp32, the context
// through the snap policy: site, the (3,) fp32 row (scale, zero point,
// has_stats) of the INT8 site table on the device, or null for the
// FloatingPoint(exp_bits, man_bits) snap; m and rs (B, H, N) fp32, the
// rowmax and reciprocal rowsum, or both null; D = C / heads of 32 or 64,
// 1 <= N <= mvt_attention_core_f32_long_max_n()
MVT_EXPORT int mvt_attention_core_f32_long(const void* qkv, void* out,
                                           void* m, void* rs, int B, int N,
                                           int heads, int D, float scale,
                                           int exp_bits, int man_bits,
                                           const void* site, void* stream) {
  if (site == nullptr && !mvt::float_fmt_ok(exp_bits, man_bits))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_d(qkv, site, out, m, rs, B, N, heads, D, scale,
                  site != nullptr ? kSnapSite : kSnapFloat,
                  site != nullptr ? mvt::QSpec(8, 22, 0)
                                  : mvt::QSpec(exp_bits, man_bits, 0),
                  static_cast<cudaStream_t>(stream));
}

// qkv (B, N, 3C) fp32, 16-byte aligned; site the (scale, zero point,
// has_stats) fp32 row of the output grid; out (B, N, C) int8 (the
// converted INT8 block's core, mvt_attention_core_f32 above its limit)
MVT_EXPORT int mvt_attention_core_f32_long_i8(const void* qkv,
                                              const void* site, void* out,
                                              int B, int N, int heads, int D,
                                              float scale, void* stream) {
  return launch_d(qkv, site, out, nullptr, nullptr, B, N, heads, D, scale,
                  kInt8, mvt::QSpec(8, 22, 0),
                  static_cast<cudaStream_t>(stream));
}
