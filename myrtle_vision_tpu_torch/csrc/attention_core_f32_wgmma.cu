// attention_core_f32 on Hopper: the fp32 softmax attention core of the
// converted-INT8 attention block, ending on the int8 grid of the next
// observer site, and of the float-format and INT8 QAT attention blocks,
// ending on their snap.
//
// The per-head loop of the TPU kernels `_attn_kernel`
// (myrtle_vision_tpu/ops/fused_int8_block.py; the same ops as
// multi_head_attention's xla path, myrtle_vision_tpu/ops/attention.py) and
// `_attn_heads_fwd` with qspec set, followed by the to_out.act_in snap of
// `_fwd_kernel` (myrtle_vision_tpu/ops/fused_attention_block.py).
// Input qkv (B, N, 3C) fp32, feature order [3][h][d], D = 32 or 64, N <=
// 256; output (B, N, C), head h at columns h*D...  For each query row:
//   s   = high3(q, k^T) * scale, the scale after the product
//   m   = rowmax(s), e = exp(s - m), sum = rowsum(e)
//   p   = e / sum                    a true fp32 divide
//   ctx = high3(p, v)
//   int8 mode:  out = clip(rint(ctx / s2) + zp2, 0, 255) - 128, int8 (site
//               2, quant_out; without statistics scale 1 and zero point
//               128, the guard of `_quantize_i8`)
//   snap mode:  out = site0(snap(ctx)), fp32: a float format's
//               FloatingPoint(exp, man) snap (the pre_linear site of the
//               projection), or INT8 QAT's affine site snap with the
//               quant_out observer's frozen row (`_snap_int8` of
//               `_fwd_kernel`, qspec "int8"); when the caller records for
//               the backward, also the rowmax m and rs = 1 / sum (a true
//               divide), (B, H, N) fp32, as `_attn_heads_fwd` returns them
// with high3 the 3-pass split-bf16 product of attention_f32_tiles.cuh,
// each product's passes chained into one accumulator.
//
// What bounds it: at ViT-S/16 (B = 256, N = 197, 6 heads of 64) the two
// products are 3 x 15.3 GFLOP of bf16 tensor-core work and the qkv rows
// and context 310 MB; the elementwise softmax (60 M exps and true
// divides, the split of every p) is of the same order.
//
// Design.  One CTA per (image, head) splits K and V of the head (rows
// past N zero, N_pad = N rounded up to 16) into hi and lo bf16 tiles in
// shared memory, 4 N_pad D bf16 in all (106,496 bytes at N = 197, D = 64),
// read as the B operands of every query tile.  Its warpgroups walk the
// queries in 64-row tiles.  Each thread loads its q values straight into
// the register A fragment of m64k16 and splits them there (WgmmaRS); S =
// high3(Q, K^T) is one wgmma chain of 3 D / 16 products m64nN_padk16 into
// one accumulator, and the scores stay in registers (N_pad / 2 fp32 a
// thread, 104 at N = 197).  The rowmax and rowsum take quad shuffles; p =
// e / sum, split into hi and lo in registers, is the A operand of U =
// high3(P, V) (m64nDk16, V read MN-major through the transpose bit), one
// chain of 3 N_pad / 16 products.  Every fragment of a chain is formed
// before its first product is issued and no register is written until it
// completes: a register written while a register-A product is in flight
// makes ptxas serialise every product of the kernel (its C7513 note), so P
// is formed whole, in the registers the scores free, rather than one
// 16-key chunk ahead of the products.  The epilogue writes the three
// output modes from the accumulator fragments, the statistics beside them.
// Where two CTAs fit an SM's shared memory (N_pad <= 224 at D = 64, any N
// at D = 32) a CTA is one warpgroup and one CTA's split and softmax
// overlap the other's products; above that one CTA of two warpgroups
// shares each head's split (`attention_core_f32_plan` in ops/_kernels.py
// gives the figures).  The wrapper counts one launch a call.
// ptxas -v (sm_90a, nvcc 12.9): at D = 64, 78-168 registers a thread up to
// N_pad = 128 and 209-255 from 144 to 224 (254 at 208), no spills; 255
// and 8 bytes spilled at 240 and 256 (two warpgroups); at D = 32, 64-255
// registers, 12 and 32 bytes spilled at 256 and 240.  On one H100 80GB
// HBM3 at 700 W (PERF.md, chip_smoke.py) a ViT-S/16 block at B = 256
// takes 0.41 ms with statistics and 0.38 in the int8 mode, against 0.81
// for fp32 SDPA; the true divide costs 0.10 ms of it (the variant that
// multiplies by the reciprocal takes 0.32).  What bounds it now is the
// elementwise softmax between the two chains, which the second CTA of an
// SM overlaps with its own products only.
#include "attention_f32_tiles.cuh"
#include "fake_quant.cuh"

namespace {

using namespace mvt::f32attn;
namespace sm = mvt::sm90;

enum Mode { kInt8 = 0, kSnapFloat = 1, kSnapSite = 2 };

template <int D, int NP>
__host__ __device__ constexpr size_t smem_bytes() {
  return 1024 + 4 * static_cast<size_t>(NP) * 2 * D;
}

// one warpgroup a CTA where two CTAs fit an SM's shared memory, else two
template <int D, int NP>
__host__ __device__ constexpr int warpgroups() {
  return 2 * (smem_bytes<D, NP>() + kSmemPerCta) <= kSmemPerSm ? 1 : 2;
}

// mode kInt8: int8 out on the grid of `site`; kSnapFloat: fp32 out through
// the float format `qs`; kSnapSite: fp32 out through the INT8 site `site`.
// kRecip multiplies e by 1 / sum instead of dividing (a timing variant)
template <int D, int NP, bool kRecip>
__global__ void __launch_bounds__(128 * warpgroups<D, NP>(),
                                  2 / warpgroups<D, NP>())
attention_core_f32_wgmma_kernel(const float* __restrict__ qkv,
                                const float* __restrict__ site,
                                void* __restrict__ out,
                                float* __restrict__ m_out,
                                float* __restrict__ rs_out, int N, int heads,
                                float scale, int mode, mvt::QSpec qs) {
  constexpr int W = warpgroups<D, NP>();
  constexpr int kRow = 2 * D, kTile = NP * kRow;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (sm::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* Kh = smem;
  unsigned char* Kl = Kh + kTile;
  unsigned char* Vh = Kl + kTile;
  unsigned char* Vl = Vh + kTile;

  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const int C = heads * D;
  const size_t row_stride = static_cast<size_t>(3) * C;
  const float* base = qkv + static_cast<size_t>(b) * N * row_stride + h * D;

  split_rows<D>(Kh, Kl, base + C, row_stride, 0, NP, N, nullptr, tid,
                128 * W);
  split_rows<D>(Vh, Vl, base + 2 * C, row_stride, 0, NP, N, nullptr, tid,
                128 * W);
  // the generic-proxy writes of the tiles, before wgmma reads them
  sm::fence_proxy_async();
  __syncthreads();
  const uint64_t dkh = sm::rows_desc<D>(Kh, 0), dkl = sm::rows_desc<D>(Kl, 0);
  const uint64_t dvh = sm::rows_desc<D>(Vh, 0), dvl = sm::rows_desc<D>(Vl, 0);
  // the output grid (int8) or site (INT8 QAT) row
  float s_site = 1.0f, zp_site = 128.0f, has_site = 0.f;
  if (mode != kSnapFloat && site[2] > 0.5f) {
    s_site = site[0];
    zp_site = site[1];
    has_site = site[2];
  }

  for (int q0 = 64 * wg; q0 < N; q0 += 64 * W) {
    // this thread's rows of the tile and its A fragments of q, split:
    // word 0 (row ra, columns 2t, 2t+1 of the 16-deep step), 1 (row rb),
    // 2 and 3 (columns 2t+8, 2t+9)
    const int ra = q0 + 16 * warp + g, rb = ra + 8;
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

    float s[NP / 2];
#pragma unroll
    for (int i = 0; i < NP / 2; ++i) s[i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      sm::fence_regs(qh[kk]);
      sm::fence_regs(ql[kk]);
    }
    sm::wgmma_fence();
    chain3<D / 16>([&](int a, int bh, int kk) {
      sm::WgmmaRS<NP>::template mma<0>(s, a ? ql[kk] : qh[kk],
                                       sm::desc_add(bh ? dkl : dkh, kk * 32),
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

    // s[4 j + e]: row ra (e < 2) or rb, key 8 j + 2 t + (e % 2)
    float mx0 = mvt::neg_inf(), mx1 = mvt::neg_inf();
#pragma unroll
    for (int j = 0; j < NP / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        s[i] = (NP > N && 8 * j + 2 * t + (e & 1) >= N) ? mvt::neg_inf()
                                                        : scaled(s[i], scale);
      }
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
    }
    // the rowsums in four partial sums a row (keys 16 k + 2 t + {0, 1, 8,
    // 9} of the thread's quad position), added pairwise: short sequential
    // runs keep the sum's rounding near that of the plain version's
    // reduction tree
    float part[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) part[r][c] = 0.f;
#pragma unroll
    for (int j = 0; j < NP / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        s[i] = exp_shift(s[i], (e & 2) ? mx1 : mx0);
        float& acc = part[e >> 1][2 * (j & 1) + (e & 1)];
        acc = __fadd_rn(acc, s[i]);
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
    // p = e / sum split into the A fragments of the 16-key steps: step kt
    // holds score blocks 2 kt and 2 kt + 1, word w rows ra (w even) or rb
    float inv0 = 0.f, inv1 = 0.f;
    if (kRecip) {
      inv0 = __fdiv_rn(1.0f, sum0);
      inv1 = __fdiv_rn(1.0f, sum1);
    }
    uint32_t ph[NP / 16][4], pl[NP / 16][4];
#pragma unroll
    for (int kt = 0; kt < NP / 16; ++kt) {
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const float e0 = s[8 * kt + 2 * w], e1 = s[8 * kt + 2 * w + 1];
        const float sum = (w & 1) ? sum1 : sum0;
        const float inv = (w & 1) ? inv1 : inv0;
        const float p0 = kRecip ? __fmul_rn(e0, inv) : __fdiv_rn(e0, sum);
        const float p1 = kRecip ? __fmul_rn(e1, inv) : __fdiv_rn(e1, sum);
        sm::split_bf16x2(p0, p1, ph[kt][w], pl[kt][w]);
      }
    }

    float u[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) u[i] = 0.f;
#pragma unroll
    for (int kt = 0; kt < NP / 16; ++kt) {
      sm::fence_regs(ph[kt]);
      sm::fence_regs(pl[kt]);
    }
    sm::wgmma_fence();
    chain3<NP / 16>([&](int a, int bh, int kt) {
      sm::WgmmaRS<D>::template mma<1>(
          u, a ? pl[kt] : ph[kt],
          sm::desc_add(bh ? dvl : dvh, kt * 16 * kRow), 1);
    });
    sm::wgmma_commit();
    sm::wgmma_wait<0>();
    sm::fence_regs(u);
#pragma unroll
    for (int kt = 0; kt < NP / 16; ++kt) {
      sm::fence_regs(ph[kt]);
      sm::fence_regs(pl[kt]);
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
      const size_t o = static_cast<size_t>(blockIdx.x) * N;
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
}

template <int D, int NP, bool kRecip>
int launch(const void* qkv, const void* site, void* out, void* m, void* rs,
           int B, int N, int heads, float scale, int mode, mvt::QSpec qs,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D, NP>();
  auto* kernel = attention_core_f32_wgmma_kernel<D, NP, kRecip>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<B * heads, 128 * warpgroups<D, NP>(), smem, stream>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(site), out,
      static_cast<float*>(m), static_cast<float*>(rs), N, heads, scale, mode,
      qs);
  return static_cast<int>(cudaGetLastError());
}

// the launch figures of (D, NP): warpgroups, KA (0: the forward splits no
// keys), launches, dynamic shared memory bytes, CTAs an SM (the runtime's
// occupancy)
template <int D, int NP>
int figures(int* f) {
  constexpr size_t smem = smem_bytes<D, NP>();
  auto* kernel = attention_core_f32_wgmma_kernel<D, NP, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  int ctas = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &ctas, kernel, 128 * warpgroups<D, NP>(), smem);
  f[0] = warpgroups<D, NP>();
  f[1] = 0;
  f[2] = 1;
  f[3] = static_cast<int>(smem);
  f[4] = ctas;
  return static_cast<int>(e);
}

// F(np) for N_pad = N rounded up to 16, 16 ... 256
#define MVT_F32_NP(F) \
  F(16) F(32) F(48) F(64) F(80) F(96) F(112) F(128) F(144) F(160) F(176) \
  F(192) F(208) F(224) F(240) F(256)

template <int D>
int launch_n(const void* qkv, const void* site, void* out, void* m, void* rs,
             int B, int N, int heads, float scale, int mode, mvt::QSpec qs,
             cudaStream_t s) {
#define MVT_CASE(np)                                                        \
  case np:                                                                  \
    return launch<D, np, false>(qkv, site, out, m, rs, B, N, heads, scale, \
                                mode, qs, s);
  switch ((N + 15) / 16 * 16) {
    MVT_F32_NP(MVT_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MVT_CASE
}

template <int D>
int figures_n(int N, int* f) {
#define MVT_CASE(np) \
  case np:           \
    return figures<D, np>(f);
  switch ((N + 15) / 16 * 16) {
    MVT_F32_NP(MVT_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MVT_CASE
}

int launch_d(const void* qkv, const void* site, void* out, void* m, void* rs,
             int B, int N, int heads, int D, float scale, int mode,
             mvt::QSpec qs, cudaStream_t stream) {
  if (B <= 0 || heads <= 0 || N <= 0 || N > kMaxN ||
      (m == nullptr) != (rs == nullptr) ||
      (mode != kSnapFloat && site == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (D == 64)
    return launch_n<64>(qkv, site, out, m, rs, B, N, heads, scale, mode, qs,
                        stream);
  if (D == 32)
    return launch_n<32>(qkv, site, out, m, rs, B, N, heads, scale, mode, qs,
                        stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

MVT_EXPORT int mvt_attention_core_f32_max_n() { return kMaxN; }

// qkv (B, N, 3C) fp32; site the (scale, zero point, has_stats) fp32 row of
// the output grid; out (B, N, C) int8
MVT_EXPORT int mvt_attention_core_f32(const void* qkv, const void* site,
                                      void* out, int B, int N, int heads,
                                      int D, float scale, void* stream) {
  return launch_d(qkv, site, out, nullptr, nullptr, B, N, heads, D, scale,
                  kInt8, mvt::QSpec(8, 22, 0),
                  static_cast<cudaStream_t>(stream));
}

// qkv (B, N, 3C) fp32; out (B, N, C) fp32, the context through the snap
// policy: site, the (3,) fp32 row (scale, zero point, has_stats) of the
// INT8 site table on the device, or null for the FloatingPoint(exp_bits,
// man_bits) snap; m and rs (B, H, N) fp32, the rowmax and reciprocal
// rowsum, or both null
MVT_EXPORT int mvt_attention_core_f32_snap(const void* qkv, void* out,
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

// The snap mode with statistics under a float format, p = e * (1 / sum)
// instead of the true divide: a timing variant for the divide's cost,
// which no path runs; D = 64 and N_pad = 208 (N 193 ... 208) only.
MVT_EXPORT int mvt_attention_core_f32_snap_recip(
    const void* qkv, void* out, void* m, void* rs, int B, int N, int heads,
    int D, float scale, int exp_bits, int man_bits, void* stream) {
  if (B <= 0 || heads <= 0 || D != 64 || (N + 15) / 16 * 16 != 208 ||
      m == nullptr || rs == nullptr || !mvt::float_fmt_ok(exp_bits, man_bits))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<64, 208, true>(qkv, nullptr, out, m, rs, B, N, heads, scale,
                               kSnapFloat, mvt::QSpec(exp_bits, man_bits, 0),
                               static_cast<cudaStream_t>(stream));
}

// the launch figures of N tokens at head width D into f[0..4]
// (`figures`); returns a cudaError_t value
MVT_EXPORT int mvt_attention_core_f32_launch(int N, int D, int* f) {
  if (N <= 0 || N > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  if (D == 64) return figures_n<64>(N, f);
  if (D == 32) return figures_n<32>(N, f);
  return static_cast<int>(cudaErrorInvalidValue);
}
