// The 3-pass fp32 attention products on wgmma, shared by the fp32
// attention core (attention_core_f32_wgmma.cu) and its backward
// (attention_core_f32_bwd_wgmma.cu), and by their long routes above 256
// tokens (attention_core_f32_long_wgmma.cu,
// attention_core_f32_bwd_long_wgmma.cu).
//
// Every product is `dot_high3` (myrtle_vision_tpu/ops/high_precision.py):
// each fp32 operand is split as x = hi + lo, hi = bf16(x), lo = bf16(x -
// hi), and a . b = ah.bh + ah.bl + al.bh.  Here the three passes run into
// ONE fp32 accumulator (`chain3`), each pass over its 16-deep steps in
// order, the two small passes first: ah.bl, al.bh, then ah.bh.  The
// plain version adds three separate sums, (P1 + P2) + P3; the chain
// rounds in another order, so the two agree to fp32 roundoff, not
// bitwise (as the JAX converted-INT8 kernel's one K = 3D dot does,
// myrtle_vision_tpu/ops/fused_int8_block.py).  The order matters: each
// step of a chain rounds the accumulator at its current magnitude, so
// the small passes chained after ah.bh would add their steps' roundings
// at the result's scale (on the card the float formats' snaps then
// flipped 0.21% of one test's context, past the 0.2% bar); first, they
// round at their own 2^-8 smaller scale.  One accumulator instead of
// three keeps a 64 x 208 score tile at 104 registers a thread.
//
// The scores.  The forward forms s = high3(q, k^T) * scale (an fp32
// multiply after the chain) and e = exp(s - m) with `scaled` and
// `exp_shift`; the backward recomputes s in its query pass as Q K^T and
// in its key pass as K Q^T, and forms e against the forward's saved m.
// All three run `chain3` on the same split operands: the same bf16 halves
// of the same fp32 q and k, the same pass order (for K Q^T the A and B
// roles swap, so its passes are kl.qh, kh.ql, kh.qh: the terms equal to
// qh.kl, ql.kh, qh.kh), the same steps of 16, then the same two fp32
// roundings and expf.  What is not the same: the forward reads q from
// registers and K at width N_pad, the backward both operands from shared
// memory at the width of its half or chunk.  The PTX ISA does not promise
// that the tensor cores then round an element alike, so e <= 1 against
// the saved m is expected, not relied on: nothing in the backward clamps
// or divides by it.
//
// Layout.  A split operand lives in shared memory as two bf16 tiles (hi,
// lo), rows of one head's D values, 128-byte rows at D = 64 and 64-byte
// rows at D = 32, swizzled as TMA writes them (the tile 1024-byte
// aligned), so one descriptor form reads a tile K-major and, with the
// transpose bit, MN-major.  In the short kernels threads split the fp32
// rows into the tiles 8 values a thread (`split_rows`) and fence the async
// proxy before a product reads them; the long routes split every operand
// once a call into a scratch that TMA loads tile by tile in this layout
// (f32_long_wgmma.cuh).
#pragma once

#include "common.cuh"
#include "sm90.cuh"

namespace mvt {
namespace f32attn {

namespace sm = mvt::sm90;

constexpr int kMaxN = 256;
// an SM's shared memory and what the card keeps of it for each CTA
constexpr size_t kSmemPerSm = 233472;
constexpr size_t kSmemPerCta = 1024;
// the long route above kMaxN (attention_core_f32_long_wgmma.cu,
// attention_core_f32_bwd_long_wgmma.cu): a CTA's own 64 rows, the 64-row
// tiles it walks, the longest sequence, and the longest that the forward's
// score-block design takes (its 64 x 768 fp32 score block is what its
// shared memory holds; above it the forward's cluster design, whose CTAs
// split the score block by keys).  kLongMaxN is the longest sequence that the JAX
// package's fused gate `fuses_at` (myrtle_vision_tpu/ops/
// fused_attention_block.py) lets through at a head width of 32 or 64: one
// head of 32 at 1837 tokens (one head of 64: 1806)
constexpr int kLongTile = 64;
constexpr int kLongMaxN = 1837;
constexpr int kBlockMaxN = 768;

// Rows r0 .. r0 + rows - 1 of an fp32 (., D) operand (`src` its row 0,
// rows `ld` floats apart; rows at or past n read as zero; each row times
// mul[row] first where `mul` is set) split into the hi and lo tiles, row
// r0 at their row 0.  Thread i of `threads` takes 8 values at a time: two
// 16-byte loads, one 16-byte store into each tile.
template <int D>
__device__ __forceinline__ void split_rows(unsigned char* hi,
                                           unsigned char* lo,
                                           const float* src, size_t ld,
                                           int r0, int rows, int n,
                                           const float* mul, int i,
                                           int threads) {
  constexpr int kRow = 2 * D;
  for (int it = i; it < rows * (D / 8); it += threads) {
    const int r = it / (D / 8), c = it % (D / 8);
    const int row = r0 + r;
    float4 x0 = make_float4(0.f, 0.f, 0.f, 0.f), x1 = x0;
    if (row < n) {
      const float* p = src + static_cast<size_t>(row) * ld + 8 * c;
      x0 = *reinterpret_cast<const float4*>(p);
      x1 = *reinterpret_cast<const float4*>(p + 4);
      if (mul != nullptr) {
        const float f = mul[row];
        x0 = make_float4(__fmul_rn(x0.x, f), __fmul_rn(x0.y, f),
                         __fmul_rn(x0.z, f), __fmul_rn(x0.w, f));
        x1 = make_float4(__fmul_rn(x1.x, f), __fmul_rn(x1.y, f),
                         __fmul_rn(x1.z, f), __fmul_rn(x1.w, f));
      }
    }
    uint4 h, l;
    sm::split_bf16x2(x0.x, x0.y, h.x, l.x);
    sm::split_bf16x2(x0.z, x0.w, h.y, l.y);
    sm::split_bf16x2(x1.x, x1.y, h.z, l.z);
    sm::split_bf16x2(x1.z, x1.w, h.w, l.w);
    const uint32_t off = sm::swizzle_chunk<kRow>(r * kRow + 16 * c);
    *reinterpret_cast<uint4*>(hi + off) = h;
    *reinterpret_cast<uint4*>(lo + off) = l;
  }
}

// The 3-pass chain into one accumulator: mma(a, b, k) issues the product
// of 16-deep step k of A's half a with B's half b (0 hi, 1 lo); the passes
// hi.lo, lo.hi, then hi.hi, each over the kSteps steps in order.
template <int kSteps, class Mma>
__device__ __forceinline__ void chain3(const Mma& mma) {
#pragma unroll
  for (int k = 0; k < kSteps; ++k) mma(0, 1, k);
#pragma unroll
  for (int k = 0; k < kSteps; ++k) mma(1, 0, k);
#pragma unroll
  for (int k = 0; k < kSteps; ++k) mma(0, 0, k);
}

// Two 3-pass chains into two accumulators, issued step by step in turn
// (mma0's step, then mma1's), each in its own order: the sums of two
// chain3 calls, with two products in flight where one chain would wait on
// its accumulator.
template <int kSteps, class Mma0, class Mma1>
__device__ __forceinline__ void chain3_pair(const Mma0& mma0,
                                            const Mma1& mma1) {
#pragma unroll
  for (int k = 0; k < kSteps; ++k) {
    mma0(0, 1, k);
    mma1(0, 1, k);
  }
#pragma unroll
  for (int k = 0; k < kSteps; ++k) {
    mma0(1, 0, k);
    mma1(1, 0, k);
  }
#pragma unroll
  for (int k = 0; k < kSteps; ++k) {
    mma0(0, 0, k);
    mma1(0, 0, k);
  }
}

// the first product of a `chain3` (step 0 of its first pass, hi.lo): the
// one that may ignore the accumulator's old contents (scale_d = 0) and so
// start a fresh sum without zeroing it, the same sum as 0 + the chain
__device__ __forceinline__ constexpr bool chain_first(int a, int b, int k) {
  return a == 0 && b == 1 && k == 0;
}

// stores a 64-row accumulator tile (times `mul`) into D columns from
// out_a of rows ra, ra + 8 (those below N: va, vb) and adds the
// stored values to the thread's column sums col[2 j + e] (column 8 j + 2 t
// + e): the backwards' dQ, dK and dV tiles
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2],
                                           float mul, float* out_a, bool va,
                                           bool vb, size_t row_stride, int t,
                                           float (&col)[D / 4]) {
  float* out_b = out_a + 8 * row_stride;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int d = 8 * j + 2 * t;
    const float a0 = __fmul_rn(acc[4 * j], mul);
    const float a1 = __fmul_rn(acc[4 * j + 1], mul);
    const float b0 = __fmul_rn(acc[4 * j + 2], mul);
    const float b1 = __fmul_rn(acc[4 * j + 3], mul);
    if (va) {
      *reinterpret_cast<float2*>(out_a + d) = make_float2(a0, a1);
      col[2 * j] = __fadd_rn(col[2 * j], a0);
      col[2 * j + 1] = __fadd_rn(col[2 * j + 1], a1);
    }
    if (vb) {
      *reinterpret_cast<float2*>(out_b + d) = make_float2(b0, b1);
      col[2 * j] = __fadd_rn(col[2 * j], b0);
      col[2 * j + 1] = __fadd_rn(col[2 * j + 1], b1);
    }
  }
}

// s = chain * scale, rounded once (never contracted with what follows)
__device__ __forceinline__ float scaled(float acc, float scale) {
  return __fmul_rn(acc, scale);
}

// e = exp(s - m)
__device__ __forceinline__ float exp_shift(float s, float m) {
  return expf(__fsub_rn(s, m));
}

}  // namespace f32attn
}  // namespace mvt
