// Softmax attention over KV tiles with an online softmax, on the tensor
// cores (mma.sync m16n8k16, bf16 in, fp32 accumulation).  One block of 4
// warps takes 64 query rows of one (image, head), 16 rows a warp, and walks
// the keys in tiles of 64 rows; the K and V tiles are double-buffered in
// shared memory with cp.async, so the copy of tile j+1 overlaps the
// products of tile j.  Scores, running row maxima and sums and the output
// accumulator stay in registers: the (N, N) score matrix never exists.
//
// Per KV tile, for each query row (rowmax m, rowsum l, accumulator acc):
//   s     = bf16(q * scale) . k^T           fp32
//   s     = -inf for keys >= n_valid
//   m'    = max(m, rowmax(s)),  a = exp(m - m')
//   e     = exp(s - m')                     fp32
//   l     = a * l + rowsum(e)               fp32 e
//   acc   = a * acc + bf16(e) . v           fp32 accumulation
// and at the end o = acc * (1 / l), with the rowmax m and the reciprocal
// 1 / l saved for the backward.
//
// This is the fused attention block's core (attention_core_wgmma.cu) for
// sequences longer than its one-CTA kernel holds, with the conventions of
// `_attn_heads_fwd` (myrtle_vision_tpu/ops/fused_attention_block.py):
// q * scale rounded to bf16 before the product, e . V first, then x
// reciprocal rowsum.
//
// The operands are read in place through element strides (image, head,
// row; the head dimension contiguous), so the (B, H, N, D) view of the
// fused (B, N, 3C) qkv rows needs no copy, and the output goes to any such
// layout, e.g. (B, N, H, D) rows that the output projection reads as they
// are.  Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16): lane = 4g + t
// holds accumulator rows g and g + 8, columns 2t and 2t + 1 of each 8-wide
// tile, and the A operand of a 16-deep slice is the accumulators of two
// neighbouring 8-wide tiles, so the probabilities go from the QK^T
// accumulators to the PV operand in registers.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace mvt {
namespace flash {

constexpr int kBM = 64;     // query rows of a block: 4 warps x 16
constexpr int kBN = 64;     // key rows of a KV tile
constexpr int kWarps = 4;

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  float* stat0;  // rowmax or null
  float* stat1;  // reciprocal rowsum (null with stat0)
  long long in_image;  // element strides of q, k and v
  int in_head, in_row;
  long long out_image;  // element strides of o
  int out_head, out_row;
  int heads, n, n_valid;
  float scale;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a . b, a 16x16 (row), b 16x8 (col), bf16 in, fp32 accumulation
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> bf16x2, the first in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t x, float scale) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
  return pack_bf16(f.x * scale, f.y * scale);
}

// rows [row0, row0 + 64) of one operand into a padded shared tile; rows at
// or past n are zeros (so that masked keys meet finite values)
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* base,
                                          int row0, int n, int row_stride,
                                          int tid) {
  constexpr int LD = D + 8, kChunks = D / 8;  // 16-byte chunks per row
  for (int c = tid; c < kBN * kChunks; c += kWarps * 32) {
    const int r = c / kChunks, d0 = (c % kChunks) * 8;
    const bool ok = row0 + r < n;
    const bf16* src =
        base + static_cast<size_t>(ok ? row0 + r : 0) * row_stride + d0;
    cp_async16(dst + r * LD + d0, src, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_kernel(const Params p) {
  // rows padded by 8 elements: 16-byte aligned for ldmatrix and cp.async,
  // and the 8 rows of an 8x8 ldmatrix land in distinct banks
  constexpr int LD = D + 8;
  __shared__ __align__(16) bf16 Qs[kBM * LD];
  __shared__ __align__(16) bf16 Ks[2][kBN * LD];
  __shared__ __align__(16) bf16 Vs[2][kBN * LD];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / p.heads, h = bh % p.heads;
  const int q0 = blockIdx.x * kBM;
  const size_t in_off =
      static_cast<size_t>(b) * p.in_image + static_cast<size_t>(h) * p.in_head;
  const bf16* qb = p.q + in_off;
  const bf16* kb = p.k + in_off;
  const bf16* vb = p.v + in_off;
  const int n_tiles = (p.n_valid + kBN - 1) / kBN;

  load_tile<D>(Qs, qb, q0, p.n, p.in_row, tid);
  load_tile<D>(Ks[0], kb, 0, p.n, p.in_row, tid);
  load_tile<D>(Vs[0], vb, 0, p.n, p.in_row, tid);
  cp_async_commit();

  uint32_t qa[D / 16][4];
  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {neg_inf(), neg_inf()};
  float l[2] = {0.f, 0.f};  // this lane's columns only, summed at the end

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    if (j + 1 < n_tiles) {
      load_tile<D>(Ks[st ^ 1], kb, (j + 1) * kBN, p.n, p.in_row, tid);
      load_tile<D>(Vs[st ^ 1], vb, (j + 1) * kBN, p.n, p.in_row, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        ldsm_x4(qa[kk], Qs + (warp * 16 + (lane & 15)) * LD + kk * 16 +
                            (lane >> 4) * 8);
#pragma unroll
        for (int r = 0; r < 4; ++r) qa[kk][r] = scale_bf16x2(qa[kk][r], p.scale);
      }
    }

    // S = Q K^T: 16 x 64 per warp, 8 tiles of 8 keys
    float s[kBN / 8][4];
#pragma unroll
    for (int i = 0; i < kBN / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
    const bf16* ks = Ks[st];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < kBN / 16; ++np) {
        // K row-major (key, d) is the col-major B operand: matrices
        // (keys 0-7 | 8-15) x (d 0-7 | 8-15) of this 16 x 16 block
        uint32_t kf[4];
        ldsm_x4(kf, ks + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * LD +
                        kk * 16 + ((lane >> 3) & 1) * 8);
        mma16816(s[2 * np], qa[kk], kf[0], kf[1]);
        mma16816(s[2 * np + 1], qa[kk], kf[2], kf[3]);
      }
    }

    // mask, online softmax; lane holds rows g (i = 0) and g + 8
    float mx[2] = {neg_inf(), neg_inf()};
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * kBN + nt * 8 + 2 * t + (e & 1);
        const float v = col < p.n_valid ? s[nt][e] : neg_inf();
        s[nt][e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      // tile 0 holds key 0 < n_valid, so m_new is finite from the start
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
    }
    float rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float ev = expf(s[nt][e] - m[e >> 1]);
        s[nt][e] = ev;
        rsum[e >> 1] += ev;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rsum[i];
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      o[dn][0] *= alpha[0];
      o[dn][1] *= alpha[0];
      o[dn][2] *= alpha[1];
      o[dn][3] *= alpha[1];
    }

    // O += bf16(E) V: E's accumulators are the A operand, V row-major
    // (key, d) read transposed as the col-major B operand
    const bf16* vs = Vs[st];
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vf[4];
        ldsm_x4_t(vf, vs + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD +
                          dp * 16 + (lane >> 4) * 8);
        mma16816(o[2 * dp], pa, vf[0], vf[1]);
        mma16816(o[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const size_t out_off = static_cast<size_t>(b) * p.out_image +
                         static_cast<size_t>(h) * p.out_head;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + warp * 16 + g + 8 * i;
    if (row >= p.n) continue;
    const float rs = 1.0f / l[i];
    bf16* orow = p.o + out_off + static_cast<size_t>(row) * p.out_row;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      *reinterpret_cast<__nv_bfloat162*>(orow + dn * 8 + 2 * t) =
          __floats2bfloat162_rn(o[dn][2 * i] * rs, o[dn][2 * i + 1] * rs);
    if (t == 0 && p.stat0 != nullptr) {
      const size_t si = static_cast<size_t>(bh) * p.n + row;
      p.stat0[si] = m[i];
      p.stat1[si] = rs;
    }
  }
}

// grid: (query tiles, images x heads); 46,080 bytes of static shared
// memory at D = 64
template <int D>
int launch(const Params& p, int images, cudaStream_t stream) {
  const dim3 grid((p.n + kBM - 1) / kBM, images * p.heads);
  flash_fwd_kernel<D><<<grid, kWarps * 32, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace flash
}  // namespace mvt
