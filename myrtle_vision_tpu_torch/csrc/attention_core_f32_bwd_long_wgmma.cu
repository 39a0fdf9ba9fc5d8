// attention_core_f32_bwd above 256 tokens on Hopper: the per-head part of
// the TPU attention block's backward in a stateless float format, fp32
// throughout, from 257 to 768 tokens.
//
// Replaces the loop over heads of `_bwd_one_image` with qspec set
// (myrtle_vision_tpu/ops/fused_attention_block.py) wherever the JAX
// package fuses, up to 701 tokens at 6 heads of 64.  Inputs: qkv (B, N,
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
// Design, after attention_core_bwd_long_wgmma.cu (the bf16 core's long
// backward): r needs every key of a row before its ds exists, so three
// launches, each CTA one warpgroup that owns 64 rows of one (image, head):
//   dq    per 64-query tile: the threads split the tile's q and du rows
//         into shared memory once, then walk the 64-key tiles twice,
//         splitting each K and V tile into hi and lo halves: the first
//         walk recomputes S = high3(Q, K^T) and dP = high3(du, V^T) and
//         sums r of each row, which it keeps as r * rs in the scratch
//         `rt` (rows of N_pad per image and head); the second recomputes
//         them, forms ds in registers and runs dQ += high3(ds, K);
//   dk/dv per 64-key tile: the K and V rows split once, then a walk over
//         the 64-query chunks recomputes S^T = high3(K, q^T) and dP^T =
//         high3(V, du^T) with the A and B roles swapped (the short
//         backward's key pass), forms e^T and ds^T from the saved m and
//         the dq launch's r * rs, and runs dV += high3(e^T, du) and dK +=
//         high3(ds^T, q);
//   sums  each tile's column sums (written by the two kernels above into
//         `colpart`, (B, N_pad / 64, 3C)) added per image in tile order.
// The recomputed s follows the forward's chain: the same split operands,
// the same pass order (hi.lo, lo.hi, hi.hi over the 16-deep steps of D),
// then the same fp32 scale and expf; only the forward reads q from
// registers.  Nothing clamps e or divides by it.  Every chain's fragments
// are formed before its first product and nothing is written until it
// completes (ptxas's C7513 note), and every sum runs in a fixed order, so
// results are bitwise reproducible.  The dQ, dK and dV chains add their
// 64-row tiles in turn (each tile's three passes, then the next tile's),
// which rounds in another order than the short backward's one chain over
// all keys: fp32 roundoff, under the gradients' bars.
// What bounds it: at (8, 677), 6 heads of 64, the recomputed S and dP (the
// dq kernel twice, dk / dv once) and dV, dQ, dK are nine 3-pass products,
// 3 x 9 x 8 x 6 x 677^2 x 64 x 2 = 38 GFLOP of bf16 tensor-core work; the
// kernels are latency-bound instead, each tile split by the threads and
// waited on before its products.  A simple kernel first: pre-split tiles
// fed by TMA into a ring are the next step.
#include <cstdint>

#include "attention_f32_tiles.cuh"

namespace {

using namespace mvt::f32attn;
namespace sm = mvt::sm90;

constexpr int kThreads = 128;  // one warpgroup
constexpr int kLaunches = 3;

template <int D>
struct Layout {
  static constexpr int kRow = 2 * D;             // bytes of a split row
  static constexpr int kSub = kLongTile * kRow;  // a 64-row split half
  // the CTA's own rows (q and du, or K and V: hi, lo, hi, lo), then the
  // walked tile's, then the column sums (4 warps x 3 sections x D fp32)
  static constexpr size_t kBytes = 1024 + 8 * kSub + 4 * 4 * 3 * D;
};

__device__ __forceinline__ int tiles_of(int n) {
  return (n + kLongTile - 1) / kLongTile;
}

// the two recomputed products of a 64 x 64 (rows, walked tile) block, each
// a chain of 3 D / 16 products into one accumulator: s = A0 B0^T, p = A1
// B1^T, with A0, A1 the rows' (q, du) and B0, B1 the tile's (K, V), or with
// the roles swapped for the transposed block; a0..b1 are the hi halves'
// descriptors, the lo halves one split half further
template <int D>
__device__ __forceinline__ void two_products(float (&s)[32], float (&p)[32],
                                             uint64_t a0, uint64_t a1,
                                             uint64_t b0, uint64_t b1,
                                             bool swap) {
  constexpr uint32_t kLo = Layout<D>::kSub >> 4;  // descriptor units
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = p[i] = 0.f;
  sm::wgmma_fence();
  // a: the half of the rows' operand (q or du), bl: that of the tile's;
  // the transposed block issues the tile's operand as A
  chain3<D / 16>([&](int a, int bl, int kk) {
    const uint64_t x = a0 + (a ? kLo : 0) + kk * 2;
    const uint64_t y = b0 + (bl ? kLo : 0) + kk * 2;
    sm::WgmmaSS<64>::template mma<0, 0>(s, swap ? y : x, swap ? x : y, 1);
  });
  chain3<D / 16>([&](int a, int bl, int kk) {
    const uint64_t x = a1 + (a ? kLo : 0) + kk * 2;
    const uint64_t y = b1 + (bl ? kLo : 0) + kk * 2;
    sm::WgmmaSS<64>::template mma<0, 0>(p, swap ? y : x, swap ? x : y, 1);
  });
  sm::wgmma_commit();
  sm::wgmma_wait<0>();
  sm::fence_regs(s);
  sm::fence_regs(p);
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
  const float* d_o;  // (B, N, C)
  const float* m;    // (B, H, N)
  const float* rs;   // (B, H, N)
  float* dqkv;       // (B, N, 3C)
  float* rt;         // (B, H, N_pad): r * rs of each row, 0 past N
  float* colpart;    // (B, N_pad / 64, 3C)
  int n, heads;
  float scale;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
f32_long_dq_kernel(Args a) {
  using L = Layout<D>;
  constexpr int kRow = L::kRow, kSub = L::kSub;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (sm::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* qu = smem;             // q hi, lo, du hi, lo
  unsigned char* kv = smem + 4 * kSub;  // K hi, lo, V hi, lo
  float* colbuf = reinterpret_cast<float*>(smem + 8 * kSub);

  const int tid = threadIdx.x, warp = tid >> 5;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int N = a.n, heads = a.heads, tiles = tiles_of(N);
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int C = heads * D;
  const size_t row_stride = static_cast<size_t>(3) * C;
  const size_t stat0 = static_cast<size_t>(bh) * N;
  const float* q_base = a.qkv + static_cast<size_t>(b) * N * row_stride +
                        h * D;
  const float* do_base = a.d_o + static_cast<size_t>(b) * N * C + h * D;
  const int q0 = kLongTile * blockIdx.x;
  const int ra = q0 + 16 * warp + g, rb = ra + 8;
  const bool va = ra < N, vb = rb < N;
  const float ma = va ? a.m[stat0 + ra] : 0.f;
  const float mb = vb ? a.m[stat0 + rb] : 0.f;

  split_rows<D>(qu, qu + kSub, q_base, row_stride, q0, kLongTile, N, nullptr,
                tid, kThreads);
  split_rows<D>(qu + 2 * kSub, qu + 3 * kSub, do_base, C, q0, kLongTile, N,
                a.rs + stat0, tid, kThreads);
  const uint64_t dq_h = sm::rows_desc<D>(qu, 0);
  const uint64_t du_h = sm::rows_desc<D>(qu + 2 * kSub, 0);
  const uint64_t dk_h = sm::rows_desc<D>(kv, 0);
  const uint64_t dv_h = sm::rows_desc<D>(kv + 2 * kSub, 0);
  const uint64_t dk_l = sm::rows_desc<D>(kv + kSub, 0);

  // e and dp of the tile from key k0 in s and p, zero past N in either
  // (s[4 j + e]: row ra (e < 2) or rb, key k0 + 8 j + 2 t + (e % 2))
  auto block = [&](int k0, float (&s)[32], float (&p)[32]) {
    __syncthreads();  // the previous tile's products are done with it
    split_rows<D>(kv, kv + kSub, q_base + C, row_stride, k0, kLongTile, N,
                  nullptr, tid, kThreads);
    split_rows<D>(kv + 2 * kSub, kv + 3 * kSub, q_base + 2 * C, row_stride,
                  k0, kLongTile, N, nullptr, tid, kThreads);
    sm::fence_proxy_async();
    __syncthreads();
    two_products<D>(s, p, dq_h, du_h, dk_h, dv_h, false);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        const bool v = k0 + 8 * j + 2 * t + (e & 1) < N && ((e & 2) ? vb : va);
        s[i] = v ? exp_shift(scaled(s[i], a.scale), (e & 2) ? mb : ma) : 0.f;
        p[i] = v ? p[i] : 0.f;
      }
    }
  };

  // ---- walk 1: r = rowsum(dp * e), kept as r * rs ----
  float r0 = 0.f, r1 = 0.f;
  for (int kt = 0; kt < tiles; ++kt) {
    float s[32], p[32];
    block(kLongTile * kt, s, p);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (i & 2)
        r1 = __fadd_rn(r1, __fmul_rn(p[i], s[i]));
      else
        r0 = __fadd_rn(r0, __fmul_rn(p[i], s[i]));
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
    float* rt = a.rt + static_cast<size_t>(bh) * tiles * kLongTile;
    rt[ra] = rt0;
    rt[rb] = rt1;
  }

  // ---- walk 2: ds = e (dp - r rs), dQ += high3(ds, K) ----
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  for (int kt = 0; kt < tiles; ++kt) {
    float s[32], p[32];
    block(kLongTile * kt, s, p);
    // ds split into the A fragments of the tile's 16-key steps
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
      for (int wd = 0; wd < 4; ++wd) {
        const int i = 8 * ks + 2 * wd;
        const float rt = (wd & 1) ? rt1 : rt0;
        sm::split_bf16x2(__fmul_rn(s[i], __fsub_rn(p[i], rt)),
                         __fmul_rn(s[i + 1], __fsub_rn(p[i + 1], rt)),
                         ah[ks][wd], al[ks][wd]);
      }
    }
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      sm::fence_regs(ah[ks]);
      sm::fence_regs(al[ks]);
    }
    // K read MN-major (the transpose bit), 16 keys a step
    sm::wgmma_fence();
    chain3<4>([&](int x, int bl, int ks) {
      sm::WgmmaRS<D>::template mma<1>(
          dq, x ? al[ks] : ah[ks],
          sm::desc_add(bl ? dk_l : dk_h, ks * 16 * kRow), 1);
    });
    sm::wgmma_commit();
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
  sm::warp_colsums<D>(col, colbuf, warp, 0, g, t);
  __syncthreads();
  tile_colsums<D>(colbuf, 0, 1,
                  a.colpart + (static_cast<size_t>(b) * tiles + blockIdx.x) *
                                  row_stride,
                  C, h);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
f32_long_dkdv_kernel(Args a) {
  using L = Layout<D>;
  constexpr int kRow = L::kRow, kSub = L::kSub;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (sm::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* kv = smem;             // K hi, lo, V hi, lo
  unsigned char* qu = smem + 4 * kSub;  // q hi, lo, du hi, lo
  float* colbuf = reinterpret_cast<float*>(smem + 8 * kSub);

  const int tid = threadIdx.x, warp = tid >> 5;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int N = a.n, heads = a.heads, tiles = tiles_of(N);
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int C = heads * D;
  const size_t row_stride = static_cast<size_t>(3) * C;
  const size_t stat0 = static_cast<size_t>(bh) * N;
  const float* q_base = a.qkv + static_cast<size_t>(b) * N * row_stride +
                        h * D;
  const float* do_base = a.d_o + static_cast<size_t>(b) * N * C + h * D;
  const float* rt = a.rt + static_cast<size_t>(bh) * tiles * kLongTile;
  const int k0 = kLongTile * blockIdx.x;
  const int ka = k0 + 16 * warp + g;
  const bool va = ka < N, vb = ka + 8 < N;

  split_rows<D>(kv, kv + kSub, q_base + C, row_stride, k0, kLongTile, N,
                nullptr, tid, kThreads);
  split_rows<D>(kv + 2 * kSub, kv + 3 * kSub, q_base + 2 * C, row_stride, k0,
                kLongTile, N, nullptr, tid, kThreads);
  const uint64_t dk_h = sm::rows_desc<D>(kv, 0);
  const uint64_t dv_h = sm::rows_desc<D>(kv + 2 * kSub, 0);
  const uint64_t dq_h = sm::rows_desc<D>(qu, 0);
  const uint64_t dq_l = sm::rows_desc<D>(qu + kSub, 0);
  const uint64_t du_h = sm::rows_desc<D>(qu + 2 * kSub, 0);
  const uint64_t du_l = sm::rows_desc<D>(qu + 3 * kSub, 0);

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  for (int qt = 0; qt < tiles; ++qt) {
    const int qc = kLongTile * qt;
    __syncthreads();  // the previous chunk's products are done with it
    split_rows<D>(qu, qu + kSub, q_base, row_stride, qc, kLongTile, N,
                  nullptr, tid, kThreads);
    split_rows<D>(qu + 2 * kSub, qu + 3 * kSub, do_base, C, qc, kLongTile, N,
                  a.rs + stat0, tid, kThreads);
    sm::fence_proxy_async();
    __syncthreads();
    // S^T = K q^T and dP^T = V du^T: s[4 j + e] is key ka (e < 2) or ka +
    // 8, query qc + 8 j + 2 t + (e % 2)
    float s[32], p[32];
    two_products<D>(s, p, dq_h, du_h, dk_h, dv_h, true);
    uint32_t eh[4][4], el[4][4], dh[4][4], dl[4][4];
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
    sm::wgmma_fence();
    chain3<4>([&](int x, int bl, int ks) {
      sm::WgmmaRS<D>::template mma<1>(
          dv, x ? el[ks] : eh[ks],
          sm::desc_add(bl ? du_l : du_h, ks * 16 * kRow), 1);
    });
    chain3<4>([&](int x, int bl, int ks) {
      sm::WgmmaRS<D>::template mma<1>(
          dk, x ? dl[ks] : dh[ks],
          sm::desc_add(bl ? dq_l : dq_h, ks * 16 * kRow), 1);
    });
    sm::wgmma_commit();
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
  }

  float colk[D / 4], colv[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) colk[i] = colv[i] = 0.f;
  float* row = a.dqkv + (static_cast<size_t>(b) * N + ka) * row_stride;
  store_rows<D>(dk, a.scale, row + C + h * D, va, vb, row_stride, t, colk);
  store_rows<D>(dv, 1.0f, row + 2 * C + h * D, va, vb, row_stride, t, colv);
  sm::warp_colsums<D>(colk, colbuf, warp, 1, g, t);
  sm::warp_colsums<D>(colv, colbuf, warp, 2, g, t);
  __syncthreads();
  tile_colsums<D>(colbuf, 1, 2,
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
int launch(const Args& a, float* dbias, int B, cudaStream_t stream) {
  const int smem = static_cast<int>(Layout<D>::kBytes);
  cudaError_t e = cudaFuncSetAttribute(
      f32_long_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(f32_long_dkdv_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = (a.n + kLongTile - 1) / kLongTile;
  const dim3 grid(tiles, B * a.heads);
  f32_long_dq_kernel<D><<<grid, kThreads, smem, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  f32_long_dkdv_kernel<D><<<grid, kThreads, smem, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int cols = 3 * a.heads * D;
  f32_long_colsum_kernel<<<(B * cols + 255) / 256, 256, 0, stream>>>(
      a.colpart, dbias, tiles, cols, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

MVT_EXPORT int mvt_attention_core_f32_bwd_long_max_n() { return kLongMaxN; }

// qkv (B, N, 3C), d_o (B, N, C), m and rs (B, heads, N) fp32 -> dqkv (B, N,
// 3C) fp32 and dbias (B, 3C) fp32, the column sums of each image's dqkv;
// scratch rt (B, heads, N_pad) and colpart (B, N_pad / 64, 3C) fp32, N_pad
// = N rounded up to 64; D = C / heads of 32 or 64, 1 <= N <=
// mvt_attention_core_f32_bwd_long_max_n(); qkv and d_o 16-byte aligned.
// *launched: the kernels launched (3 on success).
MVT_EXPORT int mvt_attention_core_f32_bwd_long(
    const void* qkv, const void* d_o, const void* m, const void* rs,
    void* dqkv, void* dbias, void* rt, void* colpart, int B, int N,
    int heads, int D, float scale, int* launched, void* stream) {
  *launched = 0;
  if (B <= 0 || heads <= 0 || N <= 0 || N > kLongMaxN ||
      static_cast<long long>(B) * heads > 65535 || rt == nullptr ||
      colpart == nullptr || reinterpret_cast<uintptr_t>(qkv) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(d_o) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(qkv), static_cast<const float*>(d_o),
               static_cast<const float*>(m),   static_cast<const float*>(rs),
               static_cast<float*>(dqkv),      static_cast<float*>(rt),
               static_cast<float*>(colpart),   N,
               heads,                          scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (D == 64)
    err = launch<64>(a, static_cast<float*>(dbias), B, s);
  else if (D == 32)
    err = launch<32>(a, static_cast<float*>(dbias), B, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (err == 0) *launched = kLaunches;
  return err;
}
