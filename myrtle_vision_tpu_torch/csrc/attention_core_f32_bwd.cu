// attention_core_f32_bwd: the per-head part of the TPU attention block's
// backward in a stateless float format (myrtle_vision_tpu/ops/
// fused_attention_block.py `_bwd_one_image` with qspec set, the loop over
// heads), fp32 throughout.
//
// Inputs: qkv (B, N, 3C) fp32 in feature order [3][h][d] (the forward's
// snapped rows), the output-projection gradient d_o = do @ Wp^T (B, N, C)
// fp32, and the forward's rowmax m and reciprocal rowsum rs (B, H, N) fp32
// (attention_core_f32.cu, snap mode).  Per head, as the TPU kernel does it,
// every product the 3-pass split-bf16 `dot_high3` (x = hi + lo, hi =
// bf16(x), lo = bf16(x - hi); (ah.bh + ah.bl) + al.bh):
//   s   = high3(q, k^T) * scale       e  = exp(s - m)     (the saved m)
//   du  = d_o_h * rs                  dp = high3(du, v^T)
//   r   = rowsum(dp * e)              ds = e * (dp - r * rs)
//   dq  = high3(ds, k) * scale        dk = high3(ds^T, q) * scale
//   dv  = high3(e^T, du)
// The score product is the forward kernel's own, fragment for fragment,
// so e <= 1 holds against the saved m.  Outputs: dqkv (B, N, 3C) fp32 in
// the same [3][h][d] column order, and its column sums per image, (B, 3C)
// fp32 (the caller adds the images for dbqkv).
//
// One block per (image, head) holds the hi and lo halves of K and V (rows
// padded to a multiple of 16 and zero-filled) in dynamic shared memory:
// 4 x 208 x 72 bf16 = 117 KB at N = 197, D = 64, which leaves room for
// eight warps' tiles (N <= 224), or 144 KB at N = 256 and four warps.  A
// warp splits the q and du rows of a 16-query tile into its own tiles as
// it needs them; its e or ds tiles reuse the staging of s and dp, read
// into registers first.  Every product
// runs on the tensor cores (WMMA 16x16x16, bf16 in, fp32 out), one 16x16
// score tile at a time, so no score row is held and s, dp are recomputed
// from the operands instead:
//   pass 1, per 16-query tile: r = rowsum(dp * e), then ds and dq over
//           all key tiles
//   pass 2, per 16-key tile:   e, then dv = e^T . du over all query tiles
//   pass 3, per 16-key tile:   e and ds, then dk = ds^T . q
// Each output fragment keeps three accumulators (hi.hi, hi.lo, lo.hi), so
// dv and dk take separate passes to stay within the registers.  That is
// 3 x 10 products of N x N x D against the forward's 3 x 2, on one block
// an SM: what bounds this design is that recompute and the occupancy the
// shared memory leaves, not device memory.  Every sum runs in a fixed
// order, so results are bitwise reproducible.  N <= kMaxN.
#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace {

using namespace nvcuda;
using mvt::bf16;

constexpr int kMaxN = 256;
constexpr size_t kMaxSmem = 232448;  // 227 KB, a block's most on sm_90
constexpr int SLD = 16 + 4;  // fp32 staging of one 16x16 tile
constexpr int PLD = 16 + 8;  // bf16 staging of one 16x16 tile

template <int D, int W>
struct Layout {
  static constexpr int KLD = D + 8;  // padded bf16 rows of K, V, q, du
  // a warp's tiles: q and du hi / lo (16 x KLD bf16 each), then s and dp
  // (16 x SLD fp32), whose place e or ds hi / lo (16 x PLD bf16) take
  static constexpr size_t kWarpBytes =
      sizeof(bf16) * 4 * 16 * KLD + sizeof(float) * 2 * 16 * SLD;
  int n_pad;
  __host__ __device__ explicit Layout(int n) : n_pad((n + 15) / 16 * 16) {}
  __host__ __device__ size_t bytes() const {
    return sizeof(bf16) * 4 * static_cast<size_t>(n_pad) * KLD +
           sizeof(float) * 3 * static_cast<size_t>(n_pad) +
           W * kWarpBytes + sizeof(float) * W * 3 * D;
  }
};

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragAT = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBT = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ void split(float x, bf16* hi, bf16* lo) {
  const bf16 h = __float2bfloat16_rn(x);
  *hi = h;
  *lo = __float2bfloat16_rn(__fsub_rn(x, __bfloat162float(h)));
}

// a warp's tiles
template <int D>
struct WarpTiles {
  static constexpr int KLD = D + 8;
  bf16 *qh, *ql, *uh, *ul;  // 16 x KLD
  float *s, *p;             // 16 x SLD
  bf16 *th, *tl;            // 16 x PLD, e or ds hi / lo, in s and dp's place
  __device__ explicit WarpTiles(unsigned char* base) {
    qh = reinterpret_cast<bf16*>(base);
    ql = qh + 16 * KLD;
    uh = ql + 16 * KLD;
    ul = uh + 16 * KLD;
    s = reinterpret_cast<float*>(ul + 16 * KLD);
    p = s + 16 * SLD;
    th = reinterpret_cast<bf16*>(s);
    tl = th + 16 * PLD;
  }
};

// the lane's 8 values of a 16 x 16 tile (row 2t + (lane >> 4), column
// lane & 15) split into the warp's th / tl tiles, once every lane has read
// s and dp, which they overwrite
__device__ __forceinline__ void put_tile(const float (&v)[8], bf16* th,
                                         bf16* tl, int lane) {
  __syncwarp();
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const int idx = t * 32 + lane;
    const int r = idx >> 4, c = idx & 15;
    split(v[t], &th[r * PLD + c], &tl[r * PLD + c]);
  }
  __syncwarp();
}

// the q rows and du = d_o * rs rows q0..q0+15 of the head (zeros past N),
// split into the warp's tiles
template <int D>
__device__ __forceinline__ void load_rows(const WarpTiles<D>& w,
                                          const float* q_base,
                                          const float* do_base,
                                          const float* RSs, int q0, int N,
                                          size_t row_stride, int C,
                                          int lane) {
  constexpr int KLD = D + 8;
  for (int c = lane; c < 16 * D; c += 32) {
    const int i = c / D, d = c % D;
    const int row = q0 + i;
    float q = 0.f, u = 0.f;
    if (row < N) {
      q = q_base[static_cast<size_t>(row) * row_stride + d];
      u = __fmul_rn(do_base[static_cast<size_t>(row) * C + d], RSs[row]);
    }
    split(q, &w.qh[i * KLD + d], &w.ql[i * KLD + d]);
    split(u, &w.uh[i * KLD + d], &w.ul[i * KLD + d]);
  }
  __syncwarp();
}

// s = high3(q_i, k_j^T) * scale into w.s and, with kDp, dp = high3(du_i,
// v_j^T) into w.p, for the warp's query tile and key tile j; the score
// product is attention_core_f32.cu's, in the same order
template <int D, bool kDp>
__device__ __forceinline__ void scores(const WarpTiles<D>& w, const bf16* Kh,
                                       const bf16* Kl, const bf16* Vh,
                                       const bf16* Vl, int j, float scale) {
  constexpr int KLD = D + 8;
  {
    FragC hh, hl, lh;
    wmma::fill_fragment(hh, 0.0f);
    wmma::fill_fragment(hl, 0.0f);
    wmma::fill_fragment(lh, 0.0f);
#pragma unroll
    for (int k = 0; k < D / 16; ++k) {
      FragA ah, al;
      FragBT bh, bl;  // K rows (key, d) read as the column-major K^T
      wmma::load_matrix_sync(ah, w.qh + k * 16, KLD);
      wmma::load_matrix_sync(al, w.ql + k * 16, KLD);
      wmma::load_matrix_sync(bh, Kh + j * 16 * KLD + k * 16, KLD);
      wmma::load_matrix_sync(bl, Kl + j * 16 * KLD + k * 16, KLD);
      wmma::mma_sync(hh, ah, bh, hh);
      wmma::mma_sync(hl, ah, bl, hl);
      wmma::mma_sync(lh, al, bh, lh);
    }
#pragma unroll
    for (int e = 0; e < hh.num_elements; ++e)
      hh.x[e] =
          __fmul_rn(__fadd_rn(__fadd_rn(hh.x[e], hl.x[e]), lh.x[e]), scale);
    wmma::store_matrix_sync(w.s, hh, SLD, wmma::mem_row_major);
  }
  if (kDp) {
    FragC hh, hl, lh;
    wmma::fill_fragment(hh, 0.0f);
    wmma::fill_fragment(hl, 0.0f);
    wmma::fill_fragment(lh, 0.0f);
#pragma unroll
    for (int k = 0; k < D / 16; ++k) {
      FragA ah, al;
      FragBT bh, bl;
      wmma::load_matrix_sync(ah, w.uh + k * 16, KLD);
      wmma::load_matrix_sync(al, w.ul + k * 16, KLD);
      wmma::load_matrix_sync(bh, Vh + j * 16 * KLD + k * 16, KLD);
      wmma::load_matrix_sync(bl, Vl + j * 16 * KLD + k * 16, KLD);
      wmma::mma_sync(hh, ah, bh, hh);
      wmma::mma_sync(hl, ah, bl, hl);
      wmma::mma_sync(lh, al, bh, lh);
    }
#pragma unroll
    for (int e = 0; e < hh.num_elements; ++e)
      hh.x[e] = __fadd_rn(__fadd_rn(hh.x[e], hl.x[e]), lh.x[e]);
    wmma::store_matrix_sync(w.p, hh, SLD, wmma::mem_row_major);
  }
  __syncwarp();
}

// acc[dt][*] += a (16 x 16, hi and lo tiles at ah / al, stride PLD; its
// transpose when kT) times b (rows b0..b0+15 of a hi / lo (n, D) operand,
// stride KLD), three passes
template <int D, bool kT>
__device__ __forceinline__ void mma3(FragC (&acc)[D / 16][3], const bf16* ah,
                                     const bf16* al, const bf16* bh,
                                     const bf16* bl) {
  constexpr int KLD = D + 8;
  using FA = typename std::conditional<kT, FragAT, FragA>::type;
  FA fh, fl;
  wmma::load_matrix_sync(fh, ah, PLD);
  wmma::load_matrix_sync(fl, al, PLD);
#pragma unroll
  for (int dt = 0; dt < D / 16; ++dt) {
    FragB gh, gl;
    wmma::load_matrix_sync(gh, bh + dt * 16, KLD);
    wmma::load_matrix_sync(gl, bl + dt * 16, KLD);
    wmma::mma_sync(acc[dt][0], fh, gh, acc[dt][0]);
    wmma::mma_sync(acc[dt][1], fh, gl, acc[dt][1]);
    wmma::mma_sync(acc[dt][2], fl, gh, acc[dt][2]);
  }
}

template <int D>
__device__ __forceinline__ void zero(FragC (&acc)[D / 16][3]) {
#pragma unroll
  for (int dt = 0; dt < D / 16; ++dt)
#pragma unroll
    for (int t = 0; t < 3; ++t) wmma::fill_fragment(acc[dt][t], 0.0f);
}

// writes one 16 x D tile, ((P1 + P2) + P3) * mul, into dqkv columns
// [col0, col0 + D) of rows row0..row0+15 (< N), and adds each of the
// lane's columns (dt * 16 + (lane & 15)) to col_acc[dt]
template <int D>
__device__ __forceinline__ void store_tile(FragC (&acc)[D / 16][3], float mul,
                                           float* s_w, float* out,
                                           size_t row_stride, int row0, int N,
                                           int col0, float (&col_acc)[D / 16],
                                           int lane) {
#pragma unroll
  for (int dt = 0; dt < D / 16; ++dt) {
#pragma unroll
    for (int e = 0; e < acc[dt][0].num_elements; ++e)
      acc[dt][0].x[e] = __fmul_rn(
          __fadd_rn(__fadd_rn(acc[dt][0].x[e], acc[dt][1].x[e]),
                    acc[dt][2].x[e]),
          mul);
    wmma::store_matrix_sync(s_w, acc[dt][0], SLD, wmma::mem_row_major);
    __syncwarp();
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int idx = t * 32 + lane;
      const int r = idx >> 4, c = idx & 15;
      if (row0 + r < N) {
        const float v = s_w[r * SLD + c];
        out[static_cast<size_t>(row0 + r) * row_stride + col0 + dt * 16 + c] =
            v;
        col_acc[dt] += v;
      }
    }
    __syncwarp();
  }
}

template <int D, int W>
__global__ void __launch_bounds__(W * 32)
attention_core_f32_bwd_kernel(const float* __restrict__ qkv,
                              const float* __restrict__ d_o,
                              const float* __restrict__ m_in,
                              const float* __restrict__ rs_in,
                              float* __restrict__ dqkv,
                              float* __restrict__ dbias, int N, int heads,
                              float scale) {
  constexpr int KLD = D + 8;
  using L = Layout<D, W>;
  const int n_pad = L(N).n_pad;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Kh = reinterpret_cast<bf16*>(smem);  // n_pad x KLD each
  bf16* Kl = Kh + n_pad * KLD;
  bf16* Vh = Kl + n_pad * KLD;
  bf16* Vl = Vh + n_pad * KLD;
  float* Ms = reinterpret_cast<float*>(Vl + n_pad * KLD);  // n_pad each
  float* RSs = Ms + n_pad;
  float* Rr = RSs + n_pad;
  unsigned char* warp_base = reinterpret_cast<unsigned char*>(Rr + n_pad);
  float* colbuf = reinterpret_cast<float*>(warp_base +
                                            W * L::kWarpBytes);  // W x 3D

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const int C = heads * D;
  const size_t row_stride = static_cast<size_t>(3) * C;
  const float* q_base = qkv + static_cast<size_t>(b) * N * row_stride + h * D;
  const float* do_base = d_o + static_cast<size_t>(b) * N * C + h * D;
  const size_t stat0 = static_cast<size_t>(blockIdx.x) * N;
  float* out = dqkv + static_cast<size_t>(b) * N * row_stride;
  const WarpTiles<D> w(warp_base + warp * L::kWarpBytes);

  // ---- K and V halves of the head, zero rows past N; the statistics ----
  for (int c = tid; c < n_pad * D; c += blockDim.x) {
    const int j = c / D, d = c % D;
    float kf = 0.f, vf = 0.f;
    if (j < N) {
      const float* row = q_base + static_cast<size_t>(j) * row_stride + d;
      kf = row[C];
      vf = row[2 * C];
    }
    split(kf, &Kh[j * KLD + d], &Kl[j * KLD + d]);
    split(vf, &Vh[j * KLD + d], &Vl[j * KLD + d]);
  }
  for (int j = tid; j < n_pad; j += blockDim.x) {
    Ms[j] = j < N ? m_in[stat0 + j] : 0.f;
    RSs[j] = j < N ? rs_in[stat0 + j] : 0.f;
  }
  __syncthreads();

  const int n_tiles = n_pad / 16;
  float col_q[D / 16], col_k[D / 16], col_v[D / 16];
#pragma unroll
  for (int dt = 0; dt < D / 16; ++dt) col_q[dt] = col_k[dt] = col_v[dt] = 0.f;
  FragC acc[D / 16][3];

  // ---- pass 1: r = rowsum(dp * e), then dq = high3(ds, K) * scale, per
  // query tile ----
  for (int i = warp; i < n_tiles; i += W) {
    load_rows<D>(w, q_base, do_base, RSs, i * 16, N, row_stride, C, lane);
    float r_acc[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) r_acc[t] = 0.f;
    for (int j = 0; j < n_tiles; ++j) {
      scores<D, true>(w, Kh, Kl, Vh, Vl, j, scale);
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int idx = t * 32 + lane;
        const int r = idx >> 4, c = idx & 15;
        const int qi = i * 16 + r, kj = j * 16 + c;
        if (qi < N && kj < N)
          r_acc[t] = __fadd_rn(
              r_acc[t],
              __fmul_rn(w.p[r * SLD + c],
                        expf(__fsub_rn(w.s[r * SLD + c], Ms[qi]))));
      }
      __syncwarp();
    }
    // the 16 lanes of a row hold its 16 column partials
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      float v = r_acc[t];
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if ((lane & 15) == 0) Rr[i * 16 + 2 * t + (lane >> 4)] = v;
    }
    __syncwarp();
    zero<D>(acc);
    for (int j = 0; j < n_tiles; ++j) {
      scores<D, true>(w, Kh, Kl, Vh, Vl, j, scale);
      float ds[8];
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int idx = t * 32 + lane;
        const int r = idx >> 4, c = idx & 15;
        const int qi = i * 16 + r, kj = j * 16 + c;
        ds[t] = 0.f;
        if (qi < N && kj < N) {
          const float e = expf(__fsub_rn(w.s[r * SLD + c], Ms[qi]));
          ds[t] = __fmul_rn(e, __fsub_rn(w.p[r * SLD + c],
                                         __fmul_rn(Rr[qi], RSs[qi])));
        }
      }
      put_tile(ds, w.th, w.tl, lane);
      mma3<D, false>(acc, w.th, w.tl, Kh + j * 16 * KLD, Kl + j * 16 * KLD);
      __syncwarp();  // the tiles are rewritten next
    }
    store_tile<D>(acc, scale, w.s, out, row_stride, i * 16, N, h * D, col_q,
                  lane);
  }
  __syncthreads();  // r of every query row

  // ---- pass 2: dv = high3(e^T, du) per key tile ----
  for (int j = warp; j < n_tiles; j += W) {
    zero<D>(acc);
    for (int i = 0; i < n_tiles; ++i) {
      load_rows<D>(w, q_base, do_base, RSs, i * 16, N, row_stride, C, lane);
      scores<D, false>(w, Kh, Kl, Vh, Vl, j, scale);
      float e[8];
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int idx = t * 32 + lane;
        const int r = idx >> 4, c = idx & 15;
        const int qi = i * 16 + r, kj = j * 16 + c;
        e[t] = (qi < N && kj < N)
                   ? expf(__fsub_rn(w.s[r * SLD + c], Ms[qi]))
                   : 0.f;
      }
      put_tile(e, w.th, w.tl, lane);
      // the (query, key) tile read column-major is its transpose
      mma3<D, true>(acc, w.th, w.tl, w.uh, w.ul);
      __syncwarp();
    }
    store_tile<D>(acc, 1.0f, w.s, out, row_stride, j * 16, N, 2 * C + h * D,
                  col_v, lane);
  }

  // ---- pass 3: dk = high3(ds^T, q) * scale per key tile ----
  for (int j = warp; j < n_tiles; j += W) {
    zero<D>(acc);
    for (int i = 0; i < n_tiles; ++i) {
      load_rows<D>(w, q_base, do_base, RSs, i * 16, N, row_stride, C, lane);
      scores<D, true>(w, Kh, Kl, Vh, Vl, j, scale);
      float ds[8];
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int idx = t * 32 + lane;
        const int r = idx >> 4, c = idx & 15;
        const int qi = i * 16 + r, kj = j * 16 + c;
        ds[t] = 0.f;
        if (qi < N && kj < N) {
          const float e = expf(__fsub_rn(w.s[r * SLD + c], Ms[qi]));
          ds[t] = __fmul_rn(e, __fsub_rn(w.p[r * SLD + c],
                                         __fmul_rn(Rr[qi], RSs[qi])));
        }
      }
      put_tile(ds, w.th, w.tl, lane);
      mma3<D, true>(acc, w.th, w.tl, w.qh, w.ql);
      __syncwarp();
    }
    store_tile<D>(acc, scale, w.s, out, row_stride, j * 16, N, C + h * D,
                  col_k, lane);
  }

  // ---- column sums of the image: lanes l and l + 16 share a column, then
  // the warps in order ----
#pragma unroll
  for (int dt = 0; dt < D / 16; ++dt) {
    const float q = col_q[dt] + __shfl_xor_sync(0xffffffffu, col_q[dt], 16);
    const float k = col_k[dt] + __shfl_xor_sync(0xffffffffu, col_k[dt], 16);
    const float v = col_v[dt] + __shfl_xor_sync(0xffffffffu, col_v[dt], 16);
    if (lane < 16) {
      float* cw = colbuf + warp * 3 * D;
      cw[dt * 16 + lane] = q;
      cw[D + dt * 16 + lane] = k;
      cw[2 * D + dt * 16 + lane] = v;
    }
  }
  __syncthreads();
  for (int c = tid; c < 3 * D; c += blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < W; ++k) s += colbuf[k * 3 * D + c];
    const int sec = c / D, d = c % D;
    dbias[static_cast<size_t>(b) * 3 * C + sec * C + h * D + d] = s;
  }
}

template <int D, int W>
int launch_w(const void* qkv, const void* d_o, const void* m, const void* rs,
             void* dqkv, void* dbias, int B, int N, int heads, float scale,
             cudaStream_t stream) {
  const size_t smem = Layout<D, W>(N).bytes();
  cudaError_t err = cudaFuncSetAttribute(
      attention_core_f32_bwd_kernel<D, W>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_core_f32_bwd_kernel<D, W><<<B * heads, W * 32, smem, stream>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(d_o),
      static_cast<const float*>(m), static_cast<const float*>(rs),
      static_cast<float*>(dqkv), static_cast<float*>(dbias), N, heads, scale);
  return static_cast<int>(cudaGetLastError());
}

// eight warps where their tiles and K, V fit a block's shared memory (N <=
// 224 at D = 64), else four
template <int D>
int launch(const void* qkv, const void* d_o, const void* m, const void* rs,
           void* dqkv, void* dbias, int B, int N, int heads, float scale,
           cudaStream_t stream) {
  if (Layout<D, 8>(N).bytes() <= kMaxSmem)
    return launch_w<D, 8>(qkv, d_o, m, rs, dqkv, dbias, B, N, heads, scale,
                          stream);
  return launch_w<D, 4>(qkv, d_o, m, rs, dqkv, dbias, B, N, heads, scale,
                        stream);
}

}  // namespace

MVT_EXPORT int mvt_attention_core_f32_bwd_max_n() { return kMaxN; }

// qkv (B, N, 3C), d_o (B, N, C), m and rs (B, heads, N) fp32 -> dqkv (B, N,
// 3C) fp32 and dbias (B, 3C) fp32, the column sums of each image's dqkv;
// D = C / heads of 32 or 64, N <= mvt_attention_core_f32_bwd_max_n()
MVT_EXPORT int mvt_attention_core_f32_bwd(const void* qkv, const void* d_o,
                                          const void* m, const void* rs,
                                          void* dqkv, void* dbias, int B,
                                          int N, int heads, int D,
                                          float scale, void* stream) {
  if (B <= 0 || heads <= 0 || N <= 0 || N > kMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch<64>(qkv, d_o, m, rs, dqkv, dbias, B, N, heads, scale, s);
  if (D == 32)
    return launch<32>(qkv, d_o, m, rs, dqkv, dbias, B, N, heads, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
