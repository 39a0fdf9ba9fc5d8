// The backward of softmax attention over KV tiles, on the tensor cores
// (mma.sync m16n8k16, bf16 in, fp32 accumulation), in the shape of
// FlashAttention-2's backward: the probabilities are recomputed from the
// forward's per-row statistic, so no (N, N) matrix is ever stored, and two
// kernels share the work without atomics:
//   dk/dv kernel: one block of 4 warps per 64-key tile of one (image,
//     head), 16 keys a warp; it walks the query tiles (Q and U tiles
//     double-buffered in shared memory with cp.async) and keeps dk and dv
//     in registers;
//   dq kernel: one block per 64-query tile, 16 queries a warp; it walks
//     the key tiles (K and V double-buffered) and keeps dq in registers.
// Every sum runs in a fixed order, so results are bitwise reproducible.
//
// This is the fused attention block's backward core (attention_core_bwd.cu,
// `_bwd_one_image` of myrtle_vision_tpu/ops/fused_attention_block.py) for
// sequences longer than its one-CTA kernel holds.  Per (query row i, key
// j), with qs = bf16(q * scale) (rounded where q is read, as the forward
// core rounds it), the saved rowmax m and reciprocal rowsum rs, du =
// bf16(d_o * rs) from a pre-pass and T_i = r_i * rs_i:
//   s    = qs_i . k_j                   fp32
//   e    = exp(s - m_i)                 0 for j or i >= n_valid
//   dp   = du_i . v_j                   fp32
//   r_i  = rowsum(dp * e)
//   ds   = e * (dp - T_i)
//   dv_j += bf16(e) du_i     dk_j += bf16(ds) qs_i     dq_i += bf16(ds) k_j
// and at the end dq *= scale.  r needs a whole row: the dq kernel walks
// the keys twice, first for r (written out as T for the dk/dv kernel,
// which runs after it), then for dq.  Both kernels also write each tile's
// fp32 column sums of dq, dk and dv, which a last pass adds up per image
// in order (the dbqkv of the block).
//
// Operands are read in place through element strides (image, head, row;
// the head dimension contiguous), outputs written through another set.
// The fragment layouts are those of flash_tiles.cuh: an accumulator tile
// of scores becomes the A operand of the next product in registers, and
// ldmatrix (.trans for a row-major B) reads every other operand.
#pragma once

#include "flash_tiles.cuh"

namespace mvt {
namespace flash {

struct BwdParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* u;        // du
  const float* beta;    // (images * heads, n): the rowmax m
  float* rowterm;       // (images * heads, n): r * rs (written by the dq
                        // kernel)
  const float* rs;      // reciprocal rowsum (images * heads, n)
  bf16* dq;
  bf16* dk;
  bf16* dv;
  float* colpart;       // (images, tiles, 3 * heads * D) or null
  long long in_image;   // element strides of q, k and v
  int in_head, in_row;
  long long u_image;    // element strides of u
  int u_head, u_row;
  long long out_image;  // element strides of dq, dk and dv
  int out_head, out_row;
  int heads, n, n_valid;
  float scale;
};

// dynamic shared memory of both kernels: six 64-row tiles, and the dk/dv
// kernel's row statistics of two query tiles
template <int D>
constexpr size_t bwd_smem_bytes() {
  return sizeof(bf16) * 6 * kBN * (D + 8) + sizeof(float) * 4 * kBM;
}

// acc = rows [r0, r0 + 16) of X times rows [0, 64) of Y transposed, both
// row-major padded tiles (row, d); a tile read with kScale* has its
// elements rounded to bf16(x * scale) first
template <int D, bool kScaleX, bool kScaleY>
__device__ __forceinline__ void tile_xyt(float (&acc)[kBN / 8][4],
                                         const bf16* X, int r0, const bf16* Y,
                                         int lane, float scale) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int i = 0; i < kBN / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, X + (r0 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
    if (kScaleX) {
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = scale_bf16x2(a[r], scale);
    }
#pragma unroll
    for (int np = 0; np < kBN / 16; ++np) {
      // Y row-major (row, d) is the col-major B operand of X Y^T
      uint32_t b[4];
      ldsm_x4(b, Y + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * LD +
                     kk * 16 + ((lane >> 3) & 1) * 8);
      if (kScaleY) {
#pragma unroll
        for (int r = 0; r < 4; ++r) b[r] = scale_bf16x2(b[r], scale);
      }
      mma16816(acc[2 * np], a, b[0], b[1]);
      mma16816(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// out += bf16(P) Z: P the warp's 16 x 64 accumulators (the A operand, in
// registers), Z rows [0, 64) of a row-major padded tile (row, d) read
// transposed as the col-major B operand
template <int D, bool kScaleZ>
__device__ __forceinline__ void tile_pz(float (&out)[D / 8][4],
                                        const float (&P)[kBN / 8][4],
                                        const bf16* Z, int lane, float scale) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    const uint32_t pa[4] = {pack_bf16(P[2 * kk][0], P[2 * kk][1]),
                            pack_bf16(P[2 * kk][2], P[2 * kk][3]),
                            pack_bf16(P[2 * kk + 1][0], P[2 * kk + 1][1]),
                            pack_bf16(P[2 * kk + 1][2], P[2 * kk + 1][3])};
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t z[4];
      ldsm_x4_t(z, Z + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD +
                       dp * 16 + (lane >> 4) * 8);
      if (kScaleZ) {
#pragma unroll
        for (int r = 0; r < 4; ++r) z[r] = scale_bf16x2(z[r], scale);
      }
      mma16816(out[2 * dp], pa, z[0], z[1]);
      mma16816(out[2 * dp + 1], pa, z[2], z[3]);
    }
  }
}

// Writes the warp's 16 rows [row0, row0 + 16) x D of acc * mul as bf16
// (rows < n) at dst + row * row_stride; with colbuf also this warp's fp32
// column sums of the written values into colbuf[warp * D ...]
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4],
                                           float mul, bf16* dst,
                                           int row_stride, int row0, int n,
                                           float* colbuf, int lane, int warp) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    float col[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + g + 8 * i;
      if (row >= n) continue;
      const float x0 = acc[dn][2 * i] * mul, x1 = acc[dn][2 * i + 1] * mul;
      *reinterpret_cast<__nv_bfloat162*>(
          dst + static_cast<size_t>(row) * row_stride + dn * 8 + 2 * t) =
          __floats2bfloat162_rn(x0, x1);
      col[0] += x0;
      col[1] += x1;
    }
    if (colbuf != nullptr) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float v = col[c];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (g == 0) colbuf[warp * D + dn * 8 + 2 * t + c] = v;
      }
    }
  }
}

// the block's column sums (the warps' in order) into colpart section sec
template <int D>
__device__ __forceinline__ void store_colpart(const BwdParams& p,
                                              const float* colbuf, int b,
                                              int h, int sec, int tid) {
  __syncthreads();
  if (tid < D) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += colbuf[w * D + tid];
    const int cols = 3 * p.heads * D;
    p.colpart[(static_cast<size_t>(b) * gridDim.x + blockIdx.x) * cols +
              sec * p.heads * D + h * D + tid] = s;
  }
  __syncthreads();
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_dq_kernel(const BwdParams p) {
  constexpr int LD = D + 8, kTile = kBN * LD;
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(bwd_smem);
  bf16* Us = Qs + kTile;
  bf16* Ks = Us + kTile;      // two stages
  bf16* Vs = Ks + 2 * kTile;  // two stages
  __shared__ float colbuf[kWarps * D];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / p.heads, h = bh % p.heads;
  const int q0 = blockIdx.x * kBM;
  const size_t in_off =
      static_cast<size_t>(b) * p.in_image + static_cast<size_t>(h) * p.in_head;
  const bf16* kb = p.k + in_off;
  const bf16* vb = p.v + in_off;
  const int n_tiles = (p.n_valid + kBN - 1) / kBN;
  const int total = 2 * n_tiles;

  load_tile<D>(Qs, p.q + in_off, q0, p.n, p.in_row, tid);
  load_tile<D>(Us,
               p.u + static_cast<size_t>(b) * p.u_image +
                   static_cast<size_t>(h) * p.u_head,
               q0, p.n, p.u_row, tid);
  load_tile<D>(Ks, kb, 0, p.n, p.in_row, tid);
  load_tile<D>(Vs, vb, 0, p.n, p.in_row, tid);
  cp_async_commit();

  float beta[2], term[2], rsr[2], r[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + warp * 16 + g + 8 * i;
    const size_t si = static_cast<size_t>(bh) * p.n + row;
    const bool ok = row < p.n;
    beta[i] = ok ? p.beta[si] : 0.f;
    term[i] = 0.f;
    rsr[i] = ok ? p.rs[si] : 0.f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int it = 0; it < total; ++it) {
    const int j = it < n_tiles ? it : it - n_tiles;
    const int st = it & 1;
    if (it + 1 < total) {
      const int jn = it + 1 < n_tiles ? it + 1 : it + 1 - n_tiles;
      load_tile<D>(Ks + (st ^ 1) * kTile, kb, jn * kBN, p.n, p.in_row, tid);
      load_tile<D>(Vs + (st ^ 1) * kTile, vb, jn * kBN, p.n, p.in_row, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bool first_walk = it < n_tiles;
    if (it == n_tiles) {
      // r of the lane's rows is complete: T = r * rs, kept for dk/dv
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        r[i] += __shfl_xor_sync(0xffffffffu, r[i], 1);
        r[i] += __shfl_xor_sync(0xffffffffu, r[i], 2);
        term[i] = r[i] * rsr[i];
        const int row = q0 + warp * 16 + g + 8 * i;
        if (t == 0 && row < p.n)
          p.rowterm[static_cast<size_t>(bh) * p.n + row] = term[i];
      }
    }

    float s[kBN / 8][4], dp[kBN / 8][4];
    tile_xyt<D, true, false>(s, Qs, warp * 16, Ks + st * kTile, lane,
                              p.scale);
    tile_xyt<D, false, false>(dp, Us, warp * 16, Vs + st * kTile, lane,
                              p.scale);
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * kBN + nt * 8 + 2 * t + (e & 1);
        const int row = q0 + warp * 16 + g + 8 * (e >> 1);
        const float pv = (col < p.n_valid && row < p.n_valid)
                             ? expf(s[nt][e] - beta[e >> 1])
                             : 0.f;
        if (first_walk)
          r[e >> 1] += dp[nt][e] * pv;
        else
          s[nt][e] = pv * (dp[nt][e] - term[e >> 1]);
      }
    }
    if (!first_walk) tile_pz<D, false>(acc, s, Ks + st * kTile, lane, p.scale);
    __syncthreads();  // this stage is refilled by the next iteration
  }

  const size_t out_off = static_cast<size_t>(b) * p.out_image +
                         static_cast<size_t>(h) * p.out_head;
  const bool sums = p.colpart != nullptr;
  store_rows<D>(acc, p.scale, p.dq + out_off, p.out_row, q0 + warp * 16, p.n,
                sums ? colbuf : nullptr, lane, warp);
  if (sums) store_colpart<D>(p, colbuf, b, h, 0, tid);
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_dkdv_kernel(const BwdParams p) {
  constexpr int LD = D + 8, kTile = kBN * LD;
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  bf16* Ks = reinterpret_cast<bf16*>(bwd_smem);
  bf16* Vs = Ks + kTile;
  bf16* Qs = Vs + kTile;      // two stages
  bf16* Us = Qs + 2 * kTile;  // two stages
  float* Bs = reinterpret_cast<float*>(Us + 2 * kTile);  // [2][kBM] beta
  float* Ts = Bs + 2 * kBM;                               // [2][kBM] T
  __shared__ float colbuf[kWarps * D];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / p.heads, h = bh % p.heads;
  const int k0 = blockIdx.x * kBN;
  const size_t in_off =
      static_cast<size_t>(b) * p.in_image + static_cast<size_t>(h) * p.in_head;
  const bf16* qb = p.q + in_off;
  const bf16* ub = p.u + static_cast<size_t>(b) * p.u_image +
                   static_cast<size_t>(h) * p.u_head;
  const size_t stat0 = static_cast<size_t>(bh) * p.n;
  // keys at or past n_valid get zero gradients: no query tile to walk
  const int n_qt = k0 < p.n_valid ? (p.n_valid + kBM - 1) / kBM : 0;

  auto load_stats = [&](int stage, int row0) {
    if (tid < kBM) {
      const int row = row0 + tid;
      const bool ok = row < p.n;
      Bs[stage * kBM + tid] = ok ? p.beta[stat0 + row] : 0.f;
      Ts[stage * kBM + tid] = ok ? p.rowterm[stat0 + row] : 0.f;
    }
  };
  if (n_qt > 0) {
    load_tile<D>(Ks, p.k + in_off, k0, p.n, p.in_row, tid);
    load_tile<D>(Vs, p.v + in_off, k0, p.n, p.in_row, tid);
    load_tile<D>(Qs, qb, 0, p.n, p.in_row, tid);
    load_tile<D>(Us, ub, 0, p.n, p.u_row, tid);
    cp_async_commit();
    load_stats(0, 0);
  }

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = 0.f;
    dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.f;
  }

  for (int i = 0; i < n_qt; ++i) {
    const int st = i & 1;
    if (i + 1 < n_qt) {
      load_tile<D>(Qs + (st ^ 1) * kTile, qb, (i + 1) * kBM, p.n, p.in_row,
                   tid);
      load_tile<D>(Us + (st ^ 1) * kTile, ub, (i + 1) * kBM, p.n, p.u_row,
                   tid);
      cp_async_commit();
      load_stats(st ^ 1, (i + 1) * kBM);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // S^T and dP^T: rows the warp's 16 keys, columns the 64 queries
    float s[kBN / 8][4], dp[kBN / 8][4];
    tile_xyt<D, false, true>(s, Ks, warp * 16, Qs + st * kTile, lane,
                              p.scale);
    tile_xyt<D, false, false>(dp, Vs, warp * 16, Us + st * kTile, lane,
                              p.scale);
    const float* bs = Bs + st * kBM;
    const float* ts = Ts + st * kBM;
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = nt * 8 + 2 * t + (e & 1);
        const int key = k0 + warp * 16 + g + 8 * (e >> 1);
        const float pv = (key < p.n_valid && i * kBM + qc < p.n_valid)
                             ? expf(s[nt][e] - bs[qc])
                             : 0.f;
        s[nt][e] = pv;
        dp[nt][e] = pv * (dp[nt][e] - ts[qc]);
      }
    }
    tile_pz<D, false>(dv, s, Us + st * kTile, lane, p.scale);
    tile_pz<D, true>(dk, dp, Qs + st * kTile, lane, p.scale);
    __syncthreads();  // this stage is refilled by the next iteration
  }

  const size_t out_off = static_cast<size_t>(b) * p.out_image +
                         static_cast<size_t>(h) * p.out_head;
  const bool sums = p.colpart != nullptr;
  store_rows<D>(dk, 1.f, p.dk + out_off, p.out_row,
                k0 + warp * 16, p.n, sums ? colbuf : nullptr, lane, warp);
  if (sums) store_colpart<D>(p, colbuf, b, h, 1, tid);
  store_rows<D>(dv, 1.f, p.dv + out_off, p.out_row, k0 + warp * 16, p.n,
                sums ? colbuf : nullptr, lane, warp);
  if (sums) store_colpart<D>(p, colbuf, b, h, 2, tid);
}

// grid: (64-row tiles, images x heads) for both kernels, the dq kernel
// first (the dk/dv kernel reads the row term it writes); 2 launches
template <int D>
int launch_bwd(const BwdParams& p, int images, cudaStream_t stream) {
  const int smem = static_cast<int>(bwd_smem_bytes<D>());
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.n + kBM - 1) / kBM, images * p.heads);
  flash_bwd_dq_kernel<D><<<grid, kWarps * 32, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv_kernel<D><<<grid, kWarps * 32, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace flash
}  // namespace mvt
