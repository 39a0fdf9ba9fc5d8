// attention_core_bwd: the per-head part of the TPU attention block's
// backward (myrtle_vision_tpu/ops/fused_attention_block.py
// `_bwd_one_image`, the loop over heads).
//
// Inputs: qkv (B, N, 3C) bf16 in feature order [3][h][d], the output-
// projection gradient d_o = do @ Wp^T (B, N, C) fp32, and the forward's
// saved rowmax m and reciprocal rowsum rs (B, H, N) fp32.  Per head, as
// the TPU kernel does it:
//   qs  = bf16(q * scale)            du = bf16(d_o_h * rs)
//   s   = qs . k^T      (fp32)       e  = exp(s - m)   (the saved m)
//   dp  = du . v^T      (fp32)       r  = rowsum(dp * e)
//   ds  = e * (dp - r * rs)          dsb = bf16(ds),  eb = bf16(e)
//   dq  = (dsb . k) * scale          dk = dsb^T . qs    dv = eb^T . du
// Outputs: dqkv (B, N, 3C) bf16, the fp32 values rounded once, in the
// same [3][h][d] column order; and their column sums per image,
// (B, 3C) fp32, summed over the fp32 values (the caller adds the images
// for dbqkv).
//
// One block per (image, head) holds qs, k, v and du of the head in shared
// memory (rows padded to a multiple of 16 and zero-filled), so dk and dv,
// sums over all queries, stay inside the block, as the TPU kernel keeps
// them inside one program.  Every product runs on the tensor cores (WMMA
// 16x16x16, bf16 in, fp32 out), one 16x16 score tile at a time, so no
// score row is held: three passes recompute s and dp from the operands in
// shared memory instead.
//   pass 1, per 16-query tile: r = rowsum(dp * e) for every query
//   pass 2, per 16-query tile: ds, then dq = ds . K over all key tiles
//   pass 3, per 16-key tile:   e and ds, then dv = e^T . du and
//                              dk = ds^T . qs over all query tiles
// That is nine N x N x D products against the forward's two; what bounds
// this design is that recompute and shared-memory traffic, not device
// memory.  Every sum runs in a fixed order, so results are bitwise
// reproducible.  This kernel takes N <= kMaxN.
//
// Longer sequences (the fused block runs up to the `fuses_at` gate of
// myrtle_vision_tpu/ops/fused_attention_block.py, 701 tokens at 6 heads of
// 64: YOLOS-S training at 256-384 px, 357-677 tokens) take the KV-tiled
// kernels of flash_bwd_tiles.cuh in their kCore form, with the same
// conventions: a pre-pass writes du = bf16(d_o * rs) (B, N, C); the dq
// kernel walks the key tiles twice, first for r = rowsum(dp * e) of its
// 64 queries (written out as r * rs), then for dq; the dk/dv kernel walks
// the query tiles once; each writes its tile's fp32 column sums, and a
// last pass adds them up per image in tile order.  Four kernels, no
// atomics, the same fixed summation order on every run.
#include <mma.h>

#include "common.cuh"
#include "flash_bwd_tiles.cuh"

namespace {

using namespace nvcuda;
using mvt::bf16;

constexpr int kWarps = 8;
constexpr int kMaxN = 256;
constexpr int SLD = 16 + 4;  // fp32 staging of one 16x16 tile
constexpr int PLD = 16 + 8;  // bf16 staging of one 16x16 tile

template <int D>
struct Layout {
  static constexpr int KLD = D + 8;  // padded rows of qs, k, v, du
  int n_pad;
  __host__ __device__ explicit Layout(int n) : n_pad((n + 15) / 16 * 16) {}
  __host__ __device__ size_t bytes() const {
    return sizeof(bf16) * 4 * static_cast<size_t>(n_pad) * KLD +
           sizeof(float) * 3 * static_cast<size_t>(n_pad) +
           kWarps * (sizeof(float) * 2 * 16 * SLD +
                     sizeof(bf16) * 2 * 16 * PLD) +
           sizeof(float) * kWarps * 3 * D;
  }
};

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragAT = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBT = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// s = qs_i . k_j^T and dp = du_i . v_j^T for query tile i, key tile j, into
// the warp's fp32 staging tiles (row = query, column = key)
template <int D>
__device__ __forceinline__ void scores(const bf16* Qs, const bf16* Ks,
                                       const bf16* Vs, const bf16* Us,
                                       int i, int j, float* s_w, float* p_w) {
  constexpr int KLD = Layout<D>::KLD;
  FragC s, p;
  wmma::fill_fragment(s, 0.0f);
  wmma::fill_fragment(p, 0.0f);
#pragma unroll
  for (int k = 0; k < D / 16; ++k) {
    FragA qa, ua;
    FragBT kb, vb;  // k and v rows (key, d) read as the column-major K^T
    wmma::load_matrix_sync(qa, Qs + i * 16 * KLD + k * 16, KLD);
    wmma::load_matrix_sync(kb, Ks + j * 16 * KLD + k * 16, KLD);
    wmma::mma_sync(s, qa, kb, s);
    wmma::load_matrix_sync(ua, Us + i * 16 * KLD + k * 16, KLD);
    wmma::load_matrix_sync(vb, Vs + j * 16 * KLD + k * 16, KLD);
    wmma::mma_sync(p, ua, vb, p);
  }
  wmma::store_matrix_sync(s_w, s, SLD, wmma::mem_row_major);
  wmma::store_matrix_sync(p_w, p, SLD, wmma::mem_row_major);
  __syncwarp();
}

// writes one 16 x D tile of fp32 fragments (times `mul`) as bf16 into
// dqkv columns [col0, col0 + D) of rows row0..row0+15 (< N), and adds the
// fp32 values of each of the lane's columns (dt * 16 + (lane & 15)) to
// col_acc[dt]
template <int D>
__device__ __forceinline__ void store_tile(FragC (&frag)[D / 16], float mul,
                                           float* s_w, bf16* dqkv,
                                           size_t row_stride, int row0, int N,
                                           int col0, float (&col_acc)[D / 16],
                                           int lane) {
#pragma unroll
  for (int dt = 0; dt < D / 16; ++dt) {
    wmma::store_matrix_sync(s_w, frag[dt], SLD, wmma::mem_row_major);
    __syncwarp();
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int idx = t * 32 + lane;
      const int r = idx >> 4, c = idx & 15;
      if (row0 + r < N) {
        const float v = s_w[r * SLD + c] * mul;
        dqkv[(row0 + r) * row_stride + col0 + dt * 16 + c] =
            __float2bfloat16_rn(v);
        col_acc[dt] += v;
      }
    }
    __syncwarp();
  }
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
attention_core_bwd_kernel(const bf16* __restrict__ qkv,
                          const float* __restrict__ d_o,
                          const float* __restrict__ m_in,
                          const float* __restrict__ rs_in,
                          bf16* __restrict__ dqkv, float* __restrict__ dbias,
                          int N, int heads, float scale) {
  constexpr int KLD = Layout<D>::KLD;
  const int n_pad = Layout<D>(N).n_pad;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // n_pad x KLD each
  bf16* Ks = Qs + n_pad * KLD;
  bf16* Vs = Ks + n_pad * KLD;
  bf16* Us = Vs + n_pad * KLD;
  float* Ms = reinterpret_cast<float*>(Us + n_pad * KLD);  // n_pad each
  float* RSs = Ms + n_pad;
  float* Rr = RSs + n_pad;
  unsigned char* warp_base = reinterpret_cast<unsigned char*>(Rr + n_pad);
  float* colbuf = reinterpret_cast<float*>(
      warp_base + kWarps * (sizeof(float) * 2 * 16 * SLD +
                            sizeof(bf16) * 2 * 16 * PLD));  // kWarps x 3D

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const int C = heads * D;
  const size_t row_stride = static_cast<size_t>(3) * C;
  const bf16* base = qkv + static_cast<size_t>(b) * N * row_stride + h * D;
  const float* do_base = d_o + static_cast<size_t>(b) * N * C + h * D;
  const size_t stat0 = static_cast<size_t>(blockIdx.x) * N;
  bf16* out = dqkv + static_cast<size_t>(b) * N * row_stride;

  unsigned char* mine =
      warp_base + warp * (sizeof(float) * 2 * 16 * SLD +
                          sizeof(bf16) * 2 * 16 * PLD);
  float* s_w = reinterpret_cast<float*>(mine);  // 16 x SLD
  float* p_w = s_w + 16 * SLD;                  // 16 x SLD
  bf16* e_w = reinterpret_cast<bf16*>(p_w + 16 * SLD);  // 16 x PLD
  bf16* ds_w = e_w + 16 * PLD;                          // 16 x PLD

  // ---- operands of the head, zero rows past N ----
  for (int c = tid; c < n_pad * (D / 8); c += blockDim.x) {
    const int j = c / (D / 8), d0 = (c % (D / 8)) * 8;
    uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
    if (j < N) {
      const bf16* row = base + static_cast<size_t>(j) * row_stride + d0;
      kv = *reinterpret_cast<const uint4*>(row + C);
      vv = *reinterpret_cast<const uint4*>(row + 2 * C);
    }
    *reinterpret_cast<uint4*>(&Ks[j * KLD + d0]) = kv;
    *reinterpret_cast<uint4*>(&Vs[j * KLD + d0]) = vv;
  }
  for (int c = tid; c < n_pad * D; c += blockDim.x) {
    const int j = c / D, d = c % D;
    float q = 0.f, u = 0.f;
    if (j < N) {
      q = __bfloat162float(base[static_cast<size_t>(j) * row_stride + d]) *
          scale;
      u = do_base[static_cast<size_t>(j) * C + d] * rs_in[stat0 + j];
    }
    Qs[j * KLD + d] = __float2bfloat16_rn(q);
    Us[j * KLD + d] = __float2bfloat16_rn(u);
  }
  for (int j = tid; j < n_pad; j += blockDim.x) {
    Ms[j] = j < N ? m_in[stat0 + j] : 0.f;
    RSs[j] = j < N ? rs_in[stat0 + j] : 0.f;
  }
  __syncthreads();

  const int n_tiles = n_pad / 16;

  // ---- pass 1: r = rowsum(dp * e) per query ----
  for (int i = warp; i < n_tiles; i += kWarps) {
    float r_acc[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) r_acc[t] = 0.f;
    for (int j = 0; j < n_tiles; ++j) {
      scores<D>(Qs, Ks, Vs, Us, i, j, s_w, p_w);
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int idx = t * 32 + lane;
        const int r = idx >> 4, c = idx & 15;
        const int qi = i * 16 + r, kj = j * 16 + c;
        if (qi < N && kj < N)
          r_acc[t] += p_w[r * SLD + c] * expf(s_w[r * SLD + c] - Ms[qi]);
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
  }
  __syncthreads();

  float col_q[D / 16], col_k[D / 16], col_v[D / 16];
#pragma unroll
  for (int dt = 0; dt < D / 16; ++dt) col_q[dt] = col_k[dt] = col_v[dt] = 0.f;

  // ---- pass 2: dq = (ds . K) * scale per query tile ----
  for (int i = warp; i < n_tiles; i += kWarps) {
    FragC dq[D / 16];
#pragma unroll
    for (int dt = 0; dt < D / 16; ++dt) wmma::fill_fragment(dq[dt], 0.0f);
    for (int j = 0; j < n_tiles; ++j) {
      scores<D>(Qs, Ks, Vs, Us, i, j, s_w, p_w);
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int idx = t * 32 + lane;
        const int r = idx >> 4, c = idx & 15;
        const int qi = i * 16 + r, kj = j * 16 + c;
        float ds = 0.f;
        if (qi < N && kj < N) {
          const float e = expf(s_w[r * SLD + c] - Ms[qi]);
          ds = e * (p_w[r * SLD + c] - Rr[qi] * RSs[qi]);
        }
        ds_w[r * PLD + c] = __float2bfloat16_rn(ds);
      }
      __syncwarp();
      FragA dsa;
      wmma::load_matrix_sync(dsa, ds_w, PLD);
#pragma unroll
      for (int dt = 0; dt < D / 16; ++dt) {
        FragB kb;
        wmma::load_matrix_sync(kb, Ks + j * 16 * KLD + dt * 16, KLD);
        wmma::mma_sync(dq[dt], dsa, kb, dq[dt]);
      }
      __syncwarp();  // ds_w and the staging tiles are rewritten next
    }
    store_tile<D>(dq, scale, s_w, out, row_stride, i * 16, N, h * D, col_q,
                  lane);
  }

  // ---- pass 3: dv = e^T . du and dk = ds^T . qs per key tile ----
  for (int j = warp; j < n_tiles; j += kWarps) {
    FragC dk[D / 16], dv[D / 16];
#pragma unroll
    for (int dt = 0; dt < D / 16; ++dt) {
      wmma::fill_fragment(dk[dt], 0.0f);
      wmma::fill_fragment(dv[dt], 0.0f);
    }
    for (int i = 0; i < n_tiles; ++i) {
      scores<D>(Qs, Ks, Vs, Us, i, j, s_w, p_w);
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int idx = t * 32 + lane;
        const int r = idx >> 4, c = idx & 15;
        const int qi = i * 16 + r, kj = j * 16 + c;
        float e = 0.f, ds = 0.f;
        if (qi < N && kj < N) {
          e = expf(s_w[r * SLD + c] - Ms[qi]);
          ds = e * (p_w[r * SLD + c] - Rr[qi] * RSs[qi]);
        }
        e_w[r * PLD + c] = __float2bfloat16_rn(e);
        ds_w[r * PLD + c] = __float2bfloat16_rn(ds);
      }
      __syncwarp();
      // the (query, key) tiles read column-major are their transposes
      FragAT ea, dsa;
      wmma::load_matrix_sync(ea, e_w, PLD);
      wmma::load_matrix_sync(dsa, ds_w, PLD);
#pragma unroll
      for (int dt = 0; dt < D / 16; ++dt) {
        FragB ub, qb;
        wmma::load_matrix_sync(ub, Us + i * 16 * KLD + dt * 16, KLD);
        wmma::mma_sync(dv[dt], ea, ub, dv[dt]);
        wmma::load_matrix_sync(qb, Qs + i * 16 * KLD + dt * 16, KLD);
        wmma::mma_sync(dk[dt], dsa, qb, dk[dt]);
      }
      __syncwarp();
    }
    store_tile<D>(dk, 1.0f, s_w, out, row_stride, j * 16, N, C + h * D,
                  col_k, lane);
    store_tile<D>(dv, 1.0f, s_w, out, row_stride, j * 16, N, 2 * C + h * D,
                  col_v, lane);
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
    for (int w = 0; w < kWarps; ++w) s += colbuf[w * 3 * D + c];
    const int sec = c / D, d = c % D;
    dbias[static_cast<size_t>(b) * 3 * C + sec * C + h * D + d] = s;
  }
}

template <int D>
int launch(const void* qkv, const void* d_o, const void* m, const void* rs,
           void* dqkv, void* dbias, int B, int N, int heads, float scale,
           cudaStream_t stream) {
  const size_t smem = Layout<D>(N).bytes();
  cudaError_t err = cudaFuncSetAttribute(
      attention_core_bwd_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_core_bwd_kernel<D><<<B * heads, kWarps * 32, smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const float*>(d_o),
      static_cast<const float*>(m), static_cast<const float*>(rs),
      static_cast<bf16*>(dqkv), static_cast<float*>(dbias), N, heads, scale);
  return static_cast<int>(cudaGetLastError());
}

// du = bf16(d_o * rs): the fp32 (B, N, C) output-projection gradient
// scaled by each row's reciprocal rowsum, (B, N, C) bf16
__global__ void __launch_bounds__(256)
core_bwd_du_kernel(const float* __restrict__ d_o, const float* __restrict__ rs,
                   bf16* __restrict__ du, int N, int heads, int D,
                   long long total) {
  const int C = heads * D;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int c = static_cast<int>(i % C);
    const long long bn = i / C;
    const int row = static_cast<int>(bn % N);
    const long long b = bn / N;
    du[i] = __float2bfloat16_rn(d_o[i] * rs[(b * heads + c / D) * N + row]);
  }
}

// dbias[b, c] = sum over the tiles t, in order, of colpart[b, t, c]
__global__ void __launch_bounds__(256)
core_bwd_colsum_kernel(const float* __restrict__ colpart,
                       float* __restrict__ dbias, int tiles, int cols,
                       int images) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= images * cols) return;
  const int b = i / cols, c = i % cols;
  float s = 0.f;
  for (int t = 0; t < tiles; ++t)
    s += colpart[(static_cast<size_t>(b) * tiles + t) * cols + c];
  dbias[i] = s;
}

template <int D>
int launch_long(const void* qkv, const void* d_o, const void* m,
                const void* rs, void* dqkv, void* dbias, void* du,
                void* rowterm, void* colpart, int B, int N, int heads,
                float scale, cudaStream_t stream) {
  const int C = heads * D;
  const long long total = static_cast<long long>(B) * N * C;
  const int blocks = static_cast<int>(
      (total + 255) / 256 < 8192 ? (total + 255) / 256 : 8192);
  core_bwd_du_kernel<<<blocks, 256, 0, stream>>>(
      static_cast<const float*>(d_o), static_cast<const float*>(rs),
      static_cast<bf16*>(du), N, heads, D, total);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mvt::flash::BwdParams p;
  const bf16* base = static_cast<const bf16*>(qkv);
  bf16* out = static_cast<bf16*>(dqkv);
  p.q = base;
  p.k = base + C;
  p.v = base + 2 * C;
  p.u = static_cast<const bf16*>(du);
  p.beta = static_cast<const float*>(m);
  p.rowterm = static_cast<float*>(rowterm);
  p.rs = static_cast<const float*>(rs);
  p.dq = out;
  p.dk = out + C;
  p.dv = out + 2 * C;
  p.colpart = static_cast<float*>(colpart);
  p.in_image = static_cast<long long>(N) * 3 * C;
  p.in_head = D;
  p.in_row = 3 * C;
  p.u_image = static_cast<long long>(N) * C;
  p.u_head = D;
  p.u_row = C;
  p.out_image = p.in_image;
  p.out_head = D;
  p.out_row = 3 * C;
  p.heads = heads;
  p.n = N;
  p.n_valid = N;
  p.scale = scale;
  const int e = mvt::flash::launch_bwd<D, true>(p, B, stream);
  if (e != 0) return e;
  const int tiles = (N + mvt::flash::kBM - 1) / mvt::flash::kBM;
  core_bwd_colsum_kernel<<<(B * 3 * C + 255) / 256, 256, 0, stream>>>(
      p.colpart, static_cast<float*>(dbias), tiles, 3 * C, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// the scratch of sequences longer than kMaxN (null up to it): du (B, N, C)
// bf16, rowterm (B, heads, N) fp32, colpart (B, ceil(N / 64), 3C) fp32.
// *launched receives the kernels launched: 1 up to kMaxN, else 4.
MVT_EXPORT int mvt_attention_core_bwd(const void* qkv, const void* d_o,
                                      const void* m, const void* rs,
                                      void* dqkv, void* dbias, void* du,
                                      void* rowterm, void* colpart, int B,
                                      int N, int heads, int D, float scale,
                                      int* launched, void* stream) {
  *launched = 0;
  if (B <= 0 || heads <= 0 || N <= 0 ||
      static_cast<long long>(B) * heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (D != 64 && D != 32) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (N > kMaxN) {
    if (du == nullptr || rowterm == nullptr || colpart == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    err = D == 64 ? launch_long<64>(qkv, d_o, m, rs, dqkv, dbias, du, rowterm,
                                    colpart, B, N, heads, scale, s)
                  : launch_long<32>(qkv, d_o, m, rs, dqkv, dbias, du, rowterm,
                                    colpart, B, N, heads, scale, s);
    if (err == 0) *launched = 4;
    return err;
  }
  err = D == 64
            ? launch<64>(qkv, d_o, m, rs, dqkv, dbias, B, N, heads, scale, s)
            : launch<32>(qkv, d_o, m, rs, dqkv, dbias, B, N, heads, scale, s);
  if (err == 0) *launched = 1;
  return err;
}
