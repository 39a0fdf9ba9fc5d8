// attention_core: per-head softmax attention over the fused qkv rows.
//
// The per-head part of the TPU attention block kernel
// (myrtle_vision_tpu/ops/fused_attention_block.py `_attn_heads_fwd`,
// called from `_fwd_kernel`).  Input qkv (B, N, 3C) bf16 with feature
// order [3][h][d]; output ctx (B, N, C) bf16, head h at columns h*D...
// For each query row, as the TPU kernel does it:
//   s   = bf16(q * scale) . k^T       fp32 accumulation
//   s   = -inf for keys >= N
//   e   = exp(s - rowmax(s))          fp32
//   u   = bf16(e) . v                 fp32 accumulation
//   out = bf16(u * (1 / rowsum(e)))   rowsum over the fp32 e, exact divide
// When the op records for the backward, the rowmax and the reciprocal
// rowsum of every row also go out, (B, H, N) fp32 each (`_fwd_kernel`'s
// `save_stats` outputs, which attention_core_bwd.cu reads).
//
// One block per (image, head) holds K and V of the head in shared memory
// (rows padded to a multiple of 16 and zero-filled); each warp takes a
// 16-query tile at a time.  Both products run on the tensor cores (WMMA
// 16x16x16, bf16 in, fp32 out): S = Q K^T goes to a per-warp fp32 row
// buffer, the warp takes rowmax / exp / rowsum over it and writes the
// bf16 probabilities over the same buffer, then U = P V, scaled by the
// reciprocal rowsum.  At ViT-S/16 (N=197, D=64) the core is ~15 GFLOP per
// layer at batch 256, against ~178 GFLOP in the projections around it;
// what bounds this design is shared-memory traffic and the fp32 softmax
// between the two products, not the tensor cores.  The whole score row of
// a tile lives in shared memory, which limits N to kMaxN.
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;
using mvt::bf16;

constexpr int kWarps = 8;
constexpr int kMaxN = 256;
constexpr int kMaxI = kMaxN / 32;  // score columns per lane

template <int D>
struct Layout {
  static constexpr int KLD = D + 8;  // padded rows of K, V and Q tiles
  // key rows; fp32 row stride of a warp's 16-row buffer, which holds the
  // scores (n_pad wide), then the probabilities, then U (D wide)
  int n_pad, sld;
  __host__ __device__ explicit Layout(int n)
      : n_pad((n + 15) / 16 * 16),
        sld(((n + 15) / 16 * 16 > D ? (n + 15) / 16 * 16 : D) + 4) {}
  __host__ __device__ size_t bytes() const {
    return sizeof(bf16) * (2 * static_cast<size_t>(n_pad) * KLD +
                           kWarps * 16 * KLD) +
           sizeof(float) * (kWarps * 16 * static_cast<size_t>(sld) +
                            kWarps * 16);
  }
};

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
attention_core_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                      float* __restrict__ m_out, float* __restrict__ rs_out,
                      int N, int heads, float scale) {
  constexpr int KLD = Layout<D>::KLD;
  const Layout<D> lay(N);
  const int n_pad = lay.n_pad, sld = lay.sld;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);  // n_pad x KLD
  bf16* Vs = Ks + n_pad * KLD;               // n_pad x KLD
  bf16* Qs = Vs + n_pad * KLD;               // kWarps x 16 x KLD
  float* Ss = reinterpret_cast<float*>(Qs + kWarps * 16 * KLD);
  float* Rs = Ss + kWarps * 16 * sld;        // kWarps x 16

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const int C = heads * D;
  const size_t row_stride = static_cast<size_t>(3) * C;
  const bf16* base = qkv + static_cast<size_t>(b) * N * row_stride + h * D;

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
  __syncthreads();

  bf16* q_w = Qs + warp * 16 * KLD;
  float* s_w = Ss + warp * 16 * sld;
  bf16* p_w = reinterpret_cast<bf16*>(s_w);  // P row r over S row r
  float* r_w = Rs + warp * 16;
  const int n_tiles = n_pad / 16;

  for (int q0 = warp * 16; q0 < N; q0 += kWarps * 16) {
    for (int c = lane; c < 16 * D; c += 32) {
      const int i = c / D, d = c % D;
      float v = 0.f;
      if (q0 + i < N)
        v = __bfloat162float(base[static_cast<size_t>(q0 + i) * row_stride +
                                  d]) * scale;
      q_w[i * KLD + d] = __float2bfloat16_rn(v);
    }
    __syncwarp();

    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
        qa[D / 16];
#pragma unroll
    for (int k = 0; k < D / 16; ++k)
      wmma::load_matrix_sync(qa[k], q_w + k * 16, KLD);
    for (int nt = 0; nt < n_tiles; ++nt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int k = 0; k < D / 16; ++k) {
        // K row-major (key, d) read as the column-major K^T operand
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;
        wmma::load_matrix_sync(kb, Ks + nt * 16 * KLD + k * 16, KLD);
        wmma::mma_sync(acc, qa[k], kb, acc);
      }
      wmma::store_matrix_sync(s_w + nt * 16, acc, sld, wmma::mem_row_major);
    }
    __syncwarp();

    for (int r = 0; r < 16; ++r) {
      const float* srow = s_w + r * sld;
      float s[kMaxI];
      float m = mvt::neg_inf();
#pragma unroll
      for (int i = 0; i < kMaxI; ++i) {
        const int j = lane + 32 * i;
        s[i] = (j < N) ? srow[j] : mvt::neg_inf();
        m = fmaxf(m, s[i]);
      }
      m = mvt::warp_max(m);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxI; ++i) {
        const int j = lane + 32 * i;
        s[i] = (j < N) ? expf(s[i] - m) : 0.f;
        sum += s[i];
      }
      sum = mvt::warp_sum(sum);
      __syncwarp();  // the row is read in full before P overwrites it
      bf16* prow = p_w + r * 2 * sld;
#pragma unroll
      for (int i = 0; i < kMaxI; ++i) {
        const int j = lane + 32 * i;
        if (j < n_pad) prow[j] = __float2bfloat16_rn(s[i]);
      }
      if (lane == 0) {
        r_w[r] = 1.0f / sum;
        if (m_out != nullptr && q0 + r < N) {
          const size_t o = static_cast<size_t>(blockIdx.x) * N + q0 + r;
          m_out[o] = m;
          rs_out[o] = 1.0f / sum;
        }
      }
    }
    __syncwarp();

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> u[D / 16];
#pragma unroll
    for (int dt = 0; dt < D / 16; ++dt) wmma::fill_fragment(u[dt], 0.0f);
    for (int kt = 0; kt < n_tiles; ++kt) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
      wmma::load_matrix_sync(pa, p_w + kt * 16, 2 * sld);
#pragma unroll
      for (int dt = 0; dt < D / 16; ++dt) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
        wmma::load_matrix_sync(vb, Vs + kt * 16 * KLD + dt * 16, KLD);
        wmma::mma_sync(u[dt], pa, vb, u[dt]);
      }
    }
    __syncwarp();
#pragma unroll
    for (int dt = 0; dt < D / 16; ++dt)
      wmma::store_matrix_sync(s_w + dt * 16, u[dt], D, wmma::mem_row_major);
    __syncwarp();
    for (int c = lane; c < 16 * D; c += 32) {
      const int i = c / D, d = c % D;
      if (q0 + i < N)
        out[(static_cast<size_t>(b) * N + q0 + i) * C + h * D + d] =
            __float2bfloat16_rn(s_w[c] * r_w[i]);
    }
    __syncwarp();  // q_w, s_w and r_w are rewritten by the next tile
  }
}

template <int D>
int launch(const void* qkv, void* out, void* m, void* rs, int B, int N,
           int heads, float scale, cudaStream_t stream) {
  const size_t smem = Layout<D>(N).bytes();
  cudaError_t err = cudaFuncSetAttribute(
      attention_core_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_core_kernel<D><<<B * heads, kWarps * 32, smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(out),
      static_cast<float*>(m), static_cast<float*>(rs), N, heads, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

MVT_EXPORT int mvt_attention_core_max_n() { return kMaxN; }

// m and rs: (B, heads, N) fp32 rowmax and reciprocal rowsum, both null or
// both set
MVT_EXPORT int mvt_attention_core(const void* qkv, void* out, void* m,
                                  void* rs, int B, int N, int heads, int D,
                                  float scale, void* stream) {
  if (B <= 0 || heads <= 0 || N <= 0 || N > kMaxN ||
      (m == nullptr) != (rs == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch<64>(qkv, out, m, rs, B, N, heads, scale, s);
  if (D == 32) return launch<32>(qkv, out, m, rs, B, N, heads, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
