// attention_core_probe: the WMMA design of the attention core, kept for
// the K12 probe of tools/perf/attn_microbench.py.  The production core is
// csrc/attention_core_wgmma.cu (wgmma, TMA); this file's kernel is the
// one it replaced, in the probe's modes only, so that the probe compares
// its variants within one design.
//
// The function of every mode is that of the core (`_attn_heads_fwd` of
// myrtle_vision_tpu/ops/fused_attention_block.py) with what lies between
// and around the two products changed: s = bf16(q * scale) . k^T in fp32,
// -inf for keys >= N, e = exp(s - rowmax), u = bf16(e) . v.
//
// One block per (image, head) holds K and V of the head in shared memory
// (rows padded to a multiple of 16 and zero-filled); each warp takes a
// 16-query tile at a time.  Both products run on the tensor cores (WMMA
// 16x16x16, bf16 in, fp32 out): S = Q K^T goes to a per-warp fp32 row
// buffer, the warp takes rowmax / exp / rowsum over it and writes the
// bf16 probabilities over the same buffer, then U = P V.  The whole score
// row of a tile lives in shared memory, which limits this kernel to
// N <= kMaxN.
//
// Probe modes (mvt_attention_core_probe): the K12 variants of the TPU
// probe tools/perf/attn_microbench.py (`_kernel_rowmajor` :109,
// `_kernel_pvrow` :76, `_kernel_dotonly` :175, `_kernel_pipe` :206), each
// the same kernel with what lies between and around the two products
// changed, so that the probe times this kernel and not a copy:
//   defer     the production function with a true divide, bf16(u / rowsum)
//   rowmajor  s = (q . k^T) * scale in fp32, p = bf16(e / rowsum),
//             out = bf16(p . v)  (also pvrow's core)
//   none      e = s * 0.01: no max, no exp; then as defer
//   nomax     e = exp(s): no max-subtract; then as defer
//   sumdot    the rowsum over bf16(e) from the P V product, through one
//             more tensor-core column of ones beside V; then as defer
//   pipe      defer, with the S product of the warp's next 16-query tile
//             issued before the softmax of the current one (two score
//             buffers a warp, four warps to keep them in shared memory)
//   dotonly   s = bf16(q . k^T) unscaled, out = bf16(s . v)
// The deferred-divide modes write, when given the statistics pointers,
// the parts instead: bf16(u) undivided, the rowmax (0 where a mode takes
// none) and the rowsum, so that a check can hold the product and the sum
// apart where the sum of signed scores (mode none) comes near 0.

#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;
using mvt::bf16;

constexpr int kWarps = 8;
constexpr int kMaxN = 256;
constexpr int kMaxI = kMaxN / 32;  // score columns per lane

// the probe modes (see the header)
enum Mode {
  kDefer = 1,
  kRowmajor = 2,
  kNone = 3,
  kNomax = 4,
  kSumdot = 5,
  kPipe = 6,
  kDotonly = 7,
};

template <int kMode>
struct Warps {
  // warps of a block and score buffers of a warp
  static constexpr int kW = kMode == kPipe ? 4 : kWarps;
  static constexpr int kBufs = kMode == kPipe ? 2 : 1;
};

template <int D, int kMode>
struct Layout {
  static constexpr int KLD = D + 8;  // padded rows of K, V and Q tiles
  static constexpr int W = Warps<kMode>::kW;
  static constexpr int BUFS = Warps<kMode>::kBufs;
  // key rows; fp32 row stride of a warp's 16-row buffer, which holds the
  // scores (n_pad wide), then the probabilities, then U (D wide)
  int n_pad, sld;
  __host__ __device__ explicit Layout(int n)
      : n_pad((n + 15) / 16 * 16),
        sld(((n + 15) / 16 * 16 > D ? (n + 15) / 16 * 16 : D) + 4) {}
  __host__ __device__ size_t bytes() const {
    return sizeof(bf16) * (2 * static_cast<size_t>(n_pad) * KLD +
                           W * 16 * KLD) +
           sizeof(float) * (W * BUFS * 16 * static_cast<size_t>(sld) +
                            W * 16) +
           (kMode == kSumdot ? sizeof(bf16) * 16 * 16 : 0);  // ones tile
  }
};

template <int D, int kMode>
__global__ void __launch_bounds__(Warps<kMode>::kW * 32)
attention_core_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                      float* __restrict__ m_out, float* __restrict__ rs_out,
                      int N, int heads, float scale) {
  using Lay = Layout<D, kMode>;
  constexpr int KLD = Lay::KLD;
  constexpr int W = Lay::W;
  constexpr int BUFS = Lay::BUFS;
  // the modes that divide the P V product by the rowsum (see the header)
  constexpr bool kDiv = kMode == kDefer || kMode == kNone ||
                        kMode == kNomax || kMode == kSumdot || kMode == kPipe;
  // q enters the S product as bf16(q * scale)
  constexpr bool kScaleQ = kMode != kRowmajor && kMode != kDotonly;
  const Lay lay(N);
  const int n_pad = lay.n_pad, sld = lay.sld;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);  // n_pad x KLD
  bf16* Vs = Ks + n_pad * KLD;               // n_pad x KLD
  bf16* Qs = Vs + n_pad * KLD;               // W x 16 x KLD
  float* Ss = reinterpret_cast<float*>(Qs + W * 16 * KLD);
  float* Rs = Ss + W * BUFS * 16 * sld;      // W x 16

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
  // sumdot: a 16 x 16 tile whose first column is ones, the extra column
  // of the P V product that sums the bf16 probabilities of a row
  bf16* ones = reinterpret_cast<bf16*>(Rs + W * 16);
  if constexpr (kMode == kSumdot) {
    for (int c = tid; c < 16 * 16; c += blockDim.x)
      ones[c] = __float2bfloat16_rn(c % 16 == 0 ? 1.f : 0.f);
  }
  __syncthreads();

  bf16* q_w = Qs + warp * 16 * KLD;
  float* r_w = Rs + warp * 16;
  const int n_tiles = n_pad / 16;

  // S = Q K^T of the 16-query tile at q0 into the fp32 buffer s_buf
  auto score = [&](int q0, float* s_buf) {
    for (int c = lane; c < 16 * D; c += 32) {
      const int i = c / D, d = c % D;
      float v = 0.f;
      if (q0 + i < N) {
        v = __bfloat162float(base[static_cast<size_t>(q0 + i) * row_stride +
                                  d]);
        if constexpr (kScaleQ) v *= scale;
      }
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
      wmma::store_matrix_sync(s_buf + nt * 16, acc, sld, wmma::mem_row_major);
    }
    __syncwarp();
  };

  if constexpr (kMode == kPipe) {
    if (warp * 16 < N) score(warp * 16, Ss + warp * BUFS * 16 * sld);
  }
  int t = 0;
  for (int q0 = warp * 16; q0 < N; q0 += W * 16, ++t) {
    float* s_w = Ss + (warp * BUFS + t % BUFS) * 16 * sld;
    bf16* p_w = reinterpret_cast<bf16*>(s_w);  // P row r over S row r
    if constexpr (kMode == kPipe) {
      // the next tile's S product goes out before this tile's softmax
      if (q0 + W * 16 < N)
        score(q0 + W * 16, Ss + (warp * BUFS + (t + 1) % BUFS) * 16 * sld);
    } else {
      score(q0, s_w);
    }

    for (int r = 0; r < 16; ++r) {
      const float* srow = s_w + r * sld;
      float s[kMaxI];
      float m = mvt::neg_inf();
#pragma unroll
      for (int i = 0; i < kMaxI; ++i) {
        const int j = lane + 32 * i;
        s[i] = (j < N) ? srow[j] : mvt::neg_inf();
        if constexpr (kMode == kRowmajor) s[i] *= scale;
        m = fmaxf(m, s[i]);
      }
      if constexpr (kMode == kNone || kMode == kNomax || kMode == kDotonly)
        m = 0.f;  // these modes subtract no max
      else
        m = mvt::warp_max(m);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxI; ++i) {
        const int j = lane + 32 * i;
        if constexpr (kMode == kNone)
          s[i] = (j < N) ? s[i] * 0.01f : 0.f;
        else if constexpr (kMode == kNomax)
          s[i] = (j < N) ? expf(s[i]) : 0.f;
        else if constexpr (kMode == kDotonly)
          s[i] = (j < N) ? s[i] : 0.f;
        else
          s[i] = (j < N) ? expf(s[i] - m) : 0.f;
        sum += s[i];
      }
      if constexpr (kMode != kSumdot && kMode != kDotonly)
        sum = mvt::warp_sum(sum);
      __syncwarp();  // the row is read in full before P overwrites it
      bf16* prow = p_w + r * 2 * sld;
#pragma unroll
      for (int i = 0; i < kMaxI; ++i) {
        const int j = lane + 32 * i;
        if constexpr (kMode == kRowmajor) {
          if (j < n_pad) prow[j] = __float2bfloat16_rn(s[i] / sum);
        } else {
          if (j < n_pad) prow[j] = __float2bfloat16_rn(s[i]);
        }
      }
      if (lane == 0) {
        if constexpr (kDiv) {
          r_w[r] = sum;  // sumdot: replaced by the product's column below
          if (m_out != nullptr && q0 + r < N) {
            const size_t o = static_cast<size_t>(blockIdx.x) * N + q0 + r;
            m_out[o] = m;
            if constexpr (kMode != kSumdot) rs_out[o] = sum;
          }
        }
      }
    }
    __syncwarp();

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> u[D / 16];
#pragma unroll
    for (int dt = 0; dt < D / 16; ++dt) wmma::fill_fragment(u[dt], 0.0f);
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> usum;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> ob;
    if constexpr (kMode == kSumdot) {
      wmma::fill_fragment(usum, 0.0f);
      wmma::load_matrix_sync(ob, ones, 16);
    }
    for (int kt = 0; kt < n_tiles; ++kt) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
      wmma::load_matrix_sync(pa, p_w + kt * 16, 2 * sld);
#pragma unroll
      for (int dt = 0; dt < D / 16; ++dt) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
        wmma::load_matrix_sync(vb, Vs + kt * 16 * KLD + dt * 16, KLD);
        wmma::mma_sync(u[dt], pa, vb, u[dt]);
      }
      if constexpr (kMode == kSumdot) wmma::mma_sync(usum, pa, ob, usum);
    }
    __syncwarp();
    if constexpr (kMode == kSumdot) {
      // column 0 of the ones product: each row's sum of bf16(e); q_w is
      // free until the next tile
      float* sum_w = reinterpret_cast<float*>(q_w);
      wmma::store_matrix_sync(sum_w, usum, 16, wmma::mem_row_major);
      __syncwarp();
      if (lane < 16) {
        r_w[lane] = sum_w[lane * 16];
        if (rs_out != nullptr && q0 + lane < N)
          rs_out[static_cast<size_t>(blockIdx.x) * N + q0 + lane] =
              sum_w[lane * 16];
      }
      __syncwarp();
    }
#pragma unroll
    for (int dt = 0; dt < D / 16; ++dt)
      wmma::store_matrix_sync(s_w + dt * 16, u[dt], D, wmma::mem_row_major);
    __syncwarp();
    const bool parts = m_out != nullptr;
    for (int c = lane; c < 16 * D; c += 32) {
      const int i = c / D, d = c % D;
      if (q0 + i < N) {
        float v;
        if constexpr (kDiv)
          v = parts ? s_w[c] : s_w[c] / r_w[i];
        else
          v = s_w[c];
        out[(static_cast<size_t>(b) * N + q0 + i) * C + h * D + d] =
            __float2bfloat16_rn(v);
      }
    }
    __syncwarp();  // q_w, s_w and r_w are rewritten by the next tile
  }
}

template <int D, int kMode>
int launch(const void* qkv, void* out, void* m, void* rs, int B, int N,
           int heads, float scale, cudaStream_t stream) {
  const size_t smem = Layout<D, kMode>(N).bytes();
  cudaError_t err = cudaFuncSetAttribute(
      attention_core_kernel<D, kMode>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_core_kernel<D, kMode>
      <<<B * heads, Warps<kMode>::kW * 32, smem, stream>>>(
          static_cast<const bf16*>(qkv), static_cast<bf16*>(out),
          static_cast<float*>(m), static_cast<float*>(rs), N, heads, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_probe(int mode, const void* qkv, void* out, void* m, void* rs,
                 int B, int N, int heads, float scale, cudaStream_t s) {
  switch (mode) {
    case kDefer:
      return launch<D, kDefer>(qkv, out, m, rs, B, N, heads, scale, s);
    case kRowmajor:
      return launch<D, kRowmajor>(qkv, out, m, rs, B, N, heads, scale, s);
    case kNone:
      return launch<D, kNone>(qkv, out, m, rs, B, N, heads, scale, s);
    case kNomax:
      return launch<D, kNomax>(qkv, out, m, rs, B, N, heads, scale, s);
    case kSumdot:
      return launch<D, kSumdot>(qkv, out, m, rs, B, N, heads, scale, s);
    case kPipe:
      return launch<D, kPipe>(qkv, out, m, rs, B, N, heads, scale, s);
    default:
      return launch<D, kDotonly>(qkv, out, m, rs, B, N, heads, scale, s);
  }
}

}  // namespace

// The K12 probe modes (1 defer, 2 rowmajor, 3 none, 4 nomax, 5 sumdot,
// 6 pipe, 7 dotonly; see the header), D = 64 (the probe's head width, and
// that of every ViT config), N <= kMaxN.  m and rs, both null or
// both set, only with a deferred-divide mode (1, 3-6): then out is bf16(u)
// undivided, m the rowmax (0 where the mode takes none), rs the rowsum.
MVT_EXPORT int mvt_attention_core_probe(const void* qkv, void* out, void* m,
                                        void* rs, int B, int N, int heads,
                                        int D, float scale, int mode,
                                        void* stream) {
  const bool div = mode == kDefer || (mode >= kNone && mode <= kPipe);
  if (B <= 0 || heads <= 0 || N <= 0 || N > kMaxN ||
      static_cast<long long>(B) * heads > 65535 || mode < kDefer ||
      mode > kDotonly || (m == nullptr) != (rs == nullptr) ||
      (m != nullptr && !div))
    return static_cast<int>(cudaErrorInvalidValue);
  if (D != 64) return static_cast<int>(cudaErrorInvalidValue);
  return launch_probe<64>(mode, qkv, out, m, rs, B, N, heads, scale,
                          static_cast<cudaStream_t>(stream));
}
