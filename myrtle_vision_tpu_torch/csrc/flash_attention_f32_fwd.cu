// flash_attention_f32_fwd: softmax attention over (B, H, N, D) fp32 q, k,
// v, keys at or past n_valid masked, the fp32 output and optionally the fp32
// LSE (B, H, N) that the backward reads.
//
// Replaces both TPU flash forwards of myrtle_vision_tpu/ops/flash_attention.py
// on fp32 operands (compute_dtype float32): the unblocked `_fwd_kernel` (K5,
// n_pad <= 1536) and the blocked `_blk_fwd_kernel` (K6, online softmax over
// KV tiles, the LSE emitted).  On fp32 operands their dots take
// `_kernel_precision` None, i.e. true fp32 products; both compute the same
// function, so one kernel serves both, as the bf16 kernel
// (flash_attention_fwd_wgmma.cu) does.  Per 64-key tile, for each query row:
//   s   = (q . k^T) scale                  fp32 FFMA, the scale after the sum
//   s   = -1e30 for keys >= n_valid
//   m'  = max(m, rowmax(s)),  a = exp(m - m')
//   e   = exp(s - m'),  l = a l + rowsum(e),  acc = a acc + e . v
// and at the end o = acc / l (an exact divide), LSE = m + log l, the plain
// version's (ops/flash_attention.py `_blocked`) steps with no rounding to a
// narrower type.  Against the unblocked plain version (p = e / l over the
// whole row, then p . v) it differs by the order of fp32 operations only.
//
// What bounds it on the H100: at the detection eval's (8, 6, 2601, 64) the
// two products are 4 N^2 D B H = 83 GFLOP, 1.24 ms at the 67 TFLOP/s of
// fp32 outside the tensor cores (0.25 ms as three bf16 passes at 989
// TFLOP/s), against 0.019 ms for its 64 MB of q, k, v and o: the
// operations bound it.
//
// Design (flash_f32_tiles.cuh), a first kernel that is right: a CTA of 256
// threads per 64 query rows of one (image, head), the Q tile and one K and
// V tile of 64 keys in shared memory (Q and K d-major, V row-major), each
// thread a 4 x 4 block of the scores and a 4 x D/16 block of the output in
// registers; e goes through shared memory (key-major) to the P V product.
// A KV tile wholly at or past n_valid is not visited (its e is 0).  No
// tensor core and no overlap of loads with products: later work.
#include "flash_f32_tiles.cuh"

namespace {

namespace ff = mvt::f32flash;

struct FwdArgs {
  ff::View q, k, v;
  float* o;    // (B, N, H, D) contiguous
  float* lse;  // (B, H, N) or null
  int heads, n, n_valid;
  float scale;
};

template <int D>
constexpr int fwd_smem() {
  // Q and K d-major, V row-major, e key-major
  return (2 * D * ff::kLd + ff::kRows * D + ff::kRows * ff::kLd) *
         static_cast<int>(sizeof(float));
}

template <int D>
__global__ void __launch_bounds__(ff::kThreads)
    flash_f32_fwd_kernel(FwdArgs a) {
  constexpr int W = D / 16;
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);
  float* kt = qt + D * ff::kLd;
  float* vs = kt + D * ff::kLd;
  float* et = vs + ff::kRows * D;
  const int bh = blockIdx.y, b = bh / a.heads, h = bh % a.heads;
  const int q0 = blockIdx.x * ff::kRows;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  ff::load_tile<D>(qt, true, a.q, b, h, q0, a.n);
  float acc[4][W], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = ff::kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < W; ++j) acc[i][j] = 0.f;
  }
  for (int k0 = 0; k0 < a.n_valid; k0 += ff::kRows) {
    __syncthreads();  // the last tile's K, V and e are read
    ff::load_tile<D>(kt, true, a.k, b, h, k0, a.n);
    ff::load_tile<D>(vs, false, a.v, b, h, k0, a.n);
    __syncthreads();
    float s[4][4] = {};
    ff::mma_tile<4>(qt, ff::kLd, kt, ff::kLd, D, s, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = ff::kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx * 4 + j;
        s[i][j] = key < a.n_valid ? s[i][j] * a.scale : ff::kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], ff::row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      l[i] = l[i] * alpha + ff::row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < W; ++j) acc[i][j] *= alpha;
    }
    ff::store_transposed(et, s, ty, tx);
    __syncthreads();
    ff::mma_tile<W>(et, ff::kLd, vs, D, ff::kRows, acc, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < W; ++j) acc[i][j] = acc[i][j] / l[i];
    const int r = q0 + ty * 4 + i;
    if (a.lse != nullptr && tx == 0 && r < a.n)
      a.lse[static_cast<long long>(bh) * a.n + r] = m[i] + logf(l[i]);
  }
  ff::store_rows<W, D>(a.o, acc, b, h, a.heads, a.n, q0, ty, tx);
}

template <int D>
int launch(FwdArgs a, int B, cudaStream_t stream) {
  static bool ready = false;
  constexpr int smem = fwd_smem<D>();
  cudaError_t e = ff::allow_smem(flash_f32_fwd_kernel<D>, smem, ready);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((a.n + ff::kRows - 1) / ff::kRows, B * a.heads);
  flash_f32_fwd_kernel<D><<<grid, ff::kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v: fp32 (B, H, N, D) views sharing the element strides (image,
// head, row), rows contiguous and 16-byte aligned; o: fp32 (B, N, H, D)
// contiguous; lse: fp32 (B, H, N) contiguous or null; D 32 or 64
MVT_EXPORT int mvt_flash_attention_f32_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    long long in_image, int in_head, int in_row, int B, int H, int N, int D,
    int n_valid, float scale, void* stream) {
  if (B <= 0 || H <= 0 || N <= 0 || n_valid <= 0 || n_valid > N ||
      static_cast<long long>(B) * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  FwdArgs a;
  a.q = {static_cast<const float*>(q), in_image, in_head, in_row};
  a.k = {static_cast<const float*>(k), in_image, in_head, in_row};
  a.v = {static_cast<const float*>(v), in_image, in_head, in_row};
  a.o = static_cast<float*>(o);
  a.lse = static_cast<float*>(lse);
  a.heads = H;
  a.n = N;
  a.n_valid = n_valid;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch<64>(a, B, s);
  if (D == 32) return launch<32>(a, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
