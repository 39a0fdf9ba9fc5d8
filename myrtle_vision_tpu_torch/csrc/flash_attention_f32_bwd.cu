// flash_attention_f32_bwd: the backward of flash_attention_f32_fwd.cu, fp32
// (B, H, N, D) q, k, v, the forward's output o and LSE, the output gradient
// do -> fp32 dq, dk, dv.
//
// Replaces both TPU flash backwards of myrtle_vision_tpu/ops/flash_attention.py
// on fp32 operands: `_bwd_kernel` (K8, n_pad <= 1536, p = e / rowsum(e) over
// the whole row) and `_blk_bwd_kernel` (K7, p = exp(s - LSE) per KV tile).
// Their dots on fp32 operands are true fp32 products (`_kernel_precision`
// None).  The rule (`_fa_bwd`), with query rows >= n_valid masked:
//   dsum = rowsum(do * o)             p = exp((q . k^T) scale - LSE)
//   dv = p^T do                       dp = do v^T
//   ds = p (dp - dsum)                dq = (ds k) scale,  dk = (ds^T q) scale
// The kernel takes p = exp(s - LSE) in both regimes (the bf16 kernel does
// too), which differs from K8's e / rowsum(e) by fp32 roundings.
//
// What bounds it on the H100: five products of 2 N^2 D B H each, 0.19 ms
// for YOLOS-S at (8, 6, 1545, 64) at 67 TFLOP/s in fp32 outside the tensor
// cores (0.038 ms as three bf16 passes at 989 TFLOP/s); the kernels below
// recompute s and dp in both passes, seven products in all.
//
// Design (flash_f32_tiles.cuh), three launches, no atomics: a pre-pass
// writes dsum, a warp a row; a dk / dv kernel gives each CTA 64 keys of one
// (image, head) and walks the query tiles (S^T, P^T, dP^T, dS^T in
// registers, then dv += P^T do and dk += dS^T q through shared memory); a
// dq kernel gives each CTA 64 queries and walks the key tiles (S, P, dP, dS,
// then dq += dS k).  Tiles wholly at or past n_valid are not visited (their
// p is 0), and the scale multiplies each sum at the end.
#include "flash_f32_tiles.cuh"

namespace {

namespace ff = mvt::f32flash;

struct BwdArgs {
  ff::View q, k, v, o, dout;
  const float* lse;  // (B, H, N)
  float* dsum;       // (B, H, N) scratch
  float *dq, *dk, *dv;  // (B, N, H, D) contiguous
  int heads, n, n_valid;
  float scale;
};

// dsum[b, h, i] = sum_d do[b, h, i, d] o[b, h, i, d], a warp a row
template <int D>
__global__ void __launch_bounds__(ff::kThreads)
    flash_f32_dsum_kernel(BwdArgs a, int rows) {
  const int row = blockIdx.x * (ff::kThreads / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const int i = row % a.n, bh = row / a.n;
  const int b = bh / a.heads, h = bh % a.heads;
  const float* g = a.dout.row(b, h, i);
  const float* o = a.o.row(b, h, i);
  float acc = 0.f;
#pragma unroll
  for (int d = lane; d < D; d += 32) acc = fmaf(g[d], o[d], acc);
  acc = mvt::warp_sum(acc);
  if (lane == 0) a.dsum[row] = acc;
}

template <int D>
constexpr int dkdv_smem() {
  // own K, V d-major; per query tile q, do d-major and row-major, P and dS
  // query-major; the tile's LSE and dsum
  return (4 * D * ff::kLd + 2 * ff::kRows * D + 2 * ff::kRows * ff::kLd +
          2 * ff::kRows) *
         static_cast<int>(sizeof(float));
}

template <int D>
__global__ void __launch_bounds__(ff::kThreads)
    flash_f32_dkdv_kernel(BwdArgs a) {
  constexpr int W = D / 16;
  extern __shared__ float4 smem4[];
  float* kt = reinterpret_cast<float*>(smem4);
  float* vt = kt + D * ff::kLd;
  float* qt = vt + D * ff::kLd;
  float* gt = qt + D * ff::kLd;   // do, d-major
  float* qs = gt + D * ff::kLd;   // q, row-major
  float* gs = qs + ff::kRows * D; // do, row-major
  float* ps = gs + ff::kRows * D; // p[q][key]
  float* dss = ps + ff::kRows * ff::kLd;  // ds[q][key]
  float* lse_s = dss + ff::kRows * ff::kLd;
  float* dsum_s = lse_s + ff::kRows;
  const int bh = blockIdx.y, b = bh / a.heads, h = bh % a.heads;
  const int k0 = blockIdx.x * ff::kRows;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  float dk[4][W] = {}, dv[4][W] = {};
  if (k0 < a.n_valid) {
    ff::load_tile<D>(kt, true, a.k, b, h, k0, a.n);
    ff::load_tile<D>(vt, true, a.v, b, h, k0, a.n);
    for (int q0 = 0; q0 < a.n_valid; q0 += ff::kRows) {
      __syncthreads();  // the last tile's operands are read
      ff::load_tile<D>(qt, true, a.q, b, h, q0, a.n);
      ff::load_tile<D>(qs, false, a.q, b, h, q0, a.n);
      ff::load_tile<D>(gt, true, a.dout, b, h, q0, a.n);
      ff::load_tile<D>(gs, false, a.dout, b, h, q0, a.n);
      ff::load_stat(lse_s, a.lse, bh, a.n, q0);
      ff::load_stat(dsum_s, a.dsum, bh, a.n, q0);
      __syncthreads();
      // rows: keys 4 ty + i; columns: queries 4 tx + j
      float p[4][4] = {}, dp[4][4] = {};
      ff::mma_tile<4>(kt, ff::kLd, qt, ff::kLd, D, p, ty, tx);
      ff::mma_tile<4>(vt, ff::kLd, gt, ff::kLd, D, dp, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool key_ok = k0 + ty * 4 + i < a.n_valid;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx * 4 + j;
          const bool ok = key_ok && q0 + c < a.n_valid;
          p[i][j] = ok ? expf(p[i][j] * a.scale - lse_s[c]) : 0.f;
          dp[i][j] = p[i][j] * (dp[i][j] - dsum_s[c]);
        }
      }
      ff::store_transposed(ps, p, ty, tx);
      ff::store_transposed(dss, dp, ty, tx);
      __syncthreads();
      ff::mma_tile<W>(ps, ff::kLd, gs, D, ff::kRows, dv, ty, tx);
      ff::mma_tile<W>(dss, ff::kLd, qs, D, ff::kRows, dk, ty, tx);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < W; ++j) dk[i][j] *= a.scale;
  ff::store_rows<W, D>(a.dk, dk, b, h, a.heads, a.n, k0, ty, tx);
  ff::store_rows<W, D>(a.dv, dv, b, h, a.heads, a.n, k0, ty, tx);
}

template <int D>
constexpr int dq_smem() {
  // own q, do d-major; per key tile K d-major and row-major, V d-major, dS
  // key-major; the own rows' LSE and dsum
  return (4 * D * ff::kLd + ff::kRows * D + ff::kRows * ff::kLd +
          2 * ff::kRows) *
         static_cast<int>(sizeof(float));
}

template <int D>
__global__ void __launch_bounds__(ff::kThreads)
    flash_f32_dq_kernel(BwdArgs a) {
  constexpr int W = D / 16;
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);
  float* gt = qt + D * ff::kLd;   // do, d-major
  float* kt = gt + D * ff::kLd;
  float* vt = kt + D * ff::kLd;
  float* ks = vt + D * ff::kLd;   // k, row-major
  float* dst = ks + ff::kRows * D;  // ds[key][q]
  float* lse_s = dst + ff::kRows * ff::kLd;
  float* dsum_s = lse_s + ff::kRows;
  const int bh = blockIdx.y, b = bh / a.heads, h = bh % a.heads;
  const int q0 = blockIdx.x * ff::kRows;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  float dq[4][W] = {};
  if (q0 < a.n_valid) {
    ff::load_tile<D>(qt, true, a.q, b, h, q0, a.n);
    ff::load_tile<D>(gt, true, a.dout, b, h, q0, a.n);
    ff::load_stat(lse_s, a.lse, bh, a.n, q0);
    ff::load_stat(dsum_s, a.dsum, bh, a.n, q0);
    for (int k0 = 0; k0 < a.n_valid; k0 += ff::kRows) {
      __syncthreads();  // the last tile's operands are read
      ff::load_tile<D>(kt, true, a.k, b, h, k0, a.n);
      ff::load_tile<D>(ks, false, a.k, b, h, k0, a.n);
      ff::load_tile<D>(vt, true, a.v, b, h, k0, a.n);
      __syncthreads();
      // rows: queries 4 ty + i; columns: keys 4 tx + j
      float p[4][4] = {}, dp[4][4] = {};
      ff::mma_tile<4>(qt, ff::kLd, kt, ff::kLd, D, p, ty, tx);
      ff::mma_tile<4>(gt, ff::kLd, vt, ff::kLd, D, dp, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        const bool row_ok = q0 + r < a.n_valid;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool ok = row_ok && k0 + tx * 4 + j < a.n_valid;
          p[i][j] = ok ? expf(p[i][j] * a.scale - lse_s[r]) : 0.f;
          dp[i][j] = p[i][j] * (dp[i][j] - dsum_s[r]);
        }
      }
      ff::store_transposed(dst, dp, ty, tx);
      __syncthreads();
      ff::mma_tile<W>(dst, ff::kLd, ks, D, ff::kRows, dq, ty, tx);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < W; ++j) dq[i][j] *= a.scale;
  ff::store_rows<W, D>(a.dq, dq, b, h, a.heads, a.n, q0, ty, tx);
}

template <int D>
int launch(BwdArgs a, int B, int* launched, cudaStream_t stream) {
  static bool ready_dkdv = false, ready_dq = false;
  constexpr int smem_dkdv = dkdv_smem<D>(), smem_dq = dq_smem<D>();
  cudaError_t e =
      ff::allow_smem(flash_f32_dkdv_kernel<D>, smem_dkdv, ready_dkdv);
  if (e == cudaSuccess)
    e = ff::allow_smem(flash_f32_dq_kernel<D>, smem_dq, ready_dq);
  if (e != cudaSuccess) return static_cast<int>(e);
  *launched = 0;
  const int rows = B * a.heads * a.n;
  constexpr int kWarps = ff::kThreads / 32;
  flash_f32_dsum_kernel<D>
      <<<(rows + kWarps - 1) / kWarps, ff::kThreads, 0, stream>>>(a, rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ++*launched;
  const dim3 grid((a.n + ff::kRows - 1) / ff::kRows, B * a.heads);
  flash_f32_dkdv_kernel<D><<<grid, ff::kThreads, smem_dkdv, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ++*launched;
  flash_f32_dq_kernel<D><<<grid, ff::kThreads, smem_dq, stream>>>(a);
  e = cudaGetLastError();
  if (e == cudaSuccess) ++*launched;
  return static_cast<int>(e);
}

}  // namespace

// q, k, v: fp32 (B, H, N, D) views sharing the element strides (image,
// head, row); o and do: fp32 (B, H, N, D) views with strides of their own;
// every row contiguous and 16-byte aligned; lse: fp32 (B, H, N)
// contiguous; dsum: fp32 (B, H, N) scratch; dq, dk, dv: fp32 (B, N, H, D)
// contiguous; D 32 or 64.  Three kernels: `launched` gets how many launched.
MVT_EXPORT int mvt_flash_attention_f32_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dsum, void* dq, void* dk,
    void* dv, long long in_image, int in_head, int in_row, long long o_image,
    int o_head, int o_row, long long do_image, int do_head, int do_row, int B,
    int H, int N, int D, int n_valid, float scale, int* launched,
    void* stream) {
  if (B <= 0 || H <= 0 || N <= 0 || n_valid <= 0 || n_valid > N ||
      static_cast<long long>(B) * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a;
  a.q = {static_cast<const float*>(q), in_image, in_head, in_row};
  a.k = {static_cast<const float*>(k), in_image, in_head, in_row};
  a.v = {static_cast<const float*>(v), in_image, in_head, in_row};
  a.o = {static_cast<const float*>(o), o_image, o_head, o_row};
  a.dout = {static_cast<const float*>(dout), do_image, do_head, do_row};
  a.lse = static_cast<const float*>(lse);
  a.dsum = static_cast<float*>(dsum);
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.heads = H;
  a.n = N;
  a.n_valid = n_valid;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch<64>(a, B, launched, s);
  if (D == 32) return launch<32>(a, B, launched, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
