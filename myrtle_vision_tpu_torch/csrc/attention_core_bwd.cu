// attention_core_bwd above 256 tokens: the per-head part of the TPU
// attention block's backward (myrtle_vision_tpu/ops/fused_attention_block.py
// `_bwd_one_image`, the loop over heads) for sequences longer than the
// one-CTA kernel of attention_core_bwd_wgmma.cu takes, which holds the
// function and its roundings:
//   qs  = bf16(q * scale)            du = bf16(d_o_h * rs)
//   s   = qs . k^T      (fp32)       e  = exp(s - m)   (the saved m)
//   dp  = du . v^T      (fp32)       r  = rowsum(dp * e)
//   ds  = e * (dp - r * rs)          dsb = bf16(ds),  eb = bf16(e)
//   dq  = (dsb . k) * scale          dk = dsb^T . qs    dv = eb^T . du
// into dqkv (B, N, 3C) bf16 and its fp32 column sums per image (B, 3C).
//
// The fused block runs up to the `fuses_at` gate of
// myrtle_vision_tpu/ops/fused_attention_block.py, 701 tokens at 6 heads of
// 64 (YOLOS-S training at 256-384 px, 357-677 tokens).  Those sequences
// take the KV-tiled kernels of flash_bwd_tiles.cuh: a
// pre-pass writes du = bf16(d_o * rs) (B, N, C); the dq kernel walks the
// key tiles twice, first for r = rowsum(dp * e) of its 64 queries
// (written out as r * rs), then for dq; the dk/dv kernel walks the query
// tiles once; each writes its tile's fp32 column sums, and a last pass
// adds them up per image in tile order.  Four kernels, no atomics, the
// same fixed summation order on every run.  The entry point takes any N,
// so the route can be timed against the one-CTA kernel at 197 tokens.
#include "common.cuh"
#include "flash_bwd_tiles.cuh"

namespace {

using mvt::bf16;

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
  const int e = mvt::flash::launch_bwd<D>(p, B, stream);
  if (e != 0) return e;
  const int tiles = (N + mvt::flash::kBM - 1) / mvt::flash::kBM;
  core_bwd_colsum_kernel<<<(B * 3 * C + 255) / 256, 256, 0, stream>>>(
      p.colpart, static_cast<float*>(dbias), tiles, 3 * C, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The KV-tiled route at any N: scratch du (B, N, C) bf16, rowterm (B,
// heads, N) fp32, colpart (B, ceil(N / 64), 3C) fp32.  *launched receives
// the kernels launched, 4.
MVT_EXPORT int mvt_attention_core_bwd_tiled(
    const void* qkv, const void* d_o, const void* m, const void* rs,
    void* dqkv, void* dbias, void* du, void* rowterm, void* colpart, int B,
    int N, int heads, int D, float scale, int* launched, void* stream) {
  *launched = 0;
  if (B <= 0 || heads <= 0 || N <= 0 ||
      static_cast<long long>(B) * heads > 65535 || du == nullptr ||
      rowterm == nullptr || colpart == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (D != 64 && D != 32) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err =
      D == 64 ? launch_long<64>(qkv, d_o, m, rs, dqkv, dbias, du, rowterm,
                                colpart, B, N, heads, scale, s)
              : launch_long<32>(qkv, d_o, m, rs, dqkv, dbias, du, rowterm,
                                colpart, B, N, heads, scale, s);
  if (err == 0) *launched = 4;
  return err;
}
