// flash_attention_bwd: the backward of flash_attention_fwd over (B, H, N,
// D) bf16 q, k, v, keys and query rows at or past n_valid masked: from the
// forward's output o, its fp32 LSE (B, H, N) and the output gradient do,
// the bf16 dq, dk and dv.
//
// Replaces both TPU flash backwards of myrtle_vision_tpu/ops/flash_attention.py:
// the unblocked `_bwd_kernel` (K8, n_pad <= 1536: p = e / rowsum(e) over
// the whole row, recomputed) and the blocked `_blk_bwd_kernel` (K7: p =
// exp(s - lse) per KV tile, dq accumulated over the tiles).  Both compute
// the same function from the same residuals; since the forward kernel
// emits the LSE in both regimes, this kernel takes p = exp(s * scale -
// lse) in both, which moves p by an fp32 rounding against K8.  Every other
// rounding is the TPU kernels': do in bf16, dsum = rowsum(do * o) in fp32,
// bf16(p) before dv = p^T do, bf16(ds) before dq = ds k and dk = ds^T q,
// fp32 accumulation, each output rounded once.
//
// Three kernels: a pre-pass for dsum (one warp per row), then the dk/dv
// and dq kernels of flash_bwd_tiles.cuh (flash mode).  What bounds it on
// the H100: five N x N x D products per (image, head) in the algorithm
// (10 N^2 D flops) against the bytes of q, k, v, o, do, dq, dk, dv and the
// LSE, so at the YOLOS-S training shapes (8, 6, 1545, 64) the tensor cores
// (0.074 ms at 989 TFLOP/s) and not the memory (0.023 ms at 3.35 TB/s).
// This first design recomputes S and dP in both kernels (seven products
// where five suffice, in exchange for no atomics and a fixed summation
// order), issues mma.sync, not wgmma, and runs well below that peak.
#include "flash_bwd_tiles.cuh"

namespace {

using mvt::bf16;

// dsum[row] = sum_d do[row, d] * o[row, d] in fp32, one warp per row of
// the (B * H * N) rows
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_dsum_kernel(const bf16* __restrict__ o, const bf16* __restrict__ d_o,
                      float* __restrict__ dsum, long long o_image, int o_head,
                      int o_row, long long u_image, int u_head, int u_row,
                      int heads, int n, long long rows) {
  const long long w = (static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= rows) return;
  const int bh = static_cast<int>(w / n), row = static_cast<int>(w % n);
  const int b = bh / heads, h = bh % heads;
  const bf16* orow = o + b * o_image + static_cast<long long>(h) * o_head +
                     static_cast<long long>(row) * o_row;
  const bf16* urow = d_o + b * u_image + static_cast<long long>(h) * u_head +
                     static_cast<long long>(row) * u_row;
  float acc = 0.f;
#pragma unroll
  for (int d = lane; d < D; d += 32)
    acc += __bfloat162float(orow[d]) * __bfloat162float(urow[d]);
  acc = mvt::warp_sum(acc);
  if (lane == 0) dsum[w] = acc;
}

template <int D>
int launch(const mvt::flash::BwdParams& p, const bf16* o, long long o_image,
           int o_head, int o_row, int B, cudaStream_t stream) {
  const long long rows = static_cast<long long>(B) * p.heads * p.n;
  const int blocks = static_cast<int>((rows + 7) / 8);
  flash_bwd_dsum_kernel<D><<<blocks, 256, 0, stream>>>(
      o, p.u, p.rowterm, o_image, o_head, o_row, p.u_image, p.u_head,
      p.u_row, p.heads, p.n, rows);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return mvt::flash::launch_bwd<D, false>(p, B, stream);
}

}  // namespace

// q, k, v share the element strides (in_*); o, do and the outputs dq, dk,
// dv have their own (o_*, u_*, out_*); lse and dsum are (B, H, N) fp32,
// dsum scratch.  *launched receives the kernels launched (3).
MVT_EXPORT int mvt_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* d_o, const void* lse, void* dsum, void* dq, void* dk,
    void* dv, long long in_image, int in_head, int in_row, long long o_image,
    int o_head, int o_row, long long u_image, int u_head, int u_row,
    long long out_image, int out_head, int out_row, int B, int H, int N,
    int D, int n_valid, float scale, int* launched, void* stream) {
  *launched = 0;
  if (B <= 0 || H <= 0 || N <= 0 || n_valid <= 0 || n_valid > N ||
      static_cast<long long>(B) * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  mvt::flash::BwdParams p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.u = static_cast<const bf16*>(d_o);
  p.beta = static_cast<const float*>(lse);
  p.rowterm = static_cast<float*>(dsum);
  p.rs = nullptr;
  p.dq = static_cast<bf16*>(dq);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.colpart = nullptr;
  p.in_image = in_image;
  p.in_head = in_head;
  p.in_row = in_row;
  p.u_image = u_image;
  p.u_head = u_head;
  p.u_row = u_row;
  p.out_image = out_image;
  p.out_head = out_head;
  p.out_row = out_row;
  p.heads = H;
  p.n = N;
  p.n_valid = n_valid;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* ob = static_cast<const bf16*>(o);
  int err;
  if (D == 64)
    err = launch<64>(p, ob, o_image, o_head, o_row, B, s);
  else if (D == 32)
    err = launch<32>(p, ob, o_image, o_head, o_row, B, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (err == 0) *launched = 3;
  return err;
}
