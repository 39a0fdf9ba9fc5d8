// attention_core above 256 tokens on Hopper: per-head softmax attention
// over the fused qkv rows for sequences longer than the one-CTA kernel of
// attention_core_wgmma.cu holds.
//
// Replaces, for those lengths, the per-head part of the TPU attention
// block kernel (myrtle_vision_tpu/ops/fused_attention_block.py
// `_attn_heads_fwd`, called from `_fwd_kernel`), with the fused core's
// conventions (attention_core_wgmma.cu): qkv (B, N, 3C) bf16 in feature
// order [3][h][d] in, ctx (B, N, C) bf16 out (head h at columns h D...),
// and with stats the rowmax m and the reciprocal rowsum rs (B, H, N) fp32
// that the backward reads.  Per 128-key tile, for each query row (running
// max m, rowsum l, accumulator acc):
//   s     = bf16(q * scale) . k^T          fp32 (the scaled score)
//   s     = -inf for keys >= N
//   m'    = max(m, rowmax(s)),  a = 2^((m - m') log2 e)
//   e     = 2^(s log2 e - m' log2 e)       one FFMA, then MUFU.EX2
//   l     = a l + rowsum(e)                fp32 e
//   acc   = a acc + bf16(e) . v            fp32 accumulation
// and at the end o = bf16(acc * (1 / l)), a reciprocal and a multiply;
// the saved m is in the scale of s, the saved rs is 1 / l.  e is rounded
// to bf16 against the running max of its tile, not the row's (about 2^-9
// of an output), and the exponent in base 2 is exp(s - m') up to an fp32
// rounding of its argument.
//
// What bounds it on the H100: at the YOLOS-S 384 px shape (8 images, 6
// heads of 64, N = 677) the two products are 4 B H N^2 D = 5.63 GFLOP
// (0.0057 ms at 989 TFLOP/s), the qkv rows and the context 16.6 MB
// (0.0050 ms at 3.35 TB/s) and the 22.0 M exponentials about 0.0053 ms on
// the SFUs (16 a clock an SM): all three about equal, so the kernel gains
// only by overlapping them.
//
// Design (core_long_wgmma.cuh): a CTA per 64 queries of one (image,
// head), one warpgroup, two CTAs an SM.  Thread 0 keeps a ring of
// kFwdStages K tiles and as many V tiles of 128 keys in flight, each by
// TMA through a 4-D tensor map over the (B, H, N, D) view of the qkv rows
// (read in place; rows past N zero) on its own full barrier; a stage is
// refilled once the whole warpgroup is past its products (a named
// barrier).  No producer warp: a fifth warp would put three warps of the
// SM's ten on one of its four register files, which caps a thread at 168
// registers, and at that cap ptxas spilled and serialised the products.
// The warpgroup loads its q rows into registers, scales and rounds them
// there, and uses them as the register A operand of S = Q K^T (wgmma
// m64n128k16, the scores in registers, 64 fp32 a thread); P = bf16(e) is
// formed whole in registers as the A fragments of acc += P V (m64nDk16, V
// MN-major through the transpose bit).  It issues S of tile j and P V of
// tile j - 1 before the softmax of tile j, so the exponentials run under
// P V, and the other CTA of the SM fills the tensor cores while this one
// waits.  The epilogue multiplies by 1 / l and stores bf16 pairs, the
// statistics beside them.  One kernel a call.  ptxas -v (sm_90a, nvcc
// 12.9): 170 registers a thread at D = 64, 146 at 32, no spills; 99,376
// bytes of dynamic shared memory at D = 64.  On one H100 at 700 W it
// takes 0.0236 ms on the device clock at (8, 677) against 0.0454 for the
// mma.sync tiles it replaced (tools/perf/core_long_bench.py).
#include "core_long_wgmma.cuh"

namespace {

using mvt::bf16;
namespace sm = mvt::sm90;
namespace fw = mvt::flashw;
namespace cl = mvt::core_long;

struct Args {
  const bf16* qkv;
  bf16* out;
  float* m_out;   // (B, H, N) or null
  float* rs_out;  // set with m_out
  int n, heads;
  float scale;
  fw::Axes axes;
};

// S = Q K^T of the warpgroup's 64 rows (Q the register A fragments)
// against a 128-key tile, issued and committed as one group
template <int D>
__device__ __forceinline__ void issue_scores(float (&s)[cl::kFwdTile / 2],
                                             const uint32_t (&qa)[D / 16][4],
                                             uint64_t dk) {
  sm::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    sm::WgmmaRS<cl::kFwdTile>::template mma<0>(
        s, qa[kk], sm::desc_add(dk, kk * 32), kk > 0 ? 1 : 0);
  sm::wgmma_commit();
}

// rows [row, row + kFwdTile) of K and V into stage st, on its full barriers
template <int D>
__device__ __forceinline__ void load_kv(unsigned char* Ks, unsigned char* Vs,
                                        uint64_t* k_full, uint64_t* v_full,
                                        const CUtensorMap* map_k,
                                        const CUtensorMap* map_v,
                                        const Args& a, int st, int row, int h,
                                        int b) {
  constexpr int kKV = cl::FwdLayout<D>::kKV;
  sm::mbar_expect_tx(&k_full[st], kKV);
  fw::load_rows(Ks + st * kKV, map_k, &k_full[st], a.axes, row, h, b);
  sm::mbar_expect_tx(&v_full[st], kKV);
  fw::load_rows(Vs + st * kKV, map_v, &v_full[st], a.axes, row, h, b);
}

template <int D>
__global__ void __launch_bounds__(cl::kFwdThreads, cl::kCtasPerSm)
attention_core_long_kernel(const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v,
                           const Args a) {
  using L = cl::FwdLayout<D>;
  constexpr int S = cl::kFwdStages, BN = cl::kFwdTile;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = fw::aligned_smem(smem_raw);
  unsigned char* Ks = smem;
  unsigned char* Vs = Ks + S * L::kKV;
  uint64_t* k_full = reinterpret_cast<uint64_t*>(smem + L::kBarOff);
  uint64_t* v_full = k_full + S;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y, b = bh / a.heads, h = bh % a.heads;
  const int q0 = blockIdx.x * cl::kRows;
  const int n_tiles = (a.n + BN - 1) / BN;

  // thread 0 issues every load: the ring's first tiles now, each later
  // tile once the whole warpgroup is done with the stage it refills
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      sm::mbar_init(&k_full[s], 1);
      sm::mbar_init(&v_full[s], 1);
    }
    sm::fence_barrier_init();
    for (int j = 0; j < S && j < n_tiles; ++j)
      load_kv<D>(Ks, Vs, k_full, v_full, &map_k, &map_v, a, j, j * BN, h, b);
  }
  __syncthreads();

  // rows ra = q0 + 16 w + g and ra + 8
  const int w = warp, g = lane >> 2, t = lane & 3;
  const int C = a.heads * D;
  const size_t row_stride = static_cast<size_t>(3) * C;
  const int ra = q0 + 16 * w + g, rb = ra + 8;
  // the A fragments of bf16(q scale): word 0 (row ra, columns 2t, 2t + 1
  // of the 16-deep step), 1 (row rb), 2 and 3 (columns 2t + 8, 2t + 9);
  // rows past n zero
  uint32_t qa[D / 16][4];
  {
    const bf16* q_base =
        a.qkv + static_cast<size_t>(b) * a.n * row_stride + h * D;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int wd = 0; wd < 4; ++wd) {
        const int r = (wd & 1) ? rb : ra;
        const int d = 16 * kk + 8 * (wd >> 1) + 2 * t;
        float2 v = make_float2(0.f, 0.f);
        if (r < a.n)
          v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              q_base + static_cast<size_t>(r) * row_stride + d));
        qa[kk][wd] = sm::pack_bf16(v.x * a.scale, v.y * a.scale);
      }
  }

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {mvt::neg_inf(), mvt::neg_inf()};
  float l[2] = {0.f, 0.f}, al[2];
  float s[BN / 2];
  uint32_t p[BN / 16][4];

  sm::mbar_wait(&k_full[0], 0);
  issue_scores<D>(s, qa, sm::rows_desc<D>(Ks, 0));
  sm::wgmma_wait<0>();
  sm::fence_regs(s);
  fw::softmax_tile(s, m, al, l, cl::kLog2e, 0, a.n, t);
  fw::pack_p(s, p);

  for (int j = 1; j < n_tiles; ++j) {
    const int st = j % S, pv = (j - 1) % S;
    sm::mbar_wait(&k_full[st], (j / S) & 1);
    issue_scores<D>(s, qa, sm::rows_desc<D>(Ks + st * L::kKV, 0));
    // the state so far to the running maximum of tile j - 1, then its
    // P V, both under tile j's scores
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= al[(i >> 1) & 1];
    sm::mbar_wait(&v_full[pv], ((j - 1) / S) & 1);
    fw::issue_pv<D>(o, p, sm::rows_desc<D>(Vs + pv * L::kKV, 0));
    sm::wgmma_wait<1>();
    sm::fence_regs(s);
    fw::softmax_tile(s, m, al, l, cl::kLog2e, j * BN, a.n, t);
    sm::wgmma_wait<0>();
    sm::fence_regs(o);
#pragma unroll
    for (int kt = 0; kt < BN / 16; ++kt) sm::fence_regs(p[kt]);
    // stage pv (tile j - 1) is free once every warp's products on it are
    // done: it takes tile j - 1 + S
    if (j - 1 + S < n_tiles) {
      asm volatile("bar.sync 1, %0;\n" ::"n"(cl::kFwdThreads) : "memory");
      if (tid == 0)
        load_kv<D>(Ks, Vs, k_full, v_full, &map_k, &map_v, a, pv,
                   (j - 1 + S) * BN, h, b);
    }
    fw::pack_p(s, p);
  }
  {
    const int last = (n_tiles - 1) % S;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= al[(i >> 1) & 1];
    sm::mbar_wait(&v_full[last], ((n_tiles - 1) / S) & 1);
    fw::issue_pv<D>(o, p, sm::rows_desc<D>(Vs + last * L::kKV, 0));
    sm::wgmma_wait<0>();
    sm::fence_regs(o);
#pragma unroll
    for (int kt = 0; kt < BN / 16; ++kt) sm::fence_regs(p[kt]);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) sm::fence_regs(qa[kk]);
  }

  // o[4 j + e]: row ra (e < 2) or rb, column 8 j + 2 t + (e % 2)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = ra + 8 * i;
    if (row >= a.n) continue;
    const float inv = 1.0f / l[i];
    bf16* orow = a.out + (static_cast<size_t>(b) * a.n + row) * C + h * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * t) =
          __floats2bfloat162_rn(o[4 * j + 2 * i] * inv,
                                o[4 * j + 2 * i + 1] * inv);
    if (t == 0 && a.m_out != nullptr) {
      const size_t si = static_cast<size_t>(bh) * a.n + row;
      a.m_out[si] = m[i];
      a.rs_out[si] = inv;
    }
  }
}

template <int D>
const void* kernel_of() {
  return reinterpret_cast<const void*>(attention_core_long_kernel<D>);
}

template <int D>
int launch(const void* qkv, void* out, void* m, void* rs, int B, int N,
           int heads, float scale, cudaStream_t stream) {
  Args a;
  a.qkv = static_cast<const bf16*>(qkv);
  a.out = static_cast<bf16*>(out);
  a.m_out = static_cast<float*>(m);
  a.rs_out = static_cast<float*>(rs);
  a.n = N;
  a.heads = heads;
  a.scale = scale;
  // K and V: the (B, H, N, D) views of the qkv rows, 128-key boxes
  const long long C = static_cast<long long>(heads) * D;
  const bf16* k = a.qkv + C;
  CUtensorMap mk, mv;
  int err = fw::encode_rows<D>(&mk, k, B, heads, N, N * 3 * C, D, 3 * C,
                               cl::kFwdTile, &a.axes);
  if (err == 0)
    err = fw::encode_rows<D>(&mv, k + C, B, heads, N, N * 3 * C, D, 3 * C,
                             cl::kFwdTile, &a.axes);
  if (err != 0) return err;
  constexpr int smem = cl::FwdLayout<D>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      attention_core_long_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((N + cl::kRows - 1) / cl::kRows, B * heads);
  attention_core_long_kernel<D><<<grid, cl::kFwdThreads, smem, stream>>>(
      mk, mv, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The long route at any N: qkv (B, N, 3C) bf16, 16-byte aligned (the
// tensor maps' base); m and rs (B, heads, N) fp32, both null or both set.
// One kernel.
MVT_EXPORT int mvt_attention_core_long(const void* qkv, void* out, void* m,
                                       void* rs, int B, int N, int heads,
                                       int D, float scale, void* stream) {
  if (B <= 0 || heads <= 0 || N <= 0 ||
      static_cast<long long>(B) * heads > 65535 ||
      (m == nullptr) != (rs == nullptr) ||
      reinterpret_cast<uintptr_t>(qkv) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch<64>(qkv, out, m, rs, B, N, heads, scale, s);
  if (D == 32) return launch<32>(qkv, out, m, rs, B, N, heads, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// the backward's figures into f[0..14] (attention_core_bwd_long_wgmma.cu)
int core_long_bwd_figures(int N, int D, int* f);

// The launch figures of N tokens at head width D into f[0..22]: for the
// forward, the dq and the dk / dv kernel in turn, seven each: CTAs per
// (image, head), the CTA's own rows, the walked tile's rows, threads,
// stages, dynamic shared memory bytes and the CTAs an SM that the runtime
// fits; then the kernels a backward call launches and a forward call
// launches.  Returns a cudaError_t value.
MVT_EXPORT int mvt_attention_core_long_plan(int N, int D, int* f) {
  if (N <= 0 || (D != 64 && D != 32))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = D == 64 ? cl::FwdLayout<64>::kBytes
                           : cl::FwdLayout<32>::kBytes;
  const void* fn = D == 64 ? kernel_of<64>() : kernel_of<32>();
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int ctas = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, fn,
                                                      cl::kFwdThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int v[7] = {(N + cl::kRows - 1) / cl::kRows, cl::kRows, cl::kFwdTile,
                    cl::kFwdThreads, cl::kFwdStages, smem, ctas};
  for (int i = 0; i < 7; ++i) f[i] = v[i];
  f[22] = 1;
  return core_long_bwd_figures(N, D, f + 7);
}
