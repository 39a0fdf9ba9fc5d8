// flash_attention_fwd on Hopper: softmax attention over (B, H, N, D) bf16
// q, k, v, keys at or past n_valid masked, bf16 output and optionally the
// fp32 LSE (B, H, N) that the backward reads.
//
// Replaces both TPU flash forwards of myrtle_vision_tpu/ops/flash_attention.py:
// the unblocked `_fwd_kernel` (K5, n_pad <= 1536: scores of the whole
// sequence in VMEM, p = e / rowsum rounded to bf16 before P V) and the
// blocked `_blk_fwd_kernel` (K6: online softmax over KV tiles, bf16(e) V
// accumulated in fp32, / l at the end, the LSE emitted).  Both compute the
// same function, so one kernel serves both and rounds as K6 does, with
// 128-key tiles; against K5 it rounds e where K5 rounds p, which moves an
// output by about 2^-9 of itself.  Per KV tile, for each query row:
//   s     = q . k^T                        fp32 (raw scores)
//   s     = -inf for keys >= n_valid
//   m'    = max(m, rowmax(s)),  a = 2^((m - m') c),  c = scale log2(e)
//   e     = 2^(s c - m' c)                 one FFMA, then MUFU.EX2
//   l     = a l + rowsum(e)                fp32 e
//   acc   = a acc + bf16(e) . v            fp32 accumulation
// and at the end o = acc / l (an exact divide), LSE = m scale + log l.
// The exponent in base 2 with scale log2(e) folded into one FFMA is
// exp(scale s - max) up to an fp32 rounding of the argument.
//
// What bounds it on the H100: at the detection eval's (8, 6, 2601, 64) the
// two products are 4 N^2 D B H = 83 GFLOP (0.084 ms at 989 TFLOP/s)
// against 64 MB of q, k, v and o (0.019 ms at 3.35 TB/s), and the 325 M
// exponentials take about 0.078 ms on the SFUs (16 a clock an SM): the
// products and the softmax take about as long as each other, so the
// kernel can beat running them one after the other only by overlapping
// them.
//
// Design (flash_wgmma.cuh): a CTA per 128 query rows of one (image,
// head), three warpgroups.  The producer loads the Q tile once and keeps
// a ring of kFwdStages K tiles and as many V tiles of 128 keys full, each
// by TMA through a 4-D tensor map over the caller's (B, H, N, D) view
// (the fused qkv rows are read in place), each with its own full and
// empty barrier, so a K tile is released as soon as its scores are in
// and a V tile once its product is done.  Each consumer warpgroup takes
// 64 query rows: S = Q K^T is an SS wgmma m64n128 with the scores in
// registers (64 fp32 a thread), P = bf16(e) is formed whole in registers
// as the A fragments of O += P V (wgmma m64nD, V read MN-major through the
// transpose bit).  The softmax of tile j runs while the tensor cores work:
// the warpgroup issues S of tile j + 1 and P V of tile j before it turns
// to the softmax of tile j + 1, and the other warpgroup's products fill
// the rest.  A KV tile wholly at or past n_valid is never loaded.  The
// epilogue divides by l and stores bf16 pairs to the (B, N, H, D) rows,
// the LSE beside them.
#include "flash_wgmma.cuh"

namespace {

using mvt::bf16;
namespace sm = mvt::sm90;
namespace fw = mvt::flashw;

struct FwdArgs {
  bf16* o;
  float* lse;  // (B, H, N) or null
  long long out_image;  // element strides of o
  int out_head, out_row;
  int heads, n, n_valid;
  float scale;
  fw::Axes axes;
};

// S = Q K^T of a warpgroup's 64 rows against a 128-key tile, issued and
// committed as one group
template <int D>
__device__ __forceinline__ void issue_scores(float (&s)[fw::kFwdTile / 2],
                                             uint64_t dq, uint64_t dk) {
  sm::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    sm::WgmmaSS<fw::kFwdTile>::template mma<0, 0>(
        s, sm::desc_add(dq, kk * 32), sm::desc_add(dk, kk * 32),
        kk > 0 ? 1 : 0);
  sm::wgmma_commit();
}

template <int D>
__global__ void __launch_bounds__(fw::kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const FwdArgs a) {
  using L = fw::FwdLayout<D>;
  constexpr int S = fw::kFwdStages, BN = fw::kFwdTile;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = fw::aligned_smem(smem_raw);
  unsigned char* Qs = smem;
  unsigned char* Ks = smem + L::kQ;
  unsigned char* Vs = Ks + S * L::kKV;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBarOff);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + S;
  uint64_t* k_empty = v_full + S;
  uint64_t* v_empty = k_empty + S;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y, b = bh / a.heads, h = bh % a.heads;
  const int q0 = blockIdx.x * fw::kRowsCta;
  const int n_tiles = (a.n_valid + BN - 1) / BN;

  if (tid == 0) {
    sm::mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      sm::mbar_init(&k_full[s], 1);
      sm::mbar_init(&v_full[s], 1);
      sm::mbar_init(&k_empty[s], fw::kConsumerWarps);
      sm::mbar_init(&v_empty[s], fw::kConsumerWarps);
    }
    sm::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= fw::kConsumerWarps) {
    // the producer warpgroup: one thread keeps the ring full
    sm::setmaxnreg_dec<fw::kProducerRegs>();
    if (warp == fw::kConsumerWarps && lane == 0) {
      sm::mbar_expect_tx(q_full, L::kQ);
      fw::load_rows(Qs, &map_q, q_full, a.axes, q0, h, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % S;
        const uint32_t use = j / S;
        if (use > 0) sm::mbar_wait(&k_empty[s], (use - 1) & 1);
        sm::mbar_expect_tx(&k_full[s], L::kKV);
        fw::load_rows(Ks + s * L::kKV, &map_k, &k_full[s], a.axes, j * BN, h,
                      b);
        if (use > 0) sm::mbar_wait(&v_empty[s], (use - 1) & 1);
        sm::mbar_expect_tx(&v_full[s], L::kKV);
        fw::load_rows(Vs + s * L::kKV, &map_v, &v_full[s], a.axes, j * BN, h,
                      b);
      }
    }
    return;
  }

  // the consumers: warpgroup wg takes query rows q0 + 64 wg ... + 63
  sm::setmaxnreg_inc<fw::kConsumerRegs>();
  const int wg = warp >> 2, w = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const float c = a.scale * fw::kLog2e;
  const uint64_t dq = sm::rows_desc<D>(Qs, 64 * wg);

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {mvt::neg_inf(), mvt::neg_inf()};
  float l[2] = {0.f, 0.f}, al[2];
  float s[BN / 2];
  uint32_t p[BN / 16][4];

  sm::mbar_wait(q_full, 0);
  sm::mbar_wait(&k_full[0], 0);
  issue_scores<D>(s, dq, sm::rows_desc<D>(Ks, 0));
  sm::wgmma_wait<0>();
  sm::fence_regs(s);
  fw::release(&k_empty[0], lane);
  fw::softmax_tile(s, m, al, l, c, 0, a.n_valid, t);
  fw::pack_p(s, p);

  for (int j = 1; j < n_tiles; ++j) {
    const int st = j % S, pv = (j - 1) % S;
    sm::mbar_wait(&k_full[st], (j / S) & 1);
    issue_scores<D>(s, dq, sm::rows_desc<D>(Ks + st * L::kKV, 0));
    // the state so far to the running maximum of tile j - 1, then its
    // P V, both under tile j's scores
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= al[(i >> 1) & 1];
    sm::mbar_wait(&v_full[pv], ((j - 1) / S) & 1);
    fw::issue_pv<D>(o, p, sm::rows_desc<D>(Vs + pv * L::kKV, 0));
    sm::wgmma_wait<1>();
    sm::fence_regs(s);
    fw::release(&k_empty[st], lane);
    fw::softmax_tile(s, m, al, l, c, j * BN, a.n_valid, t);
    sm::wgmma_wait<0>();
    sm::fence_regs(o);
#pragma unroll
    for (int kt = 0; kt < BN / 16; ++kt) sm::fence_regs(p[kt]);
    fw::release(&v_empty[pv], lane);
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
  }

  // o[4 j + e]: row ra (e < 2) or ra + 8, column 8 j + 2 t + (e % 2)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const int ra = q0 + 64 * wg + 16 * w + g;
  const size_t out0 = static_cast<size_t>(b) * a.out_image +
                      static_cast<size_t>(h) * a.out_head;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = ra + 8 * i;
    if (row >= a.n) continue;
    bf16* orow = a.o + out0 + static_cast<size_t>(row) * a.out_row;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * t) =
          __floats2bfloat162_rn(o[4 * j + 2 * i] / l[i],
                                o[4 * j + 2 * i + 1] / l[i]);
    if (t == 0 && a.lse != nullptr)
      a.lse[static_cast<size_t>(bh) * a.n + row] =
          m[i] * a.scale + logf(l[i]);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const FwdArgs& base,
           long long in_image, int in_head, int in_row, int B,
           cudaStream_t stream) {
  FwdArgs a = base;
  CUtensorMap mq, mk, mv;
  int err = mvt::flashw::encode_rows<D>(&mq, q, B, a.heads, a.n, in_image,
                                        in_head, in_row, fw::kRowsCta,
                                        &a.axes);
  if (err == 0)
    err = mvt::flashw::encode_rows<D>(&mk, k, B, a.heads, a.n, in_image,
                                      in_head, in_row, fw::kFwdTile, &a.axes);
  if (err == 0)
    err = mvt::flashw::encode_rows<D>(&mv, v, B, a.heads, a.n, in_image,
                                      in_head, in_row, fw::kFwdTile, &a.axes);
  if (err != 0) return err;
  constexpr int smem = fw::FwdLayout<D>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((a.n + fw::kRowsCta - 1) / fw::kRowsCta, B * a.heads);
  flash_fwd_wgmma_kernel<D><<<grid, fw::kThreads, smem, stream>>>(mq, mk, mv,
                                                                  a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k and v share the element strides (in_*), 16-byte aligned rows with
// the head dimension contiguous; o has its own (out_*); lse (B, H, N)
// fp32 or null.
MVT_EXPORT int mvt_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    long long in_image, int in_head, int in_row, long long out_image,
    int out_head, int out_row, int B, int H, int N, int D, int n_valid,
    float scale, void* stream) {
  if (B <= 0 || H <= 0 || N <= 0 || n_valid <= 0 || n_valid > N ||
      static_cast<long long>(B) * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  FwdArgs a;
  a.o = static_cast<bf16*>(o);
  a.lse = static_cast<float*>(lse);
  a.out_image = out_image;
  a.out_head = out_head;
  a.out_row = out_row;
  a.heads = H;
  a.n = N;
  a.n_valid = n_valid;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch<64>(q, k, v, a, in_image, in_head, in_row, B, s);
  if (D == 32) return launch<32>(q, k, v, a, in_image, in_head, in_row, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The launch figures of N tokens at head width D into f[0..6]: the grid's
// query tiles per (image, head), the CTA's query rows, the KV tile's
// keys, threads, stages, dynamic shared memory bytes and the CTAs an SM
// that the runtime fits; returns a cudaError_t value.
MVT_EXPORT int mvt_flash_attention_fwd_plan(int N, int D, int* f) {
  if (N <= 0 || (D != 64 && D != 32))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = D == 64 ? fw::FwdLayout<64>::kBytes
                           : fw::FwdLayout<32>::kBytes;
  const void* fn = D == 64
                       ? reinterpret_cast<const void*>(flash_fwd_wgmma_kernel<64>)
                       : reinterpret_cast<const void*>(flash_fwd_wgmma_kernel<32>);
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int ctas = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, fn, fw::kThreads,
                                                      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int figures[7] = {(N + fw::kRowsCta - 1) / fw::kRowsCta,
                          fw::kRowsCta, fw::kFwdTile, fw::kThreads,
                          fw::kFwdStages, smem, ctas};
  for (int i = 0; i < 7; ++i) f[i] = figures[i];
  return 0;
}
