// flash_attention_f32_fwd on Hopper: softmax attention over (B, H, N, D)
// fp32 q, k, v, keys at or past n_valid masked, the fp32 output and
// optionally the fp32 LSE (B, H, N) that the backward reads.
//
// Replaces both TPU flash forwards of myrtle_vision_tpu/ops/flash_attention.py
// on fp32 operands (compute_dtype float32): the unblocked `_fwd_kernel` (K5,
// n_pad <= 1536) and the blocked `_blk_fwd_kernel` (K6, online softmax over
// KV tiles, the LSE emitted).  On fp32 operands their dots take
// `_kernel_precision` None, i.e. true fp32 products; both compute the same
// function, so one kernel serves both.  Per 64-key tile, for each query row:
//   s   = (q . k^T) scale                  3xTF32 (flash_tf32.cuh), the
//                                          scale after the sum
//   s   = -1e30 for keys >= n_valid
//   m'  = max(m, rowmax(s)),  a = exp(m - m')
//   e   = exp(s - m'),  l = a l + rowsum(e),  acc = a acc + e . v (3xTF32)
// and at the end o = acc / l (an exact divide), LSE = m + log l: the plain
// version's (ops/flash_attention.py `_blocked`) steps with every product
// 3xTF32, about 2^-22 of each product off true fp32.
//
// What bounds it on the H100: at the detection eval's (8, 6, 2601, 64) the
// two products are 4 N^2 D B H = 83 GFLOP, three TF32 passes of them 0.504
// ms at 495 TFLOP/s, against 0.019 ms for its 64 MB of q, k, v and o and
// 0.078 ms for its 325 M exponentials on the SFUs: the tensor cores bound
// it.
//
// Design: two launches.  The split pass (flash_tf32.cuh) writes K's tf32
// halves as they lie (64 keys x D, the head dimension permuted within each
// 8) and V's transposed (D x keys), once a call: every query CTA of an
// (image, head) reads every KV tile, and would split it again.  The core is
// the bf16 kernel's shape (flash_attention_fwd_wgmma.cu): a CTA per 128
// query rows of one (image, head), two consumer warpgroups and no producer
// warp: ptxas gives a thread the registers of a CTA rounded up to whole
// warpgroups, setmaxnreg or not, so a producer warp or warpgroup beside them
// would leave a consumer 168 registers, and its Q and P fragments, scores
// and output need about 200 (they spilled). Thread 0 keeps a ring of K and
// V^T tiles of 64 keys (hi and lo each) full by TMA: each slot has a full
// and an empty barrier for K and for V, a K tile is released once its scores
// are in and a V tile once its product is done, and thread 0 refills a slot
// once both halves of it are released.  Each consumer warpgroup takes 64
// query rows: its Q rows are loaded once and split in registers into the A
// fragments of S = Q K^T (RS wgmma m64n64k8, 3 x D / 8 products); the scores
// stay in registers, and e, split in place, is the A fragment of O += P V
// (m64nDk8 against V^T), 3 x 8 products.  The warpgroup issues S of tile j +
// 1 and P V of tile j before the softmax of tile j + 1, and the other
// warpgroup's products fill the rest.  A KV tile wholly at or past n_valid
// is never loaded.
#include "flash_tf32.cuh"

namespace {

namespace sm = mvt::sm90;
namespace tf = mvt::tf32flash;

// two consumer warpgroups (thread 0 also issues the loads)
constexpr int kThreads = 256;
constexpr int kConsumerWarps = 8;
constexpr int kRowsCta = 128;

// [ring: stages x (K hi, lo)][ring: stages x (V^T hi, lo)][barriers]
template <int D>
struct FwdLayout {
  static constexpr int kHalf = tf::half_bytes<D>();
  static constexpr int kKV = 2 * kHalf;
  static constexpr int kFit = (tf::kSmemOptin - 1024 - 128) / (2 * kKV);
  static constexpr int kStages = kFit > 4 ? 4 : kFit;
  static constexpr int kBarOff = 2 * kStages * kKV;
  static constexpr int kBytes = 1024 + kBarOff + 8 * 4 * kStages;
};
static_assert(FwdLayout<64>::kStages >= 2 && FwdLayout<32>::kStages >= 2,
              "the forward's ring needs two stages");

struct FwdArgs {
  const float* q;
  long long s_image;  // element strides of q
  int s_head, s_row;
  float* o;    // (B, N, H, D) contiguous
  float* lse;  // (B, H, N) or null
  int heads, n, n_valid;
  float scale;
};

// S = Q K^T of a warpgroup's 64 rows against a 64-key tile (dk: the K
// tile's hi half; lo one half further), one group
template <int D>
__device__ __forceinline__ void issue_scores(float (&s)[32],
                                             const uint32_t (&qh)[D / 8][4],
                                             const uint32_t (&ql)[D / 8][4],
                                             uint64_t dk) {
  constexpr uint32_t kLo = tf::half_bytes<D>() >> 4;
  sm::wgmma_fence();
  tf::chain3<D / 8>([&](int a, int b, int k) {
    tf::WgmmaRS<64>::mma(s, a ? ql[k] : qh[k],
                         dk + (b ? kLo : 0) + tf::step(tf::kNatBlock, k),
                         tf::chain_first(a, b, k) ? 0 : 1);
  });
  sm::wgmma_commit();
}

// O += P V over a 64-key tile (dv: the V^T tile's hi half), one group
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&ph)[8][4],
                                         const uint32_t (&pl)[8][4],
                                         uint64_t dv) {
  constexpr uint32_t kLo = tf::half_bytes<D>() >> 4;
  sm::wgmma_fence();
  tf::chain3<8>([&](int a, int b, int k) {
    tf::WgmmaRS<D>::mma(o, a ? pl[k] : ph[k],
                        dv + (b ? kLo : 0) + tf::step(D * 128, k), 1);
  });
  sm::wgmma_commit();
}

// The online softmax of one tile's scores (s[4 j + e]: row g + 8 (e / 2),
// key col0 + 8 j + 2 t + e % 2): s scaled, keys at or past n_valid set to
// -1e30, the running maxima m, the factors a of the old state, e in place
// of s, the thread's partial row sums l.
__device__ __forceinline__ void softmax_tile(float (&s)[32], float (&m)[2],
                                             float (&a)[2], float (&l)[2],
                                             float scale, int col0,
                                             int n_valid, int t) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v = __fmul_rn(s[4 * j + e], scale);
      if (col0 + 8 * j + 2 * t + (e & 1) >= n_valid) v = tf::kNeg;
      s[4 * j + e] = v;
      mx[e >> 1] = fmaxf(mx[e >> 1], v);
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    a[i] = expf(__fsub_rn(m[i], mx[i]));
    m[i] = mx[i];
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = expf(__fsub_rn(s[4 * j + e], m[e >> 1]));
      s[4 * j + e] = x;
      sum[e >> 1] = __fadd_rn(sum[e >> 1], x);
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = __fadd_rn(__fmul_rn(l[i], a[i]), sum[i]);
}

// a consumer warp's lane 0 releases a stage once the warp is done with it
__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) sm::mbar_arrive(bar);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_f32_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v,
                           const FwdArgs a) {
  using L = FwdLayout<D>;
  constexpr int S = L::kStages, BN = tf::kTile;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = tf::aligned_smem(smem_raw);
  unsigned char* Ks = smem;
  unsigned char* Vs = smem + S * L::kKV;
  uint64_t* k_full = reinterpret_cast<uint64_t*>(smem + L::kBarOff);
  uint64_t* v_full = k_full + S;
  uint64_t* k_empty = v_full + S;
  uint64_t* v_empty = k_empty + S;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y, bhs = gridDim.y;
  const int b = bh / a.heads, h = bh % a.heads;
  const int q0 = blockIdx.x * kRowsCta;
  const int n_tiles = (a.n_valid + BN - 1) / BN;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      sm::mbar_init(&k_full[s], 1);
      sm::mbar_init(&v_full[s], 1);
      sm::mbar_init(&k_empty[s], kConsumerWarps);
      sm::mbar_init(&v_empty[s], kConsumerWarps);
    }
    sm::fence_barrier_init();
  }
  __syncthreads();

  // thread 0: tile u into slot u % S once tile u - S has left it
  auto refill = [&](int u) {
    if (tid == 0 && u < n_tiles) {
      const int s = u % S;
      const uint32_t use = u / S;
      if (use > 0) {
        sm::mbar_wait(&k_empty[s], (use - 1) & 1);
        sm::mbar_wait(&v_empty[s], (use - 1) & 1);
      }
      sm::mbar_expect_tx(&k_full[s], L::kKV);
      tf::load_natural<D>(Ks + s * L::kKV, &map_k, &k_full[s], 0, bh, bhs,
                          u * BN);
      sm::mbar_expect_tx(&v_full[s], L::kKV);
      tf::load_transposed<D>(Vs + s * L::kKV, &map_v, &v_full[s], 0, bh, bhs,
                             u * BN);
    }
    __syncwarp();
  };
  for (int u = 0; u < S; ++u) refill(u);

  // the consumers: warpgroup wg takes query rows q0 + 64 wg ... + 63
  const int wg = warp >> 2, w = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int ra = q0 + 64 * wg + 16 * w + g;

  // the rows' Q as the split A fragments of S = Q K^T: step k holds
  // columns 8 k + 2 t and 8 k + 2 t + 1 of rows ra and ra + 8
  uint32_t qh[D / 8][4], ql[D / 8][4];
  {
    const float* qb = a.q + b * a.s_image + static_cast<long long>(h) * a.s_head;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = ra + 8 * i;
      const float* qr = qb + static_cast<long long>(row) * a.s_row + 2 * t;
#pragma unroll
      for (int k = 0; k < D / 8; ++k) {
        float2 x = make_float2(0.f, 0.f);
        if (row < a.n) x = *reinterpret_cast<const float2*>(qr + 8 * k);
        tf::split(x.x, qh[k][i], ql[k][i]);
        tf::split(x.y, qh[k][2 + i], ql[k][2 + i]);
      }
    }
  }

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {tf::kNeg, tf::kNeg};
  float l[2] = {0.f, 0.f}, al[2];
  float s[32];
  uint32_t ph[8][4], pl[8][4];

  sm::mbar_wait(&k_full[0], 0);
  issue_scores<D>(s, qh, ql, tf::tile_desc(Ks));
  sm::wgmma_wait<0>();
  sm::fence_regs(s);
  release(&k_empty[0], lane);
  softmax_tile(s, m, al, l, a.scale, 0, a.n_valid, t);
  tf::frags(s, ph, pl);

  for (int j = 1; j < n_tiles; ++j) {
    const int st = j % S, pv = (j - 1) % S;
    sm::mbar_wait(&k_full[st], (j / S) & 1);
    issue_scores<D>(s, qh, ql, tf::tile_desc(Ks + st * L::kKV));
    // the state so far to the running maximum of tile j - 1, then its
    // P V, both under tile j's scores
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= al[(i >> 1) & 1];
    sm::mbar_wait(&v_full[pv], ((j - 1) / S) & 1);
    issue_pv<D>(o, ph, pl, tf::tile_desc(Vs + pv * L::kKV));
    sm::wgmma_wait<1>();
    sm::fence_regs(s);
    release(&k_empty[st], lane);
    softmax_tile(s, m, al, l, a.scale, j * BN, a.n_valid, t);
    sm::wgmma_wait<0>();
    sm::fence_regs(o);
    tf::fence_frags(ph, pl);
    release(&v_empty[pv], lane);
    refill(j - 1 + S);
    tf::frags(s, ph, pl);
  }
  {
    const int last = (n_tiles - 1) % S;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= al[(i >> 1) & 1];
    sm::mbar_wait(&v_full[last], ((n_tiles - 1) / S) & 1);
    issue_pv<D>(o, ph, pl, tf::tile_desc(Vs + last * L::kKV));
    sm::wgmma_wait<0>();
    sm::fence_regs(o);
    tf::fence_frags(ph, pl);
  }

  // o[4 j + e]: row ra (e < 2) or ra + 8, column 8 j + 2 t + (e % 2)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = __fadd_rn(l[i], __shfl_xor_sync(0xffffffffu, l[i], 1));
    l[i] = __fadd_rn(l[i], __shfl_xor_sync(0xffffffffu, l[i], 2));
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = ra + 8 * i;
    if (row >= a.n) continue;
    float* orow =
        a.o + ((static_cast<long long>(b) * a.n + row) * a.heads + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(orow + 8 * j + 2 * t) = make_float2(
          __fdiv_rn(o[4 * j + 2 * i], l[i]),
          __fdiv_rn(o[4 * j + 2 * i + 1], l[i]));
    if (t == 0 && a.lse != nullptr)
      a.lse[static_cast<long long>(bh) * a.n + row] =
          __fadd_rn(m[i], logf(l[i]));
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const FwdArgs& a,
           float* scratch, long long in_image, int in_head, int in_row,
           int B, int* launched, cudaStream_t stream) {
  const int bhs = B * a.heads, ns = tf::n_split(a.n);
  float* nat = scratch;
  float* tr = scratch + 2LL * bhs * ns * D;
  CUtensorMap mk, mv;
  int err = tf::encode_natural<D>(&mk, nat, 1, bhs, ns);
  if (err == 0) err = tf::encode_transposed<D>(&mv, tr, 1, bhs, ns);
  static unsigned ready = 0;
  constexpr int smem = FwdLayout<D>::kBytes;
  if (err == 0)
    err = tf::allow_smem(
        reinterpret_cast<const void*>(flash_f32_fwd_wgmma_kernel<D>), smem,
        &ready);
  if (err != 0) return err;
  // K as it lies into natural array 0, V transposed into array 0
  tf::SplitArgs sa{};
  sa.op[0] = {static_cast<const float*>(k), in_image, in_head, in_row, 0, -1};
  sa.op[1] = {static_cast<const float*>(v), in_image, in_head, in_row, -1, 0};
  sa.nat = nat;
  sa.tr = tr;
  sa.heads = a.heads;
  sa.n = a.n;
  sa.ns = ns;
  err = tf::launch_split(sa, 2, B, D, stream);
  if (err != 0) return err;
  *launched = 1;
  const dim3 grid((a.n + kRowsCta - 1) / kRowsCta, bhs);
  flash_f32_fwd_wgmma_kernel<D><<<grid, kThreads, smem, stream>>>(mk, mv, a);
  err = static_cast<int>(cudaGetLastError());
  if (err == 0) *launched = 2;
  return err;
}

}  // namespace

// q, k, v: fp32 (B, H, N, D) views sharing the element strides (image,
// head, row), rows contiguous and 16-byte aligned; o: fp32 (B, N, H, D)
// contiguous; lse: fp32 (B, H, N) contiguous or null; scratch: fp32, 4 B H
// n_split(N) D values (the split halves of K and of V^T); D 32 or 64.  Two
// kernels: `launched` gets how many launched.
MVT_EXPORT int mvt_flash_attention_f32_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    void* scratch, long long in_image, int in_head, int in_row, int B, int H,
    int N, int D, int n_valid, float scale, int* launched, void* stream) {
  *launched = 0;
  if (B <= 0 || H <= 0 || N <= 0 || n_valid <= 0 || n_valid > N ||
      static_cast<long long>(B) * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  FwdArgs a;
  a.q = static_cast<const float*>(q);
  a.s_image = in_image;
  a.s_head = in_head;
  a.s_row = in_row;
  a.o = static_cast<float*>(o);
  a.lse = static_cast<float*>(lse);
  a.heads = H;
  a.n = N;
  a.n_valid = n_valid;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
  if (D == 64)
    return launch<64>(q, k, v, a, sc, in_image, in_head, in_row, B, launched,
                      s);
  if (D == 32)
    return launch<32>(q, k, v, a, sc, in_image, in_head, in_row, B, launched,
                      s);
  return static_cast<int>(cudaErrorInvalidValue);
}
