// flash_attention_f32_bwd on Hopper: the backward of
// flash_attention_f32_fwd_wgmma.cu, fp32 (B, H, N, D) q, k, v, the
// forward's output o and LSE, the output gradient do -> fp32 dq, dk, dv.
//
// Replaces both TPU flash backwards of myrtle_vision_tpu/ops/flash_attention.py
// on fp32 operands: `_bwd_kernel` (K8, n_pad <= 1536, p = e / rowsum(e) over
// the whole row) and `_blk_bwd_kernel` (K7, p = exp(s - LSE) per KV tile).
// Their dots on fp32 operands are true fp32 products (`_kernel_precision`
// None).  The rule (`_fa_bwd`), with query rows >= n_valid masked:
//   dsum = rowsum(do * o)             p = exp((q . k^T) scale - LSE)
//   dv = p^T do                       dp = do v^T
//   ds = p (dp - dsum)                dq = (ds k) scale,  dk = (ds^T q) scale
// every product 3xTF32 (flash_tf32.cuh).  The kernel takes p = exp(s - LSE)
// in both regimes, which differs from K8's e / rowsum(e) by fp32 roundings.
//
// What bounds it on the H100: five products of 2 N^2 D B H each, 73.3
// GFLOP at (8, 6, 1545, 64), three TF32 passes of them 0.444 ms at 495
// TFLOP/s, against 0.185 ms for its bytes.  The kernels below recompute s
// and dp in both of their passes, seven products in all: five would need
// ds of every (query, key) pair across the two passes, in device memory (N^2
// values an (image, head)) or summed across CTAs into dq (atomics, or a
// partial per key tile and a reduction pass), and both cost more bytes
// than the two products cost time.
//
// Design, four launches, no atomics: a pre-pass writes dsum, a warp a row;
// the split pass (flash_tf32.cuh) writes the tf32 halves of q, k, v and do
// as they lie (head dimension permuted within each 8) and of q^T, k^T and
// do^T (tokens permuted within each 8), the K-major operands of the
// products that contract over tokens; then two kernels of one shape.  A
// CTA is two consumer warpgroups and a producer warp whose lane 0 loads by
// TMA the own rows of a work item and, per walked tile of 64 tokens of the
// other side, its natural tiles into one ring and its transposed tiles
// into another, each with full and empty barriers, so the next natural
// tile lands under this tile's gradient products and the next transposed
// one under the next scores.  The CTAs are persistent, one an SM, and the
// rings run on from one work item to the next (at 197 tokens an item has
// 4 tiles, and each CTA's start and end weighed on its time).
//   dk / dv: 64 own keys (K, V) that both warpgroups hold; each takes 32 of
//     a query tile's 64 queries: S^T = K Q^T and dP^T = V dO^T (SS wgmma
//     m64n32k8, the pair's steps in turn), P^T and dS^T in registers, split
//     in place as the A fragments of dV += P^T dO and dK += dS^T Q (RS
//     wgmma against dO^T and Q^T, its 4 of the tile's 8 steps); the two
//     partial sums meet in shared memory at the end.  Two warpgroups on
//     one block of keys: with one, its softmax leaves the tensor cores
//     idle (the loads are not what limits the kernel), and a second block
//     of own K and V does not fit beside the rings.
//   dq: 128 own queries (Q, dO), 64 a warpgroup; per key tile S = Q K^T,
//     dP = dO V^T (m64n64k8), P and dS in registers, dQ += dS K (against
//     K^T).
// Tiles wholly at or past n_valid are not visited (their p is 0), and the
// scale multiplies dq and dk at the end.
#include "flash_tf32.cuh"

namespace {

namespace sm = mvt::sm90;
namespace tf = mvt::tf32flash;

// two consumer warpgroups and a producer warp a CTA: the dk / dv kernel's
// share its 64 own keys and split each walked tile, the dq kernel's own 64
// queries each (a CTA of 288 threads leaves a thread 168 registers)
constexpr int kWarpgroups = 2;
constexpr int kThreads = 128 * kWarpgroups + 32;
// the split arrays: natural K, V, Q, dO; transposed K^T, Q^T, dO^T
constexpr int kNatK = 0, kNatV = 1, kNatQ = 2, kNatDo = 3, kNatArrays = 4;
constexpr int kTrK = 0, kTrQ = 1, kTrDo = 2, kTrArrays = 3;

__host__ __device__ constexpr int at_most_2(int x) { return x > 2 ? 2 : x; }

// [own: (dq: 2 warpgroups x) 2 natural tiles x (hi, lo)][dk / dv: the
// partial sums, 128 threads x D fp32][natural ring: stages x 2 tiles x
// (hi, lo)][transposed ring: stages x (1 dq, 2 dk / dv) tiles x (hi, lo)]
// [own full, empty; natural full, empty; transposed full, empty]
template <int D, bool kDq>
struct BwdLayout {
  static constexpr int kHalf = tf::half_bytes<D>();
  static constexpr int kOwn = 4 * kHalf * (kDq ? kWarpgroups : 1);
  static constexpr int kPart = kDq ? 0 : 128 * D * 4;
  static constexpr int kNat = 4 * kHalf;
  static constexpr int kTr = (kDq ? 2 : 4) * kHalf;
  static constexpr int kBudget = tf::kSmemOptin - 1024 - 128;
  static constexpr int kNatStages =
      at_most_2((kBudget - kOwn - kPart - kTr) / kNat);
  static constexpr int kTrStages =
      at_most_2((kBudget - kOwn - kPart - kNatStages * kNat) / kTr);
  static constexpr int kPartOff = kOwn;
  static constexpr int kNatOff = kPartOff + kPart;
  static constexpr int kTrOff = kNatOff + kNatStages * kNat;
  static constexpr int kBarOff = kTrOff + kTrStages * kTr;
  static constexpr int kBars = 2 + 2 * kNatStages + 2 * kTrStages;
  static constexpr int kBytes = 1024 + kBarOff + 8 * kBars;
};
static_assert(BwdLayout<64, false>::kNatStages >= 1 &&
                  BwdLayout<64, false>::kTrStages >= 1 &&
                  BwdLayout<64, true>::kNatStages >= 1 &&
                  BwdLayout<64, true>::kTrStages >= 1,
              "the backward's rings need a stage each");

// a (B, H, N, D) fp32 view: element (b, h, i, d) at p + b sb + h sh + i sn
// + d, rows 16-byte aligned
struct View {
  const float* p;
  long long sb;
  int sh, sn;
  __device__ __forceinline__ const float* row(int b, int h, int i) const {
    return p + b * sb + static_cast<long long>(h) * sh +
           static_cast<long long>(i) * sn;
  }
};

struct BwdArgs {
  View o, dout;
  const float* lse;  // (B, H, N)
  float* dsum;       // (B, H, N)
  float *dq, *dk, *dv;  // (B, N, H, D) contiguous
  int heads, n, n_valid;
  int bhs;  // images x heads
  float scale;
};

// dsum[b, h, i] = sum_d do[b, h, i, d] o[b, h, i, d], a warp a row
template <int D>
__global__ void __launch_bounds__(256)
    flash_f32_dsum_kernel(BwdArgs a, int rows) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32;
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

// x = A0 B0^T and y = A1 B1^T (64 x N each; a0, a1 the own natural tiles'
// hi halves, b0, b1 the walked ones' from the warpgroup's first column; lo
// one half further), each a 3xTF32 chain, the two chains' steps in turn,
// one group
template <int D, int N>
__device__ __forceinline__ void issue_scores(float (&x)[N / 2],
                                             float (&y)[N / 2], uint64_t a0,
                                             uint64_t a1, uint64_t b0,
                                             uint64_t b1) {
  constexpr uint32_t kLo = tf::half_bytes<D>() >> 4;
  sm::wgmma_fence();
  tf::chain3_pair<D / 8>(
      [&](int ah, int bl, int k) {
        const uint32_t st = tf::step(tf::kNatBlock, k);
        tf::WgmmaSS<N>::mma(x, a0 + (ah ? kLo : 0) + st,
                            b0 + (bl ? kLo : 0) + st,
                            tf::chain_first(ah, bl, k) ? 0 : 1);
      },
      [&](int ah, int bl, int k) {
        const uint32_t st = tf::step(tf::kNatBlock, k);
        tf::WgmmaSS<N>::mma(y, a1 + (ah ? kLo : 0) + st,
                            b1 + (bl ? kLo : 0) + st,
                            tf::chain_first(ah, bl, k) ? 0 : 1);
      });
  sm::wgmma_commit();
}

// step k of acc += F B: F the split A fragments (the warpgroup's J steps),
// B a transposed tile (d: its hi half) from step k0, one 3xTF32 product
template <int D, int J>
__device__ __forceinline__ void grad_step(float (&acc)[D / 2],
                                          const uint32_t (&fh)[J][4],
                                          const uint32_t (&fl)[J][4],
                                          uint64_t d, int k0, int ah, int bl,
                                          int k) {
  constexpr uint32_t kLo = tf::half_bytes<D>() >> 4;
  tf::WgmmaRS<D>::mma(acc, ah ? fl[k] : fh[k],
                      d + (bl ? kLo : 0) + tf::step(D * 128, k0 + k), 1);
}

// a consumer warp's lane 0 releases a stage once the warp is done with it
__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) sm::mbar_arrive(bar);
}

// the consumer warpgroups' named barrier (the producer warp not in it)
__device__ __forceinline__ void consumers_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

// The dk / dv kernel (kDq false) and the dq kernel (kDq true), persistent:
// a work item is a block of own rows of one (image, head) (dk / dv: 64
// keys, dq: 128 queries; the blocks of one (image, head) in a row), and a
// CTA takes items blockIdx.x, blockIdx.x + gridDim.x, ...; its rings run on
// from item to item (tile j of its c-th item that has tiles is u = c T +
// j), and the next item's own rows load once this item's last scores are
// in, under its last gradient products and its epilogue.  dk / dv: both
// warpgroups hold the item's keys, and each takes half of each walked
// 64-query tile (its 32 columns of S^T, dP^T, and 4 of the 8 steps of dV
// and dK); their two partial sums are added at the end, warpgroup 0's
// first.  dq: each warpgroup owns 64 of the item's 128 queries and takes
// whole key tiles.  An item wholly at or past n_valid walks nothing and
// stores zeros.
template <int D, bool kDq>
__global__ void __launch_bounds__(kThreads, 1)
flash_f32_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_n,
                           const __grid_constant__ CUtensorMap map_t,
                           const BwdArgs a) {
  using L = BwdLayout<D, kDq>;
  constexpr int SN = L::kNatStages, ST = L::kTrStages, H2 = 2 * L::kHalf;
  constexpr int WG = kWarpgroups, kConsumerWarps = 4 * WG;
  constexpr int kOwnRows = kDq ? tf::kTile * WG : tf::kTile;
  // a warpgroup's walked columns a tile, and the steps of its gradient
  // product over them
  constexpr int NW = kDq ? tf::kTile : tf::kTile / WG, J = NW / 8;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = tf::aligned_smem(smem_raw);
  unsigned char* own = smem;
  unsigned char* nat = smem + L::kNatOff;
  unsigned char* trs = smem + L::kTrOff;
  uint64_t* own_full = reinterpret_cast<uint64_t*>(smem + L::kBarOff);
  uint64_t* own_empty = own_full + 1;
  uint64_t* n_full = own_full + 2;
  uint64_t* n_empty = n_full + SN;
  uint64_t* t_full = n_empty + SN;
  uint64_t* t_empty = t_full + ST;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  // own-row blocks an (image, head), those before n_valid, walked tiles
  const int blocks = (a.n + kOwnRows - 1) / kOwnRows;
  const int blocks_valid = (a.n_valid + kOwnRows - 1) / kOwnRows;
  const int T = (a.n_valid + tf::kTile - 1) / tf::kTile;
  const int items = blocks * a.bhs;

  if (tid == 0) {
    sm::mbar_init(own_full, 1);
    sm::mbar_init(own_empty, kConsumerWarps);
    for (int s = 0; s < SN; ++s) {
      sm::mbar_init(&n_full[s], 1);
      sm::mbar_init(&n_empty[s], kConsumerWarps);
    }
    for (int s = 0; s < ST; ++s) {
      sm::mbar_init(&t_full[s], 1);
      sm::mbar_init(&t_empty[s], kConsumerWarps);
    }
    sm::fence_barrier_init();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // the producer: lane 0 issues every load
    if (lane == 0) {
      int c = 0;  // items with tiles so far
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int bh = item / blocks, r0 = (item % blocks) * kOwnRows;
        if (item % blocks >= blocks_valid) continue;
        constexpr int kOwnBlocks = kOwnRows / tf::kTile;
        if (c > 0) sm::mbar_wait(own_empty, (c - 1) & 1);
        sm::mbar_expect_tx(own_full, 2 * kOwnBlocks * H2);
        for (int i = 0; i < kOwnBlocks; ++i) {
          tf::load_natural<D>(own + 2 * i * H2, &map_n, own_full,
                              kDq ? kNatQ : kNatK, bh, a.bhs, r0 + 64 * i);
          tf::load_natural<D>(own + (2 * i + 1) * H2, &map_n, own_full,
                              kDq ? kNatDo : kNatV, bh, a.bhs, r0 + 64 * i);
        }
        for (int j = 0; j < T; ++j) {
          const int u = c * T + j, t0 = j * tf::kTile;
          const int sn = u % SN, un = u / SN;
          if (un > 0) sm::mbar_wait(&n_empty[sn], (un - 1) & 1);
          unsigned char* nt = nat + sn * L::kNat;
          sm::mbar_expect_tx(&n_full[sn], L::kNat);
          tf::load_natural<D>(nt, &map_n, &n_full[sn], kDq ? kNatK : kNatQ,
                              bh, a.bhs, t0);
          tf::load_natural<D>(nt + H2, &map_n, &n_full[sn],
                              kDq ? kNatV : kNatDo, bh, a.bhs, t0);
          const int st = u % ST, ut = u / ST;
          if (ut > 0) sm::mbar_wait(&t_empty[st], (ut - 1) & 1);
          unsigned char* tt = trs + st * L::kTr;
          sm::mbar_expect_tx(&t_full[st], L::kTr);
          if (kDq) {
            tf::load_transposed<D>(tt, &map_t, &t_full[st], kTrK, bh, a.bhs,
                                   t0);
          } else {
            tf::load_transposed<D>(tt, &map_t, &t_full[st], kTrQ, bh, a.bhs,
                                   t0);
            tf::load_transposed<D>(tt + H2, &map_t, &t_full[st], kTrDo, bh,
                                   a.bhs, t0);
          }
        }
        ++c;
      }
    }
    return;
  }

  // the consumer warpgroups: a thread's own rows ra, ra + 8 of its warp's
  // 16 (dq: of its warpgroup's 64), its walked columns from cw of a tile
  const int wg = warp >> 2, w = warp & 3, g = lane >> 2, t = lane & 3;
  const int cw = kDq ? 0 : NW * wg;
  const int own_blk = kDq ? 2 * wg : 0;
  const uint64_t d_own0 = tf::tile_desc(own + own_blk * H2);
  const uint64_t d_own1 = tf::tile_desc(own + (own_blk + 1) * H2);
  int c = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int bh = item / blocks, b = bh / a.heads, h = bh % a.heads;
    const int ra = (item % blocks) * kOwnRows + (kDq ? 64 * wg : 0) +
                   16 * w + g;
    const long long stat0 = static_cast<long long>(bh) * a.n;
    float acc0[D / 2], acc1[D / 2];  // dk / dv: dv, dk; dq: dq
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc0[i] = acc1[i] = 0.f;
    if (item % blocks < blocks_valid) {
      // dq: the own rows' LSE and dsum
      float row_lse[2] = {0.f, 0.f}, row_dsum[2] = {0.f, 0.f};
      if (kDq) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
          if (ra + 8 * i < a.n) {
            row_lse[i] = a.lse[stat0 + ra + 8 * i];
            row_dsum[i] = a.dsum[stat0 + ra + 8 * i];
          }
      }
      sm::mbar_wait(own_full, c & 1);
      for (int j = 0; j < T; ++j) {
        const int u = c * T + j, c0 = j * tf::kTile + cw;
        // dk / dv: the walked queries' LSE and dsum, columns c0 + 8 jj +
        // 2 t + e at [2 jj + e]
        float col_lse[2 * J], col_dsum[2 * J];
        if (!kDq) {
#pragma unroll
          for (int jj = 0; jj < J; ++jj)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = c0 + 8 * jj + 2 * t + e;
              const bool in = col < a.n;
              col_lse[2 * jj + e] = in ? a.lse[stat0 + col] : 0.f;
              col_dsum[2 * jj + e] = in ? a.dsum[stat0 + col] : 0.f;
            }
        }
        const int sn = u % SN, st = u % ST;
        float x[NW / 2], y[NW / 2];
        sm::mbar_wait(&n_full[sn], (u / SN) & 1);
        unsigned char* nt = nat + sn * L::kNat + cw * 128;
        issue_scores<D, NW>(x, y, d_own0, d_own1, tf::tile_desc(nt),
                            tf::tile_desc(nt + H2));
        sm::wgmma_wait<0>();
        sm::fence_regs(x);
        sm::fence_regs(y);
        release(&n_empty[sn], lane);
        if (j == T - 1) release(own_empty, lane);
        // x: the scores, y: dp (rows own, columns walked; dk / dv: keys x
        // queries) -> p, ds
#pragma unroll
        for (int jj = 0; jj < J; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * jj + e;
            const int row = ra + 8 * (e >> 1);
            const int col = c0 + 8 * jj + 2 * t + (e & 1);
            const bool ok = row < a.n_valid && col < a.n_valid;
            const float lse =
                kDq ? row_lse[e >> 1] : col_lse[2 * jj + (e & 1)];
            const float ds =
                kDq ? row_dsum[e >> 1] : col_dsum[2 * jj + (e & 1)];
            const float p =
                ok ? expf(__fsub_rn(__fmul_rn(x[i], a.scale), lse)) : 0.f;
            x[i] = p;
            y[i] = ok ? __fmul_rn(p, __fsub_rn(y[i], ds)) : 0.f;
          }
        uint32_t dh[J][4], dl[J][4];
        tf::frags(y, dh, dl);
        sm::mbar_wait(&t_full[st], (u / ST) & 1);
        unsigned char* tt = trs + st * L::kTr;
        const int k0 = cw / 8;  // the warpgroup's first step of the tile
        if (kDq) {
          // dQ += dS K
          const uint64_t dk_t = tf::tile_desc(tt);
          sm::wgmma_fence();
          tf::chain3<J>([&](int ah, int bl, int k) {
            grad_step<D, J>(acc0, dh, dl, dk_t, k0, ah, bl, k);
          });
          sm::wgmma_commit();
          sm::wgmma_wait<0>();
          sm::fence_regs(acc0);
        } else {
          // dV += P^T dO, dK += dS^T Q over the warpgroup's queries
          uint32_t ph[J][4], pl[J][4];
          tf::frags(x, ph, pl);
          const uint64_t dq_t = tf::tile_desc(tt);
          const uint64_t ddo_t = tf::tile_desc(tt + H2);
          sm::wgmma_fence();
          tf::chain3_pair<J>(
              [&](int ah, int bl, int k) {
                grad_step<D, J>(acc0, ph, pl, ddo_t, k0, ah, bl, k);
              },
              [&](int ah, int bl, int k) {
                grad_step<D, J>(acc1, dh, dl, dq_t, k0, ah, bl, k);
              });
          sm::wgmma_commit();
          sm::wgmma_wait<0>();
          sm::fence_regs(acc0);
          sm::fence_regs(acc1);
          tf::fence_frags(ph, pl);
        }
        tf::fence_frags(dh, dl);
        release(&t_empty[st], lane);
      }
      ++c;
    }

    if (!kDq) {
      // warpgroup 1's partial dV and dK through shared memory, thread by
      // thread in the layout both warpgroups' accumulators share, added to
      // warpgroup 0's; the last barrier keeps the next item's partial out
      // until they are read
      float* part = reinterpret_cast<float*>(smem + L::kPartOff) +
                    (tid & 127);
      if (wg == 1) {
#pragma unroll
        for (int i = 0; i < D / 2; ++i) {
          part[i * 128] = acc0[i];
          part[(D / 2 + i) * 128] = acc1[i];
        }
      }
      consumers_sync(128 * WG);
      if (wg == 0) {
#pragma unroll
        for (int i = 0; i < D / 2; ++i) {
          acc0[i] = __fadd_rn(acc0[i], part[i * 128]);
          acc1[i] = __fadd_rn(acc1[i], part[(D / 2 + i) * 128]);
        }
      }
      consumers_sync(128 * WG);
      if (wg == 1) continue;
    }

    // acc[4 j + e]: row ra (e < 2) or ra + 8, column 8 j + 2 t + (e % 2)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = ra + 8 * i;
      if (row >= a.n) continue;
      const long long off =
          ((static_cast<long long>(b) * a.n + row) * a.heads + h) * D + 2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const float x0 = acc0[4 * j + 2 * i], x1 = acc0[4 * j + 2 * i + 1];
        if (kDq) {
          *reinterpret_cast<float2*>(a.dq + off + 8 * j) =
              make_float2(__fmul_rn(x0, a.scale), __fmul_rn(x1, a.scale));
        } else {
          *reinterpret_cast<float2*>(a.dv + off + 8 * j) =
              make_float2(x0, x1);
          *reinterpret_cast<float2*>(a.dk + off + 8 * j) =
              make_float2(__fmul_rn(acc1[4 * j + 2 * i], a.scale),
                          __fmul_rn(acc1[4 * j + 2 * i + 1], a.scale));
        }
      }
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const BwdArgs& a,
           float* scratch, long long in_image, int in_head, int in_row,
           int B, int* launched, cudaStream_t stream) {
  const int bhs = B * a.heads, ns = tf::n_split(a.n);
  float* nat = scratch;
  float* tr = scratch + 2LL * kNatArrays * bhs * ns * D;
  CUtensorMap mn, mt;
  int err = tf::encode_natural<D>(&mn, nat, kNatArrays, bhs, ns);
  if (err == 0) err = tf::encode_transposed<D>(&mt, tr, kTrArrays, bhs, ns);
  static unsigned ready_dkdv = 0, ready_dq = 0;
  constexpr int smem_dkdv = BwdLayout<D, false>::kBytes;
  constexpr int smem_dq = BwdLayout<D, true>::kBytes;
  if (err == 0)
    err = tf::allow_smem(
        reinterpret_cast<const void*>(flash_f32_bwd_wgmma_kernel<D, false>),
        smem_dkdv, &ready_dkdv);
  if (err == 0)
    err = tf::allow_smem(
        reinterpret_cast<const void*>(flash_f32_bwd_wgmma_kernel<D, true>),
        smem_dq, &ready_dq);
  if (err != 0) return err;
  const int rows = bhs * a.n;
  flash_f32_dsum_kernel<D><<<(rows + 7) / 8, 256, 0, stream>>>(a, rows);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  *launched = 1;
  tf::SplitArgs sa{};
  sa.op[0] = {static_cast<const float*>(q), in_image, in_head, in_row, kNatQ,
              kTrQ};
  sa.op[1] = {static_cast<const float*>(k), in_image, in_head, in_row, kNatK,
              kTrK};
  sa.op[2] = {static_cast<const float*>(v), in_image, in_head, in_row, kNatV,
              -1};
  sa.op[3] = {a.dout.p, a.dout.sb, a.dout.sh, a.dout.sn, kNatDo, kTrDo};
  sa.nat = nat;
  sa.tr = tr;
  sa.heads = a.heads;
  sa.n = a.n;
  sa.ns = ns;
  err = tf::launch_split(sa, 4, B, D, stream);
  if (err != 0) return err;
  *launched = 2;
  // persistent CTAs: one an SM, or one an item where there are fewer
  int dev = 0, sms = 0;
  err = static_cast<int>(cudaGetDevice(&dev));
  if (err == 0)
    err = static_cast<int>(
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  if (err != 0) return err;
  auto ctas = [&](int rows) {
    const int items = (a.n + rows - 1) / rows * bhs;
    return items < sms ? items : sms;
  };
  flash_f32_bwd_wgmma_kernel<D, false>
      <<<ctas(tf::kTile), kThreads, smem_dkdv, stream>>>(mn, mt, a);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  *launched = 3;
  flash_f32_bwd_wgmma_kernel<D, true>
      <<<ctas(tf::kTile * kWarpgroups), kThreads, smem_dq, stream>>>(mn, mt,
                                                                      a);
  err = static_cast<int>(cudaGetLastError());
  if (err == 0) *launched = 4;
  return err;
}

}  // namespace

// q, k, v: fp32 (B, H, N, D) views sharing the element strides (image,
// head, row); o and do: fp32 (B, H, N, D) views with strides of their own;
// every row contiguous and 16-byte aligned; lse: fp32 (B, H, N)
// contiguous; dsum: fp32 (B, H, N) scratch; scratch: fp32, 14 B H
// n_split(N) D values (the split halves); dq, dk, dv: fp32 (B, N, H, D)
// contiguous; D 32 or 64.  Four kernels: `launched` gets how many launched.
MVT_EXPORT int mvt_flash_attention_f32_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dsum, void* scratch, void* dq,
    void* dk, void* dv, long long in_image, int in_head, int in_row,
    long long o_image, int o_head, int o_row, long long do_image, int do_head,
    int do_row, int B, int H, int N, int D, int n_valid, float scale,
    int* launched, void* stream) {
  *launched = 0;
  if (B <= 0 || H <= 0 || N <= 0 || n_valid <= 0 || n_valid > N ||
      static_cast<long long>(B) * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a;
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
  a.bhs = B * H;
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
