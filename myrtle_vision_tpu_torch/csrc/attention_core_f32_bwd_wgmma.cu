// attention_core_f32_bwd on Hopper: the per-head part of the TPU attention
// block's backward in a stateless float format or INT8 QAT, fp32
// throughout.
//
// Replaces the loop over heads of `_bwd_one_image` with qspec set
// (myrtle_vision_tpu/ops/fused_attention_block.py).  Inputs: qkv (B, N,
// 3C) fp32 in feature order [3][h][d] (the forward's snapped rows), the
// output-projection gradient d_o = do @ Wp^T (B, N, C) fp32, and the
// forward's rowmax m and reciprocal rowsum rs (B, H, N) fp32
// (attention_core_f32_wgmma.cu with statistics); D = 32 or 64, N <= 256.
// Per head, as the TPU kernel does it, every product the 3-pass
// split-bf16 high3 of attention_f32_tiles.cuh:
//   s   = high3(q, k^T) * scale       e  = exp(s - m)     (the saved m)
//   du  = d_o_h * rs                  dp = high3(du, v^T)
//   r   = rowsum(dp * e)              ds = e * (dp - r * rs)
//   dq  = high3(ds, k) * scale        dk = high3(ds^T, q) * scale
//   dv  = high3(e^T, du)
// The scores come from the forward's own chain (attention_f32_tiles.cuh
// says what is bitwise the same).  Outputs: dqkv (B, N, 3C) fp32 in the
// same [3][h][d] column order, and its column sums per image, (B, 3C)
// fp32 (the caller adds the images for dbqkv).
//
// What bounds it: at ViT-S/16 (B = 256, N = 197, 6 heads of 64) the seven
// products are 3 x 38 GFLOP of bf16 tensor-core work and the qkv rows,
// d_o and dqkv 465 MB; then the elementwise softmax gradient (two exps of
// every score, ds, the splits of e and ds).
//
// Design, after attention_core_bwd_wgmma.cu: one CTA of two warpgroups
// per (image, head), two passes, seven products, each a chain of three
// passes into one accumulator (21 chains).
//   query pass, per 64-query tile: the threads split the tile's q and du
//     rows into shared memory; warpgroup 0 takes keys [0, KA), warpgroup
//     1 keys [KA, N_pad) (KA = N_pad / 2 rounded up to 16), so S and dP
//     of its half stay in registers (KA / 2 fp32 each a thread); each
//     forms e and its partial rowsums of dp * e, which meet in shared
//     memory and are added warpgroup 0 first; ds, split into hi and lo in
//     registers, is the A operand of its half of dQ = high3(ds, K);
//     warpgroup 1 hands its half over in shared memory and warpgroup 0
//     adds, scales and stores.  The pass keeps r * rs of every query.
//   key pass, one 64-key tile a warpgroup at a time: the warpgroup splits
//     its K and V rows into shared memory, walks the queries in chunks of
//     64 (the last N_pad mod 64), recomputes S^T = high3(K, q^T) and dP^T
//     = high3(V, du^T), forms e^T and ds^T in registers from the saved m
//     and r * rs, and runs dV += high3(e^T, du) and dK += high3(ds^T, q)
//     with those registers as the A operand.
// Shared memory.  The split K and V of the head (the query pass's B
// operands) and the split q and du of every query (the key pass's) take
// 4 N_pad D bf16 each, 106,496 bytes at N = 197, D = 64, and together
// would not fit at N = 256: they take turns in one region, K and V for
// the query pass, then q and du for the key pass.  A second region holds
// the query tile's q and du and the dQ hand-over, then each warpgroup's K
// and V tiles (8 x 64 D bf16).  182,784 bytes at N = 197, D = 64, so one
// CTA an SM (`attention_core_f32_plan` in ops/_kernels.py).  Every tile
// that threads write is fenced to the async proxy before a product reads
// it; every register fragment of a chain is formed before the chain is
// issued, and nothing is written until it completes (ptxas would
// otherwise serialise every product, its C7513 note).  Every sum runs in
// a fixed order (the rowsum halves and the dQ halves warpgroup 0 first,
// the column sums lane, warp and image in order), so results are
// bitwise reproducible.  The wrapper counts one launch a call.
// ptxas -v (sm_90a, nvcc 12.9): at D = 64, 151-255 registers a thread
// (239 at N_pad = 208), at D = 32, 113-244, no spills at any size; at
// N_pad <= 64 ptxas inserts a warpgroup.arrive around the register-A
// products (its C7519 note).  On one H100 80GB HBM3 at 700 W
// (PERF.md, chip_smoke.py) a ViT-S/16 block at B = 256 takes 1.14 ms
// against 2.06 for fp32 SDPA's backward: one CTA an SM, and every chain
// waited on before the elementwise work that follows it, so the tensor
// cores idle while the two warpgroups form e and ds.
#include "attention_f32_tiles.cuh"

namespace {

using namespace mvt::f32attn;
namespace sm = mvt::sm90;

constexpr int kThreads = 256;  // two warpgroups

template <int D, int NP>
struct Layout {
  static constexpr int kRow = 2 * D;       // bytes of a split row
  static constexpr int kTile = NP * kRow;  // a whole split buffer
  static constexpr int kSub = 64 * kRow;   // a 64-row split buffer
  // K, V (query pass), then q, du (key pass): hi and lo each
  static constexpr int kRegionA = 4 * kTile;
  // query pass: the tile's q and du (4 kSub), then the dQ hand-over (64 D
  // fp32); key pass: each warpgroup's K and V tiles (4 kSub)
  static constexpr int kRegionB = 8 * kSub;
  // floats: m, rs and r * rs of each query, the rowsum partials, the
  // column sums (8 warps x 3 D)
  static constexpr int kStats = 3 * kMaxN + 128 + 8 * 3 * D;
  static constexpr size_t kBytes = 1024 + kRegionA + kRegionB + 4 * kStats;
  static_assert(4 * kSub + 64 * D * 4 <= kRegionB, "hand-over fits");
};

// a named barrier of both warpgroups, reached from either's code path
__device__ __forceinline__ void both_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// a named barrier of warpgroup wg
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
}

// one 64-query tile's share of the query pass for a warpgroup whose keys
// are [kb, kb + KW): S and dP, e, the rowsum partials (met in shared
// memory with the other warpgroup's), ds as split A fragments, this half
// of dQ into `dq`.  KW = 0 (a warpgroup without keys at N_pad = 16) only
// takes part in the barrier.  kv: the split K and V (hi, lo, hi, lo);
// qu: the tile's split q and du.
template <int D, int NP, int KW>
__device__ __forceinline__ void query_tile(
    const unsigned char* kv, const unsigned char* qu, const float* Ms,
    const float* RSs, float* Rt, float* rpart, int q0, int kb, int N,
    int wg, int w, int g, int t, float scale, float (&dq)[D / 2]) {
  using L = Layout<D, NP>;
  constexpr int kRow = L::kRow, kTile = L::kTile, kSub = L::kSub;
  constexpr int kS = KW > 0 ? KW / 2 : 1;
  const int ra = q0 + 16 * w + g, rb = ra + 8;
  const bool va = ra < N, vb = rb < N;
  float s[kS], p[kS];
#pragma unroll
  for (int i = 0; i < kS; ++i) s[i] = p[i] = 0.f;
  float r0 = 0.f, r1 = 0.f;
  if constexpr (KW > 0) {
    const uint64_t dqh = sm::rows_desc<D>(qu, 0);
    const uint64_t dql = sm::rows_desc<D>(qu + kSub, 0);
    const uint64_t duh = sm::rows_desc<D>(qu + 2 * kSub, 0);
    const uint64_t dul = sm::rows_desc<D>(qu + 3 * kSub, 0);
    const uint64_t dkh = sm::rows_desc<D>(kv, kb);
    const uint64_t dkl = sm::rows_desc<D>(kv + kTile, kb);
    const uint64_t dvh = sm::rows_desc<D>(kv + 2 * kTile, kb);
    const uint64_t dvl = sm::rows_desc<D>(kv + 3 * kTile, kb);
    sm::wgmma_fence();
    chain3<D / 16>([&](int a, int bh, int kk) {
      sm::WgmmaSS<KW>::template mma<0, 0>(
          s, sm::desc_add(a ? dql : dqh, kk * 32),
          sm::desc_add(bh ? dkl : dkh, kk * 32), 1);
    });
    chain3<D / 16>([&](int a, int bh, int kk) {
      sm::WgmmaSS<KW>::template mma<0, 0>(
          p, sm::desc_add(a ? dul : duh, kk * 32),
          sm::desc_add(bh ? dvl : dvh, kk * 32), 1);
    });
    sm::wgmma_commit();
    sm::wgmma_wait<0>();
    sm::fence_regs(s);
    sm::fence_regs(p);

    // s[4 j + e]: row ra (e < 2) or rb, key kb + 8 j + 2 t + (e % 2);
    // past N in either, e and dp are zero
    const float ma = Ms[ra], mb = Ms[rb];
#pragma unroll
    for (int j = 0; j < KW / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        const bool v =
            kb + 8 * j + 2 * t + (e & 1) < N && ((e & 2) ? vb : va);
        s[i] = v ? exp_shift(scaled(s[i], scale), (e & 2) ? mb : ma) : 0.f;
        p[i] = v ? p[i] : 0.f;
        if (e & 2)
          r1 = __fadd_rn(r1, __fmul_rn(p[i], s[i]));
        else
          r0 = __fadd_rn(r0, __fmul_rn(p[i], s[i]));
      }
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      r0 = __fadd_rn(r0, __shfl_xor_sync(0xffffffffu, r0, o));
      r1 = __fadd_rn(r1, __shfl_xor_sync(0xffffffffu, r1, o));
    }
  }
  if (t == 0) {
    rpart[wg * 64 + 16 * w + g] = r0;
    rpart[wg * 64 + 16 * w + g + 8] = r1;
  }
  both_sync();
  // r * rs of the row, warpgroup 0's keys first
  const float rt0 =
      va ? __fmul_rn(__fadd_rn(rpart[16 * w + g], rpart[64 + 16 * w + g]),
                     RSs[ra])
         : 0.f;
  const float rt1 =
      vb ? __fmul_rn(__fadd_rn(rpart[16 * w + g + 8],
                               rpart[64 + 16 * w + g + 8]),
                     RSs[rb])
         : 0.f;
  if (wg == 0 && t == 0) {
    Rt[ra] = rt0;
    Rt[rb] = rt1;
  }
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  if constexpr (KW > 0) {
    // ds split into the A fragments of the 16-key steps of dQ = ds K
    uint32_t ah[KW / 16][4], al[KW / 16][4];
#pragma unroll
    for (int kt = 0; kt < KW / 16; ++kt) {
#pragma unroll
      for (int wd = 0; wd < 4; ++wd) {
        const int i = 8 * kt + 2 * wd;
        const float rt = (wd & 1) ? rt1 : rt0;
        sm::split_bf16x2(__fmul_rn(s[i], __fsub_rn(p[i], rt)),
               __fmul_rn(s[i + 1], __fsub_rn(p[i + 1], rt)), ah[kt][wd],
               al[kt][wd]);
      }
    }
#pragma unroll
    for (int kt = 0; kt < KW / 16; ++kt) {
      sm::fence_regs(ah[kt]);
      sm::fence_regs(al[kt]);
    }
    // K read MN-major (the transpose bit), 16 keys a step
    const uint64_t dkh = sm::rows_desc<D>(kv, kb);
    const uint64_t dkl = sm::rows_desc<D>(kv + kTile, kb);
    sm::wgmma_fence();
    chain3<KW / 16>([&](int a, int bh, int kt) {
      sm::WgmmaRS<D>::template mma<1>(
          dq, a ? al[kt] : ah[kt],
          sm::desc_add(bh ? dkl : dkh, kt * 16 * kRow), 1);
    });
    sm::wgmma_commit();
    sm::wgmma_wait<0>();
    sm::fence_regs(dq);
#pragma unroll
    for (int kt = 0; kt < KW / 16; ++kt) {
      sm::fence_regs(ah[kt]);
      sm::fence_regs(al[kt]);
    }
  }
}

// one chunk of QC queries from query qc for a warpgroup's 64-key tile
// from k0: S^T and dP^T, e^T and ds^T, then dV += high3(e^T, du), dK +=
// high3(ds^T, q).  kv: the warpgroup's split K and V tiles; qu: the split
// q and du of every query.
template <int D, int NP, int QC>
__device__ __forceinline__ void key_chunk(
    const unsigned char* kv, const unsigned char* qu, const float* Ms,
    const float* Rt, int k0, int qc, int N, int w, int g, int t,
    float scale, float (&dk)[D / 2], float (&dv)[D / 2]) {
  using L = Layout<D, NP>;
  constexpr int kRow = L::kRow, kTile = L::kTile, kSub = L::kSub;
  float s[QC / 2], p[QC / 2];
#pragma unroll
  for (int i = 0; i < QC / 2; ++i) s[i] = p[i] = 0.f;
  const uint64_t dkh = sm::rows_desc<D>(kv, 0);
  const uint64_t dkl = sm::rows_desc<D>(kv + kSub, 0);
  const uint64_t dvh = sm::rows_desc<D>(kv + 2 * kSub, 0);
  const uint64_t dvl = sm::rows_desc<D>(kv + 3 * kSub, 0);
  const uint64_t dqh = sm::rows_desc<D>(qu, qc);
  const uint64_t dql = sm::rows_desc<D>(qu + kTile, qc);
  const uint64_t duh = sm::rows_desc<D>(qu + 2 * kTile, qc);
  const uint64_t dul = sm::rows_desc<D>(qu + 3 * kTile, qc);
  sm::wgmma_fence();
  // S^T = K q^T and dP^T = V du^T: the forward's chain with the A and B
  // roles swapped (a: the half of q or du, bh: that of K or V)
  chain3<D / 16>([&](int a, int bh, int kk) {
    sm::WgmmaSS<QC>::template mma<0, 0>(
        s, sm::desc_add(bh ? dkl : dkh, kk * 32),
        sm::desc_add(a ? dql : dqh, kk * 32), 1);
  });
  chain3<D / 16>([&](int a, int bh, int kk) {
    sm::WgmmaSS<QC>::template mma<0, 0>(
        p, sm::desc_add(bh ? dvl : dvh, kk * 32),
        sm::desc_add(a ? dul : duh, kk * 32), 1);
  });
  sm::wgmma_commit();
  sm::wgmma_wait<0>();
  sm::fence_regs(s);
  sm::fence_regs(p);

  // s[4 j + e]: key ka (e < 2) or ka + 8, query qc + 8 j + 2 t + (e % 2)
  const int ka = k0 + 16 * w + g;
  const bool va = ka < N, vb = ka + 8 < N;
  uint32_t eh[QC / 16][4], el[QC / 16][4], dh[QC / 16][4], dl[QC / 16][4];
#pragma unroll
  for (int kt = 0; kt < QC / 16; ++kt) {
    float ev[8], ds[8];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int q = qc + 16 * kt + 8 * half + 2 * t;
      const float2 mq = *reinterpret_cast<const float2*>(Ms + q);
      const float2 rq = *reinterpret_cast<const float2*>(Rt + q);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 8 * kt + 4 * half + e;
        const bool v = q + (e & 1) < N && ((e & 2) ? vb : va);
        const float x =
            v ? exp_shift(scaled(s[i], scale), (e & 1) ? mq.y : mq.x) : 0.f;
        ev[4 * half + e] = x;
        ds[4 * half + e] =
            v ? __fmul_rn(x, __fsub_rn(p[i], (e & 1) ? rq.y : rq.x)) : 0.f;
      }
    }
#pragma unroll
    for (int wd = 0; wd < 4; ++wd) {
      sm::split_bf16x2(ev[2 * wd], ev[2 * wd + 1], eh[kt][wd], el[kt][wd]);
      sm::split_bf16x2(ds[2 * wd], ds[2 * wd + 1], dh[kt][wd], dl[kt][wd]);
    }
  }
#pragma unroll
  for (int kt = 0; kt < QC / 16; ++kt) {
    sm::fence_regs(eh[kt]);
    sm::fence_regs(el[kt]);
    sm::fence_regs(dh[kt]);
    sm::fence_regs(dl[kt]);
  }
  sm::wgmma_fence();
  // du and q read MN-major (the transpose bit), 16 queries a step
  chain3<QC / 16>([&](int a, int bh, int kt) {
    sm::WgmmaRS<D>::template mma<1>(
        dv, a ? el[kt] : eh[kt],
        sm::desc_add(bh ? dul : duh, kt * 16 * kRow), 1);
  });
  chain3<QC / 16>([&](int a, int bh, int kt) {
    sm::WgmmaRS<D>::template mma<1>(
        dk, a ? dl[kt] : dh[kt],
        sm::desc_add(bh ? dql : dqh, kt * 16 * kRow), 1);
  });
  sm::wgmma_commit();
  sm::wgmma_wait<0>();
  sm::fence_regs(dk);
  sm::fence_regs(dv);
#pragma unroll
  for (int kt = 0; kt < QC / 16; ++kt) {
    sm::fence_regs(eh[kt]);
    sm::fence_regs(el[kt]);
    sm::fence_regs(dh[kt]);
    sm::fence_regs(dl[kt]);
  }
}

template <int D, int NP>
__global__ void __launch_bounds__(kThreads, 1)
attention_core_f32_bwd_wgmma_kernel(const float* __restrict__ qkv,
                                    const float* __restrict__ d_o,
                                    const float* __restrict__ m_in,
                                    const float* __restrict__ rs_in,
                                    float* __restrict__ dqkv,
                                    float* __restrict__ dbias, int N,
                                    int heads, float scale) {
  using L = Layout<D, NP>;
  constexpr int kTile = L::kTile, kSub = L::kSub;
  constexpr int KA = (NP / 16 + 1) / 2 * 16;  // warpgroup 0's keys
  constexpr int KB = NP - KA;                 // warpgroup 1's
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (sm::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ra_buf = smem;                  // region A
  unsigned char* rb_buf = smem + L::kRegionA;    // region B
  float* exch = reinterpret_cast<float*>(rb_buf + 4 * kSub);
  float* Ms = reinterpret_cast<float*>(rb_buf + L::kRegionB);
  float* RSs = Ms + kMaxN;
  float* Rt = RSs + kMaxN;
  float* rpart = Rt + kMaxN;  // the two warpgroups' rowsum partials
  float* colbuf = rpart + 128;

  const int tid = threadIdx.x;
  const int wg = tid >> 7, wtid = tid & 127;
  const int warp = tid >> 5, w = warp & 3;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const int C = heads * D;
  const size_t row_stride = static_cast<size_t>(3) * C;
  const size_t stat0 = static_cast<size_t>(blockIdx.x) * N;
  const float* q_base = qkv + static_cast<size_t>(b) * N * row_stride + h * D;
  const float* do_base = d_o + static_cast<size_t>(b) * N * C + h * D;
  const float* rs_row = rs_in + stat0;
  float* out = dqkv + static_cast<size_t>(b) * N * row_stride;

  for (int r = tid; r < kMaxN; r += kThreads) {
    Ms[r] = r < N ? m_in[stat0 + r] : 0.f;
    RSs[r] = r < N ? rs_row[r] : 0.f;
  }
  // K and V of the head, zero rows from N to N_pad
  split_rows<D>(ra_buf, ra_buf + kTile, q_base + C, row_stride, 0, NP, N,
                nullptr, tid, kThreads);
  split_rows<D>(ra_buf + 2 * kTile, ra_buf + 3 * kTile, q_base + 2 * C,
                row_stride, 0, NP, N, nullptr, tid, kThreads);

  // ---- query pass: r, r * rs and dQ ----
  float colq[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) colq[i] = 0.f;
  for (int q0 = 0; q0 < N; q0 += 64) {
    // the tile's q and du rows, zero past N
    split_rows<D>(rb_buf, rb_buf + kSub, q_base, row_stride, q0, 64, N,
                  nullptr, tid, kThreads);
    split_rows<D>(rb_buf + 2 * kSub, rb_buf + 3 * kSub, do_base, C, q0, 64,
                  N, rs_row, tid, kThreads);
    sm::fence_proxy_async();
    both_sync();
    float dq[D / 2];
    if (wg == 0)
      query_tile<D, NP, KA>(ra_buf, rb_buf, Ms, RSs, Rt, rpart, q0, 0, N,
                            wg, w, g, t, scale, dq);
    else
      query_tile<D, NP, KB>(ra_buf, rb_buf, Ms, RSs, Rt, rpart, q0, KA, N,
                            wg, w, g, t, scale, dq);
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) exch[i * 128 + wtid] = dq[i];
    }
    both_sync();
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i)
        dq[i] = __fadd_rn(dq[i], exch[i * 128 + wtid]);
      const int ra = q0 + 16 * w + g;
      store_rows<D>(dq, scale,
                    out + static_cast<size_t>(ra) * row_stride + h * D,
                    ra < N, ra + 8 < N, row_stride, t, colq);
    }
  }
  if (wg == 0) sm::warp_colsums<D>(colq, colbuf, warp, 0, g, t);
  // every read of region A and of the hand-over is done
  __syncthreads();

  // ---- key pass: dK and dV, one 64-key tile a warpgroup ----
  // q and du of every query, zero rows from N to N_pad
  split_rows<D>(ra_buf, ra_buf + kTile, q_base, row_stride, 0, NP, N,
                nullptr, tid, kThreads);
  split_rows<D>(ra_buf + 2 * kTile, ra_buf + 3 * kTile, do_base, C, 0, NP,
                N, rs_row, tid, kThreads);
  sm::fence_proxy_async();
  __syncthreads();
  unsigned char* kv = rb_buf + wg * 4 * kSub;  // this warpgroup's tiles
  float colk[D / 4], colv[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) colk[i] = colv[i] = 0.f;
  for (int k0 = 64 * wg; k0 < N; k0 += 128) {
    // the previous tile's products are done with the warpgroup's tiles
    wg_sync(wg);
    split_rows<D>(kv, kv + kSub, q_base + C, row_stride, k0, 64, N, nullptr,
                  wtid, 128);
    split_rows<D>(kv + 2 * kSub, kv + 3 * kSub, q_base + 2 * C, row_stride,
                  k0, 64, N, nullptr, wtid, 128);
    sm::fence_proxy_async();
    wg_sync(wg);
    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    for (int qc = 0; qc + 64 <= NP; qc += 64)
      key_chunk<D, NP, 64>(kv, ra_buf, Ms, Rt, k0, qc, N, w, g, t, scale, dk,
                           dv);
    if constexpr (NP % 64 != 0)
      key_chunk<D, NP, NP % 64>(kv, ra_buf, Ms, Rt, k0, NP - NP % 64, N, w,
                                g, t, scale, dk, dv);
    const int ka = k0 + 16 * w + g;
    float* row = out + static_cast<size_t>(ka) * row_stride;
    store_rows<D>(dk, scale, row + C + h * D, ka < N, ka + 8 < N,
                  row_stride, t, colk);
    store_rows<D>(dv, 1.0f, row + 2 * C + h * D, ka < N, ka + 8 < N,
                  row_stride, t, colv);
  }
  sm::warp_colsums<D>(colk, colbuf, warp, 1, g, t);
  sm::warp_colsums<D>(colv, colbuf, warp, 2, g, t);
  __syncthreads();
  // the image's column sums: the warps in order (dQ: warpgroup 0's four)
  for (int c = tid; c < 3 * D; c += kThreads) {
    const int sec = c / D, d = c % D;
    float v = 0.f;
    for (int wi = 0; wi < (sec == 0 ? 4 : 8); ++wi)
      v = __fadd_rn(v, colbuf[(wi * 3 + sec) * D + d]);
    dbias[static_cast<size_t>(b) * row_stride + sec * C + h * D + d] = v;
  }
}

template <int D, int NP>
cudaError_t prepare() {
  auto* kernel = attention_core_f32_bwd_wgmma_kernel<D, NP>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Layout<D, NP>::kBytes));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  return e;
}

template <int D, int NP>
int launch(const void* qkv, const void* d_o, const void* m, const void* rs,
           void* dqkv, void* dbias, int B, int N, int heads, float scale,
           cudaStream_t stream) {
  cudaError_t e = prepare<D, NP>();
  if (e != cudaSuccess) return static_cast<int>(e);
  attention_core_f32_bwd_wgmma_kernel<D, NP>
      <<<B * heads, kThreads, Layout<D, NP>::kBytes, stream>>>(
          static_cast<const float*>(qkv), static_cast<const float*>(d_o),
          static_cast<const float*>(m), static_cast<const float*>(rs),
          static_cast<float*>(dqkv), static_cast<float*>(dbias), N, heads,
          scale);
  return static_cast<int>(cudaGetLastError());
}

// the launch figures of (D, NP): warpgroups, KA, launches, dynamic shared
// memory bytes, CTAs an SM (the runtime's occupancy)
template <int D, int NP>
int figures(int* f) {
  cudaError_t e = prepare<D, NP>();
  int ctas = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &ctas, attention_core_f32_bwd_wgmma_kernel<D, NP>, kThreads,
        Layout<D, NP>::kBytes);
  f[0] = kThreads / 128;
  f[1] = (NP / 16 + 1) / 2 * 16;
  f[2] = 1;
  f[3] = static_cast<int>(Layout<D, NP>::kBytes);
  f[4] = ctas;
  return static_cast<int>(e);
}

#define MVT_F32_NP(F) \
  F(16) F(32) F(48) F(64) F(80) F(96) F(112) F(128) F(144) F(160) F(176) \
  F(192) F(208) F(224) F(240) F(256)

template <int D>
int launch_n(const void* qkv, const void* d_o, const void* m, const void* rs,
             void* dqkv, void* dbias, int B, int N, int heads, float scale,
             cudaStream_t s) {
#define MVT_CASE(np)                                                       \
  case np:                                                                 \
    return launch<D, np>(qkv, d_o, m, rs, dqkv, dbias, B, N, heads, scale, \
                         s);
  switch ((N + 15) / 16 * 16) {
    MVT_F32_NP(MVT_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MVT_CASE
}

template <int D>
int figures_n(int N, int* f) {
#define MVT_CASE(np) \
  case np:           \
    return figures<D, np>(f);
  switch ((N + 15) / 16 * 16) {
    MVT_F32_NP(MVT_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MVT_CASE
}

}  // namespace

MVT_EXPORT int mvt_attention_core_f32_bwd_max_n() { return kMaxN; }

// qkv (B, N, 3C), d_o (B, N, C), m and rs (B, heads, N) fp32 -> dqkv (B, N,
// 3C) fp32 and dbias (B, 3C) fp32, the column sums of each image's dqkv;
// D = C / heads of 32 or 64, N <= mvt_attention_core_f32_bwd_max_n(); qkv
// and d_o 16-byte aligned (16-byte loads)
MVT_EXPORT int mvt_attention_core_f32_bwd(const void* qkv, const void* d_o,
                                          const void* m, const void* rs,
                                          void* dqkv, void* dbias, int B,
                                          int N, int heads, int D,
                                          float scale, void* stream) {
  if (B <= 0 || heads <= 0 || N <= 0 || N > kMaxN ||
      reinterpret_cast<uintptr_t>(qkv) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(d_o) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_n<64>(qkv, d_o, m, rs, dqkv, dbias, B, N, heads, scale, s);
  if (D == 32)
    return launch_n<32>(qkv, d_o, m, rs, dqkv, dbias, B, N, heads, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// the launch figures of N tokens at head width D into f[0..4]
// (`figures`); returns a cudaError_t value
MVT_EXPORT int mvt_attention_core_f32_bwd_launch(int N, int D, int* f) {
  if (N <= 0 || N > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  if (D == 64) return figures_n<64>(N, f);
  if (D == 32) return figures_n<32>(N, f);
  return static_cast<int>(cudaErrorInvalidValue);
}
