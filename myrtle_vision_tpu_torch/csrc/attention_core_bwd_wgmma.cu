// attention_core_bwd on Hopper: the per-head part of the TPU attention
// block's backward up to 256 tokens.
//
// Replaces the loop over heads of `_bwd_one_image` in
// myrtle_vision_tpu/ops/fused_attention_block.py (`_bwd_rule` ->
// `_bwd_kernel`).  Inputs: qkv (B, N, 3C) bf16 in feature order [3][h][d],
// the output-projection gradient d_o = do @ Wp^T (B, N, C) fp32, and the
// forward's saved rowmax m and reciprocal rowsum rs (B, H, N) fp32.  Per
// head, as the TPU kernel does it:
//   qs  = bf16(q * scale)            du = bf16(d_o_h * rs)
//   s   = qs . k^T      (fp32)       e  = exp(s - m)   (the saved m)
//   dp  = du . v^T      (fp32)       r  = rowsum(dp * e)
//   ds  = e * (dp - r * rs)          dsb = bf16(ds),  eb = bf16(e)
//   dq  = (dsb . k) * scale          dk = dsb^T . qs    dv = eb^T . du
// Outputs: dqkv (B, N, 3C) bf16, the fp32 values rounded once, in the
// same [3][h][d] column order; and their column sums per image, (B, 3C)
// fp32, over the unrounded values (the caller adds the images for
// dbqkv).  r is summed over the fp32 dp * e, as the TPU kernel does; the
// rowsum(dO o O) shortcut would round elsewhere.
//
// What bounds it: at ViT-S/16 (B = 256, N = 197, 6 heads of 64) the five
// products are 38 GFLOP (0.039 ms of bf16 tensor-core time) and the qkv
// rows, d_o and dqkv 310 MB (0.093 ms at 3.35 TB/s): bytes.  The WMMA
// kernel this replaces took 1.60 ms: one 8-warp block per (image, head)
// that sent every 16 x 16 score tile through shared memory as fp32 and
// recomputed s and dp in three passes, nine products in all.
//
// Design.  One CTA of two warpgroups per (image, head).  K and V of the
// head come in by TMA through the forward's 3-D tensor map over (B, N,
// 3C), a (1, N_pad, D) box each (N_pad = N rounded up to 16; rows past N
// read as zero), rows one swizzle row wide.  The threads write qs and du
// (d_o read 16 bytes a thread) into the same swizzled layout.  Then:
//   query pass, per 64-query tile: warpgroup 0 takes keys [0, KA),
//     warpgroup 1 keys [KA, N_pad) (KA = N_pad / 2 rounded up to 16), so
//     S and dP of the tile's half stay in registers (KA / 2 fp32 each a
//     thread).  Each forms e and its partial rowsum of dp * e; the two
//     partials meet in shared memory and are added warpgroup 0 first;
//     then ds, rounded to bf16 in registers, is the A operand of its half
//     of dQ = dsb . K (the S accumulator layout is the register A
//     fragment of the next product).  Warpgroup 1 hands its dQ half over
//     in shared memory and warpgroup 0 adds it, scales, rounds and stores.
//     The pass also keeps r * rs of every query for the key pass.
//   key pass, one 64-key tile a warpgroup at a time: it walks the
//     queries in chunks of 64 (the last N_pad mod 64), recomputes S^T =
//     K qs^T and dP^T = V du^T, forms e^T and ds^T in registers from the
//     saved m and r * rs, and runs dV += eb^T du and dK += dsb^T qs with
//     those registers as the A operand (du and qs read MN-major through
//     the transpose bit).
// Seven products: S, dP, dQ, S^T, dP^T, dV, dK, all wgmma from shared
// memory.  The query pass's A operand reads 64-row tiles of qs and du,
// up to 48 rows past N_pad: those rows land in the next buffer, and every
// element of a row or column past N is forced to zero by a select before
// it reaches a sum or a product.  Every sum runs in a fixed order (the
// dQ halves warpgroup 0 first, the column sums lane, warp and image in
// order), so results are bitwise reproducible.  Shared memory: 4 N_pad D
// bf16, 64 D fp32 for the dQ hand-over and 3.5 KB of per-query values
// (127,496 bytes at N = 197, D = 64; 152,072 at 256), so one CTA an SM.
// ptxas -v (sm_90a, nvcc 12.9): 224 registers a thread at N_pad = 208,
// 202 at 256, 80-220 at the other sizes, no spills at any; at N_pad <= 64
// it inserts a warpgroup.arrive around the register-A products (C7519).
// On one H100 at 700 W it takes 0.48 ms at B = 256, N = 197 against
// SDPA's backward at 0.58 (PERF.md): one CTA an SM and every product
// waited on, so the tensor cores sit idle while the softmax gradient's
// elementwise work runs, which the two warpgroups overlap only with each
// other.
#include "common.cuh"
#include "sm90.cuh"

namespace {

using mvt::bf16;
namespace sm = mvt::sm90;

constexpr int kMaxN = 256;
constexpr int kThreads = 256;  // two warpgroups

template <int D, int NP>
struct Layout {
  static constexpr int kRow = 2 * D;       // bytes of a K, V, qs, du row
  static constexpr int kTile = NP * kRow;  // one of the four buffers
  // warpgroup 1's dQ half, fp32, one slot a thread; at the end the
  // column sums' buffer (8 warps x 3 D); it also takes the query pass's
  // reads past du's last row (at most 48 rows)
  static constexpr int kExch = 64 * D * 4;
  static constexpr int kStats = 3 * kMaxN + 2 * 64;  // floats
  static constexpr size_t kBytes =
      1024 + 4 * static_cast<size_t>(kTile) + kExch + 4 * kStats + 8;
  static_assert(48 * kRow <= kExch, "reads past du leave the buffers");
  static_assert(8 * 3 * D <= 64 * D, "column sums fit the hand-over");
};

// byte offset of a 16-byte chunk in a tile swizzled as TMA writes it
// (128- or 64-byte rows, the tile 1024-byte aligned)
template <int kRow>
__device__ __forceinline__ uint32_t swizzle(uint32_t off) {
  return off ^ (((off >> 7) & (kRow == 128 ? 7 : 3)) << 4);
}

// a named barrier of both warpgroups, reached from either's code path
__device__ __forceinline__ void both_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// K-major descriptor of the rows of a swizzled buffer from row `row`; the
// same bits read MN-major through the transpose bit
template <int D>
__device__ __forceinline__ uint64_t rows_desc(const unsigned char* buf,
                                              int row) {
  constexpr int kRow = 2 * D;
  return sm::make_desc(buf + row * kRow, 16, 8 * kRow, kRow);
}

// one 64-query tile's share of the query pass for a warpgroup whose keys
// are [kb, kb + KW): S and dP, e, the rowsum partials (met in shared
// memory with the other warpgroup's), ds as A fragments, this half of
// dQ into `dq`.  KW = 0 (a warpgroup without keys at N_pad = 16) only
// takes part in the barrier.
template <int D, int KW>
__device__ __forceinline__ void query_tile(
    const unsigned char* Ks, const unsigned char* Vs, const unsigned char* Qs,
    const unsigned char* Us, const float* Ms, const float* RSs, float* Rt,
    float* rpart, int q0, int kb, int N, int wg, int w, int g, int t,
    float (&dq)[D / 2]) {
  constexpr int kRow = 2 * D;
  constexpr int kS = KW > 0 ? KW / 2 : 1;
  const int ra = q0 + 16 * w + g, rb = ra + 8;
  const bool va = ra < N, vb = rb < N;
  float s[kS], p[kS];
#pragma unroll
  for (int i = 0; i < kS; ++i) s[i] = p[i] = 0.f;
  float r0 = 0.f, r1 = 0.f;
  if constexpr (KW > 0) {
    const uint64_t da = rows_desc<D>(Qs, q0), du = rows_desc<D>(Us, q0);
    const uint64_t dk = rows_desc<D>(Ks, kb), dv = rows_desc<D>(Vs, kb);
    sm::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sm::WgmmaSS<KW>::template mma<0, 0>(s, sm::desc_add(da, kk * 32),
                                          sm::desc_add(dk, kk * 32), 1);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sm::WgmmaSS<KW>::template mma<0, 0>(p, sm::desc_add(du, kk * 32),
                                          sm::desc_add(dv, kk * 32), 1);
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
        s[i] = v ? expf(s[i] - ((e & 2) ? mb : ma)) : 0.f;
        p[i] = v ? p[i] : 0.f;
        if (e & 2)
          r1 += p[i] * s[i];
        else
          r0 += p[i] * s[i];
      }
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      r0 += __shfl_xor_sync(0xffffffffu, r0, o);
      r1 += __shfl_xor_sync(0xffffffffu, r1, o);
    }
  }
  if (t == 0) {
    rpart[wg * 64 + 16 * w + g] = r0;
    rpart[wg * 64 + 16 * w + g + 8] = r1;
  }
  both_sync();
  // r of the row, warpgroup 0's keys first, times its rs
  const float rt0 =
      va ? (rpart[16 * w + g] + rpart[64 + 16 * w + g]) * RSs[ra] : 0.f;
  const float rt1 =
      vb ? (rpart[16 * w + g + 8] + rpart[64 + 16 * w + g + 8]) * RSs[rb]
         : 0.f;
  if (wg == 0 && t == 0) {
    Rt[ra] = rt0;
    Rt[rb] = rt1;
  }
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  if constexpr (KW > 0) {
    // dsb as the A fragments of the 16-key steps of dQ = dsb K
    uint32_t a[KW / 16][4];
#pragma unroll
    for (int kt = 0; kt < KW / 16; ++kt) {
      float ds[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        ds[i] = s[8 * kt + i] * (p[8 * kt + i] - ((i & 2) ? rt1 : rt0));
      a[kt][0] = sm::pack_bf16(ds[0], ds[1]);
      a[kt][1] = sm::pack_bf16(ds[2], ds[3]);
      a[kt][2] = sm::pack_bf16(ds[4], ds[5]);
      a[kt][3] = sm::pack_bf16(ds[6], ds[7]);
    }
    const uint64_t dk = rows_desc<D>(Ks, kb);
    sm::wgmma_fence();
#pragma unroll
    for (int kt = 0; kt < KW / 16; ++kt)
      sm::WgmmaRS<D>::template mma<1>(dq, a[kt],
                                      sm::desc_add(dk, kt * 16 * kRow), 1);
    sm::wgmma_commit();
    sm::wgmma_wait<0>();
    sm::fence_regs(dq);
#pragma unroll
    for (int kt = 0; kt < KW / 16; ++kt) sm::fence_regs(a[kt]);
  }
}

// one chunk of QC queries from query qc for a warpgroup's 64-key tile
// from k0: S^T and dP^T, e^T and ds^T, then dV += eb^T du, dK += dsb^T qs
template <int D, int QC>
__device__ __forceinline__ void key_chunk(
    const unsigned char* Ks, const unsigned char* Vs, const unsigned char* Qs,
    const unsigned char* Us, const float* Ms, const float* Rt, int k0,
    int qc, int N, int w, int g, int t, float (&dk)[D / 2],
    float (&dv)[D / 2]) {
  constexpr int kRow = 2 * D;
  float s[QC / 2], p[QC / 2];
#pragma unroll
  for (int i = 0; i < QC / 2; ++i) s[i] = p[i] = 0.f;
  const uint64_t dka = rows_desc<D>(Ks, k0), dva = rows_desc<D>(Vs, k0);
  const uint64_t dq = rows_desc<D>(Qs, qc), du = rows_desc<D>(Us, qc);
  sm::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    sm::WgmmaSS<QC>::template mma<0, 0>(s, sm::desc_add(dka, kk * 32),
                                        sm::desc_add(dq, kk * 32), 1);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    sm::WgmmaSS<QC>::template mma<0, 0>(p, sm::desc_add(dva, kk * 32),
                                        sm::desc_add(du, kk * 32), 1);
  sm::wgmma_commit();
  sm::wgmma_wait<0>();
  sm::fence_regs(s);
  sm::fence_regs(p);

  // s[4 j + e]: key ka (e < 2) or ka + 8, query qc + 8 j + 2 t + (e % 2)
  const int ka = k0 + 16 * w + g;
  const bool va = ka < N, vb = ka + 8 < N;
  uint32_t ea[QC / 16][4], da[QC / 16][4];
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
        const float x = v ? expf(s[i] - ((e & 1) ? mq.y : mq.x)) : 0.f;
        ev[4 * half + e] = x;
        ds[4 * half + e] = v ? x * (p[i] - ((e & 1) ? rq.y : rq.x)) : 0.f;
      }
    }
    ea[kt][0] = sm::pack_bf16(ev[0], ev[1]);
    ea[kt][1] = sm::pack_bf16(ev[2], ev[3]);
    ea[kt][2] = sm::pack_bf16(ev[4], ev[5]);
    ea[kt][3] = sm::pack_bf16(ev[6], ev[7]);
    da[kt][0] = sm::pack_bf16(ds[0], ds[1]);
    da[kt][1] = sm::pack_bf16(ds[2], ds[3]);
    da[kt][2] = sm::pack_bf16(ds[4], ds[5]);
    da[kt][3] = sm::pack_bf16(ds[6], ds[7]);
  }
  sm::wgmma_fence();
#pragma unroll
  for (int kt = 0; kt < QC / 16; ++kt) {
    sm::WgmmaRS<D>::template mma<1>(dv, ea[kt],
                                    sm::desc_add(du, kt * 16 * kRow), 1);
    sm::WgmmaRS<D>::template mma<1>(dk, da[kt],
                                    sm::desc_add(dq, kt * 16 * kRow), 1);
  }
  sm::wgmma_commit();
  sm::wgmma_wait<0>();
  sm::fence_regs(dk);
  sm::fence_regs(dv);
#pragma unroll
  for (int kt = 0; kt < QC / 16; ++kt) {
    sm::fence_regs(ea[kt]);
    sm::fence_regs(da[kt]);
  }
}

// stores a 64-row accumulator tile (times `mul`) as bf16 pairs into
// columns [col0, col0 + D) of rows ra, ra + 8 (those below N) and adds
// the stored fp32 values to the thread's column sums col[2 j + e]
// (column 8 j + 2 t + e)
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2],
                                           float mul, bf16* out_a, bool va,
                                           bool vb, size_t row_stride, int t,
                                           float (&col)[D / 4]) {
  bf16* out_b = out_a + 8 * row_stride;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int d = 8 * j + 2 * t;
    const float a0 = acc[4 * j] * mul, a1 = acc[4 * j + 1] * mul;
    const float b0 = acc[4 * j + 2] * mul, b1 = acc[4 * j + 3] * mul;
    if (va) {
      *reinterpret_cast<__nv_bfloat162*>(out_a + d) =
          __floats2bfloat162_rn(a0, a1);
      col[2 * j] += a0;
      col[2 * j + 1] += a1;
    }
    if (vb) {
      *reinterpret_cast<__nv_bfloat162*>(out_b + d) =
          __floats2bfloat162_rn(b0, b1);
      col[2 * j] += b0;
      col[2 * j + 1] += b1;
    }
  }
}

// a warp's column sums (the lanes of one t hold one column pair) into
// row `warp` of section `sec` of the column buffer
template <int D>
__device__ __forceinline__ void warp_colsums(const float (&col)[D / 4],
                                             float* colbuf, int warp,
                                             int sec, int g, int t) {
#pragma unroll
  for (int i = 0; i < D / 4; ++i) {
    float v = col[i];
    v += __shfl_xor_sync(0xffffffffu, v, 4);
    v += __shfl_xor_sync(0xffffffffu, v, 8);
    v += __shfl_xor_sync(0xffffffffu, v, 16);
    const int col_i = 8 * (i / 2) + 2 * t + (i & 1);
    if (g == 0) colbuf[(warp * 3 + sec) * D + col_i] = v;
  }
}

template <int D, int NP>
__global__ void __launch_bounds__(kThreads, 1)
attention_core_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_qkv,
                                const bf16* __restrict__ qkv,
                                const float* __restrict__ d_o,
                                const float* __restrict__ m_in,
                                const float* __restrict__ rs_in,
                                bf16* __restrict__ dqkv,
                                float* __restrict__ dbias, int N, int heads,
                                float scale) {
  using L = Layout<D, NP>;
  constexpr int kRow = L::kRow;
  constexpr int KA = (NP / 16 + 1) / 2 * 16;  // warpgroup 0's keys
  constexpr int KB = NP - KA;                 // warpgroup 1's
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (sm::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* Ks = smem;
  unsigned char* Vs = Ks + L::kTile;
  unsigned char* Qs = Vs + L::kTile;
  unsigned char* Us = Qs + L::kTile;
  float* exch = reinterpret_cast<float*>(Us + L::kTile);
  float* Ms = exch + 64 * D;  // kMaxN each: m, rs, r * rs of each query
  float* RSs = Ms + kMaxN;
  float* Rt = RSs + kMaxN;
  float* rpart = Rt + kMaxN;  // the two warpgroups' rowsum partials
  uint64_t* bar = reinterpret_cast<uint64_t*>(rpart + 128);

  const int tid = threadIdx.x;
  const int wg = tid >> 7, wtid = tid & 127;
  const int warp = tid >> 5, w = warp & 3;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const int C = heads * D;
  const size_t row_stride = static_cast<size_t>(3) * C;
  const size_t stat0 = static_cast<size_t>(blockIdx.x) * N;

  if (tid == 0) {
    sm::mbar_init(bar, 1);
    sm::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    sm::mbar_expect_tx(bar, 2 * L::kTile);
    sm::tma_load_3d(Ks, &map_qkv, bar, C + h * D, 0, b);
    sm::tma_load_3d(Vs, &map_qkv, bar, 2 * C + h * D, 0, b);
  }
  // qs = bf16(q scale) and du = bf16(d_o rs), 8 columns a thread, zero
  // rows from N to N_pad
  {
    const bf16* q_base = qkv + static_cast<size_t>(b) * N * row_stride + h * D;
    const float* do_base = d_o + static_cast<size_t>(b) * N * C + h * D;
    for (int i = tid; i < NP * (D / 8); i += kThreads) {
      const int r = i / (D / 8), c = i % (D / 8);
      uint4 qv = make_uint4(0u, 0u, 0u, 0u), uv = qv;
      if (r < N) {
        const uint4 raw = *reinterpret_cast<const uint4*>(
            q_base + static_cast<size_t>(r) * row_stride + 8 * c);
        const __nv_bfloat162* qe =
            reinterpret_cast<const __nv_bfloat162*>(&raw);
        const float* dr = do_base + static_cast<size_t>(r) * C + 8 * c;
        const float4 d0 = *reinterpret_cast<const float4*>(dr);
        const float4 d1 = *reinterpret_cast<const float4*>(dr + 4);
        const float rsv = rs_in[stat0 + r];
        float2 f;
        f = __bfloat1622float2(qe[0]);
        qv.x = sm::pack_bf16(f.x * scale, f.y * scale);
        f = __bfloat1622float2(qe[1]);
        qv.y = sm::pack_bf16(f.x * scale, f.y * scale);
        f = __bfloat1622float2(qe[2]);
        qv.z = sm::pack_bf16(f.x * scale, f.y * scale);
        f = __bfloat1622float2(qe[3]);
        qv.w = sm::pack_bf16(f.x * scale, f.y * scale);
        uv.x = sm::pack_bf16(d0.x * rsv, d0.y * rsv);
        uv.y = sm::pack_bf16(d0.z * rsv, d0.w * rsv);
        uv.z = sm::pack_bf16(d1.x * rsv, d1.y * rsv);
        uv.w = sm::pack_bf16(d1.z * rsv, d1.w * rsv);
      }
      const uint32_t off = swizzle<kRow>(r * kRow + 16 * c);
      *reinterpret_cast<uint4*>(Qs + off) = qv;
      *reinterpret_cast<uint4*>(Us + off) = uv;
    }
    for (int r = tid; r < kMaxN; r += kThreads) {
      Ms[r] = r < N ? m_in[stat0 + r] : 0.f;
      RSs[r] = r < N ? rs_in[stat0 + r] : 0.f;
    }
  }
  // the generic-proxy writes of qs and du, before wgmma reads them
  sm::fence_proxy_async();
  __syncthreads();
  sm::mbar_wait(bar, 0);

  // ---- query pass: r, r * rs and dQ ----
  float colq[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) colq[i] = 0.f;
  for (int q0 = 0; q0 < N; q0 += 64) {
    float dq[D / 2];
    if (wg == 0)
      query_tile<D, KA>(Ks, Vs, Qs, Us, Ms, RSs, Rt, rpart, q0, 0, N, wg, w,
                        g, t, dq);
    else
      query_tile<D, KB>(Ks, Vs, Qs, Us, Ms, RSs, Rt, rpart, q0, KA, N, wg,
                        w, g, t, dq);
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) exch[i * 128 + wtid] = dq[i];
    }
    both_sync();
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dq[i] += exch[i * 128 + wtid];
      const int ra = q0 + 16 * w + g;
      store_rows<D>(dq, scale,
                    dqkv + (static_cast<size_t>(b) * N + ra) * row_stride +
                        h * D,
                    ra < N, ra + 8 < N, row_stride, t, colq);
    }
  }
  // warpgroup 0's dQ column sums into the hand-over buffer, once all its
  // warps have read their last dQ halves there (warpgroup 1 writes the
  // buffer again only after the barrier that ends the key pass)
  float* colbuf = exch;
  if (wg == 0) {
    asm volatile("bar.sync 2, 128;\n" ::: "memory");
    warp_colsums<D>(colq, colbuf, warp, 0, g, t);
  }

  // ---- key pass: dK and dV, one 64-key tile a warpgroup ----
  float colk[D / 4], colv[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) colk[i] = colv[i] = 0.f;
  for (int k0 = 64 * wg; k0 < N; k0 += 128) {
    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    for (int qc = 0; qc + 64 <= NP; qc += 64)
      key_chunk<D, 64>(Ks, Vs, Qs, Us, Ms, Rt, k0, qc, N, w, g, t, dk, dv);
    if constexpr (NP % 64 != 0)
      key_chunk<D, NP % 64>(Ks, Vs, Qs, Us, Ms, Rt, k0, NP - NP % 64, N, w,
                            g, t, dk, dv);
    const int ka = k0 + 16 * w + g;
    bf16* row = dqkv + (static_cast<size_t>(b) * N + ka) * row_stride;
    store_rows<D>(dk, 1.0f, row + C + h * D, ka < N, ka + 8 < N, row_stride,
                  t, colk);
    store_rows<D>(dv, 1.0f, row + 2 * C + h * D, ka < N, ka + 8 < N,
                  row_stride, t, colv);
  }
  both_sync();
  warp_colsums<D>(colk, colbuf, warp, 1, g, t);
  warp_colsums<D>(colv, colbuf, warp, 2, g, t);
  __syncthreads();
  // the image's column sums: the warps in order (dQ: warpgroup 0's four)
  for (int c = tid; c < 3 * D; c += kThreads) {
    const int sec = c / D, d = c % D;
    float v = 0.f;
    for (int wi = 0; wi < (sec == 0 ? 4 : 8); ++wi)
      v += colbuf[(wi * 3 + sec) * D + d];
    dbias[static_cast<size_t>(b) * row_stride + sec * C + h * D + d] = v;
  }
}

template <int D, int NP>
int launch(const void* qkv, const void* d_o, const void* m, const void* rs,
           void* dqkv, void* dbias, int B, int N, int heads, float scale,
           cudaStream_t stream) {
  // (3C, N, B) elements, a (D, NP, 1) box: one head's K or V rows, as the
  // forward (attention_core_wgmma.cu) loads them
  const uint64_t c3 = 3ull * heads * D;
  const uint64_t dims[3] = {c3, static_cast<uint64_t>(N),
                            static_cast<uint64_t>(B)};
  const uint64_t strides[2] = {2 * c3, 2 * c3 * N};
  const uint32_t box[3] = {D, NP, 1};
  CUtensorMap map;
  int err = sm::encode_bf16(&map, qkv, 3, dims, strides, box, 2 * D);
  if (err != 0) return err;
  constexpr size_t smem = Layout<D, NP>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      attention_core_bwd_wgmma_kernel<D, NP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  attention_core_bwd_wgmma_kernel<D, NP><<<B * heads, kThreads, smem,
                                           stream>>>(
      map, static_cast<const bf16*>(qkv), static_cast<const float*>(d_o),
      static_cast<const float*>(m), static_cast<const float*>(rs),
      static_cast<bf16*>(dqkv), static_cast<float*>(dbias), N, heads, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_n(const void* qkv, const void* d_o, const void* m, const void* rs,
             void* dqkv, void* dbias, int B, int N, int heads, float scale,
             cudaStream_t s) {
#define MVT_BWD_NP(np) \
  case np:             \
    return launch<D, np>(qkv, d_o, m, rs, dqkv, dbias, B, N, heads, scale, s);
  switch ((N + 15) / 16 * 16) {
    MVT_BWD_NP(16)
    MVT_BWD_NP(32)
    MVT_BWD_NP(48)
    MVT_BWD_NP(64)
    MVT_BWD_NP(80)
    MVT_BWD_NP(96)
    MVT_BWD_NP(112)
    MVT_BWD_NP(128)
    MVT_BWD_NP(144)
    MVT_BWD_NP(160)
    MVT_BWD_NP(176)
    MVT_BWD_NP(192)
    MVT_BWD_NP(208)
    MVT_BWD_NP(224)
    MVT_BWD_NP(240)
    MVT_BWD_NP(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MVT_BWD_NP
}

}  // namespace

// the KV-tiled route of attention_core_bwd.cu, any N
MVT_EXPORT int mvt_attention_core_bwd_tiled(
    const void* qkv, const void* d_o, const void* m, const void* rs,
    void* dqkv, void* dbias, void* du, void* rowterm, void* colpart, int B,
    int N, int heads, int D, float scale, int* launched, void* stream);

// Up to kMaxN tokens one launch of the kernel above (the scratch pointers
// unused), above it the KV-tiled route: du (B, N, C) bf16, rowterm (B,
// heads, N) fp32, colpart (B, ceil(N / 64), 3C) fp32.  *launched receives
// the kernels launched: 1 up to kMaxN, else 4.  qkv 16-byte aligned (the
// tensor map's base), d_o too (16-byte loads).
MVT_EXPORT int mvt_attention_core_bwd(const void* qkv, const void* d_o,
                                      const void* m, const void* rs,
                                      void* dqkv, void* dbias, void* du,
                                      void* rowterm, void* colpart, int B,
                                      int N, int heads, int D, float scale,
                                      int* launched, void* stream) {
  *launched = 0;
  if (N > kMaxN)
    return mvt_attention_core_bwd_tiled(qkv, d_o, m, rs, dqkv, dbias, du,
                                        rowterm, colpart, B, N, heads, D,
                                        scale, launched, stream);
  if (B <= 0 || heads <= 0 || N <= 0 ||
      static_cast<long long>(B) * heads > 65535 ||
      reinterpret_cast<uintptr_t>(qkv) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(d_o) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (D == 64)
    err = launch_n<64>(qkv, d_o, m, rs, dqkv, dbias, B, N, heads, scale, s);
  else if (D == 32)
    err = launch_n<32>(qkv, d_o, m, rs, dqkv, dbias, B, N, heads, scale, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (err == 0) *launched = 1;
  return err;
}
