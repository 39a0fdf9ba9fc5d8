// attention_core on Hopper: per-head softmax attention over the fused qkv
// rows.
//
// Replaces the per-head part of the TPU attention block kernel
// (myrtle_vision_tpu/ops/fused_attention_block.py `_attn_heads_fwd`,
// called from `_fwd_kernel`).  Input qkv (B, N, 3C) bf16 with feature
// order [3][h][d]; output ctx (B, N, C) bf16, head h at columns h*D...
// For each query row, as the TPU kernel does it:
//   s   = bf16(q * scale) . k^T       fp32 accumulation
//   s   = -inf for keys >= N
//   e   = exp(s - rowmax(s))          fp32
//   u   = bf16(e) . v                 fp32 accumulation
//   out = bf16(u * (1 / rowsum(e)))   rowsum over the fp32 e, exact divide
// When the op records for the backward, the rowmax and the reciprocal
// rowsum of every row also go out, (B, H, N) fp32 each (`_fwd_kernel`'s
// `save_stats` outputs, which attention_core_bwd.cu reads).
//
// What bounds it: at ViT-S/16 (B = 256, N = 197, 6 heads of 64) the two
// products are 15.3 GFLOP (0.015 ms of bf16 tensor-core time) and the qkv
// rows and context 155 MB (0.046 ms at 3.35 TB/s): bytes, then the exp of
// 60 M scores.  The WMMA kernel (attention_core.cu, now only the K12
// probe's) took 0.63 ms: each warp sent its 16 x 212 fp32 scores through
// shared memory and back, and ~170 KB of shared memory a block left one
// block on an SM, so no load overlapped any compute.
//
// Design.  One CTA of one warpgroup per (image, head) keeps K and V of the
// head in shared memory: one TMA load each through a 3-D tensor map over
// (B, N, 3C) with a (1, N_pad, D) box (N_pad = N rounded up to 16, the
// depth of the P V product), so rows past N come back zero; the box's rows
// are one swizzle row wide (128 bytes at D = 64, 64 at D = 32), the
// layout the wgmma descriptors read.  The warpgroup walks the queries in
// 64-row tiles: Q is loaded into registers, scaled and rounded to bf16
// there and used as the register A operand of S = Q K^T, one wgmma
// m64nN_padk16 chain; the scores stay in registers (N_pad / 2 fp32 a
// thread, 104 at N = 197), the rowmax, exp and rowsum take quad shuffles;
// P is rounded to bf16 in registers and is the A operand of U = P V
// (wgmma m64nDk16, V MN-major through the transpose bit); the epilogue
// scales U by the reciprocal rowsum and stores bf16 pairs, and the
// statistics beside them.  Shared memory is 2 N_pad D bf16 (53 KB at N =
// 197), so three CTAs share an SM and one's loads and softmax overlap
// another's products.  Padding waste: 197 queries take four 64-row tiles,
// the last with 5 valid rows, and 208 key columns, so the products do
// 1.37x the work of the unpadded ones; packing tiles across heads is later
// work.  ptxas -v (sm_90a, nvcc 12.9): 168 registers a thread (the most
// that three CTAs an SM leave) up to N_pad = 224, 255 at 240 and 256 (two
// CTAs), fewer at short N; no spills but 4 bytes at D = 64, N_pad = 224;
// 2 N_pad D bf16 of dynamic shared memory and 1 KB of alignment, 53,256
// bytes at N = 197, D = 64.
//
// Longer sequences (the fused block runs up to the `fuses_at` gate of
// myrtle_vision_tpu/ops/fused_attention_block.py, 701 tokens at 6 heads of
// 64, e.g. YOLOS-S at 384 px with 677) take the KV-tiled kernel of
// flash_tiles.cuh in its kCore form: the same conventions (bf16(q * scale),
// e . V, then x reciprocal rowsum, the saved rowmax and reciprocal rowsum)
// with an online softmax over 64-key tiles, so e is rounded to bf16 against
// the running rowmax of its tile, not the final one (about 2^-9 of an
// output).  It reads the (B, H, N, D) view of the qkv rows in place.
#include "common.cuh"
#include "flash_tiles.cuh"
#include "sm90.cuh"

namespace {

using mvt::bf16;
namespace sm = mvt::sm90;

constexpr int kMaxN = 256;

template <int D, int NP>
constexpr size_t smem_bytes() {
  return 1024 + 2 * static_cast<size_t>(NP) * D * 2 + sizeof(uint64_t);
}

// three CTAs an SM where their registers allow it
template <int NP>
constexpr int min_ctas() {
  return NP <= 224 ? 3 : 2;
}

template <int D, int NP>
__global__ void __launch_bounds__(128, min_ctas<NP>())
attention_core_kernel(const __grid_constant__ CUtensorMap map_qkv,
                      const bf16* __restrict__ qkv, bf16* __restrict__ out,
                      float* __restrict__ m_out, float* __restrict__ rs_out,
                      int N, int heads, float scale) {
  constexpr int kRow = D * 2;  // bytes of a K or V row: one swizzle row
  constexpr int kTile = NP * kRow;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (sm::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* Ks = smem;
  unsigned char* Vs = smem + kTile;
  uint64_t* bar = reinterpret_cast<uint64_t*>(Vs + kTile);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const int C = heads * D;
  const size_t row_stride = static_cast<size_t>(3) * C;
  const bf16* q_base = qkv + static_cast<size_t>(b) * N * row_stride + h * D;

  if (tid == 0) {
    sm::mbar_init(bar, 1);
    sm::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    sm::mbar_expect_tx(bar, 2 * kTile);
    sm::tma_load_3d(Ks, &map_qkv, bar, C + h * D, 0, b);
    sm::tma_load_3d(Vs, &map_qkv, bar, 2 * C + h * D, 0, b);
  }
  // K is the K-major B of S = Q K^T, V the MN-major B of U = P V; rows of
  // kRow bytes, 8-row groups 8 kRow apart, one chunk across D
  const uint64_t dk = sm::make_desc(Ks, 16, 8 * kRow, kRow);
  const uint64_t dv = sm::make_desc(Vs, 16, 8 * kRow, kRow);

  for (int q0 = 0; q0 < N; q0 += 64) {
    // this thread's rows of the tile, and its A fragments of bf16(q scale):
    // word 0 (row ra, columns 2t, 2t+1 of the 16-deep step), 1 (row rb),
    // 2 and 3 (columns 2t+8, 2t+9)
    const int ra = q0 + warp * 16 + g, rb = ra + 8;
    uint32_t qa[D / 16][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int r = (w & 1) ? rb : ra;
        const int d = 16 * kk + 8 * (w >> 1) + 2 * t;
        float2 v = make_float2(0.f, 0.f);
        if (r < N)
          v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              q_base + static_cast<size_t>(r) * row_stride + d));
        qa[kk][w] = sm::pack_bf16(v.x * scale, v.y * scale);
      }
    }
    sm::mbar_wait(bar, 0);

    float s[NP / 2];
#pragma unroll
    for (int i = 0; i < NP / 2; ++i) s[i] = 0.f;
    sm::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sm::WgmmaRS<NP>::template mma<0>(s, qa[kk], sm::desc_add(dk, kk * 32),
                                       1);
    sm::wgmma_commit();
    sm::wgmma_wait<0>();
    sm::fence_regs(s);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) sm::fence_regs(qa[kk]);

    // s[4 j + e]: row ra (e < 2) or rb, key 8 j + 2 t + (e % 2)
    float mx0 = mvt::neg_inf(), mx1 = mvt::neg_inf();
#pragma unroll
    for (int j = 0; j < NP / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (NP > N && 8 * j + 2 * t + (e & 1) >= N)
          s[4 * j + e] = mvt::neg_inf();
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
    }
    // e = exp(s - m), summed in fp32, and P = bf16(e) as the A fragments
    // of the 16-key steps: step kt holds score blocks 2 kt and 2 kt + 1
    uint32_t p[NP / 16][4];
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int kt = 0; kt < NP / 16; ++kt) {
      float e[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        e[i] = expf(s[8 * kt + i] - ((i & 2) ? mx1 : mx0));
      sum0 += e[0] + e[1] + e[4] + e[5];
      sum1 += e[2] + e[3] + e[6] + e[7];
      p[kt][0] = sm::pack_bf16(e[0], e[1]);
      p[kt][1] = sm::pack_bf16(e[2], e[3]);
      p[kt][2] = sm::pack_bf16(e[4], e[5]);
      p[kt][3] = sm::pack_bf16(e[6], e[7]);
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, o);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, o);
    }

    float u[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) u[i] = 0.f;
    sm::wgmma_fence();
#pragma unroll
    for (int kt = 0; kt < NP / 16; ++kt)
      sm::WgmmaRS<D>::template mma<1>(u, p[kt],
                                      sm::desc_add(dv, kt * 16 * kRow), 1);
    sm::wgmma_commit();
    sm::wgmma_wait<0>();
    sm::fence_regs(u);
#pragma unroll
    for (int kt = 0; kt < NP / 16; ++kt) sm::fence_regs(p[kt]);

    const float inv0 = 1.0f / sum0, inv1 = 1.0f / sum1;
    bf16* out_a = out + (static_cast<size_t>(b) * N + ra) * C + h * D;
    bf16* out_b = out_a + static_cast<size_t>(8) * C;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int d = 8 * j + 2 * t;
      if (ra < N)
        *reinterpret_cast<__nv_bfloat162*>(out_a + d) =
            __floats2bfloat162_rn(u[4 * j] * inv0, u[4 * j + 1] * inv0);
      if (rb < N)
        *reinterpret_cast<__nv_bfloat162*>(out_b + d) =
            __floats2bfloat162_rn(u[4 * j + 2] * inv1, u[4 * j + 3] * inv1);
    }
    if (m_out != nullptr && t == 0) {
      const size_t o = static_cast<size_t>(blockIdx.x) * N;
      if (ra < N) {
        m_out[o + ra] = mx0;
        rs_out[o + ra] = inv0;
      }
      if (rb < N) {
        m_out[o + rb] = mx1;
        rs_out[o + rb] = inv1;
      }
    }
  }
}

template <int D, int NP>
int launch(const void* qkv, void* out, void* m, void* rs, int B, int N,
           int heads, float scale, cudaStream_t stream) {
  // (3C, N, B) elements, a (D, NP, 1) box: one head's K or V rows
  const uint64_t c3 = 3ull * heads * D;
  const uint64_t dims[3] = {c3, static_cast<uint64_t>(N),
                            static_cast<uint64_t>(B)};
  const uint64_t strides[2] = {2 * c3, 2 * c3 * N};
  const uint32_t box[3] = {D, NP, 1};
  CUtensorMap map;
  int err = sm::encode_bf16(&map, qkv, 3, dims, strides, box, 2 * D);
  if (err != 0) return err;
  constexpr size_t smem = smem_bytes<D, NP>();
  cudaError_t e = cudaFuncSetAttribute(
      attention_core_kernel<D, NP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  attention_core_kernel<D, NP><<<B * heads, 128, smem, stream>>>(
      map, static_cast<const bf16*>(qkv), static_cast<bf16*>(out),
      static_cast<float*>(m), static_cast<float*>(rs), N, heads, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_n(const void* qkv, void* out, void* m, void* rs, int B, int N,
             int heads, float scale, cudaStream_t s) {
#define MVT_CORE_NP(np) \
  case np:              \
    return launch<D, np>(qkv, out, m, rs, B, N, heads, scale, s);
  switch ((N + 15) / 16 * 16) {
    MVT_CORE_NP(16)
    MVT_CORE_NP(32)
    MVT_CORE_NP(48)
    MVT_CORE_NP(64)
    MVT_CORE_NP(80)
    MVT_CORE_NP(96)
    MVT_CORE_NP(112)
    MVT_CORE_NP(128)
    MVT_CORE_NP(144)
    MVT_CORE_NP(160)
    MVT_CORE_NP(176)
    MVT_CORE_NP(192)
    MVT_CORE_NP(208)
    MVT_CORE_NP(224)
    MVT_CORE_NP(240)
    MVT_CORE_NP(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MVT_CORE_NP
}

}  // namespace

// the longest sequence of the one-CTA kernel (and of the backward)
MVT_EXPORT int mvt_attention_core_max_n() { return kMaxN; }

// m and rs: (B, heads, N) fp32 rowmax and reciprocal rowsum, both null or
// both set; N above kMaxN takes the KV-tiled kernel.  qkv 16-byte aligned
// (the tensor map's base).
MVT_EXPORT int mvt_attention_core(const void* qkv, void* out, void* m,
                                  void* rs, int B, int N, int heads, int D,
                                  float scale, void* stream) {
  if (B <= 0 || heads <= 0 || N <= 0 ||
      static_cast<long long>(B) * heads > 65535 ||
      (m == nullptr) != (rs == nullptr) ||
      reinterpret_cast<uintptr_t>(qkv) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N > kMaxN) {
    const int C = heads * D;
    mvt::flash::Params p;
    p.q = static_cast<const mvt::bf16*>(qkv);
    p.k = p.q + C;
    p.v = p.q + 2 * C;
    p.o = static_cast<mvt::bf16*>(out);
    p.stat0 = static_cast<float*>(m);
    p.stat1 = static_cast<float*>(rs);
    p.in_image = static_cast<long long>(N) * 3 * C;
    p.in_head = D;
    p.in_row = 3 * C;
    p.out_image = static_cast<long long>(N) * C;
    p.out_head = D;
    p.out_row = C;
    p.heads = heads;
    p.n = N;
    p.n_valid = N;
    p.scale = scale;
    if (D == 64) return mvt::flash::launch<64, true>(p, B, s);
    if (D == 32) return mvt::flash::launch<32, true>(p, B, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (D == 64) return launch_n<64>(qkv, out, m, rs, B, N, heads, scale, s);
  if (D == 32) return launch_n<32>(qkv, out, m, rs, B, N, heads, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
