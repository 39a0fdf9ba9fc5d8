// gemm_bf16_epilogue on Hopper: out[M, N] = epilogue(A[M, K] @ B[K, N]
// (+ bias[N])), bf16 operands, fp32 accumulation, one rounding of each
// output.
//
// Replaces the projections inside the TPU block kernels, forward and
// backward (myrtle_vision_tpu/ops/fused_attention_block.py `_qkv_rows`,
// `_fwd_kernel` and `_bwd_one_image`; myrtle_vision_tpu/ops/fused_mlp.py
// `_fwd_kernel` and `_bwd_one_image`).  Epilogues, each as the WMMA kernel
// of gemm_bf16_epilogue.cu had them:
//   0  + bias, bf16 out                       (QKV projection)
//   1  + bias, GELU, bf16 out                 (fc1; the Abramowitz & Stegun
//      7.1.26 erf with an exact divide, `_gelu_f32` in interpret mode)
//   2  + bias + residual, bf16 out            (output projection and fc2)
//   3  fp32 out, no bias                      (d_o, dxn and the weight
//      gradients; with split K, one partial product per K chunk)
//   4  + bias, bf16 GELU out and the fp32 GELU derivative into `aux`
//                                             (the backward's fc1 remat,
//                                             `_gelu_and_grad_f32`)
//   5  x aux (fp32), bf16 out, fp32 column sums of the product per 128-row
//      tile into `colpart`                    (dh = dg * gelu'(h), db1)
// Layouts are read in place: A row-major (M, K), or column-major -- the
// (K, M) activation as it is stored -- for a weight gradient dW^T = dY^T X;
// B row-major (K, N) -- the JAX (in, out) layout -- or column-major, the
// (N, K) torch (out, in) weight as it is stored.  The wgmma transpose bits
// take whichever side is not K-major, so no operand is ever copied.
//
// What bounds it: at ViT-S/16 shapes (M = 256 x 197 = 50432, K and N in
// {384, 1152, 1536}) the products do 2 M N K = 15-60 GFLOP against 78-505
// MB of operands and outputs, 0.015-0.060 ms of bf16 tensor-core time
// against 0.023-0.151 ms of memory time at 3.35 TB/s: the smaller ones
// (N = 384, and the epilogues that write fp32 aux) are bound by bytes, the
// rest by operations.  The WMMA kernel reached 5-26% of either bound.
//
// Design.  The output is cut into 128 x 128 tiles (and a weight gradient's
// K into chunks); two persistent CTAs an SM walk them, tile c, c + grid,
// ...  In a CTA one producer warp issues TMA loads of 128 x 64 tiles of A
// and B (128-byte swizzle, rows past M, N or K zero-filled by the TMA
// unit) into a three-stage ring synchronised by mbarriers, running on
// from one output tile into the next; two consumer warpgroups, 64 rows
// each, run wgmma m64n128k16 with both operands in shared memory, keep one
// group of products in flight and release each stage as its group
// completes.  The epilogue works on the accumulator fragments in registers
// (two adjacent columns of a row a thread) and stores bf16 or fp32 pairs;
// the column sums of epilogue 5 are reduced across the tile's 128 rows
// through shared memory in a fixed order, without atomics.  The ring and
// the column buffer take ~101 KB, so the two CTAs of an SM fit, and one's
// epilogue overlaps the other's products while its own producer already
// loads its next tile.  A weight gradient has few output tiles (27 at
// 1152 x 384) and a long K (B x 197), so the wrapper splits K in multiples
// of 64 (`gemm_plan` in ops/_kernels.py) and colsum_rows sums the fp32
// partial products in a fixed order: every result is the same run to run.
// Tensor maps are encoded on the host for each launch (sm90.cuh) and passed
// as __grid_constant__ parameters.
//
// ptxas -v (sm_90a, nvcc 12.9): 93-96 registers a thread, the most that
// two 288-thread CTAs an SM leave; 104,496 bytes of dynamic shared memory;
// the GELU (1), GELU' (4) and column-sum (5) epilogues spill 4-28 bytes
// (12-40 reloaded), the others nothing.
#include "common.cuh"
#include "sm90.cuh"

#include <chrono>

namespace {

using mvt::bf16;
namespace sm = mvt::sm90;

constexpr int BM = 128, BN = 128, BK = 64;
constexpr int kStages = 3;
constexpr int kConsumers = 256;             // two warpgroups of 64 rows
constexpr int kThreads = kConsumers + 32;   // and the producer warp
constexpr int kTileA = BM * BK * 2;         // bytes of a stage's A tile
constexpr int kTileB = BN * BK * 2;
constexpr int kStageBytes = kTileA + kTileB;
constexpr int kBox = 64 * BK * 2;           // an MN-major box, 64 x 64
// the ring, its barriers, the column sums' buffer (a row a warp) and a
// copy of the tile's bias columns for each warpgroup
constexpr size_t kSmemBytes = 1024 + kStages * kStageBytes +
                              2 * kStages * sizeof(uint64_t) +
                              sizeof(float) * (kConsumers / 32 + 2) * BN;

enum Epilogue {
  kBias = 0,
  kBiasGelu = 1,
  kBiasResidual = 2,
  kF32 = 3,
  kBiasGeluGrad = 4,
  kMulAuxColsum = 5,
};

__device__ __forceinline__ float erf_as(float x) {
  const float s = (x > 0.f) ? 1.f : ((x < 0.f) ? -1.f : 0.f);
  const float ax = fabsf(x);
  const float t = 1.0f / (1.0f + 0.3275911f * ax);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f +
                t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  return s * (1.0f - poly * expf(-ax * ax));
}

__device__ __forceinline__ float gelu_as(float h) {
  return 0.5f * h * (1.0f + erf_as(h / 1.4142135623730951f));
}

// a barrier of consumer warpgroup wg's 128 threads (named barrier 2 + wg)
__device__ __forceinline__ void wg_sync(int wg) {
  if (wg == 0)
    asm volatile("bar.sync 2, 128;\n" ::: "memory");
  else
    asm volatile("bar.sync 3, 128;\n" ::: "memory");
}

__device__ __forceinline__ void store_bf16x2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// kAMn: A stored (K, M) (MN-major); kBMn: B stored (K, N) (MN-major).
// Persistent: CTA c takes output tiles c, c + gridDim.x, ..., tile
// (z tiles_n tiles_m + y tiles_n + x) being column tile x, row tile y and K
// chunk z, and the ring runs on across tiles, so the producer loads the
// next tile while the consumers finish this one.
template <bool kAMn, bool kBMn, int kEpi>
__global__ void __launch_bounds__(kThreads, 2)
gemm_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b,
                  const float* __restrict__ bias,
                  const bf16* __restrict__ residual, void* __restrict__ out,
                  float* __restrict__ aux, float* __restrict__ colpart, int M,
                  int N, int K, int k_split) {
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the ring to it
  unsigned char* smem =
      smem_raw + ((1024 - (sm::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  float* colbuf = reinterpret_cast<float*>(empty + kStages);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int tiles_n = (N + BN - 1) / BN, tiles_m = (M + BM - 1) / BM;
  const int tiles = tiles_n * tiles_m * ((K + k_split - 1) / k_split);

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      sm::mbar_init(&full[s], 1);
      sm::mbar_init(&empty[s], kConsumers / 32);
    }
    sm::fence_barrier_init();
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // the producer: one thread keeps the ring full
    if (lane == 0) {
      int s = 0, phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int n0 = (tile % tiles_n) * BN;
        const int m0 = (tile / tiles_n % tiles_m) * BM;
        const int k_begin = tile / (tiles_n * tiles_m) * k_split;
        const int k_tiles =
            (min(K, k_begin + k_split) - k_begin + BK - 1) / BK;
        for (int kt = 0; kt < k_tiles; ++kt) {
          sm::mbar_wait(&empty[s], phase ^ 1);
          unsigned char* a_s = smem + s * kStageBytes;
          unsigned char* b_s = a_s + kTileA;
          const int k0 = k_begin + kt * BK;
          sm::mbar_expect_tx(&full[s], kStageBytes);
          if (kAMn) {
            sm::tma_load_2d(a_s, &map_a, &full[s], m0, k0);
            sm::tma_load_2d(a_s + kBox, &map_a, &full[s], m0 + 64, k0);
          } else {
            sm::tma_load_2d(a_s, &map_a, &full[s], k0, m0);
          }
          if (kBMn) {
#pragma unroll
            for (int j = 0; j < BN / 64; ++j)
              sm::tma_load_2d(b_s + j * kBox, &map_b, &full[s], n0 + 64 * j,
                              k0);
          } else {
            sm::tma_load_2d(b_s, &map_b, &full[s], k0, n0);
          }
          if (++s == kStages) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg takes rows 64 wg .. 64 wg + 63 of a tile
  const int wg = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  constexpr bool kBiased = kEpi != kF32 && kEpi != kMulAuxColsum;
  float* bias_s = colbuf + (kConsumers / 32 + wg) * BN;
  int s = 0, phase = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int n0 = (tile % tiles_n) * BN;
    const int tile_m = tile / tiles_n % tiles_m;
    const int m0 = tile_m * BM;
    const int split = tile / (tiles_n * tiles_m);
    const int k_begin = split * k_split;
    const int k_tiles = (min(K, k_begin + k_split) - k_begin + BK - 1) / BK;
    if constexpr (kBiased) {
      // the warpgroup's copy of the tile's bias columns, read by the
      // epilogue from shared memory; loaded before the products so that
      // its latency hides behind them (the first barrier: the last tile's
      // epilogue has read the old copy)
      wg_sync(wg);
      const int c = tid & 127;
      bias_s[c] = n0 + c < N ? bias[n0 + c] : 0.f;
      wg_sync(wg);
    }

    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    // one group of products stays in flight: a stage is released when the
    // group after it has been issued and it has completed
    int held = -1;
    for (int kt = 0; kt < k_tiles; ++kt) {
      sm::mbar_wait(&full[s], phase);
      const unsigned char* a_s = smem + s * kStageBytes;
      const unsigned char* b_s = a_s + kTileA;
      // K-major: rows of 128 bytes, 8-row groups 1024 apart, a 16-deep
      // step 32 bytes along the row; MN-major: 64-wide chunks one box
      // (8 KB) apart, 8-deep groups 1024 apart, a 16-deep step 2048 bytes
      const uint64_t da =
          kAMn ? sm::make_desc(a_s + wg * kBox, kBox, 1024, 128)
               : sm::make_desc(a_s + wg * 64 * 128, 16, 1024, 128);
      const uint64_t db = kBMn ? sm::make_desc(b_s, kBox, 1024, 128)
                               : sm::make_desc(b_s, 16, 1024, 128);
      sm::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        sm::WgmmaSS<BN>::mma<kAMn, kBMn>(
            acc, sm::desc_add(da, kAMn ? kk * 2048 : kk * 32),
            sm::desc_add(db, kBMn ? kk * 2048 : kk * 32), 1);
      sm::wgmma_commit();
      sm::wgmma_wait<1>();
      if (held >= 0) {
        __syncwarp();
        if (lane == 0) sm::mbar_arrive(&empty[held]);
      }
      held = s;
      if (++s == kStages) {
        s = 0;
        phase ^= 1;
      }
    }
    sm::wgmma_wait<0>();
    sm::fence_regs(acc);
    __syncwarp();
    if (held >= 0 && lane == 0) sm::mbar_arrive(&empty[held]);

    // epilogue on the fragments: d[4 j + e] is row r0 + 8 (e / 2), column
    // n0 + 8 j + 2 t + (e % 2)
    const int r0 = m0 + wg * 64 + (warp & 3) * 16 + g;
    float csum[BN / 8][2];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      csum[j][0] = csum[j][1] = 0.f;
      const int col = n0 + 8 * j + 2 * t;  // N % 8 == 0: col + 1 < N too
      if (col >= N) continue;
      float2 bj = make_float2(0.f, 0.f);
      if constexpr (kBiased)
        bj = *reinterpret_cast<const float2*>(bias_s + 8 * j + 2 * t);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = r0 + 8 * hh;
        if (row >= M) continue;
        const size_t o = static_cast<size_t>(row) * N + col;
        float v0 = acc[4 * j + 2 * hh], v1 = acc[4 * j + 2 * hh + 1];
        if constexpr (kEpi == kF32) {
          float* dst = static_cast<float*>(out) +
                       static_cast<size_t>(split) * M * N + o;
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
          continue;
        }
        bf16* dst = static_cast<bf16*>(out) + o;
        if constexpr (kEpi == kMulAuxColsum) {
          const float2 a = *reinterpret_cast<const float2*>(aux + o);
          v0 *= a.x;
          v1 *= a.y;
          csum[j][0] += v0;
          csum[j][1] += v1;
        } else {
          v0 += bj.x;
          v1 += bj.y;
        }
        if constexpr (kEpi == kBiasGelu) {
          v0 = gelu_as(v0);
          v1 = gelu_as(v1);
        } else if constexpr (kEpi == kBiasResidual) {
          const float2 r = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(residual + o));
          v0 = r.x + v0;
          v1 = r.y + v1;
        } else if constexpr (kEpi == kBiasGeluGrad) {
          float gp[2], v[2] = {v0, v1};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float cdf =
                0.5f * (1.0f + erf_as(v[e] / 1.4142135623730951f));
            const float pdf =
                expf(-0.5f * (v[e] * v[e])) * 0.3989422804014327f;
            gp[e] = cdf + v[e] * pdf;
            v[e] = v[e] * cdf;
          }
          *reinterpret_cast<float2*>(aux + o) = make_float2(gp[0], gp[1]);
          v0 = v[0];
          v1 = v[1];
        }
        store_bf16x2(dst, v0, v1);
      }
    }
    if constexpr (kEpi == kMulAuxColsum) {
      // the warp's 16-row sums (lanes 4 g + t, g = 0 keeps them), then the
      // eight warps' in order; the buffer is free again after the second
      // barrier
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = csum[j][e];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (g == 0) colbuf[warp * BN + 8 * j + 2 * t + e] = v;
        }
      }
      asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
      if (tid < BN && n0 + tid < N) {
        float v = 0.f;
#pragma unroll
        for (int w = 0; w < kConsumers / 32; ++w) v += colbuf[w * BN + tid];
        colpart[static_cast<size_t>(tile_m) * N + n0 + tid] = v;
      }
      asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
    }
  }
}

// The tensor maps of A and B: a K-major operand in 128 x 64 boxes (its
// K extent one 128-byte swizzle row), an MN-major one in 64 x 64 boxes.
int encode_maps(CUtensorMap* ma, CUtensorMap* mb, const void* a,
                const void* b, int M, int N, int K, bool a_mn, bool b_mn) {
  const uint64_t m = M, n = N, k = K;
  uint64_t dims[2], strides[1];
  uint32_t box[2];
  if (a_mn) {
    dims[0] = m, dims[1] = k, strides[0] = 2 * m, box[0] = 64, box[1] = BK;
  } else {
    dims[0] = k, dims[1] = m, strides[0] = 2 * k, box[0] = BK, box[1] = BM;
  }
  int err = sm::encode_bf16(ma, a, 2, dims, strides, box, 128);
  if (err != 0) return err;
  if (b_mn) {
    dims[0] = n, dims[1] = k, strides[0] = 2 * n, box[0] = 64, box[1] = BK;
  } else {
    dims[0] = k, dims[1] = n, strides[0] = 2 * k, box[0] = BK, box[1] = BN;
  }
  return sm::encode_bf16(mb, b, 2, dims, strides, box, 128);
}

// the SMs of the current device (two persistent CTAs on each)
int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (counts[dev] == 0 &&
      cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    counts[dev] = 132;
  return counts[dev];
}

template <bool kAMn, bool kBMn, int kEpi>
int launch(cudaStream_t stream, const void* a, const void* b,
           const void* bias, const void* residual, void* out, void* aux,
           void* colpart, int M, int N, int K, int k_split) {
  CUtensorMap ma, mb;
  int err = encode_maps(&ma, &mb, a, b, M, N, K, kAMn, kBMn);
  if (err != 0) return err;
  const long long tiles = static_cast<long long>((N + BN - 1) / BN) *
                          ((M + BM - 1) / BM) *
                          ((K + k_split - 1) / k_split);
  const dim3 grid(static_cast<unsigned>(
      tiles < 2LL * sm_count() ? tiles : 2LL * sm_count()));
  auto kernel = gemm_wgmma_kernel<kAMn, kBMn, kEpi>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      ma, mb, static_cast<const float*>(bias),
      static_cast<const bf16*>(residual), out, static_cast<float*>(aux),
      static_cast<float*>(colpart), M, N, K, k_split);
  return static_cast<int>(cudaGetLastError());
}

template <bool kBMn>
int launch_epi(int epilogue, cudaStream_t s, const void* a,
               const void* b, const void* bias, const void* residual,
               void* out, void* aux, void* colpart, int M, int N, int K) {
  switch (epilogue) {
    case kBias:
      return launch<false, kBMn, kBias>(s, a, b, bias, residual, out,
                                        aux, colpart, M, N, K, K);
    case kBiasGelu:
      return launch<false, kBMn, kBiasGelu>(s, a, b, bias, residual,
                                            out, aux, colpart, M, N, K, K);
    case kBiasResidual:
      return launch<false, kBMn, kBiasResidual>(
          s, a, b, bias, residual, out, aux, colpart, M, N, K, K);
    case kF32:
      return launch<false, kBMn, kF32>(s, a, b, bias, residual, out,
                                       aux, colpart, M, N, K, K);
    case kBiasGeluGrad:
      return launch<false, kBMn, kBiasGeluGrad>(
          s, a, b, bias, residual, out, aux, colpart, M, N, K, K);
    default:
      return launch<false, kBMn, kMulAuxColsum>(
          s, a, b, bias, residual, out, aux, colpart, M, N, K, K);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// The output tile and the K step: 0 rows (BM), 1 columns (BN), 2 BK.
MVT_EXPORT int mvt_gemm_bf16_tile(int which) {
  return which == 0 ? BM : which == 1 ? BN : BK;
}

// Row-major A.  `out` is bf16 except for epilogue 3 (fp32); `aux` is the
// fp32 (M, N) GELU derivative (written by 4, read by 5); `colpart` the
// fp32 (ceil(M / 128), N) column sums of epilogue 5.  A and B 16-byte
// aligned, K and N multiples of 8 (TMA's 16-byte strides).
MVT_EXPORT int mvt_gemm_bf16(const void* a, const void* b, const void* bias,
                             const void* residual, void* out, void* aux,
                             void* colpart, int M, int N, int K,
                             int b_col_major, int epilogue, void* stream) {
  const bool needs_bias = epilogue != kF32 && epilogue != kMulAuxColsum;
  if (M <= 0 || N <= 0 || K <= 0 || K % 8 != 0 || N % 8 != 0 ||
      !aligned16(a) || !aligned16(b) || epilogue < kBias ||
      epilogue > kMulAuxColsum || (needs_bias && bias == nullptr) ||
      (epilogue == kBiasResidual && residual == nullptr) ||
      ((epilogue == kBiasGeluGrad || epilogue == kMulAuxColsum) &&
       aux == nullptr) ||
      (epilogue == kMulAuxColsum && colpart == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // a column-major B is the (N, K) weight: K-major for wgmma
  if (b_col_major)
    return launch_epi<false>(epilogue, s, a, b, bias, residual, out, aux,
                             colpart, M, N, K);
  return launch_epi<true>(epilogue, s, a, b, bias, residual, out, aux,
                          colpart, M, N, K);
}

// Weight gradient: out = A^T-stored x B, i.e. A stored (K, M) row-major and
// B (K, N) row-major, K ragged, fp32 out.  K is split into chunks of
// k_split rows (a multiple of BK); chunk z writes out[z] of (splits, M, N).
MVT_EXPORT int mvt_gemm_bf16_at(const void* a, const void* b, void* out,
                                int M, int N, int K, int k_split,
                                void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || M % 8 != 0 || N % 8 != 0 ||
      !aligned16(a) || !aligned16(b) || k_split <= 0 || k_split % BK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<true, true, kF32>(static_cast<cudaStream_t>(stream), a, b,
                                  nullptr, nullptr, out, nullptr, nullptr, M,
                                  N, K, k_split);
}

// Host nanoseconds to encode one launch's two tensor maps (a row-major A
// and a column-major B of M x K and K x N), the mean of `iters`; negative
// on an encoding error.  A diagnostic of the launch's host cost.
MVT_EXPORT int mvt_gemm_bf16_encode_ns(const void* a, const void* b, int M,
                                       int N, int K, int iters) {
  CUtensorMap ma, mb;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < iters; ++i)
    if (encode_maps(&ma, &mb, a, b, M, N, K, false, false) != 0) return -1;
  const auto t1 = std::chrono::steady_clock::now();
  return static_cast<int>(
      std::chrono::duration_cast<std::chrono::nanoseconds>(t1 - t0).count() /
      (iters > 0 ? iters : 1));
}
