// gemm_s8_epilogue on Hopper: the int8 projections of the converted-INT8
// model.
//
//   acc[M, N] = A[M, K] @ W[K, N]     int8 x int8 -> int32, exact
//   v = (s_x * s_w) * (acc + (128 - zp_x) * colsum[N]) + bias[N]
//
// A holds q - 128 for the input's uint8 grid q (site `a_site`: scale s_x,
// zero point zp_x, 1 and 128 without statistics), W the int8 weight with
// its per-tensor scale s_w, colsum the weight's column sums: the
// shifted-zero-point identity of the TPU kernels' `_i8_dot`
// (myrtle_vision_tpu/ops/fused_int8_block.py, inside `_attn_kernel` and
// `_mlp_kernel`; QDense._int8_forward in myrtle_vision_tpu/models/vit.py).
// Then one of three epilogues:
//   0  requant(v, site), fp32 out              (qkv, patch embedding, head)
//   1  the int8 grid of site2 of GELU(requant(v, site))           (fc1)
//   2  requant(requant(v, site) + residual, site2), fp32 out   (out, fc2)
// requant is the site's uint8 affine fake-quant (clip(rint(v/s) + zp, 0,
// 255) - zp) * s, or v itself without statistics; GELU the Abramowitz &
// Stegun erf with an exact divide.  Each product and sum rounds on its
// own, in the plain version's order, and the divides are IEEE, so kernel
// and plain version agree but where the plain GELU's fp32 operations are
// reordered by PyTorch.
//
// What bounds it: at ViT-S/16 shapes (M = 50432, K and N in {384, 1152,
// 1536}) the products do 2 M N K = 15-60 G integer operations against
// 20-310 MB of operands and outputs (fp32 out but for fc1): the fp32
// outputs make the narrower ones bound by bytes, the rest by operations
// at the int8 rate.  The WMMA design it replaced reached 4.30x
// torch._int_mm.
//
// Design (that of gemm_bf16_wgmma.cu, with int8 operands).  Both operands
// run along K in memory -- A (M, K), W read as the (N, K) torch weight --
// which is the only layout int8 wgmma takes.  The output is cut into 128 x
// 128 tiles; two persistent CTAs an SM walk them, tile c, c + grid, ...
// One producer warp issues TMA loads of 128 x 128-byte tiles of A and W
// (128-byte swizzle; rows past M or N and the tail of K zero-filled by the
// TMA unit: a zero of q - 128 adds nothing to the sum) into a three-stage
// ring on mbarriers, running on from one output tile into the next; two
// consumer warpgroups, 64 rows each, run wgmma m64n128k32 s32.s8.s8 with
// both operands in shared memory, keep one group of products in flight and
// release each stage as its group completes.  The epilogue reads the int32
// accumulators from registers (two adjacent columns of a row a thread) and
// stores fp32 pairs, or int8 pairs for epilogue 1; a ragged N (the head's
// 45 classes) stores one column at a time.  Tensor maps are encoded on the
// host for each launch (sm90.cuh) and passed as __grid_constant__
// parameters.  One CTA an SM walking 128 x 128 tiles with a four-stage
// ring, or with 232 registers a consumer, was slower at every shape (H100
// 80GB HBM3, 700 W): the second CTA's products hide the first one's
// epilogue.
//
// ptxas -v (sm_90a, nvcc 12.9): 96 registers, the most that two 288-thread
// CTAs an SM leave; each epilogue spills 20 bytes (20-28 reloaded); 99,376
// bytes of dynamic shared memory.
#include "common.cuh"
#include "sm90.cuh"

namespace {

namespace sm = mvt::sm90;
using s8 = signed char;

constexpr int BM = 128, BN = 128, BK = 128;  // BK int8: one 128-byte row
constexpr int kStages = 3;
constexpr int kConsumers = 256;              // two warpgroups of 64 rows
constexpr int kThreads = kConsumers + 32;    // and the producer warp
constexpr int kTileA = BM * BK;              // bytes of a stage's A tile
constexpr int kTileB = BN * BK;
constexpr int kStageBytes = kTileA + kTileB;
constexpr size_t kSmemBytes =
    1024 + kStages * kStageBytes + 2 * kStages * sizeof(uint64_t);

enum Epilogue { kRequant = 0, kRequantGeluQuant = 1, kRequantResidual = 2 };

struct Site {
  float s, zp;
  bool has;
};

__device__ __forceinline__ Site load_site(const float* p) {
  return Site{p[0], p[1], p[2] > 0.5f};
}

// the integer products' guard: scale 1 and zero point 128 without stats
__device__ __forceinline__ Site guarded(Site t) {
  return t.has ? t : Site{1.0f, 128.0f, false};
}

__device__ __forceinline__ float grid_q(float v, float s, float zp) {
  return fminf(fmaxf(__fadd_rn(rintf(v / s), zp), 0.f), 255.f);
}

__device__ __forceinline__ float requant(float v, Site t) {
  if (!t.has) return v;
  return __fmul_rn(__fsub_rn(grid_q(v, t.s, t.zp), t.zp), t.s);
}

// Persistent: CTA c takes output tiles c, c + gridDim.x, ..., tile
// (y tiles_n + x) being column tile x and row tile y, and the ring runs on
// across tiles, so the producer loads the next tile while the consumers
// finish this one.
template <int kEpi>
__global__ void __launch_bounds__(kThreads, 2)
gemm_s8_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_w,
                     const float* __restrict__ colsum,
                     const float* __restrict__ w_scale,
                     const float* __restrict__ a_site,
                     const float* __restrict__ bias,
                     const float* __restrict__ site,
                     const float* __restrict__ site2,
                     const float* __restrict__ residual,
                     void* __restrict__ out, int M, int N, int K) {
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the ring to it
  unsigned char* smem =
      smem_raw + ((1024 - (sm::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int tiles_n = (N + BN - 1) / BN;
  const int tiles = tiles_n * ((M + BM - 1) / BM);
  const int k_tiles = (K + BK - 1) / BK;

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
        const int m0 = (tile / tiles_n) * BM;
        for (int kt = 0; kt < k_tiles; ++kt) {
          sm::mbar_wait(&empty[s], phase ^ 1);
          unsigned char* a_s = smem + s * kStageBytes;
          sm::mbar_expect_tx(&full[s], kStageBytes);
          sm::tma_load_2d(a_s, &map_a, &full[s], kt * BK, m0);
          sm::tma_load_2d(a_s + kTileA, &map_w, &full[s], kt * BK, n0);
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
  const bool pairs = (N & 1) == 0;
  int s = 0, phase = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int n0 = (tile % tiles_n) * BN;
    const int m0 = (tile / tiles_n) * BM;
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    // one group of products stays in flight: a stage is released when the
    // group after it has been issued and it has completed
    int held = -1;
    for (int kt = 0; kt < k_tiles; ++kt) {
      sm::mbar_wait(&full[s], phase);
      const unsigned char* a_s = smem + s * kStageBytes;
      // K-major: rows of 128 bytes, 8-row groups 1024 apart, a 32-deep
      // step 32 bytes along the row
      const uint64_t da = sm::make_desc(a_s + wg * 64 * BK, 16, 1024, 128);
      const uint64_t db = sm::make_desc(a_s + kTileA, 16, 1024, 128);
      sm::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk)
        sm::WgmmaSSs8<BN>::mma(acc, sm::desc_add(da, kk * 32),
                               sm::desc_add(db, kk * 32), 1);
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

    // epilogue on the fragments: acc[4 j + e] is row r0 + 8 (e / 2),
    // column n0 + 8 j + 2 t + (e % 2)
    const Site in = guarded(load_site(a_site));
    const Site t1 = load_site(site);
    const Site t2 = kEpi == kRequant ? t1 : load_site(site2);
    const Site t2g = guarded(t2);
    const float sxw = __fmul_rn(in.s, __ldg(w_scale));
    const float shift = __fsub_rn(128.0f, in.zp);
    const int r0 = m0 + wg * 64 + (warp & 3) * 16 + g;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      if (col >= N) continue;
      const bool second = col + 1 < N;
      float cs[2], bs[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = second ? col + e : col;
        cs[e] = __ldg(colsum + c);
        bs[e] = __ldg(bias + c);
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = r0 + 8 * hh;
        if (row >= M) continue;
        const size_t o = static_cast<size_t>(row) * N + col;
        float res[2] = {0.f, 0.f};
        if (kEpi == kRequantResidual) {
          if (pairs) {
            const float2 p = *reinterpret_cast<const float2*>(residual + o);
            res[0] = p.x;
            res[1] = p.y;
          } else {
            res[0] = residual[o];
            if (second) res[1] = residual[o + 1];
          }
        }
        float v[2];
        s8 q8[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float a = __int2float_rn(acc[4 * j + 2 * hh + e]);
          float x = __fmul_rn(sxw, __fadd_rn(a, __fmul_rn(shift, cs[e])));
          x = requant(__fadd_rn(x, bs[e]), t1);
          if (kEpi == kRequantGeluQuant) {
            const float qg = grid_q(mvt::gelu_poly(x), t2g.s, t2g.zp);
            q8[e] = static_cast<s8>(static_cast<int>(qg) - 128);
          } else if (kEpi == kRequantResidual) {
            x = requant(__fadd_rn(x, res[e]), t2);
          }
          v[e] = x;
        }
        if (kEpi == kRequantGeluQuant) {
          s8* dst = static_cast<s8*>(out) + o;
          if (pairs) {
            *reinterpret_cast<char2*>(dst) = make_char2(q8[0], q8[1]);
          } else {
            dst[0] = q8[0];
            if (second) dst[1] = q8[1];
          }
        } else {
          float* dst = static_cast<float*>(out) + o;
          if (pairs) {
            *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
          } else {
            dst[0] = v[0];
            if (second) dst[1] = v[1];
          }
        }
      }
    }
  }
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

template <int kEpi>
int launch(cudaStream_t stream, const void* a, const void* w,
           const void* colsum, const void* w_scale, const void* a_site,
           const void* bias, const void* site, const void* site2,
           const void* residual, void* out, int M, int N, int K) {
  // both operands K-major int8, in boxes of 128 rows by 128 bytes of K
  CUtensorMap ma, mw;
  uint64_t dims[2] = {static_cast<uint64_t>(K), static_cast<uint64_t>(M)};
  const uint64_t strides[1] = {static_cast<uint64_t>(K)};
  const uint32_t box_a[2] = {BK, BM}, box_w[2] = {BK, BN};
  int err = sm::encode_s8(&ma, a, 2, dims, strides, box_a, 128);
  if (err != 0) return err;
  dims[1] = static_cast<uint64_t>(N);
  err = sm::encode_s8(&mw, w, 2, dims, strides, box_w, 128);
  if (err != 0) return err;
  const long long tiles =
      static_cast<long long>((N + BN - 1) / BN) * ((M + BM - 1) / BM);
  const dim3 grid(static_cast<unsigned>(
      tiles < 2LL * sm_count() ? tiles : 2LL * sm_count()));
  auto kernel = gemm_s8_wgmma_kernel<kEpi>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      ma, mw, static_cast<const float*>(colsum),
      static_cast<const float*>(w_scale), static_cast<const float*>(a_site),
      static_cast<const float*>(bias), static_cast<const float*>(site),
      static_cast<const float*>(site2), static_cast<const float*>(residual),
      out, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// The output tile and the K step (bytes): 0 rows (BM), 1 columns (BN), 2 BK.
MVT_EXPORT int mvt_gemm_s8_tile(int which) {
  return which == 0 ? BM : which == 1 ? BN : BK;
}

// a (M, K) int8 row-major; w the (N, K) int8 torch weight, row-major; both
// 16-byte aligned, K % 16 == 0 (TMA's 16-byte row strides); colsum, bias
// fp32 (N,); w_scale one fp32; a_site, site, site2 fp32 (scale, zero
// point, has_stats) rows; residual fp32 (M, N) (epilogue 2); out fp32 (M,
// N), int8 for epilogue 1.
MVT_EXPORT int mvt_gemm_s8(const void* a, const void* w, const void* colsum,
                           const void* w_scale, const void* a_site,
                           const void* bias, const void* site,
                           const void* site2, const void* residual, void* out,
                           int M, int N, int K, int epilogue, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 != 0 || !aligned16(a) ||
      !aligned16(w) || epilogue < kRequant || epilogue > kRequantResidual ||
      (epilogue != kRequant && site2 == nullptr) ||
      (epilogue == kRequantResidual && residual == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (epilogue) {
    case kRequant:
      return launch<kRequant>(s, a, w, colsum, w_scale, a_site, bias, site,
                              site2, residual, out, M, N, K);
    case kRequantGeluQuant:
      return launch<kRequantGeluQuant>(s, a, w, colsum, w_scale, a_site,
                                       bias, site, site2, residual, out, M,
                                       N, K);
    default:
      return launch<kRequantResidual>(s, a, w, colsum, w_scale, a_site, bias,
                                      site, site2, residual, out, M, N, K);
  }
}
