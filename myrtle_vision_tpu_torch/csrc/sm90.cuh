// Hopper (sm_90a) building blocks of the port's wgmma kernels: TMA tensor
// maps (encoded on the host), TMA loads completing on mbarriers, wgmma
// matrix descriptors and the wgmma fences (the products themselves are in
// sm90_wgmma.cuh), and the helpers several kernels share: the bf16 hi / lo
// split, the swizzled tile layout that threads write, the column sums of
// an accumulator tile.  Tensor maps of bf16, fp32 and int8 elements.
//
// The driver's cuTensorMapEncodeTiled is reached through the runtime's
// cudaGetDriverEntryPoint, so the library links against the CUDA runtime
// only (no -lcuda); <cuda.h> supplies the types.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "sm90_wgmma.cuh"

namespace mvt {
namespace sm90 {

// ------------------------------------------------------------------ host

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A tensor map of `rank` (1 to 5) dimensions and element type `type`,
// innermost first: dims[i] elements, strides[i] bytes between consecutive
// indices of dimension i + 1, a box of box[i] elements, swizzled in rows
// of `swizzle` bytes (128 or 64; the box's inner extent is one such row),
// or not swizzled (0).  Elements outside the tensor read as zero.
// Returns a cudaError_t value.
inline int encode_map(CUtensorMap* map, CUtensorMapDataType type,
                      const void* base, int rank, const uint64_t* dims,
                      const uint64_t* strides, const uint32_t* box,
                      int swizzle) {
  EncodeTiled fn = encode_tiled_fn();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  if (rank < 1 || rank > 5) return static_cast<int>(cudaErrorInvalidValue);
  cuuint64_t d[5], s[4];
  cuuint32_t b[5], e[5] = {1, 1, 1, 1, 1};
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
    if (i + 1 < rank) s[i] = strides[i];
  }
  const CUresult r = fn(
      map, type, static_cast<cuuint32_t>(rank), const_cast<void*>(base), d,
      s, b, e, CU_TENSOR_MAP_INTERLEAVE_NONE,
      swizzle == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : swizzle == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                      : CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// the same for bf16, fp32 and int8 elements (int8 as raw bytes)
inline int encode_bf16(CUtensorMap* map, const void* base, int rank,
                       const uint64_t* dims, const uint64_t* strides,
                       const uint32_t* box, int swizzle) {
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, rank, dims,
                    strides, box, swizzle);
}

inline int encode_f32(CUtensorMap* map, const void* base, int rank,
                      const uint64_t* dims, const uint64_t* strides,
                      const uint32_t* box, int swizzle) {
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, base, rank, dims,
                    strides, box, swizzle);
}

inline int encode_s8(CUtensorMap* map, const void* base, int rank,
                     const uint64_t* dims, const uint64_t* strides,
                     const uint32_t* box, int swizzle) {
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, base, rank, dims,
                    strides, box, swizzle);
}

// ---------------------------------------------------------------- device

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}

// make the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// one arrival that also expects `bytes` of TMA traffic this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// wait until the phase of parity `parity` has completed; a phase that
// never completes (a transfer that never lands) traps after ~2^28 polls
// rather than hang the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 28)) __trap();
  }
}

__device__ __forceinline__ void tma_load_1d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// 2^x on the SFU (MUFU.EX2), subnormal results flushed to zero; -inf
// gives 0
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// wgmma matrix descriptor of a tile in shared memory swizzled in rows of
// `swizzle` bytes (128 or 64; the tile 1024-byte aligned).  K-major: sbo
// is the stride of 8-row groups, lbo unused.  MN-major: sbo the stride of
// 8-row groups along K, lbo that of the swizzle-wide chunks along M or N.
__device__ __forceinline__ uint64_t make_desc(const void* tile, uint32_t lbo,
                                              uint32_t sbo, int swizzle) {
  const uint64_t layout = swizzle == 128 ? 1 : 2;
  return static_cast<uint64_t>((smem_u32(tile) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// a descriptor moved `bytes` further into its tile
__device__ __forceinline__ uint64_t desc_add(uint64_t desc, uint32_t bytes) {
  return desc + (bytes >> 4);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// Pin registers that an in-flight wgmma reads or writes: the compiler
// must treat each as read and rewritten here, so it neither reads an
// accumulator before its wgmma_wait nor reuses an operand register early.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ void fence_reg(uint64_t& r) {
  asm volatile("" : "+l"(r)::"memory");
}

// move registers between warpgroups: a warpgroup that needs few gives
// them back (dec), one that needs many takes them (inc, waiting until they
// are free); every warp of the warpgroup executes it, inside the branch of
// its role
template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// make this thread's writes to shared memory visible to the async proxy
// (a wgmma or TMA store that reads them next)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// hi = bf16(x), lo = bf16(x - hi) of a pair, as packed words (x in the low
// half): the split of `dot_high3` (myrtle_vision_tpu/ops/high_precision.py)
__device__ __forceinline__ void split_bf16x2(float x, float y, uint32_t& hi,
                                             uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const __nv_bfloat162 l = __floats2bfloat162_rn(
      __fsub_rn(x, __low2float(h)), __fsub_rn(y, __high2float(h)));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// byte offset of a 16-byte chunk in a tile swizzled as TMA writes it
// (kRow = 128- or 64-byte rows, the tile 1024-byte aligned)
template <int kRow>
__device__ __forceinline__ uint32_t swizzle_chunk(uint32_t off) {
  return off ^ (((off >> 7) & (kRow == 128 ? 7 : 3)) << 4);
}

// K-major descriptor of the rows of a swizzled tile of D bf16 columns
// (one swizzle row) from row `row`; the same bits read MN-major through
// the transpose bit
template <int D>
__device__ __forceinline__ uint64_t rows_desc(const unsigned char* tile,
                                              int row) {
  constexpr int kRow = 2 * D;
  return make_desc(tile + row * kRow, 16, 8 * kRow, kRow);
}

// the column sums of a warp's rows of an m64nD accumulator tile (col[2 j
// + e]: the thread's column 8 j + 2 t + e, summed over its rows) into row
// `warp` of section `sec` of colbuf (warps x 3 sections x D fp32): the
// lanes of one t hold one column pair
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

}  // namespace sm90
}  // namespace mvt
