// What the fp32 flash kernels share (flash_attention_f32_fwd_wgmma.cu,
// flash_attention_f32_bwd_wgmma.cu): the 3xTF32 products on wgmma, the
// split pass that writes each operand's tf32 halves once a call in the
// layouts the products read, and the tensor maps that read them back.
//
// The arithmetic.  Every product is 3xTF32: each fp32 operand x is split
// as hi = tf32(x), lo = tf32(x - hi) (cvt.rna.tf32.f32: round to nearest,
// ties away from zero; `split_tf32` of ops/flash_attention.py repeats it
// on the int32 view), and a . b = ah.bl + al.bh + ah.bh, the three passes
// into one fp32 accumulator in that order, each over its 8-deep steps
// (`chain3` of attention_f32_tiles.cuh).  A tf32 wgmma reads only the top
// 19 bits of each operand word, so every operand it reads is rounded
// first: raw fp32 bits would be truncated, not rounded.  The lost term
// al.bl is about 2^-22 of a product.
//
// Layouts.  wgmma has no transpose for tf32: both shared-memory operands
// are K-major, their contracted index contiguous in 128-byte swizzle rows
// (32 values).  A product that contracts over tokens (P V, dS K, P^T dO,
// dS^T q) therefore reads a transposed copy (D rows of tokens), which the
// split pass writes: "natural" arrays (tokens x D) and "transposed" ones
// (D x tokens), each hi then lo, per (image, head) plane, rows of
// n_split(N) = N rounded up to 8 tokens, zeros past N.
//
// The A operand from registers.  The m64nNk8 tf32 A fragment of lane 4 g
// + t holds (row g, k t), (g + 8, t), (g, t + 4), (g + 8, t + 4) of its
// warp's 16 rows, while an fp32 accumulator holds columns 2 t, 2 t + 1 of
// each 8.  So that a score tile's accumulator is its next product's A
// fragment as it lies, the contracted index is permuted within each group
// of 8 on both sides: position p of a group holds index 2 (p % 4) + p / 4
// (`src_of`; index i sits at 4 (i % 2) + i / 2).  The split pass writes every
// array so; an A fragment from an accumulator takes (s0, s2, s1, s3) of
// each 4, and one loaded from fp32 rows takes the pair at 2 t of row g and
// of row g + 8.  The sum over the contracted index is the same sum.
#pragma once

#include "attention_f32_tiles.cuh"
#include "common.cuh"
#include "sm90.cuh"

namespace mvt {
namespace tf32flash {

namespace sm = mvt::sm90;
using f32attn::chain3;
using f32attn::chain3_pair;
using f32attn::chain_first;

constexpr int kTile = 64;         // tokens of a walked tile or own block
constexpr int kSub = 32;          // tf32 values of a 128-byte swizzle row
constexpr float kNeg = -1e30f;    // a masked key's score (the JAX kernels')
constexpr int kSmemOptin = 232448;  // dynamic shared memory a CTA may ask

__host__ __device__ constexpr int n_split(int n) { return (n + 7) / 8 * 8; }

// bytes of one half (hi or lo) of a 64-token tile, natural or transposed
template <int D>
__host__ __device__ constexpr int half_bytes() {
  return kTile * D * 4;
}

// ------------------------------------------------------------ arithmetic

__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return __uint_as_float(y);
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  const float h = tf32_rna(x);
  hi = __float_as_uint(h);
  lo = __float_as_uint(tf32_rna(__fsub_rn(x, h)));
}

// the source index of position p of a group of 8
__host__ __device__ constexpr int src_of(int p) { return 2 * (p & 3) + (p >> 2); }

// a 64 x 8 J accumulator tile (x[4 j + e]: row g + 8 (e / 2), column 8 j +
// 2 t + e % 2) as the split A fragments of the J steps of a product that
// contracts over its columns
template <int J>
__device__ __forceinline__ void frags(const float (&x)[4 * J],
                                      uint32_t (&hi)[J][4],
                                      uint32_t (&lo)[J][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    split(x[4 * j], hi[j][0], lo[j][0]);
    split(x[4 * j + 2], hi[j][1], lo[j][1]);
    split(x[4 * j + 1], hi[j][2], lo[j][2]);
    split(x[4 * j + 3], hi[j][3], lo[j][3]);
  }
}

// pins the split fragments of an in-flight product (sm90.cuh fence_regs)
template <int J>
__device__ __forceinline__ void fence_frags(uint32_t (&hi)[J][4],
                                            uint32_t (&lo)[J][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    sm::fence_regs(hi[j]);
    sm::fence_regs(lo[j]);
  }
}

// ---------------------------------------------------------------- wgmma
//
// D (64 x N fp32, d[N / 2] a thread) (+)= A (64 x 8 tf32) x B (8 x N tf32,
// K-major in shared memory, descriptor desc_b); RS: A the four words of
// the fragment above, SS: A K-major in shared memory too.

template <int N>
struct WgmmaRS;

template <>
struct WgmmaRS<32> {
  __device__ __forceinline__ static void mma(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(scale_d));
  }
};

template <>
struct WgmmaRS<64> {
  __device__ __forceinline__ static void mma(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(scale_d));
  }
};

template <int N>
struct WgmmaSS;

template <>
struct WgmmaSS<32> {
  __device__ __forceinline__ static void mma(float (&d)[16], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
};

template <>
struct WgmmaSS<64> {
  __device__ __forceinline__ static void mma(float (&d)[32], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
};

// The K-major descriptor of a half tile in shared memory (1024-byte
// aligned, rows of 128 bytes, 8-row groups 1024 bytes apart), and the
// descriptor units from it to 8-deep step k: the tile's 32-wide swizzle
// blocks lie `block` bytes apart (a natural tile, 64 tokens x D: blocks of
// 64 rows, kNatBlock; a transposed one, D x 64 tokens: blocks of D rows).
__device__ __forceinline__ uint64_t tile_desc(const unsigned char* half) {
  return sm::make_desc(half, 16, 1024, 128);
}

constexpr int kNatBlock = kTile * 128;

__host__ __device__ constexpr uint32_t step(int block, int k) {
  return static_cast<uint32_t>((k >> 2) * block + (k & 3) * 32) >> 4;
}

// ---------------------------------------------------------- split pass

// one operand of the split pass: a (B, H, N, D) fp32 view (element
// strides; rows contiguous, 16-byte aligned) and where its halves go: the
// index of its natural and of its transposed array, or -1
struct SplitOp {
  const float* src;
  long long s_image;
  int s_head, s_row;
  int nat, tr;
};

constexpr int kMaxSplitOps = 4;  // the backward splits q, k, v and do
constexpr int kSplitThreads = 256;

struct SplitArgs {
  SplitOp op[kMaxSplitOps];
  float* nat;  // natural arrays: [array][hi, lo][B H][ns][D]
  float* tr;   // transposed arrays: [array][hi, lo][B H][D][ns]
  int heads, n, ns;
};

namespace {  // each source that launches the pass holds its own copy

// A block splits 64 tokens of one (image, head) of operand blockIdx.z:
// the fp32 tile through shared memory, then each half of each array the
// operand asks for, 4 positions a thread-step (16-byte stores).
template <int D>
__global__ void __launch_bounds__(kSplitThreads)
    flash_f32_split_kernel(const SplitArgs a) {
  __shared__ float tile[kTile][D + 1];
  const SplitOp op = a.op[blockIdx.z];
  const int bh = blockIdx.y, bhs = gridDim.y;
  const int b = bh / a.heads, h = bh % a.heads;
  const int t0 = blockIdx.x * kTile;
  const float* base =
      op.src + b * op.s_image + static_cast<long long>(h) * op.s_head;
  // every load of the thread in flight before the first store
  constexpr int kSteps = kTile * D / 4 / kSplitThreads;
  float4 x[kSteps];
#pragma unroll
  for (int k = 0; k < kSteps; ++k) {
    const int i = threadIdx.x + k * kSplitThreads;
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    x[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t0 + r < a.n)
      x[k] = __ldg(reinterpret_cast<const float4*>(
          base + static_cast<long long>(t0 + r) * op.s_row + c));
  }
#pragma unroll
  for (int k = 0; k < kSteps; ++k) {
    const int i = threadIdx.x + k * kSplitThreads;
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    tile[r][c] = x[k].x;
    tile[r][c + 1] = x[k].y;
    tile[r][c + 2] = x[k].z;
    tile[r][c + 3] = x[k].w;
  }
  __syncthreads();
  const long long plane = static_cast<long long>(a.ns) * D;
  const long long half = plane * bhs;
  if (op.nat >= 0) {
    float* out = a.nat + 2 * op.nat * half + bh * plane;
    for (int i = threadIdx.x; i < kTile * D / 4; i += kSplitThreads) {
      const int r = i / (D / 4), p = (i % (D / 4)) * 4;
      if (t0 + r >= a.ns) continue;
      const int g = p & ~7, p8 = p & 7;
      uint4 hv, lv;
      split(tile[r][g + src_of(p8)], hv.x, lv.x);
      split(tile[r][g + src_of(p8 + 1)], hv.y, lv.y);
      split(tile[r][g + src_of(p8 + 2)], hv.z, lv.z);
      split(tile[r][g + src_of(p8 + 3)], hv.w, lv.w);
      // streaming stores: the next kernel reads the scratch once
      float* dst = out + static_cast<long long>(t0 + r) * D + p;
      __stcs(reinterpret_cast<uint4*>(dst), hv);
      __stcs(reinterpret_cast<uint4*>(dst + half), lv);
    }
  }
  if (op.tr >= 0) {
    float* out = a.tr + 2 * op.tr * half + bh * plane;
    for (int i = threadIdx.x; i < kTile * D / 4; i += kSplitThreads) {
      const int d = i / (kTile / 4), p = (i % (kTile / 4)) * 4;
      if (t0 + p >= a.ns) continue;
      const int g = p & ~7, p8 = p & 7;
      uint4 hv, lv;
      split(tile[g + src_of(p8)][d], hv.x, lv.x);
      split(tile[g + src_of(p8 + 1)][d], hv.y, lv.y);
      split(tile[g + src_of(p8 + 2)][d], hv.z, lv.z);
      split(tile[g + src_of(p8 + 3)][d], hv.w, lv.w);
      float* dst = out + static_cast<long long>(d) * a.ns + t0 + p;
      __stcs(reinterpret_cast<uint4*>(dst), hv);
      __stcs(reinterpret_cast<uint4*>(dst + half), lv);
    }
  }
}

inline int launch_split(const SplitArgs& a, int ops, int B, int D,
                        cudaStream_t stream) {
  const dim3 grid((a.n + kTile - 1) / kTile, B * a.heads, ops);
  if (D == 64)
    flash_f32_split_kernel<64><<<grid, kSplitThreads, 0, stream>>>(a);
  else
    flash_f32_split_kernel<32><<<grid, kSplitThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ---------------------------------------------------------- tensor maps

// the 3-D map of `arrays` natural arrays (D, ns, 2 arrays B H): boxes of
// 32 values by 64 tokens of one plane; tokens past ns read as zero
template <int D>
inline int encode_natural(CUtensorMap* map, const float* base, int arrays,
                          int bhs, int ns) {
  const uint64_t dims[3] = {static_cast<uint64_t>(D),
                            static_cast<uint64_t>(ns),
                            static_cast<uint64_t>(2) * arrays * bhs};
  const uint64_t strides[2] = {static_cast<uint64_t>(D) * 4,
                               static_cast<uint64_t>(ns) * D * 4};
  const uint32_t box[3] = {kSub, kTile, 1};
  return sm::encode_f32(map, base, 3, dims, strides, box, 128);
}

// the 3-D map of `arrays` transposed arrays (ns, D, 2 arrays B H): boxes
// of 32 tokens by D rows of one plane; tokens past ns read as zero
template <int D>
inline int encode_transposed(CUtensorMap* map, const float* base,
                             int arrays, int bhs, int ns) {
  const uint64_t dims[3] = {static_cast<uint64_t>(ns),
                            static_cast<uint64_t>(D),
                            static_cast<uint64_t>(2) * arrays * bhs};
  const uint64_t strides[2] = {static_cast<uint64_t>(ns) * 4,
                               static_cast<uint64_t>(ns) * D * 4};
  const uint32_t box[3] = {kSub, static_cast<uint32_t>(D), 1};
  return sm::encode_f32(map, base, 3, dims, strides, box, 128);
}

// both halves of tokens t0 .. t0 + 63 of (array, plane bh) into `dst` (hi,
// then lo half_bytes further), on barrier `bar`, which expects their bytes
template <int D>
__device__ __forceinline__ void load_natural(unsigned char* dst,
                                             const CUtensorMap* map,
                                             uint64_t* bar, int array,
                                             int bh, int bhs, int t0) {
#pragma unroll
  for (int hl = 0; hl < 2; ++hl)
#pragma unroll
    for (int c = 0; c < D / kSub; ++c)
      sm::tma_load_3d(dst + hl * half_bytes<D>() + c * kNatBlock, map, bar,
                      c * kSub, t0, (2 * array + hl) * bhs + bh);
}

template <int D>
__device__ __forceinline__ void load_transposed(unsigned char* dst,
                                                const CUtensorMap* map,
                                                uint64_t* bar, int array,
                                                int bh, int bhs, int t0) {
#pragma unroll
  for (int hl = 0; hl < 2; ++hl)
#pragma unroll
    for (int c = 0; c < kTile / kSub; ++c)
      sm::tma_load_3d(dst + hl * half_bytes<D>() + c * D * 128, map, bar,
                      t0 + c * kSub, 0, (2 * array + hl) * bhs + bh);
}

// the first 1024-byte boundary of the dynamic shared memory
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((1024 - (sm::smem_u32(raw) & 1023)) & 1023);
}

// cudaFuncSetAttribute(fn, MaxDynamicSharedMemorySize, bytes) once a
// device; a cudaError_t value
inline int allow_smem(const void* fn, int bytes, unsigned* done_mask) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned bit = 1u << (dev & 31);
  if (*done_mask & bit) return 0;
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess) *done_mask |= bit;
  return static_cast<int>(e);
}

}  // namespace tf32flash
}  // namespace mvt
