// What the Hopper flash-attention kernels share (flash_attention_fwd_wgmma.cu,
// flash_attention_bwd_wgmma.cu): their tile shapes and shared-memory
// layouts, which `K.flash_plan` (ops/_kernels.py) repeats and a CUDA test
// holds against `mvt_flash_attention_plan`; the tensor maps of a (B, H,
// N, D) bf16 view read in place through its element strides; the roles
// of a CTA; and the steps of a tile that the fused core's kernels above
// 256 tokens (core_long_wgmma.cuh) share with these.
//
// Every kernel here is a CTA of three warpgroups: warpgroup 2 the
// producer (one thread issues every TMA load; the warpgroup gives its
// registers to the others with setmaxnreg), warpgroups 0 and 1 the
// consumers, 64 rows of the CTA's 128 each.  Rows are one swizzle row
// wide (D bf16: 128 bytes at D = 64, 64 at D = 32), the layout the wgmma
// descriptors read K-major and, through the transpose bit, MN-major.
#pragma once

#include "common.cuh"
#include "sm90.cuh"

namespace mvt {
namespace flashw {

namespace sm = mvt::sm90;

constexpr int kThreads = 384;       // two consumer warpgroups, a producer
constexpr int kConsumerWarps = 8;
constexpr int kProducerRegs = 40;   // registers a producer thread keeps
constexpr int kConsumerRegs = 232;  // (65536 - 128 x 40) / 256, to 8
constexpr int kRowsCta = 128;       // the CTA's own rows (queries or keys)
constexpr float kLog2e = 1.4426950408889634f;

// forward: 128 queries a CTA, a ring of K and V tiles of 128 keys
constexpr int kFwdTile = 128;
constexpr int kFwdStages = 3;
// backward: 128 keys (dk/dv) or queries (dq) a CTA, a ring of 64-row tiles
// of the other side
constexpr int kBwdTile = 64;
constexpr int kBwdStages = 4;

template <int D>
struct FwdLayout {
  static constexpr int kRow = 2 * D;
  static constexpr int kQ = kRowsCta * kRow;  // the CTA's Q tile
  static constexpr int kKV = kFwdTile * kRow;  // one K or V tile
  static constexpr int kBarOff = kQ + 2 * kFwdStages * kKV;
  static constexpr int kBars = 1 + 4 * kFwdStages;
  static constexpr int kBytes = 1024 + kBarOff + 8 * kBars;
};

// dk/dv: K and V of the CTA's keys; a stage holds a query tile of Q and
// do and their LSE and dsum (kBwdTile fp32 each), padded to 1024 bytes
template <int D>
struct DkdvLayout {
  static constexpr int kRow = 2 * D;
  static constexpr int kOwn = kRowsCta * kRow;
  static constexpr int kTile = kBwdTile * kRow;
  static constexpr int kStage = 2 * kTile + 1024;
  static constexpr int kBarOff = 2 * kOwn + kBwdStages * kStage;
  static constexpr int kBars = 1 + 2 * kBwdStages;
  static constexpr int kBytes = 1024 + kBarOff + 8 * kBars;
};

// dq: Q and do of the CTA's queries; a stage holds a key tile of K and V
template <int D>
struct DqLayout {
  static constexpr int kRow = 2 * D;
  static constexpr int kOwn = kRowsCta * kRow;
  static constexpr int kTile = kBwdTile * kRow;
  static constexpr int kStage = 2 * kTile;
  static constexpr int kBarOff = 2 * kOwn + kBwdStages * kStage;
  static constexpr int kBars = 1 + 2 * kBwdStages;
  static constexpr int kBytes = 1024 + kBarOff + 8 * kBars;
};

// Where the row, head and image axes of a (B, H, N, D) view sit among a
// tensor map's dimensions 1-3 (dimension 0 is D): the map takes them in
// the order of their strides, so that each dimension's stride spans the
// ones inside it as the tensor-map encoding asks (the fused qkv rows'
// view has its heads inside its rows, a contiguous tensor its rows inside
// its heads).
struct Axes {
  int row, head, image;
};

// The 4-D tensor map of a (B, H, N, D) bf16 view at `base` with element
// strides (image, head, row), the last dimension contiguous, a box of
// `rows` rows of one head (D x rows bf16, one swizzle row wide); rows
// past N read as zero.  An axis of extent 1 goes outermost.
template <int D>
inline int encode_rows(CUtensorMap* map, const void* base, int B, int H,
                       int N, long long s_image, long long s_head,
                       long long s_row, int rows, Axes* axes) {
  struct Ax {
    uint64_t extent, stride;
    int id;  // 0 row, 1 head, 2 image
  } ax[3] = {{static_cast<uint64_t>(N), static_cast<uint64_t>(s_row) * 2, 0},
             {static_cast<uint64_t>(H), static_cast<uint64_t>(s_head) * 2, 1},
             {static_cast<uint64_t>(B), static_cast<uint64_t>(s_image) * 2,
              2}};
  // order by stride, axes of extent 1 last
  auto before = [](const Ax& a, const Ax& b) {
    if ((a.extent == 1) != (b.extent == 1)) return b.extent == 1;
    return a.stride < b.stride;
  };
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && before(ax[j], ax[j - 1]); --j) {
      const Ax tmp = ax[j];
      ax[j] = ax[j - 1];
      ax[j - 1] = tmp;
    }
  uint64_t dims[4] = {D, 0, 0, 0}, strides[3];
  uint32_t box[4] = {D, 1, 1, 1};
  uint64_t span = 2 * D;  // bytes the inner dimensions take
  for (int i = 0; i < 3; ++i) {
    dims[i + 1] = ax[i].extent;
    // an axis of extent 1 is never stepped: any stride that spans the
    // inner ones does
    strides[i] = ax[i].extent == 1 ? span : ax[i].stride;
    span = strides[i] * ax[i].extent;
    if (ax[i].id == 0) {
      box[i + 1] = static_cast<uint32_t>(rows);
      axes->row = i + 1;
    } else if (ax[i].id == 1) {
      axes->head = i + 1;
    } else {
      axes->image = i + 1;
    }
  }
  return sm::encode_bf16(map, base, 4, dims, strides, box, 2 * D);
}

// rows [row, row + box) of head h of image b, as encode_rows placed them
__device__ __forceinline__ void load_rows(void* dst, const CUtensorMap* map,
                                          uint64_t* bar, const Axes& ax,
                                          int row, int h, int b) {
  int c[4] = {0, 0, 0, 0};
  c[ax.row] = row;
  c[ax.head] = h;
  c[ax.image] = b;
  sm::tma_load_4d(dst, map, bar, 0, c[1], c[2], c[3]);
}

// the first 1024-byte boundary of the dynamic shared memory (the 128- and
// 64-byte swizzles repeat every 1024 bytes)
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((1024 - (sm::smem_u32(raw) & 1023)) & 1023);
}

// a consumer warp's lane 0 releases a stage once the warp is done with it
__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) sm::mbar_arrive(bar);
}

// The forward's steps, which the fused core's long forward shares
// (attention_core_long_wgmma.cu).

// O += P V over a 128-key tile (V MN-major), issued and committed
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&p)[kFwdTile / 16]
                                                            [4],
                                         uint64_t dv) {
  sm::wgmma_fence();
#pragma unroll
  for (int kt = 0; kt < kFwdTile / 16; ++kt)
    sm::WgmmaRS<D>::template mma<1>(o, p[kt],
                                    sm::desc_add(dv, kt * 16 * 2 * D), 1);
  sm::wgmma_commit();
}

// The online softmax of one tile's scores (s[4 j + e]: row ra for e < 2,
// else rb; key col0 + 8 j + 2 t + (e % 2)): keys at or past n_valid
// masked when the tile reaches them, the running maxima m (in the units
// of s; c takes s to a base-2 exponent), the factors a of the old state,
// e in place of s, the thread's partial row sums l.
__device__ __forceinline__ void softmax_tile(float (&s)[kFwdTile / 2],
                                             float (&m)[2], float (&a)[2],
                                             float (&l)[2], float c,
                                             int col0, int n_valid, int t) {
  constexpr int kN = kFwdTile;
  if (col0 + kN > n_valid) {
#pragma unroll
    for (int j = 0; j < kN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (col0 + 8 * j + 2 * t + (e & 1) >= n_valid)
          s[4 * j + e] = mvt::neg_inf();
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < kN / 8; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  float mc[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    // the first tile holds key 0 < n_valid, so mx is finite from it on;
    // before it m = -inf and a = 0 scales an empty state
    a[i] = sm::exp2_approx((m[i] - mx[i]) * c);
    m[i] = mx[i];
    mc[i] = mx[i] * c;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = sm::exp2_approx(fmaf(s[4 * j + e], c, -mc[e >> 1]));
      s[4 * j + e] = x;
      sum[e >> 1] += x;
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * a[i] + sum[i];
}

// P = bf16(e) as the A fragments of the 16-key steps: step kt holds score
// blocks 2 kt and 2 kt + 1
__device__ __forceinline__ void pack_p(const float (&s)[kFwdTile / 2],
                                       uint32_t (&p)[kFwdTile / 16][4]) {
#pragma unroll
  for (int kt = 0; kt < kFwdTile / 16; ++kt) {
    p[kt][0] = sm::pack_bf16(s[8 * kt], s[8 * kt + 1]);
    p[kt][1] = sm::pack_bf16(s[8 * kt + 2], s[8 * kt + 3]);
    p[kt][2] = sm::pack_bf16(s[8 * kt + 4], s[8 * kt + 5]);
    p[kt][3] = sm::pack_bf16(s[8 * kt + 6], s[8 * kt + 7]);
  }
}

// The backward's steps, which the fused core's long backward shares
// (attention_core_bwd_long_wgmma.cu).

// x[4 j + e] (a 64 x 64 accumulator tile) as the A fragments of the
// 16-deep steps of the next product: step kt holds blocks 2 kt, 2 kt + 1
__device__ __forceinline__ void pack_frags(const float (&x)[kBwdTile / 2],
                                           uint32_t (&f)[kBwdTile / 16]
                                                        [4]) {
#pragma unroll
  for (int kt = 0; kt < kBwdTile / 16; ++kt) {
    f[kt][0] = sm::pack_bf16(x[8 * kt], x[8 * kt + 1]);
    f[kt][1] = sm::pack_bf16(x[8 * kt + 2], x[8 * kt + 3]);
    f[kt][2] = sm::pack_bf16(x[8 * kt + 4], x[8 * kt + 5]);
    f[kt][3] = sm::pack_bf16(x[8 * kt + 6], x[8 * kt + 7]);
  }
}

// x = A B^T and y = C E^T (64 x 64 each, all four K-major 64-row tiles in
// shared memory), each its own group
template <int D>
__device__ __forceinline__ void issue_pair(float (&x)[kBwdTile / 2],
                                           uint64_t da, uint64_t db,
                                           float (&y)[kBwdTile / 2],
                                           uint64_t dc, uint64_t de) {
  sm::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    sm::WgmmaSS<kBwdTile>::template mma<0, 0>(
        x, sm::desc_add(da, kk * 32), sm::desc_add(db, kk * 32),
        kk > 0 ? 1 : 0);
  sm::wgmma_commit();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    sm::WgmmaSS<kBwdTile>::template mma<0, 0>(
        y, sm::desc_add(dc, kk * 32), sm::desc_add(de, kk * 32),
        kk > 0 ? 1 : 0);
  sm::wgmma_commit();
}

// the 1-D tensor map of `count` fp32 values, boxes of one tile
inline int encode_stats(CUtensorMap* map, const void* base, long long count) {
  const uint64_t dims[1] = {static_cast<uint64_t>(count)};
  const uint32_t box[1] = {kBwdTile};
  return sm::encode_f32(map, base, 1, dims, nullptr, box, 0);
}

}  // namespace flashw
}  // namespace mvt
