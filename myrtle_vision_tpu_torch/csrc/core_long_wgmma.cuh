// What the fused attention core's kernels above 256 tokens share
// (attention_core_long_wgmma.cu, the forward; attention_core_bwd_long_wgmma.cu,
// the backward): the CTA's shape and roles, the tile shapes and the
// shared-memory layouts, which `K.core_long_plan` (ops/_kernels.py)
// repeats and a CUDA test holds against `mvt_attention_core_long_plan`.
//
// Every kernel here is a CTA of one consumer warpgroup (warps 0-3) that
// owns 64 rows (queries, or keys in the dk / dv kernel) of one (image,
// head).  The backward's kernels add one producer warp (warp 4) whose
// lane 0 issues every TMA load; the forward's thread 0 issues its own.
// Loads go through the 4-D tensor maps of flash_wgmma.cuh over a (B, H,
// N, D) view read in place.  The size is chosen for the shape the
// YOLOS-S train step runs, 2 images x 6 heads at N = 677: 64-row CTAs
// give 11 a (image, head), 132 CTAs, one for each SM of an H100, where
// 128-row CTAs (the flash kernels') gave 72; at batch 8, 528 CTAs fill
// the card in two waves of two CTAs an SM, which the shared memory and
// registers below allow, so one CTA's softmax runs under the other's
// products.
#pragma once

#include "flash_wgmma.cuh"

namespace mvt {
namespace core_long {

constexpr int kRows = 64;            // a CTA's own rows: one warpgroup's
constexpr int kConsumerWarps = 4;
constexpr int kThreads = 160;  // the backward: a warpgroup, a producer warp
constexpr int kCtasPerSm = 2;
constexpr float kLog2e = 1.4426950408889634f;

// forward: the consumer warpgroup alone (its thread 0 issues the loads),
// a ring of K and V tiles of the flash forward's 128 keys (whose steps it
// shares)
constexpr int kFwdThreads = 128;
constexpr int kFwdTile = flashw::kFwdTile;
constexpr int kFwdStages = 3;
// backward: a ring of tiles of the other side, the flash backward's 64
// rows (whose steps it shares)
constexpr int kBwdTile = flashw::kBwdTile;
constexpr int kBwdStages = 4;

template <int D>
struct FwdLayout {
  static constexpr int kRow = 2 * D;
  static constexpr int kKV = kFwdTile * kRow;  // one K or V tile
  static constexpr int kBarOff = 2 * kFwdStages * kKV;
  static constexpr int kBars = 2 * kFwdStages;
  static constexpr int kBytes = 1024 + kBarOff + 8 * kBars;
};

// the dq kernel: qs and du of the CTA's queries; a stage holds a key tile
// of K and V; after the bars the column sums' buffer of
// sm90::warp_colsums (4 warps x 3 sections x D fp32)
template <int D>
struct DqLayout {
  static constexpr int kRow = 2 * D;
  static constexpr int kOwn = kRows * kRow;
  static constexpr int kTile = kBwdTile * kRow;
  static constexpr int kStage = 2 * kTile;
  static constexpr int kBarOff = 2 * kOwn + kBwdStages * kStage;
  static constexpr int kBars = 1 + 2 * kBwdStages;
  static constexpr int kColOff = kBarOff + 8 * kBars;
  static constexpr int kBytes = 1024 + kColOff + 4 * kConsumerWarps * 3 * D;
};

// the dk / dv kernel: K and V of the CTA's keys; a stage holds a query
// tile of qs and du and their m log2(e) and r rs (kBwdTile fp32 each),
// padded to 1024 bytes; the column sums' buffer as the dq kernel's
template <int D>
struct DkdvLayout {
  static constexpr int kRow = 2 * D;
  static constexpr int kOwn = kRows * kRow;
  static constexpr int kTile = kBwdTile * kRow;
  static constexpr int kStage = 2 * kTile + 1024;
  static constexpr int kBarOff = 2 * kOwn + kBwdStages * kStage;
  static constexpr int kBars = 1 + 2 * kBwdStages;
  static constexpr int kColOff = kBarOff + 8 * kBars;
  static constexpr int kBytes = 1024 + kColOff + 4 * kConsumerWarps * 3 * D;
};

// rows a (image, head) is padded to in the backward's row statistics, so
// that each 64-row tile of them starts 256-byte aligned for its 1-D TMA box
inline int n_pad(int n) { return (n + kBwdTile - 1) / kBwdTile * kBwdTile; }

}  // namespace core_long
}  // namespace mvt
