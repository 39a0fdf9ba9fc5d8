// The S loop of the long fp32 core's cluster design
// (csrc/attention_core_f32_long_wgmma.cu, attention_core_f32_cluster_kernel)
// in isolation, and variants of it: each CTA (one an SM, eight warps)
// computes the three passes of 64 query rows against 128 keys (64 for the
// 4 x 4 tile) from fp32 rows in shared memory, over and over; prints the
// FMAs an SM retires a cycle, of its 128.  Built and run by
// tools/perf/s_loop_bench.py.
#include <cstdio>
#include <cstdint>
__device__ __forceinline__ float lane_of(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}
// V: 0 the kernel's (4 rows x 8 keys a thread, the d loop unrolled by 2),
// 1 the same unrolled by 1, 2 a 4 x 4 tile (64 keys a step), 3 the
// kernel's without the lo halves' loads (half the shared-memory loads; the
// hi values permuted stand in), 4 a query row's q in each thread's
// registers and K read by broadcast, 8 keys a block
template <int D, int V>
__global__ void __launch_bounds__(256, 1) sloop(float* out, long long* cyc, int reps) {
  extern __shared__ float sm[];
  float* q32 = sm;                     // (2, 64, D)
  float* k32 = q32 + 2 * 64 * D;       // (2, 128, D)
  for (int i = threadIdx.x; i < 2 * 64 * D + 4 * 64 * D; i += 256) sm[i] = (i % 97) * 0.001f;
  __syncthreads();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, c = lane & 3;
  float sum = 0.f;
  long long t0 = clock64();
  for (int rep = 0; rep < reps; ++rep) {
    if (V == 2) {
      const int r0 = 32 * (warp >> 2) + g, k0 = 16 * (warp & 3) + c;
      float hh[4][4] = {}, hl[4][4] = {}, lh[4][4] = {};
      const float* qa = q32 + r0 * D;
      const float* ka = k32 + k0 * D;
#pragma unroll 2
      for (int j = 0; j < D / 4; ++j) {
        float4 qh[4], ql[4], kh[4], kl[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          qh[x] = *reinterpret_cast<const float4*>(qa + 8 * x * D + 4 * (j ^ g));
          ql[x] = *reinterpret_cast<const float4*>(qa + (64 + 8 * x) * D + 4 * (j ^ g));
          kh[x] = *reinterpret_cast<const float4*>(ka + 4 * x * D + 4 * (j ^ ((c + 4 * x) & 7)));
          kl[x] = *reinterpret_cast<const float4*>(ka + (128 + 4 * x) * D + 4 * (j ^ ((c + 4 * x) & 7)));
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int x = 0; x < 4; ++x)
#pragma unroll
            for (int y = 0; y < 4; ++y) {
              hh[x][y] = __fmaf_rn(lane_of(qh[x], e), lane_of(kh[y], e), hh[x][y]);
              hl[x][y] = __fmaf_rn(lane_of(qh[x], e), lane_of(kl[y], e), hl[x][y]);
              lh[x][y] = __fmaf_rn(lane_of(ql[x], e), lane_of(kh[y], e), lh[x][y]);
            }
      }
      for (int x = 0; x < 4; ++x) for (int y = 0; y < 4; ++y) sum += hh[x][y] + hl[x][y] + lh[x][y];
      continue;
    }
    if (V == 4) {
      // a row's q a thread, K broadcast, 8 keys a block
      const int row = 32 * (warp & 1) + lane, kg = warp >> 1;
      float qh[D], ql[D];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        qh[d] = q32[row * D + d];
        ql[d] = q32[(64 + row) * D + d];
      }
#pragma unroll 1
      for (int kb = 0; kb < 4; ++kb) {
        float hh[8], hl[8], lh[8];
#pragma unroll
        for (int y = 0; y < 8; ++y) hh[y] = hl[y] = lh[y] = 0.f;
        const float* ka = k32 + (32 * kg + 8 * kb) * D;
#pragma unroll
        for (int j = 0; j < D / 4; ++j)
#pragma unroll
          for (int y = 0; y < 8; ++y) {
            const float4 kh = *reinterpret_cast<const float4*>(ka + y * D + 4 * j);
            const float4 kl = *reinterpret_cast<const float4*>(ka + (128 + y) * D + 4 * j);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              hh[y] = __fmaf_rn(qh[4 * j + e], lane_of(kh, e), hh[y]);
              hl[y] = __fmaf_rn(qh[4 * j + e], lane_of(kl, e), hl[y]);
              lh[y] = __fmaf_rn(ql[4 * j + e], lane_of(kh, e), lh[y]);
            }
          }
        for (int y = 0; y < 8; ++y) sum += hh[y] + hl[y] + lh[y];
      }
      continue;
    }
    const int sub = warp >> 2;
    const int r0 = 32 * ((warp >> 1) & 1) + g, k0 = 32 * (warp & 1) + c;
    float hh[4][8], hl[4][8], lh[4][8];
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 8; ++y) hh[x][y] = hl[x][y] = lh[x][y] = 0.f;
    const float* qa = q32 + r0 * D;
    const float* ka = k32 + (64 * sub + k0) * D;
#define BODY                                                                   \
    {                                                                          \
      float4 qh[4], ql[4];                                                     \
      _Pragma("unroll") for (int x = 0; x < 4; ++x) {                          \
        const float* row = qa + 8 * x * D + 4 * (j ^ g);                       \
        qh[x] = *reinterpret_cast<const float4*>(row);                         \
        ql[x] = V == 3 ? make_float4(qh[x].y, qh[x].z, qh[x].w, qh[x].x) : *reinterpret_cast<const float4*>(row + 64 * D); \
      }                                                                        \
      _Pragma("unroll") for (int y = 0; y < 8; ++y) {                          \
        const float* key = ka + 4 * y * D + 4 * (j ^ ((c + 4 * y) & 7));       \
        const float4 kh = *reinterpret_cast<const float4*>(key);               \
        const float4 kl = V == 3 ? make_float4(kh.w, kh.x, kh.y, kh.z) : *reinterpret_cast<const float4*>(key + 128 * D); \
        _Pragma("unroll") for (int e = 0; e < 4; ++e)                          \
        _Pragma("unroll") for (int x = 0; x < 4; ++x) {                        \
          const float a_h = lane_of(qh[x], e), a_l = lane_of(ql[x], e);        \
          const float b_h = lane_of(kh, e), b_l = lane_of(kl, e);              \
          hh[x][y] = __fmaf_rn(a_h, b_h, hh[x][y]);                            \
          hl[x][y] = __fmaf_rn(a_h, b_l, hl[x][y]);                            \
          lh[x][y] = __fmaf_rn(a_l, b_h, lh[x][y]);                            \
        }                                                                      \
      }                                                                        \
    }
    if (V == 1) {
#pragma unroll 1
      for (int j = 0; j < D / 4; ++j) BODY
    } else {
#pragma unroll 2
      for (int j = 0; j < D / 4; ++j) BODY
    }
    for (int x = 0; x < 4; ++x) for (int y = 0; y < 8; ++y) sum += hh[x][y] + hl[x][y] + lh[x][y];
  }
  long long t1 = clock64();
  if (tid == 0) cyc[blockIdx.x] = t1 - t0;
  out[blockIdx.x * 256 + tid] = sum;
}
template <int D, int V>
void run(const char* name) {
  float* out; long long* cyc; cudaMalloc(&out, 132 * 256 * 4); cudaMalloc(&cyc, 132 * 8);
  // 200,000 bytes of shared memory a CTA: one CTA an SM, as in the kernel
  cudaFuncSetAttribute(sloop<D, V>, cudaFuncAttributeMaxDynamicSharedMemorySize, 200000);
  const int reps = 200;
  for (int k = 0; k < 2; ++k) sloop<D, V><<<132, 256, 200000>>>(out, cyc, reps);
  cudaDeviceSynchronize();
  long long c[132]; cudaMemcpy(c, cyc, sizeof c, cudaMemcpyDeviceToHost);
  double fma = (V == 2 ? 64.0 * 64 : 64.0 * 128) * 3 * D * reps;  // per CTA
  printf("s_loop_bench: D=%d %-30s %.1f FMAs a cycle an SM (%.1f%% of 128), %s\n", D, name, fma / c[0], fma / c[0] / 1.28, cudaGetErrorString(cudaGetLastError()));
  cudaFree(out); cudaFree(cyc);
}
int main() {
  run<64, 0>("4 x 8 (the kernel's)");
  run<64, 1>("4 x 8, d loop unrolled by 1");
  run<64, 2>("4 x 4");
  run<64, 3>("4 x 8, half the loads");
  run<64, 4>("q in registers, K broadcast");
  run<32, 0>("4 x 8 (the kernel's)");
  run<32, 4>("q in registers, K broadcast");
}
