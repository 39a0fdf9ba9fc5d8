// fake_quant_rows: the qtorch fake-quant of fp32 values, elementwise, any
// length (K11).
//
// Replaces the TPU kernel `_elementwise_pallas`
// (myrtle_vision_tpu/ops/fake_quant.py), with its two bodies
// `_float_kernel` (FloatingPoint(exp, man): float_quantize) and
// `_fixed_point_kernel` (FixedPoint(wl, fl): fixed_point_quantize).  The
// TPU kernel pads the flattened input to (rows, 128) tiles; here a
// grid-stride loop walks the flat array in 16-byte vectors (scalars when
// either pointer is not 16-byte aligned, and for the tail), so nothing is
// padded or copied.  The snaps are the device functions of fake_quant.cuh,
// which the float-format chains share.  Memory bound: 8 bytes moved per
// element against a few dozen integer and fp32 operations.
#include "fake_quant.cuh"

namespace {

constexpr int kThreads = 256;

enum Mode { kFloat = 0, kFixed = 1 };

__device__ __forceinline__ float apply(float x, const mvt::FloatFmt& f) {
  return mvt::float_snap(x, f);
}

__device__ __forceinline__ float apply(float x, const mvt::FixedFmt& f) {
  return mvt::fixed_snap(x, f);
}

template <class Fmt>
__global__ void __launch_bounds__(kThreads)
fake_quant_rows_kernel(const float* __restrict__ x, float* __restrict__ out,
                       long long n, long long n4, Fmt f) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long tid =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* o4 = reinterpret_cast<float4*>(out);
  for (long long i = tid; i < n4; i += stride) {
    float4 v = x4[i];
    v.x = apply(v.x, f);
    v.y = apply(v.y, f);
    v.z = apply(v.z, f);
    v.w = apply(v.w, f);
    o4[i] = v;
  }
  for (long long i = 4 * n4 + tid; i < n; i += stride) out[i] = apply(x[i], f);
}

template <class Fmt>
int launch(const float* x, float* out, long long n, Fmt f,
           cudaStream_t stream) {
  const bool aligned =
      ((reinterpret_cast<size_t>(x) | reinterpret_cast<size_t>(out)) & 15) ==
      0;
  const long long n4 = aligned ? n / 4 : 0;
  const long long work = n4 > 0 ? n4 : n;
  // enough blocks to fill the card several times over; each thread then
  // walks the rest with the grid stride
  const long long blocks = (work + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(blocks < 8192 ? blocks : 8192);
  fake_quant_rows_kernel<Fmt><<<grid, kThreads, 0, stream>>>(x, out, n, n4, f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out fp32 (n,), 4-byte aligned; mode 0: FloatingPoint(a = exp_bits,
// b = man_bits), mode 1: FixedPoint(a = wl, b = fl)
MVT_EXPORT int mvt_fake_quant_rows(const void* x, void* out, long long n,
                                   int mode, int a, int b, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (mode == kFloat && mvt::float_fmt_ok(a, b))
    return launch(xf, of, n, mvt::FloatFmt(a, b), s);
  if (mode == kFixed && b >= 0 && b <= 126 && a - b - 1 >= 0 &&
      a - b - 1 <= 127)
    return launch(xf, of, n, mvt::FixedFmt(a, b), s);
  return static_cast<int>(cudaErrorInvalidValue);
}
