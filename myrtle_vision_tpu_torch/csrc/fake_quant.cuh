// The qtorch number-format snaps of the JAX package's fake-quant primitives
// (myrtle_vision_tpu/ops/fake_quant.py `float_quantize`,
// `fixed_point_quantize`, and the site helpers `snap` / `snap_all`), and
// PyTorchINT8's observer-site snap (`snap_int8`), as device functions.  One
// header for K11's elementwise kernel (fake_quant_rows.cu) and for the
// prologues and epilogues of the float-format and INT8 QAT block-half
// chains (layernorm_snap_rows.cu, gemm_f32x3_wgmma.cu,
// attention_core_f32_wgmma.cu), so that every snap of the port runs the
// same code.  fp32 in, fp32 out; bit-identical to the plain versions
// (ops/fake_quant.py), fp32 subnormal inputs included (built without
// flush-to-zero), NaN passed through by the float snaps.
#pragma once

#include "common.cuh"

namespace mvt {

// 2^e for -126 <= e <= 127, exactly
__host__ __device__ __forceinline__ float pow2(int e) {
  union {
    unsigned u;
    float f;
  } v{static_cast<unsigned>(127 + e) << 23};
  return v.f;
}

// FloatingPoint(exp_bits, man_bits), 2 <= exp_bits <= 8, 1 <= man_bits <= 22
struct FloatFmt {
  int shift;                 // fp32 mantissa bits dropped
  bool sub;                  // a subnormal range below fp32's (exp_bits < 8)
  float sub_limit, sub_step;  // 2^min_exp and its quantum 2^(min_exp - man)
  float sub_inv;             // 1 / sub_step, exactly (a power of two)
  float max_val;             // (2 - 2^-man) * 2^max_exp
  __host__ __device__ FloatFmt(int exp_bits, int man_bits)
      : shift(23 - man_bits), sub(exp_bits < 8) {
    const int max_exp = (1 << (exp_bits - 1)) - 1;
    const int min_exp = 2 - (1 << (exp_bits - 1));
    sub_limit = sub ? pow2(min_exp) : 0.f;
    sub_step = sub ? pow2(min_exp - man_bits) : 0.f;
    sub_inv = sub ? pow2(man_bits - min_exp) : 0.f;
    union {
      unsigned u;
      float f;
    } m{(static_cast<unsigned>(127 + max_exp) << 23) |
        (((1u << man_bits) - 1u) << shift)};
    max_val = m.f;
  }
};

// `float_quantize`: round the fp32 mantissa to nearest, ties to even, on the
// bit pattern (`_round_mantissa_rne`: half a kept ulp less one, plus the
// kept mantissa's last bit, added before the dropped bits are cleared, is
// that rounding in one add; a carry runs into the exponent), the fixed
// quantum below the format's smallest normal (rint(x / step) * step, the
// divide by a power of two as its exact multiply, selected rather than
// branched to, so that a thread's snaps interleave), then saturation to the
// largest finite value
__device__ __forceinline__ float float_snap(float x, const FloatFmt& f) {
  const unsigned bits = __float_as_uint(x);
  const unsigned drop = (1u << f.shift) - 1u;
  const unsigned lsb = (bits >> f.shift) & 1u;
  float y = __uint_as_float((bits + (drop >> 1) + lsb) & ~drop);
  const float t = __fmul_rn(rintf(__fmul_rn(x, f.sub_inv)), f.sub_step);
  if (f.sub && fabsf(x) < f.sub_limit) y = t;
  if (y != y) return y;
  return fminf(fmaxf(y, -f.max_val), f.max_val);
}

// FixedPoint(wl, fl): `fixed_point_quantize`, clip(rint(x 2^fl) / 2^fl,
// -2^(wl-fl-1), 2^(wl-fl-1) - 2^-fl)
struct FixedFmt {
  float scale, t_min, t_max;
  __host__ __device__ FixedFmt(int wl, int fl)
      : scale(pow2(fl)),
        t_min(-pow2(wl - fl - 1)),
        t_max(pow2(wl - fl - 1) - pow2(-fl)) {}
};

__device__ __forceinline__ float fixed_snap(float x, const FixedFmt& f) {
  const float y = __fdiv_rn(rintf(__fmul_rn(x, f.scale)), f.scale);
  if (y != y) return y;
  return fminf(fmaxf(y, f.t_min), f.t_max);
}

// the qspec (exp_bits, man_bits, all_sites) of a stateless float format:
// `snap` at the pre_linear sites, `snap_all` at the post_op, functional and
// GELU sites, which only FP16_16 (all_sites) quantizes
struct QSpec {
  FloatFmt fmt;
  bool all_sites;
  __host__ __device__ QSpec(int exp_bits, int man_bits, int all)
      : fmt(exp_bits, man_bits), all_sites(all != 0) {}
};

__device__ __forceinline__ float snap(float x, const QSpec& q) {
  return float_snap(x, q.fmt);
}

__device__ __forceinline__ float snap_all(float x, const QSpec& q) {
  return q.all_sites ? float_snap(x, q.fmt) : x;
}

// whether (exp_bits, man_bits) is a format the snaps take
__host__ __forceinline__ bool float_fmt_ok(int exp_bits, int man_bits) {
  return exp_bits >= 2 && exp_bits <= 8 && man_bits >= 1 && man_bits <= 22;
}

// PyTorchINT8's observer-site snap (`snap_int8` of the JAX kernels, the
// uint8 affine fake-quant of ops/fake_quant.py `int8_affine_fake_quant`
// gated on has_stats): (clip(rint(x / s) + zp, 0, 255) - zp) * s where the
// site has statistics, x as it is where it has none; a true divide and
// round half to even, every step rounded on its own
__device__ __forceinline__ float int8_site_snap(float x, float s, float zp,
                                                float has) {
  if (!(has > 0.f)) return x;
  const float q =
      fminf(fmaxf(__fadd_rn(rintf(__fdiv_rn(x, s)), zp), 0.f), 255.f);
  return __fmul_rn(__fsub_rn(q, zp), s);
}

// The snap policies of the chains.  A kernel is a template on its policy:
// QSpec, a stateless float format, or Int8Sites, PyTorchINT8's frozen
// observer sites (two-pass INT8 QAT).  It resolves the policy once, where
// its epilogue starts (`resolve`), then calls `snap` and `snap_all` at the
// float format's sites and `site(x, k)` at its k-th INT8 observer site, in
// the JAX kernels' order; each is the identity under the other policy, as
// `snap` / `snap_all` are for qspec "int8" and `snap_int8` for a float
// qspec.

// device pointers to (scale, zero point, has_stats) fp32 rows of a block
// half's (5, 3) site table: the kernel's first and second observer site
// (second null where it has one), read on the device, never on the host
struct Int8Sites {
  const float* first;
  const float* second;
};

// the rows of an Int8Sites, read into registers
struct Int8Rows {
  float s[2], zp[2], has[2];
};

__device__ __forceinline__ const QSpec& resolve(const QSpec& q) { return q; }

__device__ __forceinline__ Int8Rows resolve(const Int8Sites& q) {
  Int8Rows r{{1.f, 1.f}, {0.f, 0.f}, {0.f, 0.f}};
  const float* rows[2] = {q.first, q.second};
#pragma unroll
  for (int k = 0; k < 2; ++k)
    if (rows[k] != nullptr) {
      r.s[k] = rows[k][0];
      r.zp[k] = rows[k][1];
      r.has[k] = rows[k][2];
    }
  return r;
}

__device__ __forceinline__ float snap(float x, const Int8Rows&) { return x; }

__device__ __forceinline__ float snap_all(float x, const Int8Rows&) {
  return x;
}

__device__ __forceinline__ float site(float x, const QSpec&, int) { return x; }

__device__ __forceinline__ float site(float x, const Int8Rows& r, int k) {
  return int8_site_snap(x, r.s[k], r.zp[k], r.has[k]);
}

}  // namespace mvt
