"""Fake-quantization primitives for the FPGA number formats, in PyTorch
(port of myrtle_vision_tpu/ops/fake_quant.py).

Each takes and returns float32 and equals the JAX function bit for bit:
round to nearest, ties to even (``torch.round``, as ``jnp.rint``), true
fp32 divides, saturating clamps.

- :func:`float_quantize`: float(exp_bits, man_bits) with subnormals and
  saturation to the largest finite value (qtorch FloatingPoint; e5m10 is
  IEEE fp16, e8m10 TF32).
- :func:`fixed_point_quantize`: signed fixed point (wl, fl) (qtorch
  FixedPoint).
- :func:`int8_affine_fake_quant`: uint8 affine, PyTorchINT8 activations.
- :func:`int8_symmetric_fake_quant`: qint8 symmetric, PyTorchINT8
  weights.

The TPU's elementwise kernel of the first two (``_elementwise_pallas``,
K11) is ``fake_quant_rows`` (csrc/fake_quant_rows.cu, whose snaps,
csrc/fake_quant.cuh, the float-format block chains share):
:func:`float_quantize_rows` and :func:`fixed_point_quantize_rows` launch
it for a CUDA tensor and run the plain function above for a CPU tensor.
:func:`snap` and :func:`snap_all` are the JAX kernels' site helpers for a
float format's ``qspec = (exp_bits, man_bits, all_sites)``, in their
plain form.

The int8 pair also comes as straight-through ``autograd.Function``s
(``*_ste``): the gradient passes to ``x`` unchanged and not to the
quantization parameters, as the JAX custom VJPs do.  The float formats'
STEs come with QAT (ROADMAP A5a).
"""
from __future__ import annotations

import torch


def _round_mantissa_rne(x, man_bits: int):
    """Round the fp32 mantissa of ``x`` to ``man_bits`` bits, ties to
    even, in the fp32 bit pattern (carries run into the exponent)."""
    shift = 23 - man_bits
    bits = x.view(torch.int32)
    mask = (1 << shift) - 1
    halfway = 1 << (shift - 1)
    rem = bits & mask
    base = bits & ~mask
    # an arithmetic shift of a negative pattern leaves the low bit intact
    lsb = (base >> shift) & 1
    round_up = (rem > halfway) | ((rem == halfway) & (lsb == 1))
    rounded = base + round_up.to(torch.int32) * (1 << shift)
    return rounded.view(torch.float32)


def float_quantize(x, exp_bits: int, man_bits: int):
    """float32 -> the float(exp_bits, man_bits) format (RNE, subnormals,
    saturation to the largest finite value, no infinities)."""
    x = x.to(torch.float32).contiguous()
    min_exp = -(2 ** (exp_bits - 1) - 2)
    max_exp = 2 ** (exp_bits - 1) - 1
    max_val = (2.0 - 2.0 ** (-man_bits)) * 2.0 ** max_exp
    y = _round_mantissa_rne(x, man_bits)
    if exp_bits < 8:
        # subnormal region: fixed quantum 2^(min_exp - man_bits)
        sub_step = 2.0 ** (min_exp - man_bits)
        y_sub = torch.round(x / sub_step) * sub_step
        y = torch.where(x.abs() < 2.0 ** min_exp, y_sub, y)
    return y.clamp(-max_val, max_val)


def fixed_point_quantize(x, wl: int, fl: int):
    """float32 -> signed fixed point, word length ``wl``, fractional length
    ``fl``: range [-2^(wl-fl-1), 2^(wl-fl-1) - 2^-fl], nearest rounding."""
    x = x.to(torch.float32)
    scale = 2.0 ** fl
    t_min = -(2.0 ** (wl - fl - 1))
    t_max = 2.0 ** (wl - fl - 1) - 2.0 ** (-fl)
    return (torch.round(x * scale) / scale).clamp(t_min, t_max)


def _rows(x, mode, a, b):
    # ops/_kernels.py imports this module for the plain snaps
    from myrtle_vision_tpu_torch.ops import _kernels as K

    return K.for_device(x).fake_quant_rows(x, mode, a, b)


def float_quantize_rows(x, exp_bits: int, man_bits: int):
    """:func:`float_quantize` through K11: the ``fake_quant_rows`` kernel
    for a CUDA tensor, the plain function for a CPU tensor."""
    return _rows(x, "float", exp_bits, man_bits)


def fixed_point_quantize_rows(x, wl: int, fl: int):
    """:func:`fixed_point_quantize` through K11, as
    :func:`float_quantize_rows`."""
    return _rows(x, "fixed", wl, fl)


def snap(x, qspec):
    """The pre_linear-site snap of a float format's ``qspec`` (exp_bits,
    man_bits, all_sites); ``x`` as it is for None (FP32)."""
    if qspec is None:
        return x
    return float_quantize(x, qspec[0], qspec[1])


def snap_all(x, qspec):
    """The post_op / functional / GELU-site snap, which only the
    all-sites format (FP16_16) applies."""
    if qspec is None or not qspec[2]:
        return x
    return float_quantize(x, qspec[0], qspec[1])


def int8_affine_fake_quant(x, scale, zero_point):
    """uint8 affine fake-quant: (clip(rint(x/s) + zp, 0, 255) - zp) * s."""
    q = torch.clamp(torch.round(x / scale) + zero_point, 0.0, 255.0)
    return (q - zero_point) * scale


def int8_symmetric_fake_quant(x, scale):
    """qint8 symmetric per-tensor fake-quant: clip(rint(x/s), -128, 127)
    * s."""
    q = torch.clamp(torch.round(x / scale), -128.0, 127.0)
    return q * scale


class _Int8AffineSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, zero_point):
        return int8_affine_fake_quant(x, scale, zero_point)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Int8SymmetricSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        return int8_symmetric_fake_quant(x, scale)

    @staticmethod
    def backward(ctx, g):
        return g, None


def int8_affine_fake_quant_ste(x, scale, zero_point):
    """:func:`int8_affine_fake_quant` with a straight-through gradient."""
    return _Int8AffineSTE.apply(x, scale, zero_point)


def int8_symmetric_fake_quant_ste(x, scale):
    """:func:`int8_symmetric_fake_quant` with a straight-through
    gradient."""
    return _Int8SymmetricSTE.apply(x, scale)
