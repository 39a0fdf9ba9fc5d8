"""Quantization: the formats, the INT8 observers and convert (port of
myrtle_vision_tpu/quantize.py).

- :class:`QFormat` and :class:`NumberFormat` as in the JAX package, with
  the stateless float formats' tables :func:`act_number_format` (the
  format of each activation site), :func:`weight_number_format` and
  :data:`QSPECS` (the fused block halves' ``qspec``).
- :func:`act_quant`: a site of a stateless float format (FP16_16,
  FP16_32, TF32), a plain function of its input with no state (the JAX
  float models have no ``quant`` collection), the fake-quant through K11
  (``fake_quant_rows``) on the card.
- :class:`ActQuant`: one PyTorchINT8 activation site, an ``nn.Module``
  with ``min`` and ``max`` fp32 buffers (a torch MinMaxObserver).  Called
  with ``calibrating=True`` it folds its input into the running min/max
  first; then, once it has statistics, it applies the uint8 affine
  fake-quant of those statistics.  The JAX package keeps the same
  numbers in its ``quant`` collection.
- :func:`quantize_weight`, :func:`convert_params` and
  :func:`model_size_mb` act on the port's state dict (reference names,
  torch (out, in) Linear weights): convert makes the weight quantization
  real, int8 Linear weights with a per-tensor fp32 ``weight_scale`` for
  PyTorchINT8, fp16 storage for FP16_16 / FP16_32.

Post-training quantization runs in every format, and QAT training too
(the sites and weights straight-through, as in the JAX package): in
PyTorchINT8 the two-pass step, a calibrating pass that updates the
observers and a differentiated pass with them frozen
(training/classification.py).
"""
from __future__ import annotations

import enum

import torch
import torch.distributed as dist
from torch import nn

from myrtle_vision_tpu_torch.ops import fake_quant as fq

_EPS = 1.1920929e-7  # torch's observer scale guard (fp32 epsilon)


class QFormat(enum.IntEnum):
    """Quantization formats of the ViT (reference quantize.py:13-21)."""

    FP32 = 0
    PyTorchINT8 = 1
    FP16_16 = 2
    FP16_32 = 3
    TF32 = 4


class NumberFormat(enum.Enum):
    """Number formats the fake-quant primitives simulate (reference
    quantize.py:23-74)."""

    SymmetricInt8 = enum.auto()
    AsymmetricInt8 = enum.auto()
    HalfPrecisionFloat = enum.auto()
    SinglePrecisionFloat = enum.auto()
    TensorFloat32 = enum.auto()
    FixedPoint11Integral2 = enum.auto()
    FixedPoint11Integral3 = enum.auto()
    FixedPoint11Integral4 = enum.auto()

    def quantize(self, x, plain: bool = False):
        """The format's fake-quant with a straight-through gradient: K11
        for a CUDA tensor unless ``plain``, the plain function
        otherwise."""
        flt, fixed = fq.float_quantize_ste, fq.fixed_point_quantize_ste
        if self == NumberFormat.HalfPrecisionFloat:
            return flt(x, 5, 10, plain)
        if self == NumberFormat.SinglePrecisionFloat:
            return x
        if self == NumberFormat.TensorFloat32:
            return flt(x, 8, 10, plain)
        if self == NumberFormat.FixedPoint11Integral2:
            return fixed(x, 11, 9, plain)
        if self == NumberFormat.FixedPoint11Integral3:
            return fixed(x, 11, 8, plain)
        if self == NumberFormat.FixedPoint11Integral4:
            return fixed(x, 11, 7, plain)
        raise NotImplementedError(self)


_FP16 = NumberFormat.HalfPrecisionFloat
_TF32 = NumberFormat.TensorFloat32
# (q_format, site) -> the activation format of a stateless float format
# (reference quantize.py:46-74, the _prepare_qat_* site lists)
_ACT_TABLE = {
    QFormat.FP16_16: {"pre_linear": _FP16, "post_op": _FP16,
                      "functional": _FP16, "gelu_in": _FP16,
                      "gelu_out": _FP16},
    QFormat.FP16_32: {"pre_linear": _FP16},
    QFormat.TF32: {"pre_linear": _TF32},
}
# the fused block halves' (exp_bits, man_bits, all_sites) of each stateless
# float format (the JAX Block's _QSPECS); FP32 and PyTorchINT8 have none
QSPECS = {QFormat.FP16_16: (5, 10, True), QFormat.FP16_32: (5, 10, False),
          QFormat.TF32: (8, 10, False)}


def act_number_format(q_format, site: str):
    """The stateless activation format of a site, or None (identity)."""
    return _ACT_TABLE.get(q_format, {}).get(site)


def act_quant(x, q_format, site: str, plain: bool = False):
    """A stateless float format's activation site: ``x`` through its
    format's fake-quant (K11 on the card unless ``plain``;
    straight-through), or as it is where the format leaves the site
    alone."""
    fmt = act_number_format(q_format, site)
    return x if fmt is None else fmt.quantize(x.float(), plain).to(x.dtype)


def weight_number_format(q_format, kind: str, converted: bool):
    """Weight format of a Linear ('linear') or LayerNorm ('norm')
    parameter of a stateless float format: Linear weights always,
    LayerNorm weights only after convert (reference quantize.py:146-166)."""
    if q_format in (QFormat.FP16_16, QFormat.FP16_32):
        fmt = NumberFormat.HalfPrecisionFloat
    elif q_format == QFormat.TF32:
        fmt = NumberFormat.TensorFloat32
    else:
        return None
    if kind == "linear" or (kind == "norm" and converted):
        return fmt
    return None


def affine_uint8_qparams(min_val, max_val):
    """(scale, zero_point) of quint8 affine, reduce_range False (torch
    MinMaxObserver, reference quantize.py:242-244)."""
    min_v = torch.clamp(min_val, max=0.0)
    max_v = torch.clamp(max_val, min=0.0)
    scale = torch.clamp((max_v - min_v) / 255.0, min=_EPS)
    zero_point = torch.clamp(torch.round(-min_v / scale), 0.0, 255.0)
    # + 0.0 turns the -0 of a zero minimum into +0, as jnp.clip gives it
    return scale, zero_point + 0.0


def symmetric_int8_scale(max_abs):
    """Scale of qint8 per_tensor_symmetric (torch semantics)."""
    return torch.clamp(max_abs / 127.5, min=_EPS)


class ActQuant(nn.Module):
    """A PyTorchINT8 activation site: running min/max observers (buffers
    ``min`` and ``max``, fp32 scalars, +inf / -inf until the first
    calibration batch) and the uint8 affine fake-quant of their grid."""

    def __init__(self, device=None):
        super().__init__()
        self.register_buffer("min", torch.tensor(float("inf"),
                                                 device=device))
        self.register_buffer("max", torch.tensor(float("-inf"),
                                                 device=device))

    def int8_qparams(self):
        """(scale, zero_point, has_stats) from the running observers."""
        scale, zp = affine_uint8_qparams(self.min, self.max)
        return scale, zp, self.min <= self.max

    def forward(self, x, calibrating: bool = False, group=None):
        """``x`` through the site (its statistics folded in first when
        ``calibrating``).  ``group``: ``x`` is this rank's slice of a
        tensor split over that process group (tensor parallelism's
        local columns), so the slices' MIN / MAX over the group is what
        the site folds in, before it snaps, as an observer of the whole
        tensor does."""
        if calibrating:
            with torch.no_grad():
                xf = x.detach().float()
                lo, hi = xf.min(), xf.max()
                if group is not None:
                    both = torch.stack([lo, -hi])
                    dist.all_reduce(both, op=dist.ReduceOp.MIN, group=group)
                    lo, hi = both[0], -both[1]
                torch.minimum(self.min, lo, out=self.min)
                torch.maximum(self.max, hi, out=self.max)
        scale, zp, has = self.int8_qparams()
        q = fq.int8_affine_fake_quant_ste(x.float(), scale, zp).to(x.dtype)
        return torch.where(has, q, x)


def site_row(observer: ActQuant):
    """(3,) fp32 (scale, zero point, has_stats as 1 or 0) of an observer:
    a row of the site tables the converted-INT8 ops take."""
    scale, zp, has = observer.int8_qparams()
    return torch.stack([scale, zp, has.float()])


def quantize_weight(w, q_format, kind: str, converted: bool,
                    plain: bool = False):
    """Weight fake-quant of a Linear ('linear') or LayerNorm ('norm')
    parameter.  PyTorchINT8 Linear weights take a symmetric int8 scale
    from their current range (torch's QAT weight observer re-observes
    every step); the float formats their number format, through K11 on
    the card unless ``plain``; both straight-through."""
    if q_format == QFormat.PyTorchINT8 and kind == "linear":
        wf = w.float()
        scale = symmetric_int8_scale(wf.abs().max())
        return fq.int8_symmetric_fake_quant_ste(wf, scale).to(w.dtype)
    fmt = weight_number_format(q_format, kind, converted)
    if fmt is None:
        return w
    return fmt.quantize(w.float(), plain).to(w.dtype)


def is_observer(name: str) -> bool:
    """Whether a state-dict entry is an ActQuant buffer."""
    return name.endswith((".min", ".max")) or name in ("min", "max")


def convert_params(state_dict, q_format):
    """A state dict with the weight quantization made real (reference
    ModelQuantizer.convert, quantize.py:121-166, 329-348); observer
    buffers pass through.

    - PyTorchINT8: each Linear weight (a 2-D ``*.weight``) becomes int8,
      clip(rint(w / s), -128, 127), with ``*.weight_scale`` =
      max(max|w| / 127.5, eps) beside it, fp32.
    - FP16_16 / FP16_32: Linear and LayerNorm weights (1-D ``*.weight``)
      through the e5m10 fake-quant, stored as fp16.
    - TF32: the same through e8m10, kept fp32 (19 significant bits do
      not fit 16).

    Load the result into a ``converted=True`` model.
    """
    q_format = QFormat[q_format] if isinstance(q_format, str) else q_format
    if q_format == QFormat.FP32:
        return dict(state_dict)
    out = {}
    for name, t in state_dict.items():
        if not name.endswith(".weight") or t.dim() not in (1, 2):
            out[name] = t
            continue
        kind = "linear" if t.dim() == 2 else "norm"
        w = t.float()
        if q_format == QFormat.PyTorchINT8:
            if kind == "norm":
                out[name] = t
                continue
            scale = symmetric_int8_scale(w.abs().max())
            out[name] = torch.clamp(torch.round(w / scale), -128,
                                    127).to(torch.int8)
            out[name[:-len("weight")] + "weight_scale"] = scale
            continue
        baked = quantize_weight(w, q_format, kind, converted=True)
        if q_format in (QFormat.FP16_16, QFormat.FP16_32):
            baked = baked.to(torch.float16)
        out[name] = baked
    return out


def model_size_mb(tensors) -> float:
    """Bytes of every tensor of a state dict (or any iterable of tensors)
    in MB, the size torch.save writes up to its framing (reference
    test_quantize.py:19-23).  After :func:`convert_params` the low
    precision storage is real, so this is the converted size."""
    if isinstance(tensors, dict):
        tensors = tensors.values()
    return sum(t.numel() * t.element_size() for t in tensors) / 1e6
