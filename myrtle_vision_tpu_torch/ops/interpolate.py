"""Resizes of NHWC grids: the bicubic positional-embedding rescale and
the segmentation head's bilinear upsample.

The JAX package emulates torch's bicubic (A = -0.75, half-pixel centres,
``align_corners=False``, edge clamp, no antialiasing) as two constant
weight matmuls (myrtle_vision_tpu/ops/interpolate.py); here torch's own
``interpolate`` computes the same thing.  The bilinear resize keeps the
JAX form, two constant fp32 matrices applied to the NHWC logits (torch's
``interpolate(mode="bilinear", align_corners=False)``), so that its
gradient is the transpose of the same matrices.  XLA runs these in the
JAX package, not a Pallas kernel, so neither is a kernel here.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from myrtle_vision_tpu_torch.ops.high_precision import _fp32_products


def resize_bicubic(img, out_h: int, out_w: int):
    """(B, H, W, C) -> (B, out_h, out_w, C), fp32."""
    x = img.float().permute(0, 3, 1, 2)
    x = F.interpolate(x, size=(out_h, out_w), mode="bicubic",
                      align_corners=False)
    return x.permute(0, 2, 3, 1)


@functools.lru_cache(maxsize=None)
def _linear_resize_matrix(src: int, dst: int) -> np.ndarray:
    """(dst, src) bilinear weight matrix, half-pixel centres, edge clamp:
    torch ``interpolate(mode='bilinear', align_corners=False)``."""
    scale = src / dst
    out_coord = (np.arange(dst) + 0.5) * scale - 0.5
    base = np.floor(out_coord).astype(np.int64)
    frac = out_coord - base
    w = np.zeros((dst, src), np.float64)
    for offset in range(2):
        idx = np.clip(base + offset, 0, src - 1)
        weight = np.where(offset == 0, 1.0 - frac, frac)
        np.add.at(w, (np.arange(dst), idx), weight)
    return w.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _linear_resize_weights(src: int, dst: int, device) -> torch.Tensor:
    """:func:`_linear_resize_matrix` as an fp32 tensor on ``device``, copied
    there once (a copy from pageable host memory on every call could hold
    the host until the device drains its queue); made outside inference
    mode, so that a first call under ``torch.inference_mode`` (an eval
    forward) caches a tensor that autograd may save later."""
    with torch.inference_mode(False):
        return torch.from_numpy(_linear_resize_matrix(src, dst)).to(device)


def resize_bilinear(img, out_h: int, out_w: int):
    """torch-exact bilinear resize of (..., H, W, C) to (..., out_h, out_w,
    C), fp32 and differentiable: ``W_h @ img @ W_w^T`` as two einsums in
    full fp32 (no TF32 on the card)."""
    h, w = img.shape[-3], img.shape[-2]
    wh = _linear_resize_weights(h, out_h, img.device)
    ww = _linear_resize_weights(w, out_w, img.device)
    with _fp32_products():
        out = torch.einsum("oh,...hwc->...owc", wh, img.float())
        return torch.einsum("pw,...owc->...opc", ww, out)
