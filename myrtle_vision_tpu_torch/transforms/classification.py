"""Host-side image transforms for classification (torchvision-free; a
copy of myrtle_vision_tpu/transforms/classification.py).

Reimplements the transform ops the Resisc45 dataset builds from its
``transform_ops_*`` config dict (reference:
src/myrtle_vision/datasets/resisc45.py:39-69) with PIL + numpy, preserving
op order and semantics:

  Resize -> RandomResizedCrop -> CenterCrop -> RandomHorizontalFlip ->
  ToTensor -> Normalize

Output is float32 NHWC in [0, 1] before Normalize (torchvision's ToTensor
scales by 1/255), channel-last — the TPU-native layout.
"""
from __future__ import annotations

import math

import numpy as np
from PIL import Image

_BILINEAR = Image.BILINEAR


class Resize:
    """Resize to (size, size) (reference resisc45.py:45-50)."""

    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, img: Image.Image, rng) -> Image.Image:
        return img.resize(self.size[::-1], _BILINEAR)


class CenterCrop:
    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, img, rng):
        w, h = img.size
        th, tw = self.size
        left = int(round((w - tw) / 2.0))
        top = int(round((h - th) / 2.0))
        return img.crop((left, top, left + tw, top + th))


def random_resized_crop_params(
    rng, width, height, scale=(0.08, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0)
):
    """torchvision RandomResizedCrop.get_params: 10 tries of area/ratio
    sampling, central-crop fallback."""
    area = height * width
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(scale[0], scale[1])
        aspect_ratio = math.exp(rng.uniform(log_ratio[0], log_ratio[1]))
        w = int(round(math.sqrt(target_area * aspect_ratio)))
        h = int(round(math.sqrt(target_area / aspect_ratio)))
        if 0 < w <= width and 0 < h <= height:
            i = rng.integers(0, height - h + 1)
            j = rng.integers(0, width - w + 1)
            return int(i), int(j), h, w
    # fallback: central crop at a valid aspect ratio
    in_ratio = float(width) / float(height)
    if in_ratio < min(ratio):
        w = width
        h = int(round(w / min(ratio)))
    elif in_ratio > max(ratio):
        h = height
        w = int(round(h * max(ratio)))
    else:
        w, h = width, height
    i = (height - h) // 2
    j = (width - w) // 2
    return i, j, h, w


class RandomResizedCrop:
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0)):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.scale = scale
        self.ratio = ratio

    def __call__(self, img, rng):
        i, j, h, w = random_resized_crop_params(
            rng, img.size[0], img.size[1], self.scale, self.ratio
        )
        img = img.crop((j, i, j + w, i + h))
        return img.resize(self.size[::-1], _BILINEAR)


class RandomHorizontalFlip:
    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, img, rng):
        if rng.random() < self.p:
            return img.transpose(Image.FLIP_LEFT_RIGHT)
        return img


class ToArray:
    """PIL -> float32 HWC in [0, 1] (torchvision ToTensor, minus the CHW
    permute — we keep NHWC for TPU)."""

    def __call__(self, img, rng):
        arr = np.asarray(img.convert("RGB"), dtype=np.float32) / 255.0
        return arr


class Normalize:
    def __init__(self, mean, std):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, arr, rng):
        return (arr - self.mean) / self.std


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, img, rng):
        for t in self.transforms:
            img = t(img, rng)
        return img


def transform_from_config(transform_config) -> Compose:
    """Build the pipeline from the config dict with the reference's fixed op
    order (reference resisc45.py:39-69)."""
    ops = []
    if "Resize" in transform_config:
        ops.append(Resize(transform_config["Resize"]))
    if "RandomResizedCrop" in transform_config:
        ops.append(RandomResizedCrop(transform_config["RandomResizedCrop"]))
    if "CenterCrop" in transform_config:
        ops.append(CenterCrop(transform_config["CenterCrop"]))
    if "RandomHorizontalFlip" in transform_config:
        ops.append(RandomHorizontalFlip())
    ops.append(ToArray())
    if "Normalize" in transform_config:
        cfg = transform_config["Normalize"]
        ops.append(Normalize(cfg["Mean"], cfg["Std"]))
    return Compose(ops)
