"""Joint image + segmap transforms for segmentation (torchvision-free; a
copy of myrtle_vision_tpu/transforms/segmentation.py).

Reimplements the reference's pair transforms
(reference: src/myrtle_vision/transforms/segmentation.py): geometric ops
apply identically to image and mask (nearest neighbour for the mask, so
that labels stay classes; bilinear for the image in
RandomResizedCropBoth), photometric ops to the image only.  Every draw
comes from the numpy ``rng`` the loader hands each item, in the JAX
copy's order, so that both packages yield the same pixels.
"""
from __future__ import annotations

from PIL import Image

from myrtle_vision_tpu_torch.transforms.classification import (
    Normalize,
    ToArray,
    random_resized_crop_params,
)


class ResizeBoth:
    """Resize both with NEAREST (reference segmentation.py:15-25)."""

    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, sample, rng):
        image, label = sample
        return (
            image.resize(self.size[::-1], Image.NEAREST),
            label.resize(self.size[::-1], Image.NEAREST),
        )


class RandomHorizontalFlipBoth:
    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, sample, rng):
        if rng.random() < self.p:
            image, label = sample
            return (
                image.transpose(Image.FLIP_LEFT_RIGHT),
                label.transpose(Image.FLIP_LEFT_RIGHT),
            )
        return sample


class RandomResizedCropBoth:
    """One crop window for both; bilinear image, nearest mask (reference
    segmentation.py:38-104; its scale default is (0.5, 1.0), unlike
    classification's (0.08, 1.0)).  The window comes from the true (w, h)
    of the image, as in the JAX copy."""

    def __init__(
        self, size, scale=(0.5, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0)
    ):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.scale = scale
        self.ratio = ratio

    def __call__(self, sample, rng):
        image, segmap = sample
        i, j, h, w = random_resized_crop_params(
            rng, image.size[0], image.size[1], self.scale, self.ratio
        )
        box = (j, i, j + w, i + h)
        image = image.crop(box).resize(self.size[::-1], Image.BILINEAR)
        segmap = segmap.crop(box).resize(self.size[::-1], Image.NEAREST)
        return image, segmap


class ComposeBoth:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, sample, rng):
        for t in self.transforms:
            sample = t(sample, rng)
        return sample


def common_transform_from_config(transform_config) -> ComposeBoth:
    """Geometric pair pipeline from the config dict
    (reference dlrsd.py:39-55)."""
    ops = []
    if "Resize" in transform_config:
        ops.append(ResizeBoth(transform_config["Resize"]))
    if "RandomResizedCrop" in transform_config:
        ops.append(RandomResizedCropBoth(transform_config["RandomResizedCrop"]))
    if "RandomHorizontalFlip" in transform_config:
        ops.append(RandomHorizontalFlipBoth())
    return ComposeBoth(ops)


def image_transform_from_config(transform_config):
    """Photometric (image-only) pipeline (reference dlrsd.py:57-69):
    float32 HWC in [0, 1], then Normalize when configured."""
    ops = [ToArray()]
    if "Normalize" in transform_config:
        cfg = transform_config["Normalize"]
        ops.append(Normalize(cfg["Mean"], cfg["Std"]))

    def apply(img, rng):
        for op in ops:
            img = op(img, rng)
        return img

    return apply
