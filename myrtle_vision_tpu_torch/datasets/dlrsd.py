"""DLRSD semantic segmentation dataset (a copy of
myrtle_vision_tpu/datasets/dlrsd.py; the port imports nothing of the JAX
package).

Re-implementation of the reference dataset
(reference: src/myrtle_vision/datasets/dlrsd.py): image / segmap path
pairs from a CSV split file, joint geometric transforms on both,
photometric ones on the image only.  The stored masks are 1-based, so
labels are shifted by -1 (reference dlrsd.py:80): a stored 0 becomes -1,
which no class takes.
"""
from __future__ import annotations

import os
import random

import numpy as np
from PIL import Image

from myrtle_vision_tpu_torch.transforms.segmentation import (
    common_transform_from_config,
    image_transform_from_config,
)
from myrtle_vision_tpu_torch.utils.config import load_imagepaths_and_segmaps


class Dlrsd:
    def __init__(
        self,
        mode,
        dataset_path,
        imagepaths,
        label_map_path,
        transform_config,
    ):
        if mode not in ["train", "eval", "test"]:
            raise ValueError(f"unknown mode={mode}")
        self.mode = mode
        self.dataset_path = dataset_path
        self.imagepaths_and_segmaps = load_imagepaths_and_segmaps(
            dataset_path, imagepaths
        )
        self.label_map_path = label_map_path
        if self.mode == "train":
            # the reference shuffles once at init, with Python's random
            random.shuffle(self.imagepaths_and_segmaps)
        self.common_transform = common_transform_from_config(transform_config)
        self.image_transform = image_transform_from_config(transform_config)

    def __getitem__(self, index, rng=None):
        """{"image": float32 (H, W, 3), "label": int32 (H, W)}, the
        transforms drawing from ``rng`` (a numpy Generator)."""
        if rng is None:
            rng = np.random.default_rng()
        img_path, segmap_path = self.imagepaths_and_segmaps[index]
        image = Image.open(os.path.join(self.dataset_path, img_path))
        segmap = Image.open(os.path.join(self.dataset_path, segmap_path))

        image, segmap = self.common_transform((image, segmap), rng)
        image = self.image_transform(image, rng)
        label = np.asarray(segmap, dtype=np.int32) - 1
        return {"image": image.astype(np.float32), "label": label}

    def __len__(self):
        return len(self.imagepaths_and_segmaps)
