"""RESISC45 classification dataset (a copy of
myrtle_vision_tpu/datasets/resisc45.py; the port imports nothing of the
JAX package).

Re-implementation of the reference dataset
(reference: src/myrtle_vision/datasets/resisc45.py): reads
``*_imagepaths.txt`` split files (image path + label from the directory
name), a ``label_map.json``, and applies the config-driven transform
pipeline.  Improvements over the reference kept behaviour-compatible:

- the label map is loaded once at construction instead of being re-read
  from disk on every item (reference resisc45.py:74-80 re-opens the JSON
  per __getitem__);
- items take an explicit numpy Generator so augmentation is reproducible
  and thread-safe under the parallel loader;
- ``MVT_DECODE_CACHE=1`` keeps decoded RGB images in RAM after the first
  epoch (multi-epoch training re-decodes every JPEG otherwise; on a
  single-core host the decode is a large share of input-pipeline time,
  and RESISC45-sized datasets decode to well under a GB).
"""
from __future__ import annotations

import os
import random

import numpy as np
from PIL import Image

from myrtle_vision_tpu_torch.transforms.classification import (
    transform_from_config,
)
from myrtle_vision_tpu_torch.utils.config import (
    load_imagepaths_and_labels,
    load_label_map,
)


class Resisc45:
    def __init__(
        self,
        mode,
        dataset_path,
        imagepaths,
        label_map_path,
        transform_config,
    ):
        if mode not in ["train", "eval"]:
            raise ValueError(f"unknown mode={mode}")
        self.mode = mode
        self.dataset_path = dataset_path
        self.imagepaths_and_labels = load_imagepaths_and_labels(
            dataset_path, imagepaths
        )
        self.label_map = load_label_map(dataset_path, label_map_path)
        if self.mode == "train":
            # reference shuffles once at init (resisc45.py:34-35)
            random.shuffle(self.imagepaths_and_labels)
        self.transform = transform_from_config(transform_config)
        self._cache = (
            {} if os.environ.get("MVT_DECODE_CACHE") == "1" else None
        )

    def _load(self, img_path):
        if self._cache is not None:
            arr = self._cache.get(img_path)
            if arr is None:
                img = Image.open(
                    os.path.join(self.dataset_path, img_path)
                ).convert("RGB")
                arr = np.asarray(img)
                self._cache[img_path] = arr
            return Image.fromarray(arr)
        # convert to RGB before the geometric transforms in BOTH paths so
        # MVT_DECODE_CACHE stays a pure performance switch (resampling in
        # palette/grayscale mode then converting yields different pixels)
        return Image.open(
            os.path.join(self.dataset_path, img_path)
        ).convert("RGB")

    def __getitem__(self, index, rng=None):
        if rng is None:
            rng = np.random.default_rng()
        img_path, text_label = self.imagepaths_and_labels[index]
        img = self._load(img_path)
        arr = self.transform(img, rng)
        return {
            "image": arr.astype(np.float32),
            "label": np.int32(self.label_map[text_label]),
        }

    def __len__(self):
        return len(self.imagepaths_and_labels)
