"""COCO-format detection dataset, without pycocotools (a copy of
myrtle_vision_tpu/datasets/coco.py; the port imports nothing of the JAX
package).

The reference wraps torchvision's CocoDetection (pycocotools C extension)
and converts annotations to training targets (reference:
src/myrtle_vision/datasets/coco.py).  Here a small pure-python index over
the COCO JSON replaces the pycocotools API surface our stack needs
(images/annotations/categories lookups), and ``prepare`` reproduces the
reference target conversion exactly (coco.py:31-80):

  - drop crowd annotations;
  - xywh -> xyxy, clamped to the image;
  - drop degenerate boxes (x1<=x0 or y1<=y0);
  - keep labels/area/iscrowd/orig_size/size/image_id.
"""
from __future__ import annotations

import json
import os

import numpy as np
from PIL import Image


class CocoIndex:
    """Minimal COCO annotation index (pycocotools.COCO replacement)."""

    def __init__(self, ann_file_or_dict):
        if isinstance(ann_file_or_dict, str):
            with open(ann_file_or_dict) as f:
                data = json.load(f)
        else:
            data = ann_file_or_dict
        self.dataset = data
        self.imgs = {img["id"]: img for img in data.get("images", [])}
        self.cats = {c["id"]: c for c in data.get("categories", [])}
        self.img_anns = {img_id: [] for img_id in self.imgs}
        for ann in data.get("annotations", []):
            self.img_anns.setdefault(ann["image_id"], []).append(ann)

    def get_img_ids(self):
        return sorted(self.imgs)

    def get_cat_ids(self):
        return sorted(self.cats)

    def load_anns(self, img_id):
        return self.img_anns.get(img_id, [])


def prepare(image: Image.Image, image_id: int, annotations: list):
    """COCO anns -> target dict (reference coco.py:31-80)."""
    w, h = image.size
    anns = [a for a in annotations if a.get("iscrowd", 0) == 0]

    boxes = np.asarray(
        [a["bbox"] for a in anns], np.float32
    ).reshape(-1, 4)
    boxes[:, 2:] += boxes[:, :2]  # xywh -> xyxy
    boxes[:, 0::2] = boxes[:, 0::2].clip(0, w)
    boxes[:, 1::2] = boxes[:, 1::2].clip(0, h)

    classes = np.asarray(
        [a["category_id"] for a in anns], np.int32
    ).reshape(-1)
    area = np.asarray([a["area"] for a in anns], np.float32).reshape(-1)
    iscrowd = np.asarray(
        [a.get("iscrowd", 0) for a in anns], np.int32
    ).reshape(-1)

    keep = (boxes[:, 3] > boxes[:, 1]) & (boxes[:, 2] > boxes[:, 0])
    target = {
        "boxes": boxes[keep],
        "labels": classes[keep],
        "area": area[keep],
        "iscrowd": iscrowd[keep],
        "image_id": np.int64(image_id),
        "orig_size": np.array([h, w], np.int64),
        "size": np.array([h, w], np.int64),
    }
    return image, target


class CocoDetection:
    """Images + prepared/transformed targets from a COCO directory.

    ``subset``: optional number of images to randomly sample (reference
    detection/train.py:126-146 uses torch Subset with a seeded randperm).
    """

    def __init__(
        self, img_folder, ann_file, transforms, subset=None, subset_seed=42
    ):
        self.img_folder = img_folder
        self.coco = CocoIndex(ann_file)
        self.ids = self.coco.get_img_ids()
        if subset is not None and subset < len(self.ids):
            rng = np.random.RandomState(subset_seed)
            chosen = rng.permutation(len(self.ids))[:subset]
            self.ids = [self.ids[i] for i in sorted(chosen)]
        self._transforms = transforms

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, idx, rng=None):
        if rng is None:
            rng = np.random.default_rng()
        image_id = self.ids[idx]
        info = self.coco.imgs[image_id]
        img = Image.open(
            os.path.join(self.img_folder, info["file_name"])
        ).convert("RGB")
        img, target = prepare(img, image_id, self.coco.load_anns(image_id))
        if self._transforms is not None:
            img, target = self._transforms(img, target, rng)
        return img, target
