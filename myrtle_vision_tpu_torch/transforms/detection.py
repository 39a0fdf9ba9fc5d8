"""Box-aware detection transforms + config-driven pipeline DSL (a copy of
myrtle_vision_tpu/transforms/detection.py; the port imports nothing of
the JAX package).

Torch/torchvision-free re-implementation of the reference's DETR-derived
detection transforms (reference: src/myrtle_vision/transforms/detection.py):
functional crop/hflip/resize/pad that keep the target dict consistent, the
transform classes the JSON DSL exposes, and ``from_config`` which interprets
the ordered transform dict (JSON key order is semantic —
reference detection.py:392-429; PreRandomResize/PostRandomResize map onto
RandomResize via the endswith match, and ``max_size_ratio`` [w, h] caps the
long side at ``max(scales) * w // h``).

Key reference semantics preserved:
  - resize snaps output H and W DOWN to multiples of 16 for patch alignment
    (detection.py:188-207);
  - crop clamps boxes and drops zero-area ones (detection.py:120-158);
  - Normalize converts boxes xyxy -> cxcywh normalized by the image size
    BEFORE padding (detection.py:355-371).

Targets are numpy dicts: boxes (N,4) xyxy absolute float32, labels (N,)
int32, area (N,), iscrowd (N,), orig_size [h,w], size [h,w], image_id.
"""
from __future__ import annotations

import numpy as np
from PIL import Image


# ---------------------------------------------------------------------------
# functional ops
# ---------------------------------------------------------------------------

def hflip(image: Image.Image, target):
    image = image.transpose(Image.FLIP_LEFT_RIGHT)
    w, _ = image.size
    target = dict(target)
    if "boxes" in target and len(target["boxes"]):
        b = target["boxes"]
        target["boxes"] = np.stack(
            [w - b[:, 2], b[:, 1], w - b[:, 0], b[:, 3]], axis=1
        )
    return image, target


def _size_with_aspect_ratio(image_size, size, max_size=None):
    """(w, h) -> output (h, w): min side ~= size, long side capped, both
    snapped down to multiples of 16 (reference detection.py:180-211)."""
    w, h = image_size
    if max_size is not None:
        min_orig = float(min(w, h))
        max_orig = float(max(w, h))
        if max_orig / min_orig * size > max_size:
            size = int(round(max_size * min_orig / max_orig))

    if (w <= h and w == size) or (h <= w and h == size):
        return h - h % 16, w - w % 16

    if w < h:
        ow = size
        oh = int(size * h / w)
    else:
        oh = size
        ow = int(size * w / h)
    return oh - oh % 16, ow - ow % 16


def resize(image: Image.Image, target, size, max_size=None):
    if isinstance(size, (list, tuple)):
        out_size = tuple(size[::-1])
    else:
        out_size = _size_with_aspect_ratio(image.size, size, max_size)
    oh, ow = out_size
    rescaled = image.resize((ow, oh), Image.BILINEAR)
    if target is None:
        return rescaled, None

    rw = rescaled.size[0] / image.size[0]
    rh = rescaled.size[1] / image.size[1]
    target = dict(target)
    if "boxes" in target and len(target["boxes"]):
        target["boxes"] = target["boxes"] * np.array(
            [rw, rh, rw, rh], np.float32
        )
    if "area" in target:
        target["area"] = target["area"] * (rw * rh)
    target["size"] = np.array([oh, ow], np.int64)
    return rescaled, target


def crop(image: Image.Image, target, region):
    """region = (top, left, height, width)."""
    i, j, h, w = region
    image = image.crop((j, i, j + w, i + h))
    target = dict(target)
    target["size"] = np.array([h, w], np.int64)

    fields = [f for f in ("labels", "area", "iscrowd") if f in target]
    if "boxes" in target:
        boxes = target["boxes"] - np.array([j, i, j, i], np.float32)
        boxes = np.minimum(
            boxes.reshape(-1, 2, 2), np.array([w, h], np.float32)
        )
        boxes = np.clip(boxes, 0, None)
        keep = np.all(boxes[:, 1, :] > boxes[:, 0, :], axis=1)
        target["area"] = (boxes[:, 1, :] - boxes[:, 0, :]).prod(axis=1)
        target["boxes"] = boxes.reshape(-1, 4)
        fields.append("boxes")
        for field in fields:
            target[field] = target[field][keep]
    return image, target


def pad_bottom_right(image: Image.Image, target, padding):
    """padding = (pad_right, pad_bottom) (reference detection.py:247-257)."""
    out = Image.new(image.mode, (image.size[0] + padding[0],
                                 image.size[1] + padding[1]))
    out.paste(image, (0, 0))
    if target is None:
        return out, None
    target = dict(target)
    target["size"] = np.array([out.size[1], out.size[0]], np.int64)
    return out, target


# ---------------------------------------------------------------------------
# transform classes (DSL vocabulary)
# ---------------------------------------------------------------------------

class RandomHorizontalFlip:
    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, img, target, rng):
        if rng.random() < self.p:
            return hflip(img, target)
        return img, target


class RandomResize:
    def __init__(self, sizes, max_size=None):
        self.sizes = list(sizes)
        self.max_size = max_size

    def __call__(self, img, target, rng):
        size = self.sizes[int(rng.integers(0, len(self.sizes)))]
        return resize(img, target, size, self.max_size)


class RandomCrop:
    """Fixed-size random crop (reference detection.py:261-267)."""

    def __init__(self, size):
        self.size = size

    def __call__(self, img, target, rng):
        ch, cw = self.size
        top = int(rng.integers(0, max(img.height - ch, 0) + 1))
        left = int(rng.integers(0, max(img.width - cw, 0) + 1))
        return crop(img, target, (top, left, ch, cw))


class RandomSizeCrop:
    def __init__(self, min_size: int, max_size: int):
        self.min_size = min_size
        self.max_size = max_size

    def __call__(self, img, target, rng):
        w = int(rng.integers(self.min_size,
                             min(img.width, self.max_size) + 1))
        h = int(rng.integers(self.min_size,
                             min(img.height, self.max_size) + 1))
        top = int(rng.integers(0, img.height - h + 1))
        left = int(rng.integers(0, img.width - w + 1))
        return crop(img, target, (top, left, h, w))


class CenterCrop:
    def __init__(self, size):
        self.size = size

    def __call__(self, img, target, rng):
        ch, cw = self.size
        top = int(round((img.height - ch) / 2.0))
        left = int(round((img.width - cw) / 2.0))
        return crop(img, target, (top, left, ch, cw))


class RandomPad:
    def __init__(self, max_pad: int):
        self.max_pad = max_pad

    def __call__(self, img, target, rng):
        pad_x = int(rng.integers(0, self.max_pad + 1))
        pad_y = int(rng.integers(0, self.max_pad + 1))
        return pad_bottom_right(img, target, (pad_x, pad_y))


class RandomSelect:
    """transforms1 with probability p, else transforms2
    (reference detection.py:330-342)."""

    def __init__(self, transforms1, transforms2, p=0.5):
        self.transforms1 = transforms1
        self.transforms2 = transforms2
        self.p = p

    def __call__(self, img, target, rng):
        if rng.random() < self.p:
            return self.transforms1(img, target, rng)
        return self.transforms2(img, target, rng)


class ToArray:
    """PIL -> float32 HWC [0,1] (torchvision ToTensor minus CHW)."""

    def __call__(self, img, target, rng):
        return (
            np.asarray(img.convert("RGB"), np.float32) / 255.0,
            target,
        )


class RandomErasing:
    """Erase a random rectangle of the (HWC float) image with probability
    ``p`` — torchvision RandomErasing semantics (reference
    detection.py:346-352 wraps T.RandomErasing); boxes untouched.  Apply
    after ToArray."""

    def __init__(self, p=0.5, scale=(0.02, 0.33), ratio=(0.3, 3.3),
                 value=0.0):
        self.p = p
        self.scale = scale
        self.ratio = ratio
        self.value = value

    def __call__(self, image, target, rng):
        if rng.random() >= self.p:
            return image, target
        h, w = image.shape[0], image.shape[1]
        area = h * w
        for _ in range(10):
            erase_area = area * rng.uniform(*self.scale)
            log_r = rng.uniform(np.log(self.ratio[0]),
                                np.log(self.ratio[1]))
            aspect = np.exp(log_r)
            eh = int(round(np.sqrt(erase_area * aspect)))
            ew = int(round(np.sqrt(erase_area / aspect)))
            if eh < h and ew < w:
                top = int(rng.integers(0, h - eh + 1))
                left = int(rng.integers(0, w - ew + 1))
                image = image.copy()
                image[top : top + eh, left : left + ew] = self.value
                break
        return image, target


class Normalize:
    """Image normalize + boxes xyxy -> normalized cxcywh
    (reference detection.py:355-371)."""

    def __init__(self, mean, std):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, image, target, rng):
        image = (image - self.mean) / self.std
        if target is None:
            return image, None
        target = dict(target)
        h, w = image.shape[0], image.shape[1]
        if "boxes" in target and len(target["boxes"]):
            b = target["boxes"]
            cxcywh = np.stack(
                [
                    (b[:, 0] + b[:, 2]) / 2,
                    (b[:, 1] + b[:, 3]) / 2,
                    b[:, 2] - b[:, 0],
                    b[:, 3] - b[:, 1],
                ],
                axis=1,
            )
            target["boxes"] = cxcywh / np.array([w, h, w, h], np.float32)
        return image, target


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, img, target, rng):
        for t in self.transforms:
            img, target = t(img, target, rng)
        return img, target


# ---------------------------------------------------------------------------
# JSON DSL interpreter (reference detection.py:392-429)
# ---------------------------------------------------------------------------

def from_config(transform_config) -> Compose:
    def _from_config(cfg) -> list:
        transform_list = []
        # JSON object order is semantic (python dicts preserve it)
        for key, value in cfg.items():
            if key == "RandomHorizontalFlip":
                transform_list.append(RandomHorizontalFlip())
            elif key.endswith("RandomResize"):
                scales = value["scales"]
                if value.get("max_size_ratio") is None:
                    max_size = None
                else:
                    w, h = value["max_size_ratio"]
                    max_size = max(scales) * w // h
                transform_list.append(RandomResize(scales, max_size))
            elif key == "RandomSizeCrop":
                min_size, max_size = value
                transform_list.append(RandomSizeCrop(min_size, max_size))
            elif key == "RandomSelect":
                t1, t2 = _from_config(value)
                transform_list.append(RandomSelect(t1, t2))
            elif key == "Normalize":
                transform_list.append(ToArray())
                transform_list.append(
                    Normalize(mean=value["Mean"], std=value["Std"])
                )
            elif key == "Compose":
                transform_list.append(Compose(_from_config(value)))
        return transform_list

    return Compose(_from_config(transform_config))


# ---------------------------------------------------------------------------
# Batch collation: static-shape padding for TPU
# ---------------------------------------------------------------------------

def pad_to_bucket(size: int, granularity=None):
    """Round a spatial dim up to a bucket boundary: bounded set of distinct
    compiled shapes instead of the reference's per-batch max padding
    (NestedTensor, reference detection.py:59-81), which would trigger an XLA
    recompile for every new (H, W).

    Default granularity is the PATCH SIZE (16): the reference's resize
    already snaps H,W down to multiples of 16 (detection.py:188-207), so
    16-granularity reproduces the reference's canvas geometry EXACTLY for
    resize-ending pipelines (the compiled-shape count is bounded by the
    config's scale set, e.g. 23 for DIOR train, 1 for its val).  Round 3
    measured the earlier 128-granularity padding a 160px control to a
    256px canvas — each stack's model only scored on its own geometry
    (cross-stack AP 0.044 -> 0.0017).  Set MVT_COLLATE_BUCKET to coarsen
    when a crop-heavy pipeline produces too many distinct widths; an
    EXPLICIT granularity argument always wins over the env var."""
    import os

    if granularity is None:
        granularity = int(os.environ.get("MVT_COLLATE_BUCKET", 16))
    return -(-size // granularity) * granularity


def collate_detection(items, max_boxes: int = 100, bucket=None):
    """Collate [(image HWC float32, target), ...] into static-shape arrays:

      image: (B, Hb, Wb, 3) zero-padded (the reference model ignores the
             padding mask — vit(imgs.tensors), SURVEY §2.6 note — so zero
             padding matches);
      labels/boxes/valid: padded to ``max_boxes`` (matcher/criterion
             contract);
      sizes: pre-padding (h, w); orig_sizes: original image size (for eval).
    """
    B = len(items)
    hb = pad_to_bucket(max(it[0].shape[0] for it in items), bucket)
    wb = pad_to_bucket(max(it[0].shape[1] for it in items), bucket)
    images = np.zeros((B, hb, wb, 3), np.float32)
    labels = np.zeros((B, max_boxes), np.int32)
    boxes = np.zeros((B, max_boxes, 4), np.float32)
    valid = np.zeros((B, max_boxes), bool)
    sizes = np.zeros((B, 2), np.int32)
    orig_sizes = np.zeros((B, 2), np.int32)
    image_ids = np.zeros((B,), np.int64)
    for b, (img, tgt) in enumerate(items):
        h, w = img.shape[0], img.shape[1]
        images[b, :h, :w] = img
        n = min(len(tgt.get("labels", [])), max_boxes)
        if n:
            labels[b, :n] = tgt["labels"][:n]
            boxes[b, :n] = tgt["boxes"][:n]
            valid[b, :n] = True
        sizes[b] = [h, w]
        orig_sizes[b] = tgt.get("orig_size", [h, w])
        image_ids[b] = int(np.asarray(tgt.get("image_id", b)).reshape(()))
    return {
        "image": images,
        "labels": labels,
        "boxes": boxes,
        "valid": valid,
        "size": sizes,
        "orig_size": orig_sizes,
        "image_id": image_ids,
    }
