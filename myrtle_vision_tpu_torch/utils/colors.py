"""DLRSD 17-class colour palette and mask colourisation for segmentation
visualisation (a copy of myrtle_vision_tpu/utils/colors.py; reference:
src/myrtle_vision/utils/colors.py:2-22, the dataset's published class
colours).

The class order is the 0-based label ids of the Dlrsd dataset (stored
1-based on disk, shifted by -1 at load).
"""
from __future__ import annotations

import numpy as np

# label id -> (class name, RGB)
DLRSD_CLASSES = (
    ("airplane", (166, 202, 240)),
    ("bare soil", (128, 128, 0)),
    ("buildings", (0, 0, 128)),
    ("cars", (255, 0, 0)),
    ("chaparral", (0, 128, 0)),
    ("court", (128, 0, 0)),
    ("dock", (255, 233, 233)),
    ("field", (160, 160, 164)),
    ("grass", (0, 128, 128)),
    ("mobile home", (90, 87, 255)),
    ("pavement", (255, 255, 0)),
    ("sand", (255, 192, 0)),
    ("sea", (0, 0, 255)),
    ("ship", (255, 0, 192)),
    ("tanks", (128, 0, 128)),
    ("trees", (0, 255, 0)),
    ("water", (0, 255, 255)),
)


def dlrsd_colors() -> dict:
    """{class name: [r, g, b]} (reference colors.py:1-22 API)."""
    return {name: list(rgb) for name, rgb in DLRSD_CLASSES}


def palette() -> np.ndarray:
    """(17, 3) uint8 palette indexed by 0-based label id."""
    return np.array([rgb for _, rgb in DLRSD_CLASSES], np.uint8)


def colorize_mask(mask) -> np.ndarray:
    """(H, W) int 0-based label mask -> (H, W, 3) uint8 RGB image; a label
    outside the palette takes the nearest end's colour."""
    mask = np.asarray(mask)
    pal = palette()
    return pal[np.clip(mask, 0, len(pal) - 1)]
