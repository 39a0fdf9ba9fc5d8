"""Config parsing, seeding, batch-size arithmetic and the RESISC and
DLRSD split files: the helpers of myrtle_vision_tpu/utils/config.py
that the port's CLIs and datasets call, copied (the port imports nothing
of the JAX package).  The JSON config schema is the reference's, so the
configs run unchanged.
"""
from __future__ import annotations

import json
import os
import random

import numpy as np


def parse_config(config_path):
    """Load a JSON config file (reference: utils/utils.py:70-73)."""
    with open(config_path) as f:
        return json.loads(f.read())


def seed_everything(seed: int) -> None:
    """Seed python and numpy RNGs (reference: utils/utils.py:76-83).  The
    port's device randomness takes explicit ``torch.Generator``s derived
    from the same seed."""
    random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    np.random.seed(seed)


def get_batch_sizes(target_batch, num_devices, global_batch, verbose=False):
    """(local micro-batch, n_batch_accum) from the target local batch,
    device count and requested global batch, with the reference's rules
    (utils/utils.py:86-125):

    * If ``global_batch`` is a multiple of ``num_devices * target_batch``,
      use the target batch and accumulate the remaining factor.
    * Else, if ``global_batch`` divides evenly over the devices, fall back to
      the largest per-device micro-batch <= target that divides the
      per-device share.
    * Else raise, so that experiments stay comparable.
    """
    target_samples_per_batch = (
        num_devices * target_batch if num_devices > 0 else target_batch
    )
    if global_batch % target_samples_per_batch == 0:
        return target_batch, global_batch // target_samples_per_batch
    elif num_devices > 0 and global_batch % num_devices == 0:
        samples_per_device = global_batch // num_devices
        samples_per_minibatch = target_batch - 1
        while samples_per_device % samples_per_minibatch != 0:
            samples_per_minibatch -= 1
        n_batch_accum = samples_per_device // samples_per_minibatch
        if verbose:
            print(
                "WARNING: Did not select preferred max local batch size "
                f"{target_batch}; using a local batch size of "
                f"{samples_per_minibatch} instead"
            )
        return samples_per_minibatch, n_batch_accum
    else:
        raise ValueError(
            "WARNING: Could not fulfill the desired global batch size of "
            f"{global_batch} as it is not divisible by the number of devices "
            f"available ({num_devices})\nPlease update the global_batch_size "
            "parameter in your config file or change the number of devices "
            "available"
        )


def load_imagepaths_and_labels(dataset_path, imagepaths):
    """List of [image path, text label] pairs, label taken from the directory
    name inside the path (reference: utils/utils.py:33-46)."""
    imagepaths_filepath = os.path.join(dataset_path, imagepaths)
    with open(imagepaths_filepath, encoding="utf-8") as paths_file:
        return [[line.strip(), line.split("/")[1]] for line in paths_file]


def load_imagepaths_and_segmaps(dataset_path, imagepaths):
    """List of [image path, segmap path] pairs from a CSV split file
    (reference: utils/utils.py:11-30)."""
    imagepaths_filepath = os.path.join(dataset_path, imagepaths)
    pairs = []
    with open(imagepaths_filepath, encoding="utf-8") as paths_file:
        for line in paths_file:
            parts = line.split(",")
            pairs.append([parts[0], parts[1].strip("\n")])
    return pairs


def load_label_map(dataset_path, label_map_path):
    """Load the {text label: index} map once."""
    full_labelmap_path = os.path.join(dataset_path, label_map_path)
    with open(full_labelmap_path, encoding="utf-8") as f:
        return json.load(f)


def get_label_list(dataset_path, label_map_path):
    """Ordered list of text labels (reference: utils/utils.py:59-67)."""
    labelmap = load_label_map(dataset_path, label_map_path)
    return sorted(labelmap, key=labelmap.get)
