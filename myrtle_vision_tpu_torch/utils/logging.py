"""Scalar logging: TensorBoard when available, JSONL fallback (a copy of
myrtle_vision_tpu/utils/logging.py, which imports no jax).

The reference logs segmentation/detection scalars to TensorBoard
(reference: segmentation/train.py:33,69-71; detection/train.py:117-124,
321-323).  torch's SummaryWriter is used when the tensorboard package is
present; otherwise scalars append to ``<logdir>/scalars.jsonl`` so training
remains dependency-free and observable.
"""
from __future__ import annotations

import json
import os
import time


class ScalarLogger:
    """``enabled=False`` (a rank other than 0 of a multi-GPU run) writes
    nothing."""

    def __init__(self, logdir: str = "runs/", enabled: bool = True):
        self._writer = None
        self._fallback = None
        self._enabled = enabled
        if not enabled:
            return
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._writer = SummaryWriter(logdir)
        except Exception:
            os.makedirs(logdir, exist_ok=True)
            self._fallback = os.path.join(logdir, "scalars.jsonl")

    def add_scalar(self, tag, value, step):
        if not self._enabled:
            return
        if self._writer is not None:
            self._writer.add_scalar(tag, float(value), int(step))
        else:
            with open(self._fallback, "a") as f:
                f.write(
                    json.dumps(
                        {
                            "tag": tag,
                            "value": float(value),
                            "step": int(step),
                            "time": time.time(),
                        }
                    )
                    + "\n"
                )

    def add_hparams(self, hparams, metrics):
        if not self._enabled:
            return
        if self._writer is not None:
            clean = {
                k: (v if isinstance(v, (int, float, str, bool)) else str(v))
                for k, v in hparams.items()
                if v is not None
            }
            self._writer.add_hparams(clean, metrics)
        else:
            with open(self._fallback, "a") as f:
                f.write(
                    json.dumps({"hparams": {str(k): str(v) for k, v in
                                            hparams.items()},
                                "metrics": metrics}) + "\n"
                )

    def flush(self):
        if self._writer is not None:
            self._writer.flush()
