"""Residual-saving policy for the fused attention backward (a copy of
myrtle_vision_tpu/ops/acts_policy.py, so that both packages decide
alike).

When the budget affords it, the attention forward saves its qkv rows
(B, N, 3*C) for the backward instead of recomputing the QKV projection
there.  A call estimates the whole model's cost of its own residual as
depth x one layer and saves when that fits the budget (default 4 GiB,
the JAX package's, sized for a 16 GiB TPU; ROADMAP B1 re-decides it for
the H100).  The model passes its real ``depth``; a caller that cannot
know it gets the reference family's depth 12.

Environment overrides:
  MVT_SAVE_ACTS=0|1     force off / force on (bypasses the budget)
  MVT_SAVE_ACTS_GB=<f>  per-kernel budget in GiB (default 4.0)
"""
from __future__ import annotations

import os

_FALLBACK_DEPTH = 12


def save_acts(extra_bytes_per_layer: int, depth: int | None = None) -> bool:
    """Whether a fused op should save its projection rows for the
    backward instead of recomputing them.

    ``extra_bytes_per_layer``: bytes of the residual ONE call would add
    (batch * rows * width * itemsize).  ``depth``: the model's real
    layer count (None -> the reference family's 12).
    """
    env = os.environ.get("MVT_SAVE_ACTS")
    if env is not None and env != "auto":
        return env == "1"
    budget_gb = float(os.environ.get("MVT_SAVE_ACTS_GB", 4.0))
    n_layers = depth if depth else _FALLBACK_DEPTH
    return n_layers * extra_bytes_per_layer <= budget_gb * (1 << 30)
