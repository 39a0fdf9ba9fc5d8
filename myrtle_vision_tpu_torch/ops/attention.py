"""Multi-head self-attention core over (batch, heads, seq, head_dim)
inputs (port of myrtle_vision_tpu/ops/attention.py).

The FP32 discrete-site Block takes ``impl="auto"``, which is ``"flash"``
(ops/flash_attention.py: the plain version on the CPU, the CUDA kernel on
the card).  The einsum core ``impl="xla"`` and the probability capture
``return_probs`` serve the quantized-format simulation and attention
visualisation in the JAX package and are not ported yet (ROADMAP A10).
"""
from __future__ import annotations

from myrtle_vision_tpu_torch.ops.flash_attention import flash_attention

_NOT_PORTED = "not ported yet; see ROADMAP.md (A10)"


def multi_head_attention(q, k, v, scale, *, impl="auto", return_probs=False,
                         seq_valid=None):
    """Softmax attention over (b, h, n, d) inputs -> (b, h, n, d)."""
    if return_probs:
        raise NotImplementedError(f"attention probabilities: {_NOT_PORTED}")
    if impl == "auto":
        impl = "flash"
    if impl != "flash":
        raise NotImplementedError(f"attention impl {impl!r}: {_NOT_PORTED}")
    return flash_attention(q, k, v, scale, seq_valid)
