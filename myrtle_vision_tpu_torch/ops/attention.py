"""Multi-head self-attention core over (batch, heads, seq, head_dim)
inputs (port of myrtle_vision_tpu/ops/attention.py).

The FP32 discrete-site Block takes ``impl="auto"``, which is ``"flash"``
(ops/flash_attention.py: the plain version on the CPU, the CUDA kernel on
the card).  The float formats' discrete Block takes ``impl="xla"``, the
JAX einsum core on fp32 inputs: the 3-pass scores times the scale, keys
at or past ``seq_valid`` masked, a softmax with a true divide, the 3-pass
P V, each product with its 3-pass backward (ops/high_precision.py) and
the softmax with ``jax.nn.softmax``'s.  It is not a Pallas kernel in the
JAX package, so PyTorch operations carry it on any device.  The
probability capture ``return_probs`` is not ported yet (ROADMAP A10).
"""
from __future__ import annotations

import torch

from myrtle_vision_tpu_torch.ops.flash_attention import flash_attention
from myrtle_vision_tpu_torch.ops.high_precision import (
    bdot_pv_high3,
    bdot_qk_high3,
)

_NOT_PORTED = "not ported yet; see ROADMAP.md (A10)"


class _Softmax(torch.autograd.Function):
    """softmax over the last axis as ``jax.nn.softmax`` computes it, e =
    exp(s - max), p = e / sum(e), with its gradient p (g - sum(g p))."""

    @staticmethod
    def forward(ctx, s):
        e = torch.exp(s - s.amax(-1, keepdim=True))
        p = e / e.sum(-1, keepdim=True)
        ctx.save_for_backward(p)
        return p

    @staticmethod
    def backward(ctx, g):
        (p,) = ctx.saved_tensors
        gp = g * p
        return gp - p * gp.sum(-1, keepdim=True)


def xla_attention(q, k, v, scale, seq_valid=None):
    """The JAX ``impl="xla"`` core on fp32 (b, h, n, d) inputs -> fp32 (b,
    h, n, d), differentiable."""
    q, k, v = (t.float() for t in (q, k, v))
    s = bdot_qk_high3(q, k) * scale
    if seq_valid is not None and seq_valid < q.shape[2]:
        col = torch.arange(s.shape[-1], device=s.device)
        s = torch.where(col < seq_valid, s, torch.full_like(s, -1e30))
    return bdot_pv_high3(_Softmax.apply(s), v)


def multi_head_attention(q, k, v, scale, *, impl="auto", return_probs=False,
                         seq_valid=None):
    """Softmax attention over (b, h, n, d) inputs -> (b, h, n, d)."""
    if return_probs:
        raise NotImplementedError(f"attention probabilities: {_NOT_PORTED}")
    if impl == "auto":
        impl = "flash"
    if impl == "xla":
        if q.dtype != torch.float32:
            raise NotImplementedError(
                f"attention impl 'xla' on {q.dtype}: the port runs the "
                "einsum core on fp32 inputs only, as the float formats give "
                f"it; {_NOT_PORTED}")
        return xla_attention(q, k, v, scale, seq_valid)
    if impl != "flash":
        raise ValueError(f"unknown attention impl {impl!r}")
    return flash_attention(q, k, v, scale, seq_valid)
