"""Multi-head self-attention core over (batch, heads, seq, head_dim)
inputs (port of myrtle_vision_tpu/ops/attention.py).

The FP32 discrete-site Block takes ``impl="auto"``, which is ``"flash"``
(ops/flash_attention.py: the plain version on the CPU, the CUDA kernels
of the operands' dtype on the card).  The float formats' discrete Block
takes ``impl="xla"``, the JAX einsum core: on fp32 inputs the 3-pass
scores times the scale, keys at or past ``seq_valid`` masked, a softmax
with a true divide, the 3-pass P V, each product with its 3-pass backward
(ops/high_precision.py) and the softmax with ``jax.nn.softmax``'s; on
bf16 inputs fp32 scores from the bf16 products, the same fp32 softmax and
the probabilities cast to the operands' dtype before P V, which
accumulates in fp32.  ``return_probs`` (attention capture, which forces
``"xla"`` as in the JAX function) adds the fp32 (b, h, n, n)
probabilities.  The ``xla`` core is not a Pallas kernel in the JAX
package, so PyTorch operations carry it on any device.
"""
from __future__ import annotations

import torch

from myrtle_vision_tpu_torch.ops.flash_attention import flash_attention
from myrtle_vision_tpu_torch.ops.high_precision import (
    bdot_pv_high3,
    bdot_qk_high3,
)


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


def xla_attention(q, k, v, scale, seq_valid=None, return_probs=False):
    """The JAX ``impl="xla"`` core on (b, h, n, d) inputs of one float
    dtype -> (b, h, n, d) in that dtype, and with ``return_probs`` also the
    fp32 (b, h, n, n) probabilities; differentiable.  fp32 inputs take the
    3-pass products, any other dtype its own products summed in fp32."""
    fp32 = q.dtype == torch.float32
    if fp32:
        s = bdot_qk_high3(q, k)
    else:
        s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    s = s * scale
    if seq_valid is not None and seq_valid < q.shape[2]:
        col = torch.arange(s.shape[-1], device=s.device)
        s = torch.where(col < seq_valid, s, torch.full_like(s, -1e30))
    p = _Softmax.apply(s)
    if fp32:
        out = bdot_pv_high3(p, v)
    else:
        out = torch.matmul(p.to(v.dtype).float(), v.float()).to(v.dtype)
    return (out, p) if return_probs else out


def multi_head_attention(q, k, v, scale, *, impl="auto", return_probs=False,
                         seq_valid=None):
    """Softmax attention over (b, h, n, d) inputs -> (b, h, n, d), and with
    ``return_probs`` also the fp32 (b, h, n, n) probabilities (the
    ``xla`` impl only, which ``"auto"`` then picks)."""
    if impl == "auto":
        impl = "xla" if return_probs else "flash"
    if return_probs and impl != "xla":
        raise ValueError("attention probabilities require impl='xla'")
    if impl == "xla":
        return xla_attention(q, k, v, scale, seq_valid, return_probs)
    if impl != "flash":
        raise ValueError(f"unknown attention impl {impl!r}")
    return flash_attention(q, k, v, scale, seq_valid)
