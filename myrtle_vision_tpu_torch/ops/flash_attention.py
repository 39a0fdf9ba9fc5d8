"""Flash attention forward: softmax(q k^T scale, keys >= n_valid masked) v
over (B, H, N, D), the scores never written to device memory.

Replaces the TPU forwards of myrtle_vision_tpu/ops/flash_attention.py:
the unblocked ``_fwd_kernel`` (K5, launched by ``_flash_forward`` when the
sequence padded to 128 is at most ``_FULL_SEQ_MAX``) and the blocked
``_blk_fwd_kernel`` (K6, ``_blocked_forward``: an online softmax over KV
tiles that also emits the LSE for the backward).  On the H100 one CUDA
kernel computes both (csrc/flash_attention_fwd.cu, csrc/flash_tiles.cuh):
64-query blocks, 64-key tiles double-buffered in shared memory, both
products on the tensor cores, the softmax state in registers.

The plain version follows the JAX function regime by regime, so that the
CPU tests hold it against the JAX kernels in interpret mode:

- n_pad <= :data:`FULL_SEQ_MAX` (K5): s = (q . k^T) * scale in fp32,
  p = e / rowsum(e), bf16(p) . v with fp32 accumulation;
- above it (K6): the KV tiles of :func:`pick_kv_blk` in order, e =
  exp(s - running max), bf16(e) . v accumulated in fp32 with the running
  rescale, / l at the end.

The kernel rounds as K6 does, with 64-key tiles.  In the K5 regime it
therefore rounds e where K5 rounds p, and in both its tile boundaries
differ from the plain version's, which moves an output element by about
2^-9 of itself (one rounding of a bf16 probability, averaged over the
keys): inside the one-kernel bar |kernel - plain| <= 2^-6 |plain| + 2^-7
that chip_smoke.py holds it to.

Forward only: the backward kernels (K7, K8) come with detection training
(ROADMAP B5); a gradient through the CUDA kernel raises.  On the CPU the
plain version is differentiable by autograd.
"""
from __future__ import annotations

import torch

from myrtle_vision_tpu_torch.ops import _kernels as K

_LANE = 128
_NEG = -1e30  # the JAX kernels' mask value
# n_pad ceiling of the unblocked regime (the JAX module's _FULL_SEQ_MAX)
FULL_SEQ_MAX = 1536
_BACKWARD_NOT_PORTED = (
    "flash_attention: the backward on CUDA is not ported yet; it comes with "
    "the flash backward kernels K7 and K8 (ROADMAP B5)"
)


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def pick_kv_blk(n_pad: int) -> int:
    """KV tile width of the blocked regime: the largest 128-multiple
    divisor of n_pad up to 512 (``_pick_kv_blk``)."""
    for blk in range(512, 0, -128):
        if n_pad % blk == 0:
            return blk
    return 128


def _masked_scores(q, k, scale, n_valid, col0=0):
    """fp32 (q . k^T) * scale, keys at or past n_valid set to -1e30."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    col = torch.arange(col0, col0 + k.shape[-2], device=q.device)
    return torch.where(col < n_valid, s, torch.full_like(s, _NEG))


def _unblocked(q, k, v, scale, n_valid):
    s = _masked_scores(q, k, scale, n_valid)
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(-1, keepdim=True)
    o = torch.matmul((e / l).to(q.dtype).float(), v.float())
    return o.to(q.dtype), (m + torch.log(l))[..., 0]


def _blocked(q, k, v, scale, n_valid):
    n = q.shape[-2]
    n_pad = _ceil_to(n, _LANE)
    blk = pick_kv_blk(n_pad)
    pad = (0, 0, 0, n_pad - n)
    k = torch.nn.functional.pad(k, pad)
    v = torch.nn.functional.pad(v, pad)
    m = torch.full(q.shape[:-1] + (1,), _NEG, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape, device=q.device)
    for j in range(0, n_pad, blk):
        s = _masked_scores(q, k[..., j:j + blk, :], scale, n_valid, j)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        e = torch.exp(s - m_new)
        l = l * alpha + e.sum(-1, keepdim=True)
        acc = acc * alpha + torch.matmul(e.to(q.dtype).float(),
                                         v[..., j:j + blk, :].float())
        m = m_new
    return (acc / l).to(q.dtype), (m + torch.log(l))[..., 0]


def flash_attention_plain(q, k, v, scale, n_valid=None, lse=False):
    """The plain PyTorch version, on any device: (B, H, N, D) q, k, v in
    bf16 or fp32 -> o in their dtype, and with ``lse`` the fp32 (B, H, N)
    log-sum-exp of the masked, scaled scores."""
    n = q.shape[-2]
    n_valid = n if n_valid is None else n_valid
    run = _blocked if _ceil_to(n, _LANE) > FULL_SEQ_MAX else _unblocked
    o, lse_t = run(q, k, v, scale, n_valid)
    return (o, lse_t) if lse else o


class _FlashForward(torch.autograd.Function):
    """The CUDA kernel as an autograd node whose backward raises, so that
    a gradient is never silently dropped."""

    @staticmethod
    def forward(ctx, q, k, v, scale, n_valid):
        return K.flash_attention_fwd_cuda(q, k, v, scale, n_valid)

    @staticmethod
    def backward(ctx, do):
        raise NotImplementedError(_BACKWARD_NOT_PORTED)


def flash_attention(q, k, v, scale, n_valid=None):
    """Softmax attention, (B, H, N, D) -> (B, H, N, D), the argument order
    of the JAX function.  A CPU tensor takes the plain version; a CUDA
    tensor the kernel (bf16, D 32 or 64), or an error; any other device an
    error."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale, n_valid)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashForward.apply(q, k, v, scale, n_valid)
    return K.flash_attention_fwd_cuda(q, k, v, scale, n_valid)
