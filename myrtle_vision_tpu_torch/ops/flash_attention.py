"""Flash attention: softmax(q k^T scale, keys >= n_valid masked) v over
(B, H, N, D), forward and backward, the scores never written to device
memory.

Replaces the TPU kernels of myrtle_vision_tpu/ops/flash_attention.py:
the unblocked forward ``_fwd_kernel`` (K5, launched by ``_flash_forward``
when the sequence padded to 128 is at most ``_FULL_SEQ_MAX``) and the
blocked ``_blk_fwd_kernel`` (K6, ``_blocked_forward``: an online softmax
over KV tiles that also emits the LSE for the backward); and their
backwards, ``_bwd_kernel`` (K8, ``_flash_backward``) and
``_blk_bwd_kernel`` (K7, ``_blocked_backward``), which the custom VJP
``_fa_bwd`` picks by the same regime.  On the H100 one CUDA kernel
computes both forwards (csrc/flash_attention_fwd_wgmma.cu): 128-query
CTAs of two consumer warpgroups and a TMA producer, a ring of 128-key K
and V tiles, both products on wgmma, the softmax state in registers and
one tile's softmax under the next tile's products; and one CUDA backward
both backwards (csrc/flash_attention_bwd_wgmma.cu: a dsum pre-pass, a
dk / dv kernel walking query tiles, a dq kernel walking key tiles).

The plain version follows the JAX function regime by regime, so that the
CPU tests hold it against the JAX kernels in interpret mode:

- n_pad <= :data:`FULL_SEQ_MAX` (K5): s = (q . k^T) * scale in fp32,
  p = e / rowsum(e), bf16(p) . v with fp32 accumulation;
- above it (K6): the KV tiles of :func:`pick_kv_blk` in order, e =
  exp(s - running max), bf16(e) . v accumulated in fp32 with the running
  rescale, / l at the end.

The kernel rounds as K6 does, with 128-key tiles.  In the K5 regime it
therefore rounds e where K5 rounds p, and in both its tile boundaries
differ from the plain version's, which moves an output element by about
2^-9 of itself (one rounding of a bf16 probability, averaged over the
keys): inside the one-kernel bar |kernel - plain| <= 2^-6 |plain| + 2^-7
that chip_smoke.py holds it to.

On fp32 operands (``compute_dtype`` float32) the JAX kernels' dots take
``_kernel_precision`` None, true fp32 products, and so does the plain
version (no rounding to a narrower type).  The fp32 CUDA kernels
(csrc/flash_attention_f32_{fwd,bwd}_wgmma.cu) run every product as
3xTF32 on the tensor cores: each operand split by :func:`split_tf32`,
then ah.bl + al.bh + ah.bh (:func:`matmul_3xtf32`), about 2^-22 of each
product off true fp32; a split pass writes the halves in the layouts of
:func:`flash_f32_split_plain`.

The backward is the JAX rule ``_fa_bwd`` on both devices: one autograd
node saves q, k, v, the output and the LSE, and its backward computes,
with ``do`` rounded to the operands' dtype and fp32 accumulation,

    dsum = rowsum(do * o)          p = softmax of the masked scores
    dv = bf16(p)^T do              dp = do v^T
    ds = p * (dp - dsum)           (query rows >= n_valid: p = ds = 0)
    dq = bf16(ds) k * scale        dk = bf16(ds)^T q * scale

The plain version follows each regime: K8 normalises p = e / rowsum(e)
over the whole row, K7 recomputes p = exp(s - lse) from the forward's LSE
per :func:`pick_kv_blk` tile and sums dq over the tiles.  The kernel
takes p = exp(s - lse) in both, which moves p by an fp32 rounding.
"""
from __future__ import annotations

import torch

from myrtle_vision_tpu_torch.ops import _kernels as K

_LANE = 128
_NEG = -1e30  # the JAX kernels' mask value
# n_pad ceiling of the unblocked regime (the JAX module's _FULL_SEQ_MAX)
FULL_SEQ_MAX = 1536


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


def split_tf32(x):
    """(hi, lo) of fp32 ``x`` as the fp32 kernels' split pass forms them
    (cvt.rna.tf32.f32): hi = x rounded to tf32 (10 mantissa bits) to
    nearest, ties away from zero, lo = x - hi rounded so; on the int32
    view, add 0x1000, then keep the bits of 0xFFFFE000."""
    def rna(t):
        bits = t.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)

    hi = rna(x)
    return hi, rna(x - hi)


def matmul_3xtf32(a, b):
    """a @ b as the fp32 kernels compute it, for tests: each operand split
    by :func:`split_tf32`, the three passes ah.bl, al.bh, ah.bh added in
    that order (products of tf32 values are exact in fp32)."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    return (torch.matmul(ah, bl) + torch.matmul(al, bh)) + torch.matmul(ah, bh)


def flash_f32_split_plain(x, transposed=False):
    """The split pass's layout of an fp32 (B, H, N, D) operand: (2, B H,
    ns, D) natural or, with ``transposed``, (2, B H, D, ns), the hi then
    the lo half, ns = N rounded up to 8, zeros past N, the contracted index
    (D, or the tokens when transposed) permuted within each group of 8 so
    that position p holds index 2 (p % 4) + p // 4 (csrc/flash_tf32.cuh)."""
    b, h, n, d = x.shape
    ns = _ceil_to(n, 8)
    x = torch.nn.functional.pad(x.reshape(b * h, n, d).float(),
                                (0, 0, 0, ns - n))
    if transposed:
        x = x.transpose(1, 2)
    p = torch.arange(x.shape[-1], device=x.device)
    x = x[..., (p // 8) * 8 + 2 * (p % 4) + (p % 8) // 4]
    return torch.stack(split_tf32(x))


def flash_attention_plain(q, k, v, scale, n_valid=None, lse=False):
    """The plain PyTorch version, on any device: (B, H, N, D) q, k, v in
    bf16 or fp32 -> o in their dtype, and with ``lse`` the fp32 (B, H, N)
    log-sum-exp of the masked, scaled scores."""
    n = q.shape[-2]
    n_valid = n if n_valid is None else n_valid
    run = _blocked if _ceil_to(n, _LANE) > FULL_SEQ_MAX else _unblocked
    o, lse_t = run(q, k, v, scale, n_valid)
    return (o, lse_t) if lse else o


def _backward_rows(q, k, v, do, dsum, p, scale, n_valid):
    """dv, dk and the dq term of one KV slice (k, v) from its
    probabilities p (B, H, N, width), as ``_bwd_kernel`` and
    ``_blk_bwd_kernel`` round: query rows >= n_valid masked, p and ds
    rounded to the operands' dtype before their products."""
    dt = q.dtype
    row = torch.arange(q.shape[-2], device=q.device)[:, None] < n_valid
    p = torch.where(row, p, torch.zeros_like(p))
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), do.float())
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    dsb = (p * (dp - dsum)).to(dt).float()
    dk = torch.matmul(dsb.transpose(-1, -2), q.float()) * scale
    dq = torch.matmul(dsb, k.float()) * scale
    return dq, dk, dv


def flash_attention_bwd_plain(q, k, v, o, do, lse, scale, n_valid=None):
    """The plain PyTorch backward, on any device: (B, H, N, D) q, k, v, the
    forward's output o and its fp32 (B, H, N) LSE, the output gradient do
    -> (dq, dk, dv) in q's dtype, the JAX rule regime by regime (K8 below
    :data:`FULL_SEQ_MAX`, K7 above; see the module docstring)."""
    n = q.shape[-2]
    n_valid = n if n_valid is None else n_valid
    dt = q.dtype
    do = do.to(dt)
    dsum = (do.float() * o.to(dt).float()).sum(-1, keepdim=True)
    n_pad = _ceil_to(n, _LANE)
    if n_pad <= FULL_SEQ_MAX:
        s = _masked_scores(q, k, scale, n_valid)
        e = torch.exp(s - s.amax(-1, keepdim=True))
        dq, dk, dv = _backward_rows(q, k, v, do, dsum,
                                    e / e.sum(-1, keepdim=True), scale,
                                    n_valid)
    else:
        blk = pick_kv_blk(n_pad)
        dq, dks, dvs = 0.0, [], []
        for j in range(0, n, blk):
            kj, vj = k[..., j:j + blk, :], v[..., j:j + blk, :]
            s = _masked_scores(q, kj, scale, n_valid, j)
            dq_j, dk_j, dv_j = _backward_rows(
                q, kj, vj, do, dsum, torch.exp(s - lse[..., None]), scale,
                n_valid)
            dq = dq + dq_j
            dks.append(dk_j)
            dvs.append(dv_j)
        dk, dv = torch.cat(dks, -2), torch.cat(dvs, -2)
    return dq.to(dt), dk.to(dt), dv.to(dt)


def cuda_kernels(dtype):
    """(forward, backward) launchers of the CUDA kernels for operands of
    ``dtype``: bf16 csrc/flash_attention_{fwd,bwd}_wgmma.cu, fp32
    csrc/flash_attention_f32_{fwd,bwd}_wgmma.cu; any other dtype raises."""
    if dtype == torch.bfloat16:
        return K.flash_attention_fwd_cuda, K.flash_attention_bwd_cuda
    if dtype == torch.float32:
        return K.flash_attention_f32_fwd_cuda, K.flash_attention_f32_bwd_cuda
    raise TypeError(f"flash_attention: no kernel for {dtype} operands; the "
                    "kernels take bf16 and fp32")


class _FlashAttention(torch.autograd.Function):
    """Flash attention as an autograd node, on either side: the plain
    versions, or the CUDA kernels of the operands' dtype.  It saves q, k,
    v, the output and the LSE, as ``_fa_fwd`` saves its residuals."""

    @staticmethod
    def forward(ctx, plain, q, k, v, scale, n_valid):
        fwd = flash_attention_plain if plain else cuda_kernels(q.dtype)[0]
        o, lse = fwd(q, k, v, scale, n_valid, lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.plain, ctx.scale, ctx.n_valid = plain, scale, n_valid
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        bwd = flash_attention_bwd_plain if ctx.plain else \
            cuda_kernels(q.dtype)[1]
        # do in the operands' dtype, as the JAX rule casts it, its rows
        # contiguous for the kernels (autograd may hand over an expanded
        # gradient, e.g. of a sum)
        do = do.to(q.dtype)
        if do.stride(-1) != 1:
            do = do.contiguous()
        return (None, *bwd(q, k, v, o, do, lse, ctx.scale, ctx.n_valid),
                None, None)


def flash_attention(q, k, v, scale, n_valid=None, plain=False):
    """Softmax attention, (B, H, N, D) -> (B, H, N, D), the argument order
    of the JAX function, differentiable.  A CPU tensor takes the plain
    versions; a CUDA tensor the kernels of its dtype (bf16 or fp32, D 32
    or 64), or an error; any other device an error.  ``plain`` takes the
    plain versions on any device (the reference the kernels are held
    against)."""
    if q.device.type == "cpu":
        plain = True
    elif q.device.type != "cuda":
        raise ValueError(f"no kernel for {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(plain, q, k, v, scale, n_valid)
    if plain:
        return flash_attention_plain(q, k, v, scale, n_valid)
    return cuda_kernels(q.dtype)[0](q, k, v, scale, n_valid)
