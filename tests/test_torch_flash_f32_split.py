"""The arithmetic of the fp32 flash kernels, on the CPU.

csrc/flash_attention_f32_{fwd,bwd}_wgmma.cu run every product as 3xTF32:
each fp32 operand split as hi = tf32(x), lo = tf32(x - hi) (cvt.rna.tf32.f32,
which ``split_tf32`` repeats on the int32 view), a . b = ah.bl + al.bh +
ah.bh (``matmul_3xtf32``).  Here: the split's bits, the split pass's
layouts (``flash_f32_split_plain``, which the CUDA tests hold the kernel's
scratch to bit for bit), and the kernels' steps with 3xTF32 products
against the JAX fp32 flash function (interpret mode, true fp32 dots) at the
bars chip_smoke.py holds the kernels to against the plain version: 2^-14
of |ref| plus 2^-14 of the largest |ref| (at least 1) for the output and
the LSE, 2^-12 of it for dq, dk and dv."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import myrtle_vision_tpu.ops.flash_attention as jax_fa
from myrtle_vision_tpu_torch.ops.flash_attention import (
    flash_attention_plain,
    flash_f32_split_plain,
    matmul_3xtf32,
    split_tf32,
)

RTOL = 2.0 ** -14
ATOL = 2.0 ** -14
GRAD_ATOL = 2.0 ** -12
TILE = 64  # the forward kernel's key tile
NEG = -1e30  # a masked key's score


def bits(x):
    return x.contiguous().view(torch.int32)


def wide_values(seed, count=4096):
    """fp32 values of both signs over 2^-60 .. 2^60."""
    rng = np.random.RandomState(seed)
    x = rng.randn(count) * np.exp2(rng.randint(-60, 60, count))
    return torch.from_numpy(x.astype(np.float32))


def tf32_nearest_away(x):
    """x rounded to 10 mantissa bits, to nearest, ties away from zero, in
    float64 arithmetic (normal fp32 x)."""
    x = x.double()
    _, e = torch.frexp(x)  # |x| in [2^(e - 1), 2^e)
    ulp = torch.exp2((e - 11).double())
    q = x.abs() / ulp
    r = torch.floor(q + 0.5)  # q >= 0: halves go up in magnitude
    return (torch.sign(x) * r * ulp).float()


def test_split_hi_and_lo_have_low_13_bits_zero():
    hi, lo = split_tf32(wide_values(0))
    assert not (bits(hi) & 0x1FFF).any()
    assert not (bits(lo) & 0x1FFF).any()


def test_split_recovers_x_to_2_pow_minus_21():
    x = wide_values(1)
    hi, lo = split_tf32(x)
    err = (x.double() - hi.double() - lo.double()).abs()
    assert (err <= 2.0 ** -21 * x.double().abs()).all()
    # hi alone is x to about 2^-11
    assert ((x - hi).abs() <= 2.0 ** -11 * x.abs()).all()


def test_split_rounds_to_nearest_ties_away_from_zero():
    # 1 + 2^-11 lies halfway between tf32 neighbours 1 and 1 + 2^-10; so do
    # the other halfway cases; their negatives round away from zero too
    raw = np.array([0x3F801000, 0x3F803000, 0x3F800FFF, 0x3F801001,
                    0x40000000 | 0x5000, 0x7E801000], dtype=np.uint32)
    want = np.array([0x3F802000, 0x3F804000, 0x3F800000, 0x3F802000,
                     0x40006000, 0x7E802000], dtype=np.uint32)
    for sign in (0, 0x80000000):
        x = torch.from_numpy((raw | sign).view(np.int32)).view(torch.float32)
        hi, _ = split_tf32(x)
        assert torch.equal(
            bits(hi), torch.from_numpy((want | sign).view(np.int32)))
    x = wide_values(2)
    assert torch.equal(bits(split_tf32(x)[0]), bits(tf32_nearest_away(x)))


@pytest.mark.parametrize("transposed", [False, True])
def test_split_layouts(transposed):
    """(2, B H, ns, D) natural or (2, B H, D, ns) transposed, ns = N
    rounded up to 8, zeros past N, position p of each group of 8 along the
    contracted index holding index 2 (p % 4) + p // 4."""
    b, h, n, d = 2, 3, 13, 16
    x = torch.from_numpy(np.random.RandomState(3).randn(b, h, n, d).astype(
        np.float32))
    got = flash_f32_split_plain(x, transposed)
    ns = 16
    assert got.shape == ((2, b * h, d, ns) if transposed else
                         (2, b * h, ns, d))
    hi, lo = split_tf32(x.reshape(b * h, n, d))
    for half, ref in zip(got, (hi, lo)):
        if transposed:
            half = half.transpose(1, 2)  # (B H, ns, D), tokens permuted
        inv = torch.arange(half.shape[1 if transposed else 2])
        # index i sits at position 4 (i % 2) + (i % 8) // 2 of its group
        pos = (inv // 8) * 8 + 4 * (inv % 2) + (inv % 8) // 2
        half = half[:, pos] if transposed else half[..., pos]
        assert torch.equal(bits(half[:, :n]), bits(ref))
        assert not half[:, n:].any()


def test_matmul_3xtf32_is_fp32_close():
    rng = np.random.RandomState(4)
    a = torch.from_numpy(rng.randn(64, 96).astype(np.float32))
    b = torch.from_numpy(rng.randn(96, 80).astype(np.float32))
    ref = a.double() @ b.double()
    got = matmul_3xtf32(a, b)
    bound = 2.0 ** -18 * (a.double().abs() @ b.double().abs())
    assert ((got.double() - ref).abs() <= bound).all()


# ---------------------------------------------------------------- the
# kernels' steps with 3xTF32 products

def kernel_forward(q, k, v, scale, n_valid):
    """The forward kernel's steps: per 64-key tile the scaled scores, keys
    at or past n_valid at -1e30, the online softmax in base e, acc = a acc
    + e v; then acc / l and LSE = m + log l."""
    n = q.shape[-2]
    m = torch.full(q.shape[:-1] + (1,), NEG)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape)
    for c0 in range(0, n_valid, TILE):
        kt, vt = k[..., c0:c0 + TILE, :], v[..., c0:c0 + TILE, :]
        s = matmul_3xtf32(q, kt.transpose(-1, -2)) * scale
        col = torch.arange(c0, min(c0 + TILE, n))
        s = torch.where(col < n_valid, s, torch.full_like(s, NEG))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        a = torch.exp(m - m_new)
        e = torch.exp(s - m_new)
        l = l * a + e.sum(-1, keepdim=True)
        acc = acc * a + matmul_3xtf32(e, vt)
        m = m_new
    return acc / l, (m + torch.log(l))[..., 0]


def kernel_backward(q, k, v, o, do, lse, scale, n_valid):
    """The backward kernels' steps: dsum = rowsum(do o), p = exp(s - LSE)
    with query rows and keys at or past n_valid at 0, ds = p (dp - dsum),
    the scale on dq and dk at the end."""
    n = q.shape[-2]
    idx = torch.arange(n)
    ok = (idx[:, None] < n_valid) & (idx[None, :] < n_valid)
    dsum = (do * o).sum(-1, keepdim=True)
    s = matmul_3xtf32(q, k.transpose(-1, -2)) * scale
    p = torch.where(ok, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    dp = matmul_3xtf32(do, v.transpose(-1, -2))
    ds = torch.where(ok, p * (dp - dsum), torch.zeros_like(s))
    dv = matmul_3xtf32(p.transpose(-1, -2), do)
    dk = matmul_3xtf32(ds.transpose(-1, -2), q) * scale
    dq = matmul_3xtf32(ds, k) * scale
    return dq, dk, dv


def close(got, ref, atol_share, name):
    got = torch.from_numpy(np.array(got))
    ref = torch.from_numpy(np.array(ref))
    assert got.shape == ref.shape, name
    atol = atol_share * max(1.0, float(ref.abs().max()))
    torch.testing.assert_close(got, ref, rtol=RTOL, atol=atol, msg=name)


# (N, n_valid): ragged with masked keys and query rows; past the unblocked
# regime's 1536-token ceiling (K6 / K7), n_pad 1664
CASES = [(50, 40), (1545, None)]


@pytest.mark.parametrize("std", [1.0, 3.0])
@pytest.mark.parametrize("n,n_valid", CASES)
def test_3xtf32_flash_meets_the_kernel_bars_against_jax(n, n_valid, std):
    """Forward (output; the LSE against the plain version's true fp32) and
    q, k, v gradients, the kernels' steps with 3xTF32 products, against
    ``jax.vjp`` of the JAX fp32 flash function in interpret mode; at std 3
    the softmax is peaky."""
    rng = np.random.RandomState(n + int(std))
    q, k, v, g = ((rng.randn(1, 2, n, 32) * s).astype(np.float32)
                  for s in (std, std, std, 1.0))
    scale = 32 ** -0.5
    nv = n if n_valid is None else n_valid
    out, vjp = jax.vjp(lambda *a: jax_fa.flash_attention(*a, scale, n_valid),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(g))
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    o, lse = kernel_forward(tq, tk, tv, scale, nv)
    close(o, out, ATOL, "o")
    _, lse_ref = flash_attention_plain(tq, tk, tv, scale, n_valid, lse=True)
    close(lse, lse_ref, ATOL, "lse")
    grads = kernel_backward(tq, tk, tv, o, tg, lse, scale, nv)
    for got, ref, name in zip(grads, jgrads, ("dq", "dk", "dv")):
        close(got, ref, GRAD_ATOL, name)
        assert not got[:, :, nv:].any(), name
