"""The arithmetic of the long fp32 core's cluster design, on the CPU.

Past 768 tokens (or with ``sweep=True``) csrc/attention_core_f32_long_wgmma.cu
runs ``attention_core_f32_cluster_kernel``: a cluster of CTAs shares 64
queries of one (image, head), CTA ``rank`` holding the keys of
``rank_tiles`` consecutive 64-key tiles (``K.f32_long_plan``'s "cluster"
and "stages"), and each score is computed once:

- S: each of the three passes of the split product (hi.hi, hi.lo, lo.hi)
  the in-order fp32 sum over d, one FMA a term (each product of two bf16
  halves is exact in fp32, so an FMA is an exact product added), then
  (hi.hi + hi.lo) + lo.hi, then the scale; keys past N -inf;
- the row max over the cluster's keys;
- e = exp(s - m) with the row's final m; the rowsum as compensated (hi,
  lo) pairs: lane l of a CTA's 32 the keys l, l + 32, ... of the CTA's
  keys in order, the lanes' pairs in a butterfly (xor 16, 8, 4, 2, 1),
  then the ranks' pairs in rank order, sum = hi + lo;
- p = e / sum, the true divide;
- P V: warpgroup 0 of a CTA the first ceil(tiles / 2) of its tiles,
  warpgroup 1 the rest, each tile's 3-pass product (hi.lo, lo.hi, hi.hi
  into one accumulator) added in tile order, the 2 x cluster partial
  contexts added in (rank, warpgroup) order.

Here that order in float32 torch, against the JAX ``_attn_heads_fwd``
with ``qspec`` (jitted, as the JAX package's tests run the kernel body's
jnp functions), at the bars chip_smoke.py holds the kernel to against the
plain version: a snapped context at most 0.2% past the fp32 noise (2^-16
of its largest magnitude) and the rest within one format step; the row
max and reciprocal rowsum within the one-kernel bar (2^-6 |ref| + 2^-7);
the compensated rowsum within one ulp of the exact sum of the same e.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myrtle_vision_tpu.ops import fake_quant as jfq
from myrtle_vision_tpu.ops import fused_attention_block as jfa
from myrtle_vision_tpu_torch.ops import _kernels as K
from myrtle_vision_tpu_torch.ops.fake_quant import snap

TILE = 64
LANES = 32
FLOAT_TIGHT = 2.0 ** -16
FLOAT_SHARE = 2e-3
QSPECS = [(5, 10, True), (5, 10, False), (8, 10, False)]


def split(x):
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def in_order_scores(q, k):
    """(Nq, D) x (Nk, D) -> (Nq, Nk): high3 with each pass summed over d
    in order in fp32."""
    qh, ql = split(q)
    kh, kl = split(k)
    hh = torch.zeros(q.shape[0], k.shape[0])
    hl, lh = hh.clone(), hh.clone()
    for d in range(q.shape[1]):
        hh = hh + qh[:, d, None] * kh[None, :, d]
        hl = hl + qh[:, d, None] * kl[None, :, d]
        lh = lh + ql[:, d, None] * kh[None, :, d]
    return (hh + hl) + lh


def pair_add(hi, lo, h2, l2):
    """(hi, lo) + (h2, l2): TwoSum of the leading parts, its exact error
    added to the trailing parts' sum."""
    t = hi + h2
    bp = t - hi
    err = (hi - (t - bp)) + (h2 - bp)
    return t, (lo + l2) + err


def product3(p, v):
    """A tile's 3-pass product into one accumulator: hi.lo, lo.hi, hi.hi."""
    ph, pl = split(p)
    vh, vl = split(v)
    acc = ph @ vl
    acc = acc + pl @ vh
    return acc + ph @ vh


def cluster_core(q, k, v, scale, cluster, rank_tiles):
    """One (image, head): q, k, v (N, D) fp32 -> (context (N, D), row max
    (N,), rowsum (N,)) in the cluster design's order."""
    n = q.shape[0]
    tiles = -(-n // TILE)
    width = TILE * rank_tiles
    s = in_order_scores(q, k) * scale
    pad = torch.full((n, cluster * width - n), float("-inf"))
    s = torch.cat([s, pad], 1)  # keys past N, and past the last tile
    m = s.amax(1, keepdim=True)
    e = torch.exp(s - m)
    hi = torch.zeros(n)
    lo = torch.zeros(n)
    for r in range(cluster):
        lanes = e[:, r * width:(r + 1) * width].reshape(n, -1, LANES)
        lh, ll = torch.zeros(n, LANES), torch.zeros(n, LANES)
        for j in range(lanes.shape[1]):
            lh, ll = pair_add(lh, ll, lanes[:, j], torch.zeros(n, LANES))
        for o in (16, 8, 4, 2, 1):
            partner = torch.arange(LANES) ^ o
            lh, ll = pair_add(lh, ll, lh[:, partner], ll[:, partner])
        hi, lo = pair_add(hi, lo, lh[:, 0], ll[:, 0])
    total = hi + lo
    p = e / total[:, None]
    vp = torch.cat([v, torch.zeros(cluster * width - n, v.shape[1])])
    ctx = torch.zeros(n, v.shape[1])
    for r in range(cluster):
        own = max(0, min(rank_tiles, tiles - r * rank_tiles))
        mid = (own + 1) // 2
        for lo_t, hi_t in ((0, mid), (mid, own)):
            u = torch.zeros_like(ctx)
            for i in range(lo_t, hi_t):
                c0 = (r * rank_tiles + i) * TILE
                u = u + product3(p[:, c0:c0 + TILE], vp[c0:c0 + TILE])
            ctx = ctx + u
    return ctx, m[:, 0], total


def cluster_forward(qkv, heads, scale, cluster, rank_tiles):
    """qkv (B, N, 3C) -> (context (B, N, C), m (B, H, N), rowsum (B, H, N))."""
    b, n, c3 = qkv.shape
    c = c3 // 3
    d = c // heads
    ctx, ms, sums = [], [], []
    for i in range(b):
        row = []
        for h in range(heads):
            q, k, v = (qkv[i, :, j * c + h * d:j * c + (h + 1) * d]
                       for j in range(3))
            u, m, t = cluster_core(q, k, v, scale, cluster, rank_tiles)
            row.append(u)
            ms.append(m)
            sums.append(t)
        ctx.append(torch.cat(row, 1))
    return (torch.stack(ctx), torch.stack(ms).view(b, heads, n),
            torch.stack(sums).view(b, heads, n))


@functools.partial(jax.jit, static_argnums=(1, 2))
def jax_heads(qkv, heads, scale):
    return jfa._attn_heads_fwd(qkv, heads, scale, jnp.float32,
                               (5, 10, False))


def format_step(v, qspec):
    exp_bits, man_bits, _ = qspec
    min_exp = 2 - 2 ** (exp_bits - 1)
    return torch.exp2(torch.floor(torch.log2(
        v.abs().clamp_min(2.0 ** min_exp))) - man_bits)


# (N, D, heads, B): yolos_tiny.json's 480 px canvas at the train step's
# micro-batch (a cluster of 4, 4 tiles each); the fused gate's longest,
# one head of 32 (a cluster of 8: 29 tiles, the last rank one); just past
# the score-block design's top, 13 tiles, at 3 heads (a cluster of 4: the
# last rank one tile, its only key below N the 769th) and at one (image,
# head), which the plan gives a cluster of 8 of 2 tiles each (rank 6 one
# tile, rank 7 none: every key of its range past N)
CASES = [(1001, 64, 3, 2), (1837, 32, 1, 2), (769, 64, 3, 2),
         (769, 64, 1, 1)]


@pytest.mark.parametrize("n,d,heads,b", CASES)
def test_cluster_order_meets_the_float_bars_against_jax(n, d, heads, b):
    plan = K.f32_long_plan(n, d, b, heads)
    cluster, rank_tiles = plan["fwd"]["cluster"], plan["fwd"]["stages"]
    assert plan["sweep"] and cluster * rank_tiles >= plan["tiles"]
    rng = np.random.RandomState(n + d)
    qkv = rng.randn(b, n, 3 * heads * d).astype(np.float32)
    scale = d ** -0.5
    ctx, m, total = cluster_forward(torch.from_numpy(qkv), heads, scale,
                                    cluster, rank_tiles)
    refs = [tuple(map(np.asarray, jax_heads(jnp.asarray(qkv[i]), heads,
                                            scale))) for i in range(b)]
    ref_ctx = torch.from_numpy(np.stack([r[0] for r in refs]))
    ref_m = torch.from_numpy(np.stack([r[1] for r in refs]))
    ref_rs = torch.from_numpy(np.stack([r[2] for r in refs]))
    for qspec in QSPECS:
        got = snap(ctx, qspec).double()
        ref = torch.from_numpy(np.array(jfq.snap(
            jnp.asarray(ref_ctx.numpy()), qspec=qspec))).double()
        diff = (got - ref).abs()
        beyond = diff > FLOAT_TIGHT * float(ref.abs().max())
        share = float(beyond.double().mean())
        print(f"N={n} D={d} H={heads} B={b} cluster {cluster} x "
              f"{rank_tiles} tiles, qspec {qspec}: {share:.5f} of the "
              "context past the fp32 noise")
        assert share <= FLOAT_SHARE
        assert bool((diff[beyond] <= format_step(ref[beyond], qspec)).all())
    rs = 1.0 / total
    for got, ref in ((m, ref_m), (rs, ref_rs)):
        torch.testing.assert_close(got, ref, rtol=2.0 ** -6, atol=2.0 ** -7)


@pytest.mark.parametrize("n,d,heads,b", CASES)
def test_cluster_rowsum_is_within_an_ulp_of_the_exact_sum(n, d, heads, b):
    """The compensated pairs, lane by lane, across the lanes and the
    ranks, give the rowsum of the design's own e to within one ulp of their
    exact (float64) sum; the row max is the scores' largest, bit for
    bit."""
    plan = K.f32_long_plan(n, d, b, heads)
    cluster, rank_tiles = plan["fwd"]["cluster"], plan["fwd"]["stages"]
    rng = np.random.RandomState(7 * n + d)
    qkv = torch.from_numpy(rng.randn(1, n, 3 * d).astype(np.float32) * 2)
    q, k, v = (qkv[0, :, j * d:(j + 1) * d] for j in range(3))
    scale = d ** -0.5
    _, m, total = cluster_core(q, k, v, scale, cluster, rank_tiles)
    s = in_order_scores(q, k) * scale
    assert torch.equal(m, s.amax(1))
    exact = torch.exp(s - m[:, None]).double().sum(1)
    ulp = torch.exp2(torch.floor(torch.log2(exact)) - 23)
    assert bool(((total.double() - exact).abs() <= ulp).all())
