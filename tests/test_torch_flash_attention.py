"""The plain version of the port's flash-attention forward against the
JAX package's ``flash_attention`` (the Pallas kernels K5 and K6 in
interpret mode), regime by regime; the port's copy of the fused gate
``fuses_at``; and the attention entry points' boundaries on the CPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import myrtle_vision_tpu.ops.flash_attention as jax_fa
import myrtle_vision_tpu_torch.ops.flash_attention as port_fa
from myrtle_vision_tpu.ops.fused_attention_block import (
    fuses_at as jax_fuses_at,
)
from myrtle_vision_tpu_torch.ops import _kernels as K
from myrtle_vision_tpu_torch.ops.attention import multi_head_attention
from myrtle_vision_tpu_torch.ops.fused_attention_block import fuses_at

SCALE = 0.125
# fp32: the same arithmetic in both, the order of fp32 sums aside.  bf16:
# the probabilities round to bf16 at the same point in both, so an output
# moves by at most one bf16 step where a sum's order flips a rounding
# (rtol 2^-7), plus 2^-9 for outputs that cancel towards zero
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2.0 ** -7, atol=2.0 ** -9)}


def inputs(b, h, n, d, dtype, seed):
    rng = np.random.RandomState(seed)
    arrs = [rng.randn(b, h, n, d).astype(np.float32) for _ in range(3)]
    tdt = getattr(torch, dtype)
    return ([jnp.asarray(a, getattr(jnp, dtype)) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def check(jax_out, port_out, dtype):
    assert port_out.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(port_out.float().numpy(),
                               np.asarray(jax_out, np.float32), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [17, 197, 300])
def test_unblocked_regime_matches_jax(n, dtype):
    (jq, jk, jv), (q, k, v) = inputs(2, 3, n, 64, dtype, n)
    check(jax_fa.flash_attention(jq, jk, jv, SCALE),
          port_fa.flash_attention_plain(q, k, v, SCALE), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,kv_blk", [(200, None), (300, 128)])
def test_blocked_regime_matches_jax(n, kv_blk, dtype, monkeypatch):
    """Forced at small n by lowering the threshold in both packages (as
    tests/test_flash_attention.py does); at n = 300 also the KV tile, so
    that the online softmax runs over three tiles."""
    monkeypatch.setattr(jax_fa, "_FULL_SEQ_MAX", 128)
    monkeypatch.setattr(port_fa, "FULL_SEQ_MAX", 128)
    if kv_blk:
        monkeypatch.setattr(jax_fa, "_pick_kv_blk", lambda n_pad: kv_blk)
        monkeypatch.setattr(port_fa, "pick_kv_blk", lambda n_pad: kv_blk)
    (jq, jk, jv), (q, k, v) = inputs(1, 2, n, 64, dtype, n + 1)
    check(jax_fa.flash_attention(jq, jk, jv, SCALE),
          port_fa.flash_attention_plain(q, k, v, SCALE), dtype)


@pytest.mark.parametrize("blocked", [False, True])
def test_masked_keys_match_jax(blocked, monkeypatch):
    if blocked:
        monkeypatch.setattr(jax_fa, "_FULL_SEQ_MAX", 128)
        monkeypatch.setattr(port_fa, "FULL_SEQ_MAX", 128)
    (jq, jk, jv), (q, k, v) = inputs(2, 2, 150, 32, "float32", 5)
    check(jax_fa.flash_attention(jq, jk, jv, SCALE, 131),
          port_fa.flash_attention_plain(q, k, v, SCALE, n_valid=131),
          "float32")


def test_lse_matches_the_blocked_kernel():
    (jq, jk, jv), (q, k, v) = inputs(1, 2, 300, 64, "float32", 9)
    _, jlse = jax_fa._blocked_forward(jq, jk, jv, SCALE, 290, save_lse=True)
    for regime in (128, port_fa.FULL_SEQ_MAX):
        port_fa.FULL_SEQ_MAX, old = regime, port_fa.FULL_SEQ_MAX
        try:
            _, lse = port_fa.flash_attention_plain(q, k, v, SCALE, 290,
                                                   lse=True)
        finally:
            port_fa.FULL_SEQ_MAX = old
        assert lse.shape == (1, 2, 300) and lse.dtype == torch.float32
        np.testing.assert_allclose(
            lse.numpy(), np.asarray(jlse)[:, :300, 0].reshape(1, 2, 300),
            rtol=1e-6, atol=1e-5)


def test_pick_kv_blk_matches_jax():
    for n_pad in range(128, 4097, 128):
        assert port_fa.pick_kv_blk(n_pad) == jax_fa._pick_kv_blk(n_pad)
    assert port_fa.FULL_SEQ_MAX == jax_fa._FULL_SEQ_MAX


def test_fuses_at_matches_jax():
    sizes = (17, 197, 297, 677, 701, 702, 1017, 1125, 2601)
    grid = [(n, h, d) for n in sizes
            for h in (1, 2, 3, 6, 12) for d in (32, 64)]
    assert [fuses_at(*p) for p in grid] == [jax_fuses_at(*p) for p in grid]
    # YOLOS-S (6 heads of 64): fused through 384 px, discrete at 800 px
    assert fuses_at(677, 6, 64) and fuses_at(701, 6, 64)
    assert not fuses_at(702, 6, 64) and not fuses_at(2601, 6, 64)


def test_cpu_takes_the_plain_version_and_counts_no_launch():
    _, (q, k, v) = inputs(1, 2, 40, 32, "bfloat16", 2)
    before = K.LAUNCHES["flash_attention_fwd"]
    out = multi_head_attention(q, k, v, SCALE)
    assert K.LAUNCHES["flash_attention_fwd"] == before
    torch.testing.assert_close(
        out, port_fa.flash_attention_plain(q, k, v, SCALE), rtol=0, atol=0)


def test_cpu_plain_version_is_differentiable():
    _, (q, k, v) = inputs(1, 1, 30, 32, "float32", 3)
    q.requires_grad_()
    port_fa.flash_attention(q, k, v, SCALE).sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()


def test_entry_points_refuse_what_is_not_ported():
    q = torch.empty(1, 2, 8, 32, device="meta")
    with pytest.raises(ValueError, match="no kernel for meta"):
        port_fa.flash_attention(q, q, q, SCALE)
    x = torch.zeros(1, 2, 8, 32)
    # the xla core takes bf16 as well as fp32, and attention capture
    # forces it, as the JAX function does
    y = x.to(torch.bfloat16)
    assert multi_head_attention(y, y, y, SCALE, impl="xla").dtype == \
        torch.bfloat16
    out, probs = multi_head_attention(x, x, x, SCALE, return_probs=True)
    assert out.shape == x.shape and probs.shape == (1, 2, 8, 8)
    with pytest.raises(ValueError, match="require impl='xla'"):
        multi_head_attention(x, x, x, SCALE, impl="flash", return_probs=True)
    with pytest.raises(ValueError, match="unknown attention impl"):
        multi_head_attention(x, x, x, SCALE, impl="einsum")
