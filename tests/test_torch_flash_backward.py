"""The port's flash-attention backward against the JAX package's custom
VJP (``_fa_bwd``: the Pallas kernels K8 and K7 in interpret mode), regime
by regime and with masked keys; the autograd node on the CPU, which
follows the JAX rule where autograd of the forward would not; and the
port's copy of the native LSAP solver."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import myrtle_vision_tpu.ops.flash_attention as jax_fa
import myrtle_vision_tpu_torch.ops.flash_attention as port_fa
from myrtle_vision_tpu_torch.native import lsap

SCALE = 0.125
# fp32: the same arithmetic in both, the order of fp32 sums aside.  bf16:
# p and ds round to bf16 at the same points in both, so a gradient moves
# by at most one bf16 step where a sum's order flips a rounding (rtol
# 2^-7), plus 2^-9 for gradients that cancel towards zero
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2.0 ** -7, atol=2.0 ** -9)}


def inputs(b, h, n, d, dtype, seed):
    """q, k, v and the output gradient, std 1, from a numpy seed, for both
    packages."""
    rng = np.random.RandomState(seed)
    arrs = [rng.randn(b, h, n, d).astype(np.float32) for _ in range(4)]
    tdt = getattr(torch, dtype)
    return ([jnp.asarray(a, getattr(jnp, dtype)) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def jax_grads(jq, jk, jv, jdo, n_valid):
    _, vjp = jax.vjp(lambda q, k, v: jax_fa.flash_attention(
        q, k, v, SCALE, n_valid), jq, jk, jv)
    return vjp(jdo)


def port_grads(q, k, v, do, n_valid):
    """Gradients through the port's autograd node on the CPU."""
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    port_fa.flash_attention(*leaves, SCALE, n_valid).backward(do)
    return [t.grad for t in leaves]


def check(ref, got, dtype):
    for name, r, g in zip("qkv", ref, got):
        assert g.dtype == getattr(torch, dtype), name
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(r, np.float32), **TOL[dtype],
                                   err_msg=f"d{name}")


def force_blocked(monkeypatch, kv_blk=None):
    """The blocked regime (K7) at small n in both packages, as
    tests/test_torch_flash_attention.py forces it."""
    monkeypatch.setattr(jax_fa, "_FULL_SEQ_MAX", 128)
    monkeypatch.setattr(port_fa, "FULL_SEQ_MAX", 128)
    if kv_blk:
        monkeypatch.setattr(jax_fa, "_pick_kv_blk", lambda n_pad: kv_blk)
        monkeypatch.setattr(port_fa, "pick_kv_blk", lambda n_pad: kv_blk)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [17, 200])
def test_unblocked_backward_matches_jax(n, dtype):
    (jq, jk, jv, jdo), (q, k, v, do) = inputs(1, 2, n, 64, dtype, n)
    check(jax_grads(jq, jk, jv, jdo, None), port_grads(q, k, v, do, None),
          dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,kv_blk", [(200, None), (300, 128)])
def test_blocked_backward_matches_jax(n, kv_blk, dtype, monkeypatch):
    """The bf16 case at n = 200 is the one autograd of the forward misses:
    it rounds neither do, p nor ds where the JAX rule does."""
    force_blocked(monkeypatch, kv_blk)
    (jq, jk, jv, jdo), (q, k, v, do) = inputs(1, 2, n, 64, dtype, n + 7)
    check(jax_grads(jq, jk, jv, jdo, None), port_grads(q, k, v, do, None),
          dtype)


@pytest.mark.parametrize("blocked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_backward_matches_jax(blocked, dtype, monkeypatch):
    """Keys and query rows at or past n_valid: zero gradients there."""
    if blocked:
        force_blocked(monkeypatch, 128)
    (jq, jk, jv, jdo), (q, k, v, do) = inputs(2, 2, 150, 32, dtype, 5)
    got = port_grads(q, k, v, do, 131)
    check(jax_grads(jq, jk, jv, jdo, 131), got, dtype)
    for g in got:
        assert not g[:, :, 131:].any()


def test_plain_backward_is_the_rule_not_autograd(monkeypatch):
    """The plain backward called directly gives the node's gradients, and
    differs from autograd of the plain forward in bf16, which rounds
    elsewhere (the fault the node repairs)."""
    force_blocked(monkeypatch)
    _, (q, k, v, do) = inputs(1, 2, 200, 64, "bfloat16", 207)
    node = port_grads(q, k, v, do, None)
    o, lse = port_fa.flash_attention_plain(q, k, v, SCALE, lse=True)
    direct = port_fa.flash_attention_bwd_plain(q, k, v, o, do, lse, SCALE)
    for a, b in zip(node, direct):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    port_fa.flash_attention_plain(*leaves, SCALE).backward(do)
    assert any(not torch.equal(t.grad, g) for t, g in zip(leaves, node))


def test_cpu_gradient_counts_no_launch():
    from myrtle_vision_tpu_torch.ops import _kernels as K

    _, (q, k, v, do) = inputs(1, 1, 30, 32, "float32", 3)
    before = (K.LAUNCHES["flash_attention_fwd"],
              K.LAUNCHES["flash_attention_bwd"])
    port_grads(q, k, v, do, None)
    assert (K.LAUNCHES["flash_attention_fwd"],
            K.LAUNCHES["flash_attention_bwd"]) == before


@pytest.mark.parametrize("shape", [(7, 3), (12, 12), (100, 9)])
def test_lsap_matches_scipy(shape):
    """The copy of the native solver, built from native/lsap.cpp, finds
    an assignment of scipy's optimal cost, rows sorted."""
    from scipy.optimize import linear_sum_assignment

    assert lsap.available()
    cost = np.random.RandomState(shape[0]).rand(*shape)
    rows, cols = lsap.solve(cost)
    ref_rows, ref_cols = linear_sum_assignment(cost)
    assert len(rows) == len(cols) == min(shape)
    assert list(rows) == sorted(rows)
    np.testing.assert_allclose(cost[rows, cols].sum(),
                               cost[ref_rows, ref_cols].sum(), rtol=1e-12)
