"""The port's block-half backwards (the plain PyTorch chains, which CPU
tensors take) against ``jax.vjp`` of the JAX package's fused blocks,
whose Pallas backward kernels run in interpret mode on the CPU.  Same
numpy inputs and upstream gradient on both sides."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myrtle_vision_tpu.ops.fused_attention_block import (
    fused_attention_block as jax_attention,
)
from myrtle_vision_tpu.ops.fused_mlp import fused_mlp_block as jax_mlp
from myrtle_vision_tpu_torch.ops import _kernels as K
from myrtle_vision_tpu_torch.ops.fused_attention_block import (
    fused_attention_block,
    fused_attention_block_plain,
)
from myrtle_vision_tpu_torch.ops.fused_mlp import (
    fused_mlp_block,
    fused_mlp_block_plain,
)

C, HEADS, HID, B = 64, 2, 128, 3
SCALE = (C // HEADS) ** -0.5
NAMES = {"attention": ["x", "ln_scale", "ln_bias", "wqkv", "bqkv", "wp",
                       "bp"],
         "mlp": ["x", "ln_scale", "ln_bias", "w1", "b1", "w2", "b2"]}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def make_inputs(op, n, seed):
    """fp32 numpy arrays: x, the block's parameters in the JAX (in, out)
    layout, and the upstream gradient."""
    rng = np.random.RandomState(seed)

    def r(*shape, std=1.0):
        return (rng.randn(*shape) * std).astype(np.float32)

    hid = 3 * C if op == "attention" else HID
    out = C if op == "attention" else HID
    args = [r(B, n, C, std=0.5), 1 + r(C, std=0.1), r(C, std=0.1),
            r(C, hid, std=0.1), r(hid, std=0.05)]
    args += ([r(C, C, std=0.1)] if op == "attention"
             else [r(out, C, std=0.1)])
    args += [r(C, std=0.05)]
    return args, r(B, n, C)


def cast_like_the_block(args, dt):
    """The dtypes the Block hands the op: activations, LN scale and
    weights in the compute dtype, the biases fp32 (models/vit.py)."""
    return [a if i in (2, 4, 6) else a.astype(dt)
            for i, a in enumerate(args)]


def jax_grads(op, args, g, dtype):
    fn = jax_attention if op == "attention" else jax_mlp
    extra = (HEADS, SCALE) if op == "attention" else ()
    jargs = [jnp.asarray(a) for a in
             cast_like_the_block(args, JDT[dtype])]
    out, vjp = jax.vjp(lambda *a: fn(*a, *extra), *jargs)
    grads = vjp(jnp.asarray(g).astype(out.dtype))
    return [np.asarray(t.astype(jnp.float32)) for t in grads]


def torch_grads(op, args, g, dtype, fn=None):
    dt = getattr(torch, dtype)
    tensors = []
    for i, a in enumerate(args):
        t = torch.from_numpy(a)
        if i not in (2, 4, 6):
            t = t.to(dt)
        tensors.append(t.requires_grad_())
    if fn is None:
        fn = fused_attention_block if op == "attention" else fused_mlp_block
    extra = (HEADS, SCALE) if op == "attention" else ()
    out = fn(*tensors, *extra)
    out.backward(torch.from_numpy(g).to(out.dtype))
    for t in tensors:
        assert t.grad.dtype == t.dtype and t.grad.shape == t.shape
    return [t.grad.float().numpy() for t in tensors]


def assert_grads(op, ours, ref, atol, rtol):
    for a, b, name in zip(ours, ref, NAMES[op]):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("save", ["0", "1"])
@pytest.mark.parametrize("n", [17, 50])
def test_attention_fp32_matches_jax(n, save, monkeypatch):
    # both packages read MVT_SAVE_ACTS through ops/acts_policy.py
    monkeypatch.setenv("MVT_SAVE_ACTS", save)
    args, g = make_inputs("attention", n, seed=n + int(save))
    ours = torch_grads("attention", args, g, "float32")
    ref = jax_grads("attention", args, g, "float32")
    # the bar the JAX kernel's gradients are held to against their
    # reference composition (tests/test_fused_attention_block.py)
    assert_grads("attention", ours, ref, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("n", [17, 50])
def test_mlp_fp32_matches_jax(n):
    args, g = make_inputs("mlp", n, seed=200 + n)
    ours = torch_grads("mlp", args, g, "float32")
    ref = jax_grads("mlp", args, g, "float32")
    assert_grads("mlp", ours, ref, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("op", ["attention", "mlp"])
def test_bf16_matches_jax(op, monkeypatch):
    monkeypatch.setenv("MVT_SAVE_ACTS", "1")
    args, g = make_inputs(op, 50, seed=300)
    ours = torch_grads(op, args, g, "bfloat16")
    ref = jax_grads(op, args, g, "bfloat16")
    # Both round at the same points (do, qs, e, du, ds, dqkv or g and dh,
    # and every bf16 weight gradient) and sum in another order, so a
    # value near a rounding boundary lands one bf16 step (2^-8 relative)
    # apart and carries into the products after it.  Bar per element:
    # 2^-6 relative plus 2^-6 of the gradient's largest magnitude.
    for a, b, name in zip(ours, ref, NAMES[op]):
        atol = 2.0 ** -6 * max(1.0, np.abs(b).max())
        np.testing.assert_allclose(a, b, rtol=2.0 ** -6, atol=atol,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("op", ["attention", "mlp"])
def test_plain_chain_is_the_cpu_op(op):
    """On CPU tensors the op and the plain chain are one computation."""
    args, g = make_inputs(op, 17, seed=5)
    plain = (fused_attention_block_plain if op == "attention"
             else fused_mlp_block_plain)
    a = torch_grads(op, args, g, "bfloat16")
    b = torch_grads(op, args, g, "bfloat16", fn=plain)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_saved_and_recomputed_qkv_agree(monkeypatch):
    """The saved qkv rows are the forward's own, so the two branches of
    the attention backward give identical gradients."""
    args, g = make_inputs("attention", 50, seed=9)
    runs = []
    for save in ("0", "1"):
        monkeypatch.setenv("MVT_SAVE_ACTS", save)
        runs.append(torch_grads("attention", args, g, "bfloat16"))
    for x, y in zip(*runs):
        np.testing.assert_array_equal(x, y)


def test_transposed_weight_views_get_their_gradients():
    """A (in, out) view of a torch (out, in) weight, as the Block passes
    it, receives its gradient through autograd in the torch layout."""
    args, g = make_inputs("mlp", 17, seed=11)
    ref = torch_grads("mlp", args, g, "float32")
    w1 = torch.from_numpy(np.ascontiguousarray(args[3].T)).requires_grad_()
    w2 = torch.from_numpy(np.ascontiguousarray(args[5].T)).requires_grad_()
    rest = [torch.from_numpy(a) for a in args]
    out = fused_mlp_block(rest[0], rest[1], rest[2], w1.t(), rest[4],
                          w2.t(), rest[6])
    out.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(w1.grad.numpy().T, ref[3])
    np.testing.assert_array_equal(w2.grad.numpy().T, ref[5])


def test_no_graph_no_residuals():
    """Without grad the op records nothing, and under grad the forward
    output is the same."""
    args, _ = make_inputs("attention", 17, seed=12)
    t = [torch.from_numpy(a) for a in args]
    with torch.no_grad():
        out = fused_attention_block(*t, HEADS, SCALE)
    assert out.grad_fn is None
    t[3].requires_grad_()
    out2 = fused_attention_block(*t, HEADS, SCALE)
    assert out2.grad_fn is not None
    torch.testing.assert_close(out, out2.detach(), rtol=0, atol=0)


def test_attention_core_bwd_pieces():
    """The core's column sums are the per-image sums of its gradient,
    and the saved statistics are the forward's."""
    rng = np.random.RandomState(13)
    qkv = torch.from_numpy(rng.randn(2, 19, 3 * C).astype(np.float32))
    ctx, m, rs = K.attention_core_plain(qkv, HEADS, SCALE, stats=True)
    torch.testing.assert_close(ctx, K.attention_core_plain(qkv, HEADS, SCALE),
                               rtol=0, atol=0)
    assert m.shape == rs.shape == (2, HEADS, 19)
    d_o = torch.from_numpy(rng.randn(2, 19, C).astype(np.float32))
    dqkv, colsum = K.attention_core_bwd_plain(qkv, d_o, m, rs, HEADS, SCALE)
    torch.testing.assert_close(colsum, dqkv.sum(1), rtol=1e-6, atol=1e-6)
