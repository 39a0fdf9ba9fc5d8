"""The port's stateless float formats (FP16_16, FP16_32, TF32) against the
JAX package on the CPU: the qtorch fake-quant K11 (the JAX Pallas kernel
in interpret mode) bit for bit, both block halves with a ``qspec`` (the
JAX Pallas kernels in interpret mode) stage by stage and end to end, the
simulation and the converted ViT after a ``strict=True`` load, and
``convert_params`` / ``model_size_mb``.

Inputs from np.random.RandomState; the model as tests/test_torch_vit.py
(80 px, patch 16, dim 64, depth 2, 2 heads of 32, MLP 128).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myrtle_vision_tpu.models.vit import ViT as JaxViT
from myrtle_vision_tpu.ops import fake_quant as jfq
from myrtle_vision_tpu.ops import fused_attention_block as jfa
from myrtle_vision_tpu.ops import fused_mlp as jfm
from myrtle_vision_tpu.ops.high_precision import dot_high3
from myrtle_vision_tpu.quantize import QFormat as JaxQFormat
from myrtle_vision_tpu.quantize import convert_params as jax_convert
from myrtle_vision_tpu.quantize import model_size_mb as jax_size_mb
from myrtle_vision_tpu_torch.models.vit import ViT
from myrtle_vision_tpu_torch.ops import _kernels as K
from myrtle_vision_tpu_torch.ops import fake_quant as fq
from myrtle_vision_tpu_torch.ops.fused_attention_block import (
    fused_attention_block,
)
from myrtle_vision_tpu_torch.ops.fused_mlp import fused_mlp_block
from myrtle_vision_tpu_torch.quantize import (
    QSPECS,
    QFormat,
    act_number_format,
    convert_params,
    model_size_mb,
    weight_number_format,
)
from myrtle_vision_tpu_torch.utils.convert import state_dict_from_jax

FORMATS = ["FP16_16", "FP16_32", "TF32"]
KW = dict(decoder="classification", image_size=80, patch_size=16,
          num_classes=5, dim=64, depth=2, heads=2, mlp_dim=128, dim_head=32)
# the FP32 blocks' bar against the JAX kernels (test_torch_fused_*.py)
TOL = 3e-5
# where the two packages' fp32 sums put a value on the other side of a
# snap's rounding boundary, one step of the format at that element; at a
# snap site at most this share of the elements flips
FLIP_SHARE = 1e-3
# End to end, a flipped site moves the row of every product after it (and
# through a key or value every query of its image): each output element
# within TOL plus one step of the format at the output's largest
# magnitude, and at least this share of them within TOL
END_TO_END_SAME = 0.95


def bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


# ------------------------------------------------------------------- K11

def _inputs(seed):
    """Random values at several scales; halfway ties of the fp16 and TF32
    mantissas and of the fixed-point quanta; saturation; fp16 subnormals;
    signed zeros.  No fp32 subnormals: XLA on the CPU flushes them to zero,
    PyTorch keeps them (the card's test covers them)."""
    rng = np.random.RandomState(seed)
    rand = np.concatenate([rng.randn(3000) * 10.0 ** e
                           for e in (-7, -3, 0, 2, 5)])
    ties = np.concatenate([
        (np.arange(-50, 50) + 0.5) * 2.0 ** -10,   # e5m10 / e8m10 at [1, 2)
        (np.arange(-50, 50) + 0.5) * 2.0 ** -24,   # fp16 subnormal quanta
        (np.arange(-50, 50) + 0.5) * 2.0 ** -9,    # fixed (11, 9)
        (np.arange(-50, 50) + 0.5) * 2.0 ** -8,    # fixed (11, 8)
        (np.arange(-50, 50) + 0.5) * 2.0 ** -7,    # fixed (11, 7)
        2.0 ** 20 * (1.0 + (np.arange(0, 64) + 0.5) * 2.0 ** -10),
    ])
    edge = np.array([0.0, -0.0, 65504.0, 65519.0, 65520.0, -65520.0, 1e6,
                     -1e6, 3.4e38, -3.4e38, 1.1754944e-38, 2.0 ** -14,
                     2.0 ** -15, 2.0 ** -25, 3.0 * 2.0 ** -26, 3.99609375,
                     4.0, -4.0, 4.1, -4.1, 8.0, -8.0, 16.0, -16.0])
    return np.concatenate([rand, ties, edge]).astype(np.float32)


@pytest.mark.parametrize("mode,a,b", [("float", 5, 10), ("float", 8, 10),
                                      ("fixed", 11, 9), ("fixed", 11, 8),
                                      ("fixed", 11, 7)])
def test_fake_quant_rows_matches_the_jax_pallas_kernel(mode, a, b):
    x = _inputs(a * 100 + b)
    x = np.concatenate([x, np.zeros(-len(x) % 37, np.float32)]).reshape(
        37, -1)  # a shape the TPU kernel pads to (rows, 128) tiles
    pallas = (jfq.float_quantize_pallas if mode == "float"
              else jfq.fixed_point_quantize_pallas)
    ref = pallas(jnp.asarray(x), a, b)
    rows = (fq.float_quantize_rows if mode == "float"
            else fq.fixed_point_quantize_rows)
    got = rows(torch.from_numpy(x), a, b)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(bits(got), bits(ref))
    np.testing.assert_array_equal(
        bits(K.fake_quant_rows_plain(torch.from_numpy(x), mode, a, b)),
        bits(ref))


@pytest.mark.parametrize("q_format", FORMATS + ["FP32"])
def test_site_helpers_and_tables_match_jax(q_format):
    from myrtle_vision_tpu.quantize import act_number_format as jax_act
    from myrtle_vision_tpu.quantize import weight_number_format as jax_w

    jq, q = JaxQFormat[q_format], QFormat[q_format]
    for site in ("pre_linear", "post_op", "functional", "gelu_in",
                 "gelu_out", "stub"):
        got, ref = act_number_format(q, site), jax_act(jq, site)
        assert (got and got.name) == (ref and ref.name), site
    for kind in ("linear", "norm"):
        for converted in (False, True):
            got, ref = (weight_number_format(q, kind, converted),
                        jax_w(jq, kind, converted))
            assert (got and got.name) == (ref and ref.name)
    qspec = QSPECS.get(q)
    x = _inputs(3)
    for port, jax_fn in ((fq.snap, jfq.snap), (fq.snap_all, jfq.snap_all)):
        np.testing.assert_array_equal(
            bits(port(torch.from_numpy(x), qspec)),
            bits(jax_fn(jnp.asarray(x), qspec)))


# ------------------------------------------------------ block halves

C, HEADS, HID, B = 64, 2, 128, 3
QSPEC_CASES = [(5, 10, True), (5, 10, False), (8, 10, False)]


def block_inputs(n, seed):
    """fp32 x and both halves' parameters, JAX layout ((in, out)
    weights), weights at std C^-1/2 as a trained block's."""
    rng = np.random.RandomState(seed)
    f = np.float32
    x = rng.randn(B, n, C).astype(f)
    attn = [(1 + 0.1 * rng.randn(C)).astype(f), (0.1 * rng.randn(C)).astype(f),
            (rng.randn(C, 3 * C) * C ** -0.5).astype(f),
            (0.1 * rng.randn(3 * C)).astype(f),
            (rng.randn(C, C) * C ** -0.5).astype(f),
            (0.1 * rng.randn(C)).astype(f)]
    mlp = [(1 + 0.1 * rng.randn(C)).astype(f), (0.1 * rng.randn(C)).astype(f),
           (rng.randn(C, HID) * C ** -0.5).astype(f),
           (0.1 * rng.randn(HID)).astype(f),
           (rng.randn(HID, C) * HID ** -0.5).astype(f),
           (0.1 * rng.randn(C)).astype(f)]
    return x, attn, mlp


def format_step(ref, qspec):
    """One step of the format (exp_bits, man_bits) at each element of
    ``ref``: 2^(exponent - man_bits), the subnormal quantum below the
    smallest normal."""
    exp_bits, man_bits, _ = qspec
    min_exp = 2 - 2 ** (exp_bits - 1)
    e = np.floor(np.log2(np.maximum(np.abs(ref), 2.0 ** min_exp)))
    return 2.0 ** (e - man_bits)


def check_stage(name, got, ref, qspec, addend=None):
    """A stage fed the JAX stage's input: each element within TOL of JAX's
    or, where its snap flipped, one step of the format at that element,
    in at most FLIP_SHARE of the elements.  A residual stage snaps the
    projection before the sum (``addend`` = sum - residual), so a flip
    there is a step at the larger of the two."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, name
    d = np.abs(got - ref)
    flipped = d > TOL
    at = np.abs(ref) if addend is None else np.maximum(np.abs(ref),
                                                        np.abs(addend))
    worst = (d[flipped] / format_step(at[flipped], qspec)).max(initial=0.0)
    print(f"{name}: {int(flipped.sum())} of {d.size} elements flipped "
          f"(largest {worst:.3g} steps of the format), max abs {d.max():.3g}")
    assert worst <= 1.0 + 1e-6, name
    assert flipped.mean() <= FLIP_SHARE, name


def check_end_to_end(got, ref, qspec):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    d = np.abs(got - ref)
    bar = TOL + format_step(np.abs(ref).max(), qspec)
    within = (d <= TOL).mean()
    print(f"block output: {int((d > TOL).sum())} of {d.size} elements past "
          f"{TOL:g}, max abs {d.max():.3g} (bar {bar:.3g})")
    assert d.max() <= bar and within >= END_TO_END_SAME


def _jax_sites(qspec):
    snap = functools.partial(jfq.snap, qspec=qspec)
    snap_all = functools.partial(jfq.snap_all, qspec=qspec)
    return snap, snap_all


@functools.partial(jax.jit, static_argnums=(2,))
def _jax_attention_stages(x2, p, qspec):
    """The JAX kernel body's values site by site (``_qkv_rows``,
    ``_attn_heads_fwd``, then the projection), jitted: the same jnp
    functions the Pallas kernel runs, which the JAX package holds
    bit-identical to it (tests/test_golden_values.py)."""
    snap, snap_all = _jax_sites(qspec)
    scale_ln, bias_ln, wqkv, bqkv, wp, bp = p
    qkv, xn, _, _ = jfa._qkv_rows(x2, scale_ln, bias_ln, wqkv, bqkv, qspec)
    qkv3 = qkv.reshape(B, -1, 3 * C)
    ctx = jnp.concatenate([
        jfa._attn_heads_fwd(qkv3[i], HEADS, (C // HEADS) ** -0.5,
                            jnp.float32, qspec)[0] for i in range(B)])
    ctx = snap(ctx)
    y = snap_all(dot_high3(ctx, wp, (((1,), (0,)), ((), ()))) + bp)
    return xn, qkv, ctx, snap_all(x2 + y)


@functools.partial(jax.jit, static_argnums=(2,))
def _jax_mlp_stages(x2, p, qspec):
    """The JAX MLP kernel body's values site by site, jitted."""
    snap, snap_all = _jax_sites(qspec)
    scale, bias, w1, b1, w2, b2 = p
    mm = functools.partial(dot_high3,
                           dimension_numbers=(((1,), (0,)), ((), ())))
    xn = snap(snap_all(jfm._layernorm_f32(snap(x2), scale, bias)[0]))
    h = snap_all(mm(xn, w1) + b1)
    g = snap(snap_all(jfm.gelu_erf_poly(h)))
    return xn, g, snap_all(x2 + snap_all(mm(g, w2) + b2))


@pytest.mark.parametrize("n", [17, 50])
@pytest.mark.parametrize("qspec", QSPEC_CASES)
def test_qspec_attention_block_matches_jax(qspec, n):
    x, p, _ = block_inputs(n, seed=n)
    x2 = x.reshape(-1, C)
    xn_j, qkv_j, ctx_j, out_j = map(np.asarray, _jax_attention_stages(
        jnp.asarray(x2), tuple(map(jnp.asarray, p)), qspec))
    t = [torch.from_numpy(a) for a in p]
    t2 = torch.from_numpy(x2)
    scale = (C // HEADS) ** -0.5
    # stage by stage, each port stage fed the JAX stage's input
    check_stage("xn", K.layernorm_snap_rows_plain(t2, t[0], t[1], qspec),
                xn_j, qspec)
    check_stage("qkv", K.gemm_f32x3_epilogue_plain(
        torch.from_numpy(xn_j), t[2], t[3], "bias_snap", qspec), qkv_j, qspec)
    check_stage("ctx", K.attention_core_snap_plain(
        torch.from_numpy(qkv_j).view(B, n, 3 * C), HEADS, scale,
        qspec).view(-1, C), ctx_j, qspec)
    check_stage("out", K.gemm_f32x3_epilogue_plain(
        torch.from_numpy(ctx_j), t[4], t[5], "bias_snap_residual_snap", qspec,
        residual=t2), out_j, qspec, addend=out_j - x2)
    # end to end against the Pallas kernel, which the stages compose
    ref = np.asarray(jfa.fused_attention_block(
        jnp.asarray(x), *map(jnp.asarray, p), HEADS, scale, qspec))
    np.testing.assert_array_equal(ref, out_j.reshape(ref.shape))
    got = fused_attention_block(torch.from_numpy(x), *t, HEADS, scale,
                                qspec=qspec)
    assert got.dtype == torch.float32
    check_end_to_end(got, ref, qspec)


@pytest.mark.parametrize("n", [17, 50])
@pytest.mark.parametrize("qspec", QSPEC_CASES)
def test_qspec_mlp_block_matches_jax(qspec, n):
    x, _, p = block_inputs(n, seed=100 + n)
    x2 = x.reshape(-1, C)
    xn_j, g_j, out_j = map(np.asarray, _jax_mlp_stages(
        jnp.asarray(x2), tuple(map(jnp.asarray, p)), qspec))
    t = [torch.from_numpy(a) for a in p]
    t2 = torch.from_numpy(x2)
    check_stage("xn", K.layernorm_snap_rows_plain(t2, t[0], t[1], qspec),
                xn_j, qspec)
    check_stage("gelu", K.gemm_f32x3_epilogue_plain(
        torch.from_numpy(xn_j), t[2], t[3], "bias_snap_gelu_snap", qspec),
        g_j, qspec)
    check_stage("out", K.gemm_f32x3_epilogue_plain(
        torch.from_numpy(g_j), t[4], t[5], "bias_snap_residual_snap", qspec,
        residual=t2), out_j, qspec, addend=out_j - x2)
    ref = np.asarray(jfm.fused_mlp_block(jnp.asarray(x), *map(jnp.asarray, p),
                                         qspec))
    np.testing.assert_array_equal(ref, out_j.reshape(ref.shape))
    got = fused_mlp_block(torch.from_numpy(x), *t, qspec=qspec)
    check_end_to_end(got, ref, qspec)


def test_qspec_ops_refuse_a_backward():
    """The qspec ops now record and run their backward (QAT): the
    gradients of every input against ``jax.vjp`` of the JAX op (its K2 /
    K4 kernel with qspec in interpret mode), each within 2e-4 of the
    leaf's largest magnitude (the key third of dbqkv, zero up to
    roundoff on both sides, left out); under no_grad nothing records.
    tests/test_torch_float_qat.py holds every format and both save_acts
    branches."""
    qspec = (5, 10, False)
    x, attn, mlp = block_inputs(17, seed=0)
    g = np.random.RandomState(1).randn(*x.shape).astype(np.float32)
    scale = (C // HEADS) ** -0.5
    for op, params in ((fused_attention_block, attn),
                       (fused_mlp_block, mlp)):
        extra = (HEADS, scale) if op is fused_attention_block else ()
        args = [x] + params
        t = [torch.from_numpy(a).requires_grad_() for a in args]
        out = op(*t, *extra, qspec=qspec)
        ours = torch.autograd.grad(out, t, torch.from_numpy(g))
        jax_op = jfa.fused_attention_block if op is fused_attention_block \
            else jfm.fused_mlp_block
        _, vjp = jax.vjp(lambda *a: jax_op(*a, *extra, qspec),
                         *map(jnp.asarray, args))
        for i, (a, r) in enumerate(zip(ours, vjp(jnp.asarray(g)))):
            a, r = a.numpy(), np.asarray(r)
            if op is fused_attention_block and i == 4:
                a, r = np.delete(a, np.s_[C:2 * C]), np.delete(r,
                                                                np.s_[C:2 * C])
            assert np.abs(a - r).max() <= 2e-4 * np.abs(r).max(), (op, i)
        with torch.no_grad():  # nothing records: the forward alone
            assert op(*t, *extra, qspec=qspec).grad_fn is None


# -------------------------------------------------------------------- ViT

@pytest.fixture(scope="module")
def jax_params():
    img = jnp.zeros((1, 80, 80, 3), jnp.float32)
    params = JaxViT(**KW).init(jax.random.PRNGKey(0), img)["params"]
    rng = np.random.RandomState(0)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p, np.float32)
        + (0.05 * rng.randn(*p.shape)).astype(np.float32), params)


@pytest.fixture(scope="module")
def images():
    return np.random.RandomState(1).uniform(-1, 1, (4, 80, 80, 3)).astype(
        np.float32)


@pytest.mark.parametrize("converted", [False, True])
@pytest.mark.parametrize("q_format", FORMATS)
def test_float_vit_matches_jax(jax_params, images, q_format, converted):
    jq = JaxQFormat[q_format]
    params = jax_convert(jax_params, jq) if converted else jax_params
    ref = np.asarray(jax.jit(JaxViT(**KW, q_format=jq,
                                    converted=converted).apply)(
        {"params": params}, jnp.asarray(images)))
    sd = state_dict_from_jax(params)
    model = ViT(**KW, q_format=q_format, converted=converted).eval()
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    for name, t in model.state_dict().items():
        assert t.dtype == sd[name].dtype, name
    with torch.inference_mode():
        out = model(torch.from_numpy(images))
        calibrating = model(torch.from_numpy(images), calibrating=True)
    assert out.dtype == torch.float32 and out.shape == (4, 5)
    assert torch.equal(out, calibrating)  # no state: the same forward
    # the fp32 bar of the FP32 ViT (test_torch_vit.py), plus one step of
    # the format at the largest logit: a snap that the two packages' fp32
    # sums flip moves the logits by up to one step (FP16_16's logits are
    # fp16 values: a flipped logit is exactly one step off)
    d = np.abs(out.numpy() - ref)
    bar = 1e-4 + format_step(np.abs(ref).max(), QSPECS[QFormat[q_format]])
    print(f"{q_format} converted={converted}: logits max abs {d.max():.3g} "
          f"(bar {bar:.3g}), {(d <= 1e-4).mean():.3f} within 1e-4")
    assert d.max() <= bar
    np.testing.assert_array_equal(out.numpy().argmax(-1), ref.argmax(-1))


@pytest.mark.parametrize("q_format", FORMATS)
def test_convert_params_matches_jax(jax_params, q_format):
    jq = JaxQFormat[q_format]
    ref = state_dict_from_jax(jax_convert(jax_params, jq))
    got = convert_params(state_dict_from_jax(jax_params), q_format)
    assert set(got) == set(ref)
    for name, r in ref.items():
        assert got[name].dtype == r.dtype, name
        np.testing.assert_array_equal(got[name].numpy(), r.numpy(),
                                      err_msg=name)
    half = q_format != "TF32"
    assert any(t.dtype == torch.float16 for t in got.values()) == half
    jax_mb = jax_size_mb({"params": jax_convert(jax_params, jq)}, jq, True)
    assert model_size_mb(got) == pytest.approx(jax_mb, rel=0, abs=1e-12)
    assert model_size_mb(state_dict_from_jax(jax_params)) == pytest.approx(
        jax_size_mb({"params": jax_params}, jq, False), rel=0, abs=1e-12)
