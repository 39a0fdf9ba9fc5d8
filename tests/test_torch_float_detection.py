"""YOLOS detection in the float formats (FP16_16, FP16_32, TF32) of the
port against the JAX package on the CPU: the 3-pass attention products'
backwards, the fp32 ``xla`` attention core, the fused ``qspec`` attention
block above 256 tokens (the plain version the long CUDA kernels are held
against), the discrete float Block site by site, the detection ViT on both
sides of the fused gate with one QAT train step, and the detection train
and eval CLIs in FP16_32 against the JAX eval CLI.

Inputs from np.random.RandomState; JAX's Pallas kernels run in interpret
mode, as the JAX package's own tests run them on the CPU.  Widths: dim 64,
2 heads of 32, MLP 128, 2 layers."""
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import myrtle_vision_tpu.models.vit as jax_vit
import myrtle_vision_tpu_torch.models.vit as port_vit
from myrtle_vision_tpu.models.detector import (
    build_weight_dict as jax_weight_dict,
    criterion as jax_criterion,
)
from myrtle_vision_tpu.ops import attention as jatt
from myrtle_vision_tpu.ops import fake_quant as jfq
from myrtle_vision_tpu.ops import fused_attention_block as jfa
from myrtle_vision_tpu.ops import high_precision as jhp
from myrtle_vision_tpu.quantize import QFormat as JaxQFormat
from myrtle_vision_tpu.training import optim as jax_optim
from myrtle_vision_tpu.training.trainer import init_train_state
from myrtle_vision_tpu.utils.checkpoint import (
    save_checkpoint as jax_save_checkpoint,
)
from myrtle_vision_tpu.utils.export import import_torch_state_dict
from myrtle_vision_tpu_torch.detection import test as eval_cli
from myrtle_vision_tpu_torch.detection import train as train_cli
from myrtle_vision_tpu_torch.eval.coco_eval import CocoEvaluator
from myrtle_vision_tpu_torch.models.detector import criterion
from myrtle_vision_tpu_torch.ops import _kernels as K
from myrtle_vision_tpu_torch.ops.attention import multi_head_attention
from myrtle_vision_tpu_torch.ops.fused_attention_block import (
    fused_attention_block,
)
from myrtle_vision_tpu_torch.ops.high_precision import (
    bdot_pv_high3,
    bdot_qk_high3,
)
from myrtle_vision_tpu_torch.quantize import QSPECS, QFormat, act_quant
from myrtle_vision_tpu_torch.training import optim
from myrtle_vision_tpu_torch.utils.convert import state_dict_from_jax

from test_torch_detection import jax_params as detection_params
from test_torch_detection import run_jax_cli
from test_torch_float_qat import identity_snaps
from test_torch_detection_training import (
    TRAIN_CONFIG,
    WEIGHTS,
    capture_summaries,
    targets,
    write_split,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORMATS = ["FP16_16", "FP16_32", "TF32"]
C, HEADS, D, HID = 64, 2, 32, 128
SCALE = D ** -0.5
# Blocks, port against JAX: within 3e-5, or one step of the format where
# the two packages' fp32 sums put a snap on either side of a rounding
# boundary (two steps where an epilogue snaps twice in series), in at most
# FLIP_SHARE of a site's elements (tests/test_torch_float_formats.py, PR
# 6-7); end to end 95% of a block's elements within 3e-5.
BLOCK_BAR = 3e-5
FLIP_SHARE = 1e-3
# Gradients: each leaf within GRAD_BAR of its largest magnitude
# (tests/test_torch_float_qat.py).
GRAD_BAR = 2e-4
NUM_CLASSES = 3
DET_KW = dict(decoder="detection", image_size=160, patch_size=16,
              num_classes=NUM_CLASSES, dim=C, depth=2, heads=HEADS,
              mlp_dim=HID, dim_head=D, num_det_tokens=10)


def fmt_step(v, qspec):
    """One step of the format (exp_bits, man_bits) at |v| (numpy)."""
    exp_bits, man_bits = qspec[0], qspec[1]
    min_exp = 2 - 2 ** (exp_bits - 1)
    e = np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** min_exp)))
    return np.exp2(e - man_bits)


def flips(label, got, ref, qspec, first=None):
    """The elements of a snapped site past BLOCK_BAR, each within its
    steps of the format (two where ``first``, the first of two values
    snapped in series, is given); returns their share, held to
    FLIP_SHARE."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, label
    d = np.abs(got - ref)
    past = d > BLOCK_BAR
    at, steps = np.abs(ref), 1
    if first is not None:
        at, steps = np.maximum(at, np.abs(np.asarray(first))), 2
    assert (d[past] <= steps * fmt_step(at[past], qspec) + BLOCK_BAR).all(), \
        f"{label}: max abs {d.max():.3g}"
    share = past.mean()
    print(f"{label}: {past.sum()} of {past.size} elements flipped "
          f"({share:.5f}), max abs {d.max():.3g}")
    assert share <= FLIP_SHARE, label
    return share


def grads_close(label, ours, ref, skip_key_bias=False):
    """Each gradient within GRAD_BAR of its leaf's largest magnitude."""
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape, label
    d = np.abs(ours - ref)
    if skip_key_bias:
        # the key third of a qkv bias: softmax ignores a per-row shift,
        # so its gradient is zero up to roundoff on both sides
        d = d.copy()
        d[..., C:2 * C] = 0
    share = d.max() / max(np.abs(ref).max(), 1e-30)
    print(f"{label}: max abs {d.max():.3g}, {share:.3g} of the leaf's scale")
    assert share <= GRAD_BAR, label


# ----------------------------------------------- the 3-pass attention dots

@pytest.mark.parametrize("shape", [(2, 2, 9, 7, 5), (1, 3, 33, 40, 16)])
def test_bdot_backwards_match_jax(shape):
    """bdot_qk_high3 and bdot_pv_high3 with their 3-pass backwards (the
    incoming gradient split too) against jax.vjp of the JAX custom VJPs:
    per element within 1e-6 of |JAX| plus 1e-6 of the largest."""
    b, h, n, m, d = shape
    rng = np.random.RandomState(n)
    q = rng.randn(b, h, n, d).astype(np.float32)
    k = rng.randn(b, h, m, d).astype(np.float32)
    p = rng.rand(b, h, n, m).astype(np.float32)
    v = rng.randn(b, h, m, d).astype(np.float32)
    g_s = rng.randn(b, h, n, m).astype(np.float32)
    g_o = rng.randn(b, h, n, d).astype(np.float32)
    for jfn, fn, a, bb, g in ((jhp.bdot_qk_high3, bdot_qk_high3, q, k, g_s),
                              (jhp.bdot_pv_high3, bdot_pv_high3, p, v, g_o)):
        out, vjp = jax.vjp(jfn, jnp.asarray(a), jnp.asarray(bb))
        refs = vjp(jnp.asarray(g))
        ta = torch.from_numpy(a).requires_grad_()
        tb = torch.from_numpy(bb).requires_grad_()
        got = fn(ta, tb)
        got.backward(torch.from_numpy(g))
        for x, r in ((got.detach(), out), (ta.grad, refs[0]),
                     (tb.grad, refs[1])):
            r = np.asarray(r)
            np.testing.assert_allclose(x.numpy(), r, rtol=1e-6,
                                       atol=1e-6 * np.abs(r).max())
        # the gradient's low half counts: its bf16 part alone misses by far
        # more than the bar
        g_hi = torch.from_numpy(g).to(torch.bfloat16).float()
        ta.grad = tb.grad = None
        fn(ta, tb).backward(g_hi)
        assert float((ta.grad - torch.from_numpy(
            np.asarray(refs[0]))).abs().max()) > 1e-4


# ------------------------------------------------------- the xla core

@pytest.mark.parametrize("seq_valid", [None, 29])
def test_xla_core_matches_jax(seq_valid):
    """The fp32 einsum core (JAX ``impl="xla"``): the output and the q, k,
    v gradients within 2^-16 of each leaf's largest magnitude, keys at or
    past ``seq_valid`` masked.  The two packages part in the order of fp32
    sums; where that moves a score or probability by an ulp across a bf16
    boundary of its split, hi and lo trade a step and the dropped lo.lo
    term moves by up to 2^-16 of the product (measured 1.7e-6 of the
    largest q gradient)."""
    rng = np.random.RandomState(3)
    q, k, v = (rng.randn(2, HEADS, 37, D).astype(np.float32)
               for _ in range(3))
    g = rng.randn(2, HEADS, 37, D).astype(np.float32)

    def jfn(q_, k_, v_):
        return jatt.multi_head_attention(q_, k_, v_, SCALE, impl="xla",
                                         seq_valid=seq_valid)

    out, vjp = jax.vjp(jfn, *(jnp.asarray(t) for t in (q, k, v)))
    refs = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    got = multi_head_attention(*leaves, SCALE, impl="xla",
                               seq_valid=seq_valid)
    got.backward(torch.from_numpy(g))
    for x, r in zip([got.detach()] + [t.grad for t in leaves],
                    [out, *refs]):
        r = np.asarray(r)
        np.testing.assert_allclose(x.numpy(), r, rtol=0,
                                   atol=2.0 ** -16 * np.abs(r).max())
    if seq_valid is not None:
        assert not leaves[1].grad[:, :, seq_valid:].any()
        assert not leaves[2].grad[:, :, seq_valid:].any()


# ------------------------------------------- the long route's shapes

@pytest.mark.parametrize("n,d", [(257, 64), (677, 64), (701, 32), (768, 64),
                                 (1, 32)])
def test_f32_long_plan(n, d):
    """The long route's figures: 64-row tiles, two launches a forward and
    four a backward (the split passes included), the split scratch of K
    and V (forward) and of q, k, v and du (backward) in bf16 rows of n_pad,
    the backward's other scratch, each kernel's threads, ring stages and
    shared memory; outside its lengths and head widths it raises."""
    heads = 384 // d
    plan = K.f32_long_plan(n, d, b=3, heads=heads)
    tiles = -(-n // 64)
    n_pad = 64 * tiles
    assert plan["tiles"] == tiles and plan["n_pad"] == n_pad
    assert plan["scratch"] == {
        "fwd": {"split": (4, 3, heads, n_pad, d)},
        "bwd": {"split": (8, 3, heads, n_pad, d), "rt": (3, heads, n_pad),
                "colpart": (3, tiles, 3 * 384)}}
    assert plan["launches"] == {"fwd": 2, "bwd": 4}
    assert (K.F32_LONG_FWD_LAUNCHES, K.F32_LONG_BWD_LAUNCHES) == (2, 4)
    pair = 2 * 64 * 2 * d  # a 64-row tile's bf16 hi and lo halves
    fwd = plan["fwd"]
    assert fwd["threads"] == 160 and fwd["ctas_per_sm"] == 1
    assert fwd["smem"] == 1024 + fwd["stages"] * pair + 64 * n_pad * 4 + 64
    stages = 2 if d == 64 else 4
    assert plan["dq"] == plan["dkdv"] == {
        "grid": tiles, "rows": 64, "tile": 64, "threads": 128,
        "stages": stages, "ctas_per_sm": 2,
        "smem": 1024 + 2 * pair + stages * 2 * pair + 8 * (1 + 2 * stages)
        + 4 * 4 * 3 * d}
    assert fwd["grid"] == tiles and fwd["rows"] == fwd["tile"] == 64
    for bad in ((K.F32_LONG_MAX_N + 1, d), (0, d), (n, 48)):
        with pytest.raises(ValueError):
            K.f32_long_plan(*bad)


@pytest.mark.parametrize("d", [32, 64])
def test_f32_long_plan_fits_shared_memory(d):
    """At every length from 257 to 768 tokens the forward's score block and
    a ring of at least two stages fit the 232,448 bytes a CTA may ask for,
    the ring taking what the score block leaves (at most four stages: at d
    64 four up to n_pad 640, three at 704, two at 768); above it the
    cluster design's CTAs, a cluster of 1, 2, 4 or 8 holding every key
    tile, fit it too; at every length two backward CTAs fit an SM's
    233,472 bytes with the 1,024 the card keeps for each."""
    pair = 2 * 64 * 2 * d
    seen = set()
    for n in range(257, K.F32_LONG_MAX_N + 1):
        plan = K.f32_long_plan(n, d)
        fwd = plan["fwd"]
        assert fwd["smem"] <= K.F32_LONG_SMEM_OPTIN == 232448, n
        for kernel in ("dq", "dkdv"):
            assert 2 * (plan[kernel]["smem"] + K.CTA_RESERVED_BYTES) <= \
                K.SM_SHARED_BYTES, (n, kernel)
        if plan["sweep"]:
            # the cluster design: a stage for each of a CTA's key tiles,
            # the cluster's CTAs holding every tile
            assert fwd["cluster"] in (1, 2, 4, 8), n
            assert fwd["cluster"] * fwd["stages"] >= plan["tiles"], n
            assert fwd["stages"] <= K.f32_sweep_max_tiles(d), n
            assert fwd["grid"] == plan["tiles"] * fwd["cluster"], n
            continue
        assert 2 <= fwd["stages"] <= K.F32_LONG_FWD_MAX_STAGES, n
        if fwd["stages"] < K.F32_LONG_FWD_MAX_STAGES:
            assert fwd["smem"] + pair > K.F32_LONG_SMEM_OPTIN, n
        seen.add((plan["n_pad"], fwd["stages"]))
    if d == 64:
        assert {(640, 4), (704, 3), (768, 2)} <= seen
    else:
        assert {s for _, s in seen} == {4}


# ------------------------------------------ the fused block above 256 tokens

def attention_inputs(n, seed, qspec):
    """fp32 x, the attention half's parameters in the JAX (in, out) layout,
    the weights in the format (as the caller's ``_qw`` gives them), and
    the upstream gradient."""
    rng = np.random.RandomState(seed)
    f = np.float32
    args = [rng.randn(2, n, C).astype(f), (1 + 0.1 * rng.randn(C)).astype(f),
            (0.1 * rng.randn(C)).astype(f),
            (rng.randn(C, 3 * C) * C ** -0.5).astype(f),
            (0.1 * rng.randn(3 * C)).astype(f),
            (rng.randn(C, C) * C ** -0.5).astype(f),
            (0.1 * rng.randn(C)).astype(f)]
    for i in (3, 5):
        args[i] = np.array(jfq.float_quantize(jnp.asarray(args[i]), qspec[0],
                                              qspec[1]))
    return args, rng.randn(2, n, C).astype(f)


@pytest.mark.parametrize("n", [257, 300])
@pytest.mark.parametrize("q_format", FORMATS)
def test_fused_qspec_attention_above_256_matches_jax(q_format, n):
    """The fused ``qspec`` attention block at the lengths its long CUDA
    kernels take, forward and backward, against the JAX fused kernel (K1
    and K2 in interpret mode): the output within 3e-5 plus one format step
    at its largest magnitude, 95% within 3e-5; every gradient within 2e-4
    of its leaf's largest magnitude."""
    qspec = QSPECS[QFormat[q_format]]
    args, g = attention_inputs(n, n, qspec)
    out_j, vjp = jax.vjp(
        lambda *a: jfa.fused_attention_block(*a, HEADS, SCALE, qspec),
        *(jnp.asarray(a) for a in args))
    refs = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    out = fused_attention_block(*leaves, HEADS, SCALE, qspec=qspec)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    out, out_j = out.detach().numpy(), np.asarray(out_j)
    d = np.abs(out - out_j)
    step = fmt_step(np.abs(out_j).max(), qspec)
    print(f"{q_format} N={n}: output max abs {d.max():.3g}, "
          f"{(d > BLOCK_BAR).mean():.5f} past 3e-5")
    assert d.max() <= BLOCK_BAR + step
    assert (d <= BLOCK_BAR).mean() >= 0.95
    names = ["x", "ln_scale", "ln_bias", "wqkv", "bqkv", "wp", "bp"]
    for gr, r, name in zip(grads, refs, names):
        grads_close(f"{q_format} N={n} d{name}", gr.numpy(), r,
                    skip_key_bias=name == "bqkv")


# ---------------------------------------------------- the discrete Block

def jax_params(kw, q_format, size, seed):
    """A JAX ViT in ``q_format`` and its parameters, every one moved off
    its init (tests/test_torch_detection.py's)."""
    kw = dict(kw, q_format=JaxQFormat[q_format])
    return (jax_vit.ViT(**kw, dtype=jnp.float32),
            detection_params(kw, seed, size))


def port_model(kw, q_format, params):
    model = port_vit.ViT(**kw, q_format=q_format)
    model.load_state_dict(state_dict_from_jax(params, kw["decoder"]),
                          strict=True)
    return model


def discrete(monkeypatch):
    for mod in (jax_vit, port_vit):
        monkeypatch.setattr(mod, "fuses_at", lambda n, h, d: False)


@pytest.mark.parametrize("q_format", FORMATS)
def test_discrete_float_block_matches_jax_site_by_site(q_format,
                                                        monkeypatch):
    """The float Block past the fused gate (``fuses_at`` false in both
    packages), each stage of the port's composition fed the JAX stage's
    input (its intermediates): the snapped sites within 3e-5 or one format
    step, in at most 0.1% of their elements, the unsnapped core within
    3e-5; the port's Block end to end within 3e-5 plus one step at the
    largest magnitude, 95% within 3e-5; its backward (the sites
    straight-through, the 3-pass products' backward, the xla core's) within
    2e-4 of each leaf's largest magnitude, both fed the JAX block input and
    the same output gradient."""
    discrete(monkeypatch)
    q, qspec = QFormat[q_format], QSPECS[QFormat[q_format]]
    kw = dict(DET_KW, decoder="classification", image_size=80,
              num_classes=5)
    jmodel, params = jax_params(kw, q_format, 80, 11)
    model = port_model(kw, q_format, params)
    img = np.random.RandomState(12).uniform(-1, 1, (2, 80, 80, 3)).astype(
        np.float32)
    _, st = jmodel.apply({"params": params}, jnp.asarray(img),
                         capture_intermediates=True,
                         mutable=["intermediates"])
    inter = st["intermediates"]
    layer = inter["transformer"]["layers_0"]

    def jx(path):
        node = layer
        for key in path.split("/"):
            node = node[key]
        return torch.from_numpy(np.asarray(node["__call__"][0]))

    x0 = torch.from_numpy(np.asarray(inter["emb_drop"]["__call__"][0]))
    blk = model.transformer.layers[0]
    a, f = blk._modules["0"].fn, blk._modules["1"].fn
    attn, net = a.fn, f.fn.net

    def core(qkv):
        b, n, _ = qkv.shape
        qh, kh, vh = qkv.view(b, n, 3, HEADS, D).permute(2, 0, 3, 1, 4)
        o = multi_head_attention(qh, kh, vh, SCALE, impl="xla")
        return o.transpose(1, 2).reshape(b, n, C)

    qd, ln = port_vit._qdense_float, port_vit._qlayernorm_float
    stages = [
        ("attn_norm", lambda: ln(a.norm, x0, q, False, True)),
        ("attn/to_qkv", lambda: qd(attn.to_qkv, jx("attn_norm"), q, False,
                                   True)),
        ("attn/quant_out", lambda: core(jx("attn/to_qkv"))),
        ("attn/to_out", lambda: qd(attn.to_out[0], jx("attn/quant_out"), q,
                                   False, True)),
        ("attn_res", lambda: act_quant(jx("attn") + x0, q, "functional",
                                       True)),
        ("ffn_norm", lambda: ln(f.norm, jx("attn_res"), q, False, True)),
        ("ffn/fc1", lambda: qd(net[0], jx("ffn_norm"), q, False, True)),
        ("ffn/gelu", lambda: act_quant(K.gelu_poly(act_quant(
            jx("ffn/fc1"), q, "gelu_in", True)), q, "gelu_out", True)),
        ("ffn/fc2", lambda: qd(net[3], jx("ffn/gelu"), q, False, True)),
        ("ffn_res", lambda: act_quant(jx("ffn") + jx("attn_res"), q,
                                      "functional", True)),
    ]
    with torch.no_grad():
        for site, fn in stages:
            got, ref = fn().numpy(), jx(site).numpy()
            if site == "attn/quant_out":  # the core: no snap
                np.testing.assert_allclose(got, ref, rtol=0, atol=BLOCK_BAR)
            else:
                flips(f"{q_format} {site}", got, ref, qspec)
        out = blk.forward_float(x0).numpy()
    ref = np.asarray(layer["__call__"][0])
    d = np.abs(out - ref)
    assert d.max() <= BLOCK_BAR + fmt_step(np.abs(ref).max(), qspec)
    assert (d <= BLOCK_BAR).mean() >= 0.95

    # the backward: the JAX Block's vjp against the port's autograd
    jblock = jax_vit.Block(C, HEADS, D, HID, 0.0, JaxQFormat[q_format],
                           dtype=jnp.float32, model_depth=2)
    g = np.random.RandomState(13).randn(*ref.shape).astype(np.float32)
    bparams = params["transformer"]["layers_0"]
    _, vjp = jax.vjp(lambda p, x: jblock.apply({"params": p}, x), bparams,
                     jnp.asarray(x0.numpy()))
    dparams, dx_j = vjp(jnp.asarray(g))
    full = jax.tree_util.tree_map(np.zeros_like, params)
    full["transformer"]["layers_0"] = jax.tree_util.tree_map(np.asarray,
                                                             dparams)
    prefix = "transformer.layers.0."
    ref_grads = {n[len(prefix):]: t for n, t in
                 state_dict_from_jax(full).items() if n.startswith(prefix)}
    x = x0.clone().requires_grad_()
    blk.forward_float(x).backward(torch.from_numpy(g))
    grads_close(f"{q_format} dx", x.grad.numpy(), dx_j)
    named = dict(blk.named_parameters())
    assert set(named) == set(ref_grads)
    for name, r in ref_grads.items():
        grads_close(f"{q_format} d{name}", named[name].grad.numpy(), r,
                    skip_key_bias=name.endswith("to_qkv.bias"))


# ----------------------------------------------------- the detection ViT

# canvases on both sides of the fused gate at 2 heads of 32 (fuses_at: up
# to 1321 tokens): 256 px, 16 x 16 patches + cls + 10 det tokens = 267
# (the fused blocks above 256 tokens); 592 px, 37 x 37 + 11 = 1380 (the
# discrete Block)
CANVASES = {"fused_267": 256, "discrete_1380": 592}


def logit_of(p):
    p = np.clip(np.asarray(p, np.float64), 1e-7, 1 - 1e-7)
    return np.log(p / (1 - p))


# The whole QAT step, port against JAX, as tests/test_torch_float_qat.py
# holds the classifier's: "identity snaps" runs FP16_32 with every snap of
# both packages the identity, leaving the QAT machinery (the 3-pass
# products and their backward, the xla core, the fused long-sequence ops,
# the straight-through sites, AdamW) to tight bars: the loss within 1e-6
# relative, each gradient within 1e-4 of its leaf's largest magnitude.
# With the snaps, a snap that the two packages' fp32 sums put on either
# side of a rounding boundary moves an element a format step, and the
# network carries it into the outputs (measured up to one step of the
# largest logit) and the gradients (measured up to 7.3e-4 of a leaf's
# scale): the loss within 1e-4 relative, the gradients within 2e-3 of
# their scale (STEP_GRAD_BAR of the classifier's step).  Either way the
# parameters after the AdamW step within 1e-4 where the gradient is
# defined (above the gradient bar), and both packages' backward is fed
# JAX's output gradient (GIoU's min and max can flip with a snap,
# ROADMAP C6).
STEP_CASES = FORMATS + ["identity snaps"]
STEP_GRAD_BAR = {"identity snaps": 1e-4, "FP16_16": 2e-3, "FP16_32": 2e-3,
                 "TF32": 2e-3}


@pytest.mark.parametrize("canvas", list(CANVASES))
@pytest.mark.parametrize("case", STEP_CASES)
def test_detection_vit_qat_step_matches_jax(case, canvas, monkeypatch):
    """The detection ViT in a float format against JAX's after a strict
    load, on one side of the fused gate or the other: the eval outputs
    (logits within 1e-4 plus one format step at the largest logit, boxes
    within 1e-4 plus a quarter step at the largest pre-sigmoid magnitude,
    the sigmoid's largest slope); one QAT train step of two images: the
    loss, every parameter gradient and the parameters after the AdamW step
    under the bars above."""
    size = CANVASES[canvas]
    n = (size // 16) ** 2 + 11
    assert port_vit.fuses_at(n, HEADS, D) == (canvas == "fused_267")
    check_qat_step(case, DET_KW, size, canvas, monkeypatch)


def check_qat_step(case, kw, size, canvas, monkeypatch):
    """The check of :func:`test_detection_vit_qat_step_matches_jax` for
    the detection ViT of ``kw`` on two images of ``size`` px."""
    q_format = "FP16_32" if case == "identity snaps" else case
    if case == "identity snaps":
        identity_snaps(monkeypatch)
    qspec = QSPECS[QFormat[q_format]]
    grad_bar = STEP_GRAD_BAR[case]
    c = kw["dim"]
    jmodel, params = jax_params(kw, q_format, 160, 21)
    model = port_model(kw, q_format, params)
    rng = np.random.RandomState(size)
    img = rng.uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    tgt = targets(rng, (2,), kw["num_det_tokens"])

    out_j, vjp = jax.vjp(
        lambda p: jmodel.apply({"params": p}, jnp.asarray(img)), params)

    def jax_total(o):
        losses = jax_criterion(o, {k: jnp.asarray(v) for k, v in
                                   tgt.items()}, NUM_CLASSES,
                               weight_dict=jax_weight_dict(TRAIN_CONFIG))
        return losses["loss"]

    loss_j, g_out = jax.value_and_grad(jax_total)(out_j)
    (grads_j,) = vjp(g_out)

    out = model(torch.from_numpy(img))
    loss = float(criterion(out, {k: torch.from_numpy(v) for k, v in
                                 tgt.items()}, NUM_CLASSES,
                           weight_dict=WEIGHTS)["loss"].detach())
    logits, logits_j = out["pred_logits"].detach().numpy(), np.asarray(
        out_j["pred_logits"])
    boxes, boxes_j = out["pred_boxes"].detach().numpy(), np.asarray(
        out_j["pred_boxes"])
    d_logits = np.abs(logits - logits_j)
    print(f"{case} {canvas}: logits max abs {d_logits.max():.3g}, boxes "
          f"{np.abs(boxes - boxes_j).max():.3g}, loss {loss!r} vs "
          f"{float(loss_j)!r}")
    assert d_logits.max() <= 1e-4 + fmt_step(np.abs(logits_j).max(), qspec)
    assert np.abs(boxes - boxes_j).max() <= 1e-4 + 0.25 * fmt_step(
        np.abs(logit_of(boxes_j)).max(), qspec)
    rel = 1e-6 if case == "identity snaps" else 1e-4
    assert abs(loss - float(loss_j)) <= rel * abs(float(loss_j))

    torch.autograd.backward([out["pred_logits"], out["pred_boxes"]],
                            [torch.from_numpy(np.asarray(g_out[k]))
                             for k in ("pred_logits", "pred_boxes")])
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, grads_j),
                              "detection")
    named = dict(model.named_parameters())
    assert set(named) == set(ref)
    worst, worst_name = 0.0, ""
    for name, r in ref.items():
        d = (named[name].grad - r).abs()
        if name.endswith("to_qkv.bias"):
            d[c:2 * c] = 0  # the key third (see grads_close)
        share = float(d.max()) / max(float(r.abs().max()), 1e-30)
        if share > worst:
            worst, worst_name = share, name
    print(f"{case} {canvas}: largest gradient difference {worst:.3g} of its "
          f"tensor's scale, in {worst_name}")
    assert worst <= grad_bar

    # one AdamW step of each package on its own gradients
    tx = jax_optim.create_optimizer(TRAIN_CONFIG)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    upd, _ = tx.update(grads_j, tx.init(jparams), jparams)
    after_j = state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, jax.tree_util.tree_map(jnp.add, jparams, upd)),
        "detection")
    optim.create_optimizer(TRAIN_CONFIG, model).step()
    for name, want in after_j.items():
        g = ref[name].abs()
        defined = g > grad_bar * float(g.max())
        got = named[name].detach()
        torch.testing.assert_close(got[defined], want[defined], rtol=0,
                                   atol=1e-4, msg=name)
        rest = (got - want)[~defined]
        assert rest.numel() == 0 or float(rest.abs().max()) <= 2.2e-3, name


# ------------------------------------------------------------ CLIs

CLI_VIT = {"decoder": "detection", "image_size": 96, "patch_size": 16,
           "embed_dim": C, "depth": 2, "heads": HEADS, "mlp_dim": HID,
           "dropout": 0.0, "num_det_tokens": 10, "emb_dropout": 0.0,
           "q_format": "FP16_32"}


@pytest.fixture(scope="module")
def cli_setup(tmp_path_factory):
    """A train split of 11 images (global batch 4 of 2 x 2, drop_last: 2
    steps), a val split of 5 that is also the test split, and
    yolos_small.json's train config with this ViT in FP16_32."""
    root = tmp_path_factory.mktemp("torch_float_det")
    write_split(root / "data", "train", 11, 0, 0)
    write_split(root / "data", "val", 5, 1, 1000)
    norm = {"Mean": [0.5, 0.5, 0.5], "Std": [0.5, 0.5, 0.5]}
    data_config = {
        "dataset_path": str(root / "data"), "train_images": "train",
        "valid_images": "val", "test_images": "val",
        "train_annotations": "train.json", "valid_annotations": "val.json",
        "test_annotations": "val.json", "train_subset": None,
        "valid_subset": None, "test_subset": None, "number_of_classes": 2,
        "transform_ops_train": {
            "RandomHorizontalFlip": None,
            "RandomResize": {"scales": [96, 112, 128],
                             "max_size_ratio": [1333, 800]},
            "Normalize": norm},
        "transform_ops_val": {
            "RandomResize": {"scales": [112], "max_size_ratio": [1333, 800]},
            "Normalize": norm},
    }
    with open(root / "data_config.json", "w") as f:
        json.dump(data_config, f)
    with open(os.path.join(REPO, "detection", "train_configs",
                           "yolos_small.json")) as f:
        config = json.load(f)
    config["data_config_path"] = str(root / "data_config.json")
    config["vit_config"] = dict(CLI_VIT)
    config.pop("dist_config")
    config["train_config"].update(
        epochs=1, warmup_epochs=0, lr=1e-3, pretrained_backbone=None,
        distributed=False, checkpoint_path="",
        output_directory=str(root / "port_out"))
    return root, config


def test_float_train_cli_checkpoint_evaluates_as_the_jax_cli(
        cli_setup, monkeypatch, capsys):
    """The port's detection train CLI in FP16_32: two QAT steps with
    finite losses, the checkpoint carrying its format; that checkpoint
    through the port's eval CLI and, as JAX parameters, through the JAX
    ``detection/test.py``: the same COCO summary (within 1e-4) and
    detections; a config of another format refuses the checkpoint."""
    from conftest import load_script_module

    root, config = cli_setup
    cfg = root / "train.json"
    cfg.write_text(json.dumps(config))
    state = train_cli.main(["-c", str(cfg), "--device", "cpu"])
    out = capsys.readouterr().out
    losses = re.findall(r"Iteration (\d+):\tloss=(\S+)\t", out)
    assert [i for i, _ in losses] == ["1", "2"]
    assert all(np.isfinite(float(v)) for _, v in losses)
    assert state.iteration == 2 and state.model.q_format == QFormat.FP16_32
    run_dir = out.split("output directory: ")[1].split("\n")[0]
    ckpt = os.path.join(run_dir, "vit_000002")
    payload = torch.load(ckpt, weights_only=True)
    assert payload["q_format"] == "FP16_32"

    config = json.loads(json.dumps(config))
    config["train_config"]["checkpoint_path"] = ckpt
    eval_cfg = root / "eval.json"
    eval_cfg.write_text(json.dumps(config))
    port_stats = capture_summaries(monkeypatch, CocoEvaluator)
    evaluator, preds = eval_cli.main(["-c", str(eval_cfg), "--device",
                                      "cpu"])
    assert len(preds) == 5 and len(port_stats) == 1

    # the same weights as a JAX checkpoint, through the JAX eval CLI
    data_config = json.loads((root / "data_config.json").read_text())
    kw = jax_vit.vit_kwargs_from_config(config, data_config)
    jmodel = jax_vit.ViT(**kw)
    jstate = init_train_state(jmodel, jax_optim.create_optimizer(
        config["train_config"]), jax.random.PRNGKey(0),
        jnp.zeros((1, 96, 96, 3)))
    params = import_torch_state_dict(
        jax.tree_util.tree_map(np.asarray, jstate.params),
        {n: t.numpy() for n, t in payload["model"].items()}, "detection")
    jstate = jstate.replace(params=jax.tree_util.tree_map(jnp.asarray,
                                                          params))
    jax_save_checkpoint(jstate, str(root / "jax_ckpt"))
    config["train_config"]["checkpoint_path"] = str(root / "jax_ckpt")
    jax_cfg = root / "jax_eval.json"
    jax_cfg.write_text(json.dumps(config))
    ref_preds, ref_stats = run_jax_cli(str(jax_cfg), monkeypatch)
    assert sorted(preds) == sorted(ref_preds)
    worst = {"scores": 0.0, "boxes": 0.0}
    for img_id, got in preds.items():
        want = ref_preds[img_id]
        np.testing.assert_array_equal(got["labels"], want["labels"])
        for key in worst:
            worst[key] = max(worst[key], float(np.abs(
                got[key] - want[key]).max()))
    print(f"COCO stats, port {port_stats[0]} vs JAX {ref_stats}; "
          f"detections max abs {worst}")
    np.testing.assert_allclose(port_stats[0], ref_stats, rtol=0, atol=1e-4)
    # the detection ViT's output bars above (a format step of a logit, a
    # quarter step of a box's pre-sigmoid value) in probability and in the
    # pixels of these images (at most 128 px): 1e-3 and 0.05 px
    assert worst["scores"] <= 1e-3 and worst["boxes"] <= 0.05

    config["vit_config"]["q_format"] = "FP32"
    config["train_config"]["checkpoint_path"] = ckpt
    with pytest.raises(ValueError, match="q_format FP16_32"):
        eval_cli.build_eval(config, torch.device("cpu"))


def test_int8_detection_still_raises(cli_setup):
    """INT8 detection builds and trains now: the train CLI's
    ``build_train`` takes a PyTorchINT8 config, and one step of the
    one-pass QAT loss (training/detection.py) on its first batch gives a
    finite loss, a gradient for every parameter and observers that have
    folded the batch in (tests/test_torch_int8_detection.py holds the step
    and the CLIs against JAX).  A converted INT8 detector, which no JAX
    CLI builds, is still refused."""
    from myrtle_vision_tpu_torch.models.detector import build_weight_dict
    from myrtle_vision_tpu_torch.quantize import ActQuant
    from myrtle_vision_tpu_torch.training.detection import make_loss_fn

    with pytest.raises(NotImplementedError, match="converted PyTorchINT8"):
        port_vit.ViT(**DET_KW, q_format="PyTorchINT8", converted=True)
    _, config = cli_setup
    config = json.loads(json.dumps(config))
    config["vit_config"]["q_format"] = "PyTorchINT8"
    model, loader, _, _, (micro, n_accum) = train_cli.build_train(
        config, torch.device("cpu"))
    assert model.int8 and not model.converted
    epoch = loader.epoch(0)
    batch = next(epoch)
    epoch.close()
    loss_fn = make_loss_fn(model, 2, build_weight_dict(config[
        "train_config"]), config["train_config"]["eos_coef"])
    loss, aux = loss_fn({k: batch[k][:micro] for k in
                         ("image", "labels", "boxes", "valid")})
    loss.backward()
    assert bool(torch.isfinite(loss)) and set(aux["metrics"]) >= {
        "loss_ce", "loss_bbox", "loss_giou"}
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for p in model.parameters())
    observers = [m for m in model.modules() if isinstance(m, ActQuant)]
    assert observers and all(bool(o.min <= o.max) for o in observers)
