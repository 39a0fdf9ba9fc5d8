"""Float-format QAT (FP16_16, FP16_32, TF32) of the port against the JAX
package on the CPU: the straight-through fake-quant, ``matmul_high3``'s
3-pass backward, both block halves' ``qspec`` backwards against
``jax.vjp`` of the JAX ops (their Pallas backward kernels, K2 and K4 with
``qspec``, in interpret mode) in both ``save_acts`` branches, one whole
QAT train step, the parameter converter both ways, and the train CLI
whose checkpoint the eval CLI reads.

Inputs from np.random.RandomState; the ViT as tests/test_torch_vit.py
(80 px, patch 16, dim 64, depth 2, 2 heads of 32, MLP 128)."""
import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myrtle_vision_tpu.models.vit import ViT as JaxViT
from myrtle_vision_tpu.ops import fake_quant as jfq
from myrtle_vision_tpu.ops import fused_attention_block as jfa
from myrtle_vision_tpu.ops import fused_mlp as jfm
from myrtle_vision_tpu.ops import high_precision as jhp
from myrtle_vision_tpu.quantize import QFormat as JaxQFormat
from myrtle_vision_tpu.training import optim as jax_optim
from myrtle_vision_tpu.training.classification import (
    make_loss_fn as jax_loss_fn,
)
from myrtle_vision_tpu.training.trainer import (
    TrainState as JaxState,
    make_train_step as jax_train_step,
)
from myrtle_vision_tpu.utils.export import import_torch_state_dict
from myrtle_vision_tpu_torch.classification import test as eval_cli
from myrtle_vision_tpu_torch.classification import train as train_cli
from myrtle_vision_tpu_torch.models.vit import ViT
from myrtle_vision_tpu_torch.ops import fake_quant as fq
from myrtle_vision_tpu_torch.ops.fused_attention_block import (
    fused_attention_block,
)
from myrtle_vision_tpu_torch.ops.fused_mlp import fused_mlp_block
from myrtle_vision_tpu_torch.ops.high_precision import matmul_high3
from myrtle_vision_tpu_torch.quantize import QSPECS, QFormat, quantize_weight
from myrtle_vision_tpu_torch.training import optim
from myrtle_vision_tpu_torch.training.classification import make_loss_fn
from myrtle_vision_tpu_torch.training.trainer import (
    TrainState,
    make_train_step,
)
from myrtle_vision_tpu_torch.utils.convert import state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(decoder="classification", image_size=80, patch_size=16,
          num_classes=5, dim=64, depth=2, heads=2, mlp_dim=128, dim_head=32)
C, HEADS, HID, B = 64, 2, 128, 3
SCALE = (C // HEADS) ** -0.5
QSPEC_CASES = [(5, 10, True), (5, 10, False), (8, 10, False)]
NAMES = {"attention": ["x", "ln_scale", "ln_bias", "wqkv", "bqkv", "wp",
                       "bp"],
         "mlp": ["x", "ln_scale", "ln_bias", "w1", "b1", "w2", "b2"]}
# Gradients, port against JAX: each leaf within GRAD_BAR of its largest
# magnitude.  Both packages run the same fp32 operations, every product
# 3-pass, and differ in the order of fp32 sums; where that puts a
# recomputed snap (xn, qkv, the context, h, g) on the other side of a
# rounding boundary, one element moves a format step and the weight
# gradient that contracts against it moves by that step times one row's
# term (the prints give the flipped share).  JAX's own fused-against-
# discrete test holds these gradients to 1e-2 of the leaf's scale.
GRAD_BAR = 2e-4
TRAIN_CONFIG = dict(optimizer="adamw", opt_eps=1e-8, opt_betas=None,
                    weight_decay=0.05, momentum=0.9, lr=1e-3, clip_grad=None)


# ------------------------------------------------------------------- STE

FAKE_QUANT_MODES = [("float", 5, 10), ("float", 8, 10), ("fixed", 11, 9),
                    ("fixed", 11, 8), ("fixed", 11, 7)]


def ste_inputs(seed):
    """Values at several scales, the halfway ties of the fp16 / TF32
    mantissas and of the fixed-point quanta, saturation, signed zeros; no
    fp32 subnormals (XLA on the CPU flushes them)."""
    rng = np.random.RandomState(seed)
    k = np.arange(-40, 40) + 0.5
    x = np.concatenate([rng.randn(2000) * 10.0 ** e for e in (-3, 0, 2, 5)]
                       + [k * 2.0 ** -10, k * 2.0 ** -9, k * 2.0 ** -7,
                          [0.0, -0.0, 65504.0, 65520.0, -1e6, 6.0, -6.0]])
    return x.astype(np.float32)


@pytest.mark.parametrize("mode,a,b", FAKE_QUANT_MODES)
def test_ste_forward_is_jax_and_gradient_passes_through(mode, a, b):
    x = ste_inputs(a * 100 + b)
    g = np.random.RandomState(1).randn(x.size).astype(np.float32)
    port = fq.float_quantize_ste if mode == "float" else \
        fq.fixed_point_quantize_ste
    ref_fn = jfq.float_quantize_ste if mode == "float" else \
        jfq.fixed_point_quantize_ste
    ref, vjp = jax.vjp(lambda v: ref_fn(v, a, b), jnp.asarray(x))
    (ref_g,) = vjp(jnp.asarray(g))
    for plain in (False, True):
        t = torch.from_numpy(x).requires_grad_()
        out = port(t, a, b, plain)
        out.backward(torch.from_numpy(g))
        np.testing.assert_array_equal(out.detach().numpy().view(np.uint32),
                                      np.asarray(ref).view(np.uint32))
        np.testing.assert_array_equal(t.grad.numpy(), g)
    np.testing.assert_array_equal(np.asarray(ref_g), g)


@pytest.mark.parametrize("q_format", ["FP16_16", "FP16_32", "TF32"])
def test_weight_fake_quant_is_straight_through(q_format):
    """QAT's weight site (the JAX Block's ``_qw``): the format's values
    forward, the gradient to the fp32 parameter unchanged."""
    rng = np.random.RandomState(2)
    w = torch.from_numpy(rng.randn(8, 6).astype(np.float32)).requires_grad_()
    g = torch.from_numpy(rng.randn(8, 6).astype(np.float32))
    q = quantize_weight(w, QFormat[q_format], "linear", False)
    q.backward(g)
    exp_bits = 8 if q_format == "TF32" else 5
    assert torch.equal(q.detach(), fq.float_quantize(w.detach(), exp_bits,
                                                     10))
    assert torch.equal(w.grad, g)
    assert quantize_weight(w, QFormat[q_format], "norm", False) is w


# ----------------------------------------------------------- matmul_high3

@pytest.mark.parametrize("x_shape", [(7, 24), (2, 5, 24)])
def test_matmul_high3_backward_matches_jax(x_shape):
    """The 3-pass backward of both operands, the gradient split too, as
    the JAX custom VJP: per element within 1e-6 of |JAX| plus 1e-6 of the
    largest (fp32 sum order only)."""
    rng = np.random.RandomState(len(x_shape))
    x = rng.randn(*x_shape).astype(np.float32)
    w = rng.randn(24, 16).astype(np.float32)
    g = rng.randn(*x_shape[:-1], 16).astype(np.float32)
    out, vjp = jax.vjp(jhp.matmul_high3, jnp.asarray(x), jnp.asarray(w))
    refs = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    got = matmul_high3(tx, tw)
    got.backward(torch.from_numpy(g))
    for a, r in ((got.detach(), out), (tx.grad, refs[0]), (tw.grad, refs[1])):
        r = np.asarray(r)
        np.testing.assert_allclose(a.numpy(), r, rtol=1e-6,
                                   atol=1e-6 * np.abs(r).max())
    # the gradient's low half counts: a product of its bf16 part alone
    # misses it by far more than the bar
    g_hi = torch.from_numpy(g).to(torch.bfloat16).float()
    dx_hi = torch.matmul(g_hi, torch.from_numpy(w).t())
    assert float((dx_hi - tx.grad).abs().max()) > 1e-4


# ------------------------------------------------------- block halves

def block_inputs(op, n, seed):
    """fp32 numpy x, one half's parameters in the JAX (in, out) layout
    (weights already in the format, as the caller's ``_qw`` gives them),
    and the upstream gradient."""
    rng = np.random.RandomState(seed)
    f = np.float32
    hid = 3 * C if op == "attention" else HID
    x = rng.randn(B, n, C).astype(f)
    w1 = (rng.randn(C, hid) * C ** -0.5).astype(f)
    w2 = (rng.randn(C if op == "attention" else HID, C)
          * hid ** -0.5).astype(f)
    args = [x, (1 + 0.1 * rng.randn(C)).astype(f),
            (0.1 * rng.randn(C)).astype(f), w1,
            (0.1 * rng.randn(hid)).astype(f), w2,
            (0.1 * rng.randn(C)).astype(f)]
    return args, rng.randn(B, n, C).astype(f)


def snap_weights(args, qspec):
    out = list(args)
    for i in (3, 5):
        out[i] = np.array(jfq.float_quantize(jnp.asarray(args[i]),
                                             qspec[0], qspec[1]))
    return out


def check_grads(op, ours, ref, qspec):
    worst = 0.0
    for a, r, name in zip(ours, ref, NAMES[op]):
        assert a.shape == r.shape, name
        d = np.abs(a - r)
        if name == "bqkv":
            # the key third: softmax ignores a per-row shift, so its
            # gradient is zero up to roundoff on both sides
            keep = np.ones(r.shape, bool)
            keep[C:2 * C] = False
            d, r = d[keep], r[keep]
        scale = np.abs(r).max()
        share = d.max() / scale
        past = (d > 1e-6 * scale).mean()
        print(f"{op} {qspec} d{name}: max abs {d.max():.3g}, "
              f"{share:.3g} of the leaf's scale, {past:.4f} of the elements "
              "past 1e-6 of it")
        worst = max(worst, share)
        assert share <= GRAD_BAR, name
    return worst


def jax_vjp(op, args, g, qspec):
    jargs = [jnp.asarray(a) for a in args]
    if op == "attention":
        fn = lambda *a: jfa.fused_attention_block(  # noqa: E731
            *a, HEADS, SCALE, qspec)
    else:
        fn = lambda *a: jfm.fused_mlp_block(*a, qspec)  # noqa: E731
    out, vjp = jax.vjp(fn, *jargs)
    return np.asarray(out), [np.asarray(t) for t in vjp(jnp.asarray(g))]


def torch_grads(op, args, g, qspec):
    tensors = [torch.from_numpy(a).requires_grad_() for a in args]
    if op == "attention":
        out = fused_attention_block(*tensors, HEADS, SCALE, qspec=qspec)
    else:
        out = fused_mlp_block(*tensors, qspec=qspec)
    assert out.grad_fn is not None
    grads = torch.autograd.grad(out, tensors, torch.from_numpy(g))
    for t, gr in zip(tensors, grads):
        assert gr.dtype == torch.float32 and gr.shape == t.shape
    return out.detach().numpy(), [gr.numpy() for gr in grads]


@pytest.mark.parametrize("save", ["0", "1"])
@pytest.mark.parametrize("qspec", QSPEC_CASES)
def test_qspec_attention_backward_matches_jax(qspec, save, monkeypatch):
    # both packages read MVT_SAVE_ACTS through ops/acts_policy.py
    monkeypatch.setenv("MVT_SAVE_ACTS", save)
    args, g = block_inputs("attention", 50, seed=10 + int(save))
    args = snap_weights(args, qspec)
    out_j, ref = jax_vjp("attention", args, g, qspec)
    out, ours = torch_grads("attention", args, g, qspec)
    assert out.shape == out_j.shape
    check_grads("attention", ours, ref, qspec)


@pytest.mark.parametrize("qspec", QSPEC_CASES)
def test_qspec_mlp_backward_matches_jax(qspec):
    args, g = block_inputs("mlp", 50, seed=20)
    args = snap_weights(args, qspec)
    _, ref = jax_vjp("mlp", args, g, qspec)
    _, ours = torch_grads("mlp", args, g, qspec)
    check_grads("mlp", ours, ref, qspec)


def test_saved_and_recomputed_qkv_agree(monkeypatch):
    """The saved qkv rows are the forward's own, so both branches of the
    float attention backward give identical gradients."""
    args, g = block_inputs("attention", 17, seed=30)
    runs = []
    for save in ("0", "1"):
        monkeypatch.setenv("MVT_SAVE_ACTS", save)
        runs.append(torch_grads("attention", args, g, (5, 10, True))[1])
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ train step

# The whole step, port against JAX.  "identity snaps" runs FP16_32 with
# every snap of both packages (the fake-quant, the sites, the kernels'
# in-kernel snaps) replaced by the identity: what is left is the QAT
# machinery itself (the straight-through sites, the 3-pass products and
# their backward, the fused backward chains, AdamW), held to tight bars:
# loss 1e-6 relative, parameters after the step 1e-4, and the gradients
# 1e-4 of each tensor's scale.  With the snaps, the forward
# differs where a snap flips (the block outputs of test_torch_float_
# formats.py: 95% within 3e-5, up to one format step at the largest
# magnitude), so the loss is held to what the logits' difference allows
# (cross entropy moves by at most 2 max|d logits|) and the logits to the
# float ViT's bar, the gradients to STEP_GRAD_BAR of their scale (under
# the 1e-2 of JAX's fused-against-discrete test); the prints give the
# flipped elements at the first snap site (measured 19 and 18 of 3328,
# the gradients 4.2e-4 and 1.1e-3 of their scale in FP16_32 and FP16_16,
# 1e-5 with identity snaps).
STEP_CASES = ["FP16_32", "FP16_16", "identity snaps"]
STEP_GRAD_BAR = {"identity snaps": 1e-4, "FP16_32": 2e-3, "FP16_16": 2e-3}


def identity_snaps(mp):
    """Every snap of both packages as the identity (``mp``: a
    MonkeyPatch)."""
    from myrtle_vision_tpu_torch.ops import _kernels as K

    def same(x, *_):
        return x

    for mod in (jfa, jfm):
        mp.setattr(mod, "_snap", same)
        mp.setattr(mod, "_snap_all", same)
    mp.setattr(jfq, "float_quantize_ste", same)
    for mod, names in ((K, ("snap", "snap_all", "float_quantize")),
                       (fq, ("float_quantize", "float_quantize_rows"))):
        for name in names:
            mp.setattr(mod, name, same)


def first_site_flips(jmodel, params, model, images):
    """Elements of block 0's first snap site (the attention half's xn)
    that the two packages snap to different values, each from its own
    forward's block input, and their count."""
    from myrtle_vision_tpu_torch.ops import _kernels as K

    _, st = jmodel.apply({"params": params}, jnp.asarray(images),
                         capture_intermediates=True, mutable=["intermediates"])
    x_j = np.asarray(st["intermediates"]["emb_drop"]["__call__"][0])
    qspec = QSPECS[model.q_format]
    norm = model.transformer.layers[0]._modules["0"].fn.norm
    scale_ln, bias_ln = (p.detach().numpy() for p in (norm.weight,
                                                       norm.bias))
    xn_j = np.asarray(jfa._qkv_rows(
        jnp.asarray(x_j.reshape(-1, C)), jnp.asarray(scale_ln),
        jnp.asarray(bias_ln), jnp.zeros((C, 3 * C)), jnp.zeros(3 * C),
        qspec)[1])
    with torch.no_grad():
        x = model.embed_float(torch.from_numpy(images)).reshape(-1, C)
        xn = K.layernorm_snap_rows_plain(x, torch.from_numpy(scale_ln),
                                         torch.from_numpy(bias_ln), qspec)
    return int((xn.numpy() != xn_j).sum()), xn_j.size


@pytest.fixture(scope="module", params=STEP_CASES)
def qat_step(request):
    """One QAT step (n_accum 2 micro-batches of 2, AdamW at lr 1e-3)
    through the JAX and the port's make_train_step from one JAX init,
    carried across by the converter; the logits of the first
    micro-batch before it."""
    q_format = "FP16_32" if request.param == "identity snaps" else \
        request.param
    rng = np.random.RandomState(5)
    images = rng.uniform(-1, 1, (2, 2, 80, 80, 3)).astype(np.float32)
    labels = rng.randint(0, 5, (2, 2)).astype(np.int32)
    jmodel = JaxViT(**KW, q_format=JaxQFormat[q_format])
    params = jmodel.init(jax.random.PRNGKey(4),
                         jnp.zeros((1, 80, 80, 3)))["params"]
    init = jax.tree_util.tree_map(np.array, params)  # the step donates
    model = ViT(**KW, q_format=q_format)
    model.load_state_dict(state_dict_from_jax(init), strict=True)
    flips = first_site_flips(jmodel, params, model, images[0])
    with pytest.MonkeyPatch.context() as mp:
        if request.param == "identity snaps":
            identity_snaps(mp)
        jax_logits = np.asarray(jmodel.apply({"params": params},
                                             jnp.asarray(images[0])))
        with torch.no_grad():
            logits = model(torch.from_numpy(images[0])).numpy()
        tx = jax_optim.create_optimizer(TRAIN_CONFIG)
        state = JaxState(params=params, opt_state=tx.init(params), quant={},
                         iteration=jnp.zeros((), jnp.int32))
        loss_fn = jax_loss_fn(jmodel)
        grad_fn = jax.grad(
            lambda p, mb: loss_fn(p, {}, mb, jax.random.PRNGKey(0))[0])
        grads = None
        for i in range(2):
            g = grad_fn(params, {"image": jnp.asarray(images[i]),
                                 "label": jnp.asarray(labels[i])})
            grads = g if grads is None else jax.tree_util.tree_map(
                jnp.add, grads, g)
        grads = jax.tree_util.tree_map(np.asarray, grads)
        step = jax_train_step(loss_fn, tx, 2)
        state, metrics = step(state, {"image": jnp.asarray(images),
                                      "label": jnp.asarray(labels)}, 1e-3,
                              jax.random.PRNGKey(0))
        jax_loss = float(metrics["loss"])
        tstate = TrainState(model,
                            optim.create_optimizer(TRAIN_CONFIG, model))
        metrics = make_train_step(make_loss_fn(model), 2)(
            tstate, {"image": torch.from_numpy(images),
                     "label": torch.from_numpy(labels)}, 1e-3)
    print(f"{request.param}: {flips[0]} of {flips[1]} elements of block 0's "
          f"first snap site flipped; logits max abs "
          f"{np.abs(logits - jax_logits).max():.3g}")
    return dict(
        case=request.param, q_format=q_format, jax_loss=jax_loss,
        loss=float(metrics["loss"]), logits=logits, jax_logits=jax_logits,
        jax_grads=state_dict_from_jax(grads),
        grads={n: p.grad for n, p in model.named_parameters()},
        jax_params=state_dict_from_jax(
            jax.tree_util.tree_map(np.asarray, state.params)),
        params={n: p.detach() for n, p in model.named_parameters()},
        model=model, jax_model=jmodel, jax_init=init)


def test_qat_step_loss_matches_jax(qat_step):
    ours, ref = qat_step["loss"], qat_step["jax_loss"]
    d_logits = np.abs(qat_step["logits"] - qat_step["jax_logits"]).max()
    print(f"{qat_step['case']}: loss {ours!r} vs JAX {ref!r} "
          f"({abs(ours - ref) / abs(ref):.3g} relative), logits "
          f"{d_logits:.3g} apart")
    if qat_step["case"] == "identity snaps":
        assert abs(ours - ref) <= 1e-6 * abs(ref)
        return
    qspec = QSPECS[QFormat[qat_step["q_format"]]]
    largest = np.abs(qat_step["jax_logits"]).max()
    step = 2.0 ** (np.floor(np.log2(largest)) - qspec[1])
    # the float ViT's logit bar (test_torch_float_formats.py)
    assert d_logits <= 1e-4 + step
    assert abs(ours - ref) <= 1e-6 * abs(ref) + 2 * d_logits


def test_qat_step_gradients_match_jax(qat_step):
    ours, ref = qat_step["grads"], qat_step["jax_grads"]
    assert set(ours) == set(ref)
    worst, worst_name = 0.0, ""
    for name, r in ref.items():
        d = (ours[name] - r).abs()
        if name.endswith("to_qkv.bias"):
            d[C:2 * C] = 0  # the key third (see check_grads)
        share = float(d.max()) / max(float(r.abs().max()), 1e-30)
        if share > worst:
            worst, worst_name = share, name
    print(f"{qat_step['case']}: largest gradient difference {worst:.3g} of "
          f"its tensor's scale, in {worst_name}")
    assert worst <= STEP_GRAD_BAR[qat_step["case"]]


def test_qat_step_parameters_match_jax(qat_step):
    """The parameters after the AdamW step within 1e-4 on the elements
    with a defined gradient: above the gradient bar, so that both
    packages agree on its sign (Adam's first step moves an element by
    about lr = 1e-3 whatever its gradient's size, so one whose gradient
    is roundoff moves +-lr on a coin flip; the key third of each qkv
    bias is such, and the unused detection tokens only decay)."""
    ours, ref = qat_step["params"], qat_step["jax_params"]
    grads = qat_step["jax_grads"]
    for name, r in ref.items():
        g = grads[name].abs()
        defined = g > STEP_GRAD_BAR[qat_step["case"]] * float(g.max())
        torch.testing.assert_close(ours[name][defined], r[defined], rtol=0,
                                   atol=1e-4, msg=name)
        rest = (ours[name] - r)[~defined]
        assert rest.numel() == 0 or float(rest.abs().max()) <= 2.2e-3, name


def test_converter_carries_a_float_model_both_ways(qat_step):
    """JAX params -> the port's state dict (utils/convert.py) -> the
    reference names -> JAX params (the JAX package's import) is the
    identity, for the initial and the trained weights; the trained port
    weights run in the JAX model as in the port's."""
    init = qat_step["jax_init"]
    back = import_torch_state_dict(init, {
        n: t.numpy() for n, t in state_dict_from_jax(init).items()},
        "classification")
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(init)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    model = qat_step["model"]
    trained = import_torch_state_dict(init, {
        n: t.detach().numpy() for n, t in model.state_dict().items()},
        "classification")
    img = np.random.RandomState(9).uniform(-1, 1, (2, 80, 80, 3)).astype(
        np.float32)
    ref = np.asarray(qat_step["jax_model"].apply({"params": trained},
                                                  jnp.asarray(img)))
    with torch.inference_mode():
        out = model(torch.from_numpy(img)).numpy()
    # the float ViT's logit bar (test_torch_float_formats.py): 1e-4 plus
    # one fp16 step at the largest logit
    step = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 10)
    assert np.abs(out - ref).max() <= 1e-4 + step


# ------------------------------------------------------------------- CLI

@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_qat")
    data = root / "data"
    subprocess.run(
        [sys.executable, os.path.join(REPO, "classification",
                                      "prepare_synthetic.py"),
         "--out", str(data), "--per_class", "3", "--seed", "5"],
        check=True, capture_output=True,
    )
    with open(os.path.join(REPO, "classification", "data_configs",
                           "data_config_synth.json")) as f:
        data_config = json.load(f)
    data_config["dataset_path"] = str(data)
    path = root / "data_config.json"
    with open(path, "w") as f:
        json.dump(data_config, f)
    return dict(root=root, data_config_path=str(path))


def qat_config(synth, name, q_format):
    config = {
        "train_config": {
            "output_directory": str(synth["root"] / name),
            "checkpoint_path": "", "epochs": 1, "local_batch_size": 4,
            "global_batch_size": 8, "iters_per_checkpoint": 2,
            "iters_per_val": 2, "seed": 7, "drop_last_batch": True,
            "optimizer": "adamw", "opt_eps": 1e-8, "opt_betas": None,
            "clip_grad": 1.0, "momentum": 0.9, "weight_decay": 0.05,
            "scheduler": "cosine", "lr": 1e-3, "lr_noise": None,
            "warmup_lr": 1e-6, "min_lr": 1e-5, "warmup_epochs": 0,
            "pretrained_backbone": None,
        },
        "data_config_path": synth["data_config_path"],
        "vit_config": {
            "decoder": "classification", "image_size": 80,
            "patch_size": 16, "embed_dim": 32, "depth": 1, "heads": 1,
            "mlp_dim": 64, "dropout": 0.0, "emb_dropout": 0.0,
            "q_format": q_format,
        },
    }
    path = synth["root"] / f"{name}.json"
    with open(path, "w") as f:
        json.dump(config, f)
    return str(path), config


def test_qat_cli_trains_and_its_checkpoint_evaluates(synth, capsys):
    cfg, config = qat_config(synth, "qat", "FP16_32")
    state = train_cli.main(["-c", cfg, "--device", "cpu"])
    out = capsys.readouterr().out
    # 21 training images, 8 per step, drop_last: 2 steps in the epoch
    losses = re.findall(r"Iteration (\d+):\tloss=([0-9.]+)\tacc=", out)
    assert [i for i, _ in losses] == ["1", "2"]
    assert all(np.isfinite(float(v)) for _, v in losses)
    assert state.iteration == 2
    assert state.model.q_format == QFormat.FP16_32
    assert all(p.grad is not None for p in state.model.parameters())
    run_dir = out.split("output directory: ")[1].split("\n")[0]
    assert sorted(os.listdir(run_dir)) == ["vit_000000", "vit_000002"]
    # the eval CLI reads the QAT checkpoint into the format's model
    config["train_config"]["checkpoint_path"] = f"{run_dir}/vit_000002"
    eval_cfg = synth["root"] / "qat_eval.json"
    with open(eval_cfg, "w") as f:
        json.dump(config, f)
    gts, preds, logits = eval_cli.main(["-c", str(eval_cfg), "--device",
                                        "cpu"])
    assert len(gts) == len(preds) == logits.shape[0] > 0
    assert torch.isfinite(logits).all()
    with torch.inference_mode():
        model, loader, _ = eval_cli.build_eval(config, torch.device("cpu"))
        batch = next(loader.epoch(0))
        again = model(batch["image"])
    n = len(batch["label"])
    torch.testing.assert_close(again, logits[:n], rtol=0, atol=0)
