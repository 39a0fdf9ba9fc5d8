"""PyTorchINT8 QAT of the port against the JAX package on the CPU: the
observer-site snap bit for bit, both two-pass block halves
(``fused_attention_block_i8`` / ``fused_mlp_block_i8``, the JAX ones run
through their Pallas kernels K1-K4 with ``qspec="int8"`` in interpret
mode) forward and backward, the simulation's eval forward, the two-pass
train step against the JAX one-pass and two-pass steps, and the train
CLI against the JAX CLI, its checkpoint through the eval and PTQ CLIs.

Inputs from np.random.RandomState; the ViT as tests/test_fused_int8_qat.py
builds it (80 px, patch 16, dim 32, depth 2, 2 heads of 16, MLP 64)."""
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

import myrtle_vision_tpu.models.vit as jax_vit
from myrtle_vision_tpu.models.vit import ViT as JaxViT
from myrtle_vision_tpu.ops import fake_quant as jfq
from myrtle_vision_tpu.ops import fused_attention_block as jfa
from myrtle_vision_tpu.ops import fused_mlp as jfm
from myrtle_vision_tpu.quantize import QFormat as JaxQFormat
from myrtle_vision_tpu.training import optim as jax_optim
from myrtle_vision_tpu.training.classification import (
    make_loss_fn as jax_loss_fn,
)
from myrtle_vision_tpu.training.trainer import init_train_state
from myrtle_vision_tpu.utils.checkpoint import (
    save_checkpoint as jax_save_checkpoint,
)
from myrtle_vision_tpu_torch.classification import test as eval_cli
from myrtle_vision_tpu_torch.classification import test_quantize as ptq_cli
from myrtle_vision_tpu_torch.classification import train as train_cli
from myrtle_vision_tpu_torch.models import vit as port_vit
from myrtle_vision_tpu_torch.models.vit import Block, ViT
from myrtle_vision_tpu_torch.ops import fake_quant as fq
from myrtle_vision_tpu_torch.ops.fused_attention_block import (
    fused_attention_block_i8,
    fused_attention_block_i8_plain,
)
from myrtle_vision_tpu_torch.ops.fused_mlp import (
    fused_mlp_block_i8,
    fused_mlp_block_i8_plain,
)
from myrtle_vision_tpu_torch.quantize import ActQuant, QFormat, is_observer
from myrtle_vision_tpu_torch.training import optim
from myrtle_vision_tpu_torch.training.classification import make_loss_fn
from myrtle_vision_tpu_torch.training.trainer import (
    TrainState,
    make_train_step,
)
from myrtle_vision_tpu_torch.utils.checkpoint import save_checkpoint
from myrtle_vision_tpu_torch.utils.convert import (
    quant_site_names,
    state_dict_from_jax,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(decoder="classification", image_size=80, patch_size=16,
          num_classes=4, dim=32, depth=2, heads=2, mlp_dim=64, dim_head=16)
C, HEADS, HID, B, N = 32, 2, 64, 3, 26
SCALE = (C // HEADS) ** -0.5
NAMES = {"attention": ["x", "ln_scale", "ln_bias", "wqkv", "bqkv", "wp",
                       "bp"],
         "mlp": ["x", "ln_scale", "ln_bias", "w1", "b1", "w2", "b2"]}
# Block halves, port (plain chain) against the JAX Pallas kernels in
# interpret mode: both run the same fp32 operations and differ in the
# order of fp32 sums; such a difference is below 3e-5 unless it moves a
# value across a rounding edge of a site's rint, which moves that element
# by one step of the site's grid (its scale) and, through the products
# after it, the elements that read it.  Bar per output: every element
# within 3e-5 of JAX, or within one grid step of the output's site in at
# most FLIP_SHARE of the elements (the prints give the flips).
FWD_ATOL = 3e-5
FLIP_SHARE = 1e-3
# Gradients against jax.vjp: each leaf within GRAD_BAR of its largest
# magnitude (the float-format halves' bar, tests/test_torch_float_qat.py)
GRAD_BAR = 2e-4
TRAIN_CONFIG = dict(optimizer="adamw", opt_eps=1e-8, opt_betas=None,
                    weight_decay=0.05, momentum=0.9, lr=1e-3, clip_grad=None)


def bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


# ------------------------------------------------------------ the snap

# (scale, zero point, has_stats) rows: a power-of-two scale (x / s exact,
# so the ties below are exact .5 ties), a scale of a real observer, a zero
# point at each end, and a site without statistics
SITES = [(2.0 ** -4, 128.0, 1.0), (0.0123456, 37.0, 1.0),
         (0.05, 0.0, 1.0), (0.05, 255.0, 1.0), (1.1920929e-7, 0.0, 0.0)]


def snap_inputs(site, seed):
    """Values on both sides of the grid, past both clip ends, and the
    halfway ties (k + 1/2) s of the grid."""
    s, zp, _ = site
    rng = np.random.RandomState(seed)
    k = np.arange(-300, 300) + 0.5
    x = np.concatenate([rng.randn(3000) * s * 40, rng.randn(500) * s * 400,
                        k * s, [0.0, -0.0, 1e6, -1e6, (255 - zp) * s,
                                -zp * s, (255.5 - zp) * s,
                                (-zp - 0.5) * s]])
    return x.astype(np.float32)


@pytest.mark.parametrize("site", SITES)
def test_site_snap_is_jax_bit_for_bit(site):
    """``snap_int8`` of ops/fake_quant.py (the plain version of every
    kernel's INT8 site) against JAX ``snap_int8``, bit for bit, ties,
    clip ends and has_stats 0 included; and against the observer's own
    fake-quant (ActQuant frozen at the same grid)."""
    x = snap_inputs(site, seed=int(site[1]))
    table = np.asarray([site] * 2, np.float32)
    ref = jfq.snap_int8(jnp.asarray(x), "int8", jnp.asarray(table), 1)
    row = torch.from_numpy(table[1])
    got = fq.snap_int8(torch.from_numpy(x), fq.Int8Sites(row, row), 1)
    np.testing.assert_array_equal(bits(got), bits(ref))
    # under a float qspec the INT8 snap is the identity, under Int8Sites
    # the float snaps are
    assert torch.equal(fq.snap_int8(torch.from_numpy(x), (5, 10, True), 0),
                       torch.from_numpy(x))
    assert torch.equal(fq.snap_all(torch.from_numpy(x),
                                   fq.Int8Sites(row)), torch.from_numpy(x))
    if site[2]:
        s, zp, _ = site
        obs = ActQuant()
        obs.min.fill_(-zp * s)
        obs.max.fill_((255 - zp) * s)
        scale, zero, has = obs.int8_qparams()
        table_obs = torch.stack([scale, zero, has.float()])
        np.testing.assert_array_equal(
            bits(fq.snap_int8(torch.from_numpy(x), fq.Int8Sites(table_obs),
                              0)),
            bits(obs(torch.from_numpy(x))))
    else:
        np.testing.assert_array_equal(bits(got), bits(x))


# ------------------------------------------------------- block halves

def block_setup(seed):
    """fp32 x, a calibrated block (the port's discrete calibrating forward
    on x), each half's parameters in the JAX (in, out) layout with the
    weights through their symmetric int8 fake-quant (as the Block passes
    them), its (2, 5, 3) site table, and an upstream gradient."""
    rng = np.random.RandomState(seed)
    f = np.float32
    x = rng.randn(B, N, C).astype(f)
    block = Block(C, HEADS, C // HEADS, HID, 0.0, 2,
                  q_format=QFormat.PyTorchINT8)
    sd = {}
    for name, t in block.state_dict().items():
        if is_observer(name):
            sd[name] = t
        elif name.endswith("norm.weight"):
            sd[name] = torch.from_numpy((1 + 0.1 * rng.randn(C)).astype(f))
        elif t.dim() == 2:
            sd[name] = torch.from_numpy(
                (rng.randn(*t.shape) * t.shape[1] ** -0.5).astype(f))
        else:
            sd[name] = torch.from_numpy((0.1 * rng.randn(*t.shape)).astype(f))
    block.load_state_dict(sd)
    with torch.no_grad():
        block.forward_int8(torch.from_numpy(x))
    table = block.site_table().numpy()
    qkv, out, fc1, fc2 = block._linears()
    a, m = block._modules["0"].fn.norm, block._modules["1"].fn.norm

    def qw(lin):
        w = lin.weight.detach()
        s = torch.clamp(w.abs().max() / 127.5, min=1.1920929e-7)
        return fq.int8_symmetric_fake_quant(w, s).t().contiguous().numpy()

    def vec(t):
        return t.detach().numpy().copy()

    args = {"attention": [x, vec(a.weight), vec(a.bias), qw(qkv),
                          vec(qkv.bias), qw(out), vec(out.bias)],
            "mlp": [x, vec(m.weight), vec(m.bias), qw(fc1), vec(fc1.bias),
                    qw(fc2), vec(fc2.bias)]}
    return args, table, rng.randn(B, N, C).astype(f)


# the site tables of each case: calibrated, and with sites that have no
# statistics yet (fresh observers) at the context / GELU output (row 2)
# and everywhere
TABLE_CASES = ["calibrated", "row 2 fresh", "all fresh"]


def case_table(table, case):
    t = table.copy()
    if case == "row 2 fresh":
        t[2] = (1.1920929e-7, 0.0, 0.0)
    elif case == "all fresh":
        t[:, :] = (1.1920929e-7, 0.0, 0.0)
    return t


def jax_op(op, qs):
    if op == "attention":
        return lambda *a: jfa.fused_attention_block_i8(  # noqa: E731
            *a, jnp.asarray(qs), HEADS, SCALE)
    return lambda *a: jfm.fused_mlp_block_i8(  # noqa: E731
        *a, jnp.asarray(qs))


def port_op(op, qs, plain=False):
    if op == "attention":
        fn = fused_attention_block_i8_plain if plain else \
            fused_attention_block_i8
        return lambda *a: fn(*a, qs, HEADS, SCALE)  # noqa: E731
    fn = fused_mlp_block_i8_plain if plain else fused_mlp_block_i8
    return lambda *a: fn(*a, qs)  # noqa: E731


@pytest.mark.parametrize("case", TABLE_CASES)
@pytest.mark.parametrize("op", ["attention", "mlp"])
def test_int8_half_forward_matches_jax(op, case):
    args, table, _ = block_setup(seed=3)
    args = args[op]
    qs = case_table(table[0 if op == "attention" else 1], case)
    ref = np.asarray(jax_op(op, qs)(*(jnp.asarray(a) for a in args)))
    with torch.no_grad():
        got = port_op(op, torch.from_numpy(qs))(
            *(torch.from_numpy(a) for a in args)).numpy()
        plain = port_op(op, torch.from_numpy(qs), plain=True)(
            *(torch.from_numpy(a) for a in args)).numpy()
    np.testing.assert_array_equal(got, plain)  # the CPU takes the plain chain
    d = np.abs(got - ref)
    step = qs[4, 0] if qs[4, 2] else 0.0
    flips = d > FWD_ATOL
    print(f"{op} {case}: max abs {d.max():.3g}, {int(flips.sum())} of "
          f"{d.size} elements past {FWD_ATOL:g} (site 4 step {step:.4g})")
    assert flips.mean() <= FLIP_SHARE
    assert np.all(d <= FWD_ATOL + step * (1 + 1e-6))


def check_grads(op, ours, ref):
    for a, r, name in zip(ours, ref, NAMES[op]):
        assert a.shape == r.shape, name
        d = np.abs(a - r)
        if name == "bqkv":
            # the key third: softmax ignores a per-row shift, so its
            # gradient is zero up to roundoff on both sides
            keep = np.ones(r.shape, bool)
            keep[C:2 * C] = False
            d, r = d[keep], r[keep]
        share = d.max() / np.abs(r).max()
        print(f"{op} d{name}: max abs {d.max():.3g}, {share:.3g} of the "
              "leaf's scale")
        assert share <= GRAD_BAR, name


@pytest.mark.parametrize("op,save", [("attention", "0"), ("attention", "1"),
                                     ("mlp", "0")])
def test_int8_half_backward_matches_jax(op, save, monkeypatch):
    """Every gradient against ``jax.vjp`` of the JAX op (its Pallas K2 / K4
    with qspec "int8"), the attention in both ``save_acts`` branches (the
    MLP backward recomputes either way); the site table takes no gradient
    (JAX gives it zeros)."""
    # both packages read MVT_SAVE_ACTS through ops/acts_policy.py
    monkeypatch.setenv("MVT_SAVE_ACTS", save)
    args, table, g = block_setup(seed=5 + int(save))
    args = args[op]
    qs = table[0 if op == "attention" else 1]
    jargs = [jnp.asarray(a) for a in args] + [jnp.asarray(qs)]
    if op == "attention":
        fn = lambda *a: jfa.fused_attention_block_i8(  # noqa: E731
            *a, HEADS, SCALE)
    else:
        fn = jfm.fused_mlp_block_i8
    _, vjp = jax.vjp(fn, *jargs)
    ref = [np.asarray(t) for t in vjp(jnp.asarray(g))]
    assert not np.any(ref[-1])  # the JAX rule's zero cotangent for qs
    tensors = [torch.from_numpy(a).requires_grad_() for a in args]
    qs_t = torch.from_numpy(qs).requires_grad_()
    out = port_op(op, qs_t)(*tensors)
    grads = torch.autograd.grad(out, tensors + [qs_t], torch.from_numpy(g),
                                allow_unused=True)
    assert grads[-1] is None
    check_grads(op, [t.numpy() for t in grads[:-1]], ref[:-1])


# ------------------------------------------------------------ the model

@pytest.fixture(scope="module")
def jax_model():
    """The JAX INT8 ViT, its params and fresh quant collection, and four
    images (two micro-batches of two)."""
    model = JaxViT(**KW, q_format=JaxQFormat.PyTorchINT8, dtype=jnp.float32)
    rng = np.random.RandomState(4)
    images = rng.uniform(-1, 1, (2, 2, 80, 80, 3)).astype(np.float32)
    labels = rng.randint(0, 4, (2, 2)).astype(np.int32)
    variables = model.init(jax.random.PRNGKey(3), jnp.asarray(images[0]))
    # the JAX step donates its state: keep host copies
    params = jax.tree_util.tree_map(np.array, variables["params"])
    quant = jax.tree_util.tree_map(np.array, variables["quant"])
    return dict(model=model, params=params, quant=quant, images=images,
                labels=labels)


def port_model(params, quant):
    model = ViT(**KW, q_format="PyTorchINT8")
    model.load_state_dict(state_dict_from_jax(params, quant=quant),
                          strict=True)
    return model


def logits_step(jax_logits):
    """One step of the grid of the logits' site (decoder.linear.act_out)
    at the largest logit: the scale of a calibrated uint8 site is its
    range / 255, which 255 steps span."""
    return float(np.ptp(jax_logits)) / 255.0


def test_simulation_eval_forward_matches_jax(jax_model):
    """The INT8 simulation's eval forward (``calibrating=False``: frozen
    observers, HIGHEST products, the exact erf) against the JAX ViT after
    a strict load with the ``quant`` collection of one calibrating batch:
    logits within 1e-4 plus one step of their site's grid, the same
    argmax, and the observers untouched."""
    m, params = jax_model["model"], jax_model["params"]
    _, upd = m.apply({"params": params, "quant": jax_model["quant"]},
                     jnp.asarray(jax_model["images"][0]), calibrating=True,
                     mutable=["quant"])
    quant = jax.tree_util.tree_map(np.asarray, upd["quant"])
    img = jax_model["images"][1]
    ref = np.asarray(m.apply({"params": params, "quant": quant},
                             jnp.asarray(img)))
    model = port_model(params, quant)
    before = {n: t.clone() for n, t in model.state_dict().items()}
    with torch.inference_mode():
        got = model(torch.from_numpy(img)).numpy()
    site = model.decoder.linear.act_out
    step = float(site.int8_qparams()[0])
    d = np.abs(got - ref).max()
    print(f"eval forward: logits max abs {d:.3g}, the site's step "
          f"{step:.4g}")
    assert d <= 1e-4 + step * (1 + 1e-6)
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))
    for name, t in model.state_dict().items():
        assert torch.equal(t, before[name]), name


@pytest.fixture(scope="module", params=["0", "1"])
def int8_step(request, jax_model):
    """One QAT step (2 micro-batches of 2, AdamW at lr 1e-3) through the
    JAX ``make_loss_fn``, one-pass (MVT_INT8_QAT_FUSE=0) or two-pass (1),
    its gradients summed over the micro-batches and the observers threaded
    through them as the JAX ``make_train_step`` does, then the optax
    update; and through the port's two-pass step, from one JAX init
    carried across by the converter; and the logits of each micro-batch's
    calibrating pass in both packages.  The JAX loss is differentiated
    op by op, as the port runs: the jitted JAX step fuses its fp32
    operations otherwise, which flips a snap's rounding here and there
    (the decoder norm's observer then moves 1e-3 relative), a difference
    of XLA's programs, not of the two packages."""
    m = jax_model["model"]
    params, quant = jax_model["params"], jax_model["quant"]
    images, labels = jax_model["images"], jax_model["labels"]
    jax_logits, q = [], quant
    for i in range(2):
        out, upd = m.apply({"params": params, "quant": q},
                           jnp.asarray(images[i]), calibrating=True,
                           mutable=["quant"])
        jax_logits.append(np.asarray(out))
        q = upd["quant"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MVT_INT8_QAT_FUSE", request.param)
        grad_fn = jax.value_and_grad(jax_loss_fn(m), has_aux=True)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    q, grads, jax_loss = jax.tree_util.tree_map(jnp.asarray, quant), None, 0.0
    for i in range(2):
        (loss, aux), g = grad_fn(jparams, q, {
            "image": jnp.asarray(images[i]),
            "label": jnp.asarray(labels[i])}, jax.random.PRNGKey(i))
        q = aux["quant"]
        jax_loss += float(loss) / 2
        grads = g if grads is None else jax.tree_util.tree_map(jnp.add,
                                                               grads, g)
    tx = jax_optim.create_optimizer(TRAIN_CONFIG)
    opt_state = jax_optim.set_learning_rate(tx.init(jparams), 1e-3)
    updates, _ = tx.update(grads, opt_state, jparams)
    new_params = jax.tree_util.tree_map(lambda p, u: p + u, jparams, updates)
    # the port's passes on a copy, to hold pass 2 against pass 1
    twin = port_model(params, quant)
    pass1, pass2 = [], []
    for i in range(2):
        img = torch.from_numpy(images[i])
        with torch.no_grad():
            pass1.append(twin(img, calibrating=True).numpy())
            pass2.append(twin(img, int8_fused=True).numpy())
    model = port_model(params, quant)
    tstate = TrainState(model, optim.create_optimizer(TRAIN_CONFIG, model))
    metrics = make_train_step(make_loss_fn(model), 2)(
        tstate, {"image": torch.from_numpy(images),
                 "label": torch.from_numpy(labels)}, 1e-3)
    return dict(
        fuse=request.param, jax_loss=jax_loss, loss=float(metrics["loss"]),
        jax_logits=np.stack(jax_logits), pass1=np.stack(pass1),
        pass2=np.stack(pass2), model=model,
        jax_quant=jax.tree_util.tree_map(np.asarray, q),
        jax_grads=state_dict_from_jax(
            jax.tree_util.tree_map(np.asarray, grads)),
        jax_params=state_dict_from_jax(
            jax.tree_util.tree_map(np.asarray, new_params)),
        twin=twin)


def test_two_pass_observers_match_jax(int8_step):
    """The observers after the step within 1e-5 of JAX's ``quant``: pass
    1's, pass 2 folding nothing."""
    sd = int8_step["model"].state_dict()
    twin = int8_step["twin"].state_dict()
    for path, name in quant_site_names(KW["depth"]):
        site = int8_step["jax_quant"]
        for p in path:
            site = site[p]
        for key in ("min", "max"):
            np.testing.assert_allclose(sd[f"{name}.{key}"].numpy(),
                                       site[key], rtol=1e-5, atol=1e-7,
                                       err_msg=name)
            # the passes run on their own copy fold in the same batches
            assert torch.equal(sd[f"{name}.{key}"], twin[f"{name}.{key}"])


def test_two_pass_logits_and_loss_match_jax(int8_step):
    """Pass 2's logits equal pass 1's (on the CPU both run the same plain
    operations in the same order); pass 1's within 1e-4 plus one step of
    the logits' grid of JAX's calibrating forward; the loss within twice
    the logits' difference of the JAX step's."""
    np.testing.assert_array_equal(int8_step["pass2"], int8_step["pass1"])
    d = np.abs(int8_step["pass1"] - int8_step["jax_logits"]).max()
    step = logits_step(int8_step["jax_logits"])
    ours, ref = int8_step["loss"], int8_step["jax_loss"]
    print(f"MVT_INT8_QAT_FUSE={int8_step['fuse']}: loss {ours!r} vs JAX "
          f"{ref!r}, logits {d:.3g} apart (grid step {step:.3g})")
    assert d <= 1e-4 + step
    assert abs(ours - ref) <= 1e-6 * abs(ref) + 2 * d


def test_two_pass_parameters_match_jax(int8_step):
    """The parameters after the AdamW step within 1e-4 on the elements
    with a defined gradient (above 2e-3 of the tensor's largest gradient:
    Adam's first step moves an element by about lr whatever its
    gradient's size, so one whose gradient is roundoff moves +-lr on a
    coin flip; the key third of each qkv bias is such, ROADMAP C6)."""
    model = int8_step["model"]
    ours = {n: p.detach() for n, p in model.named_parameters()}
    grads = {n: p.grad for n, p in model.named_parameters()}
    for name, r in int8_step["jax_params"].items():
        g = grads[name].abs()
        defined = g > 2e-3 * float(g.max())
        torch.testing.assert_close(ours[name][defined], r[defined], rtol=0,
                                   atol=1e-4, msg=name)
        rest = (ours[name] - r)[~defined]
        assert rest.numel() == 0 or float(rest.abs().max()) <= 2.2e-3, name


def test_two_pass_gradients_match_jax(int8_step):
    """Every gradient of the step (summed over both micro-batches) within
    GRAD_BAR of its tensor's largest magnitude of JAX's (the key third of
    each qkv bias left out, see check_grads)."""
    model = int8_step["model"]
    worst, worst_name = 0.0, ""
    for name, r in int8_step["jax_grads"].items():
        d = (dict(model.named_parameters())[name].grad - r).abs()
        if name.endswith("to_qkv.bias"):
            d[C:2 * C] = 0
        share = float(d.max()) / max(float(r.abs().max()), 1e-30)
        if share > worst:
            worst, worst_name = share, name
    print(f"MVT_INT8_QAT_FUSE={int8_step['fuse']}: largest gradient "
          f"difference {worst:.3g} of its tensor's scale, in {worst_name}")
    assert worst <= GRAD_BAR


def test_qat_past_the_fused_gate_raises(jax_model, monkeypatch):
    """Beyond the fused Block's length (``fuses_at`` false in both
    packages) the JAX two-pass step's second pass runs the Block's
    discrete composition, differentiated; the port's pass 2 runs the same
    (``Block.forward_int8``, calibrating with the observers frozen).  One
    micro-batch: pass 2's logits equal pass 1's; the loss within 1e-6
    relative of the JAX step's, the observers within 1e-5 of its
    ``quant``, every gradient within GRAD_BAR of its tensor's largest
    magnitude (the key third of each qkv bias left out).  The calibrating
    and the int8_fused pass still refuse to run together."""
    for mod in (port_vit, jax_vit):
        monkeypatch.setattr(mod, "fuses_at", lambda n, h, d: False)
    monkeypatch.setenv("MVT_INT8_QAT_FUSE", "1")
    m, params, quant = (jax_model[k] for k in ("model", "params", "quant"))
    images, labels = jax_model["images"][0], jax_model["labels"][0]
    (loss_j, aux), grads_j = jax.value_and_grad(jax_loss_fn(m), has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params),
        jax.tree_util.tree_map(jnp.asarray, quant),
        {"image": jnp.asarray(images), "label": jnp.asarray(labels)},
        jax.random.PRNGKey(0))
    model = port_model(params, quant)
    img = torch.from_numpy(images)
    twin = port_model(params, quant)
    with torch.no_grad():
        pass1 = twin(img, calibrating=True)
        pass2 = twin(img, int8_fused=True)
    torch.testing.assert_close(pass2, pass1, rtol=0, atol=0)
    loss, _ = make_loss_fn(model)({"image": img,
                                   "label": torch.from_numpy(labels).long()})
    loss.backward()
    loss = float(loss.detach())
    print(f"past the gate: loss {loss!r} vs JAX {float(loss_j)!r}")
    assert abs(loss - float(loss_j)) <= 1e-6 * abs(float(loss_j))
    sd, jq = model.state_dict(), jax.tree_util.tree_map(np.asarray,
                                                        aux["quant"])
    for path, name in quant_site_names(KW["depth"]):
        site = jq
        for p in path:
            site = site[p]
        for key in ("min", "max"):
            np.testing.assert_allclose(sd[f"{name}.{key}"].numpy(),
                                       site[key], rtol=1e-5, atol=1e-7,
                                       err_msg=name)
    worst, worst_name = 0.0, ""
    named = dict(model.named_parameters())
    for name, r in state_dict_from_jax(
            jax.tree_util.tree_map(np.asarray, grads_j)).items():
        g = named[name].grad  # None where the loss does not reach
        d = ((torch.zeros_like(r) if g is None else g) - r).abs()
        if name.endswith("to_qkv.bias"):
            d[C:2 * C] = 0
        share = float(d.max()) / max(float(r.abs().max()), 1e-30)
        if share > worst:
            worst, worst_name = share, name
    print(f"past the gate: largest gradient difference {worst:.3g} of its "
          f"tensor's scale, in {worst_name}")
    assert worst <= GRAD_BAR
    with pytest.raises(ValueError, match="int8_fused"):
        model(img, calibrating=True, int8_fused=True)


# ------------------------------------------------------------------- CLI

@pytest.fixture(scope="module")
def cli_setup(tmp_path_factory):
    """A synthetic RESISC-layout set, a PyTorchINT8 train config of a tiny
    ViT, and the same initial weights and fresh observers as a JAX
    checkpoint and a port checkpoint at iteration 0."""
    root = tmp_path_factory.mktemp("torch_int8_qat")
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
    with open(root / "data_config.json", "w") as f:
        json.dump(data_config, f)
    config = {
        "train_config": {
            "checkpoint_path": "", "epochs": 1, "local_batch_size": 4,
            "global_batch_size": 8, "iters_per_checkpoint": 2,
            "iters_per_val": 2, "seed": 7, "drop_last_batch": True,
            "optimizer": "adamw", "opt_eps": 1e-8, "opt_betas": None,
            "clip_grad": 1.0, "momentum": 0.9, "weight_decay": 0.05,
            "scheduler": "cosine", "lr": 1e-3, "lr_noise": None,
            "warmup_lr": 1e-6, "min_lr": 1e-5, "warmup_epochs": 0,
            "pretrained_backbone": None, "distributed": False,
        },
        "data_config_path": str(root / "data_config.json"),
        "vit_config": {
            "decoder": "classification", "image_size": 80,
            "patch_size": 16, "embed_dim": 32, "depth": 1, "heads": 1,
            "mlp_dim": 64, "dropout": 0.0, "emb_dropout": 0.0,
            "q_format": "PyTorchINT8",
        },
    }
    from myrtle_vision_tpu.models.vit import vit_kwargs_from_config

    model = JaxViT(**vit_kwargs_from_config(config, data_config))
    state = init_train_state(model, jax_optim.create_optimizer(
        config["train_config"]), jax.random.PRNGKey(0),
        jnp.zeros((1, 80, 80, 3)))
    jax_save_checkpoint(state, str(root / "jax_init"))
    port = ViT(**port_vit.vit_kwargs_from_config(config, data_config))
    port.load_state_dict(state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, state.params),
        quant=jax.tree_util.tree_map(np.asarray, state.quant)), strict=True)
    save_checkpoint(TrainState(port, optim.create_optimizer(
        config["train_config"], port)), str(root / "port_init"))
    configs = {}
    for name in ("jax", "port"):
        config["train_config"].update(
            checkpoint_path=str(root / f"{name}_init"),
            output_directory=str(root / f"{name}_out"))
        configs[name] = str(root / f"{name}.json")
        with open(configs[name], "w") as f:
            json.dump(config, f)
    return root, configs


def shared_step_loss(config, ckpt):
    """The port's two-pass loss of the CLI's second step (its micro-batches
    in order, the observers folding each in) from the JAX CLI's state
    after the first step, parameters and observers, as the port's CLI
    prints it: the mean over the micro-batches."""
    from flax import serialization

    with open(ckpt, "rb") as f:
        payload = serialization.msgpack_restore(f.read())
    data_config = json.loads(open(config["data_config_path"]).read())
    model = ViT(**port_vit.vit_kwargs_from_config(config, data_config))
    model.load_state_dict(state_dict_from_jax(
        payload["model"], quant=payload["quant"]), strict=True)
    _, loader, _, (micro, n_accum) = train_cli.build_train(
        config, torch.device("cpu"))
    batch = list(loader.epoch(0))[1]
    loss_fn = make_loss_fn(model)
    model.train()
    with torch.no_grad():
        losses = [float(loss_fn({k: v.view(n_accum, micro, *v.shape[1:])[i]
                                 for k, v in batch.items()})[0])
                  for i in range(n_accum)]
    return sum(losses) / n_accum


def test_train_cli_matches_jax_cli(cli_setup, monkeypatch, capsys):
    """One epoch of two steps of 2 x 4 images in PyTorchINT8: the port's
    iteration lines against the JAX CLI's (its one-pass step on the CPU),
    then the last checkpoint, observers and all, through
    the eval CLI (the simulation's eval forward) and the PTQ CLI
    (calibrate on, convert, the converted INT8 forward).

    Both CLIs start from one checkpoint, so the first step's line is held
    as it is.  The second step starts from parameters that the two
    packages' fp32 sums left apart by roundoff, which an INT8 snap can
    turn into a whole grid step, and every later observer and grid with
    it (ROADMAP C6): it is held from the state that JAX holds after the
    first step, written by the JAX CLI (``vit_000001``), through the
    port's two-pass loss on the same images; the port CLI's own second
    line is printed beside it."""
    from conftest import load_script_module

    root, configs = cli_setup
    monkeypatch.chdir(root)
    jax_train = load_script_module(
        os.path.join(REPO, "classification", "train.py"),
        "cls_train_for_int8_qat")
    with open(configs["jax"]) as f:
        jax_config = json.load(f)
    jax_config["train_config"]["iters_per_checkpoint"] = 1
    jax_train.train(jax_config)
    jax_out = capsys.readouterr().out
    state = train_cli.main(["-c", configs["port"], "--device", "cpu"])
    out = capsys.readouterr().out
    line = r"Iteration (\d+):\tloss=(\S+)\tacc=(\S+)"
    ours, ref = re.findall(line, out), re.findall(line, jax_out)
    shared = shared_step_loss(jax_config, os.path.join(
        jax_config["train_config"]["output_directory"], "vit_000001"))
    with capsys.disabled():
        print(f"iterations: port {ours}, JAX {ref}; the port's second "
              f"step from JAX's first: {shared:.6f}")
    assert [r[0] for r in ours] == [r[0] for r in ref] == ["1", "2"]
    # the printed losses (4 decimals) as the detection CLI's are held
    np.testing.assert_allclose(np.asarray(ours[0], np.float64)[1:],
                               np.asarray(ref[0], np.float64)[1:],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(shared, float(ref[1][1]), rtol=1e-4,
                               atol=1e-4)
    assert state.iteration == 2 and state.model.q_format == QFormat.PyTorchINT8
    assert re.search(r"val_loss : [0-9.]+ - val_acc: [0-9.]+", out)
    run_dir = out.split("output directory: ")[1].split("\n")[0]
    assert sorted(os.listdir(run_dir)) == ["vit_000000", "vit_000002"]
    ckpt = torch.load(os.path.join(run_dir, "vit_000002"), weights_only=True)
    assert sum(is_observer(n) for n in ckpt["model"]) == 2 * 19
    assert all(float(ckpt["model"][n]) < float("inf") for n in ckpt["model"]
               if n.endswith(".min"))

    with open(configs["port"]) as f:
        config = json.load(f)
    config["train_config"]["checkpoint_path"] = os.path.join(run_dir,
                                                             "vit_000002")
    cfg = root / "int8_eval.json"
    cfg.write_text(json.dumps(config))
    gts, preds, logits = eval_cli.main(["-c", str(cfg), "--device", "cpu"])
    assert len(gts) == len(preds) == logits.shape[0] > 0
    assert torch.isfinite(logits).all()
    with torch.inference_mode():
        model, loader, _ = eval_cli.build_eval(json.loads(cfg.read_text()),
                                               torch.device("cpu"))
        batch = next(loader.epoch(0))
        again = model(batch["image"])
    torch.testing.assert_close(again, logits[:len(batch["label"])], rtol=0,
                               atol=0)
    gts_q, preds_q, logits_q = ptq_cli.main(["-c", str(cfg), "--device",
                                             "cpu", "--calib_steps", "1"])
    capsys.readouterr()
    assert len(preds_q) == len(gts_q) == len(gts)
    assert torch.isfinite(logits_q).all()
