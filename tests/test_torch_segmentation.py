"""DLRSD segmentation of the port against the JAX package on the CPU: the
bilinear upsample, the pixel cross entropy (the -1 of an unlabelled
pixel included), the streaming mIoU and top-k accuracy, the DLRSD
dataset with its joint transforms and the loader's batches, the palette,
the segmentation ViT's forward and one train step in FP32, FP16_32 and
PyTorchINT8 (the calibrating one-pass step), and the train and test CLIs
against the JAX ``segmentation/train.py`` and ``test.py``.

Widths: dim 64, depth 2, 2 heads of 32, MLP 128, 80 px (25 patches + the
cls token = 26 tokens, the fused blocks), 5 classes; inputs from
np.random.RandomState.  The bars are those of the classification tests:
logits within 1e-4 in fp32 (tests/test_torch_vit.py), a float format's
within 1e-4 plus one step of the format at the largest logit
(tests/test_torch_float_qat.py; a snap that the two packages' fp32 sums
put on either side of its rounding edge moves an element by a step), an
INT8 one's within 1e-4 plus one step of the head's output grid and the
observers within 1e-5 (tests/test_torch_int8_detection.py); the loss
within 1e-6 relative plus twice the logits' difference, each gradient
within 2e-4 of its tensor's largest magnitude (FP16_32: 2e-3, see
GRAD_BARS), the key third of each qkv bias left out (its gradient is
roundoff: softmax ignores a per-row shift).  The INT8 step is held
micro-batch by micro-batch, op by op, each JAX micro-batch started from
the port's observers before it (ROADMAP C6: in INT8 a flip moves every
later grid)."""
import json
import os
import random
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from PIL import Image

import myrtle_vision_tpu.models.vit as jax_vit
from myrtle_vision_tpu.data.loader import DataLoader as JaxLoader
from myrtle_vision_tpu.datasets.dlrsd import Dlrsd as JaxDlrsd
from myrtle_vision_tpu.ops.interpolate import resize_bilinear as jax_resize
from myrtle_vision_tpu.quantize import QFormat as JaxQFormat
from myrtle_vision_tpu.training import optim as jax_optim
from myrtle_vision_tpu.training.segmentation import (
    make_loss_fn as jax_loss_fn,
    pixel_cross_entropy as jax_pixel_ce,
)
from myrtle_vision_tpu.training.trainer import init_train_state
from myrtle_vision_tpu.utils import colors as jax_colors
from myrtle_vision_tpu.utils import metrics as jax_metrics
from myrtle_vision_tpu.utils.checkpoint import (
    save_checkpoint as jax_save_checkpoint,
)
from myrtle_vision_tpu_torch.data.loader import DataLoader
from myrtle_vision_tpu_torch.datasets.dlrsd import Dlrsd
from myrtle_vision_tpu_torch.models.vit import ViT
from myrtle_vision_tpu_torch.ops.interpolate import resize_bilinear
from myrtle_vision_tpu_torch.quantize import QSPECS, QFormat, is_observer
from myrtle_vision_tpu_torch.segmentation import test as test_cli
from myrtle_vision_tpu_torch.segmentation import train as train_cli
from myrtle_vision_tpu_torch.training import optim
from myrtle_vision_tpu_torch.training.segmentation import (
    make_loss_fn,
    pixel_cross_entropy,
)
from myrtle_vision_tpu_torch.training.trainer import (
    TrainState,
    make_train_step,
)
from myrtle_vision_tpu_torch.utils import colors, metrics
from myrtle_vision_tpu_torch.utils.checkpoint import save_checkpoint
from myrtle_vision_tpu_torch.utils.convert import (
    quant_site_names,
    state_dict_from_jax,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C, HEADS, HID, DEPTH, NUM_CLASSES, SIZE = 64, 2, 128, 2, 5, 80
KW = dict(decoder="segmentation", image_size=SIZE, patch_size=16,
          num_classes=NUM_CLASSES, dim=C, depth=DEPTH, heads=HEADS,
          mlp_dim=HID, dim_head=C // HEADS)
TRAIN_CONFIG = dict(optimizer="adamw", opt_eps=1e-8, opt_betas=None,
                    weight_decay=0.05, momentum=0.9, lr=1e-3, clip_grad=None)
# each gradient's largest difference as a share of its tensor's largest
# magnitude: 2e-4, and in the float format the float QAT step's bar
# (tests/test_torch_float_qat.py STEP_GRAD_BAR), since a snap the two
# packages round apart moves every gradient behind it (measured here: FP32
# 7.4e-7, PyTorchINT8 2.0e-6, FP16_32 1.95e-4)
GRAD_BARS = {"FP32": 2e-4, "PyTorchINT8": 2e-4, "FP16_32": 2e-3}


# ------------------------------------------------------------ ops

@pytest.mark.parametrize("src,dst", [((14, 14), (224, 224)),
                                     ((5, 5), (80, 80)),
                                     ((14, 10), (224, 160))])
def test_resize_bilinear_matches_jax_and_interpolate(src, dst):
    x = np.random.RandomState(0).randn(2, *src, NUM_CLASSES).astype(
        np.float32)
    # the first call under inference mode, as an eval forward makes it,
    # then one that autograd records (the weights are cached per shape)
    with torch.inference_mode():
        resize_bilinear(torch.from_numpy(x), *dst)
    xt = torch.from_numpy(x).requires_grad_()
    ours = resize_bilinear(xt, *dst)
    ours.sum().backward()
    ours = ours.detach()
    ref = np.asarray(jax_resize(jnp.asarray(x), *dst))
    torch_ref = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2),
                              size=dst, mode="bilinear",
                              align_corners=False).permute(0, 2, 3, 1)
    assert ours.dtype == torch.float32 and ours.shape == (2, *dst,
                                                          NUM_CLASSES)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(ours.numpy(), torch_ref.numpy(), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("labels", ["valid", "with -1", "past the ends"])
def test_pixel_cross_entropy_and_gradient_match_jax(labels):
    """The loss and its gradient against ``jax.value_and_grad`` of the JAX
    loss: a -1 label takes the last class's log-probability (JAX's
    ``take_along_axis`` wraps it), a label past either end gives NaN,
    whose pixel gets no gradient."""
    rng = np.random.RandomState(1)
    logits = rng.randn(2, 6, 7, NUM_CLASSES).astype(np.float32)
    lab = rng.randint(0, NUM_CLASSES, (2, 6, 7)).astype(np.int32)
    if labels != "valid":
        lab[rng.rand(*lab.shape) < 0.3] = -1
    if labels == "past the ends":
        lab[0, 0, :2] = (NUM_CLASSES, -NUM_CLASSES - 1)
    ref, g_ref = jax.value_and_grad(jax_pixel_ce)(jnp.asarray(logits),
                                                  jnp.asarray(lab))
    x = torch.from_numpy(logits).requires_grad_()
    loss = pixel_cross_entropy(x, torch.from_numpy(lab))
    loss.backward()
    loss = float(loss.detach())
    if labels == "past the ends":
        assert np.isnan(float(ref)) and np.isnan(loss)
    else:
        np.testing.assert_allclose(loss, float(ref), rtol=0, atol=1e-6)
    g_ref = np.asarray(g_ref)
    assert np.isfinite(g_ref).all()
    np.testing.assert_allclose(x.grad.numpy(), g_ref, rtol=0, atol=1e-6)
    if labels == "with -1":
        # the -1 pixels pull the last class up, as in JAX
        assert (x.grad.numpy()[lab == -1][:, -1] < 0).all()


def test_miou_and_accuracy_match_jax():
    """Batches with -1 labels and a class absent from every prediction
    and label: the per-class arrays equal, NaN included, and so the
    mIoU's NaN; then top-k accuracy."""
    rng = np.random.RandomState(2)
    ours, ref = metrics.MIoU(6), jax_metrics.MIoU(6)
    for _ in range(3):
        pred = rng.randint(0, 5, (2, 9, 11))  # class 5 never predicted
        label = rng.randint(-1, 5, (2, 9, 11))
        ours.add_batch(torch.from_numpy(pred), torch.from_numpy(label))
        ref.add_batch(pred, label)
    np.testing.assert_array_equal(ours.total_area_intersect,
                                  ref.total_area_intersect)
    np.testing.assert_array_equal(ours.get_per_class_iou(),
                                  ref.get_per_class_iou())
    assert np.isnan(ours.get_per_class_iou()[5])
    assert np.isnan(ours.get_miou()) and np.isnan(ref.get_miou())
    out = rng.randn(7, 10).astype(np.float32)
    target = rng.randint(0, 10, 7)
    for a, b in zip(metrics.accuracy(torch.from_numpy(out),
                                     torch.from_numpy(target), (1, 3, 5)),
                    jax_metrics.accuracy(jnp.asarray(out),
                                         jnp.asarray(target), (1, 3, 5))):
        assert float(a) == float(b)


def test_palette_and_colorize_match_jax():
    assert colors.dlrsd_colors() == jax_colors.dlrsd_colors()
    mask = np.random.RandomState(3).randint(-1, 19, (5, 6))
    np.testing.assert_array_equal(colors.colorize_mask(mask),
                                  jax_colors.colorize_mask(mask))


# ------------------------------------------------------------ data

def write_dlrsd(root, count, size, seed):
    """A DLRSD-layout split of ``count`` random images and masks stored
    1-based as DLRSD stores them, with some 0 pixels (-1 once loaded);
    every file is in train, val and test."""
    rng = np.random.RandomState(seed)
    os.makedirs(root / "imgs")
    os.makedirs(root / "maps")
    lines = []
    for i in range(count):
        img = rng.randint(0, 256, (size, size + 8, 3)).astype(np.uint8)
        mask = rng.randint(1, NUM_CLASSES + 1, (size, size + 8))
        mask[rng.rand(*mask.shape) < 0.05] = 0
        Image.fromarray(img).save(root / "imgs" / f"{i}.png")
        Image.fromarray(mask.astype(np.uint8), mode="L").save(
            root / "maps" / f"{i}.png")
        lines.append(f"imgs/{i}.png,maps/{i}.png")
    for split in ("train", "val", "test"):
        (root / f"{split}_imagepaths.txt").write_text("\n".join(lines))
    (root / "label_map.json").write_text(json.dumps(
        {f"class{c}": c for c in range(NUM_CLASSES)}))
    return str(root)


TRANSFORMS = {
    "train": {"Resize": 88, "RandomResizedCrop": SIZE,
              "RandomHorizontalFlip": None,
              "Normalize": {"Mean": [0.5] * 3, "Std": [0.5] * 3}},
    "eval": {"Resize": SIZE,
             "Normalize": {"Mean": [0.5] * 3, "Std": [0.5] * 3}},
}


@pytest.fixture(scope="module")
def dlrsd(tmp_path_factory):
    return write_dlrsd(tmp_path_factory.mktemp("dlrsd"), 10, 96, 4)


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_dlrsd_and_its_loader_match_jax(dlrsd, mode):
    """The same files through both datasets, the train split shuffled
    from the same Python seed: every item from the same numpy rng
    bit-identical (image and label, the stored 0 as -1), then the
    loaders' batches of an epoch."""
    sets = []
    for cls in (Dlrsd, JaxDlrsd):
        random.seed(11)
        sets.append(cls(mode, dlrsd, f"{'train' if mode == 'train' else 'val'}"
                        "_imagepaths.txt", "label_map.json",
                        TRANSFORMS[mode]))
    ours, ref = sets
    assert ours.imagepaths_and_segmaps == ref.imagepaths_and_segmaps
    n_minus = 0
    for i in range(len(ours)):
        a = ours.__getitem__(i, rng=np.random.default_rng(i))
        b = ref.__getitem__(i, rng=np.random.default_rng(i))
        assert a["image"].shape == (SIZE, SIZE, 3)
        assert a["label"].shape == (SIZE, SIZE)
        assert a["label"].dtype == b["label"].dtype == np.int32
        np.testing.assert_array_equal(a["image"], b["image"])
        np.testing.assert_array_equal(a["label"], b["label"])
        assert a["label"].min() >= -1 and a["label"].max() < NUM_CLASSES
        n_minus += int((a["label"] == -1).sum())
    assert n_minus > 0
    kw = dict(batch_size=4, shuffle=mode == "train", seed=7,
              drop_last=mode == "train", pad_last=mode != "train")
    got = list(DataLoader(ours, device="cpu", **kw).epoch(2))
    want = list(JaxLoader(ref, **kw).epoch(2))
    assert len(got) == len(want) == (2 if mode == "train" else 3)
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for key in a:
            np.testing.assert_array_equal(np.asarray(a[key]),
                                          np.asarray(b[key]), err_msg=key)


# ------------------------------------------------------------ the model

def jax_params(kw, seed):
    model = jax_vit.ViT(**kw, dtype=jnp.float32)
    variables = model.init(jax.random.PRNGKey(seed),
                           jnp.zeros((1, SIZE, SIZE, 3)))
    # LayerNorm scales and biases off their init, every parameter moved
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p, np.float32)
        + (0.05 * rng.randn(*p.shape)).astype(np.float32),
        variables["params"])
    quant = jax.tree_util.tree_map(np.asarray, variables.get("quant", {}))
    return model, params, quant


def port_model(q_format, params, quant=None):
    model = ViT(**KW, q_format=q_format, compute_dtype=torch.float32)
    model.load_state_dict(state_dict_from_jax(
        params, "segmentation", quant if q_format == "PyTorchINT8" else None),
        strict=True)
    return model


def jax_quant_of(sd):
    """The JAX ``quant`` collection of a port model's observers."""
    quant = {}
    for path, name in quant_site_names(DEPTH, "segmentation"):
        node = quant
        for p in path:
            node = node.setdefault(p, {})
        node.update(min=sd[f"{name}.min"].numpy(),
                    max=sd[f"{name}.max"].numpy())
    return quant


def observers_close(model, quant):
    sd = model.state_dict()
    for path, name in quant_site_names(DEPTH, "segmentation"):
        site = quant
        for p in path:
            site = site[p]
        for key in ("min", "max"):
            np.testing.assert_allclose(sd[f"{name}.{key}"].numpy(),
                                       np.asarray(site[key]), rtol=1e-5,
                                       atol=1e-7, err_msg=name)


def logit_bar(q_format, model, ref):
    """1e-4, plus one step of the format at the largest logit, or of the
    INT8 head's output grid."""
    if q_format == "FP32":
        return 1e-4
    if q_format == "PyTorchINT8":
        return 1e-4 + float(model.decoder.linear.act_out.int8_qparams()[0])
    mantissa = QSPECS[QFormat[q_format]][1]
    return 1e-4 + 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - mantissa)


FORMATS = ["FP32", "FP16_32", "PyTorchINT8"]


@pytest.fixture(scope="module", params=FORMATS)
def seg_model(request):
    q_format = request.param
    jmodel, params, quant = jax_params(
        dict(KW, q_format=JaxQFormat[q_format]), 5)
    rng = np.random.RandomState(6)
    images = rng.uniform(-1, 1, (2, 2, SIZE, SIZE, 3)).astype(np.float32)
    labels = rng.randint(0, NUM_CLASSES, (2, 2, SIZE, SIZE)).astype(np.int32)
    labels[rng.rand(*labels.shape) < 0.05] = -1
    return dict(q_format=q_format, jmodel=jmodel, params=params, quant=quant,
                images=images, labels=labels)


def test_forward_matches_jax(seg_model):
    """NHWC pixel logits (B, 80, 80, 5) of the strict-loaded port model
    against the JAX model's: FP32, the FP16_32 simulation and the INT8
    calibrating forward (its observers after it too) and the INT8 eval
    forward from them."""
    q_format, jmodel = seg_model["q_format"], seg_model["jmodel"]
    params, quant = seg_model["params"], seg_model["quant"]
    img = seg_model["images"][0]
    model = port_model(q_format, params, quant)
    calibrating = q_format == "PyTorchINT8"
    variables = {"params": params, **({"quant": quant} if quant else {})}
    if calibrating:
        ref, upd = jmodel.apply(variables, jnp.asarray(img),
                                calibrating=True, mutable=["quant"])
    else:
        ref = jmodel.apply(variables, jnp.asarray(img))
    with torch.no_grad():
        out = model(torch.from_numpy(img), calibrating=calibrating)
    ref = np.asarray(ref)
    assert out.dtype == torch.float32 and out.shape == (2, SIZE, SIZE,
                                                        NUM_CLASSES)
    d = np.abs(out.numpy() - ref).max()
    print(f"{q_format}: pixel logits max abs {d:.3g}, bar "
          f"{logit_bar(q_format, model, ref):.3g}")
    assert d <= logit_bar(q_format, model, ref)
    if calibrating:
        quant = jax.tree_util.tree_map(np.asarray, upd["quant"])
        observers_close(model, quant)
        ref = np.asarray(jmodel.apply({"params": params, "quant": quant},
                                      jnp.asarray(seg_model["images"][1])))
        with torch.inference_mode():
            out = model(torch.from_numpy(seg_model["images"][1]))
        d = np.abs(out.numpy() - ref).max()
        print(f"{q_format} eval forward: max abs {d:.3g}")
        assert d <= logit_bar(q_format, model, ref)


def grads_close(q_format, ours, ref):
    assert set(ours) == set(ref)
    worst, worst_name = 0.0, ""
    for name, r in ref.items():
        diff = (ours[name] - r).abs()
        if name.endswith("to_qkv.bias"):
            diff[C:2 * C] = 0  # the key third
        share = float(diff.max()) / max(float(r.abs().max()), 1e-30)
        if share > worst:
            worst, worst_name = share, name
    print(f"{q_format}: largest gradient difference {worst:.3g} of its "
          f"tensor's scale, in {worst_name}")
    assert worst <= GRAD_BARS[q_format]


def test_train_step_matches_jax(seg_model):
    """One step of two micro-batches of two through the port's
    make_train_step against the JAX make_loss_fn differentiated and
    summed over the same micro-batches: each micro-batch's loss, the
    step's gradients and, in INT8, the observers after each micro-batch
    (JAX op by op from the port's observers before it)."""
    q_format, jmodel = seg_model["q_format"], seg_model["jmodel"]
    params, quant = seg_model["params"], seg_model["quant"]
    images, labels = seg_model["images"], seg_model["labels"]
    int8 = q_format == "PyTorchINT8"

    model = port_model(q_format, params, quant)
    loss_fn = make_loss_fn(model)
    losses, observers = [], []
    model.train()
    for i in range(2):
        observers.append({n: t.clone() for n, t in model.state_dict().items()
                          if is_observer(n)})
        loss, _ = loss_fn({"image": torch.from_numpy(images[i]),
                           "label": torch.from_numpy(labels[i])})
        loss.backward()
        losses.append(float(loss.detach()))
    # a parameter the loss does not reach (the detection tokens) has a
    # zero gradient, as under jax.grad and in the trainer
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
             for n, p in model.named_parameters()}
    after = model.state_dict()

    # the same step through the trainer: the same gradients and losses
    stepped = port_model(q_format, params, quant)
    metrics_ = make_train_step(make_loss_fn(stepped), 2)(
        TrainState(stepped, optim.create_optimizer(TRAIN_CONFIG, stepped)),
        {"image": torch.from_numpy(images),
         "label": torch.from_numpy(labels)}, 1e-3)
    assert float(metrics_["loss"]) == pytest.approx(np.mean(losses),
                                                    rel=1e-6)

    # JAX: its loss differentiated, jitted as its step runs it, but op by
    # op in INT8, each micro-batch from the port's observers before it
    # (ROADMAP C6: XLA's fusions flip INT8 sites the eager program does
    # not)
    grad_fn = jax.value_and_grad(jax_loss_fn(jmodel), has_aux=True)
    apply = jmodel.apply
    if not int8:
        grad_fn, apply = jax.jit(grad_fn), jax.jit(apply)
    jgrads = None
    for i in range(2):
        q = jax_quant_of(observers[i]) if int8 else {}
        batch = {"image": jnp.asarray(images[i]),
                 "label": jnp.asarray(labels[i])}
        (loss_j, aux), g = grad_fn(params, q, batch, jax.random.PRNGKey(0))
        jgrads = g if jgrads is None else jax.tree_util.tree_map(
            jnp.add, jgrads, g)
        # both packages' logits of the micro-batch from the same observers
        run = port_model(q_format, params, q if int8 else None)
        with torch.no_grad():
            logits = run(torch.from_numpy(images[i]),
                         calibrating=int8).numpy()
        if int8:
            ref_logits = apply({"params": params, "quant": q},
                               batch["image"], calibrating=True,
                               mutable=["quant"])[0]
            observers_close(run, jax.tree_util.tree_map(np.asarray,
                                                        aux["quant"]))
        else:
            ref_logits = apply({"params": params}, batch["image"])
        d = float(np.abs(logits - np.asarray(ref_logits)).max())
        print(f"{q_format} micro-batch {i}: loss {losses[i]!r} vs JAX "
              f"{float(loss_j)!r}, logits {d:.3g} apart")
        assert d <= logit_bar(q_format, run, logits)
        # cross entropy moves by at most twice the logits' difference
        assert abs(losses[i] - float(loss_j)) <= \
            1e-6 * abs(float(loss_j)) + 2 * d
    if int8:
        for name in after:
            if is_observer(name):
                assert torch.equal(after[name], stepped.state_dict()[name])
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads),
                              "segmentation")
    grads_close(q_format, grads, ref)
    for name, p in stepped.named_parameters():
        assert torch.equal(p.grad, grads[name]), name


# ------------------------------------------------------------ CLIs

@pytest.fixture(scope="module")
def cli_setup(tmp_path_factory):
    """prepare_synthetic.py's DLRSD-layout data (40 images: 28 train, 4
    val, 8 test), seg_micro_synth.json cut to this ViT in fp32 compute
    (local batch 4, global 8: 3 steps, one validation), and the same
    initial weights as a JAX checkpoint and a port checkpoint at
    iteration 0."""
    root = tmp_path_factory.mktemp("torch_seg_cli")
    subprocess.run(
        [sys.executable, os.path.join(REPO, "segmentation",
                                      "prepare_synthetic.py"),
         "--out", str(root / "data"), "--count", "40", "--seed", "5"],
        check=True, capture_output=True)
    with open(os.path.join(REPO, "segmentation", "data_configs",
                           "data_config_synth.json")) as f:
        data_config = json.load(f)
    data_config["dataset_path"] = str(root / "data")
    with open(root / "data_config.json", "w") as f:
        json.dump(data_config, f)
    with open(os.path.join(REPO, "segmentation", "train_configs",
                           "seg_micro_synth.json")) as f:
        config = json.load(f)
    config["data_config_path"] = str(root / "data_config.json")
    config["vit_config"].update(embed_dim=C, depth=DEPTH, heads=HEADS,
                                mlp_dim=HID, compute_dtype="float32")
    config["train_config"].update(epochs=1, local_batch_size=4,
                                  global_batch_size=8, warmup_epochs=0,
                                  iters_per_checkpoint=100,
                                  iters_per_val=100)
    kw = jax_vit.vit_kwargs_from_config(config, data_config)
    state = init_train_state(jax_vit.ViT(**kw), jax_optim.create_optimizer(
        config["train_config"]), jax.random.PRNGKey(0),
        jnp.zeros((1, SIZE, SIZE, 3)))
    jax_save_checkpoint(state, str(root / "jax_init"))
    port = ViT(**dict(KW, compute_dtype=torch.float32))
    port.load_state_dict(state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, state.params), "segmentation"),
        strict=True)
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


def capture_miou(monkeypatch):
    """Every JAX MIoU's per-class IoU when it is read."""
    seen = []
    per_class = jax_metrics.MIoU.get_per_class_iou

    def capture(self):
        seen.append(per_class(self))
        return seen[-1]

    monkeypatch.setattr(jax_metrics.MIoU, "get_per_class_iou", capture)
    return seen


def test_train_and_test_clis_match_jax_clis(cli_setup, monkeypatch, capsys):
    """The train CLIs from the same initial checkpoint: the same
    iteration lines (to 1e-4) and validation mIoU; the port's final
    checkpoint through the port's test CLI and, as a JAX checkpoint,
    through the JAX ``test.py``: the same per-class IoU (mIoU delta 0),
    and the PNGs written."""
    from conftest import load_script_module
    from myrtle_vision_tpu.utils.export import import_torch_state_dict

    root, configs = cli_setup
    monkeypatch.chdir(root)  # the JAX CLI's scalar logs go to ./runs
    seg_train = load_script_module(
        os.path.join(REPO, "segmentation", "train.py"), "seg_train_for_port")
    with open(configs["jax"]) as f:
        seg_train.train(json.load(f))
    jax_out = capsys.readouterr().out
    state = train_cli.main(["-c", configs["port"], "--device", "cpu"])
    out = capsys.readouterr().out
    line = r"Iteration (\d+):\tloss=(\S+)\tacc=(\S+)"
    ours, ref = re.findall(line, out), re.findall(line, jax_out)
    print(f"port {ours}\nJAX  {ref}")
    assert [r[0] for r in ours] == [r[0] for r in ref] == ["1", "2", "3"]
    np.testing.assert_allclose(np.asarray(ours, np.float64)[:, 1:],
                               np.asarray(ref, np.float64)[:, 1:],
                               rtol=1e-4, atol=1e-4)
    mious = [re.findall(r"miou is (\S+)", t) for t in (out, jax_out)]
    assert len(mious[0]) == len(mious[1]) == 1
    assert float(mious[0][0]) == pytest.approx(float(mious[1][0]), abs=1e-6)
    assert re.search(r"Epoch : 1 - loss : \S+ - acc: \S+ - val_loss : \S+ "
                     r"- val_acc: \S+ - time", out)
    assert state.iteration == 3
    run_dir = out.split("output directory: ")[1].split("\n")[0]
    assert sorted(os.listdir(run_dir)) == ["vit_000000", "vit_000003"]
    ckpt = os.path.join(run_dir, "vit_000003")

    with open(configs["port"]) as f:
        config = json.load(f)
    config["train_config"]["checkpoint_path"] = ckpt
    eval_cfg = root / "eval.json"
    eval_cfg.write_text(json.dumps(config))
    vis = root / "vis"
    miou = test_cli.main(["-c", str(eval_cfg), "--device", "cpu",
                          "--visualize_dir", str(vis), "--visualize_n", "3"])
    printed = capsys.readouterr().out
    assert sorted(os.listdir(vis)) == [f"{k}_{i}.png" for k in ("label",
                                                                 "pred")
                                       for i in range(3)]
    assert np.asarray(Image.open(vis / "pred_0.png")).shape == (SIZE, SIZE,
                                                                3)
    assert f"mIoU: {miou.get_miou():.4f}" in printed
    assert len(re.findall(r"^ +\w+: \S+$", printed, re.M)) == NUM_CLASSES

    # the same weights as a JAX checkpoint, through the JAX test CLI
    data_config = json.loads((root / "data_config.json").read_text())
    kw = jax_vit.vit_kwargs_from_config(config, data_config)
    jstate = init_train_state(jax_vit.ViT(**kw), jax_optim.create_optimizer(
        config["train_config"]), jax.random.PRNGKey(0),
        jnp.zeros((1, SIZE, SIZE, 3)))
    payload = torch.load(ckpt, weights_only=True)
    jstate = jstate.replace(params=jax.tree_util.tree_map(
        jnp.asarray, import_torch_state_dict(
            jax.tree_util.tree_map(np.asarray, jstate.params),
            {n: t.numpy() for n, t in payload["model"].items()},
            "segmentation")))
    jax_save_checkpoint(jstate, str(root / "jax_final"))
    config["train_config"]["checkpoint_path"] = str(root / "jax_final")
    seen = capture_miou(monkeypatch)
    seg_test = load_script_module(
        os.path.join(REPO, "segmentation", "test.py"), "seg_test_for_port")
    seg_test.test_seg(config)
    jax_printed = capsys.readouterr().out
    print(f"port per-class IoU {miou.get_per_class_iou()}\nJAX "
          f"{seen[-1]}")
    np.testing.assert_array_equal(miou.get_per_class_iou(), seen[-1])
    assert jax_printed.splitlines()[-NUM_CLASSES - 1:] == \
        printed.splitlines()[-NUM_CLASSES - 1:]


def test_int8_train_cli_checkpoint_evaluates(cli_setup, capsys):
    """The train CLI in PyTorchINT8 (the one-pass QAT step) for one epoch:
    finite losses, the checkpoint carrying its format and every observer,
    read back by the test CLI; a checkpoint of another format is
    refused."""
    root, configs = cli_setup
    with open(configs["port"]) as f:
        config = json.load(f)
    config["vit_config"]["q_format"] = "PyTorchINT8"
    config["train_config"].update(checkpoint_path="",
                                  output_directory=str(root / "int8_out"))
    cfg = root / "int8.json"
    cfg.write_text(json.dumps(config))
    state = train_cli.main(["-c", str(cfg), "--device", "cpu"])
    out = capsys.readouterr().out
    losses = [float(v) for v in re.findall(r"Iteration \d+:\tloss=(\S+)",
                                           out)]
    assert len(losses) == 3 and np.isfinite(losses).all()
    run_dir = out.split("output directory: ")[1].split("\n")[0]
    ckpt = os.path.join(run_dir, "vit_000003")
    payload = torch.load(ckpt, weights_only=True)
    assert payload["q_format"] == "PyTorchINT8"
    observers = [n for n in payload["model"] if is_observer(n)]
    assert len(observers) == 2 * len(quant_site_names(DEPTH, "segmentation"))
    assert state.model.decoder.linear.act_out.min <= \
        state.model.decoder.linear.act_out.max
    config["train_config"]["checkpoint_path"] = ckpt
    cfg.write_text(json.dumps(config))
    miou = test_cli.main(["-c", str(cfg), "--device", "cpu"])
    assert miou.total_area_union.sum() > 0
    config["vit_config"]["q_format"] = "FP32"
    cfg.write_text(json.dumps(config))
    with pytest.raises(ValueError, match="q_format PyTorchINT8"):
        test_cli.main(["-c", str(cfg), "--device", "cpu"])


def test_clis_raise_without_a_card(cli_setup, monkeypatch):
    _, configs = cli_setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cli in (train_cli, test_cli):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["-c", configs["port"]])
