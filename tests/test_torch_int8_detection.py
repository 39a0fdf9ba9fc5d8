"""YOLOS detection in PyTorchINT8 (before convert) of the port against the
JAX package on the CPU: the observer names of the detector, the one-pass
QAT step (the JAX ``qat_int8`` loss of training/detection.py: the
calibrating forward, differentiated, the observers folding in the batch
as it runs) with its loss, outputs, observers and every gradient; the
simulation's eval forward (observers frozen, full fp32 products, the
exact erf); and the train CLI against the JAX train CLI, each one's final
checkpoint through its eval CLI.

Widths: dim 64, 2 heads of 32, MLP 128, 2 layers, 10 det tokens; a 96 px
canvas (36 patches + cls + 10 det tokens = 47, the discrete Block, which
the JAX detector runs in PyTorchINT8 at every canvas); inputs from
np.random.RandomState.  The bars are the INT8 bars of
tests/test_torch_int8_qat.py: the observers within 1e-5, the logits
within 1e-4 plus one step of their site's grid (a box within 1e-4 plus a
quarter step of its site at the sigmoid's largest slope), the loss within
1e-6 relative plus twice the logits' difference, every gradient within
2e-4 of its leaf's largest magnitude; both packages' backward is fed
JAX's output gradient (GIoU's min and max can flip with a snap, ROADMAP
C6), and the key third of each qkv bias, whose gradient is roundoff, is
left out.  The CLIs: iteration losses within 1e-4, the COCO summaries
within 1e-4, as tests/test_torch_detection_training.py holds FP32, but
with the train CLI's first step held against JAX's op by op and its
checkpoint through both eval CLIs: the JAX train CLI jits its step, and
XLA's fusion of the step's fp32 operations puts a site's rint on the
other side of its edge here and there, which in INT8 moves the observers
and every grid after them (measured on the first step's second
micro-batch: loss 3.93869 jitted against 3.93392 op by op and in the
port), a difference of XLA's programs, not of the two packages; op by op
the JAX train CLI takes 11 minutes here."""
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import myrtle_vision_tpu.models.vit as jax_vit
from myrtle_vision_tpu.models.detector import (
    build_weight_dict as jax_weight_dict,
    criterion as jax_criterion,
)
from myrtle_vision_tpu.quantize import QFormat as JaxQFormat
from myrtle_vision_tpu.training import optim as jax_optim
from myrtle_vision_tpu.training.trainer import init_train_state
from myrtle_vision_tpu.utils.checkpoint import (
    load_checkpoint as jax_load_checkpoint,
    save_checkpoint as jax_save_checkpoint,
)
from myrtle_vision_tpu.utils.export import import_torch_state_dict
from myrtle_vision_tpu_torch.detection import test as eval_cli
from myrtle_vision_tpu_torch.detection import train as train_cli
from myrtle_vision_tpu_torch.eval.coco_eval import CocoEvaluator
from myrtle_vision_tpu_torch.models import vit as port_vit
from myrtle_vision_tpu_torch.quantize import affine_uint8_qparams, is_observer
from myrtle_vision_tpu_torch.training import optim
from myrtle_vision_tpu_torch.training.detection import make_loss_fn
from myrtle_vision_tpu_torch.training.trainer import TrainState
from myrtle_vision_tpu_torch.utils.checkpoint import save_checkpoint
from myrtle_vision_tpu_torch.utils.convert import (
    quant_site_names,
    state_dict_from_jax,
)

from test_torch_detection import jax_params as detection_params
from test_torch_detection import run_jax_cli
from test_torch_detection_training import (
    TRAIN_CONFIG,
    WEIGHTS,
    capture_summaries,
    targets,
    write_split,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C, HEADS, D, HID, DEPTH, DET = 64, 2, 32, 128, 2, 10
NUM_CLASSES = 3
KW = dict(decoder="detection", image_size=96, patch_size=16,
          num_classes=NUM_CLASSES, dim=C, depth=DEPTH, heads=HEADS,
          mlp_dim=HID, dim_head=D, num_det_tokens=DET)
GRAD_BAR = 2e-4


def quant_paths(tree, path=()):
    if "min" in tree:
        return [path]
    return [p for k in sorted(tree) for p in quant_paths(tree[k], path + (k,))]


@pytest.fixture(scope="module")
def detector():
    """The JAX INT8 detector, its parameters (moved off their init) and
    fresh quant collection, two micro-batches of two images, targets."""
    kw = dict(KW, q_format=JaxQFormat.PyTorchINT8)
    jmodel = jax_vit.ViT(**kw, dtype=jnp.float32)
    params = detection_params(kw, 3, 96)
    quant = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.PRNGKey(3), jnp.zeros((1, 96, 96, 3)))["quant"])
    rng = np.random.RandomState(96)
    images = rng.uniform(-1, 1, (2, 2, 96, 96, 3)).astype(np.float32)
    return dict(model=jmodel, params=params, quant=quant, images=images,
                targets=targets(rng, (2,), DET))


def port_detector(params, quant):
    model = port_vit.ViT(**KW, q_format="PyTorchINT8")
    model.load_state_dict(state_dict_from_jax(params, "detection", quant),
                          strict=True)
    return model


def test_detector_observers_are_the_jax_quant_collection(detector):
    """Every site of the JAX detector's ``quant`` collection (the det
    tokens' stub, the class and box heads' act_out) has its port observer,
    and the strict load takes them all."""
    names = quant_site_names(DEPTH, "detection")
    assert sorted(p for p, _ in names) == quant_paths(detector["quant"])
    model = port_detector(detector["params"], detector["quant"])
    observers = {n for n in model.state_dict() if is_observer(n)}
    assert observers == {f"{n}.{k}" for _, n in names for k in ("min", "max")}


def test_int8_detector_state_round_trips(detector):
    """A calibrated INT8 detector's state dict to JAX parameters and
    ``quant`` (export's ``import_torch_state_dict``, the observers by
    their JAX paths) and back through ``state_dict_from_jax``: every
    tensor the same.  The positional grid is the stored 14 x 14 + 1 in
    both packages at every canvas (interpolated on the fly), so no
    longer embedding is carried."""
    model = port_detector(detector["params"], detector["quant"])
    with torch.no_grad():
        model(torch.from_numpy(detector["images"][0]), calibrating=True)
    sd = model.state_dict()
    assert tuple(sd["pos_embedding"].shape) == (1, 197, C)
    params = import_torch_state_dict(
        detector["params"], {n: t.numpy() for n, t in sd.items()
                             if not is_observer(n)}, "detection")
    back = state_dict_from_jax(params, "detection", jax_quant_of(sd))
    assert set(back) == set(sd)
    for name, t in sd.items():
        assert torch.equal(back[name], t), name


def observers_close(model, quant):
    """Every observer within 1e-5 of the JAX ``quant`` collection's."""
    sd = model.state_dict()
    for path, name in quant_site_names(DEPTH, "detection"):
        site = quant
        for p in path:
            site = site[p]
        for key in ("min", "max"):
            np.testing.assert_allclose(sd[f"{name}.{key}"].numpy(),
                                       site[key], rtol=1e-5, atol=1e-7,
                                       err_msg=name)


def outputs_close(label, model, out, out_j):
    """pred_logits within 1e-4 plus one step of class_embed.act_out's
    grid, pred_boxes within 1e-4 plus a quarter step of bbox_embed's."""
    logits, boxes = (out[k].detach().numpy() for k in
                     ("pred_logits", "pred_boxes"))
    step_l = float(model.decoder.class_embed.act_out.int8_qparams()[0])
    step_b = float(model.decoder.bbox_embed.act_out.int8_qparams()[0])
    d_l = np.abs(logits - np.asarray(out_j["pred_logits"])).max()
    d_b = np.abs(boxes - np.asarray(out_j["pred_boxes"])).max()
    print(f"{label}: logits max abs {d_l:.3g} (step {step_l:.4g}), boxes "
          f"{d_b:.3g} (step {step_b:.4g})")
    assert d_l <= 1e-4 + step_l * (1 + 1e-6)
    assert d_b <= 1e-4 + 0.25 * step_b
    return d_l


def test_one_pass_step_matches_jax(detector):
    """One micro-batch of the one-pass QAT step from the fresh observers:
    the outputs, the loss, the observers after it and every gradient."""
    jmodel, params = detector["model"], detector["params"]
    img = detector["images"][0]
    tgt = detector["targets"]

    def fwd(p):
        out, upd = jmodel.apply({"params": p, "quant": detector["quant"]},
                                jnp.asarray(img), calibrating=True,
                                mutable=["quant"])
        return out, upd["quant"]

    out_j, vjp, quant_j = jax.vjp(fwd, params, has_aux=True)

    def jax_total(o):
        return jax_criterion(o, {k: jnp.asarray(v) for k, v in tgt.items()},
                             NUM_CLASSES,
                             weight_dict=jax_weight_dict(TRAIN_CONFIG))["loss"]

    loss_j, g_out = jax.value_and_grad(jax_total)(out_j)
    (grads_j,) = vjp(g_out)

    model = port_detector(params, detector["quant"])
    loss_fn = make_loss_fn(model, NUM_CLASSES, WEIGHTS, 0.1)
    batch = {"image": torch.from_numpy(img),
             **{k: torch.from_numpy(v) for k, v in tgt.items()}}
    loss, _ = loss_fn(batch)
    out = model(torch.from_numpy(img), calibrating=True)  # idempotent
    d = outputs_close("one-pass step", model, out, out_j)
    loss = float(loss.detach())
    print(f"one-pass step: loss {loss!r} vs JAX {float(loss_j)!r}")
    assert abs(loss - float(loss_j)) <= 1e-6 * abs(float(loss_j)) + 2 * d
    observers_close(model, jax.tree_util.tree_map(np.asarray, quant_j))

    model.zero_grad(set_to_none=True)
    out = model(torch.from_numpy(img), calibrating=True)
    torch.autograd.backward([out["pred_logits"], out["pred_boxes"]],
                            [torch.from_numpy(np.asarray(g_out[k]))
                             for k in ("pred_logits", "pred_boxes")])
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, grads_j),
                              "detection")
    named = dict(model.named_parameters())
    assert set(named) == set(ref)
    worst, worst_name = 0.0, ""
    for name, r in ref.items():
        diff = (named[name].grad - r).abs()
        if name.endswith("to_qkv.bias"):
            diff[C:2 * C] = 0
        share = float(diff.max()) / max(float(r.abs().max()), 1e-30)
        if share > worst:
            worst, worst_name = share, name
    print(f"one-pass step: largest gradient difference {worst:.3g} of its "
          f"tensor's scale, in {worst_name}")
    assert worst <= GRAD_BAR


def test_eval_forward_matches_jax(detector):
    """The simulation's eval forward with the observers of one calibrating
    micro-batch, on the other: the outputs under the bars above, the
    observers untouched."""
    jmodel, params = detector["model"], detector["params"]
    _, upd = jmodel.apply({"params": params, "quant": detector["quant"]},
                          jnp.asarray(detector["images"][0]),
                          calibrating=True, mutable=["quant"])
    quant = jax.tree_util.tree_map(np.asarray, upd["quant"])
    img = detector["images"][1]
    out_j = jmodel.apply({"params": params, "quant": quant},
                         jnp.asarray(img))
    model = port_detector(params, quant)
    before = {n: t.clone() for n, t in model.state_dict().items()}
    with torch.inference_mode():
        out = model(torch.from_numpy(img))
    outputs_close("eval forward", model, out, out_j)
    for name, t in model.state_dict().items():
        assert torch.equal(t, before[name]), name


# ------------------------------------------------------------ CLIs

CLI_VIT = {"decoder": "detection", "image_size": 96, "patch_size": 16,
           "embed_dim": C, "depth": DEPTH, "heads": HEADS, "mlp_dim": HID,
           "dropout": 0.0, "num_det_tokens": DET, "emb_dropout": 0.0,
           "q_format": "PyTorchINT8"}


@pytest.fixture(scope="module")
def cli_setup(tmp_path_factory):
    """A train split of 11 images (global batch 4 of 2 x 2, drop_last: 2
    steps at mixed canvases), a val split of 5 that is also the test
    split, yolos_small.json's train config with this ViT in PyTorchINT8,
    and the same initial weights and fresh observers as a JAX checkpoint
    and a port checkpoint at iteration 0."""
    root = tmp_path_factory.mktemp("torch_int8_det")
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
    config["train_config"].update(epochs=1, warmup_epochs=0, lr=1e-3,
                                  pretrained_backbone=None,
                                  distributed=False)
    kw = jax_vit.vit_kwargs_from_config(config, data_config)
    state = init_train_state(jax_vit.ViT(**kw), jax_optim.create_optimizer(
        config["train_config"]), jax.random.PRNGKey(0),
        jnp.zeros((1, 96, 96, 3)))
    jax_save_checkpoint(state, str(root / "jax_init"))
    port = port_vit.ViT(**port_vit.vit_kwargs_from_config(config,
                                                          data_config))
    port.load_state_dict(state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, state.params), "detection",
        jax.tree_util.tree_map(np.asarray, state.quant)), strict=True)
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


def jax_quant_of(sd):
    """The JAX ``quant`` collection of a port detector's observers."""
    quant = {}
    for path, name in quant_site_names(DEPTH, "detection"):
        node = quant
        for p in path:
            node = node.setdefault(p, {})
        node.update(min=sd[f"{name}.min"].numpy(),
                    max=sd[f"{name}.max"].numpy())
    return quant


def test_int8_train_cli_checkpoint_evaluates_as_the_jax_cli(
        cli_setup, monkeypatch, capsys):
    """The port's detection train CLI in PyTorchINT8: one epoch of two
    one-pass QAT steps, its first iteration line within 1e-4 of JAX's
    first step op by op (the same initial weights and observers, the same
    batch), finite losses, the checkpoint carrying its format and every
    observer; that checkpoint through the port's eval CLI and, as JAX
    parameters and ``quant``, through the JAX ``detection/test.py``: the
    same COCO summary within 1e-4, the same labels, scores and boxes
    within the step test's output bars carried through the softmax or the
    sigmoid (a quarter of a step of their site's grid, in probability, or
    for a corner 1.5 times that in the pixels of these images, at most 128
    px)."""

    root, configs = cli_setup
    monkeypatch.chdir(root)  # the JAX CLI's scalar logs go to ./runs
    line = (r"Iteration (\d+):\tloss=(\S+)\tce=(\S+)\tbbox=(\S+)\t"
            r"giou=(\S+)")
    state = train_cli.main(["-c", configs["port"], "--device", "cpu"])
    out = capsys.readouterr().out
    ours = re.findall(line, out)
    assert [r[0] for r in ours] == ["1", "2"]
    assert np.all(np.isfinite(np.asarray(ours, np.float64)))
    assert state.iteration == 2 and state.model.int8
    run_dir = out.split("output directory: ")[1].split("\n")[0]
    ckpt = os.path.join(run_dir, "vit_000002")
    payload = torch.load(ckpt, weights_only=True)
    assert payload["q_format"] == "PyTorchINT8"
    assert sum(is_observer(n) for n in payload["model"]) == \
        2 * len(quant_site_names(DEPTH, "detection"))
    assert all(float(payload["model"][n]) < float("inf")
               for n in payload["model"] if n.endswith(".min"))

    # the CLI's first step as JAX computes it op by op: the JAX model and
    # criterion on the CLI's first batch (its loader's), from the JAX
    # initial checkpoint, the observers threaded through the micro-batches
    with open(configs["port"]) as f:
        config = json.load(f)
    _, loader, _, _, (micro, n_accum) = train_cli.build_train(
        config, torch.device("cpu"))
    epoch = loader.epoch(0)
    batch = next(epoch)
    epoch.close()
    data_config = json.loads((root / "data_config.json").read_text())
    kw = jax_vit.vit_kwargs_from_config(config, data_config)
    jmodel = jax_vit.ViT(**kw)
    jstate = init_train_state(jmodel, jax_optim.create_optimizer(
        config["train_config"]), jax.random.PRNGKey(0),
        jnp.zeros((1, 96, 96, 3)))
    jstate, _ = jax_load_checkpoint(jstate, str(root / "jax_init"))
    weights = jax_weight_dict(config["train_config"])
    quant, first = jstate.quant, np.zeros(4)
    for i in range(n_accum):
        sl = slice(i * micro, (i + 1) * micro)
        out_j, upd = jmodel.apply(
            {"params": jstate.params, "quant": quant},
            jnp.asarray(batch["image"][sl].numpy()), calibrating=True,
            mutable=["quant"])
        quant = upd["quant"]
        losses = jax_criterion(out_j, {k: jnp.asarray(batch[k][sl].numpy())
                                       for k in ("labels", "boxes",
                                                 "valid")},
                               2, weight_dict=weights)
        first += np.array([float(losses[k]) for k in (
            "loss", "loss_ce", "loss_bbox", "loss_giou")]) / n_accum
    print(f"first iteration: CLI {ours[0]}, JAX op by op {first}")
    np.testing.assert_allclose(np.asarray(ours[0][1:], np.float64), first,
                               rtol=1e-4, atol=1e-4)

    with open(configs["port"]) as f:
        config = json.load(f)
    config["train_config"]["checkpoint_path"] = ckpt
    eval_cfg = root / "eval.json"
    eval_cfg.write_text(json.dumps(config))
    port_stats = capture_summaries(monkeypatch, CocoEvaluator)
    evaluator, preds = eval_cli.main(["-c", str(eval_cfg), "--device",
                                      "cpu"])
    assert len(preds) == 5 and len(port_stats) == 1

    # the same weights and observers as a JAX checkpoint, through the JAX
    # eval CLI
    kw = jax_vit.vit_kwargs_from_config(config, data_config)
    jstate = init_train_state(jax_vit.ViT(**kw), jax_optim.create_optimizer(
        config["train_config"]), jax.random.PRNGKey(0),
        jnp.zeros((1, 96, 96, 3)))
    params = import_torch_state_dict(
        jax.tree_util.tree_map(np.asarray, jstate.params),
        {n: t.numpy() for n, t in payload["model"].items()
         if not is_observer(n)}, "detection")
    jstate = jstate.replace(
        params=jax.tree_util.tree_map(jnp.asarray, params),
        quant=jax.tree_util.tree_map(jnp.asarray,
                                     jax_quant_of(payload["model"])))
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
    # a logit or box output whose site the two sides' fp32 sums put on
    # either side of a rint edge moves a step of that site's grid; a
    # softmax score or a sigmoid moves by at most a quarter of that, and a
    # corner (c +- w / 2) times the image side (at most 128 px here) by
    # 1.5 times that where both its c and its w flipped
    steps = {}
    for head in ("class_embed", "bbox_embed"):
        site = f"decoder.{head}.act_out"
        steps[head] = float(affine_uint8_qparams(
            payload["model"][f"{site}.min"],
            payload["model"][f"{site}.max"])[0])
    print(f"grid steps {steps}")
    assert worst["scores"] <= 1e-4 + 0.25 * steps["class_embed"]
    assert worst["boxes"] <= 1.5 * 128 * (1e-4 + 0.25 * steps["bbox_embed"])
