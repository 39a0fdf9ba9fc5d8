"""The port's detection training against the JAX package's: the
Hungarian matcher, the set criterion and its gradients, one detection
train step of a small ViT at three canvases (the fused block above 256
tokens, the flash path's unblocked K8 regime and its blocked K7 regime),
and the train CLI end to end against the JAX ``detection/train.py`` on a
synthetic COCO split."""
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import myrtle_vision_tpu.models.vit as jax_vit
import myrtle_vision_tpu.ops.flash_attention as jax_fa
import myrtle_vision_tpu_torch.models.vit as port_vit
import myrtle_vision_tpu_torch.ops.flash_attention as port_fa
from myrtle_vision_tpu.eval.coco_eval import CocoEvaluator as JaxEvaluator
from myrtle_vision_tpu.models.detector import (
    build_weight_dict as jax_weight_dict,
    criterion as jax_criterion,
)
from myrtle_vision_tpu.models.matcher import hungarian_match as jax_match
from myrtle_vision_tpu.training import optim as jax_optim
from myrtle_vision_tpu.training.detection import (
    make_loss_fn as jax_loss_fn,
)
from myrtle_vision_tpu.training.trainer import (
    TrainState as JaxState,
    init_train_state,
    make_train_step as jax_train_step,
)
from myrtle_vision_tpu.utils.checkpoint import (
    save_checkpoint as jax_save_checkpoint,
)
from myrtle_vision_tpu_torch.detection import test as eval_cli
from myrtle_vision_tpu_torch.detection import train as train_cli
from myrtle_vision_tpu_torch.eval.coco_eval import CocoEvaluator
from myrtle_vision_tpu_torch.models.detector import (
    build_weight_dict,
    criterion,
)
from myrtle_vision_tpu_torch.models.matcher import hungarian_match
from myrtle_vision_tpu_torch.training import optim
from myrtle_vision_tpu_torch.training.detection import make_loss_fn
from myrtle_vision_tpu_torch.training.trainer import (
    TrainState,
    make_train_step,
)
from myrtle_vision_tpu_torch.utils.checkpoint import save_checkpoint
from myrtle_vision_tpu_torch.utils.convert import state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_CLASSES = 3
KW = dict(decoder="detection", image_size=160, patch_size=16,
          num_classes=NUM_CLASSES, dim=64, depth=2, heads=2, mlp_dim=128,
          dim_head=32, num_det_tokens=10)
TRAIN_CONFIG = dict(optimizer="adamw", opt_eps=1e-8, opt_betas=None,
                    weight_decay=0.05, momentum=0.9, lr=1e-3, clip_grad=None,
                    loss_ce=1.0, class_error=0.0, loss_bbox=5.0,
                    loss_giou=2.0, cardinality_error=0.0, eos_coef=0.1)
WEIGHTS = build_weight_dict(TRAIN_CONFIG)


def targets(rng, lead, m, n_classes=NUM_CLASSES):
    """Padded targets of shape lead + (m,): 1 to 4 valid boxes per image,
    cxcywh inside the unit square."""
    n = int(np.prod(lead))
    valid = np.zeros((n, m), bool)
    for i, k in enumerate(rng.randint(1, 5, n)):
        valid[i, :k] = True
    wh = rng.uniform(0.05, 0.5, (n, m, 2))
    cxy = wh / 2 + rng.uniform(0, 1, (n, m, 2)) * (1 - wh)
    boxes = np.concatenate([cxy, wh], -1).astype(np.float32)
    labels = rng.randint(0, n_classes, (n, m)).astype(np.int32)
    return {"labels": labels.reshape(*lead, m),
            "boxes": boxes.reshape(*lead, m, 4),
            "valid": valid.reshape(*lead, m)}


def predictions(rng, b, q, n_classes=NUM_CLASSES):
    logits = (rng.randn(b, q, n_classes + 1) * 2).astype(np.float32)
    boxes = (1 / (1 + np.exp(-rng.randn(b, q, 4)))).astype(np.float32)
    return logits, boxes


def to_torch(arrs):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in arrs.items()}


def to_jax(arrs):
    return {k: jnp.asarray(v) for k, v in arrs.items()}


# ------------------------------------------------------------ matcher

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hungarian_match_matches_jax(seed):
    rng = np.random.RandomState(seed)
    logits, boxes = predictions(rng, 3, 20)
    tgt = targets(rng, (3,), 8)
    tgt["valid"][2] = False  # an image without targets
    costs = dict(cost_class=1.0, cost_bbox=5.0, cost_giou=2.0)
    ref = np.asarray(jax_match(jnp.asarray(logits), jnp.asarray(boxes),
                               jnp.asarray(tgt["labels"]),
                               jnp.asarray(tgt["boxes"]),
                               jnp.asarray(tgt["valid"]), **costs))
    got = hungarian_match(torch.from_numpy(logits), torch.from_numpy(boxes),
                          **{f"tgt_{k}": v for k, v in to_torch(tgt).items()},
                          **costs)
    assert got.dtype == torch.int64 and got.shape == (3, 8)
    np.testing.assert_array_equal(got.numpy(), ref)
    # every valid slot has its own query; invalid slots point at 0
    for b in range(3):
        chosen = got[b][torch.from_numpy(tgt["valid"][b])]
        assert len(set(chosen.tolist())) == len(chosen)
    assert not got[2].any()


# ------------------------------------------------------------ criterion

@pytest.mark.parametrize("seed", [0, 1])
def test_criterion_matches_jax(seed):
    """Every loss within 1e-6, and the gradients of the weighted total in
    the logits and boxes within 1e-5 of jax.grad; the matcher runs inside
    both."""
    rng = np.random.RandomState(seed + 10)
    logits, boxes = predictions(rng, 2, 10)
    tgt = targets(rng, (2,), 10)

    def jax_total(lg, bx):
        losses = jax_criterion({"pred_logits": lg, "pred_boxes": bx},
                               to_jax(tgt), NUM_CLASSES,
                               weight_dict=jax_weight_dict(TRAIN_CONFIG))
        return losses["loss"], losses

    (_, ref), ref_grads = jax.value_and_grad(
        jax_total, argnums=(0, 1), has_aux=True)(jnp.asarray(logits),
                                                 jnp.asarray(boxes))
    lg = torch.from_numpy(logits).requires_grad_()
    bx = torch.from_numpy(boxes).requires_grad_()
    got = criterion({"pred_logits": lg, "pred_boxes": bx}, to_torch(tgt),
                    NUM_CLASSES, weight_dict=WEIGHTS)
    assert set(got) == set(ref)
    for name in ref:
        assert got[name].dtype == torch.float32 and got[name].dim() == 0
        np.testing.assert_allclose(float(got[name].detach()),
                                   float(ref[name]), rtol=1e-6, atol=1e-6,
                                   err_msg=name)
    assert not got["class_error"].requires_grad
    assert not got["cardinality_error"].requires_grad
    got["loss"].backward()
    for t, r, name in ((lg, ref_grads[0], "pred_logits"),
                       (bx, ref_grads[1], "pred_boxes")):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_criterion_takes_given_matches_and_no_targets():
    rng = np.random.RandomState(3)
    logits, boxes = predictions(rng, 2, 10)
    tgt = to_torch(targets(rng, (2,), 10))
    outputs = {"pred_logits": torch.from_numpy(logits),
               "pred_boxes": torch.from_numpy(boxes)}
    src = hungarian_match(outputs["pred_logits"], outputs["pred_boxes"],
                          tgt["labels"], tgt["boxes"], tgt["valid"],
                          cost_class=1.0, cost_bbox=5.0, cost_giou=2.0)
    auto = criterion(outputs, tgt, NUM_CLASSES, weight_dict=WEIGHTS)
    given = criterion(outputs, tgt, NUM_CLASSES, weight_dict=WEIGHTS,
                      src_idx=src)
    for name in auto:
        assert float(auto[name]) == float(given[name]), name
    # no valid target: every query is no-object, box losses 0 over 1 box
    tgt["valid"][:] = False
    empty = criterion(outputs, tgt, NUM_CLASSES, weight_dict=WEIGHTS)
    assert float(empty["loss_bbox"]) == float(empty["loss_giou"]) == 0.0
    assert torch.isfinite(empty["loss"])


# ------------------------------------------------------------ train step

# canvases: 256 px is 16 x 16 patches + cls + 10 det tokens = 267 tokens
# (fused, the long core backward); 160 px is 111 tokens, run through the
# flash path (n_pad 128: K8) and its blocked regime forced (K7)
STEP_CASES = {"fused_267": 256, "flash_k8": 160, "flash_k7": 160}


def force_path(case, monkeypatch):
    if case == "fused_267":
        assert port_vit.fuses_at(267, 2, 32)
        return
    for mod in (jax_vit, port_vit):
        monkeypatch.setattr(mod, "fuses_at", lambda n, h, d: False)
    if case == "flash_k7":
        # the blocked regime at 111 tokens, in two KV tiles of 64
        monkeypatch.setattr(jax_fa, "_FULL_SEQ_MAX", 0)
        monkeypatch.setattr(jax_fa, "_pick_kv_blk", lambda n_pad: 64)
        monkeypatch.setattr(port_fa, "FULL_SEQ_MAX", 0)
        monkeypatch.setattr(port_fa, "pick_kv_blk", lambda n_pad: 64)


def step_pair(case, monkeypatch):
    """One step of n_accum=2 micro-batches of 2 through the JAX and the
    port's make_train_step, from one JAX init, fp32."""
    force_path(case, monkeypatch)
    size = STEP_CASES[case]
    rng = np.random.RandomState(size)
    batch = {"image": rng.uniform(-1, 1, (2, 2, size, size, 3)).astype(
        np.float32), **targets(rng, (2, 2), KW["num_det_tokens"])}

    jmodel = jax_vit.ViT(**KW, dtype=jnp.float32)
    params = jmodel.init(jax.random.PRNGKey(2),
                         jnp.zeros((1, 160, 160, 3)))["params"]
    pert = np.random.RandomState(4)  # LayerNorms and biases off their init
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p, np.float32)
        + (0.02 * pert.randn(*p.shape)).astype(np.float32), params)
    tx = jax_optim.create_optimizer(TRAIN_CONFIG)
    loss_fn = jax_loss_fn(jmodel, NUM_CLASSES,
                          jax_weight_dict(TRAIN_CONFIG),
                          TRAIN_CONFIG["eos_coef"])
    grad_fn = jax.grad(
        lambda p, mb: loss_fn(p, {}, mb, jax.random.PRNGKey(0))[0])
    grads = None
    for i in range(2):
        g = grad_fn(params, to_jax({k: v[i] for k, v in batch.items()}))
        grads = g if grads is None else jax.tree_util.tree_map(jnp.add,
                                                               grads, g)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    state = JaxState(params=jparams, opt_state=tx.init(jparams), quant={},
                     iteration=jnp.zeros((), jnp.int32))
    state, jmetrics = jax_train_step(loss_fn, tx, 2)(
        state, to_jax(batch), 1e-3, jax.random.PRNGKey(0))

    model = port_vit.ViT(**KW, compute_dtype=torch.float32)
    model.load_state_dict(state_dict_from_jax(params, decoder="detection"),
                          strict=True)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    tstate = TrainState(model, optim.create_optimizer(TRAIN_CONFIG, model))
    metrics = make_train_step(
        make_loss_fn(model, NUM_CLASSES, WEIGHTS, TRAIN_CONFIG["eos_coef"]),
        2)(tstate, to_torch(batch), 1e-3)
    return dict(
        jax_metrics={k: float(v) for k, v in jmetrics.items()},
        metrics={k: float(v) for k, v in metrics.items()},
        jax_grads=state_dict_from_jax(
            jax.tree_util.tree_map(np.asarray, grads), decoder="detection"),
        grads={n: p.grad for n, p in model.named_parameters()},
        jax_delta={n: v - before[n] for n, v in state_dict_from_jax(
            jax.tree_util.tree_map(np.asarray, state.params),
            decoder="detection").items()},
        delta={n: p.detach() - before[n]
               for n, p in model.named_parameters()},
    )


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_detection_train_step_matches_jax(case, monkeypatch):
    """Loss and metrics, every gradient and the AdamW change of one step,
    fp32 on both sides, within 1e-4."""
    pair = step_pair(case, monkeypatch)
    assert set(pair["metrics"]) == set(pair["jax_metrics"]) == {
        "loss", "loss_ce", "class_error", "cardinality_error", "loss_bbox",
        "loss_giou"}
    for name, ref in pair["jax_metrics"].items():
        np.testing.assert_allclose(pair["metrics"][name], ref, rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    ours, ref = pair["grads"], pair["jax_grads"]
    assert set(ours) == set(ref)
    for name in ref:
        # fp32 on both sides, summed in another order: per element 1e-4
        # relative plus 1e-4 of the tensor's largest gradient
        bar = 1e-4 * max(float(ref[name].abs().max()), 1e-6)
        torch.testing.assert_close(ours[name], ref[name], rtol=1e-4,
                                   atol=bar, msg=name)
    for name, want in pair["jax_delta"].items():
        # Adam moves an element by lr * g / (|g| + 1e-8): by +-lr on a
        # coin flip where g is roundoff (the key third of each qkv bias,
        # as in tests/test_torch_training.py), and by a visibly different
        # fraction of lr where |g| is near 1e-8, e.g. a patch-embedding
        # weight whose gradient of 3e-8 (1.5e-6 of the tensor's largest)
        # the two packages' sum orders put 3.5% apart.  Elements whose
        # gradient is above the gradient check's own absolute bar (1e-4
        # of the largest) are held to 1e-3 of one step (lr 1e-3); the
        # others only to two steps.
        g = ref[name].abs()
        defined = g > 1e-4 * float(g.max())
        torch.testing.assert_close(pair["delta"][name][defined],
                                   want[defined], rtol=0, atol=1e-6,
                                   msg=name)
        rest = pair["delta"][name][~defined]
        assert rest.numel() == 0 or float(rest.abs().max()) <= 2.2e-3


# ------------------------------------------------------------ CLI

def write_split(root, split, n, seed, id0):
    """n images of 96-128 px, 1-3 coloured boxes of 2 classes each."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    os.makedirs(root / split, exist_ok=True)
    os.makedirs(root / "annotations", exist_ok=True)
    images, anns = [], []
    for i in range(n):
        h, w = rng.randint(96, 129, 2)
        arr = rng.randint(0, 100, (h, w, 3), dtype=np.uint8)
        for _ in range(rng.randint(1, 4)):
            bw, bh = rng.randint(16, 40, 2)
            x, y = rng.randint(0, w - bw), rng.randint(0, h - bh)
            cat = rng.randint(0, 2)
            arr[y:y + bh, x:x + bw] = [220, 40, 40] if cat == 0 else [40, 220,
                                                                      40]
            anns.append({"id": len(anns), "image_id": id0 + i,
                         "category_id": int(cat),
                         "bbox": [int(x), int(y), int(bw), int(bh)],
                         "area": int(bw * bh), "iscrowd": 0,
                         "segmentation": []})
        Image.fromarray(arr).save(root / split / f"{id0 + i}.jpg")
        images.append({"id": id0 + i, "width": int(w), "height": int(h),
                       "file_name": f"{id0 + i}.jpg"})
    cats = [{"id": 0, "name": "red", "supercategory": "red"},
            {"id": 1, "name": "green", "supercategory": "green"}]
    with open(root / "annotations" / f"{split}.json", "w") as f:
        json.dump({"info": {}, "licenses": [], "images": images,
                   "annotations": anns, "categories": cats}, f)


CLI_VIT = {"decoder": "detection", "image_size": 96, "patch_size": 16,
           "embed_dim": 64, "depth": 2, "heads": 2, "mlp_dim": 128,
           "dropout": 0.0, "num_det_tokens": 10, "emb_dropout": 0.0,
           "q_format": "FP32", "compute_dtype": "float32"}


@pytest.fixture(scope="module")
def cli_setup(tmp_path_factory):
    """A train split of 11 images (global batch 4 of 2 x 2, drop_last: 2
    steps at mixed canvases), a val split of 5, yolos_small.json's train
    config with this tiny ViT, and the same initial weights as a JAX
    checkpoint and a port checkpoint at iteration 0."""
    root = tmp_path_factory.mktemp("torch_det_train")
    write_split(root / "data", "train", 11, 0, 0)
    write_split(root / "data", "val", 5, 1, 1000)
    norm = {"Mean": [0.5, 0.5, 0.5], "Std": [0.5, 0.5, 0.5]}
    data_config = {
        "dataset_path": str(root / "data"), "train_images": "train",
        "valid_images": "val", "train_annotations": "train.json",
        "valid_annotations": "val.json", "train_subset": None,
        "valid_subset": None, "number_of_classes": 2,
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
    model = jax_vit.ViT(**kw)
    state = init_train_state(model, jax_optim.create_optimizer(
        config["train_config"]), jax.random.PRNGKey(0),
        jnp.zeros((1, 96, 96, 3)))
    jax_save_checkpoint(state, str(root / "jax_init"))
    port = port_vit.ViT(**port_vit.vit_kwargs_from_config(config,
                                                          data_config))
    port.load_state_dict(state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, state.params),
        decoder="detection"), strict=True)
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


def capture_summaries(monkeypatch, evaluator):
    stats = []
    summarize = evaluator.summarize

    def capture(self):
        stats.append(np.asarray(summarize(self), np.float64))
        return stats[-1]

    monkeypatch.setattr(evaluator, "summarize", capture)
    return stats


def test_train_cli_matches_jax_cli(cli_setup, monkeypatch, capsys):
    """One epoch of two steps: the port's iteration lines within 1e-4 of
    the JAX CLI's, the same COCO summary of the val split, vit_best and
    the final checkpoint written and read back by the eval CLI."""
    from conftest import load_script_module

    root, configs = cli_setup
    monkeypatch.chdir(root)  # the JAX CLI's scalar logs go to ./runs
    jax_stats = capture_summaries(monkeypatch, JaxEvaluator)
    det_train = load_script_module(
        os.path.join(REPO, "detection", "train.py"), "det_train_for_port")
    with open(configs["jax"]) as f:
        det_train.train(json.load(f))
    jax_out = capsys.readouterr().out

    port_stats = capture_summaries(monkeypatch, CocoEvaluator)
    state = train_cli.main(["-c", configs["port"], "--device", "cpu"])
    out = capsys.readouterr().out
    line = (r"Iteration (\d+):\tloss=(\S+)\tce=(\S+)\tbbox=(\S+)\t"
            r"giou=(\S+)")
    ours, ref = re.findall(line, out), re.findall(line, jax_out)
    assert [r[0] for r in ours] == [r[0] for r in ref] == ["1", "2"]
    np.testing.assert_allclose(np.asarray(ours, np.float64)[:, 1:],
                               np.asarray(ref, np.float64)[:, 1:],
                               rtol=1e-4, atol=1e-4)
    assert state.iteration == 2
    assert len(port_stats) == len(jax_stats) == 1
    np.testing.assert_allclose(port_stats[0], jax_stats[0], rtol=0,
                               atol=1e-4)
    assert re.search(r"Epoch : 1 - loss : \S+ - val AP: \S+ - time", out)

    run_dir = out.split("output directory: ")[1].split("\n")[0]
    assert sorted(os.listdir(run_dir)) == ["vit_000002", "vit_best"]
    best = torch.load(os.path.join(run_dir, "vit_best"), weights_only=True)
    assert best["lr_scheduler"] == {"ap": float(port_stats[0][0])}
    with open(configs["port"]) as f:
        config = json.load(f)
    config["train_config"]["checkpoint_path"] = os.path.join(run_dir,
                                                             "vit_best")
    config["data_config_path"] = str(root / "data_config.json")
    eval_cfg = root / "eval.json"
    with open(root / "data_config.json") as f:
        data_config = json.load(f)
    data_config.update(test_images="val", test_annotations="val.json",
                       test_subset=None)
    with open(root / "data_config_eval.json", "w") as f:
        json.dump(data_config, f)
    config["data_config_path"] = str(root / "data_config_eval.json")
    with open(eval_cfg, "w") as f:
        json.dump(config, f)
    evaluator, preds = eval_cli.main(["-c", str(eval_cfg), "--device",
                                      "cpu"])
    assert len(preds) == 5
    np.testing.assert_allclose(evaluator.stats, port_stats[0], rtol=0,
                               atol=1e-12)


def test_build_train_is_the_cli_set_up(cli_setup):
    """build_train gives the CLI's micro-batching and, built twice, the
    same weights and batches."""
    _, configs = cli_setup
    with open(configs["port"]) as f:
        config = json.load(f)
    config["train_config"]["checkpoint_path"] = ""

    def first():
        model, train_loader, val_loader, valset, sizes = \
            train_cli.build_train(config, torch.device("cpu"))
        return model, next(train_loader.epoch(0)), len(train_loader), sizes

    model, batch, steps, (micro, n_accum) = first()
    model2, batch2, _, _ = first()
    assert (micro, n_accum, steps) == (2, 2, 2)
    assert batch["image"].shape[0] == 4
    torch.testing.assert_close(batch2, batch, rtol=0, atol=0)
    torch.testing.assert_close(model2.state_dict(), model.state_dict(),
                               rtol=0, atol=0)
    mb = train_cli.micro_batches(batch, n_accum, micro)
    assert set(mb) == set(train_cli.STEP_KEYS)
    assert mb["image"].shape[:2] == (2, 2) and mb["valid"].dtype == torch.bool


def test_train_cli_refuses_without_a_card_and_quantized(cli_setup,
                                                        monkeypatch):
    _, configs = cli_setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["-c", configs["port"], "--device", "cuda"])
    with open(configs["port"]) as f:
        config = json.load(f)
    # PyTorchINT8 trains now (the one-pass QAT step,
    # tests/test_torch_int8_detection.py): the set-up builds its model
    config["vit_config"]["q_format"] = "PyTorchINT8"
    config["train_config"]["checkpoint_path"] = ""
    model = train_cli.build_train(config, torch.device("cpu"))[0]
    assert model.int8 and not model.converted
