"""The port's detection inference against the JAX package's: the
detection ViT after a strict load of the JAX model's parameters (on the
fused path, on the flash path and in the flash kernel's blocked regime),
``post_process``, the COCO evaluator, the loader's detection batches, and
the eval CLI against the JAX ``detection/test.py`` on a synthetic COCO
set."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import myrtle_vision_tpu.models.vit as jax_vit
import myrtle_vision_tpu.ops.flash_attention as jax_fa
import myrtle_vision_tpu_torch.models.vit as port_vit
import myrtle_vision_tpu_torch.ops.flash_attention as port_fa
from myrtle_vision_tpu.datasets.coco import CocoIndex as JaxCocoIndex
from myrtle_vision_tpu.eval.coco_eval import CocoEvaluator as JaxEvaluator
from myrtle_vision_tpu.models.detector import post_process as jax_post
from myrtle_vision_tpu.training.optim import create_optimizer
from myrtle_vision_tpu.training.trainer import init_train_state
from myrtle_vision_tpu.utils.checkpoint import save_checkpoint
from myrtle_vision_tpu.utils.export import save_torch_checkpoint
from myrtle_vision_tpu_torch.data.loader import DataLoader
from myrtle_vision_tpu_torch.datasets.coco import CocoDetection, CocoIndex
from myrtle_vision_tpu_torch.detection import test as cli
from myrtle_vision_tpu_torch.eval.coco_eval import CocoEvaluator
from myrtle_vision_tpu_torch.models.detector import post_process
from myrtle_vision_tpu_torch.transforms import detection as T
from myrtle_vision_tpu_torch.utils.convert import state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# 160 px: a 10 x 10 patch grid (the stored 14 x 14 positions resized), the
# cls token and 10 det tokens -> 111 tokens
KW = dict(decoder="detection", image_size=160, patch_size=16, num_classes=3,
          dim=64, depth=2, heads=2, mlp_dim=128, dim_head=32,
          num_det_tokens=10)


def jax_params(kw, seed, size):
    model = jax_vit.ViT(**kw, dtype=jnp.float32)
    params = model.init(jax.random.PRNGKey(seed),
                        jnp.zeros((1, size, size, 3)))["params"]
    # LayerNorm scales and biases off their init, every parameter moved
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p, np.float32)
        + (0.05 * rng.randn(*p.shape)).astype(np.float32), params)


@pytest.fixture(scope="module")
def params():
    return jax_params(KW, 0, 160)


@pytest.fixture(scope="module")
def images():
    return np.random.RandomState(1).uniform(-1, 1, (2, 160, 160, 3)).astype(
        np.float32)


def both_outputs(params, images):
    ref = jax_vit.ViT(**KW, dtype=jnp.float32).apply(
        {"params": params}, jnp.asarray(images), deterministic=True)
    model = port_vit.ViT(**KW, compute_dtype=torch.float32).eval()
    model.load_state_dict(state_dict_from_jax(params, decoder="detection"),
                          strict=True)
    with torch.no_grad():
        out = model(torch.from_numpy(images))
    return out, ref


@pytest.mark.parametrize("path", ["fused", "flash", "flash_blocked"])
def test_detection_vit_matches_jax(params, images, path, monkeypatch):
    calls = []
    plain = port_fa.flash_attention_plain
    monkeypatch.setattr(port_fa, "flash_attention_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    if path != "fused":
        for mod in (jax_vit, port_vit):
            monkeypatch.setattr(mod, "fuses_at", lambda n, h, d: False)
    if path == "flash_blocked":
        # the blocked regime at 111 tokens, in two KV tiles of 64
        monkeypatch.setattr(jax_fa, "_FULL_SEQ_MAX", 0)
        monkeypatch.setattr(jax_fa, "_pick_kv_blk", lambda n_pad: 64)
        monkeypatch.setattr(port_fa, "FULL_SEQ_MAX", 0)
        monkeypatch.setattr(port_fa, "pick_kv_blk", lambda n_pad: 64)
    out, ref = both_outputs(params, images)
    # the fused gate decides alike in both packages: flash only off it
    assert len(calls) == (0 if path == "fused" else KW["depth"])
    assert set(out) == {"pred_logits", "pred_boxes"}
    assert out["pred_logits"].shape == (2, 10, 4)
    assert out["pred_boxes"].shape == (2, 10, 4)
    for key in out:
        assert out[key].dtype == torch.float32
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   rtol=1e-4, atol=1e-4, err_msg=key)


def test_strict_load_covers_the_detection_head(params):
    sd = state_dict_from_jax(params, decoder="detection")
    model = port_vit.ViT(**KW)
    assert set(sd) == set(model.state_dict())
    assert sd["decoder.class_embed.weight"].shape == (4, 64)
    assert sd["decoder.bbox_embed.weight"].shape == (4, 64)
    np.testing.assert_array_equal(
        sd["decoder.bbox_embed.weight"].numpy(),
        params["decoder"]["bbox_embed"]["kernel"].T)
    with pytest.raises(RuntimeError, match="class_embed"):
        port_vit.ViT(**{**KW, "decoder": "classification"}).load_state_dict(
            sd, strict=True)


def test_post_process_matches_jax():
    rng = np.random.RandomState(2)
    logits = rng.randn(3, 7, 5).astype(np.float32) * 3
    boxes = rng.uniform(0, 1, (3, 7, 4)).astype(np.float32)
    sizes = np.array([[480, 640], [800, 800], [96, 160]], np.int32)
    ref = jax_post({"pred_logits": jnp.asarray(logits),
                    "pred_boxes": jnp.asarray(boxes)}, jnp.asarray(sizes))
    got = post_process({"pred_logits": torch.from_numpy(logits),
                        "pred_boxes": torch.from_numpy(boxes)},
                       torch.from_numpy(sizes))
    np.testing.assert_array_equal(got["labels"].numpy(),
                                  np.asarray(ref["labels"]))
    for key in ("scores", "boxes"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   rtol=1e-5, atol=1e-5, err_msg=key)


def coco_dict(rng, n_images, n_cats=3):
    images, anns = [], []
    for i in range(n_images):
        images.append({"id": i, "width": 200, "height": 150,
                       "file_name": f"{i}.jpg"})
        for _ in range(rng.randint(0, 5)):
            w, h = rng.uniform(5, 90, 2)
            x, y = rng.uniform(0, 200 - w), rng.uniform(0, 150 - h)
            anns.append({"id": len(anns), "image_id": i,
                         "category_id": int(rng.randint(n_cats)),
                         "bbox": [x, y, w, h], "area": w * h,
                         "iscrowd": int(rng.rand() < 0.1)})
    cats = [{"id": c, "name": str(c)} for c in range(n_cats)]
    return {"images": images, "annotations": anns, "categories": cats}


def test_coco_evaluator_matches_jax():
    rng = np.random.RandomState(3)
    coco = coco_dict(rng, 12)
    preds = {}
    for i in range(12):
        # a jittered copy of each ground-truth box, mostly with its class,
        # and a few boxes anywhere
        gts = [a for a in coco["annotations"] if a["image_id"] == i]
        q = len(gts) + rng.randint(1, 6)
        xy = rng.uniform(0, 140, (q, 2))
        wh = rng.uniform(5, 90, (q, 2))
        labels = rng.randint(0, 3, q)
        for j, a in enumerate(gts):
            xy[j] = np.asarray(a["bbox"][:2]) + rng.randn(2) * 2
            wh[j] = np.asarray(a["bbox"][2:]) * rng.uniform(0.85, 1.15, 2)
            if rng.rand() < 0.8:
                labels[j] = a["category_id"]
        preds[i] = {"scores": rng.rand(q).astype(np.float32),
                    "labels": labels,
                    "boxes": np.concatenate([xy, xy + wh], 1).astype(
                        np.float32)}
    stats = []
    for index, evaluator in ((JaxCocoIndex, JaxEvaluator),
                             (CocoIndex, CocoEvaluator)):
        ev = evaluator(index(coco))
        ev.update(preds)
        ev.synchronize_between_processes()
        ev.accumulate()
        stats.append(ev.summarize())
    assert len(stats[1]) == 12 and stats[1][0] > 0
    np.testing.assert_array_equal(stats[1], stats[0])


def write_coco_split(root, n, seed):
    """A test split of 96 px images with 1-3 coloured boxes of 2 classes
    each, as tests/test_e2e_detection.py writes it."""
    rng = np.random.RandomState(seed)
    os.makedirs(root / "test")
    os.makedirs(root / "annotations")
    images, anns = [], []
    for i in range(n):
        arr = rng.randint(0, 100, (96, 96, 3), dtype=np.uint8)
        for _ in range(rng.randint(1, 4)):
            w, h = rng.randint(16, 40, 2)
            x, y = rng.randint(0, 96 - w), rng.randint(0, 96 - h)
            cat = rng.randint(0, 2)
            arr[y:y + h, x:x + w] = [220, 40, 40] if cat == 0 else [40, 220,
                                                                    40]
            anns.append({"id": len(anns), "image_id": 2000 + i,
                         "category_id": int(cat),
                         "bbox": [int(x), int(y), int(w), int(h)],
                         "area": int(w * h), "iscrowd": 0,
                         "segmentation": []})
        Image.fromarray(arr).save(root / "test" / f"{2000 + i}.jpg")
        images.append({"id": 2000 + i, "width": 96, "height": 96,
                       "file_name": f"{2000 + i}.jpg"})
    cats = [{"id": 0, "name": "red", "supercategory": "red"},
            {"id": 1, "name": "green", "supercategory": "green"}]
    with open(root / "annotations" / "test.json", "w") as f:
        json.dump({"info": {}, "licenses": [], "images": images,
                   "annotations": anns, "categories": cats}, f)


CLI_VIT = {"decoder": "detection", "image_size": 96, "patch_size": 16,
           "embed_dim": 64, "depth": 2, "heads": 2, "mlp_dim": 128,
           "dropout": 0.1, "num_det_tokens": 10, "emb_dropout": 0.1,
           "q_format": "FP32", "compute_dtype": "float32"}


@pytest.fixture(scope="module")
def cli_setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_det_cli")
    write_coco_split(root / "data", 5, seed=0)
    data_config = {
        "dataset_path": str(root / "data"), "test_images": "test",
        "test_annotations": "test.json", "test_subset": None,
        "number_of_classes": 2,
        # 96 px -> 112: a 7 x 7 grid, 60 tokens
        "transform_ops_val": {
            "RandomResize": {"scales": [112], "max_size_ratio": [1333, 800]},
            "Normalize": {"Mean": [0.5, 0.5, 0.5], "Std": [0.5, 0.5, 0.5]},
        },
    }
    with open(root / "data_config.json", "w") as f:
        json.dump(data_config, f)
    with open(os.path.join(REPO, "detection", "train_configs",
                           "yolos_small.json")) as f:
        config = json.load(f)
    config["data_config_path"] = str(root / "data_config.json")
    config["vit_config"] = dict(CLI_VIT)
    kw = jax_vit.vit_kwargs_from_config(config, data_config)
    params = jax_params({k: v for k, v in kw.items() if k != "dtype"}, 4, 96)
    state = init_train_state(jax_vit.ViT(**kw),
                             create_optimizer(config["train_config"]),
                             jax.random.PRNGKey(0), jnp.zeros((1, 96, 96, 3)))
    state = state.replace(params=jax.tree_util.tree_map(jnp.asarray, params))
    save_checkpoint(state, str(root / "jax_ckpt"))
    save_torch_checkpoint(params, "detection", str(root / "model.pth"))
    configs = {}
    for name, ckpt in (("jax", "jax_ckpt"), ("port", "model.pth")):
        config["train_config"]["checkpoint_path"] = str(root / ckpt)
        configs[name] = str(root / f"{name}.json")
        with open(configs[name], "w") as f:
            json.dump(config, f)
    return configs


def run_jax_cli(cfg, monkeypatch):
    """The JAX ``detection/test.py`` as a module, its evaluator's inputs
    and summary captured."""
    from conftest import load_script_module

    det_test = load_script_module(os.path.join(REPO, "detection", "test.py"),
                                  "det_test_for_port")
    preds, stats = {}, []
    update, summarize = JaxEvaluator.update, JaxEvaluator.summarize

    def capture_update(self, predictions):
        preds.update(predictions)
        return update(self, predictions)

    def capture_summarize(self):
        stats.append(summarize(self))
        return stats[-1]

    monkeypatch.setattr(JaxEvaluator, "update", capture_update)
    monkeypatch.setattr(JaxEvaluator, "summarize", capture_summarize)
    with open(cfg) as f:
        det_test.test_detection(json.load(f))
    return preds, stats[0]


@pytest.mark.parametrize("gate", ["as_it_falls", "flash"])
def test_cli_matches_jax_cli(cli_setup, gate, monkeypatch, capsys):
    if gate == "flash":
        for mod in (jax_vit, port_vit):
            monkeypatch.setattr(mod, "fuses_at", lambda n, h, d: False)
    ref_preds, ref_stats = run_jax_cli(cli_setup["jax"], monkeypatch)
    evaluator, preds = cli.main(["-c", cli_setup["port"], "--device", "cpu"])
    assert "IoU metric: bbox" in capsys.readouterr().out
    assert sorted(preds) == sorted(ref_preds) and len(preds) == 5
    for img_id, got in preds.items():
        want = ref_preds[img_id]
        np.testing.assert_array_equal(got["labels"], want["labels"])
        for key in ("scores", "boxes"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                       atol=1e-4, err_msg=key)
    np.testing.assert_allclose(evaluator.stats, ref_stats, rtol=0, atol=1e-4)


def test_cli_cuda_without_a_card_raises(cli_setup, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["-c", cli_setup["port"], "--device", "cuda"])


def test_loader_carries_the_detection_batch(cli_setup):
    """``collate_fn`` batches arrive on the device as the collate made
    them: integer and bool fields keep their dtypes and values."""
    with open(cli_setup["port"]) as f:
        data_config_path = json.load(f)["data_config_path"]
    with open(data_config_path) as f:
        data_config = json.load(f)
    root = data_config["dataset_path"]
    ds = CocoDetection(os.path.join(root, "test"),
                       os.path.join(root, "annotations", "test.json"),
                       T.from_config(data_config["transform_ops_val"]))
    collate = lambda items: T.collate_detection(items, max_boxes=10)  # noqa
    loader = DataLoader(ds, batch_size=2, device="cpu", drop_last=False,
                        collate_fn=collate)
    batches = list(loader.epoch(0))
    assert len(batches) == len(loader) == 3
    ref = collate([ds.__getitem__(
        i, rng=np.random.default_rng((0, i))) for i in (4,)])
    last = batches[-1]
    for key, arr in ref.items():
        t = last[key]
        assert t.dtype == torch.from_numpy(arr).dtype, key
        np.testing.assert_array_equal(t.numpy(), arr, err_msg=key)
    assert last["valid"].dtype == torch.bool and last["valid"].any()
    assert last["image"].shape == (1, 112, 112, 3)
