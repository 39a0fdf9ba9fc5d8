"""The port's evaluation CLI end to end on a tiny synthetic dataset,
against the JAX package's eval forward on the same checkpoint; and the
port's boundaries: no CUDA fallback, no jax import, nothing imported of
the JAX package, directly or through another module."""
import ast
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myrtle_vision_tpu.data.loader import DataLoader as JaxLoader
from myrtle_vision_tpu.datasets.resisc45 import Resisc45
from myrtle_vision_tpu.models.vit import ViT as JaxViT
from myrtle_vision_tpu.training.classification import (
    make_predict_fn as jax_predict_fn,
)
from myrtle_vision_tpu.utils.export import save_torch_checkpoint
from myrtle_vision_tpu_torch.classification import test as cli
from myrtle_vision_tpu_torch.data.loader import DataLoader
from myrtle_vision_tpu_torch.datasets.resisc45 import (
    Resisc45 as PortResisc45,
)
from myrtle_vision_tpu_torch.ops.fused_attention_block import (
    fused_attention_block,
)
from myrtle_vision_tpu_torch.ops.fused_mlp import fused_mlp_block
from myrtle_vision_tpu_torch.utils.convert import load_reference_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIT = dict(decoder="classification", image_size=80, patch_size=16,
           num_classes=10, dim=64, depth=2, heads=2, mlp_dim=128,
           dim_head=32)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_cli")
    data = root / "data"
    subprocess.run(
        [sys.executable, os.path.join(REPO, "classification",
                                      "prepare_synthetic.py"),
         "--out", str(data), "--per_class", "5", "--seed", "3"],
        check=True, capture_output=True,
    )
    with open(os.path.join(REPO, "classification", "data_configs",
                           "data_config_synth.json")) as f:
        data_config = json.load(f)
    data_config["dataset_path"] = str(data)
    with open(root / "data_config.json", "w") as f:
        json.dump(data_config, f)

    model = JaxViT(**VIT)
    params = model.init(jax.random.PRNGKey(4),
                        jnp.zeros((1, 80, 80, 3)))["params"]
    ckpt = root / "model.pth"
    save_torch_checkpoint(params, "classification", str(ckpt))

    config = {
        "train_config": {"checkpoint_path": str(ckpt),
                         "local_batch_size": 8, "drop_last_batch": False},
        "data_config_path": str(root / "data_config.json"),
        "vit_config": {
            "decoder": "classification", "image_size": 80, "patch_size": 16,
            "embed_dim": 64, "depth": 2, "heads": 2, "mlp_dim": 128,
            "dropout": 0.1, "emb_dropout": 0.1, "q_format": "FP32",
        },
    }
    cfg = root / "config.json"
    with open(cfg, "w") as f:
        json.dump(config, f)
    testset = Resisc45("eval", str(data), "test_imagepaths.txt",
                       "label_map.json", data_config["transform_ops_val"])
    return dict(cfg=str(cfg), params=params, testset=testset,
                ckpt=str(ckpt), root=root)


def test_cli_predictions_match_jax(setup, capsys):
    gts, preds, logits = cli.main(["-c", setup["cfg"], "--device", "cpu"])
    report = capsys.readouterr().out
    assert "precision" in report and "checker" in report

    predict = jax_predict_fn(JaxViT(**VIT))
    jgts, jpreds = [], []
    loader = JaxLoader(setup["testset"], batch_size=8, drop_last=False,
                       pad_last=True)
    for batch in loader.epoch(0):
        n = batch.pop("_n_valid")
        out = predict(setup["params"], None, jnp.asarray(batch["image"]))
        jpreds.extend(np.asarray(jnp.argmax(out, -1))[:n])
        jgts.extend(batch["label"][:n])
    assert len(preds) == len(setup["testset"]) == 20
    np.testing.assert_array_equal(gts, np.asarray(jgts))
    np.testing.assert_array_equal(preds, np.asarray(jpreds))
    assert logits.dtype == torch.float32 and logits.shape == (20, 10)


def test_loader_batches_match_jax_loader(setup):
    kw = dict(batch_size=6, drop_last=False, pad_last=True)
    ours = list(DataLoader(setup["testset"], device="cpu", **kw).epoch(0))
    ref = list(JaxLoader(setup["testset"], **kw).epoch(0))
    assert [b["_n_valid"] for b in ours] == [6, 6, 6, 2]
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert a["_n_valid"] == b["_n_valid"]
        np.testing.assert_array_equal(a["image"].numpy(), b["image"])
        np.testing.assert_array_equal(a["label"].numpy(), b["label"])


def test_cuda_without_a_card_raises(setup, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["-c", setup["cfg"], "--device", "cuda"])


def test_flax_checkpoint_is_refused(tmp_path):
    path = tmp_path / "vit_000001"
    path.write_bytes(b"\x85\xa5model\x80")  # a msgpack map, as flax writes
    with pytest.raises(ValueError, match="export_checkpoint.py"):
        load_reference_checkpoint(str(path))


def test_wrapped_checkpoint_loads(setup, tmp_path):
    sd = torch.load(setup["ckpt"], weights_only=True)
    path = tmp_path / "wrapped.pth"
    torch.save({"model": sd, "iteration": 3}, path)
    got = load_reference_checkpoint(str(path))
    assert set(got) == set(sd)


@pytest.mark.parametrize("op", ["attention", "mlp"])
def test_ops_raise_on_other_devices(op):
    x = torch.empty(2, 5, 64, device="meta")
    w = torch.empty(64, 192, device="meta")
    with pytest.raises(ValueError, match="no kernel for meta"):
        if op == "attention":
            fused_attention_block(x, x[0, 0], x[0, 0], w, w[0], w[:, :64],
                                  x[0, 0], 2, 0.125)
        else:
            fused_mlp_block(x, x[0, 0], x[0, 0], w, w[0], w.t(), x[0, 0])


def test_port_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import myrtle_vision_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax'))\n"
        "assert not bad, bad\n"
        "print('modules', sum(m.startswith(pkg.__name__) "
        "for m in sys.modules))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 15


def _imported_names(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def _port_sources():
    pkg = os.path.join(REPO, "myrtle_vision_tpu_torch")
    paths = [os.path.join(root, name) for root, _, names in os.walk(pkg)
             for name in names if name.endswith(".py")]
    return sorted(paths) + [os.path.join(REPO, "chip_smoke.py")]


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py drives the port through its own modules: it imports
    nothing of the JAX package directly."""
    names = _imported_names(os.path.join(REPO, "chip_smoke.py"))
    ours = {n for n in names if n.split(".")[0].startswith("myrtle")}
    assert ours and all(n.split(".")[0] == "myrtle_vision_tpu_torch"
                        for n in ours), sorted(ours)


def test_no_port_source_imports_the_jax_package():
    """Every import statement, at any depth, of every port module and of
    chip_smoke.py: none names ``myrtle_vision_tpu`` (or a module in it)."""
    paths = _port_sources()
    assert len(paths) > 30
    bad = {os.path.relpath(p, REPO): sorted(
        n for n in _imported_names(p) if n.split(".")[0] == "myrtle_vision_tpu")
        for p in paths}
    assert not {p: n for p, n in bad.items() if n}


def test_importing_the_port_loads_nothing_of_the_jax_package():
    """Every port module, both CLIs among them, and chip_smoke.py, imported
    in a fresh interpreter: ``myrtle_vision_tpu`` never enters
    ``sys.modules``, so no module reaches it through another."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import myrtle_vision_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] == 'myrtle_vision_tpu')\n"
        "assert not bad, bad\n"
        "need = ['myrtle_vision_tpu_torch.classification.test',\n"
        "        'myrtle_vision_tpu_torch.classification.test_quantize',\n"
        "        'myrtle_vision_tpu_torch.classification.train']\n"
        "assert all(m in sys.modules for m in need)\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-1] == "ok"


@pytest.mark.parametrize("mode,split,config", [
    ("eval", "test_imagepaths.txt", "transform_ops_val"),
    ("train", "train_imagepaths.txt", "transform_ops_train"),
])
def test_resisc45_copy_yields_what_the_jax_one_does(setup, mode, split,
                                                    config):
    """The port's copy of the dataset: the same arrays from the same files,
    random augmentations included, under the same seed."""
    import random

    with open(os.path.join(setup["root"], "data_config.json")) as f:
        data_config = json.load(f)
    args = (mode, data_config["dataset_path"], split, "label_map.json",
            data_config[config])
    random.seed(3)  # the train split is shuffled when it is read
    ours = PortResisc45(*args)
    random.seed(3)
    ref = Resisc45(*args)
    assert len(ours) == len(ref) > 0
    for i in range(0, len(ref), 7):
        a = ours.__getitem__(i, np.random.default_rng(i))
        b = ref.__getitem__(i, np.random.default_rng(i))
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])
