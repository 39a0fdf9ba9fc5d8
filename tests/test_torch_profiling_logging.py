"""The port's step profiler (utils/profiling.py, on ``torch.profiler``)
and scalar logger (utils/logging.py, a copy of the JAX package's) on the
CPU: a trace file appears with MVT_PROFILE_DIR set and none without it;
the logger's ``scalars.jsonl`` lines (its fallback without TensorBoard)
have the JAX logger's format; and the port's segmentation train CLI logs
the JAX CLI's validation scalars from the same weights, traced under
MVT_PROFILE_DIR."""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import myrtle_vision_tpu.models.vit as jax_vit
from myrtle_vision_tpu.training import optim as jax_optim
from myrtle_vision_tpu.training.trainer import init_train_state
from myrtle_vision_tpu.utils.checkpoint import (
    save_checkpoint as jax_save_checkpoint,
)
from myrtle_vision_tpu.utils.logging import ScalarLogger as JaxLogger
from myrtle_vision_tpu_torch.models.vit import ViT
from myrtle_vision_tpu_torch.models.vit import (
    vit_kwargs_from_config as port_vit_kwargs,
)
from myrtle_vision_tpu_torch.segmentation import train as seg_cli
from myrtle_vision_tpu_torch.training import optim
from myrtle_vision_tpu_torch.training.trainer import TrainState
from myrtle_vision_tpu_torch.utils.checkpoint import save_checkpoint
from myrtle_vision_tpu_torch.utils.convert import state_dict_from_jax
from myrtle_vision_tpu_torch.utils.logging import ScalarLogger
from myrtle_vision_tpu_torch.utils.profiling import StepProfiler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def no_tensorboard(monkeypatch):
    """Both loggers' JSONL fallback: TensorBoard's writer not importable."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def work():
    a = torch.randn(64, 64)
    return (a @ a).sum()


@pytest.mark.parametrize("traced", [True, False])
def test_step_profiler_writes_a_trace_only_when_asked(traced, tmp_path,
                                                      monkeypatch):
    """Steps 1..7 with the JAX constructor's defaults (start 3, 3 steps):
    with MVT_PROFILE_DIR one Chrome trace of steps 3-5 holding the work's
    operations; without it nothing is written."""
    trace_dir = tmp_path / "traces"
    if traced:
        monkeypatch.setenv("MVT_PROFILE_DIR", str(trace_dir))
    else:
        monkeypatch.delenv("MVT_PROFILE_DIR", raising=False)
    prof = StepProfiler()
    assert (prof.start, prof.stop) == (3, 6)
    for it in range(1, 8):
        work()
        prof.step(it)
    prof.close()
    if not traced:
        assert not trace_dir.exists()
        return
    assert os.listdir(trace_dir) == ["trace_steps_3_5.json"]
    trace = json.loads((trace_dir / "trace_steps_3_5.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::mm" in names


def test_step_profiler_close_ends_an_open_trace(tmp_path, monkeypatch):
    """A run that stops inside the window still writes its trace."""
    monkeypatch.setenv("MVT_PROFILE_DIR", str(tmp_path))
    prof = StepProfiler(start=1, num_steps=5)
    prof.step(1)
    work()
    prof.close()
    assert os.listdir(tmp_path) == ["trace_steps_1_5.json"]


def test_scalar_lines_match_the_jax_logger(tmp_path, monkeypatch):
    """The same calls through both loggers give the same JSONL lines but
    for the wall-clock ``time``."""
    no_tensorboard(monkeypatch)
    lines = []
    for name, cls in (("jax", JaxLogger), ("port", ScalarLogger)):
        log = cls(str(tmp_path / name))
        log.add_hparams({"lr": 1e-3, "depth": 2, "betas": None,
                         "mean": [0.5]}, {"metric/placeholder": 0.0})
        log.add_scalar("lr", np.float32(0.25), 3)
        log.add_scalar("val_AP", torch.tensor(0.125), np.int64(4))
        log.flush()
        rows = read_jsonl(tmp_path / name / "scalars.jsonl")
        for row in rows:
            assert isinstance(row.pop("time", 0.0), float)
        lines.append(rows)
    assert lines[0] == lines[1]
    assert lines[1][1] == {"tag": "lr", "value": 0.25, "step": 3}


@pytest.fixture(scope="module")
def seg_setup(tmp_path_factory):
    """prepare_synthetic.py's DLRSD-layout data (40 images: 28 train),
    seg_micro_synth.json cut to a 2-block ViT in fp32 compute (local
    batch 4, global 8: 3 steps, a validation before each), and the same
    initial weights as a JAX checkpoint and a port checkpoint."""
    root = tmp_path_factory.mktemp("torch_scalars")
    subprocess.run(
        [sys.executable, os.path.join(REPO, "segmentation",
                                      "prepare_synthetic.py"),
         "--out", str(root / "data"), "--count", "40", "--seed", "6"],
        check=True, capture_output=True)
    with open(os.path.join(REPO, "segmentation", "data_configs",
                           "data_config_synth.json")) as f:
        data_config = json.load(f)
    data_config["dataset_path"] = str(root / "data")
    (root / "data_config.json").write_text(json.dumps(data_config))
    with open(os.path.join(REPO, "segmentation", "train_configs",
                           "seg_micro_synth.json")) as f:
        config = json.load(f)
    config["data_config_path"] = str(root / "data_config.json")
    config["vit_config"].update(embed_dim=64, depth=2, heads=2, mlp_dim=128,
                                compute_dtype="float32")
    config["train_config"].update(epochs=1, local_batch_size=4,
                                  global_batch_size=8, warmup_epochs=0,
                                  iters_per_checkpoint=100, iters_per_val=1)
    kw = jax_vit.vit_kwargs_from_config(config, data_config)
    size = config["vit_config"]["image_size"]
    state = init_train_state(jax_vit.ViT(**kw), jax_optim.create_optimizer(
        config["train_config"]), jax.random.PRNGKey(0),
        jnp.zeros((1, size, size, 3)))
    jax_save_checkpoint(state, str(root / "jax_init"))
    port = ViT(**port_vit_kwargs(config, data_config))
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
        configs[name] = dict(json.loads(json.dumps(config)))
    return root, configs


def test_seg_train_cli_logs_the_jax_cli_scalars(seg_setup, monkeypatch,
                                                capsys):
    """Both segmentation train CLIs from the same weights, each in its own
    directory (their scalars go to ./runs): the port's scalars.jsonl holds
    the JAX CLI's tags and steps (accuracy, loss, miou at each
    validation), the values within 1e-4; under MVT_PROFILE_DIR the port's
    run leaves a trace."""
    from conftest import load_script_module

    root, configs = seg_setup
    no_tensorboard(monkeypatch)
    jax_dir, port_dir = root / "jax_run", root / "port_run"
    jax_dir.mkdir()
    port_dir.mkdir()
    monkeypatch.chdir(jax_dir)
    seg_train = load_script_module(
        os.path.join(REPO, "segmentation", "train.py"),
        "seg_train_for_port_scalars")
    seg_train.train(configs["jax"])
    monkeypatch.chdir(port_dir)
    monkeypatch.setenv("MVT_PROFILE_DIR", str(root / "traces"))
    state = seg_cli.train(configs["port"], torch.device("cpu"))
    capsys.readouterr()
    assert state.iteration == 3
    ref = read_jsonl(jax_dir / "runs" / "scalars.jsonl")
    got = read_jsonl(port_dir / "runs" / "scalars.jsonl")
    key = [(r["tag"], r["step"]) for r in ref]
    assert key == [(r["tag"], r["step"]) for r in got] == [
        (tag, step) for step in (0, 1, 2) for tag in ("accuracy", "loss",
                                                   "miou")]
    np.testing.assert_allclose([r["value"] for r in got],
                               [r["value"] for r in ref], rtol=1e-4,
                               atol=1e-4)
    assert os.listdir(root / "traces") == ["trace_steps_3_5.json"]
