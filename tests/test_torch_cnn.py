"""The port's CNN zoo and its CLIs against the JAX package's on the CPU:
the seven architectures of ``ALL_CNN_ARCHS`` through
``apply_any_torch_sd`` in eval mode (running statistics) and train mode
(batch statistics: the logits and the running statistics' update), on
one He-init state dict each, equal to the JAX package's draw; the frozen
teacher ``make_teacher_fn`` on a saved ``.pth``; one epoch of
``finetune_cnn`` (one SGD step of 64 images, ResNet-18 at 32 px) against
the JAX CLI, its weights and running statistics; ``test_cnn``'s report
equal to the JAX CLI's; the refusals.

Bars, fp32 on both sides, the sums in another order: eval-mode logits
within 2e-5 of the largest (measured at most 4.4e-6, 2 images at 64 px);
train mode on 4 images at 160 px, so that a batch norm of the last stage
normalizes over 100 values a channel (over 8 at 2 images of 64 px,
ResNet-50's train-mode logits were 2e-4 apart): the logits within 1e-4
of the largest (measured at most 6.0e-5, ResNet-50), the running
statistics within 2e-5 of each tensor's largest plus 1e-6 (a running
mean of a zero-mean batch is roundoff, ~1e-7; measured at most 1.0e-5
of the largest, ResNet-50). Each case prints what it measured."""
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myrtle_vision_tpu.models import cnn as jax_cnn
from myrtle_vision_tpu.models import resnet as jax_resnet
from myrtle_vision_tpu_torch.classification import finetune_cnn, test_cnn
from myrtle_vision_tpu_torch.models import cnn, resnet

from conftest import load_script_module

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVAL_BAR, TRAIN_BAR = 2e-5, 1e-4
STATS_RTOL, STATS_ATOL = 2e-5, 1e-6


def images(seed, size=64, batch=2):
    return np.random.RandomState(seed).uniform(
        -1, 1, (batch, size, size, 3)).astype(np.float32)


def torch_sd(sd):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()
            if not k.endswith("num_batches_tracked")}


def relative(out, ref):
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(out) - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("arch", jax_cnn.ALL_CNN_ARCHS)
def test_zoo_matches_jax(arch, train):
    assert cnn.ALL_CNN_ARCHS == jax_cnn.ALL_CNN_ARCHS
    sd = cnn.random_any_state_dict(arch, 7, seed=1)
    ref_sd = jax_cnn.random_any_state_dict(arch, 7, seed=1)
    assert set(sd) == set(ref_sd)
    assert all(np.array_equal(np.asarray(sd[k]), np.asarray(ref_sd[k]))
               for k in sd)
    x = images(0, size=160, batch=4) if train else images(0)
    ref = jax_cnn.apply_any_torch_sd(
        {k: jnp.asarray(v) for k, v in torch_sd(sd).items()},
        jnp.asarray(x), arch, train=train)
    out = cnn.apply_any_torch_sd(torch_sd(sd), torch.from_numpy(x), arch,
                                 train=train)
    if train:
        (ref, ref_stats), (out, stats) = ref, out
        assert set(stats) == set(ref_stats)
        assert bool(stats) == (not arch.startswith("squeezenet"))
        worst = 0.0
        for name, value in ref_stats.items():
            value = np.asarray(value)
            d = float(np.abs(stats[name].numpy() - value).max())
            worst = max(worst, (d - STATS_ATOL) / np.abs(value).max())
            np.testing.assert_allclose(
                stats[name].numpy(), value, rtol=0,
                atol=STATS_RTOL * np.abs(value).max() + STATS_ATOL,
                err_msg=name)
        print(f"{arch} train: running statistics {worst:.3g} of their "
              "largest past 1e-6")
    assert out.shape == (len(x), 7) and out.dtype == torch.float32
    d = relative(out.numpy(), ref)
    print(f"{arch} {'train' if train else 'eval'}: logits {d:.3g} of the "
          "largest")
    assert d <= (TRAIN_BAR if train else EVAL_BAR)


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_teacher_fn_matches_jax(arch, tmp_path):
    """``make_teacher_fn`` on a ``.pth`` (with ``num_batches_tracked``
    and batch-norm statistics moved off their init, so the folding
    matters): the logits of the folded network against the JAX teacher's,
    and against the raw state dict in eval mode."""
    rng = np.random.RandomState(5)
    sd = resnet.random_state_dict(arch, 6, seed=2)
    for k in sd:
        if k.endswith(("running_mean", "bias")):
            sd[k] = (0.1 * rng.randn(*sd[k].shape)).astype(np.float32)
        elif k.endswith("running_var"):
            sd[k] = rng.uniform(0.5, 2.0, sd[k].shape).astype(np.float32)
    path = str(tmp_path / "teacher.pth")
    torch.save({k: torch.as_tensor(v) for k, v in sd.items()}, path)
    x = images(1)
    ref = np.asarray(jax_resnet.make_teacher_fn(path, arch)(jnp.asarray(x)))
    teacher = resnet.make_teacher_fn(path, arch)
    out = teacher(torch.from_numpy(x))
    assert not out.requires_grad
    raw = resnet.resnet_apply_torch_sd(torch_sd(sd), torch.from_numpy(x),
                                       arch)
    print(f"{arch}: teacher {relative(out, ref):.3g}, raw "
          f"{relative(raw, ref):.3g} of the largest logit")
    assert relative(out, ref) <= EVAL_BAR
    assert relative(raw, ref) <= EVAL_BAR


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """A 10-class synthetic RESISC-layout set (70 train, 10 validation,
    20 test images) at 32 px."""
    root = tmp_path_factory.mktemp("torch_cnn")
    data = root / "data"
    subprocess.run(
        [sys.executable, os.path.join(REPO, "classification",
                                      "prepare_synthetic.py"),
         "--out", str(data), "--per_class", "10", "--seed", "11"],
        check=True, capture_output=True,
    )
    with open(os.path.join(REPO, "classification", "data_configs",
                           "data_config_synth.json")) as f:
        data_config = json.load(f)
    data_config["dataset_path"] = str(data)
    data_config["transform_ops_train"]["RandomResizedCrop"] = 32
    data_config["transform_ops_val"]["Resize"] = 32
    path = root / "data_config.json"
    path.write_text(json.dumps(data_config))
    return dict(root=root, data=str(data), data_config=str(path))


@pytest.fixture
def jax_cli(monkeypatch):
    """The JAX package's CNN CLIs loaded as modules, the process's
    sys.path, the stdlib ``test`` module and the JAX compilation cache
    setting (which the scripts change when imported) restored after."""
    cache_dir = jax.config.jax_compilation_cache_dir
    monkeypatch.setattr(sys, "path", list(sys.path))
    try:
        monkeypatch.setitem(sys.modules, "test", load_script_module(
            os.path.join(REPO, "classification", "test.py"),
            "jax_classification_test_for_cnn"))
        yield {name: load_script_module(
            os.path.join(REPO, "classification", f"{name}.py"),
            f"jax_{name}_for_port") for name in ("finetune_cnn", "test_cnn")}
    finally:
        jax.config.update("jax_compilation_cache_dir", cache_dir)


def jax_float64_finetune(cli, data_config):
    """The JAX CLI's ``finetune_cnn`` step of the test below in float64
    (``jax_enable_x64``): its initial draw, loader, batch, masked optax
    chain and train-mode ResNet, every array float64, the cross entropy
    of ``cross_entropy_loss`` without its float32 cast."""
    import optax

    from myrtle_vision_tpu.data.loader import DataLoader as JaxLoader
    from myrtle_vision_tpu.datasets.resisc45 import Resisc45 as JaxResisc45
    from myrtle_vision_tpu.utils.config import seed_everything

    dc = json.loads(open(data_config).read())
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        seed_everything(0)
        sd = cli.load_initial_sd("resnet18", dc["number_of_classes"], None)
        params = {k: jnp.asarray(v, jnp.float64) for k, v in sd.items()
                  if not k.endswith("num_batches_tracked")}
        tx = optax.masked(
            optax.chain(optax.clip_by_global_norm(5.0),
                        optax.sgd(0.05, momentum=0.9)),
            {k: cli.is_trainable(k) for k in params})
        opt_state = tx.init(params)

        @jax.jit
        def step(params, opt_state, images, labels):
            def loss_fn(p):
                logits, stats = jax_cnn.apply_any_torch_sd(
                    p, images, "resnet18", train=True)
                logp = jax.nn.log_softmax(logits, axis=-1)
                nll = -jnp.take_along_axis(logp, labels[:, None], -1)
                return jnp.mean(nll), stats

            (_, stats), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(params)
            updates, opt_state = tx.update(grads, opt_state, params)
            return {**optax.apply_updates(params, updates), **stats}, \
                opt_state

        trainset = JaxResisc45(mode="train", dataset_path=dc["dataset_path"],
                               imagepaths=dc["train_files"],
                               label_map_path=dc["label_map"],
                               transform_config=dc["transform_ops_train"])
        for batch in JaxLoader(trainset, batch_size=64, shuffle=True,
                               seed=0).epoch(0):
            params, opt_state = step(
                params, opt_state,
                jnp.asarray(batch["image"], jnp.float64),
                jnp.asarray(batch["label"]))
        return {k: torch.from_numpy(np.array(v, np.float64))
                for k, v in params.items()}
    finally:
        jax.config.update("jax_enable_x64", x64)


def test_finetune_step_matches_jax(synth, jax_cli, tmp_path):
    """One epoch of 70 images at batch 64 is one SGD step (drop_last):
    ResNet-18 from the He-init draw at 32 px, lr 0.05, through both CLIs.
    The printed loss and validation accuracy the same; every trained
    tensor of the port's within 1e-5 of its largest plus 1e-6 of the
    start's of the JAX step in float64, the running statistics as above;
    the written file a torchvision state dict with one
    ``num_batches_tracked`` per batch norm.  The JAX step in float64, not
    the JAX CLI's fp32 step, holds the tensors: on some hosts XLA:CPU's
    fp32 convolution gradients land far from it (a batch norm bias 1.5e3
    bars off, where the port's are within 0.33), and the JAX CLI's
    distance from it is printed."""
    outs = {}
    for name, run in (("jax", jax_cli["finetune_cnn"].finetune),
                      ("port", finetune_cnn.finetune)):
        outs[name] = str(tmp_path / f"{name}.pth")
        printed = io.StringIO()
        with redirect_stdout(printed):
            run("resnet18", synth["data_config"], 1, 64, 0.05, None,
                outs[name])
        outs[name + "_printed"] = printed.getvalue().splitlines()[0]
    print(outs["jax_printed"], "|", outs["port_printed"])
    assert outs["port_printed"] == outs["jax_printed"]
    ours, jax_sd = (torch.load(outs[n], weights_only=True)
                    for n in ("port", "jax"))
    exact = jax_float64_finetune(jax_cli["finetune_cnn"],
                                 synth["data_config"])
    start = resnet.random_state_dict("resnet18", 10)
    assert set(ours) == set(jax_sd) == set(start)
    moved, worst, jax_worst = 0, 0.0, 0.0
    for name, t in jax_sd.items():
        got = ours[name]
        assert got.dtype == t.dtype, name
        if name.endswith("num_batches_tracked"):
            assert int(got) == int(t) == 0
            continue
        ref = exact[name].detach().float()
        t0 = torch.from_numpy(start[name])
        if name.endswith(("running_mean", "running_var")):
            atol = STATS_RTOL * float(ref.abs().max()) + STATS_ATOL
        else:
            atol = 1e-5 * float(ref.abs().max()) + 1e-6 * float(
                t0.abs().max())
            moved += not torch.equal(got, t0)
        worst = max(worst, float((got - ref).abs().max()) / atol)
        jax_worst = max(jax_worst, float((t - ref).abs().max()) / atol)
        torch.testing.assert_close(got, ref, rtol=0, atol=atol, msg=name)
    print(f"from the JAX step in float64: the port's tensors at most "
          f"{worst:.3f} bars, the JAX CLI's {jax_worst:.3f}")
    assert moved == len([k for k in jax_sd if finetune_cnn.is_trainable(k)])


def test_test_cnn_report_matches_jax(synth, jax_cli, tmp_path):
    """``test_cnn`` on a MobileNetV2 ``.pth`` (batch-norm statistics off
    their init), test and validation splits: the printed report equal to
    the JAX CLI's."""
    rng = np.random.RandomState(3)
    sd = cnn.random_any_state_dict("mobilenet_v2", 10, seed=4)
    for k in sd:
        if k.endswith("running_mean"):
            sd[k] = (0.1 * rng.randn(*sd[k].shape)).astype(np.float32)
    # the pooled features of a random network barely differ between
    # images: a steep head spreads the predictions over the classes
    sd["classifier.1.weight"] *= 100
    path = str(tmp_path / "mbv2.pth")
    torch.save({k: torch.as_tensor(v) for k, v in sd.items()}, path)
    for use_val in (False, True):
        reports = {}
        for name, run in (("jax", jax_cli["test_cnn"].test_cnn),
                          ("port", test_cnn.test_cnn)):
            printed = io.StringIO()
            with redirect_stdout(printed):
                out = run("mobilenet_v2", path, use_val,
                          synth["data_config"])
            reports[name] = printed.getvalue()
        gts, preds, logits = out
        with open(os.path.join(synth["data"], "val_imagepaths.txt" if use_val
                               else "test_imagepaths.txt")) as f:
            count = len(f.read().split())
        assert len(gts) == len(preds) == logits.shape[0] == count > 0
        print(reports["port"])
        assert reports["port"] == reports["jax"]


def test_cnn_cli_refusals(synth, tmp_path, monkeypatch):
    with pytest.raises(SystemExit, match="unsupported model"):
        test_cnn.test_cnn("vgg16", "x.pth", data_config_path=synth[
            "data_config"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        test_cnn.main(["--cnn_weights", "x.pth", "--data_config",
                       synth["data_config"]])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        finetune_cnn.main(["--data_config", synth["data_config"],
                           "--output", str(tmp_path / "x.pth")])
