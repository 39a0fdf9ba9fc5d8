"""The port's training layer against the JAX package's: the LR schedule,
the weight-decay mask and the optimizers, one ViT train step with
gradient accumulation, the shuffled loader, checkpoints and resume, the
pretrained-backbone import, and the train CLI end to end on a tiny
synthetic dataset."""
import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from myrtle_vision_tpu.data.loader import DataLoader as JaxLoader
from myrtle_vision_tpu.datasets.resisc45 import Resisc45
from myrtle_vision_tpu.models.distill import DistillWrapper as JaxWrapper
from myrtle_vision_tpu.models.vit import ViT as JaxViT
from myrtle_vision_tpu.models.vit import (
    vit_kwargs_from_config as jax_vit_kwargs_from_config,
)
from myrtle_vision_tpu.training import optim as jax_optim
from myrtle_vision_tpu.training.classification import (
    make_loss_fn as jax_loss_fn,
)
from myrtle_vision_tpu.training.trainer import (
    TrainState as JaxState,
    make_train_step as jax_train_step,
)
from myrtle_vision_tpu.utils.export import export_torch_state_dict
from myrtle_vision_tpu.utils.pretrained import (
    load_pretrained_backbone as jax_pretrained,
)
from myrtle_vision_tpu_torch.classification import test as eval_cli
from myrtle_vision_tpu_torch.classification import train as train_cli
from myrtle_vision_tpu_torch.data.loader import DataLoader
from myrtle_vision_tpu_torch.models.vit import ViT
from myrtle_vision_tpu_torch.training import optim
from myrtle_vision_tpu_torch.training.classification import make_loss_fn
from myrtle_vision_tpu_torch.training.trainer import (
    TrainState,
    make_train_step,
)
from myrtle_vision_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    prepare_model_and_load_ckpt,
    save_checkpoint,
)
from myrtle_vision_tpu_torch.utils.convert import (
    load_pretrained_backbone,
    state_dict_from_jax,
)

from test_torch_int8_discrete import (
    capture_matches_jax,
    converted_setup,
    jax_logits,
    logits_close,
    refuse_fused,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(decoder="classification", image_size=80, patch_size=16,
          num_classes=5, dim=64, depth=2, heads=2, mlp_dim=128, dim_head=32)
TRAIN_CONFIG = dict(optimizer="adamw", opt_eps=1e-8, opt_betas=None,
                    weight_decay=0.05, momentum=0.9, lr=1e-3, clip_grad=None)


def vit_small_train_config():
    with open(os.path.join(REPO, "classification", "train_configs",
                           "vit_small.json")) as f:
        return json.load(f)["train_config"]


# ------------------------------------------------------------ schedule

@pytest.mark.parametrize("noise", [None, 0.5, [0.2, 0.6]])
def test_lr_at_epoch_matches_jax(noise):
    tc = vit_small_train_config()
    tc["lr_noise"] = noise
    ours = [optim.lr_at_epoch(tc, e) for e in range(311)]
    ref = [jax_optim.lr_at_epoch(tc, e) for e in range(311)]
    assert ours == ref
    assert ours[0] == tc["warmup_lr"]
    if noise is None:
        assert ours[310] == tc["min_lr"]


def test_weight_decay_mask_matches_jax():
    params = JaxViT(**KW).init(jax.random.PRNGKey(0),
                               jnp.zeros((1, 80, 80, 3)))["params"]
    mask = jax_optim._weight_decay_mask(params)
    decayed = {name for name, v in
               export_torch_state_dict(mask, "classification").items() if v}
    model = ViT(**KW)
    names = {id(p): n for n, p in model.named_parameters()}
    groups = optim.param_groups(model, 0.05)
    assert {names[id(p)] for p in groups[0]["params"]} == decayed
    assert groups[0]["weight_decay"] == 0.05
    assert groups[1]["weight_decay"] == 0.0
    assert len(groups[0]["params"]) + len(groups[1]["params"]) == len(names)


class _Toy(torch.nn.Module):
    def __init__(self, w, b):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(w.copy()))
        self.b = torch.nn.Parameter(torch.from_numpy(b.copy()))


@pytest.mark.parametrize("clip", [None, 0.5])
@pytest.mark.parametrize("name", ["adamw", "sgd", "nesterov", "adam"])
def test_optimizers_match_optax(name, clip):
    """Two steps of each optimizer from the same parameters and
    gradients, against the JAX package's optax chain."""
    rng = np.random.RandomState(0)
    w = rng.randn(6, 4).astype(np.float32)
    b = rng.randn(4).astype(np.float32)
    grads = [(rng.randn(6, 4).astype(np.float32),
              rng.randn(4).astype(np.float32)) for _ in range(2)]
    tc = {**TRAIN_CONFIG, "optimizer": name, "clip_grad": clip}

    tx = jax_optim.create_optimizer(tc)
    params = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    opt_state = tx.init(params)
    for gw, gb in grads:
        updates, opt_state = tx.update(
            {"w": jnp.asarray(gw), "b": jnp.asarray(gb)}, opt_state, params)
        params = optax.apply_updates(params, updates)

    model = _Toy(w, b)
    opt = optim.create_optimizer(tc, model)
    for gw, gb in grads:
        model.w.grad = torch.from_numpy(gw.copy())
        model.b.grad = torch.from_numpy(gb.copy())
        if clip is not None:
            optim.clip_by_global_norm([model.w, model.b], clip)
        opt.step()
    for ours, ref in ((model.w, params["w"]), (model.b, params["b"])):
        np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------ train step

@pytest.fixture(scope="module")
def step_pair():
    """Two steps of n_accum=2 micro-batches of 2 at lr 1e-3 through the
    JAX and the port's make_train_step, from one JAX init, fp32."""
    rng = np.random.RandomState(3)
    images = rng.uniform(-1, 1, (2, 2, 2, 80, 80, 3)).astype(np.float32)
    labels = rng.randint(0, 5, (2, 2, 2)).astype(np.int32)

    jmodel = JaxViT(**KW, dtype=jnp.float32)
    params = jmodel.init(jax.random.PRNGKey(1),
                         jnp.zeros((1, 80, 80, 3)))["params"]
    # the step donates its state, so keep a host copy of the start
    init = jax.tree_util.tree_map(np.array, params)
    tx = jax_optim.create_optimizer(TRAIN_CONFIG)
    state = JaxState(params=params, opt_state=tx.init(params), quant={},
                     iteration=jnp.zeros((), jnp.int32))
    loss_fn = jax_loss_fn(jmodel)
    grad_fn = jax.grad(
        lambda p, mb: loss_fn(p, {}, mb, jax.random.PRNGKey(0))[0])
    grads = None
    for i in range(2):
        g = grad_fn(params, {"image": jnp.asarray(images[0, i]),
                             "label": jnp.asarray(labels[0, i])})
        grads = g if grads is None else jax.tree_util.tree_map(
            jnp.add, grads, g)
    step = jax_train_step(loss_fn, tx, 2)
    jax_losses = []
    for s in range(2):
        batch = {"image": jnp.asarray(images[s]),
                 "label": jnp.asarray(labels[s])}
        state, metrics = step(state, batch, 1e-3, jax.random.PRNGKey(s))
        jax_losses.append((float(metrics["loss"]), float(metrics["acc"])))

    model = ViT(**KW, compute_dtype=torch.float32)
    model.load_state_dict(state_dict_from_jax(init), strict=True)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    tstate = TrainState(model, optim.create_optimizer(TRAIN_CONFIG, model))
    tstep = make_train_step(make_loss_fn(model), 2)
    losses, step_grads = [], None
    for s in range(2):
        batch = {"image": torch.from_numpy(images[s]),
                 "label": torch.from_numpy(labels[s])}
        metrics = tstep(tstate, batch, 1e-3)
        losses.append((float(metrics["loss"]), float(metrics["acc"])))
        if s == 0:
            step_grads = {n: p.grad.clone()
                          for n, p in model.named_parameters()}
    return dict(
        jax_losses=jax_losses, losses=losses, iteration=tstate.iteration,
        jax_grads=state_dict_from_jax(
            jax.tree_util.tree_map(np.asarray, grads)),
        grads=step_grads,
        jax_delta={n: v - before[n] for n, v in state_dict_from_jax(
            jax.tree_util.tree_map(np.asarray, state.params)).items()},
        delta={n: p.detach() - before[n]
               for n, p in model.named_parameters()},
    )


def test_train_step_loss_matches_jax(step_pair):
    assert step_pair["iteration"] == 2
    np.testing.assert_allclose(step_pair["losses"], step_pair["jax_losses"],
                               rtol=1e-5, atol=1e-5)


def test_train_step_gradients_match_jax(step_pair):
    ours, ref = step_pair["grads"], step_pair["jax_grads"]
    assert set(ours) == set(ref)
    for name in ref:
        # fp32 on both sides, summed in another order: per element
        # 1e-4 relative plus 1e-4 of the tensor's largest gradient
        bar = 1e-4 * max(float(ref[name].abs().max()), 1e-6)
        torch.testing.assert_close(ours[name], ref[name], rtol=1e-4,
                                   atol=bar, msg=name)


def test_adamw_parameter_change_matches_jax(step_pair):
    ours, ref = step_pair["delta"], step_pair["jax_delta"]
    grads = step_pair["jax_grads"]
    for name in ref:
        # Adam moves each weight by about lr = 1e-3 per step whatever its
        # gradient's size, so an element whose gradient is roundoff moves
        # by +-lr on a coin flip.  The key section of each qkv bias is
        # such: a shift of every key adds a constant to each score row,
        # which softmax ignores, so its gradient is 0 up to roundoff.
        # Elements with a gradient above 1e-6 of the tensor's largest are
        # held to 1e-3 of one step; the others only to two steps.
        g = grads[name].abs()
        defined = g > 1e-6 * float(g.max())
        torch.testing.assert_close(ours[name][defined], ref[name][defined],
                                   rtol=0, atol=1e-6, msg=name)
        rest = ours[name][~defined]
        assert rest.numel() == 0 or float(rest.abs().max()) <= 2.2e-3
    qkv_bias = grads["transformer.layers.0.0.fn.fn.to_qkv.bias"]
    assert float(qkv_bias[64:128].abs().max()) < 1e-7  # the key section
    # the unused detection tokens still decay, as under optax
    assert float(ours["det_tokens"].abs().max()) > 0


# ------------------------------------------------------------ data

@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_train")
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
    return dict(root=root, data=str(data), data_config=data_config,
                data_config_path=str(path))


def test_shuffled_loader_matches_jax_loader(synth):
    trainset = Resisc45("train", synth["data"], "train_imagepaths.txt",
                        "label_map.json",
                        synth["data_config"]["transform_ops_train"])
    kw = dict(batch_size=4, shuffle=True, seed=7, drop_last=True)
    ours = list(DataLoader(trainset, device="cpu", **kw).epoch(3))
    ref = list(JaxLoader(trainset, **kw).epoch(3))
    assert len(ours) == len(ref) == len(trainset) // 4
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a["image"].numpy(), b["image"])
        np.testing.assert_array_equal(a["label"].numpy(), b["label"])
    # another epoch is another order
    again = next(iter(DataLoader(trainset, device="cpu", **kw).epoch(4)))
    assert not np.array_equal(again["label"].numpy(), ours[0]["label"].numpy()) \
        or not np.array_equal(again["image"].numpy(),
                              ours[0]["image"].numpy())


# ------------------------------------------------------------ checkpoints

def _tiny_state(seed):
    model = ViT(**KW, compute_dtype=torch.float32,
                generator=torch.Generator().manual_seed(seed))
    return TrainState(model, optim.create_optimizer(TRAIN_CONFIG, model))


def _batch(seed):
    rng = np.random.RandomState(seed)
    return {"image": torch.from_numpy(
                rng.uniform(-1, 1, (1, 2, 80, 80, 3)).astype(np.float32)),
            "label": torch.from_numpy(rng.randint(0, 5, (1, 2)))}


def test_checkpoint_round_trip_and_resume(tmp_path):
    state = _tiny_state(0)
    step = make_train_step(make_loss_fn(state.model), 1)
    step(state, _batch(1), 1e-3)
    path = str(tmp_path / "vit_000001")
    save_checkpoint(state, path)
    assert not os.path.exists(path + ".tmp")

    resumed, iteration = prepare_model_and_load_ckpt(
        {"checkpoint_path": path}, _tiny_state(1))
    assert iteration == resumed.iteration == 1
    for (n, a), b in zip(state.model.state_dict().items(),
                         resumed.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=n)
    # the next step from the checkpoint is the next step of the run
    m1 = step(state, _batch(2), 1e-3)
    m2 = make_train_step(make_loss_fn(resumed.model), 1)(
        resumed, _batch(2), 1e-3)
    assert float(m1["loss"]) == float(m2["loss"])
    for a, b in zip(state.model.parameters(), resumed.model.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # a fresh state without checkpoint_path starts at 0
    assert prepare_model_and_load_ckpt({"checkpoint_path": ""},
                                       _tiny_state(2))[1] == 0


def test_flax_checkpoint_refused_on_resume(tmp_path):
    path = tmp_path / "vit_000002"
    path.write_bytes(b"\x85\xa5model\x80")
    with pytest.raises(ValueError, match="export_checkpoint.py"):
        load_checkpoint(_tiny_state(0), str(path))


def test_pretrained_backbone_matches_jax(tmp_path):
    """A timm-style .pth goes into the port as the JAX package merges it;
    a timm model name without timm raises RuntimeError in both."""
    from myrtle_vision_tpu.utils.pretrained import _RULES

    rng = np.random.RandomState(4)
    shapes = {"pos_embed": (1, 197, 64), "cls_token": (1, 1, 64),
              "patch_embed.proj.weight": (64, 3, 16, 16),
              "patch_embed.proj.bias": (64,)}
    for i in range(2):
        for key, shape in (("norm1.weight", (64,)), ("norm1.bias", (64,)),
                           ("attn.qkv.weight", (192, 64)),
                           ("attn.qkv.bias", (192,)),
                           ("attn.proj.weight", (64, 64)),
                           ("attn.proj.bias", (64,)),
                           ("norm2.weight", (64,)), ("norm2.bias", (64,)),
                           ("mlp.fc1.weight", (128, 64)),
                           ("mlp.fc1.bias", (128,)),
                           ("mlp.fc2.weight", (64, 128)),
                           ("mlp.fc2.bias", (64,))):
            shapes[f"blocks.{i}.{key}"] = shape
    assert all(any(re.match(p, k) for p, _, _ in _RULES) for k in shapes)
    sd = {k: torch.from_numpy(rng.randn(*s).astype(np.float32))
          for k, s in shapes.items()}
    path = str(tmp_path / "timm.pth")
    torch.save(sd, path)

    params = JaxViT(**KW).init(jax.random.PRNGKey(0),
                               jnp.zeros((1, 80, 80, 3)))["params"]
    ref = state_dict_from_jax(jax_pretrained(
        jax.tree_util.tree_map(np.asarray, params), path))
    model = ViT(**KW)
    keep = model.decoder.linear.weight.detach().clone()
    load_pretrained_backbone(model, path)
    ours = model.state_dict()
    for name in ("patch_to_embedding.weight", "pos_embedding",
                 "transformer.layers.1.0.fn.fn.to_qkv.weight",
                 "transformer.layers.0.1.fn.fn.net.3.weight"):
        torch.testing.assert_close(ours[name], ref[name], rtol=0, atol=0)
    torch.testing.assert_close(ours["decoder.linear.weight"], keep)
    with pytest.raises(RuntimeError, match="timm"):
        load_pretrained_backbone(model, "vit_small_patch16_224")


# ------------------------------------------------------------ CLI

def _write_config(synth, name, **train):
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
            "pretrained_backbone": "vit_small_patch16_224", **train,
        },
        "data_config_path": synth["data_config_path"],
        "vit_config": {
            "decoder": "classification", "image_size": 80,
            "patch_size": 16, "embed_dim": 32, "depth": 1, "heads": 1,
            "mlp_dim": 64, "dropout": 0.0, "emb_dropout": 0.0,
            "q_format": "FP32",
        },
    }
    path = synth["root"] / f"{name}.json"
    with open(path, "w") as f:
        json.dump(config, f)
    return str(path), config


def test_train_cli_runs_resumes_and_evaluates(synth, capsys):
    cfg, config = _write_config(synth, "run")
    state = train_cli.main(["-c", cfg, "--device", "cpu"])
    out = capsys.readouterr().out
    # 21 training images, 8 per step, drop_last: 2 steps in the epoch
    assert re.findall(r"Iteration (\d+):\tloss=[0-9.]+\tacc=[0-9.]+", out) \
        == ["1", "2"]
    assert "WARNING: pretrained backbone unavailable" in out
    assert re.search(r"Epoch : 1 - loss : [0-9.]+ - acc: [0-9.]+ - "
                     r"val_loss : [0-9.]+ - val_acc: [0-9.]+", out)
    assert state.iteration == 2
    run_dir = out.split("output directory: ")[1].split("\n")[0]
    assert sorted(os.listdir(run_dir)) == ["vit_000000", "vit_000002"]

    # resume from the last checkpoint with a second epoch: the reference's
    # epoch offset, int(local_batch * iteration / len(trainset)), is
    # int(4 * 2 / 21) = 0 here, so both epochs run, counting on from 2
    cfg2, _ = _write_config(synth, "resumed", epochs=2,
                            checkpoint_path=f"{run_dir}/vit_000002")
    resumed = train_cli.main(["-c", cfg2, "--device", "cpu"])
    out2 = capsys.readouterr().out
    assert re.findall(r"Iteration (\d+):", out2) == ["3", "4", "5", "6"]
    assert "Epoch : 1 -" in out2 and "Epoch : 2 -" in out2
    assert resumed.iteration == 6

    # the port's eval CLI reads the written checkpoint as it is
    config["train_config"]["checkpoint_path"] = f"{run_dir}/vit_000002"
    eval_cfg = synth["root"] / "eval.json"
    with open(eval_cfg, "w") as f:
        json.dump(config, f)
    gts, preds, logits = eval_cli.main(["-c", str(eval_cfg), "--device",
                                        "cpu"])
    assert len(gts) == len(preds) == logits.shape[0] > 0
    assert torch.isfinite(logits).all()


def test_build_train_repeats_the_cli_first_step(synth, capsys):
    """build_train is the CLI's set-up: built again from the same config
    it gives the same weights and batches, and the CLI's first step."""
    cfg, config = _write_config(synth, "first_step", pretrained_backbone=None)
    train_cli.main(["-c", cfg, "--device", "cpu"])
    printed = float(re.search(r"Iteration 1:\tloss=(\S+)\t",
                              capsys.readouterr().out).group(1))

    def first():
        model, train_loader, val_loader, sizes = train_cli.build_train(
            config, torch.device("cpu"))
        assert val_loader.batch_size == sizes[0]
        return model, next(train_loader.epoch(0)), len(train_loader), sizes

    model, batch, steps, (micro, n_accum) = first()
    model2, batch2, _, _ = first()
    # 21 training images, 8 per step, drop_last: 2 steps
    assert (micro, n_accum, steps) == (4, 2, 2)
    assert batch["image"].shape == (8, 80, 80, 3)
    torch.testing.assert_close(batch2, batch, rtol=0, atol=0)
    torch.testing.assert_close(model2.state_dict(), model.state_dict(),
                               rtol=0, atol=0)
    step = make_train_step(make_loss_fn(model), n_accum)
    state = TrainState(model, optim.create_optimizer(config["train_config"],
                                                     model))
    metrics = step(state, {k: v.view(n_accum, micro, *v.shape[1:])
                           for k, v in batch.items()}, 1e-3)
    assert abs(float(metrics["loss"]) - printed) <= 1e-4


def test_unported_options_raise(synth):
    """Options that raised before their port: a distiller in a quantized
    format now builds its DistillWrapper, whose PyTorchINT8 student
    carries the JAX student's observers (its token's two included) and
    loads the JAX wrapper's params and quant strictly; attention capture
    in a converted INT8 model runs the discrete converted Block, its
    probabilities those the JAX model sows."""
    _, config = _write_config(synth, "distill")
    config["distiller_config"] = {"temperature": 1.0, "alpha": 0.5,
                                  "teacher_weights_path": "x.pth"}
    for q_format in ("FP16_32", "PyTorchINT8"):
        config["vit_config"]["q_format"] = q_format
        vit, wrapper = train_cli.build_models(
            config, synth["data_config"], "cpu", torch.Generator())
        assert wrapper.student is vit and vit.q_format.name == q_format
        assert hasattr(vit, "distill_token_cat") == (q_format ==
                                                     "PyTorchINT8")
    jwrapper = JaxWrapper(student=JaxViT(**jax_vit_kwargs_from_config(
        config, synth["data_config"])), temperature=1.0, alpha=0.5)
    variables = jwrapper.init(jax.random.PRNGKey(0),
                              jnp.zeros((1, 80, 80, 3)),
                              jnp.zeros((1,), jnp.int32), jnp.zeros((1, 10)))
    assert set(variables["quant"]["student"]) >= {"quant_distill_token",
                                                  "distill_token_cat"}
    sd = state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, variables["params"]),
        quant=jax.tree_util.tree_map(np.asarray, variables["quant"]))
    wrapper.load_state_dict(sd, strict=True)
    assert float(wrapper.student.distill_token_cat.min) == float("inf")
    img, jconv, jvars, model, _ = converted_setup("calibrated")
    capture_matches_jax(img, jconv, jvars, model)


@pytest.mark.parametrize("env", [("MVT_INT8_FUSE", "0"),
                                 ("MVT_NO_FUSE", "1")])
def test_converted_int8_refuses_the_discrete_block(monkeypatch, env):
    """Under ``MVT_INT8_FUSE=0`` (as under ``MVT_NO_FUSE=1``) the JAX
    converted Block runs its discrete form, and so does the port's: a
    converted PyTorchINT8 model no longer refuses there, its fused ops
    are not called, and its logits are the JAX model's under the same
    variable (within 2 steps of the head's grid, the converted bar of
    tests/test_torch_int8_discrete.py); with the variable unset it runs
    the fused ops again."""
    img, jconv, variables, model, _ = converted_setup("calibrated")
    x = torch.from_numpy(img)
    with torch.no_grad():
        fused = model(x)
        monkeypatch.setenv(*env)
        ref = jax_logits(jconv, variables, img)
        with monkeypatch.context() as mp:
            refuse_fused(mp)
            got = model(x)
    logits_close(env[0], got.numpy(), ref, model)
    monkeypatch.delenv(env[0])
    with torch.no_grad():
        assert torch.equal(model(x), fused)
