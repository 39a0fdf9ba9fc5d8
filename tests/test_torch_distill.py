"""The port's DeiT distillation against the JAX package's on the CPU: the
loss; the DistillWrapper's loss, student logits and gradients with the
weights carried across by ``state_dict_from_jax``; one distilled train
step (two micro-batches, AdamW) against the JAX ``make_loss_fn(vit,
distiller, teacher_fn)`` step; a deit checkpoint through the port's eval
and export CLIs against the JAX CLIs; the train CLI end to end on a
teacher that the port's ``finetune_cnn`` wrote; and the quantized
formats: a student in FP16_32, TF32 and PyTorchINT8 (the one-pass INT8
step, its observers) against the JAX step, and a quantized deit config
through the train, eval and export CLIs.

The student: dim 64, depth 2, 2 heads of 32, MLP 128, 80 px, 5 or 10
classes: 25 patches, the class token and the distillation token, N = 27,
compute in fp32 on both sides.  Bars: loss and logits within 1e-4 of the
largest, gradients within 2e-4 of each tensor's largest; elements whose
gradient is undefined (the key third of each qkv bias: softmax ignores a
shift of every key, so that gradient is roundoff on both sides) are left
out, as tests/test_torch_training.py leaves them out."""
import copy
import io
import json
import os
import re
import subprocess
import sys
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myrtle_vision_tpu.models.distill import (
    DistillWrapper as JaxWrapper,
    distillation_loss as jax_distillation_loss,
)
from myrtle_vision_tpu.models.resnet import make_teacher_fn as jax_teacher
from myrtle_vision_tpu.models.vit import ViT as JaxViT
from myrtle_vision_tpu.quantize import QFormat as JaxQFormat
from myrtle_vision_tpu.training import optim as jax_optim
from myrtle_vision_tpu.training.classification import (
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
from myrtle_vision_tpu_torch.classification import export_checkpoint
from myrtle_vision_tpu_torch.classification import finetune_cnn
from myrtle_vision_tpu_torch.classification import test as eval_cli
from myrtle_vision_tpu_torch.classification import train as train_cli
from myrtle_vision_tpu_torch.models.distill import (
    DistillableViT,
    DistillWrapper,
    distillation_loss,
)
from myrtle_vision_tpu_torch.models.resnet import (
    make_teacher_fn,
    random_state_dict,
)
from myrtle_vision_tpu_torch.models.vit import ViT
from myrtle_vision_tpu_torch.training import optim
from myrtle_vision_tpu_torch.training.classification import make_loss_fn
from myrtle_vision_tpu_torch.training.trainer import (
    TrainState,
    make_train_step,
)
from myrtle_vision_tpu_torch.utils.checkpoint import save_checkpoint
from myrtle_vision_tpu_torch.utils.convert import (
    load_reference_checkpoint,
    state_dict_from_jax,
)

from conftest import load_script_module

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(decoder="classification", image_size=80, patch_size=16,
          num_classes=5, dim=64, depth=2, heads=2, mlp_dim=128, dim_head=32)
TRAIN_CONFIG = dict(optimizer="adamw", opt_eps=1e-8, opt_betas=None,
                    weight_decay=0.05, momentum=0.9, lr=1e-3, clip_grad=None)
T, ALPHA = 3.0, 0.5
LOGIT_BAR, GRAD_BAR = 1e-4, 2e-4
QKV_KEYS = slice(64, 128)  # the key third of a qkv bias (2 heads of 32)


def jax_wrapper(num_classes=5, q_format="FP32", depth=2):
    student = JaxViT(**{**KW, "num_classes": num_classes, "depth": depth},
                     q_format=JaxQFormat[q_format], dtype=jnp.float32)
    return JaxWrapper(student=student, temperature=T, alpha=ALPHA)


def jax_params(wrapper, seed=0, with_quant=False):
    """The JAX wrapper's initial tree, every leaf moved by seeded noise
    (so the LayerNorms and biases are off 1 and 0), as numpy; with
    ``with_quant`` also its fresh ``quant`` collection ({} but in
    PyTorchINT8)."""
    variables = wrapper.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 80, 80, 3)),
        jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, wrapper.student.num_classes)))
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p, np.float32)
        + (0.05 * rng.randn(*p.shape)).astype(np.float32),
        variables["params"])
    if not with_quant:
        return params
    return params, jax.tree_util.tree_map(np.asarray,
                                          variables.get("quant", {}))


def port_wrapper(params, num_classes=5, q_format="FP32", quant=None,
                 depth=2):
    student = ViT(**{**KW, "num_classes": num_classes, "depth": depth},
                  compute_dtype=torch.float32, q_format=q_format)
    wrapper = DistillWrapper(student, temperature=T, alpha=ALPHA)
    wrapper.load_state_dict(state_dict_from_jax(params, quant=quant or None),
                            strict=True)
    return wrapper


def inputs(seed, batch=4, num_classes=5):
    rng = np.random.RandomState(seed)
    return (rng.uniform(-1, 1, (batch, 80, 80, 3)).astype(np.float32),
            rng.randint(0, num_classes, (batch,)).astype(np.int32),
            (3 * rng.randn(batch, num_classes)).astype(np.float32))


def defined(grad):
    """The elements of a gradient that are not roundoff on both sides."""
    g = grad.abs()
    return g > 1e-6 * float(g.max())


@pytest.mark.parametrize("t,alpha", [(3.0, 0.5), (1.0, 0.1), (4.0, 1.0)])
def test_distillation_loss_matches_jax(t, alpha):
    rng = np.random.RandomState(int(t * 10 + alpha * 100))
    student, distill, teacher = (
        (4 * rng.randn(6, 45)).astype(np.float32) for _ in range(3))
    labels = rng.randint(0, 45, 6).astype(np.int32)
    ref = float(jax_distillation_loss(*map(jnp.asarray, (
        student, distill, teacher, labels)), t, alpha))
    ours = float(distillation_loss(*map(torch.from_numpy, (
        student, distill, teacher, labels)), t, alpha))
    assert abs(ours - ref) <= 1e-6 * max(1.0, abs(ref)), (ours, ref)


def test_state_dict_from_jax_names_the_wrapper():
    params = jax_params(jax_wrapper())
    sd = state_dict_from_jax(params)
    assert set(sd) == set(DistillWrapper(ViT(**KW)).state_dict())
    np.testing.assert_array_equal(sd["distill_mlp_linear.weight"].numpy(),
                                  params["distill_mlp_linear"]["kernel"].T)
    np.testing.assert_array_equal(sd["distillation_token"].numpy(),
                                  params["distillation_token"])
    assert torch.equal(sd["student.cls_token"],
                       state_dict_from_jax(params["student"])["cls_token"])


def test_wrapper_matches_jax():
    """The loss, the student's logits and every gradient, the JAX wrapper
    (its student's fused blocks in Pallas interpret mode) against the
    port's, the same weights."""
    wrapper = jax_wrapper()
    params = jax_params(wrapper)
    img, labels, teacher = inputs(1)

    def loss_fn(p):
        return wrapper.apply({"params": p}, jnp.asarray(img),
                             jnp.asarray(labels), jnp.asarray(teacher))

    (ref_loss, ref_logits), grads = jax.value_and_grad(
        loss_fn, has_aux=True)(params)
    ref_grads = state_dict_from_jax(jax.tree_util.tree_map(np.asarray,
                                                           grads))

    model = port_wrapper(params)
    loss, logits = model(torch.from_numpy(img), torch.from_numpy(labels),
                         torch.from_numpy(teacher))
    loss.backward()
    ref_logits = np.asarray(ref_logits)
    d_logits = np.abs(logits.detach().numpy() - ref_logits).max()
    print(f"loss {loss.item():.7f} vs {float(ref_loss):.7f}, logits "
          f"{d_logits:.3g}")
    assert abs(loss.item() - float(ref_loss)) <= LOGIT_BAR * max(
        1.0, abs(float(ref_loss)))
    assert d_logits <= LOGIT_BAR * max(1.0, np.abs(ref_logits).max())
    worst = 0.0
    for name, p in model.named_parameters():
        ref = ref_grads[name]
        got = p.grad if p.grad is not None else torch.zeros_like(ref)
        if not float(ref.abs().max()):
            assert not float(got.abs().max()), name  # det tokens
            continue
        mask = defined(ref)
        d = float((got - ref)[mask].abs().max()) / float(ref.abs().max())
        worst = max(worst, d)
        assert d <= GRAD_BAR, (name, d)
    qkv = ref_grads["student.transformer.layers.0.0.fn.fn.to_qkv.bias"]
    assert not bool(defined(qkv)[QKV_KEYS].any())
    print(f"largest gradient difference {worst:.3g} of its tensor's scale")


@pytest.fixture(scope="module")
def teacher_pth(tmp_path_factory):
    """A ResNet-18 teacher ``.pth`` (He-init, 5 classes)."""
    path = str(tmp_path_factory.mktemp("teacher") / "resnet18.pth")
    torch.save({k: torch.as_tensor(v) for k, v in
                random_state_dict("resnet18", 5, seed=4).items()}, path)
    return path


def test_distilled_train_step_matches_jax(teacher_pth):
    """One step of two micro-batches of 2 (AdamW, lr 1e-3): the JAX
    ``make_loss_fn(vit, distiller, teacher_fn)`` step against the port's,
    the same weights and a ResNet-18 teacher from the same ``.pth`` in
    each package: the metrics, and every parameter's change within 1e-6
    where its gradient is defined (the others move by +-lr on a coin
    flip, at most 2.2e-3)."""
    wrapper = jax_wrapper()
    params = jax_params(wrapper, seed=2)
    rng = np.random.RandomState(7)
    batch = {"image": rng.uniform(-1, 1, (2, 2, 80, 80, 3)).astype(
                 np.float32),
             "label": rng.randint(0, 5, (2, 2)).astype(np.int32)}

    tx = jax_optim.create_optimizer(TRAIN_CONFIG)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    state = JaxState(params=jparams, opt_state=tx.init(jparams), quant={},
                     iteration=jnp.zeros((), jnp.int32))
    loss_fn = jax_loss_fn(wrapper.student, distiller=wrapper,
                          teacher_fn=jax_teacher(teacher_pth, "resnet18"))
    grad_fn = jax.grad(lambda p, mb: loss_fn(p, {}, mb,
                                             jax.random.PRNGKey(0))[0])
    grads = None
    for i in range(2):
        g = grad_fn(jparams, {k: jnp.asarray(v[i]) for k, v in
                              batch.items()})
        grads = g if grads is None else jax.tree_util.tree_map(jnp.add,
                                                               grads, g)
    grads = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, grads))
    state, metrics = jax_train_step(loss_fn, tx, 2)(
        state, {k: jnp.asarray(v) for k, v in batch.items()}, 1e-3,
        jax.random.PRNGKey(0))
    after = state_dict_from_jax(jax.tree_util.tree_map(np.asarray,
                                                       state.params))
    start = state_dict_from_jax(params)

    model = port_wrapper(params)
    tstate = TrainState(model, optim.create_optimizer(TRAIN_CONFIG, model))
    step = make_train_step(make_loss_fn(
        model.student, model, make_teacher_fn(teacher_pth, "resnet18")), 2)
    ours = step(tstate, {k: torch.from_numpy(v) for k, v in batch.items()},
                1e-3)
    print(f"loss {float(ours['loss']):.7f} vs {float(metrics['loss']):.7f}")
    assert abs(float(ours["loss"]) - float(metrics["loss"])) <= LOGIT_BAR
    assert float(ours["acc"]) == float(metrics["acc"])
    for name, p in model.named_parameters():
        delta = p.detach() - start[name]
        ref = after[name] - start[name]
        mask = defined(grads[name])
        torch.testing.assert_close(delta[mask], ref[mask], rtol=0,
                                   atol=1e-6, msg=name)
        rest = delta[~mask]
        assert rest.numel() == 0 or float(rest.abs().max()) <= 2.2e-3, name
    # the token and the head moved, and the unused detection tokens decay
    for name in ("distillation_token", "distill_mlp_linear.weight",
                 "student.det_tokens"):
        assert float((model.state_dict()[name] - start[name]).abs().max())


def test_distillable_vit_to_vit():
    model = DistillableViT(**KW, compute_dtype=torch.float32)
    vit = model.to_vit()
    assert type(vit) is ViT
    x = torch.from_numpy(inputs(3)[0])
    token = torch.randn(1, 1, 64)
    with torch.no_grad():
        logits, embedding = model(x, distill_token=token)
        assert torch.equal(vit(x, distill_token=token)[0], logits)
        assert embedding.shape == (4, 64) and embedding.dtype == \
            torch.float32


def observer_names(state_dict):
    return [n for n in state_dict if n.endswith((".min", ".max"))]


@pytest.mark.parametrize("q_format", ["FP16_32", "PyTorchINT8", "TF32"])
def test_quantized_distillation_raises_a8b(q_format):
    """A student in a quantized format against the JAX package's: the
    JAX ``make_loss_fn(vit, distiller, teacher_fn)`` step's loss and
    gradients (PyTorchINT8: the one-pass step, its calibrating forward
    differentiated op by op, the observers updated as it runs) against
    the port's; the student's logits and the token's embedding from the
    same state; in PyTorchINT8 every observer after the step, the
    token's two included.  Float formats (the student's fused blocks
    with their qspec at N = 27; the token's stub an identity, its
    functional site a snap only in FP16_16): the two packages' fp32 sums
    put a snap on either side of a rounding boundary now and then, which
    moves that element a whole format step (ROADMAP C6), so the logits
    and the embedding are held to 1e-4 plus one format step at their
    largest magnitude, the loss to what the differences of the logits and
    of the distillation head's outputs allow, and the gradients to 2e-3 of their scale, tests/test_torch_float_qat.py's
    bars with the snaps on (measured in FP16_32 at depth 2: logits 3.2e-4
    apart, gradients 3.0e-4 of their scale; with every snap of both
    packages the identity, 2.4e-6 and 8.9e-6).  The student here has one
    block.  PyTorchINT8: logits and embedding within
    1e-4 plus one step of the logits' grid (tests/test_torch_int8_qat.py),
    the loss likewise, observers 1e-5, gradients GRAD_BAR."""
    int8 = q_format == "PyTorchINT8"
    wrapper = jax_wrapper(q_format=q_format, depth=1)
    params, quant = jax_params(wrapper, seed=6, with_quant=True)
    img, labels, teacher = inputs(8, batch=2)
    batch = {"image": jnp.asarray(img), "label": jnp.asarray(labels)}

    loss_fn = jax_loss_fn(wrapper.student, distiller=wrapper,
                          teacher_fn=lambda _: jnp.asarray(teacher))
    (ref_loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        params, quant, batch, jax.random.PRNGKey(0))
    ref_grads = state_dict_from_jax(jax.tree_util.tree_map(np.asarray,
                                                           grads))
    student = {"params": params["student"]}
    kwargs = dict(distill_token=jnp.asarray(params["distillation_token"]))
    if int8:
        student["quant"] = quant["student"]
        kwargs.update(calibrating=True, mutable=["quant"])
    out = wrapper.student.apply(student, jnp.asarray(img), **kwargs)
    ref_logits, ref_token = (np.asarray(t) for t in (out[0] if int8
                                                     else out))

    model = port_wrapper(params, q_format=q_format, quant=quant, depth=1)
    assert set(observer_names(model.state_dict())) == (
        set(observer_names(state_dict_from_jax(params, quant=quant)))
        if int8 else set())
    with torch.no_grad():
        logits, token = copy.deepcopy(model.student)(
            torch.from_numpy(img), calibrating=int8,
            distill_token=model.distillation_token)
    loss, _ = make_loss_fn(model.student, model, lambda _: torch.from_numpy(
        teacher))({k: torch.from_numpy(np.asarray(v))
                   for k, v in batch.items()})
    loss.backward()

    def bar(ref):
        top = float(np.abs(ref).max())
        step = (float(np.ptp(ref_logits)) / 255.0 if int8
                else 2.0 ** (np.floor(np.log2(top)) - 10))
        return LOGIT_BAR * max(1.0, top) + step

    d_logits = np.abs(logits.numpy() - ref_logits).max()
    d_token = np.abs(token.numpy() - ref_token).max()
    print(f"{q_format}: loss {loss.item():.7f} vs {float(ref_loss):.7f}, "
          f"logits {d_logits:.3g} (bar {bar(ref_logits):.3g}), token "
          f"{d_token:.3g} (bar {bar(ref_token):.3g})")
    assert d_logits <= bar(ref_logits) and d_token <= bar(ref_token)
    # cross entropy moves by at most 2 max|d logits|, T^2 KL(z / T) by
    # at most 2 T max|d z| where z is the distillation head's output
    with torch.no_grad():
        d_head = float((model.distill_mlp_linear(model.distill_mlp_norm(
            token)) - model.distill_mlp_linear(model.distill_mlp_norm(
                torch.from_numpy(ref_token)))).abs().max())
    assert abs(loss.item() - float(ref_loss)) <= 1e-6 * abs(
        float(ref_loss)) + 2 * (ALPHA * d_logits + (1 - ALPHA) * T * d_head)
    grad_bar = GRAD_BAR if int8 else 2e-3
    worst = 0.0
    for name, p in model.named_parameters():
        ref = ref_grads[name]
        got = p.grad if p.grad is not None else torch.zeros_like(ref)
        if not float(ref.abs().max()):
            assert not float(got.abs().max()), name
            continue
        mask = defined(ref)
        d = float((got - ref)[mask].abs().max()) / float(ref.abs().max())
        worst = max(worst, d)
        assert d <= grad_bar, (name, d)
    print(f"{q_format}: largest gradient difference {worst:.3g}")
    if int8:
        after = state_dict_from_jax(params, quant=jax.tree_util.tree_map(
            np.asarray, aux["quant"]))
        sd = model.state_dict()
        for name in observer_names(after):
            np.testing.assert_allclose(sd[name].numpy(), after[name].numpy(),
                                       rtol=1e-5, atol=1e-7, err_msg=name)
        assert float(sd["student.distill_token_cat.max"]) > float(
            sd["student.distill_token_cat.min"])


# ------------------------------------------------------------ CLIs

@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """A 10-class synthetic RESISC-layout set at 80 px (70 train, 10
    validation, 20 test images) and a ResNet-50 teacher that the port's
    ``finetune_cnn`` wrote from He-init (two SGD steps of 32 images)."""
    root = tmp_path_factory.mktemp("torch_distill")
    data = root / "data"
    subprocess.run(
        [sys.executable, os.path.join(REPO, "classification",
                                      "prepare_synthetic.py"),
         "--out", str(data), "--per_class", "10", "--seed", "13"],
        check=True, capture_output=True,
    )
    with open(os.path.join(REPO, "classification", "data_configs",
                           "data_config_synth.json")) as f:
        data_config = json.load(f)
    data_config["dataset_path"] = str(data)
    path = root / "data_config.json"
    path.write_text(json.dumps(data_config))
    teacher = str(root / "teacher_resnet50.pth")
    with redirect_stdout(io.StringIO()):
        finetune_cnn.main(["--model", "resnet50", "--data_config",
                           str(path), "--epochs", "1", "--batch_size", "32",
                           "--output", teacher, "--device", "cpu"])
    return dict(root=root, data_config=str(path), teacher=teacher)


def deit_config(synth, name, q_format="FP32", **train):
    """classification/train_configs/deit_micro_synth.json's keys at the
    test's widths, the distiller pointing at the fixture's teacher."""
    with open(os.path.join(REPO, "classification", "train_configs",
                           "deit_micro_synth.json")) as f:
        config = json.load(f)
    config["train_config"].update({
        "output_directory": str(synth["root"] / name), "epochs": 1,
        "local_batch_size": 8, "global_batch_size": 16,
        "iters_per_checkpoint": 2, "iters_per_val": 2, "seed": 7,
        "warmup_epochs": 0, "checkpoint_path": "", **train})
    config["data_config_path"] = synth["data_config"]
    config["vit_config"].update(embed_dim=64, depth=2, heads=2, mlp_dim=128,
                                q_format=q_format)
    config["distiller_config"]["teacher_weights_path"] = synth["teacher"]
    path = synth["root"] / f"{name}.json"
    path.write_text(json.dumps(config))
    return str(path), config


def test_train_cli_distills_and_its_checkpoint_evaluates(synth, capsys):
    """The train CLI on a deit config: 70 images, 2 x 8 a step, 4 steps, the
    distillation loss in every line; the checkpoints hold the wrapper,
    whose student the eval and export CLIs read; the first step again
    from the CLI's own set-up (``build_train``) prints the same loss."""
    cfg, config = deit_config(synth, "deit")
    state = train_cli.main(["-c", cfg, "--device", "cpu"])
    out = capsys.readouterr().out
    losses = re.findall(r"Iteration \d+:\tloss=(\S+)\tacc=", out)
    assert len(losses) == state.iteration == 4
    assert re.search(r"Epoch : 1 - loss : [0-9.]+ - acc: [0-9.]+ - "
                     r"val_loss : [0-9.]+ - val_acc: [0-9.]+", out)
    assert isinstance(state.model, DistillWrapper)
    run_dir = out.split("output directory: ")[1].split("\n")[0]
    assert sorted(os.listdir(run_dir)) == ["vit_000000", "vit_000002",
                                           "vit_000004"]
    payload = torch.load(os.path.join(run_dir, "vit_000004"),
                         weights_only=True)
    assert set(payload["model"]) == set(state.model.state_dict())
    assert payload["q_format"] == "FP32"

    model, train_loader, _, (micro, n_accum) = train_cli.build_train(
        config, torch.device("cpu"))
    model.load_state_dict(torch.load(os.path.join(run_dir, "vit_000000"),
                                     weights_only=True)["model"])
    step = make_train_step(make_loss_fn(
        model.student, model, train_cli.build_teacher(config, "cpu")),
        n_accum)
    batch = next(train_loader.epoch(0))
    metrics = step(TrainState(model, optim.create_optimizer(
        config["train_config"], model)), {
            k: v.view(n_accum, micro, *v.shape[1:]) for k, v in
            batch.items()}, 1e-3)
    assert abs(float(metrics["loss"]) - float(losses[0])) <= 1e-4

    config["train_config"]["checkpoint_path"] = os.path.join(run_dir,
                                                             "vit_000004")
    eval_cfg = synth["root"] / "deit_eval.json"
    eval_cfg.write_text(json.dumps(config))
    gts, preds, logits = eval_cli.main(["-c", str(eval_cfg), "--device",
                                        "cpu"])
    assert len(gts) == logits.shape[0] > 0
    student = {k[len("student."):]: v for k, v in payload["model"].items()
               if k.startswith("student.")}
    vit = ViT(**train_cli.vit_kwargs_from_config(config, {
        "number_of_classes": 10}))
    vit.load_state_dict(student, strict=True)
    exported = str(synth["root"] / "deit_student.pth")
    export_checkpoint.main(["-c", str(eval_cfg), "--output", exported,
                            "--device", "cpu"])
    assert set(torch.load(exported, weights_only=True)) == set(
        vit.state_dict())


def test_deit_checkpoint_clis_match_jax(synth, tmp_path, monkeypatch):
    """A JAX DistillWrapper checkpoint and the port checkpoint of the same
    weights: the JAX export CLI and the port's write the same student,
    bit for bit, with and without the training envelope; the JAX eval CLI
    and the port's print the same report from the same predictions."""
    wrapper = jax_wrapper(num_classes=10)
    params = jax_params(wrapper, seed=5)
    tx = jax_optim.create_optimizer(TRAIN_CONFIG)
    jstate = init_train_state(
        wrapper, tx, jax.random.PRNGKey(0), jnp.zeros((1, 80, 80, 3)),
        labels=jnp.zeros((1,), jnp.int32),
        teacher_logits=jnp.zeros((1, 10), jnp.float32))
    jstate = jstate.replace(params=params,
                            iteration=jnp.asarray(6, jnp.int32))
    jax_save_checkpoint(jstate, str(tmp_path / "jax_ckpt"))
    model = port_wrapper(params, num_classes=10)
    save_checkpoint(TrainState(model, optim.create_optimizer(
        TRAIN_CONFIG, model), 6), str(tmp_path / "port_ckpt"))
    assert set(load_reference_checkpoint(str(tmp_path / "port_ckpt"))) == \
        set(model.student.state_dict())

    configs = {}
    for name in ("jax", "port"):
        _, config = deit_config(synth, f"ckpt_{name}", checkpoint_path=str(
            tmp_path / f"{name}_ckpt"), local_batch_size=4)
        config["vit_config"]["compute_dtype"] = "float32"
        configs[name] = config
    jax_export = load_script_module(
        os.path.join(REPO, "classification", "export_checkpoint.py"),
        "export_checkpoint_for_deit")
    for wrap in (False, True):
        outs = {n: str(tmp_path / f"{n}_{wrap}.pth") for n in configs}
        jax_export.export(json.loads(json.dumps(configs["jax"])),
                          outs["jax"], wrap)
        export_checkpoint.export(configs["port"], outs["port"], wrap)
        ours, ref = (torch.load(outs[n], weights_only=True)
                     for n in ("port", "jax"))
        if wrap:
            assert ours["iteration"] == ref["iteration"] == 6
            ours, ref = ours["model"], ref["model"]
        assert set(ours) == set(ref)
        for name, t in ref.items():
            assert torch.equal(ours[name], t), name

    cache_dir = jax.config.jax_compilation_cache_dir
    try:
        jax_test = load_script_module(
            os.path.join(REPO, "classification", "test.py"),
            "test_for_deit")
    finally:
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    captured = {}
    evaluate = jax_test.evaluate_dataset

    def capture(*args):
        captured["gts"], captured["preds"] = evaluate(*args)
        return captured["gts"], captured["preds"]

    monkeypatch.setattr(jax_test, "evaluate_dataset", capture)
    reports = {}
    for name in ("jax", "port"):
        printed = io.StringIO()
        with redirect_stdout(printed):
            if name == "jax":
                jax_test.test_deit(configs["jax"])
            else:
                gts, preds, _ = eval_cli.run_eval(configs["port"],
                                                  torch.device("cpu"))
        reports[name] = printed.getvalue()
    np.testing.assert_array_equal(gts, captured["gts"])
    np.testing.assert_array_equal(preds, captured["preds"])
    assert reports["port"] == reports["jax"]


def test_quantized_deit_config_raises_a8b(synth, tmp_path):
    """A deit config in PyTorchINT8 and in FP16_16 through the port's
    CLIs: the train CLI distils the student (INT8: the one-pass step) for
    4 steps of 2 x 8 with finite losses, and an INT8 checkpoint carries
    the student's observers, the token's two among them with statistics;
    the eval CLI reads the student as a plain ViT (INT8: the simulation's
    eval forward); and the export CLI writes what the JAX export CLI
    writes from the JAX checkpoint of the same weights and observers, bit
    for bit."""
    for q_format in ("PyTorchINT8", "FP16_16"):
        cfg, config = deit_config(synth, f"deit_{q_format}",
                                  q_format=q_format)
        out = io.StringIO()
        with redirect_stdout(out):
            state = train_cli.main(["-c", cfg, "--device", "cpu"])
        losses = [float(v) for v in re.findall(
            r"Iteration \d+:\tloss=(\S+)\tacc=", out.getvalue())]
        assert len(losses) == state.iteration == 4
        assert all(np.isfinite(losses)), (q_format, losses)
        run_dir = out.getvalue().split("output directory: ")[1].split(
            "\n")[0]
        payload = torch.load(os.path.join(run_dir, "vit_000004"),
                             weights_only=True)
        assert payload["q_format"] == q_format
        sd = payload["model"]
        for site in ("quant_distill_token", "distill_token_cat"):
            assert (float(sd[f"student.{site}.min"]) <= float(
                sd[f"student.{site}.max"])) if q_format == "PyTorchINT8" \
                else f"student.{site}.min" not in sd, site
        config["train_config"]["checkpoint_path"] = os.path.join(
            run_dir, "vit_000004")
        with redirect_stdout(io.StringIO()):
            gts, _, logits = eval_cli.run_eval(config, torch.device("cpu"))
        assert logits.shape == (len(gts), 10) and bool(
            torch.isfinite(logits).all())

    config = json.loads(json.dumps(config))
    config["vit_config"]["q_format"] = "PyTorchINT8"
    wrapper = jax_wrapper(num_classes=10, q_format="PyTorchINT8")
    params, quant = jax_params(wrapper, seed=9, with_quant=True)
    quant = jax.tree_util.tree_map(lambda v: np.float32(
        -1.5 if np.isposinf(v) else 2.5), quant)
    jstate = init_train_state(
        wrapper, jax_optim.create_optimizer(TRAIN_CONFIG),
        jax.random.PRNGKey(0), jnp.zeros((1, 80, 80, 3)),
        labels=jnp.zeros((1,), jnp.int32),
        teacher_logits=jnp.zeros((1, 10), jnp.float32))
    jax_save_checkpoint(jstate.replace(
        params=params, quant=quant, iteration=jnp.asarray(4, jnp.int32)),
        str(tmp_path / "jax_ckpt"))
    model = port_wrapper(params, num_classes=10, q_format="PyTorchINT8",
                         quant=quant)
    save_checkpoint(TrainState(model, optim.create_optimizer(
        TRAIN_CONFIG, model), 4), str(tmp_path / "port_ckpt"))
    jax_export = load_script_module(
        os.path.join(REPO, "classification", "export_checkpoint.py"),
        "export_checkpoint_for_int8_deit")
    outs = {}
    for name, export in (("jax", jax_export.export),
                         ("port", export_checkpoint.export)):
        config["train_config"]["checkpoint_path"] = str(tmp_path /
                                                        f"{name}_ckpt")
        outs[name] = str(tmp_path / f"{name}.pth")
        export(json.loads(json.dumps(config)), outs[name])
    ours, ref = (torch.load(outs[n], weights_only=True)
                 for n in ("port", "jax"))
    assert set(ours) == set(ref) and not any(
        n.endswith((".min", ".max")) for n in ours)
    for name, t in ref.items():
        assert torch.equal(ours[name], t), name
