"""The port's checkpoint CLIs against the JAX package's on the CPU:
``export_checkpoint`` on a port checkpoint writes what the JAX
``classification/export_checkpoint.py`` writes from the JAX checkpoint of
the same weights (the same names, the same bits, the envelope with
``--wrap_train_ckpt``) for the three decoders, FP32, FP16_32 (the
QAT-prepared ``.1`` names) and PyTorchINT8 (no observers);
``import_checkpoint`` on a reference ``.pth`` gives a port checkpoint whose
eval logits are those of the JAX import of the same file; export then
import gives back every parameter bit for bit; and the refusals.

Widths: dim 64, depth 2, 2 heads of 32, MLP 128, 80 px, 5 classes (5 det
tokens), weights from a JAX init moved by np.random.RandomState noise.
The JAX export CLI builds a model it only reads the parameter shapes of,
so the export cases take its discrete Block (``fuses_at`` patched false
in the JAX package): the same parameters, without the fused kernels'
interpret mode at init."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import myrtle_vision_tpu.models.vit as jax_vit
from myrtle_vision_tpu.training import optim as jax_optim
from myrtle_vision_tpu.training.trainer import init_train_state
from myrtle_vision_tpu.utils.checkpoint import (
    load_checkpoint as jax_load_checkpoint,
    save_checkpoint as jax_save_checkpoint,
)
from myrtle_vision_tpu.utils.export import (
    save_torch_checkpoint as jax_save_torch_checkpoint,
)
from myrtle_vision_tpu_torch.classification import export_checkpoint
from myrtle_vision_tpu_torch.classification import import_checkpoint
from myrtle_vision_tpu_torch.models.distill import DistillWrapper
from myrtle_vision_tpu_torch.models.vit import ViT, vit_kwargs_from_config
from myrtle_vision_tpu_torch.quantize import QSPECS, QFormat, is_observer
from myrtle_vision_tpu_torch.training import optim
from myrtle_vision_tpu_torch.training.trainer import TrainState
from myrtle_vision_tpu_torch.utils.checkpoint import save_checkpoint
from myrtle_vision_tpu_torch.utils.convert import (
    load_reference_checkpoint,
    state_dict_from_jax,
)

from conftest import load_script_module

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, ITERATION = 80, 7
TRAIN_CONFIG = dict(optimizer="adamw", opt_eps=1e-8, opt_betas=None,
                    weight_decay=0.05, momentum=0.9, lr=1e-3, clip_grad=None,
                    seed=0, checkpoint_path="", local_batch_size=2,
                    drop_last_batch=False)
CASES = [("classification", "FP32"), ("classification", "FP16_32"),
         ("segmentation", "FP32"), ("segmentation", "FP16_32"),
         ("segmentation", "PyTorchINT8"), ("detection", "FP32")]


def cli_module(name):
    return load_script_module(
        os.path.join(REPO, "classification", f"{name}.py"),
        f"{name}_for_port")


def write_config(root, decoder, q_format, checkpoint_path=""):
    data_config = root / "data_config.json"
    data_config.write_text(json.dumps({"number_of_classes": 5}))
    config = {
        "train_config": dict(TRAIN_CONFIG, checkpoint_path=checkpoint_path),
        "data_config_path": str(data_config),
        "vit_config": {
            "decoder": decoder, "image_size": SIZE, "patch_size": 16,
            "embed_dim": 64, "depth": 2, "heads": 2, "mlp_dim": 128,
            "dropout": 0.0, "emb_dropout": 0.0, "q_format": q_format,
            "num_det_tokens": 5, "compute_dtype": "float32",
        },
    }
    path = root / f"{decoder}_{q_format}.json"
    path.write_text(json.dumps(config))
    return config, str(path)


def jax_state(config):
    kw = jax_vit.vit_kwargs_from_config(config, {"number_of_classes": 5})
    model = jax_vit.ViT(**kw)
    state = init_train_state(model, jax_optim.create_optimizer(
        config["train_config"]), jax.random.PRNGKey(0),
        jnp.zeros((1, SIZE, SIZE, 3)))
    return model, state


@pytest.fixture(scope="module", params=CASES, ids=["-".join(c)
                                                    for c in CASES])
def checkpoints(request, tmp_path_factory):
    """One model's weights, moved off the JAX init, as a JAX checkpoint
    and as a port checkpoint, both at iteration 7; the config of each."""
    decoder, q_format = request.param
    root = tmp_path_factory.mktemp(f"ckpt_{decoder}_{q_format}")
    config, _ = write_config(root, decoder, q_format)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_vit, "fuses_at", lambda *_: False)
        _, state = jax_state(config)
    rng = np.random.RandomState(len(decoder) + len(q_format))
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p, np.float32)
        + (0.05 * rng.randn(*p.shape)).astype(np.float32), state.params)
    quant = jax.tree_util.tree_map(np.asarray, state.quant)
    if quant:  # observers with statistics, as after calibration
        quant = jax.tree_util.tree_map(
            lambda v: np.float32(-1.5 if np.isposinf(v) else 2.5), quant)
    state = state.replace(params=params, quant=quant,
                          iteration=jnp.asarray(ITERATION, jnp.int32))
    jax_save_checkpoint(state, str(root / "jax_ckpt"))
    model = ViT(**vit_kwargs_from_config(config, {"number_of_classes": 5}))
    model.load_state_dict(state_dict_from_jax(
        params, decoder, quant if q_format == "PyTorchINT8" else None),
        strict=True)
    save_checkpoint(TrainState(model, optim.create_optimizer(
        config["train_config"], model), ITERATION), str(root / "port_ckpt"))
    configs = {}
    for name in ("jax", "port"):
        os.makedirs(root / name)
        configs[name] = write_config(root / name, decoder, q_format,
                                     str(root / f"{name}_ckpt"))[1]
    return dict(root=root, decoder=decoder, q_format=q_format,
                configs=configs, model=model)


@pytest.mark.parametrize("wrap", [False, True], ids=["plain", "wrapped"])
def test_export_matches_jax_export(checkpoints, wrap, monkeypatch):
    """The same key set and bit-equal fp32 arrays (``.1`` names in a
    float format, no observers in INT8), and with ``--wrap_train_ckpt``
    the same {"model", "iteration"} envelope."""
    root = checkpoints["root"]
    monkeypatch.setattr(jax_vit, "fuses_at", lambda *_: False)
    jax_cli = cli_module("export_checkpoint")
    outs = {}
    for name in ("jax", "port"):
        with open(checkpoints["configs"][name]) as f:
            config = json.load(f)
        outs[name] = str(root / f"{name}_{wrap}.pth")
        if name == "jax":
            jax_cli.export(config, outs[name], wrap)
        else:
            export_checkpoint.main(["-c", checkpoints["configs"][name],
                                    "--output", outs[name], "--device",
                                    "cpu"] + (["--wrap_train_ckpt"] if wrap
                                              else []))
    ours, ref = (torch.load(outs[n], weights_only=True)
                 for n in ("port", "jax"))
    if wrap:
        assert set(ours) == set(ref) == {"model", "iteration"}
        assert ours["iteration"] == ref["iteration"] == ITERATION
        ours, ref = ours["model"], ref["model"]
    assert set(ours) == set(ref)
    float_format = QFormat[checkpoints["q_format"]] in QSPECS
    assert ("decoder.linear.1.weight" in ours) == (
        float_format and checkpoints["decoder"] != "detection")
    assert not any(is_observer(n) for n in ours)
    for name, t in ref.items():
        assert ours[name].dtype == t.dtype == torch.float32, name
        assert torch.equal(ours[name], t), name


def test_export_then_import_round_trips(checkpoints):
    """A port checkpoint through the export and the import CLI: every
    parameter bit for bit, the iteration carried by the envelope, the
    format recorded; INT8 observers, which the reference format does
    not carry, come back fresh."""
    root = checkpoints["root"]
    cfg = checkpoints["configs"]["port"]
    pth, back = str(root / "round.pth"), str(root / "round_back")
    export_checkpoint.main(["-c", cfg, "--output", pth, "--wrap_train_ckpt",
                            "--device", "cpu"])
    model = import_checkpoint.main(["-c", cfg, "--torch_ckpt", pth,
                                    "--output", back, "--device", "cpu"])
    payload = torch.load(back, weights_only=True)
    assert payload["iteration"] == ITERATION
    assert payload["q_format"] == checkpoints["q_format"]
    original = checkpoints["model"].state_dict()
    assert set(payload["model"]) == set(original)
    for name, t in original.items():
        got = payload["model"][name]
        if is_observer(name):
            assert float(got) == (float("inf") if name.endswith(".min")
                                  else float("-inf")), name
        else:
            assert torch.equal(got, t), name
    assert isinstance(model, ViT)


IMPORT_CASES = [("classification", "FP32", "state dict"),
                ("segmentation", "FP32", "envelope"),
                ("segmentation", "FP16_32", "QAT-prepared names")]


@pytest.mark.parametrize("decoder,q_format,layout", IMPORT_CASES)
def test_import_gives_the_jax_import_logits(decoder, q_format, layout,
                                            tmp_path):
    """A reference ``.pth`` (written by the JAX package's
    ``save_torch_checkpoint``, with a quantizer buffer the reference adds
    and both importers ignore) through both import CLIs, then each
    package's eval forward on the same images: fp32 logits within 1e-4
    (a float format's within 1e-4 plus one step of the format at the
    largest logit, as tests/test_torch_float_qat.py holds them)."""
    config, cfg = write_config(tmp_path, decoder, q_format)
    jmodel, state = jax_state(config)
    rng = np.random.RandomState(9)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p, np.float32)
        + (0.05 * rng.randn(*p.shape)).astype(np.float32), state.params)
    pth = str(tmp_path / "reference.pth")
    jax_save_torch_checkpoint(params, decoder, pth,
                              qat_wrapped=layout == "QAT-prepared names")
    sd = torch.load(pth, weights_only=True)
    sd["decoder.norm.activation_post_process.scale"] = torch.ones(1)
    torch.save({"model": sd, "iteration": 3} if layout == "envelope"
               else sd, pth)

    cli_module("import_checkpoint").main(config, pth,
                                         str(tmp_path / "jax_imported"))
    jstate, iteration = jax_load_checkpoint(state,
                                            str(tmp_path / "jax_imported"))
    port_out = str(tmp_path / "port_imported")
    import_checkpoint.main(["-c", cfg, "--torch_ckpt", pth, "--output",
                            port_out, "--device", "cpu"])
    assert torch.load(port_out, weights_only=True)["iteration"] == \
        int(iteration) == (3 if layout == "envelope" else 0)

    images = rng.uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    ref = np.asarray(jmodel.apply({"params": jstate.params},
                                  jnp.asarray(images)))
    model = ViT(**vit_kwargs_from_config(config, {"number_of_classes": 5}))
    model.load_state_dict(load_reference_checkpoint(port_out), strict=True)
    with torch.inference_mode():
        out = model.eval()(torch.from_numpy(images)).numpy()
    bar = 1e-4
    if q_format != "FP32":
        mantissa = QSPECS[QFormat[q_format]][1]
        bar += 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - mantissa)
    d = np.abs(out - ref).max()
    print(f"{decoder} {q_format} {layout}: logits max abs {d:.3g} "
          f"(bar {bar:.3g})")
    assert out.shape == ref.shape and d <= bar


def test_refusals(tmp_path, monkeypatch):
    """Export of a distillation config in a quantized format (FP16_32:
    the ``.1`` names) writes what the JAX CLI writes from the JAX
    DistillWrapper checkpoint of the same weights, its student bit for
    bit; an import that finds under half of the parameters raises;
    without a card both CLIs raise."""
    config, _ = write_config(tmp_path, "classification", "FP16_32")
    config["distiller_config"] = {"temperature": 1.0, "alpha": 0.5}
    with monkeypatch.context() as mp:
        mp.setattr(jax_vit, "fuses_at", lambda *_: False)
        _, state = jax_state(config)
    rng = np.random.RandomState(3)
    student = jax.tree_util.tree_map(
        lambda p: np.asarray(p, np.float32)
        + (0.05 * rng.randn(*p.shape)).astype(np.float32), state.params)
    tree = {"student": student,
            "distillation_token": rng.randn(1, 1, 64).astype(np.float32),
            "distill_mlp_norm": {"scale": np.ones(64, np.float32),
                                 "bias": np.zeros(64, np.float32)},
            "distill_mlp_linear": {
                "kernel": rng.randn(64, 5).astype(np.float32),
                "bias": np.zeros(5, np.float32)}}
    with open(tmp_path / "jax_deit", "wb") as f:
        f.write(serialization.msgpack_serialize({
            "model": tree, "optimizer": None, "quant": {},
            "lr_scheduler": {}, "iteration": ITERATION}))
    wrapper = DistillWrapper(ViT(**vit_kwargs_from_config(
        config, {"number_of_classes": 5})))
    wrapper.load_state_dict(state_dict_from_jax(tree), strict=True)
    save_checkpoint(TrainState(wrapper, optim.create_optimizer(
        config["train_config"], wrapper), ITERATION),
        str(tmp_path / "port_deit"))
    outs = {}
    for name, cli in (("jax", cli_module("export_checkpoint")),
                      ("port", export_checkpoint)):
        config["train_config"]["checkpoint_path"] = str(tmp_path /
                                                        f"{name}_deit")
        outs[name] = str(tmp_path / f"{name}_deit.pth")
        cli.export(json.loads(json.dumps(config)), outs[name])
    ours, ref = (torch.load(outs[n], weights_only=True)
                 for n in ("port", "jax"))
    assert set(ours) == set(ref) and "decoder.linear.1.weight" in ref
    for name, t in ref.items():
        assert torch.equal(ours[name], t), name
    config, cfg = write_config(tmp_path, "segmentation", "FP32")
    torch.save({"linear.weight": torch.zeros(5, 64)},
               str(tmp_path / "odd.pth"))
    with pytest.raises(ValueError, match="unrecognized checkpoint layout"):
        import_checkpoint.main(["-c", cfg, "--torch_ckpt",
                                str(tmp_path / "odd.pth"), "--output",
                                str(tmp_path / "odd"), "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_checkpoint.main(["-c", cfg, "--output",
                                str(tmp_path / "y.pth")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        import_checkpoint.main(["-c", cfg, "--torch_ckpt",
                                str(tmp_path / "odd.pth"), "--output",
                                str(tmp_path / "z")])
