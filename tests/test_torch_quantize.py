"""The port's PyTorchINT8 quantization against the JAX package on the CPU:
the fake-quant primitives bit for bit, the calibrating forward's
observers, convert, the converted ViT after a ``strict=True`` load, the
converted checkpoint, and the PTQ CLI's predictions.

Model as tests/test_convert.py: 80 px, patch 16, dim 64, depth 2, 2
heads, MLP 128, dim_head 32; inputs from np.random.RandomState.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from myrtle_vision_tpu.models.vit import ViT as JaxViT
from myrtle_vision_tpu.ops import fake_quant as jfq
from myrtle_vision_tpu.quantize import QFormat as JaxQFormat
from myrtle_vision_tpu.quantize import convert_params as jax_convert
from myrtle_vision_tpu.utils.export import save_torch_checkpoint
from myrtle_vision_tpu_torch.classification import test_quantize as cli
from myrtle_vision_tpu_torch.models.vit import ViT
from myrtle_vision_tpu_torch.ops import fake_quant as fq
from myrtle_vision_tpu_torch.quantize import (
    ActQuant,
    QFormat,
    convert_params,
    is_observer,
)
from myrtle_vision_tpu_torch.utils.checkpoint import save_model
from myrtle_vision_tpu_torch.utils.convert import (
    load_reference_checkpoint,
    quant_site_names,
    state_dict_from_jax,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(decoder="classification", image_size=80, patch_size=16,
          num_classes=4, dim=64, depth=2, heads=2, mlp_dim=128, dim_head=32)


def bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


# ------------------------------------------------------------ fake quant

def _inputs(seed):
    """Random values at several scales, and edge values: fp16 subnormals
    and the smallest normal fp32 values, halfway ties of the fp16 and TF32
    mantissas and of the fixed-point quanta, saturation, signed zeros.
    (fp32 subnormal inputs are left out: XLA on the CPU flushes them to
    zero, PyTorch keeps them.)"""
    rng = np.random.RandomState(seed)
    rand = np.concatenate([rng.randn(4000) * 10.0 ** e for e in (-6, -2, 0,
                                                                 2, 5)])
    ties = np.concatenate([
        (np.arange(-40, 40) + 0.5) * 2.0 ** -10,   # e5m10 at [1, 2)
        (np.arange(-40, 40) + 0.5) * 2.0 ** -24,   # fp16 subnormal quanta
        (np.arange(-40, 40) + 0.5) * 2.0 ** -9,    # fixed (11, 9) quanta
        (np.arange(-40, 40) + 0.5) * 2.0 ** -7,    # fixed (11, 7)
        1.0 + (np.arange(0, 64) + 0.5) * 2.0 ** -10,
    ])
    edge = np.array([0.0, -0.0, 65504.0, 65520.0, -65520.0, 1e6, -1e6,
                     3.4e38, -3.4e38, 1.1754944e-38, -1.1754944e-38, 6e-8,
                     5.9e-8,
                     2.0 ** -14, 2.0 ** -15, 2.0 ** -25, 3.0 * 2.0 ** -26,
                     3.99609375, 4.0, -4.0, 4.1, -4.1])
    return np.concatenate([rand, ties, edge]).astype(np.float32)


@pytest.mark.parametrize("exp_bits,man_bits", [(5, 10), (8, 10), (4, 3)])
def test_float_quantize_bit_identical(exp_bits, man_bits):
    x = _inputs(exp_bits)
    ref = jfq.float_quantize(jnp.asarray(x), exp_bits, man_bits)
    got = fq.float_quantize(torch.from_numpy(x), exp_bits, man_bits)
    np.testing.assert_array_equal(bits(got), bits(ref))


@pytest.mark.parametrize("fl", [7, 8, 9])
def test_fixed_point_quantize_bit_identical(fl):
    x = _inputs(fl)
    ref = jfq.fixed_point_quantize(jnp.asarray(x), 11, fl)
    got = fq.fixed_point_quantize(torch.from_numpy(x), 11, fl)
    np.testing.assert_array_equal(bits(got), bits(ref))


@pytest.mark.parametrize("lo,hi", [(-3.7, 5.1), (0.25, 9.0), (-1e-3, 2e-3),
                                   (-2.0, -0.5)])
def test_int8_affine_fake_quant_bit_identical(lo, hi):
    from myrtle_vision_tpu.quantize import affine_uint8_qparams as jax_qp
    from myrtle_vision_tpu_torch.quantize import affine_uint8_qparams

    scale, zp = affine_uint8_qparams(torch.tensor(np.float32(lo)),
                                     torch.tensor(np.float32(hi)))
    jscale, jzp = jax_qp(jnp.float32(lo), jnp.float32(hi))
    np.testing.assert_array_equal(bits([scale, zp]), bits([jscale, jzp]))
    # values past both ends (saturation) and exact ties of the grid
    x = np.concatenate([
        np.random.RandomState(1).uniform(lo * 1.5 - 1, hi * 1.5 + 1, 3000),
        (np.arange(-300, 300) + 0.5) * float(scale) - float(zp) * float(
            scale)]).astype(np.float32)
    ref = jfq.int8_affine_fake_quant(jnp.asarray(x), jscale, jzp)
    got = fq.int8_affine_fake_quant(torch.from_numpy(x), scale, zp)
    np.testing.assert_array_equal(bits(got), bits(ref))


@pytest.mark.parametrize("max_abs", [0.05, 1.0, 7.3])
def test_int8_symmetric_fake_quant_bit_identical(max_abs):
    from myrtle_vision_tpu.quantize import symmetric_int8_scale as jax_scale
    from myrtle_vision_tpu_torch.quantize import symmetric_int8_scale

    scale = symmetric_int8_scale(torch.tensor(np.float32(max_abs)))
    jscale = jax_scale(jnp.float32(max_abs))
    np.testing.assert_array_equal(bits(scale), bits(jscale))
    x = np.concatenate([
        np.random.RandomState(2).uniform(-1.2 * max_abs, 1.2 * max_abs, 3000),
        (np.arange(-130, 130) + 0.5) * float(scale)]).astype(np.float32)
    ref = jfq.int8_symmetric_fake_quant(jnp.asarray(x), jscale)
    got = fq.int8_symmetric_fake_quant(torch.from_numpy(x), scale)
    np.testing.assert_array_equal(bits(got), bits(ref))


def test_ste_gradients_pass_through():
    x = torch.linspace(-3, 3, 41, requires_grad=True)
    scale = torch.tensor(0.05, requires_grad=True)
    g = torch.arange(41.0)
    fq.int8_affine_fake_quant_ste(x, scale, torch.tensor(7.0)).backward(g)
    assert torch.equal(x.grad, g) and scale.grad is None
    x.grad = None
    fq.int8_symmetric_fake_quant_ste(x, scale).backward(g)
    assert torch.equal(x.grad, g) and scale.grad is None


def test_site_without_statistics_passes_through():
    site = ActQuant()
    x = torch.from_numpy(_inputs(3)[:500].copy())
    assert torch.equal(site(x), x)
    assert not bool(site.int8_qparams()[2])
    y = site(x, calibrating=True)
    assert float(site.min) == float(x.min()) and bool(site.int8_qparams()[2])
    assert not torch.equal(y, x)


# --------------------------------------------------------------- the model

@pytest.fixture(scope="module")
def jax_int8():
    """The JAX INT8 model's fp32 params, its quant collection after one
    calibrating batch and the calibrating output, the converted params,
    and the converted model's logits (K9/K10 in interpret mode)."""
    model = JaxViT(q_format=JaxQFormat.PyTorchINT8, dtype=jnp.float32, **KW)
    img = np.random.RandomState(0).randn(2, 80, 80, 3).astype(np.float32)
    variables = model.init(jax.random.PRNGKey(1), jnp.asarray(img))
    out_cal, upd = model.apply(variables, jnp.asarray(img), calibrating=True,
                               mutable=["quant"])
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    quant = jax.tree_util.tree_map(np.asarray, upd["quant"])
    fresh = jax.tree_util.tree_map(np.asarray, variables["quant"])
    converted = jax.tree_util.tree_map(
        np.asarray, jax_convert(variables["params"], JaxQFormat.PyTorchINT8))
    model_c = JaxViT(q_format=JaxQFormat.PyTorchINT8, converted=True,
                     dtype=jnp.float32, **KW)
    logits = model_c.apply({"params": converted, "quant": quant},
                           jnp.asarray(img))
    fresh_logits = model_c.apply({"params": converted, "quant": fresh},
                                 jnp.asarray(img))
    return dict(img=img, params=params, quant=quant, fresh=fresh,
                out_cal=np.asarray(out_cal), converted=converted,
                logits=np.asarray(logits),
                fresh_logits=np.asarray(fresh_logits))


def _calibrated_port(jax_int8):
    model = ViT(q_format="PyTorchINT8", **KW)
    model.load_ptq_state_dict(state_dict_from_jax(jax_int8["params"]))
    with torch.no_grad():
        out = model(torch.from_numpy(jax_int8["img"]), calibrating=True)
    return model, out


def test_calibration_observers_match_jax(jax_int8):
    model, out = _calibrated_port(jax_int8)
    sd = model.state_dict()
    names = quant_site_names(KW["depth"])
    assert len(names) == 29 and sum(is_observer(n) for n in sd) == 58
    for path, name in names:
        site = jax_int8["quant"]
        for p in path:
            site = site[p]
        for key in ("min", "max"):
            np.testing.assert_allclose(sd[f"{name}.{key}"].numpy(),
                                       site[key], rtol=1e-5, err_msg=name)
    np.testing.assert_allclose(out.numpy(), jax_int8["out_cal"], rtol=1e-4,
                               atol=1e-4)


def test_convert_matches_jax(jax_int8):
    model, _ = _calibrated_port(jax_int8)
    ours = convert_params(model.state_dict(), QFormat.PyTorchINT8)
    theirs = state_dict_from_jax(jax_int8["converted"],
                                 quant=jax_int8["quant"])
    assert set(ours) == set(theirs)
    for name, t in theirs.items():
        if is_observer(name):
            continue
        assert ours[name].dtype == t.dtype, name
        if t.dtype == torch.int8 or name.endswith("weight_scale"):
            assert torch.equal(ours[name], t), name


def test_converted_vit_matches_jax(jax_int8):
    sd = state_dict_from_jax(jax_int8["converted"], quant=jax_int8["quant"])
    model = ViT(q_format="PyTorchINT8", converted=True, **KW)
    model.load_state_dict(sd, strict=True)
    img = torch.from_numpy(jax_int8["img"])
    with torch.no_grad():
        got = model(img)
        assert torch.equal(got, model(img, plain=True))
    np.testing.assert_allclose(got.numpy(), jax_int8["logits"], rtol=1e-4,
                               atol=1e-4)
    linears = [n for n in sd if n.endswith("weight_scale")]
    assert len(linears) == 2 + 4 * KW["depth"]
    for name in linears:
        assert sd[name[:-len("_scale")]].dtype == torch.int8


def test_uncalibrated_converted_vit_is_finite(jax_int8):
    sd = state_dict_from_jax(jax_int8["converted"], quant=jax_int8["fresh"])
    model = ViT(q_format="PyTorchINT8", converted=True, **KW)
    model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = model(torch.from_numpy(jax_int8["img"]))
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), jax_int8["fresh_logits"],
                               rtol=1e-4, atol=1e-4)


def test_converted_checkpoint_is_int8_and_small(jax_int8, tmp_path):
    model, _ = _calibrated_port(jax_int8)
    fp32_path, int8_path = tmp_path / "fp32.pth", tmp_path / "int8.pth"
    save_model(model, fp32_path)
    converted = ViT(q_format="PyTorchINT8", converted=True, **KW)
    converted.load_state_dict(convert_params(model.state_dict(),
                                             "PyTorchINT8"), strict=True)
    save_model(converted, int8_path)
    assert os.path.getsize(int8_path) < 0.45 * os.path.getsize(fp32_path)
    loaded = load_reference_checkpoint(str(int8_path))
    assert loaded["decoder.linear.weight"].dtype == torch.int8
    again = ViT(q_format="PyTorchINT8", converted=True, **KW)
    again.load_state_dict(loaded, strict=True)
    img = torch.from_numpy(jax_int8["img"])
    with torch.no_grad():
        assert torch.equal(again(img), converted(img))


def test_loads_refuse_the_other_storage(jax_int8):
    fp32 = state_dict_from_jax(jax_int8["params"], quant=jax_int8["quant"])
    with pytest.raises(TypeError, match="converted checkpoint"):
        ViT(q_format="PyTorchINT8", converted=True, **KW).load_state_dict(
            fp32)
    int8 = state_dict_from_jax(jax_int8["converted"], quant=jax_int8["quant"])
    with pytest.raises(TypeError, match="converted checkpoint"):
        ViT(q_format="PyTorchINT8", **KW).load_state_dict(int8, strict=False)
    with pytest.raises(RuntimeError, match="Missing key"):
        ViT(q_format="PyTorchINT8", **KW).load_state_dict(
            state_dict_from_jax(jax_int8["params"]))


@pytest.mark.parametrize("q_format", ["FP16_16", "FP16_32", "TF32"])
def test_float_formats_raise_with_the_roadmap_item(q_format, monkeypatch,
                                                   jax_int8):
    """What the quantized formats still refuse: a converted PyTorchINT8
    model past the fused gate (the discrete converted Block, A5b), and a
    converted INT8 detector (no JAX CLI builds one).  A PyTorchINT8
    detector before convert builds now, and the float formats build a
    detector; a sequence past the fused gate runs the discrete float
    Block, recording gradients or not (tests/test_torch_float_detection.py
    holds both against JAX)."""
    assert ViT(**dict(KW, decoder="detection"),
               q_format="PyTorchINT8").int8
    with pytest.raises(NotImplementedError, match="converted PyTorchINT8"):
        ViT(**dict(KW, decoder="detection"), q_format="PyTorchINT8",
            converted=True)
    assert ViT(**dict(KW, decoder="detection"), q_format=q_format).q_format \
        == QFormat[q_format]
    model = ViT(q_format=q_format, **KW)
    img = torch.zeros(1, 80, 80, 3)
    fused = model(img)
    assert fused.grad_fn is not None
    converted = ViT(q_format="PyTorchINT8", converted=True, **KW)
    converted.load_state_dict(state_dict_from_jax(
        jax_int8["converted"], quant=jax_int8["quant"]), strict=True)
    monkeypatch.setattr("myrtle_vision_tpu_torch.models.vit.fuses_at",
                        lambda n, heads, d: False)
    with pytest.raises(NotImplementedError, match="A5b"), torch.no_grad():
        converted(img)
    assert model(img).grad_fn is not None
    with torch.no_grad():
        torch.testing.assert_close(model(img), fused.detach(), rtol=0,
                                   atol=1e-5)


# ------------------------------------------------------------------- CLI

@pytest.fixture(scope="module")
def cli_setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_quantize_cli")
    data = root / "data"
    subprocess.run(
        [sys.executable, os.path.join(REPO, "classification",
                                      "prepare_synthetic.py"),
         "--out", str(data), "--per_class", "5", "--seed", "5"],
        check=True, capture_output=True,
    )
    with open(os.path.join(REPO, "classification", "data_configs",
                           "data_config_synth.json")) as f:
        data_config = json.load(f)
    data_config["dataset_path"] = str(data)
    with open(root / "data_config.json", "w") as f:
        json.dump(data_config, f)
    vit = dict(KW, num_classes=data_config["number_of_classes"])
    params = JaxViT(**vit).init(jax.random.PRNGKey(6),
                                jnp.zeros((1, 80, 80, 3)))["params"]
    pth, msgpack = root / "model.pth", root / "model.msgpack"
    save_torch_checkpoint(params, "classification", str(pth))
    with open(msgpack, "wb") as f:  # the JAX CLI's checkpoint format
        f.write(serialization.msgpack_serialize({
            "model": jax.tree_util.tree_map(np.asarray, params),
            "optimizer": None, "quant": {}, "lr_scheduler": {},
            "iteration": 0}))
    config = {
        "train_config": {
            "checkpoint_path": str(pth), "local_batch_size": 4,
            "drop_last_batch": False, "optimizer": "adamw", "opt_eps": 1e-8,
            "opt_betas": None, "clip_grad": None, "momentum": 0.9,
            "weight_decay": 0.05, "lr": 1e-3,
        },
        "data_config_path": str(root / "data_config.json"),
        "vit_config": {
            "decoder": "classification", "image_size": 80, "patch_size": 16,
            "embed_dim": 64, "depth": 2, "heads": 2, "mlp_dim": 128,
            "dropout": 0.1, "emb_dropout": 0.0, "q_format": "PyTorchINT8",
        },
    }
    cfg = root / "config.json"
    with open(cfg, "w") as f:
        json.dump(config, f)
    return dict(cfg=str(cfg), config=config, msgpack=str(msgpack), root=root)


def test_cli_predicts_as_the_jax_cli(cli_setup, capsys, tmp_path):
    saved = tmp_path / "converted.pth"
    gts, preds, logits = cli.main(["-c", cli_setup["cfg"], "--device", "cpu",
                                   "--calib_steps", "2",
                                   "--save_converted", str(saved)])
    out = capsys.readouterr().out
    assert "Running 2 calibration steps" in out and "precision" in out
    sizes = [float(line.split(":")[1].split()[0]) for line in out.splitlines()
             if "model size" in line]
    assert len(sizes) == 2 and sizes[1] < 0.45 * sizes[0]
    assert load_reference_checkpoint(str(saved))[
        "transformer.layers.0.0.fn.fn.to_qkv.weight"].dtype == torch.int8

    assert_as_the_jax_cli(cli_setup, cli_setup["config"], "parity", gts,
                          preds, logits)


def assert_as_the_jax_cli(cli_setup, config, name, gts, preds, logits):
    """The JAX classification/test_quantize.py on ``config`` and the msgpack
    checkpoint, its ``evaluate_dataset`` wrapped to capture its
    predictions: the same labels and predictions as the port's CLI."""
    from conftest import load_script_module

    tq = load_script_module(
        os.path.join(REPO, "classification", "test_quantize.py"),
        f"cls_tq_script_torch_{name}")
    seen = {}

    def capture(predict_fn, state, loader):
        seen["gts"], seen["preds"] = evaluate(predict_fn, state, loader)
        return seen["gts"], seen["preds"]

    evaluate = tq.evaluate_dataset
    tq.evaluate_dataset = capture
    config = json.loads(json.dumps(config))
    config["train_config"]["checkpoint_path"] = cli_setup["msgpack"]
    tq.test_deit(config, calib_steps=2, quantized_ckpt=False)
    assert len(preds) == len(seen["preds"]) == 20
    np.testing.assert_array_equal(gts, seen["gts"])
    np.testing.assert_array_equal(preds, seen["preds"])
    assert logits.shape == (20, 10) and torch.isfinite(logits).all()


@pytest.mark.parametrize("q_format", ["FP16_16", "FP16_32", "TF32"])
def test_float_cli_predicts_as_the_jax_cli(cli_setup, capsys, tmp_path,
                                           q_format):
    config = json.loads(json.dumps(cli_setup["config"]))
    config["vit_config"]["q_format"] = q_format
    cfg = tmp_path / f"{q_format}.json"
    cfg.write_text(json.dumps(config))
    saved = tmp_path / "converted.pth"
    gts, preds, logits = cli.main(["-c", str(cfg), "--device", "cpu",
                                   "--calib_steps", "2",
                                   "--save_converted", str(saved)])
    out = capsys.readouterr().out
    assert "Running 2 calibration steps" in out and "precision" in out
    sizes = [float(line.split(":")[1].split()[0]) for line in out.splitlines()
             if "model size" in line]
    weight = load_reference_checkpoint(str(saved))[
        "transformer.layers.0.0.fn.fn.to_qkv.weight"]
    if q_format == "TF32":  # TF32 values keep their 32-bit containers
        assert sizes[1] == sizes[0] and weight.dtype == torch.float32
    else:
        assert sizes[1] < 0.6 * sizes[0] and weight.dtype == torch.float16
    assert_as_the_jax_cli(cli_setup, config, q_format, gts, preds, logits)


def test_cli_cuda_without_a_card_raises(cli_setup, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["-c", cli_setup["cfg"], "--device", "cuda"])


@pytest.mark.parametrize("q_format,decoder,error,match", [
    ("FP16_32", "detection", NotImplementedError, "A5a"),
    ("FP32", "classification", ValueError, "nothing to quantize"),
])
def test_cli_refuses_other_formats(cli_setup, tmp_path, q_format, decoder,
                                   error, match):
    config = json.loads(json.dumps(cli_setup["config"]))
    config["vit_config"]["q_format"] = q_format
    config["vit_config"]["decoder"] = decoder
    cfg = tmp_path / f"{q_format}.json"
    cfg.write_text(json.dumps(config))
    with pytest.raises(error, match=match):
        cli.main(["-c", str(cfg), "--device", "cpu"])
