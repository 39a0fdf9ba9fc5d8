"""Attention capture in the port against the JAX package on the CPU: each
layer's probabilities of ``ViT.forward(img, capture_attention=True)``
against the ``attn_probs`` the JAX model sows, the ``xla`` core with
``return_probs`` against the JAX core, and the port's
``classification/visualize_attention.py`` against the JAX CLI from the
same weights.  Inputs are numpy arrays from a seed, the weights a JAX
init carried by utils/convert.py ``state_dict_from_jax``."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import myrtle_vision_tpu.models.vit as jax_vit
from myrtle_vision_tpu.ops.attention import (
    multi_head_attention as jax_attention,
)
from myrtle_vision_tpu.training import optim as jax_optim
from myrtle_vision_tpu.training.trainer import init_train_state
from myrtle_vision_tpu.utils.checkpoint import (
    save_checkpoint as jax_save_checkpoint,
)
from myrtle_vision_tpu_torch.classification import (
    visualize_attention as port_cli,
)
from myrtle_vision_tpu_torch.models.vit import ViT
from myrtle_vision_tpu_torch.ops.attention import multi_head_attention
from myrtle_vision_tpu_torch.utils.checkpoint import save_model
from myrtle_vision_tpu_torch.utils.convert import state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEPTH, HEADS = 2, 2
KW = dict(decoder="classification", image_size=80, patch_size=16,
          num_classes=5, dim=64, depth=DEPTH, heads=HEADS, mlp_dim=128,
          dim_head=32)
PROB_BAR = 1e-5
# bf16 compute: the two models' layer inputs part where a bf16 rounding
# flips (the patch embedding and the projections sum 64-768 terms in
# another order), which moves a probability by far more than the core's
# own fp32 noise (measured 3.5e-5 in layer 0 and 3.2e-4 in layer 1), so
# the whole models are held to 2^-10 there, and the 1e-5 bar holds the
# capture's core on the port's own q, k and v
BF16_MODEL_BAR = 2.0 ** -10
DTYPES = {"bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float32": (jnp.float32, torch.float32)}


def jax_params(dtype, seed=0):
    model = jax_vit.ViT(**KW, dtype=DTYPES[dtype][0])
    params = model.init(jax.random.PRNGKey(seed),
                        jnp.zeros((1, 80, 80, 3)))["params"]
    return model, jax.tree_util.tree_map(np.asarray, params)


def sown_probs(model, params, img):
    """The JAX model's sown ``attn_probs``, layer by layer in depth
    order, and its logits."""
    out, inter = model.apply({"params": params}, jnp.asarray(img),
                             deterministic=True, capture_attention=True,
                             mutable=["intermediates"])
    layers = inter["intermediates"]["transformer"]
    return [np.asarray(layers[f"layers_{i}"]["attn"]["attn_probs"][0])
            for i in range(DEPTH)], np.asarray(out, np.float32)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_captured_probabilities_match_jax(dtype, monkeypatch):
    """Every layer's (B, H, N, N) probabilities in depth order, the
    logits the capture returns beside them equal to the model's without
    capture in fp32, and in bf16 compute the capture's core on the
    port's own q, k, v equal to the JAX core's."""
    model, params = jax_params(dtype)
    img = np.random.RandomState(1).uniform(-1, 1, (2, 80, 80, 3)).astype(
        np.float32)
    ref, jax_logits = sown_probs(model, params, img)
    port = ViT(**KW, compute_dtype=DTYPES[dtype][1])
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    seen = []
    import myrtle_vision_tpu_torch.models.vit as port_vit

    def recording(q, k, v, scale, **kw):
        seen.append((q, k, v, scale))
        return multi_head_attention(q, k, v, scale, **kw)

    monkeypatch.setattr(port_vit, "multi_head_attention", recording)
    with torch.no_grad():
        logits, probs = port(torch.from_numpy(img), capture_attention=True)
    assert len(probs) == DEPTH == len(seen)
    bar = PROB_BAR if dtype == "float32" else BF16_MODEL_BAR
    for i, (p, r) in enumerate(zip(probs, ref)):
        assert p.dtype == torch.float32 and p.shape == (2, HEADS, 26, 26)
        np.testing.assert_allclose(p.numpy(), r, rtol=0, atol=bar,
                                   err_msg=f"layer {i}")
        q, k, v, scale = seen[i]
        _, core = jax_attention(*(jnp.asarray(t.float().numpy()).astype(
            DTYPES[dtype][0]) for t in (q, k, v)), scale, impl="xla",
            return_probs=True)
        np.testing.assert_allclose(p.numpy(), np.asarray(core), rtol=0,
                                   atol=PROB_BAR, err_msg=f"core {i}")
    if dtype == "float32":
        np.testing.assert_allclose(logits.numpy(), jax_logits, rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_xla_core_with_probabilities_matches_jax(dtype):
    """``multi_head_attention(..., return_probs=True)`` (the ``xla``
    core: fp32 scores, an fp32 softmax, bf16 probabilities into P V for
    bf16 operands, 3-pass products for fp32 ones) against the JAX core on
    the same inputs: probabilities 1e-5, outputs in their dtype."""
    rng = np.random.RandomState(2)
    q, k, v = (rng.randn(2, 3, 29, 32).astype(np.float32) for _ in range(3))
    jdt, tdt = DTYPES[dtype]
    jout, jprobs = jax_attention(*(jnp.asarray(t).astype(jdt)
                                   for t in (q, k, v)), 0.2, impl="xla",
                                 return_probs=True, seq_valid=25)
    out, probs = multi_head_attention(
        *(torch.from_numpy(t).to(tdt) for t in (q, k, v)), 0.2,
        return_probs=True, seq_valid=25)
    assert out.dtype == tdt and probs.dtype == torch.float32
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), rtol=0,
                               atol=PROB_BAR)
    bar = 1e-5 if dtype == "float32" else 2.0 ** -8
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(jout.astype(jnp.float32)),
                               rtol=bar, atol=bar)


def test_capture_is_differentiable_and_leaves_eval_alone():
    """The capture path has gradients (the xla core's softmax and
    products), and a forward without capture is the fused one."""
    port = ViT(**KW, compute_dtype=torch.float32)
    img = torch.from_numpy(np.random.RandomState(3).uniform(
        -1, 1, (1, 80, 80, 3)).astype(np.float32))
    logits, probs = port(img, capture_attention=True)
    (logits.sum() + probs[0].sum()).backward()
    assert port.cls_token.grad is not None
    torch.testing.assert_close(port(img).detach(), logits.detach(),
                               rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def cli_setup(tmp_path_factory):
    """An 80 px image, a data config with the validation transform, and
    one set of weights as a JAX checkpoint and as a port checkpoint, for
    a bf16 and a float32 compute config each."""
    root = tmp_path_factory.mktemp("torch_capture_cli")
    rng = np.random.RandomState(4)
    Image.fromarray(rng.randint(0, 256, (96, 96, 3), np.uint8)).save(
        root / "img.png")
    (root / "data.json").write_text(json.dumps({
        "dataset_path": str(root), "number_of_classes": 5,
        "transform_ops_val": {"Resize": 80, "Normalize": {
            "Mean": [0.5, 0.5, 0.5], "Std": [0.5, 0.5, 0.5]}}}))
    train_config = dict(optimizer="adamw", opt_eps=1e-8, opt_betas=None,
                        weight_decay=0.05, momentum=0.9, lr=1e-3,
                        clip_grad=None, epochs=1, warmup_epochs=0)
    configs = {}
    for dtype in DTYPES:
        vit_config = dict(decoder="classification", image_size=80,
                          patch_size=16, embed_dim=64, depth=DEPTH,
                          heads=HEADS, mlp_dim=128, dropout=0.0,
                          emb_dropout=0.0, q_format="FP32",
                          compute_dtype=dtype)
        model = jax_vit.ViT(**jax_vit.vit_kwargs_from_config(
            {"vit_config": vit_config}, {"number_of_classes": 5}))
        state = init_train_state(model, jax_optim.create_optimizer(
            train_config), jax.random.PRNGKey(7), jnp.zeros((1, 80, 80, 3)))
        jax_save_checkpoint(state, str(root / f"jax_{dtype}"))
        port = ViT(**KW)
        port.load_state_dict(state_dict_from_jax(jax.tree_util.tree_map(
            np.asarray, state.params)), strict=True)
        save_model(port, str(root / f"port_{dtype}"))
        for side in ("jax", "port"):
            config = {"vit_config": vit_config,
                      "data_config_path": str(root / "data.json"),
                      "train_config": {**train_config, "checkpoint_path":
                                       str(root / f"{side}_{dtype}")}}
            configs[side, dtype] = config
    return root, configs


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_visualize_cli_matches_jax_cli(cli_setup, dtype, capsys):
    """Both CLIs on one image from the same weights: the same PNG names
    (each head and the mean of the last layer), 80 x 80 grayscale, at
    most one grey level apart."""
    from conftest import load_script_module

    root, configs = cli_setup
    jax_cli = load_script_module(
        os.path.join(REPO, "classification", "visualize_attention.py"),
        "visualize_attention_for_port")
    jax_cli.visualize(configs["jax", dtype], str(root / "img.png"),
                      str(root / f"jax_out_{dtype}"), -1)
    port_cli.main(["-c", _write(root, configs["port", dtype], dtype),
                   "--image", str(root / "img.png"), "--output_dir",
                   str(root / f"port_out_{dtype}"), "--device", "cpu"])
    assert "wrote 3 attention maps (layer -1, 2 heads + mean)" in \
        capsys.readouterr().out
    names = sorted(os.listdir(root / f"jax_out_{dtype}"))
    assert names == sorted(os.listdir(root / f"port_out_{dtype}")) == [
        "layer-1_head0.png", "layer-1_head1.png", "layer-1_mean.png"]
    for name in names:
        a, b = (np.asarray(Image.open(root / f"{side}_out_{dtype}" / name),
                           np.int16) for side in ("jax", "port"))
        assert a.shape == b.shape == (80, 80)
        assert int(np.abs(a - b).max()) <= 1, name


def _write(root, config, dtype):
    path = root / f"port_{dtype}.json"
    path.write_text(json.dumps(config))
    return str(path)
