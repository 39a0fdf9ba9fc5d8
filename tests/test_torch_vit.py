"""The port's ViT against the JAX package's ViT on one set of weights:
a seeded JAX model, carried across with ``state_dict_from_jax`` and
loaded with ``strict=True``.  80 px images give a 5x5 patch grid, so the
stored 14x14 positional grid goes through the bicubic resize."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myrtle_vision_tpu.models.vit import ViT as JaxViT
from myrtle_vision_tpu.ops.interpolate import resize_bicubic as jax_resize
from myrtle_vision_tpu_torch.models.vit import (
    SegmentationDecoder,
    ViT,
    vit_kwargs_from_config,
)
from myrtle_vision_tpu_torch.ops.interpolate import resize_bicubic
from myrtle_vision_tpu_torch.utils.convert import state_dict_from_jax

KW = dict(decoder="classification", image_size=80, patch_size=16,
          num_classes=5, dim=64, depth=2, heads=2, mlp_dim=128, dim_head=32)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def jax_params():
    model = JaxViT(**KW)
    img = jnp.zeros((1, 80, 80, 3), jnp.float32)
    params = model.init(jax.random.PRNGKey(0), img)["params"]
    # move LayerNorm scales/biases and zero-free biases off their init
    rng = np.random.RandomState(0)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p, np.float32)
        + (0.05 * rng.randn(*p.shape)).astype(np.float32),
        params,
    )


@pytest.fixture(scope="module")
def images():
    return np.random.RandomState(1).uniform(-1, 1, (4, 80, 80, 3)).astype(
        np.float32
    )


def both_logits(params, images, dtype):
    jdt, tdt = DTYPES[dtype]
    ref = JaxViT(**KW, dtype=jdt).apply(
        {"params": params}, jnp.asarray(images), deterministic=True
    )
    model = ViT(**KW, compute_dtype=tdt).eval()
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.inference_mode():
        out = model(torch.from_numpy(images))
    assert out.dtype == torch.float32 and out.shape == (4, 5)
    return out.numpy(), np.asarray(ref, np.float32)


def test_strict_load_covers_every_parameter(jax_params):
    sd = state_dict_from_jax(jax_params)
    model = ViT(**KW)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    for name, t in model.state_dict().items():
        torch.testing.assert_close(t, sd[name], rtol=0, atol=0)


def test_fp32_logits_match_jax(jax_params, images):
    out, ref = both_logits(jax_params, images, "float32")
    # the fp32 bar the JAX package holds against torch (test_timm_parity)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def test_bf16_logits_match_jax(jax_params, images):
    out, ref = both_logits(jax_params, images, "bfloat16")
    # bf16 at the same rounding points, other summation order: the
    # residual stream carries ~one bf16 step (2^-8 relative) of
    # difference per block half into the head
    np.testing.assert_allclose(out, ref, rtol=0, atol=5e-2)
    np.testing.assert_array_equal(out.argmax(-1), ref.argmax(-1))


@pytest.mark.parametrize("size", [(5, 5), (3, 7), (14, 14), (20, 20)])
def test_bicubic_resize_matches_jax(size):
    grid = np.random.RandomState(2).randn(1, 14, 14, 8).astype(np.float32)
    ref = np.asarray(jax_resize(jnp.asarray(grid), *size))
    out = resize_bicubic(torch.from_numpy(grid), *size).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_kwargs_from_config_and_unported_options():
    config = {"vit_config": {
        "decoder": "classification", "image_size": 224, "patch_size": 16,
        "embed_dim": 384, "depth": 12, "heads": 6, "mlp_dim": 1536,
        "dropout": 0.0, "emb_dropout": 0.0, "q_format": "FP32",
    }}
    kw = vit_kwargs_from_config(config, {"number_of_classes": 45})
    assert kw["dim_head"] == 64 and kw["num_classes"] == 45
    assert "compute_dtype" not in kw  # ViT's default: bf16
    config["vit_config"]["compute_dtype"] = "float32"
    kw = vit_kwargs_from_config(config, {"number_of_classes": 45})
    assert kw["compute_dtype"] is torch.float32
    # segmentation builds before convert; a converted segmentation model,
    # which no CLI of the JAX package builds, is refused, and so is a
    # decoder the JAX package does not know
    assert isinstance(ViT(**{**KW, "decoder": "segmentation"}).decoder,
                      SegmentationDecoder)
    with pytest.raises(NotImplementedError, match="converted segmentation"):
        ViT(**{**KW, "decoder": "segmentation", "q_format": "FP16_32"},
            converted=True)
    with pytest.raises(ValueError, match="decoder must be"):
        ViT(**{**KW, "decoder": "captioning"})
    # PyTorchINT8 detection builds before convert; a converted INT8
    # detector, which no CLI of the JAX package builds, is refused
    assert ViT(**{**KW, "decoder": "detection", "q_format": "PyTorchINT8"}
               ).int8
    with pytest.raises(NotImplementedError, match="converted PyTorchINT8"):
        ViT(**{**KW, "decoder": "detection", "q_format": "PyTorchINT8"},
            converted=True)
