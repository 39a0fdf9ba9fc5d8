"""The port's discrete converted-INT8 Block (models/vit.py
``Block.forward_converted_discrete``) against the JAX converted Block's
discrete form on the CPU, wherever the JAX ``int8_fuse`` gate is false:
under ``MVT_INT8_FUSE=0``, under ``MVT_NO_FUSE=1``, under attention
capture and past ``fuses_at``; and the port's fused and discrete converted
models against each other, the port's twin of tests/test_convert.py's
``test_int8_fused_blocks_match_unfused``.

Model and data as tests/test_torch_int8_block.py: 80 px, patch 16, dim
64, depth 2, 2 heads of 32, MLP 128, two images from
np.random.RandomState.  Past the gate: 16 heads of 4 at dim 64, whose
gate ends at 463 tokens, patch 4 at 88 px (485 tokens), depth 1, one
image.  Both packages load the same converted parameters and the same
quant collection (``state_dict_from_jax``): calibrated on the images, or
fresh (no statistics anywhere: every product takes the JAX fallback), or
calibrated with one site fresh (layer 0's quant_out: to_out's fallback
beside integer products).

Bars.  A block's output: the converted bar of
tests/test_torch_int8_block.py, at least 99.9% of the elements identical
and none more than 2 steps of its res_add site's grid apart (the integer
products are exact in both packages; the fp32 order of the LayerNorm
statistics and the attention core, and torch's against XLA's exact erf,
can flip an isolated rint); where that site has no statistics, 1e-5.  The
logits: within 2 steps of the head's grid, or 1e-5 where it has none.
The captured probabilities: 1e-5, as tests/test_torch_attention_capture.py
holds them.  Fused against discrete in the port: 1e-4, the JAX test's
bar, on its calibrated model (without statistics the fused ops quantize
at scale 1 and zero point 128 where the discrete form takes the
fallback, in both packages).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import myrtle_vision_tpu_torch.models.vit as port_vit
from myrtle_vision_tpu.models.vit import Block as JaxBlock
from myrtle_vision_tpu.models.vit import ViT as JaxViT
from myrtle_vision_tpu.quantize import QFormat, convert_params
from myrtle_vision_tpu_torch.models.vit import ViT
from myrtle_vision_tpu_torch.ops import _kernels as K
from myrtle_vision_tpu_torch.ops.fused_attention_block import fuses_at
from myrtle_vision_tpu_torch.utils.convert import state_dict_from_jax

KW = dict(decoder="classification", image_size=80, patch_size=16,
          num_classes=4, dim=64, depth=2, heads=2, mlp_dim=128, dim_head=32)
LONG = dict(KW, image_size=88, patch_size=4, depth=1, heads=16, dim_head=4)
SAME, STEPS = 0.999, 2
PROB_BAR = 1e-5
ENVS = [("MVT_INT8_FUSE", "0"), ("MVT_NO_FUSE", "1")]


def converted_pair(kw, img, sites="calibrated"):
    """The JAX converted model, its variables, and the port's converted
    model loaded from them; ``sites`` as the module docstring says."""
    jmodel = JaxViT(q_format=QFormat.PyTorchINT8, dtype=jnp.float32, **kw)
    # jitted: only the state they give is compared, and both packages
    # load it
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(1), jnp.asarray(img))
    quant = variables["quant"]
    if sites != "fresh":
        _, upd = jax.jit(functools.partial(
            jmodel.apply, calibrating=True, mutable=["quant"]))(
                variables, jnp.asarray(img))
        quant = upd["quant"]
    quant = jax.tree_util.tree_map(np.asarray, quant)
    if sites == "one fresh":
        quant["transformer"]["layers_0"]["attn"]["quant_out"] = {
            "min": np.float32(np.inf), "max": np.float32(-np.inf)}
    params = jax.tree_util.tree_map(
        np.asarray, convert_params(variables["params"], QFormat.PyTorchINT8))
    jconv = JaxViT(q_format=QFormat.PyTorchINT8, converted=True,
                   dtype=jnp.float32, **kw)
    model = ViT(q_format="PyTorchINT8", converted=True, **kw)
    model.load_state_dict(state_dict_from_jax(params, quant=quant),
                          strict=True)
    return jconv, {"params": params, "quant": quant}, model


def block_inputs(model, img):
    """The residual stream entering each block, from the port's own plain
    forward (the inputs only need to be realistic)."""
    with torch.no_grad():
        x = model.embed_converted(torch.from_numpy(img), K.PLAIN)
        xs = [x]
        for block, sites in zip(model.transformer.layers, model.block_sites):
            xs.append(block.forward_converted(xs[-1], sites, plain=True))
    return [t.numpy() for t in xs[:-1]]


def jax_block(kw, variables, layer, x):
    """The JAX converted Block of ``layer`` on ``x``, op by op (jitted,
    XLA's fusions move the fake-quants' fp32 roundings by an ulp)."""
    block = JaxBlock(kw["dim"], kw["heads"], kw["dim_head"], kw["mlp_dim"],
                     0.0, QFormat.PyTorchINT8, converted=True,
                     dtype=jnp.float32)
    name = f"layers_{layer}"
    return np.asarray(block.apply(
        {"params": variables["params"]["transformer"][name],
         "quant": variables["quant"]["transformer"][name]},
        jnp.asarray(x)))


def jax_logits(jconv, variables, img):
    """The JAX converted model's logits, op by op likewise."""
    return jconv.apply(variables, jnp.asarray(img))


def on_grid(label, got, ref, site):
    """The block bar of the module docstring at ``site``'s grid."""
    diff = np.abs(got.astype(np.float64) - ref.astype(np.float64))
    if site[2] < 0.5:
        print(f"{label}: max |d| {diff.max():.3g} (no statistics)")
        assert diff.max() <= 1e-5, label
        return
    step = float(site[0])
    same = float(np.mean(diff == 0))
    print(f"{label}: {same:.5f} identical, at most {diff.max() / step:.3g} "
          "steps")
    assert same >= SAME, (label, same)
    assert diff.max() <= STEPS * step * (1 + 1e-5), label


def logits_close(label, got, ref, model):
    """The logits' bar of the module docstring; where the head's site has
    no statistics, 1e-5."""
    site = model.io_sites[3]
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    print(f"{label}: logits max |d| {diff.max():.3g}, "
          f"{np.mean(diff == 0):.3f} identical")
    bar = STEPS * float(site[0]) * (1 + 1e-5) if site[2] > 0.5 else 1e-5
    assert diff.max() <= bar, label


def refuse_fused(monkeypatch):
    """The fused converted ops raise, so that a pass proves the discrete
    form ran."""
    def fused(*_args, **_kwargs):
        raise AssertionError("the fused converted op ran")

    monkeypatch.setattr(port_vit, "int8_attention_block", fused)
    monkeypatch.setattr(port_vit, "int8_mlp_block", fused)


@functools.lru_cache(maxsize=None)
def converted_setup(sites):
    img = np.random.RandomState(0).randn(2, 80, 80, 3).astype(np.float32)
    jconv, variables, model = converted_pair(KW, img, sites)
    return img, jconv, variables, model, block_inputs(model, img)


@pytest.fixture(scope="module", params=["calibrated", "fresh", "one fresh"])
def models(request):
    return converted_setup(request.param)


@pytest.mark.parametrize("env", ENVS, ids=["int8_fuse_0", "no_fuse_1"])
def test_discrete_blocks_and_logits_match_jax(models, env, monkeypatch):
    """Each block's discrete form against the JAX Block's under ``env``,
    on the same input; then the whole converted model's logits."""
    img, jconv, variables, model, xs = models
    monkeypatch.setenv(*env)
    refuse_fused(monkeypatch)
    for layer, block in enumerate(model.transformer.layers):
        sites = model.block_sites[layer]
        with torch.no_grad():
            got = block.forward_converted(torch.from_numpy(xs[layer]), sites)
        on_grid(f"block {layer}", got.numpy(),
                jax_block(KW, variables, layer, xs[layer]), sites[1][4])
    ref = jax_logits(jconv, variables, img)
    with torch.no_grad():
        got = model(torch.from_numpy(img))
        assert torch.equal(got, model(torch.from_numpy(img), plain=True))
    logits_close("model", got.numpy(), ref, model)


def capture_matches_jax(img, jconv, variables, model):
    """Attention capture in a converted model: each layer's probabilities
    against the JAX model's sown ``attn_probs``, and the logits beside
    them."""
    ref, inter = jconv.apply(variables, jnp.asarray(img),
                             capture_attention=True,
                             mutable=["intermediates"])
    layers = inter["intermediates"]["transformer"]
    with torch.no_grad():
        got, probs = model(torch.from_numpy(img), capture_attention=True)
    assert len(probs) == KW["depth"]
    for i, p in enumerate(probs):
        want = np.asarray(layers[f"layers_{i}"]["attn"]["attn_probs"][0])
        assert p.shape == want.shape == (2, 2, 26, 26)
        np.testing.assert_allclose(p.numpy(), want, rtol=0, atol=PROB_BAR)
    logits_close("captured", got.numpy(), ref, model)


def test_capture_matches_jax(models, monkeypatch):
    img, jconv, variables, model, _ = models
    refuse_fused(monkeypatch)
    capture_matches_jax(img, jconv, variables, model)


def test_fused_and_discrete_agree(monkeypatch):
    """The port's fused converted model against its discrete form under
    ``MVT_INT8_FUSE=0`` (the kernels' polynomial erf against the exact
    erf can flip an isolated gelu_out rint), at the JAX test's 1e-4."""
    img, _, _, model, _ = converted_setup("calibrated")
    x = torch.from_numpy(img)
    with torch.no_grad():
        fused = model(x)
        monkeypatch.setenv("MVT_INT8_FUSE", "0")
        refuse_fused(monkeypatch)
        discrete = model(x)
    np.testing.assert_allclose(fused.numpy(), discrete.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_past_the_gate_matches_jax(monkeypatch):
    """485 tokens at 16 heads of 4, past the gate's 463: the JAX model
    runs its discrete Block there without any variable, so does the
    port's."""
    n = (LONG["image_size"] // LONG["patch_size"]) ** 2 + 1
    top = max(m for m in range(1, n) if fuses_at(m, 16, 4))
    assert (n, top) == (485, 463) and not fuses_at(n, 16, 4)
    img = np.random.RandomState(2).randn(1, 88, 88, 3).astype(np.float32)
    jconv, variables, model = converted_pair(LONG, img)
    refuse_fused(monkeypatch)
    x = block_inputs(model, img)[0]
    sites = model.block_sites[0]
    with torch.no_grad():
        got = model.transformer.layers[0].forward_converted(
            torch.from_numpy(x), sites)
        logits = model(torch.from_numpy(img))
    on_grid("block 0 at 485 tokens", got.numpy(),
            jax_block(LONG, variables, 0, x), sites[1][4])
    logits_close("485 tokens", logits.numpy(),
                 jax_logits(jconv, variables, img), model)
