"""The port's converted-INT8 block halves (ops/fused_int8_block.py, plain
chains on the CPU) against the JAX package's Pallas kernels K9 and K10
(myrtle_vision_tpu/ops/fused_int8_block.py, interpret mode on the CPU, as
tests/test_convert.py runs them), on the same int8 weights and sites.

Model and data as tests/test_convert.py: 80 px, patch 16, dim 64, depth
2, 2 heads, MLP 128, dim_head 32; images from np.random.RandomState.
The integer products are exact in both packages; only fp32 sum order
(LayerNorm statistics, the attention core, where the JAX kernel packs
its three passes into one product) can flip an isolated rint.  Bar: at
least 99.9% of the output elements identical, none more than 2 steps of
the output site's scale apart.  Both the calibrated observers and fresh
ones (no statistics: the requants pass values through, the integer
products take scale 1 and zero point 128) are compared.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myrtle_vision_tpu.models.vit import ViT as JaxViT
from myrtle_vision_tpu.ops import fused_int8_block as jax_int8
from myrtle_vision_tpu.quantize import (
    QFormat,
    affine_uint8_qparams,
    convert_params,
)
from myrtle_vision_tpu_torch.models.vit import ViT
from myrtle_vision_tpu_torch.ops import _kernels as K
from myrtle_vision_tpu_torch.ops.fused_attention_block import fuses_at
from myrtle_vision_tpu_torch.ops.fused_int8_block import (
    int8_attention_block,
    int8_attention_block_plain,
    int8_mlp_block,
    int8_mlp_block_plain,
)
from myrtle_vision_tpu_torch.utils.convert import state_dict_from_jax

KW = dict(decoder="classification", image_size=80, patch_size=16,
          num_classes=4, dim=64, depth=2, heads=2, mlp_dim=128, dim_head=32)
SAME = 0.999
STEPS = 2
ATTN_SITES = [("attn_norm", "act_out"), ("attn", "to_qkv", "act_out"),
              ("attn", "quant_out"), ("attn", "to_out", "act_out"),
              ("attn_res", "res_add")]
MLP_SITES = [("ffn_norm", "act_out"), ("ffn", "fc1", "act_out"),
             ("ffn", "gelu", "act_out"), ("ffn", "fc2", "act_out"),
             ("ffn_res", "res_add")]


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


@pytest.fixture(scope="module", params=["calibrated", "fresh"])
def models(request):
    """JAX converted params and quant collection (calibrated on one batch,
    or fresh observers without statistics), the same carried into the
    port's converted model, and the activations entering each block."""
    jmodel = JaxViT(q_format=QFormat.PyTorchINT8, dtype=jnp.float32, **KW)
    img = np.random.RandomState(0).randn(2, 80, 80, 3).astype(np.float32)
    variables = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(img))
    quant = variables["quant"]
    if request.param == "calibrated":
        _, upd = jmodel.apply(variables, jnp.asarray(img), calibrating=True,
                              mutable=["quant"])
        quant = upd["quant"]
    params = jax.tree_util.tree_map(
        np.asarray, convert_params(variables["params"], QFormat.PyTorchINT8))
    quant = jax.tree_util.tree_map(np.asarray, quant)
    model = ViT(q_format="PyTorchINT8", converted=True, **KW)
    model.load_state_dict(state_dict_from_jax(params, quant=quant),
                          strict=True)
    # the residual stream entering each block, from the port's own plain
    # forward of this image batch (the inputs only need to be realistic)
    with torch.no_grad():
        x = model.embed_converted(torch.from_numpy(img), K.PLAIN)
        xs = [x]
        for block, sites in zip(model.transformer.layers, model.block_sites):
            xs.append(block.forward_converted(xs[-1], sites, plain=True))
    return params, quant, model, [t.numpy() for t in xs[:-1]]


def _jax_sites(quant, layer, names):
    rows = []
    for path in names:
        site = _get(quant, ("transformer", f"layers_{layer}") + path)
        lo, hi = jnp.float32(site["min"]), jnp.float32(site["max"])
        scale, zp = affine_uint8_qparams(lo, hi)
        rows.append((scale, zp, lo <= hi))
    return rows


def _on_grid(got, ref, step):
    """The bar of the module docstring; an output site without statistics
    (step 0) has no grid, and there the two differ by fp32 roundoff of
    the epilogues' order of operations (measured 2.4e-7 at |x| < 4)."""
    if not step:
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
        return
    diff = np.abs(got.astype(np.float64) - ref.astype(np.float64))
    assert np.mean(diff == 0) >= SAME, np.mean(diff == 0)
    assert diff.max() <= STEPS * step * (1 + 1e-5)


@pytest.mark.parametrize("layer", [0, 1])
def test_site_tables_match_jax(models, layer):
    _, quant, model, _ = models
    table = model.block_sites[layer].numpy()
    for half, names in enumerate((ATTN_SITES, MLP_SITES)):
        for row, (scale, zp, has) in zip(table[half],
                                         _jax_sites(quant, layer, names)):
            np.testing.assert_array_equal(
                row, np.array([scale, zp, float(has)], np.float32))


@pytest.mark.parametrize("layer", [0, 1])
def test_attention_half_matches_jax_kernel(models, layer):
    params, quant, model, xs = models
    p = params["transformer"][f"layers_{layer}"]
    x = xs[layer]
    ref = jax_int8.int8_attention_block(
        jnp.asarray(x), p["attn_norm"]["scale"], p["attn_norm"]["bias"],
        p["attn"]["to_qkv"]["kernel"], p["attn"]["to_qkv"]["kernel_scale"],
        p["attn"]["to_qkv"]["bias"], p["attn"]["to_out"]["kernel"],
        p["attn"]["to_out"]["kernel_scale"], p["attn"]["to_out"]["bias"],
        _jax_sites(quant, layer, ATTN_SITES), heads=2, scale=32 ** -0.5)
    block = model.transformer.layers[layer]
    a = block._modules["0"].fn
    args = (torch.from_numpy(x), a.norm.weight, a.norm.bias,
            a.fn.to_qkv.weight.t(), a.fn.to_qkv.weight_scale,
            a.fn.to_qkv.bias, a.fn.to_out[0].weight.t(),
            a.fn.to_out[0].weight_scale, a.fn.to_out[0].bias,
            model.block_sites[layer][0], 2, 32 ** -0.5)
    with torch.no_grad():
        got = int8_attention_block(*args)
        plain = int8_attention_block_plain(*args)
    torch.testing.assert_close(got, plain, rtol=0, atol=0)
    site = model.block_sites[layer][0][4]
    _on_grid(got.numpy(), np.asarray(ref),
             float(site[0]) if site[2] > 0.5 else 0.0)


@pytest.mark.parametrize("layer", [0, 1])
def test_mlp_half_matches_jax_kernel(models, layer):
    params, quant, model, xs = models
    p = params["transformer"][f"layers_{layer}"]
    block = model.transformer.layers[layer]
    with torch.no_grad():  # the MLP half's input: the attention half's out
        x = block.forward_converted(torch.from_numpy(xs[layer]),
                                    model.block_sites[layer],
                                    plain=True).numpy()
    ref = jax_int8.int8_mlp_block(
        jnp.asarray(x), p["ffn_norm"]["scale"], p["ffn_norm"]["bias"],
        p["ffn"]["fc1"]["kernel"], p["ffn"]["fc1"]["kernel_scale"],
        p["ffn"]["fc1"]["bias"], p["ffn"]["fc2"]["kernel"],
        p["ffn"]["fc2"]["kernel_scale"], p["ffn"]["fc2"]["bias"],
        _jax_sites(quant, layer, MLP_SITES))
    f = block._modules["1"].fn
    net = f.fn.net
    args = (torch.from_numpy(x), f.norm.weight, f.norm.bias,
            net[0].weight.t(), net[0].weight_scale, net[0].bias,
            net[3].weight.t(), net[3].weight_scale, net[3].bias,
            model.block_sites[layer][1])
    with torch.no_grad():
        got = int8_mlp_block(*args)
        plain = int8_mlp_block_plain(*args)
    torch.testing.assert_close(got, plain, rtol=0, atol=0)
    site = model.block_sites[layer][1][4]
    _on_grid(got.numpy(), np.asarray(ref),
             float(site[0]) if site[2] > 0.5 else 0.0)


def test_ops_refuse_long_sequences_and_other_devices():
    """The attention op takes every length the JAX model fuses (257 and
    the gate's last) and refuses the first past the gate (``fuses_at``,
    the discrete converted Block's lengths, ROADMAP A5b); another device
    has no kernel."""
    w = torch.zeros(64, 192, dtype=torch.int8)
    sites = torch.zeros(5, 3)
    one = torch.ones(())
    top = max(n for n in range(257, 4096) if fuses_at(n, 2, 32))
    for n in (257, top):
        x = torch.zeros(1, n, 64)
        out = int8_attention_block(x, x[0, 0], x[0, 0], w, one,
                                   w[0].float(), w[:, :64], one, x[0, 0],
                                   sites, 2, 0.125)
        assert out.shape == x.shape and bool(torch.isfinite(out).all())
    x = torch.zeros(1, top + 1, 64)
    with pytest.raises(ValueError, match="past the fused gate.*A5b"):
        int8_attention_block(x, x[0, 0], x[0, 0], w, one, w[0].float(),
                             w[:, :64], one, x[0, 0], sites, 2, 0.125)
    with pytest.raises(ValueError, match="no kernel for meta"):
        int8_mlp_block(x.to("meta"), x[0, 0], x[0, 0], w, one, w[0].float(),
                       w.t(), one, x[0, 0], sites)
