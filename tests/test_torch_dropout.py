"""Active dropout in the port against the JAX package on the CPU.  Both
packages are fed the same keep masks in call order: the port's through
models/vit.py ``dropout_mask``, the JAX model's through a stand-in for
``flax.linen.Dropout.__call__`` (flax's own arithmetic, select(keep,
x / (1 - rate), 0), on the given mask), set up in the test only.  Then
one train micro-batch gives the same loss and gradients, and the sites
match the JAX model's four (the tokens, the attention output, the GELU
output, fc2's output) in number, shape and order.  With rate 0, or
without a generator (the JAX ``deterministic``), the outputs are bit for
bit the model's without dropout.  The masks keep 1 - rate of the
elements within binomial bounds, and one seed repeats a step."""
import math

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import myrtle_vision_tpu.models.vit as jax_vit
import myrtle_vision_tpu_torch.models.vit as port_vit
from myrtle_vision_tpu.training.classification import (
    make_loss_fn as jax_loss_fn,
)
from myrtle_vision_tpu_torch.training import optim
from myrtle_vision_tpu_torch.training.classification import make_loss_fn
from myrtle_vision_tpu_torch.training.trainer import (
    TrainState,
    dropout_generator,
    make_train_step,
)
from myrtle_vision_tpu_torch.utils.convert import state_dict_from_jax

DEPTH, C, HID, N = 2, 64, 128, 26
KW = dict(decoder="classification", image_size=80, patch_size=16,
          num_classes=5, dim=C, depth=DEPTH, heads=2, mlp_dim=HID,
          dim_head=32, dropout=0.1, emb_dropout=0.1)
TRAIN_CONFIG = dict(optimizer="adamw", opt_eps=1e-8, opt_betas=None,
                    weight_decay=0.05, momentum=0.9, lr=1e-3, clip_grad=None)
# the JAX model's sites in call order: the tokens (emb_drop), then per
# block the attention after to_out, the MLP after the GELU and after fc2
SITES = [(2, N, C)] + [(2, N, C), (2, N, HID), (2, N, C)] * DEPTH
LOSS_BAR = 1e-4
GRAD_BAR = 2e-4


def batch(seed=3):
    rng = np.random.RandomState(seed)
    return {"image": rng.uniform(-1, 1, (2, 80, 80, 3)).astype(np.float32),
            "label": rng.randint(0, 5, 2).astype(np.int32)}


def jax_setup(dtype=jnp.float32):
    model = jax_vit.ViT(**KW, dtype=dtype)
    params = model.init(jax.random.PRNGKey(1),
                        jnp.zeros((1, 80, 80, 3)))["params"]
    return model, jax.tree_util.tree_map(np.asarray, params)


def port_model(params, dtype=torch.float32, **kw):
    model = port_vit.ViT(**{**KW, **kw}, compute_dtype=dtype)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return model


def feed_jax_masks(monkeypatch, masks, shapes):
    """flax's Dropout on the given keep masks, in call order; each
    active call's input shape recorded."""
    it = iter(masks)

    def call(self, inputs, deterministic=None, rng=None):
        if self.rate == 0.0 or flax_nn.merge_param(
                "deterministic", self.deterministic, deterministic):
            return inputs
        shapes.append(tuple(inputs.shape))
        keep = jnp.asarray(next(it))
        return jax.lax.select(keep, inputs / (1.0 - self.rate),
                              jnp.zeros_like(inputs))

    monkeypatch.setattr(flax_nn.Dropout, "__call__", call)


def feed_port_masks(monkeypatch, masks, shapes):
    it = iter(masks)

    def mask(shape, rate, generator, device):
        shapes.append(tuple(shape))
        return torch.from_numpy(next(it)).to(device)

    monkeypatch.setattr(port_vit, "dropout_mask", mask)


def masks_for(seed, rate=0.1):
    rng = np.random.RandomState(seed)
    return [rng.uniform(size=s) >= rate for s in SITES]


def test_sites_and_step_match_jax_with_shared_masks(monkeypatch):
    """One micro-batch, dropout and emb_dropout 0.1, fp32 compute, the
    Blocks discrete on both sides (the JAX gate's active-dropout branch):
    the sites' number, shapes and order, the loss, every gradient."""
    model, params = jax_setup()
    data = batch()
    masks = masks_for(5)
    jax_shapes, port_shapes = [], []
    feed_jax_masks(monkeypatch, masks, jax_shapes)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jax_loss_fn(model)(p, {}, {k: jnp.asarray(v)
                                              for k, v in data.items()},
                                     jax.random.PRNGKey(0)),
        has_aux=True)(params)
    port = port_model(params)
    feed_port_masks(monkeypatch, masks, port_shapes)
    counts = []
    real = port_vit.Block.forward_discrete

    def discrete(self, *a, **kw):
        counts.append(1)
        return real(self, *a, **kw)

    monkeypatch.setattr(port_vit.Block, "forward_discrete", discrete)
    loss, _ = make_loss_fn(port)({k: torch.from_numpy(v)
                                  for k, v in data.items()},
                                 torch.Generator().manual_seed(0))
    loss.backward()
    assert jax_shapes == port_shapes == SITES
    assert len(counts) == DEPTH
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=LOSS_BAR, atol=LOSS_BAR)
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    for name, p in port.named_parameters():
        r = ref[name].numpy()
        got = (np.zeros_like(r) if p.grad is None else p.grad.numpy())
        atol = GRAD_BAR * max(float(np.abs(r).max()), 1e-6)
        np.testing.assert_allclose(got, r, rtol=GRAD_BAR, atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_inactive_dropout_is_bit_for_bit_the_model_without(dtype):
    """Rate 0 with a generator, and rate 0.1 without one (eval, the JAX
    ``deterministic``), give the bits of the model without dropout, on
    the fused path."""
    _, params = jax_setup()
    img = torch.from_numpy(batch()["image"])
    plain = port_model(params, dtype, dropout=0.0, emb_dropout=0.0)
    ref = plain(img)
    assert torch.equal(plain(img, dropout_rng=torch.Generator()), ref)
    assert torch.equal(port_model(params, dtype)(img), ref)
    assert dropout_generator(plain, 0) is None


def test_keep_rate_is_binomial_and_the_seed_repeats_a_step():
    """A mask keeps 1 - rate of its elements within 5 standard
    deviations; two train steps from the same weights and the same seed
    give the same loss and gradients, another seed another loss."""
    n, rate = 1 << 20, 0.1
    keep = port_vit.dropout_mask((n,), rate, torch.Generator().manual_seed(3),
                                 torch.device("cpu"))
    sd = math.sqrt(n * rate * (1 - rate))
    assert abs(int(keep.sum()) - n * (1 - rate)) <= 5 * sd
    _, params = jax_setup()
    data = {k: torch.from_numpy(v)[None].expand(2, *v.shape).contiguous()
            for k, v in batch().items()}
    runs = []
    for seed in (7, 7, 8):
        model = port_model(params)
        state = TrainState(model, optim.create_optimizer(TRAIN_CONFIG, model),
                           dropout=dropout_generator(model, seed))
        metrics = make_train_step(make_loss_fn(model), 2)(state, data, 1e-3)
        runs.append((float(metrics["loss"]),
                     model.cls_token.detach().clone()))
    assert runs[0][0] == runs[1][0]
    assert torch.equal(runs[0][1], runs[1][1])
    assert runs[0][0] != runs[2][0]


def test_eval_ignores_dropout():
    """make_predict_fn's eval forward takes no generator: the same logits
    as the model without dropout."""
    from myrtle_vision_tpu_torch.training.classification import (
        make_predict_fn,
    )

    _, params = jax_setup()
    img = torch.from_numpy(batch()["image"])
    ref = port_model(params, dropout=0.0, emb_dropout=0.0)(img)
    assert torch.equal(make_predict_fn(port_model(params))(img), ref)
