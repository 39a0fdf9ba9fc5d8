"""compute_dtype float32 in the port against the JAX package on the CPU:
both fused block halves at ``qspec`` None (the JAX Pallas kernels in
interpret mode, whose fp32 dots are true fp32), fp32 flash attention on
both sides of the unblocked regime's 1536-token ceiling with masked keys,
a ViT train step with float32 compute, fused and under MVT_NO_FUSE=1, and
a YOLOS train step under MVT_NO_FUSE=1 through the blocked flash regime
(K7), forced as tests/test_torch_detection_training.py forces it.  The
same numpy inputs and, for the models, the same JAX-initialised weights
(utils/convert.py ``state_dict_from_jax``) on both sides.

Bars (PERF.md section 2, on the CPU against JAX): block and attention
outputs 3e-5, gradients 2e-4 relative plus 2e-4 of the tensor's largest,
logits and losses 1e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import myrtle_vision_tpu.models.vit as jax_vit
import myrtle_vision_tpu.ops.flash_attention as jax_fa
import myrtle_vision_tpu_torch.models.vit as port_vit
import myrtle_vision_tpu_torch.ops.flash_attention as port_fa
from myrtle_vision_tpu.models.detector import (
    build_weight_dict as jax_weight_dict,
)
from myrtle_vision_tpu.ops.fused_attention_block import (
    fused_attention_block as jax_attention,
)
from myrtle_vision_tpu.ops.fused_mlp import fused_mlp_block as jax_mlp
from myrtle_vision_tpu.training.classification import (
    make_loss_fn as jax_cls_loss_fn,
)
from myrtle_vision_tpu.training.detection import (
    make_loss_fn as jax_det_loss_fn,
)
from myrtle_vision_tpu_torch.models.detector import build_weight_dict
from myrtle_vision_tpu_torch.ops.fused_attention_block import (
    fused_attention_block,
)
from myrtle_vision_tpu_torch.ops.fused_mlp import fused_mlp_block
from myrtle_vision_tpu_torch.training.classification import (
    make_loss_fn as cls_loss_fn,
)
from myrtle_vision_tpu_torch.training.detection import (
    make_loss_fn as det_loss_fn,
)
from myrtle_vision_tpu_torch.utils.convert import state_dict_from_jax

BLOCK_BAR = 3e-5
GRAD_BAR = 2e-4
LOGIT_BAR = 1e-4
C, HEADS, HID, B = 64, 2, 128, 2
SCALE = (C // HEADS) ** -0.5


def r(rng, *shape, std=1.0):
    return (rng.randn(*shape) * std).astype(np.float32)


def close(got, ref, bar, name=""):
    """Per element: ``bar`` relative plus ``bar`` of ref's largest
    magnitude (at least 1e-6)."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, name
    atol = bar * max(float(np.abs(ref).max()), 1e-6)
    np.testing.assert_allclose(got, ref, rtol=bar, atol=atol, err_msg=name)


# ------------------------------------------------------------ block halves

def block_args(op, n, seed):
    """fp32 x, the half's parameters in the JAX (in, out) layout, an
    upstream gradient."""
    rng = np.random.RandomState(seed)
    if op == "attention":
        args = [r(rng, B, n, C, std=0.5), 1 + r(rng, C, std=0.1),
                r(rng, C, std=0.1), r(rng, C, 3 * C, std=0.1),
                r(rng, 3 * C, std=0.05), r(rng, C, C, std=0.1),
                r(rng, C, std=0.05)]
    else:
        args = [r(rng, B, n, C, std=0.5), 1 + r(rng, C, std=0.1),
                r(rng, C, std=0.1), r(rng, C, HID, std=0.1),
                r(rng, HID, std=0.05), r(rng, HID, C, std=0.1),
                r(rng, C, std=0.05)]
    return args, r(rng, B, n, C)


@pytest.mark.parametrize("n", [17, 50])
@pytest.mark.parametrize("op", ["attention", "mlp"])
def test_fp32_block_half_matches_jax_interpret(op, n):
    """Forward and every gradient of the fp32 half (``qspec`` None): the
    port's op on CPU tensors (the plain chain: true fp32 products, as
    the JAX kernel's ``_dot`` takes at fp32) against ``jax.vjp`` of the
    JAX op, its Pallas kernels in interpret mode."""
    args, g = block_args(op, n, 40 + n)
    jfn, tfn = ((jax_attention, fused_attention_block) if op == "attention"
                else (jax_mlp, fused_mlp_block))
    extra = (HEADS, SCALE) if op == "attention" else ()
    out, vjp = jax.vjp(lambda *a: jfn(*a, *extra),
                       *(jnp.asarray(a) for a in args))
    jgrads = vjp(jnp.asarray(g))
    tensors = [torch.from_numpy(a).requires_grad_() for a in args]
    t_out = tfn(*tensors, *extra)
    assert t_out.dtype == torch.float32
    t_out.backward(torch.from_numpy(g))
    close(t_out.detach(), out, BLOCK_BAR, "out")
    for t, jg, name in zip(tensors, jgrads, range(len(args))):
        close(t.grad, jg, GRAD_BAR, f"d{name}")


# ------------------------------------------------------------ flash

@pytest.mark.parametrize("n,n_valid", [(197, 150), (1545, 1400)])
def test_fp32_flash_matches_jax_interpret(n, n_valid):
    """fp32 flash attention, keys at or past n_valid masked, below the
    1536-token ceiling (K5 / K8) and past it (K6 / K7): output and q, k,
    v gradients against ``jax.vjp`` of the JAX function in interpret
    mode."""
    rng = np.random.RandomState(n)
    q, k, v, g = (r(rng, 1, 2, n, 32) for _ in range(4))
    out, vjp = jax.vjp(
        lambda *a: jax_fa.flash_attention(*a, SCALE, n_valid),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    t_out = port_fa.flash_attention(tq, tk, tv, SCALE, n_valid)
    assert t_out.dtype == torch.float32
    t_out.backward(torch.from_numpy(g))
    close(t_out.detach(), out, BLOCK_BAR, "o")
    for t, jg, name in zip((tq, tk, tv), jgrads, "qkv"):
        close(t.grad, jg, GRAD_BAR, f"d{name}")
    assert not tk.grad[:, :, n_valid:].any()


# ------------------------------------------------------------ ViT step

CLS_KW = dict(decoder="classification", image_size=80, patch_size=16,
              num_classes=5, dim=C, depth=2, heads=HEADS, mlp_dim=HID,
              dim_head=C // HEADS)


def loss_and_grads(jmodel, params, jloss_fn, model, loss_fn, batch,
                   decoder):
    """(JAX loss, port loss, JAX gradients, port gradients) of one
    micro-batch, the port model loaded with the JAX parameters."""
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jloss_fn(p, {}, {k: jnp.asarray(v)
                                   for k, v in batch.items()},
                           jax.random.PRNGKey(0)), has_aux=True)(params)
    model.load_state_dict(state_dict_from_jax(params, decoder=decoder),
                          strict=True)
    loss, _ = loss_fn({k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    return (float(jloss), float(loss.detach()),
            state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads),
                                decoder=decoder),
            {n: p.grad for n, p in model.named_parameters()})


def check_step(jloss, loss, jgrads, grads):
    np.testing.assert_allclose(loss, jloss, rtol=LOGIT_BAR, atol=LOGIT_BAR)
    for name, ref in jgrads.items():
        got = grads[name]
        if got is None:  # a parameter the loss does not reach
            assert not ref.abs().max() > 0, name
            continue
        close(got, ref, GRAD_BAR, name)


@pytest.mark.parametrize("no_fuse", [False, True])
def test_fp32_vit_step_matches_jax(no_fuse, monkeypatch):
    """One classification micro-batch with compute_dtype float32, the
    fused Blocks (the fp32 K1-K4 plain chains against the Pallas kernels
    in interpret mode) or, under MVT_NO_FUSE=1, the discrete Blocks on
    both sides (the fp32 flash K5 / K8): loss and every gradient."""
    if no_fuse:
        monkeypatch.setenv("MVT_NO_FUSE", "1")
    rng = np.random.RandomState(7)
    batch = {"image": rng.uniform(-1, 1, (2, 80, 80, 3)).astype(np.float32),
             "label": rng.randint(0, 5, 2).astype(np.int32)}
    jmodel = jax_vit.ViT(**CLS_KW, dtype=jnp.float32)
    params = jmodel.init(jax.random.PRNGKey(3),
                         jnp.zeros((1, 80, 80, 3)))["params"]
    model = port_vit.ViT(**CLS_KW, compute_dtype=torch.float32)
    counts = []
    real = port_vit.Block.forward_discrete

    def counted(self, *a, **kw):
        counts.append(1)
        return real(self, *a, **kw)

    monkeypatch.setattr(port_vit.Block, "forward_discrete", counted)
    check_step(*loss_and_grads(jmodel, params, jax_cls_loss_fn(jmodel),
                               model, cls_loss_fn(model), batch,
                               "classification"))
    assert len(counts) == (2 if no_fuse else 0)


# ------------------------------------------------------------ YOLOS step

DET_KW = dict(decoder="detection", image_size=160, patch_size=16,
              num_classes=3, dim=C, depth=2, heads=HEADS, mlp_dim=HID,
              dim_head=C // HEADS, num_det_tokens=10)
DET_CONFIG = dict(loss_ce=1.0, class_error=0.0, loss_bbox=5.0,
                  loss_giou=2.0, cardinality_error=0.0, eos_coef=0.1)


def test_fp32_yolos_step_blocked_flash_matches_jax(monkeypatch):
    """A YOLOS micro-batch at 256 px (267 tokens) with compute_dtype
    float32 under MVT_NO_FUSE=1, the flash attention forced into its
    blocked regime (K6 forward, K7 backward) in both packages in KV tiles
    of 128, the route past 1536 tokens: the losses and every gradient.
    The same output gradient reaches both networks only through the same
    matching, so the boxes stay well inside the images."""
    monkeypatch.setenv("MVT_NO_FUSE", "1")
    monkeypatch.setattr(jax_fa, "_FULL_SEQ_MAX", 0)
    monkeypatch.setattr(jax_fa, "_pick_kv_blk", lambda n_pad: 128)
    monkeypatch.setattr(port_fa, "FULL_SEQ_MAX", 0)
    monkeypatch.setattr(port_fa, "pick_kv_blk", lambda n_pad: 128)
    rng = np.random.RandomState(11)
    wh = rng.uniform(0.1, 0.4, (2, 10, 2))
    cxy = wh / 2 + rng.uniform(0, 1, (2, 10, 2)) * (1 - wh)
    valid = np.zeros((2, 10), bool)
    valid[:, :3] = True
    batch = {"image": rng.uniform(-1, 1, (2, 256, 256, 3)).astype(
                 np.float32),
             "boxes": np.concatenate([cxy, wh], -1).astype(np.float32),
             "labels": rng.randint(0, 3, (2, 10)).astype(np.int32),
             "valid": valid}
    jmodel = jax_vit.ViT(**DET_KW, dtype=jnp.float32)
    params = jmodel.init(jax.random.PRNGKey(5),
                         jnp.zeros((1, 160, 160, 3)))["params"]
    model = port_vit.ViT(**DET_KW, compute_dtype=torch.float32)
    jloss_fn = jax_det_loss_fn(jmodel, 3, jax_weight_dict(DET_CONFIG), 0.1)
    loss_fn = det_loss_fn(model, 3, build_weight_dict(DET_CONFIG), 0.1)
    check_step(*loss_and_grads(jmodel, params, jloss_fn, model, loss_fn,
                               batch, "detection"))
