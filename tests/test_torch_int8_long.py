"""PyTorchINT8 above 256 tokens, the port against the JAX package on the
CPU: the two-pass QAT attention half (``fused_attention_block_i8``, the
JAX K1 / K2 with ``qspec="int8"`` in interpret mode) forward and backward,
and the converted block halves (``int8_attention_block`` /
``int8_mlp_block``, the JAX K9 / K10 in interpret mode), at 257 and 300
tokens, the lengths whose attention core takes the long CUDA kernel on the
card (csrc/attention_core_f32_long_wgmma.cu, its site and int8 modes); and
a tiny ViT classifier at 272 px (17 x 17 patches + cls = 290 tokens): its
two-pass QAT step against the JAX step (``MVT_INT8_QAT_FUSE=1``: pass 2
through the fused Pallas kernels), its observers and gradients, and its
converted forward.

Widths: dim 32, 2 heads of 16, MLP 64; inputs from np.random.RandomState.
The bars are the existing INT8 bars: tests/test_torch_int8_qat.py's for
the QAT half (the output within 3e-5 plus one step of its site, at most
0.1% of its elements past 3e-5; every gradient within 2e-4 of its leaf's
largest magnitude) and the step (the loss within 1e-6 relative, the
observers within 1e-5, the logits within 1e-4 plus one step of their
grid); tests/test_torch_int8_block.py's for the converted halves and
model (at least 99.9% of the elements identical, none more than 2 steps
of the output's grid apart)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myrtle_vision_tpu.models.vit import ViT as JaxViT
from myrtle_vision_tpu.ops import fused_attention_block as jfa
from myrtle_vision_tpu.ops import fused_int8_block as jax_int8
from myrtle_vision_tpu.quantize import QFormat as JaxQFormat
from myrtle_vision_tpu.quantize import convert_params as jax_convert
from myrtle_vision_tpu.training.classification import (
    make_loss_fn as jax_loss_fn,
)
from myrtle_vision_tpu_torch.models.vit import Block, ViT
from myrtle_vision_tpu_torch.ops import _kernels as K
from myrtle_vision_tpu_torch.ops import fake_quant as fq
from myrtle_vision_tpu_torch.ops import fused_attention_block as pfa
from myrtle_vision_tpu_torch.ops.fused_attention_block import (
    fused_attention_block_i8,
    fuses_at,
)
from myrtle_vision_tpu_torch.ops.fused_int8_block import (
    int8_attention_block,
    int8_attention_block_plain,
    int8_mlp_block,
    int8_mlp_block_plain,
    weight_colsum,
)
from myrtle_vision_tpu_torch.quantize import (
    QFormat,
    convert_params,
    is_observer,
)
from myrtle_vision_tpu_torch.training.classification import make_loss_fn
from myrtle_vision_tpu_torch.training.optim import cross_entropy_loss
from myrtle_vision_tpu_torch.utils.convert import (
    quant_site_names,
    state_dict_from_jax,
)

from test_torch_int8_block import _on_grid

C, HEADS, HID, B = 32, 2, 64, 2
D = C // HEADS
SCALE = D ** -0.5
LENGTHS = [257, 300]
FWD_ATOL = 3e-5
FLIP_SHARE = 1e-3
GRAD_BAR = 2e-4
NAMES = ["x", "ln_scale", "ln_bias", "wqkv", "bqkv", "wp", "bp"]
KW = dict(decoder="classification", image_size=272, patch_size=16,
          num_classes=4, dim=C, depth=1, heads=HEADS, mlp_dim=HID,
          dim_head=D)
TOKENS = (272 // 16) ** 2 + 1


def test_the_lengths_fuse():
    """Every length here is under the fused gate, above the one-CTA
    kernels' 256: the JAX model fuses them, the card takes the long
    kernel."""
    for n in LENGTHS + [TOKENS]:
        assert 256 < n and fuses_at(n, HEADS, D)


def calibrated_block(n, seed, c=C, heads=HEADS, hid=HID, b=B):
    """fp32 x (b, n, c), a port Block of ``heads`` heads and an MLP of
    ``hid`` calibrated on x (its discrete calibrating forward) with
    weights from the seed, its (2, 5, 3) site table, and an upstream
    gradient."""
    rng = np.random.RandomState(seed)
    f = np.float32
    x = rng.randn(b, n, c).astype(f)
    block = Block(c, heads, c // heads, hid, 0.0, 1,
                  q_format=QFormat.PyTorchINT8)
    sd = {}
    for name, t in block.state_dict().items():
        if is_observer(name):
            sd[name] = t
        elif name.endswith("norm.weight"):
            sd[name] = torch.from_numpy((1 + 0.1 * rng.randn(c)).astype(f))
        elif t.dim() == 2:
            sd[name] = torch.from_numpy(
                (rng.randn(*t.shape) * t.shape[1] ** -0.5).astype(f))
        else:
            sd[name] = torch.from_numpy((0.1 * rng.randn(*t.shape)).astype(f))
    block.load_state_dict(sd)
    with torch.no_grad():
        block.forward_int8(torch.from_numpy(x))
    return x, block, block.site_table(), rng.randn(b, n, c).astype(f)


def qat_attention_args(x, block):
    """The attention half's arguments in the JAX layout, the weights
    through their symmetric int8 fake-quant as the Block passes them."""
    a = block._modules["0"].fn
    qkv, out = a.fn.to_qkv, a.fn.to_out[0]

    def qw(lin):
        w = lin.weight.detach()
        s = torch.clamp(w.abs().max() / 127.5, min=1.1920929e-7)
        return fq.int8_symmetric_fake_quant(w, s).t().contiguous().numpy()

    def vec(t):
        return t.detach().numpy().copy()

    return [x, vec(a.norm.weight), vec(a.norm.bias), qw(qkv), vec(qkv.bias),
            qw(out), vec(out.bias)]


@pytest.mark.parametrize("n", LENGTHS)
def test_int8_qat_attention_above_256_matches_jax(n):
    """``fused_attention_block_i8`` forward and backward against
    ``jax.vjp`` of the JAX op (K1 and K2 with qspec "int8", interpret
    mode) on a calibrated site table.  dWp is held after taking out what
    the context elements that flipped a step of site 2 (at most 0.1% of
    them, the forward bar) move it by."""
    check_int8_qat_attention(n, n)


def check_int8_qat_attention(n, seed, c=C, heads=HEADS, hid=HID, b=B):
    """The check of :func:`test_int8_qat_attention_above_256_matches_jax`
    at n tokens of ``b`` images, ``heads`` heads of c / heads."""
    x, block, table, g = calibrated_block(n, seed, c, heads, hid, b)
    scale = (c // heads) ** -0.5
    args = qat_attention_args(x, block)
    qs = table[0].numpy()
    out_j, vjp = jax.vjp(
        lambda *a: jfa.fused_attention_block_i8(*a, jnp.asarray(qs), heads,
                                                scale),
        *(jnp.asarray(a) for a in args))
    refs = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    out = fused_attention_block_i8(*leaves, torch.from_numpy(qs), heads,
                                   scale)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    d = np.abs(out.detach().numpy() - np.asarray(out_j))
    step = qs[4, 0] if qs[4, 2] else 0.0
    print(f"N={n}: output max abs {d.max():.3g}, "
          f"{(d > FWD_ATOL).mean():.5f} past {FWD_ATOL:g} (site 4 step "
          f"{step:.4g})")
    assert (d > FWD_ATOL).mean() <= FLIP_SHARE
    assert d.max() <= FWD_ATOL + step * (1 + 1e-6)
    # the context (site 2, quant_out) each package saves for dWp: JAX's
    # from its forward rule, the port's from its chain; a context element
    # that the two fp32 sums put on either side of a rint edge differs by
    # one step of site 2 (measured: 1 of 19200 at N=300), which moves dWp
    # by that step times a row of the upstream gradient, and nothing else
    # (dx and dWqkv do not read the snapped context)
    ctx_j = np.asarray(jfa._fwd_rule_i8(
        *(jnp.asarray(a) for a in args), jnp.asarray(qs), heads, scale,
        None)[1][6]).reshape(-1, c)
    ctx = pfa._forward_q(K.PLAIN, *(torch.from_numpy(a) for a in args),
                         heads, scale, torch.from_numpy(qs),
                         record=True)[1][0].numpy().reshape(-1, c)
    dctx = ctx - ctx_j
    flips = np.abs(dctx) > FWD_ATOL
    print(f"N={n}: {int(flips.sum())} of {dctx.size} context elements a "
          f"step of site 2 ({qs[2, 0]:.4g}) apart")
    assert flips.mean() <= FLIP_SHARE
    assert np.abs(dctx).max() <= FWD_ATOL + qs[2, 0] * (1 + 1e-6)
    for gr, r, name in zip(grads, refs, NAMES):
        gr, r = gr.numpy(), np.asarray(r)
        if name == "wp":
            gr = gr - dctx.T @ g.reshape(-1, c)
        diff = np.abs(gr - r)
        if name == "bqkv":
            # the key third: softmax ignores a per-row shift, so its
            # gradient is zero up to roundoff on both sides (ROADMAP C6)
            diff[c:2 * c], r = 0, np.concatenate([r[:c], r[2 * c:]])
        share = diff.max() / np.abs(r).max()
        print(f"N={n} d{name}: {share:.3g} of the leaf's scale")
        assert share <= GRAD_BAR, name


def converted_halves(n, seed, c=C, heads=HEADS, hid=HID, b=B):
    """A calibrated Block's converted weights (int8, per-tensor scales)
    and site table, and the block input x: the arguments of both
    converted halves in the port's and the JAX layout."""
    x, block, table, _ = calibrated_block(n, seed, c, heads, hid, b)
    sd = convert_params(block.state_dict(), QFormat.PyTorchINT8)
    a, f = "0.fn.", "1.fn."

    def w(name):
        return sd[name + ".weight"].t(), sd[name + ".weight_scale"]

    def half(norm, lin1, lin2, sites):
        w1, s1 = w(lin1)
        w2, s2 = w(lin2)
        port = [torch.from_numpy(x), sd[norm + ".weight"], sd[norm + ".bias"],
                w1, s1, sd[lin1 + ".bias"], w2, s2, sd[lin2 + ".bias"],
                sites]
        jax_args = [jnp.asarray(t.numpy()) for t in port[:-1]]
        rows = [tuple(jnp.asarray(v) for v in row.numpy()) for row in sites]
        return port, jax_args, [(s, z, h > 0.5) for s, z, h in rows], \
            (weight_colsum(w1), weight_colsum(w2))

    attn = half(a + "norm", a + "fn.to_qkv", a + "fn.to_out.0", table[0])
    mlp = half(f + "norm", f + "fn.net.0", f + "fn.net.3", table[1])
    return attn, mlp


def on_grid(label, got, ref, site):
    """The converted bar of tests/test_torch_int8_block.py on the grid of
    the output's site row (none without statistics)."""
    diff = np.abs(got.astype(np.float64) - ref.astype(np.float64))
    print(f"{label}: {np.mean(diff == 0):.5f} identical, max abs "
          f"{diff.max():.3g}")
    _on_grid(got, ref, float(site[0]) if site[2] > 0.5 else 0.0)


@pytest.mark.parametrize("half", ["attention", "mlp"])
@pytest.mark.parametrize("n", LENGTHS)
def test_converted_halves_above_256_match_jax(n, half):
    """``int8_attention_block`` / ``int8_mlp_block`` (the CPU's plain
    chain, the card's kernels with the long core's int8 mode) against the
    JAX K9 / K10 on the same int8 weights and sites."""
    check_converted_half(n, n + 1, half)


def check_converted_half(n, seed, half, c=C, heads=HEADS, hid=HID, b=B):
    """The check of :func:`test_converted_halves_above_256_match_jax` at n
    tokens of ``b`` images, ``heads`` heads of c / heads."""
    attn, mlp = converted_halves(n, seed, c, heads, hid, b)
    scale = (c // heads) ** -0.5
    port, jargs, jsites, colsums = attn if half == "attention" else mlp
    with torch.no_grad():
        if half == "attention":
            ref = jax_int8.int8_attention_block(*jargs, sites=jsites,
                                                heads=heads, scale=scale)
            got = int8_attention_block(*port, heads, scale, colsums=colsums)
            plain = int8_attention_block_plain(*port, heads, scale)
        else:
            ref = jax_int8.int8_mlp_block(*jargs, sites=jsites)
            got = int8_mlp_block(*port, colsums=colsums)
            plain = int8_mlp_block_plain(*port)
    torch.testing.assert_close(got, plain, rtol=0, atol=0)
    on_grid(f"{half} N={n}", got.numpy(), np.asarray(ref),
            port[-1][4].numpy())


# ------------------------------------------------- the tiny classifier

@pytest.fixture(scope="module")
def classifier():
    """The JAX INT8 ViT at 272 px (290 tokens), its params and fresh
    quant collection, and two images with their labels."""
    model = JaxViT(**KW, q_format=JaxQFormat.PyTorchINT8, dtype=jnp.float32)
    rng = np.random.RandomState(29)
    images = rng.uniform(-1, 1, (B, 272, 272, 3)).astype(np.float32)
    labels = rng.randint(0, 4, (B,)).astype(np.int32)
    variables = model.init(jax.random.PRNGKey(5), jnp.asarray(images))
    return dict(model=model, images=images, labels=labels,
                params=jax.tree_util.tree_map(np.array, variables["params"]),
                quant=jax.tree_util.tree_map(np.array, variables["quant"]))


def port_classifier(params, quant, converted=False):
    model = ViT(**KW, q_format="PyTorchINT8", converted=converted)
    model.load_state_dict(state_dict_from_jax(params, quant=quant),
                          strict=True)
    return model


# The two-pass step's first pass is the discrete calibrating forward,
# whose sites snap as they observe: at 290 tokens one qkv element that the
# two packages' fp32 sums put on either side of a rint edge of the
# to_qkv.act_out grid moves the context (measured: quant_out's max by
# 1.4e-4 relative) and, through the grids downstream, the later
# observers (decoder.norm's by 8e-3) and everything after them.  The
# step's second pass, the fused ops above 256 tokens, is held from the
# same observers in both packages (JAX's pass 1's, loaded into the port)
# to the two-pass bars; the observers up to the first snapped product's
# output (to_qkv.act_out) to 1e-5.
EARLY_SITES = ("quant_img", "quant_cls_token", "quant_pos_embedding",
               "cls_token_cat", "pos_embedding_cat", "pos_embedding_add",
               "patch_to_embedding.act_out",
               "transformer.layers.0.0.fn.norm.act_out",
               "transformer.layers.0.0.fn.fn.to_qkv.act_out")


@pytest.fixture(scope="module")
def two_pass_step(classifier):
    """One micro-batch of the two-pass QAT step: the JAX loss with
    ``MVT_INT8_QAT_FUSE=1`` (pass 2 through the fused Pallas kernels above
    256 tokens, differentiated op by op) from the fresh observers; the
    port's ``make_loss_fn`` from the same; and the port's pass 2 from
    JAX's pass-1 observers, differentiated."""
    m, params, quant = (classifier[k] for k in ("model", "params", "quant"))
    images, labels = classifier["images"], classifier["labels"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MVT_INT8_QAT_FUSE", "1")
        grad_fn = jax.value_and_grad(jax_loss_fn(m), has_aux=True)
    (loss_j, aux), grads_j = grad_fn(
        jax.tree_util.tree_map(jnp.asarray, params),
        jax.tree_util.tree_map(jnp.asarray, quant),
        {"image": jnp.asarray(images), "label": jnp.asarray(labels)},
        jax.random.PRNGKey(0))
    quant_j = jax.tree_util.tree_map(np.asarray, aux["quant"])
    logits_j, _ = m.apply({"params": params, "quant": quant_j},
                          jnp.asarray(images), calibrating=True,
                          int8_fused=True, mutable=["quant"])
    img = torch.from_numpy(images)
    label = torch.from_numpy(labels).long()
    model = port_classifier(params, quant)
    make_loss_fn(model)({"image": img, "label": label})[0].backward()
    with torch.no_grad():
        pass1 = port_classifier(params, quant)
        pass1(img, calibrating=True)
    from_j = port_classifier(params, quant_j)
    logits = from_j(img, int8_fused=True)
    loss = cross_entropy_loss(logits, label)
    loss.backward()
    return dict(model=model, pass1=pass1, from_j=from_j, quant_j=quant_j,
                loss=float(loss.detach()), loss_j=float(loss_j),
                logits=logits.detach().numpy(),
                logits_j=np.asarray(logits_j),
                grads_j=state_dict_from_jax(
                    jax.tree_util.tree_map(np.asarray, grads_j)))


def test_two_pass_observers_above_256_match_jax(two_pass_step):
    """The step's observers are its calibrating pass's, bit for bit (pass
    2 folds nothing), and up to to_qkv.act_out within 1e-5 of the JAX
    step's ``quant``; the later ones are printed (see above)."""
    sd = two_pass_step["model"].state_dict()
    ref = two_pass_step["pass1"].state_dict()
    for path, name in quant_site_names(KW["depth"]):
        site = two_pass_step["quant_j"]
        for p in path:
            site = site[p]
        for key in ("min", "max"):
            assert torch.equal(sd[f"{name}.{key}"], ref[f"{name}.{key}"])
            got, want = sd[f"{name}.{key}"].numpy(), site[key]
            if name in EARLY_SITES:
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7,
                                           err_msg=name)
            else:
                print(f"{name}.{key}: {abs(got - want) / abs(want):.3g} "
                      "relative")


def test_two_pass_loss_and_logits_above_256_match_jax(two_pass_step):
    """Pass 2 from JAX's pass-1 observers: the logits within 1e-4 plus one
    step of their grid of JAX's pass 2, the loss within 1e-6 relative."""
    ref = two_pass_step["logits_j"]
    d = np.abs(two_pass_step["logits"] - ref).max()
    step = float(np.ptp(ref)) / 255.0
    ours, theirs = two_pass_step["loss"], two_pass_step["loss_j"]
    print(f"{TOKENS} tokens: loss {ours!r} vs JAX {theirs!r}, logits "
          f"{d:.3g} apart (grid step {step:.3g})")
    assert d <= 1e-4 + step
    assert abs(ours - theirs) <= 1e-6 * abs(theirs)


def test_two_pass_gradients_above_256_match_jax(two_pass_step):
    """Pass 2 from JAX's pass-1 observers: every gradient within GRAD_BAR
    of its tensor's largest magnitude of the JAX step's (the key third of
    the qkv bias left out; the detection tokens, which a classifier's loss
    does not reach, zero on both sides)."""
    named = dict(two_pass_step["from_j"].named_parameters())
    worst, worst_name = 0.0, ""
    for name, r in two_pass_step["grads_j"].items():
        g = named[name].grad
        d = ((torch.zeros_like(r) if g is None else g) - r).abs()
        if name.endswith("to_qkv.bias"):
            d[C:2 * C] = 0
        share = float(d.max()) / max(float(r.abs().max()), 1e-30)
        if share > worst:
            worst, worst_name = share, name
    print(f"{TOKENS} tokens: largest gradient difference {worst:.3g} of its "
          f"tensor's scale, in {worst_name}")
    assert worst <= GRAD_BAR


def test_converted_classifier_above_256_matches_jax(classifier):
    """The converted classifier at 290 tokens (the converted K9 / K10 per
    block), calibrated on the images, against the JAX converted model
    (K9 / K10 in interpret mode) after a strict load: the logits under
    the converted bar on the head's grid, the same argmax; the kernels'
    path (the plain chain here) equal to ``plain``."""
    m, params = classifier["model"], classifier["params"]
    img = jnp.asarray(classifier["images"])
    _, upd = m.apply({"params": params, "quant": classifier["quant"]}, img,
                     calibrating=True, mutable=["quant"])
    quant = jax.tree_util.tree_map(np.asarray, upd["quant"])
    converted = jax.tree_util.tree_map(
        np.asarray, jax_convert(params, JaxQFormat.PyTorchINT8))
    jmodel = JaxViT(**KW, q_format=JaxQFormat.PyTorchINT8, converted=True,
                    dtype=jnp.float32)
    ref = np.asarray(jmodel.apply({"params": converted, "quant": quant},
                                  img))
    model = port_classifier(converted, quant, converted=True)
    with torch.no_grad():
        got = model(torch.from_numpy(classifier["images"]))
        assert torch.equal(got, model(torch.from_numpy(classifier["images"]),
                                      plain=True))
    on_grid(f"converted logits, {TOKENS} tokens", got.numpy(), ref,
            model.io_sites[3].numpy())
    np.testing.assert_array_equal(got.numpy().argmax(-1), ref.argmax(-1))
