"""Vision Transformer for classification, segmentation and detection, in
PyTorch:
eval and training forward in FP32, the PyTorchINT8 format's calibration,
simulation, two-pass QAT training and converted inference, and the
stateless float formats' (FP16_16, FP16_32, TF32) simulation, QAT
training and converted inference.

Port of myrtle_vision_tpu/models/vit.py for the paths this package runs
so far: ``decoder="classification"`` in
``q_format`` FP32 (inference and training), PyTorchINT8 (the calibrating
forward, the simulation's eval forward, QAT training, and the converted
model up to the fused Block's length) and the float formats (inference
and QAT training), ``decoder="segmentation"`` (the Segmenter linear head
on every patch token, its logits upsampled bilinearly to NHWC pixel
logits) and ``decoder="detection"`` (YOLOS: det tokens after the
patches, the class and box heads on them) in FP32, in the float formats
and in PyTorchINT8 before convert (the one-pass QAT step and the
simulation's eval forward).  Parameters are named as in
the upstream reference state dict that myrtle_vision_tpu/utils/export.py
writes
(``transformer.layers.{i}.0.fn.fn.to_qkv.weight``, ...), so
``load_state_dict(sd, strict=True)`` takes such a dict as it is.

FP32: activations run in ``compute_dtype`` (bf16 by default, or
float32) with fp32 LayerNorm statistics, softmax and accumulation,
rounding at the points the JAX model rounds.  Where the JAX Block fuses
(``fuses_at`` of ops/fused_attention_block.py), each block half runs as
one differentiable op (ops/fused_attention_block.py, ops/fused_mlp.py),
which dispatches on the activation's device: the plain PyTorch chain on
the CPU, the CUDA kernel chain on a GPU (the bf16 chain, or on float32
activations the fp32 chain that snaps nothing), forward and backward.
Longer sequences (detection at 800 px: 2601 tokens), ``MVT_NO_FUSE=1``
(read at each call, as the JAX Block reads it while tracing), attention
capture and active dropout take the JAX Block's discrete-site
composition: LayerNorm, the projections and the exact-erf GELU as plain
products, as XLA runs them there, and the attention core through
``multi_head_attention`` (ops/attention.py), i.e. the flash kernel of
the compute dtype (or, capturing, the ``xla`` core).  The port reads no
``JAX_DEFAULT_MATMUL_PRECISION``: an fp32 product outside the kernels is
a full fp32 ``torch.matmul`` (TF32 off, PyTorch's default), so float32
compute under ``MVT_NO_FUSE=1`` is the JAX package's true-fp32 recipe.

Dropout (``forward(img, dropout_rng=g)``, ``g`` a ``torch.Generator`` on
the model's device; the JAX ``deterministic=False`` with its "dropout"
rng) acts at the JAX model's four sites, in its order: the tokens after
the positions (``emb_dropout``), and in each block the attention after
its output projection, the MLP after the GELU and after fc2
(``dropout``).  Each keeps an element with probability 1 - rate and
scales it by 1 / (1 - rate) in the activation's dtype, as flax's
``nn.Dropout`` does; the masks come from ``g`` only.  Without ``g`` (the
JAX ``deterministic=True``) no site acts.  An active ``dropout`` keeps
every Block discrete, as the JAX gate does.

Attention capture (``forward(img, capture_attention=True)``, the JAX
``capture_attention`` with its sown ``attn_probs``) returns the output
and a list of each layer's fp32 (B, H, N, N) softmax probabilities in
depth order, every Block discrete with the ``xla`` core.

PyTorchINT8 (compute in fp32, as in the JAX package): every observer
site of the JAX model is an :class:`ActQuant` (``min`` and ``max``
buffers) on the module it belongs to, named as the JAX ``quant``
collection names it (utils/convert.py maps one onto the other):
``quant_img``, ``quant_cls_token``, ``quant_pos_embedding``,
``cls_token_cat``, ``pos_embedding_cat``, ``pos_embedding_add`` on the
model; ``act_out`` on every Linear and LayerNorm and on the GELU
(``net.1``); ``quant_out`` on the attention; ``res_add`` on each
residual (``transformer.layers.{i}.0`` and ``.1``).
``forward(img, calibrating=True)`` runs the JAX model's discrete-site
forward, folding each site's input into its observer first: the 3-pass
bf16 products (ops/high_precision.py), the polynomial-erf GELU, the fp32
attention core, all in plain PyTorch on any device, as the JAX package
runs it outside any kernel.  ``forward(img)`` is the simulation's eval
forward, the same composition with the observers frozen, full fp32
products (the JAX HIGHEST dot) and the exact-erf GELU, as the JAX QDense
and QGelu run it with ``calibrating=False``.  ``forward(img,
int8_fused=True)`` is the second pass of the two-pass QAT step
(training/classification.py): the calibrating forward's operations with
the observers as the first pass left them, each block half one
differentiable op with the frozen site table
(ops/fused_attention_block.py ``fused_attention_block_i8``,
ops/fused_mlp.py ``fused_mlp_block_i8``: the TPU kernels K1-K4 with
``qspec="int8"``), the weights through their symmetric int8 fake-quant,
every site straight-through; past the fused gate a block runs the
calibrating composition with the observers frozen, as the JAX Block's
discrete branch does there.  ``forward(img, calibrating=True)`` recording
gradients is the one-pass QAT step, which the detector trains with (JAX
training/detection.py): the observers fold in each micro-batch as the
forward runs, every product and the attention core keep their 3-pass
backward, every site is straight-through.  With ``converted=True`` each
Linear weight is int8 with an fp32 ``weight_scale``
(quantize.convert_params), and the forward is the converted model's: the
patch embedding and the head as int8 products (``gemm_s8_epilogue``, the
integer path of QDense), each
block half as one op (ops/fused_int8_block.py, the TPU kernels K9 and
K10) where the JAX Block's ``int8_fuse`` gate holds; under attention
capture, ``MVT_NO_FUSE=1``, ``MVT_INT8_FUSE=0`` or past ``fuses_at`` the
Block's discrete form (:meth:`Block.forward_converted_discrete`): each
projection through ``gemm_s8_epilogue`` (its LayerNorm through
``layernorm_quant_rows``), the fp32 ``xla`` core and the requant sites as
PyTorch operations.  The observers of a converted model are frozen:
their grids, which of them have statistics, and the weights' column sums
are computed when its state dict is loaded.

The stateless float formats (compute in fp32) have no state: each site
is a function of its input (quantize.act_quant), which on the card runs
K11 (``fake_quant_rows``), as does each weight's fake-quant
(quantize.quantize_weight).  Outside the blocks the JAX model's
discrete sites run as it runs them (QDense: the pre_linear snap, the
weight's snap, the 3-pass product, the bias, the post_op snap;
QLayerNorm, the token sites), the products as plain PyTorch, as XLA runs
them there; where the JAX Block fuses, each block half is one op with
the format's ``qspec`` (ops/fused_attention_block.py, ops/fused_mlp.py,
the TPU kernels K1 and K3 with their snaps, K2 and K4 for their
backward), and beyond the gate the Block's discrete sites run the same
way, with the fp32 ``xla`` attention core (ops/attention.py).  The simulation
trains (QAT): every site and weight fake-quant is straight-through
(ops/fake_quant.py), the products outside the blocks take
``matmul_high3``'s 3-pass backward, and the fused ops their own.
``forward(img, calibrating=True)`` is the same forward: these formats
have no observers to update.  With
``converted=True`` the Linear and LayerNorm weights are stored as fp16
(FP16_16, FP16_32) or as TF32 values in fp32 (quantize.convert_params),
cast to fp32 on use, and snapped again as the JAX model snaps them
(idempotent).

``forward(img, distill_token=t)`` is the DeiT student
(models/distill.py): ``t``, (1, 1, dim), goes after every other token
once the positions are added, so it carries none, the blocks run on the
longer sequence (198 tokens at 224 px), and the forward returns the
logits and the token's fp32 embedding after the last block, as the JAX
ViT does.  In a quantized format the token passes the JAX model's two
sites first: ``quant_distill_token`` (a stub) on the token, then
``distill_token_cat`` (a functional site) on the sequence with it; in
the float formats they are stateless snaps, in PyTorchINT8 observers
that a student carries (:meth:`ViT.add_distill_sites`, which
models/distill.py's wrapper calls).  A converted PyTorchINT8 model takes
no token: the CLIs evaluate and convert a student as a plain ViT.

Tensor parallelism (parallel/tp.py): a Block given its place in a model
group (``Block.tp``, set by ``parallel.tp.enable``) runs in training in
the form :meth:`Block.tp_form` names, from what it would run alone: a
fusing Block head-sharded where the fused gate held (the JAX Block's
``tp_axis`` branch: each half on its local heads and hidden columns with
``res_scale`` 1/n_tp, the partial outputs summed over the group), else
whole on every rank; a discrete Block (any format) split Megatron-style
where heads and ``mlp_dim`` divide (``parallel.tp.Split``: the
LayerNorms replicated, ``to_qkv`` and ``fc1`` on the local columns,
attention on the local heads, ``to_out`` and ``fc2`` an fp32 partial
product summed over the group before the rounding, the bias, the snaps,
dropout and the residual add; the INT8 observers of the split
activations fold the group's MIN / MAX), else whole.  Those are the
results of the JAX trainer's GSPMD branch, which partitions the XLA dots
and gathers around the Pallas calls.  Evaluation (``model.eval()``) runs
the whole Block on every rank, as the JAX CLIs evaluate the model
without ``tp_axis``.

Images are NHWC, as in the JAX package.  ``forward(img, plain=True)``
runs the plain PyTorch versions on any device, as the reference the
kernels are checked against.  The patch embedding, the tokens and the
head of the FP32 model are plain products outside any kernel in both
packages, and take their gradients from autograd.
"""
from __future__ import annotations

import os

import torch
from torch import nn

from myrtle_vision_tpu_torch.ops import _kernels as K
from myrtle_vision_tpu_torch.ops._kernels import layernorm_rows_plain
from myrtle_vision_tpu_torch.ops.attention import multi_head_attention
from myrtle_vision_tpu_torch.ops.flash_attention import flash_attention
from myrtle_vision_tpu_torch.ops.fused_attention_block import (
    fused_attention_block,
    fused_attention_block_i8,
    fused_attention_block_i8_plain,
    fused_attention_block_plain,
    fuses_at,
)
from myrtle_vision_tpu_torch.ops.fused_mlp import (
    fused_mlp_block,
    fused_mlp_block_i8,
    fused_mlp_block_i8_plain,
    fused_mlp_block_plain,
)
from myrtle_vision_tpu_torch.ops.fused_int8_block import (
    int8_attention_block,
    int8_attention_block_plain,
    int8_mlp_block,
    int8_mlp_block_plain,
    weight_colsum,
)
from myrtle_vision_tpu_torch.ops.high_precision import (
    matmul_fp32,
    matmul_high3,
)
from myrtle_vision_tpu_torch.parallel import tp as tp_lib
from myrtle_vision_tpu_torch.ops.interpolate import (
    resize_bicubic,
    resize_bilinear,
)
from myrtle_vision_tpu_torch.quantize import (
    QSPECS,
    ActQuant,
    QFormat,
    act_quant,
    affine_uint8_qparams,
    is_observer,
    quantize_weight,
    site_row,
    symmetric_int8_scale,
)

MIN_NUM_PATCHES = 16  # reference vit.py:14
# a discrete Block alone: parallel.tp.Split's identity
_NO_SPLIT = tp_lib.Split()
# a DeiT student's observers of its distillation token (PyTorchINT8)
DISTILL_SITES = ("quant_distill_token", "distill_token_cat")
# the weights a converted float model stores in fp16
_FP16_STORAGE = (QFormat.FP16_16, QFormat.FP16_32)


def no_fuse() -> bool:
    """``MVT_NO_FUSE=1``: every Block takes its discrete-site composition
    (the JAX Block reads the variable when it traces, the port at each
    call)."""
    return os.environ.get("MVT_NO_FUSE") == "1"


def no_int8_fuse() -> bool:
    """``MVT_INT8_FUSE=0``: the converted PyTorchINT8 Block takes its
    discrete form (the JAX Block's ``int8_fuse`` gate)."""
    return os.environ.get("MVT_INT8_FUSE") == "0"


def dropout_mask(shape, rate, generator, device):
    """flax ``nn.Dropout``'s keep mask: each element kept with probability
    1 - ``rate``, from ``generator`` (on ``device``), never from the global
    RNG."""
    u = torch.rand(shape, generator=generator, device=device)
    return u < 1.0 - rate


def dropout(x, rate, generator, split=_NO_SPLIT):
    """A dropout site: with ``generator`` and ``rate`` > 0, the kept
    elements of :func:`dropout_mask` scaled by 1 / (1 - rate) in x's
    dtype and the others 0; else x as it is.  ``split``: ``x`` is this
    rank's local columns (``parallel.tp.Split``), so the mask is drawn at
    the whole width, as on every rank of the group from the same
    generator state, and its local columns kept."""
    if generator is None or rate == 0.0:
        return x
    shape = (*x.shape[:-1], x.shape[-1] * split.size)
    keep = split.local_cols(dropout_mask(shape, rate, generator, x.device),
                            x)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def _attention(q, k, v, scale, probs, impl="auto", plain=False):
    """The discrete Block's core: with ``probs`` (a list, attention
    capture) the ``xla`` core, its probabilities appended; else
    ``multi_head_attention`` with ``impl`` (``plain`` FP32: the flash
    kernel's plain version)."""
    if probs is not None:
        out, p = multi_head_attention(q, k, v, scale, return_probs=True)
        probs.append(p)
        return out
    if plain and impl == "auto":
        return flash_attention(q, k, v, scale, plain=True)
    return multi_head_attention(q, k, v, scale, impl=impl)


def _linear(in_features, out_features, device):
    # parameters are set by ViT.reset_parameters from an explicit
    # generator, never from torch's global one
    return nn.utils.skip_init(nn.Linear, in_features, out_features,
                              device=device or "cpu")


def _layernorm(dim, device):
    return nn.utils.skip_init(nn.LayerNorm, dim, eps=1e-5,
                              device=device or "cpu")


def _dense(x, linear, dtype, split=_NO_SPLIT, part="cols", sections=1):
    """QDense in FP32 mode: operands rounded to ``dtype``, fp32
    accumulation, the product rounded to ``dtype``, then the bias added
    in ``dtype``.  Under a ``split`` (``parallel.tp.Split``) ``part``
    "cols" takes the local output features (``sections`` of them, the
    [q|k|v] of to_qkv), "rows" the local input features, whose fp32
    partial product is summed over the group before the rounding and the
    bias."""
    if part == "rows":
        p = torch.matmul(x.to(dtype).float(),
                         split.rows(linear.weight).to(dtype).float().t())
        return split.reduce(p).to(dtype) + split.whole(linear.bias).to(dtype)
    w = split.cols(linear.weight, sections)
    y = torch.matmul(x.to(dtype).float(), w.to(dtype).float().t())
    return y.to(dtype) + split.cols(linear.bias, sections).to(dtype)


def _make_int8(linear):
    """Converted storage of a Linear: an int8 weight (no gradient), its
    fp32 per-tensor ``weight_scale``, and the weight's column sums, which
    are not stored but computed when the model is loaded."""
    shape, device = linear.weight.shape, linear.weight.device
    linear.weight = nn.Parameter(
        torch.zeros(shape, dtype=torch.int8, device=device),
        requires_grad=False)
    linear.register_buffer("weight_scale", torch.ones((), device=device))
    linear.register_buffer("weight_colsum", torch.zeros(shape[0],
                                                        device=device),
                           persistent=False)


def _qdense(linear, x, calibrating=True, update=None, split=_NO_SPLIT,
            part="cols", sections=1):
    """QDense of the PyTorchINT8 simulation: the Linear's weight through
    its symmetric int8 fake-quant (straight-through), the product, the
    bias, then the ``act_out`` site.  ``calibrating`` (the JAX
    ``calibrating=True``): a 3-pass product, the site observing the result
    first unless ``update`` is False (the QAT step's second pass, its
    observers frozen); else the eval forward's full fp32 product (the JAX
    HIGHEST dot), the observers frozen.  ``split``, ``part`` and
    ``sections`` as in :func:`_dense`: the weight's scale is the whole
    weight's, and a local output's site observes the group's MIN / MAX."""
    w = quantize_weight(linear.weight, QFormat.PyTorchINT8, "linear", False)
    mm = matmul_high3 if calibrating else matmul_fp32
    update = calibrating if update is None else update
    if part == "rows":
        y = split.reduce(mm(x, split.rows(w).t())) + split.whole(linear.bias)
        return linear.act_out(y, update)
    y = mm(x, split.cols(w, sections).t()) + split.cols(linear.bias,
                                                         sections)
    return linear.act_out(y, update, split.group)


def _make_fp16(module):
    """Converted FP16_16 / FP16_32 storage of a Linear or LayerNorm weight
    (no gradient; the bias stays fp32, as convert leaves it)."""
    w = module.weight
    module.weight = nn.Parameter(
        torch.zeros(w.shape, dtype=torch.float16, device=w.device),
        requires_grad=False)


def _qdense_float(linear, x, q_format, converted, plain, split=_NO_SPLIT,
                  part="cols", sections=1):
    """QDense in a stateless float format, fp32 (..., K) in and out: the
    pre_linear snap, the weight's fake-quant, the 3-pass product, the
    bias, the post_op snap.  ``split``, ``part`` and ``sections`` as in
    :func:`_dense` (each snap is elementwise)."""
    x = act_quant(x, q_format, "pre_linear", plain)
    w = quantize_weight(linear.weight, q_format, "linear", converted, plain)
    if part == "rows":
        y = split.reduce(matmul_high3(x, split.rows(w).float().t()))
        y = y + split.whole(linear.bias)
    else:
        y = matmul_high3(x, split.cols(w, sections).float().t())
        y = y + split.cols(linear.bias, sections)
    return act_quant(y, q_format, "post_op", plain)


def _qlayernorm_float(norm, x, q_format, converted, plain):
    """QLayerNorm in a stateless float format, fp32 (..., C) in and out: the
    pre_linear snap, the scale's fake-quant (only when converted), the
    LayerNorm, the post_op snap."""
    y = act_quant(x, q_format, "pre_linear", plain)
    scale = quantize_weight(norm.weight, q_format, "norm", converted, plain)
    return act_quant(layernorm_rows_plain(y, scale.float(), norm.bias),
                     q_format, "post_op", plain)


def _int8_dense(kern, linear, x, in_site, out_site, in_has):
    """QDense._int8_forward of the converted model, fp32 (..., K) in and
    out: with statistics at the input's site ``in_site`` the int8 product
    of ``gemm_s8_epilogue`` (``kern``), requantized at ``out_site``
    (``act_out``); without, the JAX fallback, a 3-pass product of the
    dequantized weight and the ``act_out`` fake-quant."""
    lead = x.shape[:-1]
    if in_has:
        q8 = K.quantize_i8(x.reshape(-1, x.shape[-1]), in_site)
        y = kern.gemm_s8(q8, linear.weight.t(), linear.weight_colsum,
                         linear.weight_scale, in_site, linear.bias,
                         "requant", out_site)
        return y.view(*lead, -1)
    w = linear.weight.float() * linear.weight_scale
    return linear.act_out(matmul_high3(x, w.t()) + linear.bias)


def _int8_norm_dense(kern, norm, linear, x, norm_site, out_site, has):
    """QLayerNorm, then QDense._int8_forward on its grid, fp32 (rows, C)
    in and out: with statistics at the norm's site the integers that the
    LayerNorm, its fake-quant and ``rint(x/s) + zp`` give, from
    ``layernorm_quant_rows`` (``kern``), into :func:`_int8_dense`'s int8
    product; without, the plain LayerNorm (its site passes it through)
    and the fallback product."""
    if not has:
        y = K.requant(layernorm_rows_plain(x, norm.weight, norm.bias),
                      norm_site)
        return _int8_dense(kern, linear, y, norm_site, out_site, False)
    q8 = kern.layernorm_quant_rows(x, norm.weight, norm.bias, norm_site)
    return kern.gemm_s8(q8, linear.weight.t(), linear.weight_colsum,
                        linear.weight_scale, norm_site, linear.bias,
                        "requant", out_site)


def _decode(x, distill_token, decode):
    """The head ``decode`` on the tokens after the last block; a student's
    (``distill_token`` given) on every token but the last, returned with
    that token's fp32 embedding (the JAX ViT's distill split)."""
    if distill_token is None:
        return decode(x)
    return decode(x[:, :-1]), x[:, -1].float()


class Residual(nn.Module):
    """Name container of the reference (``layers.{i}.{0,1}.fn``)."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn


class PreNorm(nn.Module):
    """Name container of the reference (``.norm`` and ``.fn``)."""

    def __init__(self, dim, fn, device=None):
        super().__init__()
        self.norm = _layernorm(dim, device)
        self.fn = fn


class Attention(nn.Module):
    """Fused-QKV attention parameters (reference vit.py:59-99)."""

    def __init__(self, dim, heads, dim_head, dropout, device=None):
        super().__init__()
        inner = dim_head * heads
        if inner != dim:
            raise ValueError(
                "attention inner dim must equal model dim (heads * dim_head "
                f"= {inner}, dim = {dim})"
            )
        self.to_qkv = _linear(dim, inner * 3, device)
        self.to_out = nn.Sequential(_linear(inner, dim, device),
                                    nn.Dropout(dropout))


class FeedForward(nn.Module):
    """Linear -> GELU -> Dropout -> Linear -> Dropout parameters
    (reference vit.py:44-56)."""

    def __init__(self, dim, hidden_dim, dropout, device=None):
        super().__init__()
        self.net = nn.Sequential(
            _linear(dim, hidden_dim, device), nn.GELU(), nn.Dropout(dropout),
            _linear(hidden_dim, dim, device), nn.Dropout(dropout),
        )


class Block(nn.Module):
    """Pre-norm transformer block (myrtle_vision_tpu/models/vit.py Block).
    Children ``0`` and ``1`` carry the reference's parameter names.
    FP32: one fused op per half (the JAX Block's ``fuse`` branch) where
    ``fuses_at`` holds and no capture, active dropout or ``MVT_NO_FUSE=1``
    stops it, else the discrete-site composition
    (:meth:`forward_discrete`); ``depth``, the model's layer count, sizes
    the attention op's qkv-saving budget as ``model_depth`` does in the
    JAX Block.  Each forward takes ``dropout_rng`` (the model's dropout
    generator, or None) and ``probs`` (a list that attention capture
    fills, or None).
    With ``tp`` set (parallel/tp.py ``TensorParallel``), in training:
    the form :meth:`tp_form` names (head-sharded, :meth:`forward_tp`;
    split; or whole on every rank of the model group).
    PyTorchINT8: the observer sites (see the module docstring), the
    discrete-site forward, calibrating or the simulation's eval
    (:meth:`forward_int8`), the two-pass QAT step's second pass, one op
    per half with the frozen sites (:meth:`forward_int8_qat`, the
    ``int8_qat_fuse`` branch) and, converted, one INT8 op per half
    (:meth:`forward_converted`, the ``int8_fuse`` branch) or elsewhere
    the discrete converted form (:meth:`forward_converted_discrete`).  A
    stateless
    float format: one op per half with the format's ``qspec``
    (:meth:`forward_float`, the ``fuse`` branch)."""

    def __init__(self, dim, heads, dim_head, mlp_dim, dropout, depth,
                 device=None, q_format=QFormat.FP32, converted=False):
        super().__init__()
        self.heads = heads
        self.dim_head = dim_head
        self.scale = dim_head ** -0.5
        self.depth = depth
        self.dropout = dropout
        self.q_format = q_format
        self.converted = converted
        self.tp = None  # this rank's model group under tensor parallelism
        self.add_module("0", Residual(PreNorm(
            dim, Attention(dim, heads, dim_head, dropout, device), device)))
        self.add_module("1", Residual(PreNorm(
            dim, FeedForward(dim, mlp_dim, dropout, device), device)))
        if q_format == QFormat.PyTorchINT8:
            for module, name in self._sites():
                setattr(module, name, ActQuant(device))
            if converted:
                for linear in self._linears():
                    _make_int8(linear)
                # whether the input sites of to_qkv, to_out, fc1 and fc2
                # have statistics, read on the host once, when a state
                # dict is loaded (fresh observers have none)
                self.input_has = (False,) * 4
                self.register_load_state_dict_post_hook(
                    Block._read_input_has)
        if converted and q_format in _FP16_STORAGE:
            for module in self._linears() + [self._modules["0"].fn.norm,
                                             self._modules["1"].fn.norm]:
                _make_fp16(module)

    def _sites(self):
        """(module, observer name) of the ten sites, in the order of the
        TPU kernels' site rows: attention 0-4, then MLP 0-4."""
        a, f = self._modules["0"], self._modules["1"]
        net = f.fn.fn.net
        return [(a.fn.norm, "act_out"), (a.fn.fn.to_qkv, "act_out"),
                (a.fn.fn, "quant_out"), (a.fn.fn.to_out[0], "act_out"),
                (a, "res_add"),
                (f.fn.norm, "act_out"), (net[0], "act_out"),
                (net[1], "act_out"), (net[3], "act_out"), (f, "res_add")]

    def _linears(self):
        attn, net = self._modules["0"].fn.fn, self._modules["1"].fn.fn.net
        return [attn.to_qkv, attn.to_out[0], net[0], net[3]]

    @staticmethod
    def _read_input_has(block, _keys):
        """The has_stats flags of the discrete converted form's product
        inputs (rows 0 and 2 of each half of :meth:`site_table`)."""
        flags = block.site_table()[:, (0, 2), 2].flatten().tolist()
        block.input_has = tuple(v > 0.5 for v in flags)

    def site_table(self):
        """(2, 5, 3) fp32: the (scale, zero point, has_stats) rows of the
        attention and the MLP half's sites, computed on the observers'
        device from their buffers (each row :func:`site_row` of its
        observer; nothing read on the host)."""
        observers = [getattr(m, n) for m, n in self._sites()]
        lo = torch.stack([o.min for o in observers])
        hi = torch.stack([o.max for o in observers])
        scale, zp = affine_uint8_qparams(lo, hi)
        return torch.stack([scale, zp, (lo <= hi).float()], -1).view(2, 5, 3)

    def fuses(self, x, dropout_rng=None, probs=None):
        """The JAX Block's gate: ``fuses_at`` the sequence, no attention
        capture, no active dropout, no ``MVT_NO_FUSE=1``."""
        return (probs is None and not no_fuse()
                and (self.dropout == 0.0 or dropout_rng is None)
                and fuses_at(x.shape[1], self.heads, self.dim_head))

    def tp_form(self, fuses: bool) -> str:
        """Under a model group (``tp``), in training, how this Block runs
        where it would run alone fused (``fuses``) or discrete
        (parallel/tp.py): "sharded" (fused, the fused gate held: each
        half head-sharded, :meth:`forward_tp`), "split" (discrete, heads
        and ``mlp_dim`` divisible by the group: ``parallel.tp.Split``) or
        "whole" (the Block whole on every rank of the group)."""
        if fuses:
            return "sharded" if self.tp.fused else "whole"
        n = self.tp.size
        mlp_dim = self._modules["1"].fn.fn.net[0].out_features
        return "split" if self.heads % n == mlp_dim % n == 0 else "whole"

    def _over_group(self) -> bool:
        return self.tp is not None and self.training

    def _whole(self, fn, x):
        """``fn(x)`` whole on every rank of the model group: the
        parameters' gradients scaled by 1/n_tp (the group sums them), the
        input's whole.  Alone, or in evaluation, ``fn(x)``."""
        if not self._over_group():
            return fn(x)
        n = self.tp.size
        return tp_lib.scale_grad(fn(tp_lib.scale_grad(x, float(n))), 1.0 / n)

    def _discrete(self, fn, x, *args):
        """A discrete composition ``fn(x, *args, split)``: alone, or over
        the model group in training split (``parallel.tp.Split``) or
        whole, as :meth:`tp_form` says."""
        if self._over_group() and self.tp_form(False) == "split":
            return fn(x, *args, tp_lib.Split(self.tp))
        return self._whole(lambda t: fn(t, *args, _NO_SPLIT), x)

    def forward_int8(self, x, calibrating=True, update=None,
                     dropout_rng=None, probs=None):
        """The JAX Block's discrete-site composition for PyTorchINT8
        before convert (:meth:`_int8_discrete`), alone or over the model
        group (:meth:`_discrete`)."""
        return self._discrete(self._int8_discrete, x, calibrating, update,
                              dropout_rng, probs)

    def _int8_discrete(self, x, calibrating, update, dropout_rng, probs,
                       split):
        """The JAX Block's discrete-site composition for PyTorchINT8
        before convert, fp32 (B, N, C) in and out, differentiable.
        ``calibrating`` (the JAX ``calibrating=True``): every site folds its
        input into its observer, then fake-quantizes it; 3-pass products
        with their 3-pass backward, the polynomial erf.  Else the
        simulation's eval forward: the observers frozen, full fp32 products
        (the JAX HIGHEST dot) and the exact erf, as the JAX QDense and
        QGelu switch them.  ``update`` False keeps the observers as they are
        in a calibrating forward (the QAT step's second pass).  The
        attention core is the fp32 ``xla`` core of ops/attention.py in both
        (3-pass products, ``jax.nn.softmax``'s backward).  Every site is
        straight-through.  ``split``: ``parallel.tp.Split``."""
        update = calibrating if update is None else update
        a, f = self._modules["0"], self._modules["1"]
        attn, net = a.fn.fn, f.fn.fn.net
        sp = split
        b, n, _ = x.shape
        y = a.fn.norm.act_out(layernorm_rows_plain(
            sp.replicated(x), a.fn.norm.weight, a.fn.norm.bias), update)
        qkv = _qdense(attn.to_qkv, y, calibrating, update, sp, sections=3)
        qh, kh, vh = qkv.view(b, n, 3, self.heads // sp.size,
                              -1).permute(2, 0, 3, 1, 4)
        ctx = _attention(qh, kh, vh, self.scale, probs, impl="xla")
        ctx = attn.quant_out(ctx.transpose(1, 2).reshape(b, n, -1), update,
                             sp.group)
        y = dropout(_qdense(attn.to_out[0], ctx, calibrating, update, sp,
                            "rows"), self.dropout, dropout_rng)
        x = a.res_add(y + x, update)
        y = f.fn.norm.act_out(layernorm_rows_plain(
            sp.replicated(x), f.fn.norm.weight, f.fn.norm.bias), update)
        h = _qdense(net[0], y, calibrating, update, sp)
        g = K.gelu_poly(h) if calibrating else \
            torch.nn.functional.gelu(h)
        g = dropout(net[1].act_out(g, update, sp.group), self.dropout,
                    dropout_rng, sp)
        y = dropout(_qdense(net[3], g, calibrating, update, sp, "rows"),
                    self.dropout, dropout_rng)
        return f.res_add(y + x, update)

    def forward_int8_qat(self, x, plain=False):
        """The JAX Block's ``int8_qat_fuse`` branch, the second pass of
        the two-pass INT8 QAT step, fp32 (B, N, C) in and out: each Linear
        weight through its symmetric int8 fake-quant (straight-through),
        then one op per half with the site table of the observers, which
        the first pass has updated and this pass leaves as they are.  Past
        the fused gate the JAX Block runs its discrete composition there
        too: :meth:`forward_int8`, calibrating with the observers frozen
        (their grids are pass 1's, as the JAX pass's idempotent updates
        leave them)."""
        if not self.fuses(x):
            return self.forward_int8(x, calibrating=True, update=False)
        return self._whole(lambda t: self._int8_qat_fused(t, plain), x)

    def _int8_qat_fused(self, x, plain):
        a, f = self._modules["0"].fn, self._modules["1"].fn
        qkv, out = a.fn.to_qkv, a.fn.to_out[0]
        fc1, fc2 = f.fn.net[0], f.fn.net[3]

        def qw(linear):
            return quantize_weight(linear.weight, QFormat.PyTorchINT8,
                                   "linear", False).t()

        attn_op = fused_attention_block_i8_plain if plain else \
            fused_attention_block_i8
        mlp_op = fused_mlp_block_i8_plain if plain else fused_mlp_block_i8
        sites = self.site_table().detach()
        x = attn_op(x, a.norm.weight, a.norm.bias, qw(qkv), qkv.bias, qw(out),
                    out.bias, sites[0], self.heads, self.scale, self.depth)
        return mlp_op(x, f.norm.weight, f.norm.bias, qw(fc1), fc1.bias,
                      qw(fc2), fc2.bias, sites[1])

    def forward_converted(self, x, sites, plain=False, probs=None):
        """The converted model's block, fp32 (B, N, C) in and out;
        ``sites`` is :meth:`site_table` as loaded.  Where the JAX Block's
        ``int8_fuse`` gate holds (:meth:`fuses`, and no
        ``MVT_INT8_FUSE=0``), one INT8 op per half; else its discrete
        form (:meth:`forward_converted_discrete`)."""
        if not self.fuses(x, probs=probs) or no_int8_fuse():
            return self.forward_converted_discrete(x, sites, plain, probs)
        x = self.converted_attention(x, sites, plain)
        return self.converted_mlp(x, sites, plain)

    def forward_converted_discrete(self, x, sites, plain=False, probs=None):
        """The JAX converted Block's discrete form, fp32 (B, N, C) in and
        out, inference only.  Attention: QLayerNorm and to_qkv's
        ``_int8_forward`` (:func:`_int8_norm_dense`), the fp32 ``xla``
        core (capturing, its probabilities appended to ``probs``), the
        quant_out site, to_out's ``_int8_forward`` (:func:`_int8_dense`)
        on that site's grid, the residual and its res_add site.  MLP: the
        norm and fc1 likewise, the exact-erf GELU and its site, fc2 on
        that grid, the residual and its site.  The int8 products and the
        LayerNorm's quantize run ``gemm_s8_epilogue`` and
        ``layernorm_quant_rows`` on the card unless ``plain``; the core,
        the GELU and the requants are PyTorch operations, as XLA runs them
        in the JAX package.  A product whose input site has no statistics
        takes the JAX fallback (:func:`_int8_dense`)."""
        kern = K.PLAIN if plain else K.for_device(x)
        a, f = self._modules["0"], self._modules["1"]
        attn, net = a.fn.fn, f.fn.fn.net
        has = self.input_has
        b, n, c = x.shape
        x = x.reshape(b * n, c)
        s = sites[0]
        qkv = _int8_norm_dense(kern, a.fn.norm, attn.to_qkv, x, s[0], s[1],
                               has[0])
        qh, kh, vh = qkv.view(b, n, 3, self.heads, -1).permute(2, 0, 3, 1, 4)
        ctx = _attention(qh, kh, vh, self.scale, probs, impl="xla")
        ctx = K.requant(ctx.transpose(1, 2).reshape(b * n, c), s[2])
        y = _int8_dense(kern, attn.to_out[0], ctx, s[2], s[3], has[1])
        x = K.requant(y + x, s[4])
        s = sites[1]
        h = _int8_norm_dense(kern, f.fn.norm, net[0], x, s[0], s[1], has[2])
        g = K.requant(torch.nn.functional.gelu(h), s[2])
        y = _int8_dense(kern, net[3], g, s[2], s[3], has[3])
        return K.requant(y + x, s[4]).view(b, n, c)

    def converted_attention(self, x, sites, plain=False):
        """The converted block's attention half (K9's op)."""
        a = self._modules["0"].fn
        qkv, out = a.fn.to_qkv, a.fn.to_out[0]
        op = int8_attention_block_plain if plain else int8_attention_block
        return op(
            x, a.norm.weight, a.norm.bias,
            qkv.weight.t(), qkv.weight_scale, qkv.bias,
            out.weight.t(), out.weight_scale, out.bias, sites[0],
            self.heads, self.scale,
            colsums=(qkv.weight_colsum, out.weight_colsum),
        )

    def converted_mlp(self, x, sites, plain=False):
        """The converted block's MLP half (K10's op)."""
        f = self._modules["1"].fn
        fc1, fc2 = f.fn.net[0], f.fn.net[3]
        op = int8_mlp_block_plain if plain else int8_mlp_block
        return op(
            x, f.norm.weight, f.norm.bias,
            fc1.weight.t(), fc1.weight_scale, fc1.bias,
            fc2.weight.t(), fc2.weight_scale, fc2.bias, sites[1],
            colsums=(fc1.weight_colsum, fc2.weight_colsum),
        )

    def forward_float(self, x, plain=False, dropout_rng=None, probs=None):
        """The JAX Block in a stateless float format, fp32 (B, N, C) in and
        out.  Where :meth:`fuses` holds, its ``fuse`` branch: each weight
        through its fake-quant (``_qw``; LayerNorm scales only when
        converted), then one op per half with the format's ``qspec``;
        beyond the gate the discrete sites (:meth:`forward_float_discrete`)."""
        if not self.fuses(x, dropout_rng, probs):
            return self.forward_float_discrete(x, plain, dropout_rng, probs)
        return self._whole(lambda t: self._float_fused(t, plain), x)

    def _float_fused(self, x, plain):
        a, f = self._modules["0"].fn, self._modules["1"].fn
        qkv, out = a.fn.to_qkv, a.fn.to_out[0]
        fc1, fc2 = f.fn.net[0], f.fn.net[3]

        def qw(module, kind):
            return quantize_weight(module.weight, self.q_format, kind,
                                   self.converted, plain).float()

        attn_op = fused_attention_block_plain if plain else \
            fused_attention_block
        mlp_op = fused_mlp_block_plain if plain else fused_mlp_block
        qspec = QSPECS[self.q_format]
        x = attn_op(x, qw(a.norm, "norm"), a.norm.bias,
                    qw(qkv, "linear").t(), qkv.bias, qw(out, "linear").t(),
                    out.bias, self.heads, self.scale, self.depth,
                    qspec=qspec)
        return mlp_op(x, qw(f.norm, "norm"), f.norm.bias,
                      qw(fc1, "linear").t(), fc1.bias,
                      qw(fc2, "linear").t(), fc2.bias, qspec=qspec)

    def forward_float_discrete(self, x, plain=False, dropout_rng=None,
                               probs=None):
        """:meth:`_float_discrete`, alone or over the model group
        (:meth:`_discrete`)."""
        return self._discrete(self._float_discrete, x, plain, dropout_rng,
                              probs)

    def _float_discrete(self, x, plain, dropout_rng, probs, split):
        """The JAX Block's discrete-site composition in a stateless float
        format (its ``else`` branches), fp32 (B, N, C) in and out, every
        site straight-through: QLayerNorm (:func:`_qlayernorm_float`),
        QDense (:func:`_qdense_float`: 3-pass products with their 3-pass
        backward) for to_qkv, to_out, fc1 and fc2, the fp32 ``xla``
        attention core (ops/attention.py), the quant_out stub (the identity
        in these formats), QGelu (the gelu_in and gelu_out sites around the
        exact-divide polynomial-erf GELU) and the ResidualAdd sites.  The
        sites run K11 on the card unless ``plain``; the products, the
        LayerNorms and the core are PyTorch operations on any device, as
        XLA runs them in the JAX package.  ``split``:
        ``parallel.tp.Split``."""
        a, f = self._modules["0"].fn, self._modules["1"].fn
        attn, net = a.fn, f.fn.net
        q, conv, sp = self.q_format, self.converted, split
        b, n, _ = x.shape
        y = _qlayernorm_float(a.norm, sp.replicated(x), q, conv, plain)
        qkv = _qdense_float(attn.to_qkv, y, q, conv, plain, sp, sections=3)
        qh, kh, vh = qkv.view(b, n, 3, self.heads // sp.size,
                              -1).permute(2, 0, 3, 1, 4)
        o = _attention(qh, kh, vh, self.scale, probs, impl="xla")
        o = o.transpose(1, 2).reshape(b, n, -1)
        y = dropout(_qdense_float(attn.to_out[0], o, q, conv, plain, sp,
                                  "rows"), self.dropout, dropout_rng)
        x = act_quant(y + x, q, "functional", plain)
        y = _qlayernorm_float(f.norm, sp.replicated(x), q, conv, plain)
        h = act_quant(_qdense_float(net[0], y, q, conv, plain, sp), q,
                      "gelu_in", plain)
        g = dropout(act_quant(K.gelu_poly(h), q, "gelu_out", plain),
                    self.dropout, dropout_rng, sp)
        y = dropout(_qdense_float(net[3], g, q, conv, plain, sp, "rows"),
                    self.dropout, dropout_rng)
        return act_quant(y + x, q, "functional", plain)

    def forward_discrete(self, x, plain=False, dropout_rng=None, probs=None):
        """:meth:`_fp32_discrete`, alone or over the model group
        (:meth:`_discrete`)."""
        return self._discrete(self._fp32_discrete, x, plain, dropout_rng,
                              probs)

    def _fp32_discrete(self, x, plain, dropout_rng, probs, split):
        """The JAX Block's discrete-site FP32 composition, (B, N, C) in the
        compute dtype in and out: QLayerNorm (fp32 statistics and
        parameters, rounded once), QDense (``_dense``), the attention core
        (``multi_head_attention``; ``plain`` takes its plain version;
        capturing, the ``xla`` core), the exact-erf GELU in fp32, the
        dropout sites, the residual adds in the compute dtype.  ``split``:
        ``parallel.tp.Split`` (the attention on the local heads, on the
        card the flash kernels)."""
        a, f = self._modules["0"].fn, self._modules["1"].fn
        attn, net = a.fn, f.fn.net
        dt, sp = x.dtype, split
        b, n, _ = x.shape
        y = layernorm_rows_plain(sp.replicated(x), a.norm.weight, a.norm.bias)
        qkv = _dense(y, attn.to_qkv, dt, sp, sections=3)
        q, k, v = qkv.view(b, n, 3, self.heads // sp.size,
                           -1).permute(2, 0, 3, 1, 4)
        o = _attention(q, k, v, self.scale, probs, plain=plain)
        o = o.transpose(1, 2).reshape(b, n, -1).to(dt)
        rate = self.dropout
        x = dropout(_dense(o, attn.to_out[0], dt, sp, "rows"), rate,
                    dropout_rng) + x
        y = layernorm_rows_plain(sp.replicated(x), f.norm.weight, f.norm.bias)
        h = torch.nn.functional.gelu(
            _dense(y, net[0], dt, sp).float()).to(dt)
        h = dropout(h, rate, dropout_rng, sp)
        return dropout(_dense(h, net[3], dt, sp, "rows"), rate,
                       dropout_rng) + x

    def forward_tp(self, x, plain=False, dropout_rng=None, probs=None):
        """The JAX Block's ``tp_fuse`` branch: each half on this rank's
        1/n_tp of the heads (the [q|k|v] rows of ``to_qkv`` and the
        matching columns of ``to_out``) and of the hidden columns (rows
        of fc1, columns of fc2), the output bias and the residual scaled
        by 1/n_tp (``res_scale``), the block input through
        ``replicated_in`` and the partial output through ``partial_out``.
        The parameters stay whole; their gradients here are this rank's
        part, which the trainer sums over the group.  The Block fuses:
        :meth:`forward` takes this form where :meth:`tp_form` says
        "sharded"."""
        attn = self._modules["0"].fn
        ffn = self._modules["1"].fn
        attn_op = fused_attention_block_plain if plain else \
            fused_attention_block
        mlp_op = fused_mlp_block_plain if plain else fused_mlp_block
        group, idx, n = self.tp.group, self.tp.index, self.tp.size
        inv = 1.0 / n
        dt = x.dtype

        def cols(w, sections=1):
            # the local output features of a torch (out, in) weight, as
            # the (in, out) view of a row-major tensor, which the kernels
            # read in place
            return tp_lib.shard_cols(w.to(dt), idx, n,
                                     sections).contiguous().t()

        def rows(w):
            # the local input features, likewise
            return tp_lib.shard_rows(w.to(dt), idx, n).contiguous().t()

        qkv, out = attn.fn.to_qkv, attn.fn.to_out[0]
        part = attn_op(
            tp_lib.replicated_in(x, group), attn.norm.weight.to(dt),
            attn.norm.bias, cols(qkv.weight, 3),
            tp_lib.shard_cols(qkv.bias, idx, n, 3), rows(out.weight),
            out.bias * inv, self.heads // n, self.scale, self.depth,
            res_scale=inv)
        x = tp_lib.partial_out(part, group)
        fc1, fc2 = ffn.fn.net[0], ffn.fn.net[3]
        part = mlp_op(
            tp_lib.replicated_in(x, group), ffn.norm.weight.to(dt),
            ffn.norm.bias, cols(fc1.weight), tp_lib.shard_cols(
                fc1.bias, idx, n), rows(fc2.weight), fc2.bias * inv,
            res_scale=inv)
        return tp_lib.partial_out(part, group)

    def forward(self, x, plain: bool = False, dropout_rng=None, probs=None):
        if not self.fuses(x, dropout_rng, probs):
            return self.forward_discrete(x, plain, dropout_rng, probs)
        if self._over_group() and self.tp_form(True) == "sharded":
            return self.forward_tp(x, plain, dropout_rng, probs)
        return self._whole(lambda t: self._fp32_fused(t, plain), x)

    def _fp32_fused(self, x, plain):
        attn = self._modules["0"].fn
        ffn = self._modules["1"].fn
        attn_op = fused_attention_block_plain if plain else \
            fused_attention_block
        mlp_op = fused_mlp_block_plain if plain else fused_mlp_block
        dt = x.dtype
        # As the JAX Block: LN scales and weights cast to the compute
        # dtype before the op (so their gradients round there too), biases
        # fp32; the (out, in) torch weights handed over as (in, out) views.
        x = attn_op(
            x, attn.norm.weight.to(dt), attn.norm.bias,
            attn.fn.to_qkv.weight.to(dt).t(), attn.fn.to_qkv.bias,
            attn.fn.to_out[0].weight.to(dt).t(), attn.fn.to_out[0].bias,
            self.heads, self.scale, self.depth,
        )
        return mlp_op(
            x, ffn.norm.weight.to(dt), ffn.norm.bias,
            ffn.fn.net[0].weight.to(dt).t(), ffn.fn.net[0].bias,
            ffn.fn.net[3].weight.to(dt).t(), ffn.fn.net[3].bias,
        )


class Transformer(nn.Module):
    """depth x Block (reference vit.py:102-161); ViT.forward runs them."""

    def __init__(self, dim, depth, heads, dim_head, mlp_dim, dropout,
                 device=None, q_format=QFormat.FP32, converted=False):
        super().__init__()
        self.layers = nn.ModuleList(
            Block(dim, heads, dim_head, mlp_dim, dropout, depth, device,
                  q_format, converted)
            for _ in range(depth)
        )


class ClassificationDecoder(nn.Module):
    """cls token -> LayerNorm -> Linear(num_classes)
    (reference vit.py:325-342)."""

    def __init__(self, dim, num_classes, device=None):
        super().__init__()
        self.norm = _layernorm(dim, device)
        self.linear = _linear(dim, num_classes, device)

    def forward(self, x):
        dtype = x.dtype
        y = layernorm_rows_plain(x[:, 0], self.norm.weight, self.norm.bias)
        return _dense(y, self.linear, dtype)

    def forward_int8(self, x, calibrating=True, update=None):
        """The PyTorchINT8 simulation's head (see :func:`_qdense`)."""
        update = calibrating if update is None else update
        y = layernorm_rows_plain(x[:, 0], self.norm.weight, self.norm.bias)
        return _qdense(self.linear, self.norm.act_out(y, update), calibrating,
                       update)

    def forward_float(self, x, q_format, converted, plain):
        """QLayerNorm and QDense in a stateless float format: the norm's
        pre_linear snap, its scale's fake-quant (when converted), the
        LayerNorm, its post_op snap, then :func:`_qdense_float`."""
        y = _qlayernorm_float(self.norm, x[:, 0], q_format, converted, plain)
        return _qdense_float(self.linear, y, q_format, converted, plain)

    def forward_converted(self, kern, x, sites, has):
        """``sites``: the rows of ``norm.act_out`` and ``linear.act_out``;
        ``has``: whether the first has statistics."""
        return _int8_norm_dense(kern, self.norm, self.linear,
                                x[:, 0].contiguous(), sites[0], sites[1],
                                has)


class SegmentationDecoder(ClassificationDecoder):
    """The "Segmenter" linear decoder (reference vit.py:344-374): the cls
    token dropped, LayerNorm and Linear(num_classes) over every patch
    token, the (B, grid, grid, num_classes) patch logits cast to fp32 and
    upsampled bilinearly to the image (ops/interpolate.py
    ``resize_bilinear``, torch's ``align_corners=False``).  The output is
    NHWC (B, H, W, num_classes), as the JAX package returns it; the
    reference returns NCHW.  The head rounds as the JAX head does: in
    FP32 its QDense runs in the compute dtype and only its output is cast
    to fp32, before the resize.  Its quant sites see every patch token's
    row: an INT8 observer takes the min and max over all of them, a float
    snap applies per element."""

    def __init__(self, dim, num_classes, image_size, patch_size,
                 device=None):
        super().__init__(dim, num_classes, device)
        self.grid = image_size // patch_size
        self.image_size = image_size

    def _upsample(self, y):
        b, _, c = y.shape
        y = y.reshape(b, self.grid, self.grid, c).float()
        return resize_bilinear(y, self.image_size, self.image_size)

    def forward(self, x):
        dtype = x.dtype
        y = layernorm_rows_plain(x[:, 1:], self.norm.weight, self.norm.bias)
        return self._upsample(_dense(y, self.linear, dtype))

    def forward_int8(self, x, calibrating=True, update=None):
        """The PyTorchINT8 simulation's head (see :func:`_qdense`)."""
        update = calibrating if update is None else update
        y = layernorm_rows_plain(x[:, 1:], self.norm.weight, self.norm.bias)
        return self._upsample(_qdense(self.linear,
                                      self.norm.act_out(y, update),
                                      calibrating, update))

    def forward_float(self, x, q_format, converted, plain):
        """QLayerNorm and QDense in a stateless float format over the
        patch tokens, then the upsample."""
        y = _qlayernorm_float(self.norm, x[:, 1:], q_format, converted, plain)
        return self._upsample(_qdense_float(self.linear, y, q_format,
                                            converted, plain))


class DetectionDecoder(nn.Module):
    """YOLOS head on the last ``num_det_tokens`` tokens: Linear class
    logits (``num_classes`` + 1, the last the no-object class) and
    sigmoid'd Linear boxes (cx, cy, w, h), both fp32
    (myrtle_vision_tpu/models/vit.py DetectionDecoder)."""

    def __init__(self, dim, num_classes, num_det_tokens, device=None):
        super().__init__()
        self.num_det_tokens = num_det_tokens
        self.class_embed = _linear(dim, num_classes + 1, device)
        self.bbox_embed = _linear(dim, 4, device)

    def forward(self, x):
        dtype = x.dtype
        x = x[:, -self.num_det_tokens:]
        return {
            "pred_logits": _dense(x, self.class_embed, dtype).float(),
            "pred_boxes": torch.sigmoid(
                _dense(x, self.bbox_embed, dtype).float()),
        }

    def forward_int8(self, x, calibrating=True, update=None):
        """The PyTorchINT8 simulation's heads: ``class_embed`` and
        ``bbox_embed`` as QDense sites (:func:`_qdense`), then the sigmoid
        of the boxes, fp32."""
        x = x[:, -self.num_det_tokens:]
        return {
            "pred_logits": _qdense(self.class_embed, x, calibrating, update),
            "pred_boxes": torch.sigmoid(
                _qdense(self.bbox_embed, x, calibrating, update)),
        }

    def forward_float(self, x, q_format, converted, plain):
        """The heads in a stateless float format: ``class_embed`` and
        ``bbox_embed`` through :func:`_qdense_float`, then the sigmoid of
        the boxes, fp32."""
        x = x[:, -self.num_det_tokens:]
        return {
            "pred_logits": _qdense_float(self.class_embed, x, q_format,
                                         converted, plain),
            "pred_boxes": torch.sigmoid(_qdense_float(
                self.bbox_embed, x, q_format, converted, plain)),
        }


def interpolate_pos_embedding(pos_embedding, grid_h, grid_w):
    """Bicubically rescale the stored 14x14 positional grid to
    (grid_h, grid_w) (reference vit.py:292-302)."""
    _, n, dim = pos_embedding.shape
    src = int(round(n ** 0.5))
    if (grid_h, grid_w) == (src, src):
        return pos_embedding
    grid = pos_embedding.reshape(1, src, src, dim)
    grid = resize_bicubic(grid, grid_h, grid_w)
    return grid.reshape(1, grid_h * grid_w, dim).to(pos_embedding.dtype)


class ViT(nn.Module):
    """The ViT backbone with the classification, segmentation or detection
    decoder (reference vit.py:164-323).

    ``forward(img, plain=False, calibrating=False, int8_fused=False)``:
    img (B, H, W, C) float NHWC -> fp32 logits (B, num_classes), for
    segmentation fp32 pixel logits (B, image_size, image_size,
    num_classes), or for detection the {"pred_logits" (B,
    num_det_tokens, num_classes + 1), "pred_boxes" (B, num_det_tokens,
    4)} dict of fp32 tensors;
    differentiable in FP32, on the card at any length (the fused ops'
    backward walks KV tiles above 256 tokens, the discrete path has the
    flash backward); ``plain`` selects the plain PyTorch versions in
    place of the kernels; ``calibrating`` (PyTorchINT8 before convert)
    updates the observers, and without it that model runs the
    simulation's eval forward; ``int8_fused`` (PyTorchINT8 before
    convert) is the QAT step's differentiable second pass.  The float
    formats' simulation is differentiable too (QAT); a converted model's
    fp16 weights take no gradient.
    The detection parameters (``pos_embedding_det``, ``det_tokens``)
    exist in every model so that the reference state dict loads strictly;
    the classification forward does not read them.
    """

    def __init__(self, decoder, image_size, patch_size, num_classes, dim,
                 depth, heads, mlp_dim, channels=3, dim_head=64,
                 dropout=0.0, emb_dropout=0.0, num_det_tokens=100,
                 q_format="FP32", converted=False,
                 compute_dtype=torch.bfloat16, device=None, generator=None):
        super().__init__()
        if decoder not in ("classification", "segmentation", "detection"):
            raise ValueError("decoder must be either classification, "
                             f"segmentation, or detection, not {decoder!r}")
        q_format = QFormat[getattr(q_format, "name", q_format)]
        if decoder == "detection" and converted and \
                q_format == QFormat.PyTorchINT8:
            raise NotImplementedError(
                "a converted PyTorchINT8 detector: the JAX package builds "
                "converted models for classification only (its PTQ CLI)")
        if decoder == "segmentation" and converted:
            raise NotImplementedError(
                "a converted segmentation model: the JAX package builds "
                "converted models for classification only (its PTQ CLI)")
        if converted and q_format == QFormat.FP32:
            raise ValueError("q_format FP32 has nothing to convert")
        if image_size % patch_size:
            raise ValueError("Image dimensions must be divisible by the "
                             "patch size.")
        num_patches = (image_size // patch_size) ** 2
        if num_patches <= MIN_NUM_PATCHES:
            raise ValueError(
                f"your number of patches ({num_patches}) is way too small "
                "for attention to be effective (at least 16). Try "
                "decreasing your patch size"
            )
        self.decoder_name = decoder
        self.num_classes = num_classes
        self.num_det_tokens = num_det_tokens
        self.image_size = image_size
        self.patch_size = patch_size
        self.dim = dim
        self.dropout = dropout
        self.emb_dropout = emb_dropout
        self.q_format = q_format
        self.converted = converted
        self.int8 = q_format == QFormat.PyTorchINT8
        self.float_format = q_format in QSPECS
        # a quantized format computes in fp32, as the JAX ViT does
        self.compute_dtype = (compute_dtype if q_format == QFormat.FP32
                              else torch.float32)
        patch_dim = channels * patch_size ** 2

        def param(*shape):
            return nn.Parameter(torch.empty(*shape, device=device))

        # stored at the fixed 14x14+1 grid whatever the image size
        self.pos_embedding = param(1, 14 * 14 + 1, dim)
        self.pos_embedding_det = param(1, num_det_tokens, dim)
        self.cls_token = param(1, 1, dim)
        self.det_tokens = param(1, num_det_tokens, dim)
        self.patch_to_embedding = _linear(patch_dim, dim, device)
        self.transformer = Transformer(dim, depth, heads, dim_head, mlp_dim,
                                       dropout, device, q_format, converted)
        if decoder == "detection":
            self.decoder = DetectionDecoder(dim, num_classes, num_det_tokens,
                                            device)
        elif decoder == "segmentation":
            self.decoder = SegmentationDecoder(dim, num_classes, image_size,
                                               patch_size, device)
        else:
            self.decoder = ClassificationDecoder(dim, num_classes, device)
        head = ((self.decoder.class_embed, self.decoder.bbox_embed)
                if decoder == "detection"
                else (self.decoder.norm, self.decoder.linear))
        if self.int8:
            for name in ("quant_img", "quant_cls_token",
                         "quant_pos_embedding", "cls_token_cat",
                         "pos_embedding_cat", "pos_embedding_add"):
                setattr(self, name, ActQuant(device))
            if decoder == "detection":
                self.quant_det_tokens = ActQuant(device)
            for module in (self.patch_to_embedding, *head):
                module.act_out = ActQuant(device)
        if converted and q_format in _FP16_STORAGE:
            for module in (self.patch_to_embedding, *head):
                _make_fp16(module)
        if converted and self.int8:
            for linear in (self.patch_to_embedding, self.decoder.linear):
                _make_int8(linear)
            # the sites' rows, refreshed when a state dict is loaded:
            # quant_img, patch_to_embedding.act_out, decoder.norm.act_out,
            # decoder.linear.act_out; then each block's site_table
            self.register_buffer("io_sites", torch.zeros(4, 3, device=device),
                                 persistent=False)
            self.register_buffer(
                "block_sites", torch.zeros(depth, 2, 5, 3, device=device),
                persistent=False)
            self._has = (False, False)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """The JAX package's initialisers, drawn on the CPU from
        ``generator`` (a fresh one seeded 0 when None): tokens N(0, 1),
        Linear weight and bias U(+-1/sqrt(fan_in)), LayerNorm 1 and 0.  A
        converted model stores each drawn weight through convert's
        quantization (int8, or the float format's fake-quant)."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for module in self.modules():
            if isinstance(module, nn.Linear):
                bound = module.in_features ** -0.5
                w, b = (torch.empty(p.shape).uniform_(-bound, bound,
                                                      generator=generator)
                        for p in (module.weight, module.bias))
                if module.weight.dtype == torch.int8:
                    scale = symmetric_int8_scale(w.abs().max())
                    w = torch.clamp(torch.round(w / scale), -128, 127)
                    module.weight_scale.copy_(scale)
                elif self.converted:
                    w = quantize_weight(w, self.q_format, "linear", True,
                                        plain=True)
                module.weight.copy_(w)
                module.bias.copy_(b)
            elif isinstance(module, nn.LayerNorm):
                module.weight.fill_(1.0)
                module.bias.fill_(0.0)
        for p in (self.pos_embedding, self.pos_embedding_det,
                  self.cls_token, self.det_tokens):
            p.copy_(torch.empty(p.shape).normal_(generator=generator))
        self._refresh_converted()

    @torch.no_grad()
    def _refresh_converted(self):
        """Column sums of the int8 weights and the sites' rows, computed
        once for the frozen observers of a converted INT8 model."""
        if not (self.converted and self.int8):
            return
        for module in self.modules():
            if isinstance(module, nn.Linear):
                module.weight_colsum.copy_(weight_colsum(module.weight.t()))
        io = [self.quant_img, self.patch_to_embedding.act_out,
              self.decoder.norm.act_out, self.decoder.linear.act_out]
        self.io_sites.copy_(torch.stack([site_row(o) for o in io]))
        self.block_sites.copy_(torch.stack(
            [block.site_table() for block in self.transformer.layers]))
        has = self.io_sites[:, 2].tolist()
        self._has = (has[0] > 0.5, has[2] > 0.5)

    def add_distill_sites(self):
        """Make this model a DeiT student: in PyTorchINT8 (before
        convert) register the distillation token's two observers, the
        JAX ``quant_distill_token`` and ``distill_token_cat``, which the
        JAX ViT creates when a student first runs with its token; the
        other formats keep no state for them."""
        if self.int8 and not self.converted:
            for name in DISTILL_SITES:
                if not hasattr(self, name):
                    setattr(self, name, ActQuant(self.cls_token.device))

    def load_state_dict(self, state_dict, strict=True, assign=False):
        """``nn.Module.load_state_dict``, refusing a tensor whose storage
        (int8, fp16) is on one side only (an fp32 checkpoint into a
        converted model, or a converted one into a model that is not),
        then refreshing what a converted model computes from its weights
        and observers."""
        own = self.state_dict()
        low = (torch.int8, torch.float16)
        for name, t in state_dict.items():
            if name in own and own[name].dtype != t.dtype and (
                    own[name].dtype in low or t.dtype in low):
                raise TypeError(
                    f"{name}: a {t.dtype} tensor for a {own[name].dtype} "
                    "entry (a converted checkpoint goes into a converted=True "
                    "model, an fp32 one into a model that is not)")
        result = super().load_state_dict(state_dict, strict=strict,
                                         assign=assign)
        self._refresh_converted()
        return result

    def load_ptq_state_dict(self, state_dict):
        """Load an fp32 reference state dict (no observers) strictly into
        this PyTorchINT8 model and keep its observers as they are: the
        PTQ flow, where the format is applied after the weights are read
        (reference test_quantize.py:90-103)."""
        observers = {name: t for name, t in self.state_dict().items()
                     if is_observer(name)}
        return self.load_state_dict({**observers, **state_dict}, strict=True)

    def patchify(self, img):
        """NHWC image -> (B, num_patches, p*p*C), per-patch element order
        (row, col, channel) (reference vit.py:271-275)."""
        b, h, w, c = img.shape
        p = self.patch_size
        x = img.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(b, (h // p) * (w // p), p * p * c)

    def _positions(self, h, w):
        """fp32 positions [cls, patches interpolated to the image's grid]
        and, for detection, the det tokens' ``pos_embedding_det``."""
        p = self.patch_size
        pos_patches = interpolate_pos_embedding(
            self.pos_embedding[:, 1:], h // p, w // p
        )
        parts = [self.pos_embedding[:, :1], pos_patches]
        if self.decoder_name == "detection":
            parts.append(self.pos_embedding_det)
        return torch.cat(parts, dim=1)

    def _tokens_int8(self, x, h, w, calibrating=False):
        """cls token (and for detection the det tokens after the patches),
        positions and their sites (JAX ViT.__call__)."""
        b = x.shape[0]
        cls = self.quant_cls_token(self.cls_token.expand(b, 1, self.dim),
                                   calibrating)
        tokens = [cls, x]
        if self.decoder_name == "detection":
            tokens.append(self.quant_det_tokens(self.det_tokens.expand(
                b, self.num_det_tokens, self.dim), calibrating))
        x = self.cls_token_cat(torch.cat(tokens, dim=1), calibrating)
        pos = self.pos_embedding_cat(self._positions(h, w).float(),
                                     calibrating)
        pos = self.quant_pos_embedding(pos, calibrating)
        return self.pos_embedding_add(x + pos, calibrating)

    def forward(self, img, plain: bool = False, calibrating: bool = False,
                int8_fused: bool = False, distill_token=None,
                capture_attention: bool = False, dropout_rng=None):
        """Logits (fp32; a dict for detection); with ``distill_token``
        (the DeiT student) (logits, the distillation token's fp32
        embedding after the last block); with ``capture_attention``
        (that output, each layer's fp32 (B, H, N, N) attention
        probabilities in depth order).  ``dropout_rng``: the dropout
        sites' ``torch.Generator`` (the module docstring), None for none."""
        probs = [] if capture_attention else None
        out = self._forward(img, plain, calibrating, int8_fused,
                            distill_token, dropout_rng, probs)
        return (out, probs) if capture_attention else out

    def _forward(self, img, plain, calibrating, int8_fused, distill_token,
                 dropout_rng, probs):
        if int8_fused and (not self.int8 or self.converted or calibrating):
            raise ValueError(
                "int8_fused is the second pass of the PyTorchINT8 QAT step: "
                "a model before convert, its observers updated by a "
                "calibrating forward first and frozen in this one")
        if self.float_format:
            return self._forward_float(img, plain, dropout_rng, probs,
                                       distill_token)
        if self.converted:
            if calibrating:
                raise ValueError("a converted model's observers are frozen; "
                                 "calibrate before convert")
            if distill_token is not None:
                raise ValueError(
                    "a converted PyTorchINT8 model takes no distillation "
                    "token: the CLIs evaluate and convert a student as a "
                    "plain ViT")
            return self._forward_converted(img, plain, probs)
        if self.int8:
            return self._forward_int8(img, calibrating or int8_fused,
                                      int8_fused, plain, dropout_rng, probs,
                                      distill_token)
        b, h, w, _ = img.shape
        dtype = self.compute_dtype
        x = _dense(self.patchify(img.to(dtype)), self.patch_to_embedding,
                   dtype)
        tokens = [self.cls_token.to(dtype).expand(b, 1, self.dim), x]
        if self.decoder_name == "detection":
            tokens.append(self.det_tokens.to(dtype).expand(
                b, self.num_det_tokens, self.dim))
        x = torch.cat(tokens, dim=1)
        x = x + self._positions(h, w).to(dtype)
        if distill_token is not None:
            # DeiT: the token after every other one, without a position
            # (reference distill.py:65-69)
            x = torch.cat([x, distill_token.to(dtype).expand(b, 1, self.dim)],
                          dim=1)
        x = dropout(x, self.emb_dropout, dropout_rng)
        for block in self.transformer.layers:
            x = block(x, plain, dropout_rng, probs)

        def decode(t):
            out = self.decoder(t)
            return out if isinstance(out, dict) else out.float()

        return _decode(x, distill_token, decode)

    def _forward_float(self, img, plain, dropout_rng=None, probs=None,
                       distill_token=None):
        """A stateless float format, simulation or converted: the JAX
        ViT's discrete sites around the blocks (the stubs are identities
        in these formats), each block half one op with the format's
        ``qspec``; a student's token through its stub and its functional
        site after the positions."""
        q = self.q_format
        x = self.embed_float(img, plain)
        if distill_token is not None:
            token = act_quant(distill_token.float().expand(
                x.shape[0], 1, self.dim), q, "stub", plain)
            x = act_quant(torch.cat([x, token], dim=1), q, "functional",
                          plain)
        x = dropout(x, self.emb_dropout, dropout_rng)
        for block in self.transformer.layers:
            x = block.forward_float(x, plain, dropout_rng, probs)
        return _decode(x, distill_token, lambda t: self.decoder.forward_float(
            t, q, self.converted, plain))

    def embed_float(self, img, plain=False):
        """A float format's tokens entering the first block: the patch
        embedding's QDense, the cls token (and for detection the det tokens
        after the patches) and positions through the functional sites (the
        token stubs are identities in these formats)."""
        b, h, w, _ = img.shape
        q = self.q_format
        x = _qdense_float(self.patch_to_embedding,
                          self.patchify(img.float()), q, self.converted,
                          plain)
        tokens = [self.cls_token.float().expand(b, 1, self.dim), x]
        if self.decoder_name == "detection":
            tokens.append(self.det_tokens.float().expand(
                b, self.num_det_tokens, self.dim))
        x = act_quant(torch.cat(tokens, dim=1), q, "functional", plain)
        pos = act_quant(self._positions(h, w).float(), q, "functional", plain)
        return act_quant(x + pos, q, "functional", plain)

    def _forward_int8(self, img, calibrating, fused=False, plain=False,
                      dropout_rng=None, probs=None, distill_token=None):
        """PyTorchINT8 before convert, the JAX ViT's discrete sites.
        ``calibrating``: every observer updated, 3-pass products, the
        polynomial erf; else the simulation's eval forward (observers
        frozen, full fp32 products, the exact erf).  ``fused``: the QAT
        step's second pass, the calibrating forward's operations with the
        observers frozen and each block half one op with their site table
        (``plain`` takes its plain chains).  A student's token passes its
        two observers (:meth:`add_distill_sites`) after the positions."""
        _, h, w, _ = img.shape
        update = calibrating and not fused
        x = self.quant_img(self.patchify(img.float()), update)
        x = self._tokens_int8(
            _qdense(self.patch_to_embedding, x, calibrating, update), h, w,
            update)
        if distill_token is not None:
            if not hasattr(self, "distill_token_cat"):
                raise ValueError(
                    "a distillation token in PyTorchINT8 needs the student's "
                    "token observers: wrap the model in models/distill.py's "
                    "DistillWrapper (ViT.add_distill_sites)")
            token = self.quant_distill_token(distill_token.float().expand(
                x.shape[0], 1, self.dim), update)
            x = self.distill_token_cat(torch.cat([x, token], dim=1), update)
        x = dropout(x, self.emb_dropout, dropout_rng)
        for block in self.transformer.layers:
            x = (block.forward_int8_qat(x, plain) if fused
                 else block.forward_int8(x, calibrating, None, dropout_rng,
                                         probs))
        return _decode(x, distill_token, lambda t: self.decoder.forward_int8(
            t, calibrating, update))

    def _forward_converted(self, img, plain, probs=None):
        """The converted PyTorchINT8 model: int8 products throughout, each
        Block fused or discrete as the JAX ``int8_fuse`` gate decides
        (:meth:`Block.forward_converted`)."""
        kern = K.PLAIN if plain else K.for_device(img)
        x = self.embed_converted(img, kern)
        for block, sites in zip(self.transformer.layers, self.block_sites):
            x = block.forward_converted(x, sites, plain, probs)
        return self.decoder.forward_converted(kern, x, self.io_sites[2:],
                                              self._has[1])

    def embed_converted(self, img, kern):
        """The converted model's tokens entering the first block: the int8
        patch embedding (``kern.gemm_s8``), the cls token and positions.
        quant_img's fake-quant and the product's quantization share one
        grid, so the product quantizes the raw patches (and without
        statistics the fake-quant passes them through)."""
        _, h, w, _ = img.shape
        io = self.io_sites
        x = _int8_dense(kern, self.patch_to_embedding,
                        self.patchify(img.float()), io[0], io[1],
                        self._has[0])
        return self._tokens_int8(x, h, w)


def vit_kwargs_from_config(config, data_config, converted=False):
    """ViT constructor kwargs from the reference JSON config schema
    (myrtle_vision_tpu/models/vit.py vit_kwargs_from_config), with
    ``converted`` passed through."""
    vit_config = config["vit_config"]
    kwargs = dict(
        decoder=vit_config["decoder"],
        image_size=vit_config["image_size"],
        patch_size=vit_config["patch_size"],
        num_classes=data_config["number_of_classes"],
        dim=vit_config["embed_dim"],
        depth=vit_config["depth"],
        heads=vit_config["heads"],
        mlp_dim=vit_config["mlp_dim"],
        dropout=vit_config["dropout"],
        emb_dropout=vit_config["emb_dropout"],
        q_format=vit_config["q_format"],
        converted=converted,
        dim_head=vit_config.get(
            "dim_head", vit_config["embed_dim"] // vit_config["heads"]
        ),
    )
    if "num_det_tokens" in vit_config:
        kwargs["num_det_tokens"] = vit_config["num_det_tokens"]
    if "compute_dtype" in vit_config:
        kwargs["compute_dtype"] = getattr(torch, vit_config["compute_dtype"])
    return kwargs
