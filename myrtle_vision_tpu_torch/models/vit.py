"""Vision Transformer for classification, in PyTorch: eval and training
forward.

Port of myrtle_vision_tpu/models/vit.py for the path this package runs
so far: ``decoder="classification"``, ``q_format`` FP32, no active
dropout.  Parameters are fp32 and named as in the upstream reference
state dict that myrtle_vision_tpu/utils/export.py writes
(``transformer.layers.{i}.0.fn.fn.to_qkv.weight``, ...), so
``load_state_dict(sd, strict=True)`` takes such a dict as it is.
Activations run in ``compute_dtype`` (bf16 by default) with fp32
LayerNorm statistics, softmax and accumulation, rounding at the points
the JAX model rounds.

Images are NHWC, as in the JAX package.  Each block half runs as one
differentiable op (ops/fused_attention_block.py, ops/fused_mlp.py),
which dispatches on the activation's device: the plain PyTorch chain on
the CPU, the CUDA kernel chain on a GPU, forward and backward.
``ViT.forward(img, plain=True)`` runs the plain chains on any device, as
the reference the kernels are checked against.  The patch embedding, the
tokens and the decoder head are plain products outside any kernel in
both packages, and take their gradients from autograd.
"""
from __future__ import annotations

import torch
from torch import nn

from myrtle_vision_tpu_torch.ops._kernels import layernorm_rows_plain
from myrtle_vision_tpu_torch.ops.fused_attention_block import (
    fused_attention_block,
    fused_attention_block_plain,
)
from myrtle_vision_tpu_torch.ops.fused_mlp import (
    fused_mlp_block,
    fused_mlp_block_plain,
)
from myrtle_vision_tpu_torch.ops.interpolate import resize_bicubic

MIN_NUM_PATCHES = 16  # reference vit.py:14
# the port runs the classification decoder in the FP32 format, without
# active dropout, for inference and training
_NOT_PORTED = "not ported yet; see ROADMAP.md (Queue A)"


def _linear(in_features, out_features, device):
    # parameters are set by ViT.reset_parameters from an explicit
    # generator, never from torch's global one
    return nn.utils.skip_init(nn.Linear, in_features, out_features,
                              device=device or "cpu")


def _layernorm(dim, device):
    return nn.utils.skip_init(nn.LayerNorm, dim, eps=1e-5,
                              device=device or "cpu")


def _dense(x, linear, dtype):
    """QDense in FP32 mode: operands rounded to ``dtype``, fp32
    accumulation, the product rounded to ``dtype``, then the bias added
    in ``dtype``."""
    y = torch.matmul(x.to(dtype).float(), linear.weight.to(dtype).float().t())
    return y.to(dtype) + linear.bias.to(dtype)


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
    """Pre-norm transformer block, FP32 format: one fused op per half
    (myrtle_vision_tpu/models/vit.py Block, the ``fuse`` branch).
    Children ``0`` and ``1`` carry the reference's parameter names.
    ``depth``, the model's layer count, sizes the attention op's
    qkv-saving budget as ``model_depth`` does in the JAX Block."""

    def __init__(self, dim, heads, dim_head, mlp_dim, dropout, depth,
                 device=None):
        super().__init__()
        self.heads = heads
        self.scale = dim_head ** -0.5
        self.depth = depth
        self.add_module("0", Residual(PreNorm(
            dim, Attention(dim, heads, dim_head, dropout, device), device)))
        self.add_module("1", Residual(PreNorm(
            dim, FeedForward(dim, mlp_dim, dropout, device), device)))

    def forward(self, x, plain: bool = False):
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
                 device=None):
        super().__init__()
        self.layers = nn.ModuleList(
            Block(dim, heads, dim_head, mlp_dim, dropout, depth, device)
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
    """The ViT backbone with the classification decoder (reference
    vit.py:164-323).

    ``forward(img, plain=False)``: img (B, H, W, C) float NHWC -> fp32
    logits (B, num_classes), differentiable; ``plain`` selects the plain
    PyTorch chains in place of the kernels.  The detection parameters (``pos_embedding_det``,
    ``det_tokens``) exist so that the reference state dict loads
    strictly; the classification forward does not read them.
    """

    def __init__(self, decoder, image_size, patch_size, num_classes, dim,
                 depth, heads, mlp_dim, channels=3, dim_head=64,
                 dropout=0.0, emb_dropout=0.0, num_det_tokens=100,
                 q_format="FP32", compute_dtype=torch.bfloat16, device=None,
                 generator=None):
        super().__init__()
        if decoder != "classification":
            raise NotImplementedError(f"decoder {decoder!r}: {_NOT_PORTED}")
        q_format = getattr(q_format, "name", q_format)
        if q_format != "FP32":
            raise NotImplementedError(f"q_format {q_format}: {_NOT_PORTED}")
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
        self.image_size = image_size
        self.patch_size = patch_size
        self.dim = dim
        self.dropout = dropout
        self.emb_dropout = emb_dropout
        self.compute_dtype = compute_dtype
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
                                       dropout, device)
        self.decoder = ClassificationDecoder(dim, num_classes, device)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """The JAX package's initialisers, drawn on the CPU from
        ``generator`` (a fresh one seeded 0 when None): tokens N(0, 1),
        Linear weight and bias U(+-1/sqrt(fan_in)), LayerNorm 1 and 0."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for module in self.modules():
            if isinstance(module, nn.Linear):
                bound = module.in_features ** -0.5
                for p in (module.weight, module.bias):
                    p.copy_(torch.empty(p.shape).uniform_(
                        -bound, bound, generator=generator))
            elif isinstance(module, nn.LayerNorm):
                module.weight.fill_(1.0)
                module.bias.fill_(0.0)
        for p in (self.pos_embedding, self.pos_embedding_det,
                  self.cls_token, self.det_tokens):
            p.copy_(torch.empty(p.shape).normal_(generator=generator))

    def patchify(self, img):
        """NHWC image -> (B, num_patches, p*p*C), per-patch element order
        (row, col, channel) (reference vit.py:271-275)."""
        b, h, w, c = img.shape
        p = self.patch_size
        x = img.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(b, (h // p) * (w // p), p * p * c)

    def forward(self, img, plain: bool = False):
        if self.training and (self.dropout or self.emb_dropout):
            raise NotImplementedError(f"active dropout: {_NOT_PORTED}")
        b, h, w, _ = img.shape
        p = self.patch_size
        dtype = self.compute_dtype
        x = _dense(self.patchify(img.to(dtype)), self.patch_to_embedding,
                   dtype)
        cls_tokens = self.cls_token.to(dtype).expand(b, 1, self.dim)
        x = torch.cat([cls_tokens, x], dim=1)
        pos_patches = interpolate_pos_embedding(
            self.pos_embedding[:, 1:], h // p, w // p
        )
        pos = torch.cat([self.pos_embedding[:, :1], pos_patches], dim=1)
        x = x + pos.to(dtype)
        for block in self.transformer.layers:
            x = block(x, plain)
        return self.decoder(x).float()


def vit_kwargs_from_config(config, data_config):
    """ViT constructor kwargs from the reference JSON config schema
    (myrtle_vision_tpu/models/vit.py vit_kwargs_from_config)."""
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
        dim_head=vit_config.get(
            "dim_head", vit_config["embed_dim"] // vit_config["heads"]
        ),
    )
    if "num_det_tokens" in vit_config:
        kwargs["num_det_tokens"] = vit_config["num_det_tokens"]
    if "compute_dtype" in vit_config:
        kwargs["compute_dtype"] = getattr(torch, vit_config["compute_dtype"])
    return kwargs
