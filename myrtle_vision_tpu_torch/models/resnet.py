"""torchvision-layout ResNet-18 / ResNet-50 for the distillation teacher and
the CNN baseline (port of myrtle_vision_tpu/models/resnet.py).

The networks are functions of a state dict with torchvision's names
(``conv1.weight``, ``layer1.0.bn1.running_mean``, ..., ``fc.bias``), built
from ``torch.nn.functional``, so a torchvision checkpoint loads as it is
and a finetuned one stays a torchvision checkpoint.  ResNet V1.5: the
stride of a Bottleneck sits on its 3x3 convolution.

Images are NHWC, as everywhere in the port.  ``img.permute(0, 3, 1, 2)``
of a contiguous NHWC tensor is an NCHW view whose memory is
``channels_last``, the layout cuDNN prefers, so the convolutions take the
images without a copy.  The convolutions run in fp32 without TF32
(:func:`fp32_convolutions`), as the JAX teacher runs them in fp32.

- :func:`load_torch_resnet` + :func:`resnet_apply`: the frozen teacher,
  each batch norm folded into a per-channel scale and shift (eps 1e-5)
  when the weights are loaded, and those into the convolution before it
  (its weight times the scale, the shift its bias), so a convolution is
  the teacher's only kernel between two ReLUs; :func:`make_teacher_fn`
  returns it as a function of the images.
- :func:`resnet_apply_torch_sd`: the raw state dict, eval mode (running
  statistics) or train mode (batch statistics, and the running statistics'
  momentum-0.1 update with the unbiased batch variance, returned), as
  ``torch.nn.BatchNorm2d`` does; the finetuning CLI trains through it.
- :func:`random_state_dict`: He-init weights from a numpy seed.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_ARCH = {
    "resnet18": ("basic", (2, 2, 2, 2)),
    "resnet50": ("bottleneck", (3, 4, 6, 3)),
}
BN_EPS = 1e-5
BN_MOMENTUM = 0.1


def fp32_convolutions():
    """Context in which cuDNN convolutions run in true fp32 (TF32 off),
    every other cuDNN setting left as it is."""
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic, allow_tf32=False)


def nchw(images):
    """(B, H, W, C) float images -> the (B, C, H, W) view the
    convolutions take (``channels_last`` memory for contiguous images)."""
    return images.float().permute(0, 3, 1, 2)


def read_state_dict(source):
    """A torch state dict from a ``.pth`` path (a ``{"state_dict": ...}``
    wrapper unwrapped) or a dict of arrays or tensors, as fp32 tensors on
    the CPU, ``num_batches_tracked`` dropped."""
    if isinstance(source, str):
        sd = torch.load(source, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
    else:
        sd = source
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                               else v).float()
            for k, v in sd.items() if not k.endswith("num_batches_tracked")}


def _bn_of(conv):
    """The batch norm after a convolution: ``conv1`` -> ``bn1``,
    ``layer1.0.conv2`` -> ``layer1.0.bn2``, ``layer2.0.downsample.0`` ->
    ``layer2.0.downsample.1``."""
    if conv.endswith("downsample.0"):
        return conv[: -1] + "1"
    return conv.replace("conv", "bn")


def load_torch_resnet(source, arch: str = "resnet50", device="cpu"):
    """A torchvision ResNet state dict (path or dict) -> {name: tensor}
    on ``device``: each batch norm folded into the convolution before it,
    ``<conv>.weight`` times scale = gamma / sqrt(var + 1e-5) per output
    channel and ``<conv>.bias`` = beta - mean * scale, the convolution
    weights in ``channels_last`` memory, ``fc.*`` as they are."""
    sd = read_state_dict(source)
    params = {}
    for key, value in sd.items():
        name = key.rsplit(".", 1)[0]
        if f"{name}.running_mean" in sd:
            continue  # a batch norm's tensor, folded into its convolution
        if value.dim() == 4:
            bn = _bn_of(name)
            scale = sd[f"{bn}.weight"] / torch.sqrt(
                sd[f"{bn}.running_var"] + BN_EPS)
            value = value * scale[:, None, None, None]
            params[f"{name}.bias"] = (sd[f"{bn}.bias"]
                                      - sd[f"{bn}.running_mean"] * scale)
        params[key] = value
    out = {}
    for key, value in params.items():
        value = value.to(device)
        if value.dim() == 4:
            value = value.contiguous(memory_format=torch.channels_last)
        out[key] = value
    return out


def _head(x, weight, bias):
    return F.linear(x.mean(dim=(2, 3)), weight, bias)


def _trunk(x, arch, sd, bn=None):
    """The stem and the four stages, the global average pool's input:
    the convolutions' weights from ``sd``, each followed by the batch norm
    ``bn(name, x)``, or with ``bn`` None by nothing: the batch norm is
    folded into the convolution's weight and bias
    (:func:`load_torch_resnet`)."""
    block_kind, layout = _ARCH[arch]

    def conv_bn(conv_name, x, stride, pad):
        y = F.conv2d(x, sd[f"{conv_name}.weight"],
                     sd.get(f"{conv_name}.bias"), stride, pad)
        return y if bn is None else bn(_bn_of(conv_name), y)

    def shortcut(prefix, x, stride):
        if f"{prefix}.downsample.0.weight" in sd:
            return conv_bn(f"{prefix}.downsample.0", x, stride, 0)
        return x

    def basic(prefix, x, stride):
        out = F.relu(conv_bn(f"{prefix}.conv1", x, stride, 1))
        out = conv_bn(f"{prefix}.conv2", out, 1, 1)
        return F.relu(out + shortcut(prefix, x, stride))

    def bottleneck(prefix, x, stride):
        out = F.relu(conv_bn(f"{prefix}.conv1", x, 1, 0))
        out = F.relu(conv_bn(f"{prefix}.conv2", out, stride, 1))
        out = conv_bn(f"{prefix}.conv3", out, 1, 0)
        return F.relu(out + shortcut(prefix, x, stride))

    block = basic if block_kind == "basic" else bottleneck
    x = F.relu(conv_bn("conv1", x, 2, 3))
    x = F.max_pool2d(x, 3, 2, 1)
    for li, blocks in enumerate(layout, start=1):
        for bi in range(blocks):
            stride = 2 if (li > 1 and bi == 0) else 1
            x = block(f"layer{li}.{bi}", x, stride)
    return x


def resnet_apply(params, images, arch: str = "resnet50"):
    """(B, H, W, 3) NHWC float images -> (B, num_classes) fp32 logits,
    from :func:`load_torch_resnet`'s folded parameters."""
    with fp32_convolutions():
        x = _trunk(nchw(images), arch, params)
        return _head(x, params["fc.weight"], params["fc.bias"])


def make_teacher_fn(weights_path: str, arch: str = "resnet50",
                    device="cpu"):
    """The frozen teacher (reference utils/models.py:14-22): images on
    ``device`` -> logits, without gradient, the weights read once from
    ``weights_path`` onto ``device``."""
    params = load_torch_resnet(weights_path, arch, device)

    @torch.no_grad()
    def teacher(images):
        return resnet_apply(params, images, arch)

    return teacher


class BatchNorm:
    """Batch norm over a torchvision state dict (``<name>.weight``,
    ``.bias``, ``.running_mean``, ``.running_var``), eps 1e-5.  Eval mode
    normalizes with the running statistics; train mode with the batch's,
    and records in ``new_stats`` the running statistics' update, (1 - m) *
    old + m * batch with the unbiased batch variance, as
    ``torch.nn.BatchNorm2d.train()`` does with m = 0.1 (``F.batch_norm``
    computes both on copies, so ``sd`` is not changed)."""

    def __init__(self, sd, train):
        self.sd = sd
        self.train = train
        self.new_stats = {}

    def __call__(self, name, x):
        sd = self.sd
        mean = sd[f"{name}.running_mean"]
        var = sd[f"{name}.running_var"]
        if self.train:
            mean = mean.detach().clone()
            var = var.detach().clone()
            self.new_stats[f"{name}.running_mean"] = mean
            self.new_stats[f"{name}.running_var"] = var
        return F.batch_norm(x, mean, var, sd[f"{name}.weight"],
                            sd[f"{name}.bias"], self.train, BN_MOMENTUM,
                            BN_EPS)


def resnet_apply_torch_sd(sd, images, arch: str = "resnet50",
                          train: bool = False):
    """Forward from a raw torchvision state dict (tensors on the images'
    device).  Eval mode returns the logits; train mode (batch statistics,
    differentiable through them) returns (logits, {name.running_mean /
    running_var: the updated statistics})."""
    bn = BatchNorm(sd, train)
    with fp32_convolutions():
        x = _trunk(nchw(images), arch, sd, bn)
        logits = _head(x, sd["fc.weight"], sd["fc.bias"])
    return (logits, bn.new_stats) if train else logits


def random_state_dict(arch: str, num_classes: int, seed: int = 0):
    """torchvision-layout He-init state dict (numpy; OIHW convolutions,
    batch-norm buffers and ``num_batches_tracked``), the JAX package's
    draws from ``np.random.RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    block_kind, layout = _ARCH[arch]
    sd = {}

    def conv(name, o, i, k):
        sd[f"{name}.weight"] = (
            rng.randn(o, i, k, k) * (2.0 / (i * k * k)) ** 0.5
        ).astype(np.float32)

    def bn(name, c):
        sd[f"{name}.weight"] = np.ones(c, np.float32)
        sd[f"{name}.bias"] = np.zeros(c, np.float32)
        sd[f"{name}.running_mean"] = np.zeros(c, np.float32)
        sd[f"{name}.running_var"] = np.ones(c, np.float32)
        sd[f"{name}.num_batches_tracked"] = np.int64(0)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    in_ch = 64
    widths = (64, 128, 256, 512)
    for li, (blocks, width) in enumerate(zip(layout, widths), start=1):
        out_ch = width * (4 if block_kind == "bottleneck" else 1)
        for bi in range(blocks):
            p = f"layer{li}.{bi}"
            if block_kind == "bottleneck":
                conv(f"{p}.conv1", width, in_ch, 1)
                bn(f"{p}.bn1", width)
                conv(f"{p}.conv2", width, width, 3)
                bn(f"{p}.bn2", width)
                conv(f"{p}.conv3", out_ch, width, 1)
                bn(f"{p}.bn3", out_ch)
            else:
                conv(f"{p}.conv1", width, in_ch, 3)
                bn(f"{p}.bn1", width)
                conv(f"{p}.conv2", width, width, 3)
                bn(f"{p}.bn2", width)
            if bi == 0 and (in_ch != out_ch or li > 1):
                conv(f"{p}.downsample.0", out_ch, in_ch, 1)
                bn(f"{p}.downsample.1", out_ch)
            in_ch = out_ch
    sd["fc.weight"] = (
        rng.randn(num_classes, in_ch) * in_ch ** -0.5
    ).astype(np.float32)
    sd["fc.bias"] = np.zeros(num_classes, np.float32)
    return sd
