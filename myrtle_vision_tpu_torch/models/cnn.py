"""torchvision-layout CNN forwards for the teacher / baseline zoo (port of
myrtle_vision_tpu/models/cnn.py).

The reference's CNN notebook finetunes torchvision models: squeezenet,
shufflenet, mobilenet, mnasnet, resnet18 and resnet50 (reference:
classification/Finetune_CNN_Resisc45.ipynb, utils/models.py:14-22).  The
ResNets live in models/resnet.py; this module adds the other four
families as functions of a raw torchvision state dict (OIHW convolutions,
batch norm's weight, bias and running statistics), built from
``torch.nn.functional``, so torchvision checkpoints load unchanged and
finetuned weights stay torchvision checkpoints:
  - squeezenet1_0 / squeezenet1_1: Fire modules, no batch norm, a
    convolutional classifier;
  - mobilenet_v2: inverted residuals, ReLU6, the width-1.0 setting table;
  - mnasnet1_0: MBConv stacks (kernels 3 and 5), depth multiplier 1.0;
  - shufflenet_v2_x1_0: channel split and shuffle, stages (116, 232, 464).

Every forward takes NHWC float images (models/resnet.py ``nchw`` views
them as NCHW in ``channels_last`` memory) and returns (B, num_classes)
fp32 logits.  ``train=True`` normalizes with batch statistics and also
returns the running statistics' update (models/resnet.py ``BatchNorm``),
as ``resnet_apply_torch_sd`` does.  The convolutions run without TF32.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from myrtle_vision_tpu_torch.models.resnet import (
    BatchNorm as _BN,
    fp32_convolutions,
    nchw,
    random_state_dict,
    resnet_apply_torch_sd,
)


def _conv_sd(sd, name, x, stride=1, pad=0, groups=1):
    return F.conv2d(x, sd[f"{name}.weight"], sd.get(f"{name}.bias"),
                    stride, pad, groups=groups)


def _maxpool(x, window=3, stride=2, pad=0, ceil_mode=False):
    """Max pooling; ``ceil_mode`` counts a last, partial window (the JAX
    package pads the right and bottom edges with -inf for it)."""
    return F.max_pool2d(x, window, stride, pad, ceil_mode=ceil_mode)


def _linear_sd(sd, name, x):
    return F.linear(x, sd[f"{name}.weight"], sd[f"{name}.bias"])


def _pool(x):
    return x.mean(dim=(2, 3))


# ---------------------------------------------------------------------------
# SqueezeNet (no batch norm)
# ---------------------------------------------------------------------------

# version -> stem (kernel, stride, out), fires [(index, squeeze, e1, e3)],
# the indices of the max pools
_SQUEEZE_CFG = {
    "squeezenet1_0": dict(
        stem=(7, 2, 96),
        fires=[(3, 16, 64, 64), (4, 16, 64, 64), (5, 32, 128, 128),
               (7, 32, 128, 128), (8, 48, 192, 192), (9, 48, 192, 192),
               (10, 64, 256, 256), (12, 64, 256, 256)],
        pools=(2, 6, 11),
    ),
    "squeezenet1_1": dict(
        stem=(3, 2, 64),
        fires=[(3, 16, 64, 64), (4, 16, 64, 64), (6, 32, 128, 128),
               (7, 32, 128, 128), (9, 48, 192, 192), (10, 48, 192, 192),
               (11, 64, 256, 256), (12, 64, 256, 256)],
        pools=(2, 5, 8),
    ),
}


def squeezenet_apply(sd, x, arch="squeezenet1_0"):
    """NCHW input -> logits (the classifier is a 1x1 convolution, then the
    global average)."""
    cfg = _SQUEEZE_CFG[arch]
    pools = set(cfg["pools"])
    fire_idx = {i for i, *_ in cfg["fires"]}
    x = F.relu(_conv_sd(sd, "features.0", x, cfg["stem"][1], 0))
    for i in range(1, 13):
        if i in pools:
            x = _maxpool(x, 3, 2, ceil_mode=True)
        elif i in fire_idx:
            p = f"features.{i}"
            s = F.relu(_conv_sd(sd, f"{p}.squeeze", x))
            e1 = F.relu(_conv_sd(sd, f"{p}.expand1x1", s))
            e3 = F.relu(_conv_sd(sd, f"{p}.expand3x3", s, pad=1))
            x = torch.cat([e1, e3], dim=1)
    return _pool(F.relu(_conv_sd(sd, "classifier.1", x)))


# ---------------------------------------------------------------------------
# MobileNetV2
# ---------------------------------------------------------------------------

# (expand_ratio, out_channels, repeats, first_stride), width 1.0
_MBV2_SETTING = [
    (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
    (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1),
]


def mobilenet_v2_apply(sd, x, bn):
    x = F.relu6(bn("features.0.1", _conv_sd(sd, "features.0.0", x, 2, 1)))
    cin = 32
    idx = 1
    for t, c, n, s in _MBV2_SETTING:
        for rep in range(n):
            stride = s if rep == 0 else 1
            p = f"features.{idx}.conv"
            identity = x
            if t == 1:
                h = F.relu6(bn(f"{p}.0.1", _conv_sd(sd, f"{p}.0.0", x,
                                                    stride, 1, groups=cin)))
                x = bn(f"{p}.2", _conv_sd(sd, f"{p}.1", h))
            else:
                h = F.relu6(bn(f"{p}.0.1", _conv_sd(sd, f"{p}.0.0", x)))
                h = F.relu6(bn(f"{p}.1.1", _conv_sd(sd, f"{p}.1.0", h, stride,
                                                    1, groups=cin * t)))
                x = bn(f"{p}.3", _conv_sd(sd, f"{p}.2", h))
            if stride == 1 and cin == c:
                x = x + identity
            cin = c
            idx += 1
    x = F.relu6(bn("features.18.1", _conv_sd(sd, "features.18.0", x)))
    return _linear_sd(sd, "classifier.1", _pool(x))


# ---------------------------------------------------------------------------
# MnasNet 1.0
# ---------------------------------------------------------------------------

# (in, out, kernel, first_stride, expand, repeats) of each stack, layers.8-13
_MNAS_STACKS = [
    (16, 24, 3, 2, 3, 3), (24, 40, 5, 2, 3, 3), (40, 80, 5, 2, 6, 3),
    (80, 96, 3, 1, 6, 2), (96, 192, 5, 2, 6, 4), (192, 320, 3, 1, 6, 1),
]


def mnasnet_apply(sd, x, bn):
    x = F.relu(bn("layers.1", _conv_sd(sd, "layers.0", x, 2, 1)))
    x = F.relu(bn("layers.4", _conv_sd(sd, "layers.3", x, 1, 1, groups=32)))
    x = bn("layers.7", _conv_sd(sd, "layers.6", x))  # 32 -> 16, no ReLU
    for stack_i, (cin, cout, k, s, t, reps) in enumerate(_MNAS_STACKS,
                                                         start=8):
        for rep in range(reps):
            stride = s if rep == 0 else 1
            ci = cin if rep == 0 else cout
            p = f"layers.{stack_i}.{rep}.layers"
            identity = x
            h = F.relu(bn(f"{p}.1", _conv_sd(sd, f"{p}.0", x)))
            h = F.relu(bn(f"{p}.4", _conv_sd(sd, f"{p}.3", h, stride, k // 2,
                                             groups=ci * t)))
            x = bn(f"{p}.7", _conv_sd(sd, f"{p}.6", h))
            if stride == 1 and ci == cout:
                x = x + identity
    x = F.relu(bn("layers.15", _conv_sd(sd, "layers.14", x)))
    return _linear_sd(sd, "classifier.1", _pool(x))


# ---------------------------------------------------------------------------
# ShuffleNetV2 x1.0
# ---------------------------------------------------------------------------

_SHUFFLE_STAGES = [("stage2", 24, 116, 4), ("stage3", 116, 232, 8),
                   ("stage4", 232, 464, 4)]


def _channel_shuffle(x, groups=2):
    """NCHW channel shuffle: channel i * (C / groups) + j goes to
    j * groups + i."""
    b, c, h, w = x.shape
    x = x.reshape(b, groups, c // groups, h, w).transpose(1, 2)
    return x.reshape(b, c, h, w)


def shufflenet_v2_apply(sd, x, bn):
    x = F.relu(bn("conv1.1", _conv_sd(sd, "conv1.0", x, 2, 1)))
    x = _maxpool(x, 3, 2, 1)
    for stage, cin, cout, reps in _SHUFFLE_STAGES:
        half = cout // 2
        for rep in range(reps):
            p = f"{stage}.{rep}"
            if rep == 0:
                # downsample unit: both branches see the full input
                b1 = bn(f"{p}.branch1.1", _conv_sd(sd, f"{p}.branch1.0", x,
                                                   2, 1, groups=cin))
                b1 = F.relu(bn(f"{p}.branch1.3",
                               _conv_sd(sd, f"{p}.branch1.2", b1)))
                b2 = F.relu(bn(f"{p}.branch2.1",
                               _conv_sd(sd, f"{p}.branch2.0", x)))
                stride = 2
            else:
                b1, inp = x[:, :half], x[:, half:]
                b2 = F.relu(bn(f"{p}.branch2.1",
                               _conv_sd(sd, f"{p}.branch2.0", inp)))
                stride = 1
            b2 = bn(f"{p}.branch2.4", _conv_sd(sd, f"{p}.branch2.3", b2,
                                               stride, 1, groups=half))
            b2 = F.relu(bn(f"{p}.branch2.6",
                           _conv_sd(sd, f"{p}.branch2.5", b2)))
            x = _channel_shuffle(torch.cat([b1, b2], dim=1))
    x = F.relu(bn("conv5.1", _conv_sd(sd, "conv5.0", x)))
    return _linear_sd(sd, "fc", _pool(x))


# ---------------------------------------------------------------------------
# dispatch and random init
# ---------------------------------------------------------------------------

_APPLY = {
    "squeezenet1_0": lambda sd, x, bn: squeezenet_apply(sd, x,
                                                        "squeezenet1_0"),
    "squeezenet1_1": lambda sd, x, bn: squeezenet_apply(sd, x,
                                                        "squeezenet1_1"),
    "mobilenet_v2": mobilenet_v2_apply,
    "mnasnet1_0": mnasnet_apply,
    "shufflenet_v2_x1_0": shufflenet_v2_apply,
}

CNN_ARCHS = tuple(_APPLY)


def cnn_apply_torch_sd(sd, images, arch, train=False):
    """Forward a raw torchvision state dict (tensors on the images'
    device) for any zoo arch; with ``train=True`` returns (logits, the
    running statistics' update), empty for SqueezeNet."""
    if arch not in _APPLY:
        raise ValueError(
            f"unknown arch {arch!r}; available: {sorted(_APPLY)}"
        )
    bn = _BN(sd, train)
    with fp32_convolutions():
        logits = _APPLY[arch](sd, nchw(images), bn)
    return (logits, bn.new_stats) if train else logits


def _he(rng, shape):
    fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else shape[0]
    return (rng.randn(*shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)


def apply_any_torch_sd(sd, images, arch, train=False):
    """Forward any zoo or ResNet arch from a raw torchvision state
    dict."""
    if arch.startswith("resnet"):
        return resnet_apply_torch_sd(sd, images, arch, train=train)
    return cnn_apply_torch_sd(sd, images, arch, train=train)


def random_any_state_dict(arch, num_classes, seed=0):
    """He-init numpy state dict of any arch (a ResNet's is drawn with seed
    0 whatever ``seed`` is, as in the JAX package)."""
    if arch.startswith("resnet"):
        return random_state_dict(arch, num_classes)
    return random_cnn_state_dict(arch, num_classes, seed)


def head_keys(arch):
    """(weight_key, bias_key, is_conv_head) of the classifier head."""
    if arch.startswith("resnet") or arch == "shufflenet_v2_x1_0":
        return "fc.weight", "fc.bias", False
    if arch.startswith("squeezenet"):
        return "classifier.1.weight", "classifier.1.bias", True
    return "classifier.1.weight", "classifier.1.bias", False


ALL_CNN_ARCHS = ("resnet18", "resnet50") + tuple(sorted(_APPLY))


def random_cnn_state_dict(arch, num_classes, seed=0):
    """He-init torchvision-layout numpy state dict of a zoo arch, the
    classifier sized to ``num_classes`` (the shapes of the torchvision
    constructors; the JAX package's draws)."""
    rng = np.random.RandomState(seed)
    sd = {}

    def conv(name, cin, cout, k, bias=False, groups=1):
        sd[f"{name}.weight"] = _he(rng, (cout, cin // groups, k, k))
        if bias:
            sd[f"{name}.bias"] = np.zeros(cout, np.float32)

    def bnp(name, c):
        sd[f"{name}.weight"] = np.ones(c, np.float32)
        sd[f"{name}.bias"] = np.zeros(c, np.float32)
        sd[f"{name}.running_mean"] = np.zeros(c, np.float32)
        sd[f"{name}.running_var"] = np.ones(c, np.float32)

    def linear(name, cin, cout):
        sd[f"{name}.weight"] = _he(rng, (cout, cin))
        sd[f"{name}.bias"] = np.zeros(cout, np.float32)

    if arch.startswith("squeezenet"):
        cfg = _SQUEEZE_CFG[arch]
        k, _, c0 = cfg["stem"]
        conv("features.0", 3, c0, k, bias=True)
        cin = c0
        for i, sq, e1, e3 in cfg["fires"]:
            conv(f"features.{i}.squeeze", cin, sq, 1, bias=True)
            conv(f"features.{i}.expand1x1", sq, e1, 1, bias=True)
            conv(f"features.{i}.expand3x3", sq, e3, 3, bias=True)
            cin = e1 + e3
        conv("classifier.1", cin, num_classes, 1, bias=True)
    elif arch == "mobilenet_v2":
        conv("features.0.0", 3, 32, 3)
        bnp("features.0.1", 32)
        cin, idx = 32, 1
        for t, c, n, s in _MBV2_SETTING:
            for rep in range(n):
                p = f"features.{idx}.conv"
                hid = cin * t
                if t == 1:
                    conv(f"{p}.0.0", cin, hid, 3, groups=cin)
                    bnp(f"{p}.0.1", hid)
                    conv(f"{p}.1", hid, c, 1)
                    bnp(f"{p}.2", c)
                else:
                    conv(f"{p}.0.0", cin, hid, 1)
                    bnp(f"{p}.0.1", hid)
                    conv(f"{p}.1.0", hid, hid, 3, groups=hid)
                    bnp(f"{p}.1.1", hid)
                    conv(f"{p}.2", hid, c, 1)
                    bnp(f"{p}.3", c)
                cin = c
                idx += 1
        conv("features.18.0", 320, 1280, 1)
        bnp("features.18.1", 1280)
        linear("classifier.1", 1280, num_classes)
    elif arch == "mnasnet1_0":
        conv("layers.0", 3, 32, 3)
        bnp("layers.1", 32)
        conv("layers.3", 32, 32, 3, groups=32)
        bnp("layers.4", 32)
        conv("layers.6", 32, 16, 1)
        bnp("layers.7", 16)
        for stack_i, (cin, cout, k, s, t, reps) in enumerate(
            _MNAS_STACKS, start=8
        ):
            for rep in range(reps):
                ci = cin if rep == 0 else cout
                hid = ci * t
                p = f"layers.{stack_i}.{rep}.layers"
                conv(f"{p}.0", ci, hid, 1)
                bnp(f"{p}.1", hid)
                conv(f"{p}.3", hid, hid, k, groups=hid)
                bnp(f"{p}.4", hid)
                conv(f"{p}.6", hid, cout, 1)
                bnp(f"{p}.7", cout)
        conv("layers.14", 320, 1280, 1)
        bnp("layers.15", 1280)
        linear("classifier.1", 1280, num_classes)
    elif arch == "shufflenet_v2_x1_0":
        conv("conv1.0", 3, 24, 3)
        bnp("conv1.1", 24)
        for stage, cin, cout, reps in _SHUFFLE_STAGES:
            half = cout // 2
            for rep in range(reps):
                p = f"{stage}.{rep}"
                if rep == 0:
                    conv(f"{p}.branch1.0", cin, cin, 3, groups=cin)
                    bnp(f"{p}.branch1.1", cin)
                    conv(f"{p}.branch1.2", cin, half, 1)
                    bnp(f"{p}.branch1.3", half)
                    conv(f"{p}.branch2.0", cin, half, 1)
                else:
                    conv(f"{p}.branch2.0", half, half, 1)
                bnp(f"{p}.branch2.1", half)
                conv(f"{p}.branch2.3", half, half, 3, groups=half)
                bnp(f"{p}.branch2.4", half)
                conv(f"{p}.branch2.5", half, half, 1)
                bnp(f"{p}.branch2.6", half)
        conv("conv5.0", 464, 1024, 1)
        bnp("conv5.1", 1024)
        linear("fc", 1024, num_classes)
    else:
        raise ValueError(f"unknown arch {arch!r}")
    return sd
