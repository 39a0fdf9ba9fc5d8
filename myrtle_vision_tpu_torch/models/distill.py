"""DeiT knowledge distillation (port of myrtle_vision_tpu/models/distill.py;
reference: src/myrtle_vision/models/distill.py).

:class:`DistillWrapper` holds the student ViT, the learnable distillation
token and the distillation head (``distill_mlp_norm``, a LayerNorm, then
``distill_mlp_linear``), the JAX parameter tree's names.  The frozen
teacher runs outside the wrapper: its logits are an input, computed under
``torch.no_grad()`` (the JAX package's ``stop_gradient``; the reference
runs the teacher under ``torch.no_grad()``, distill.py:132-133).  The
student is the port's ViT with the token threaded through its forward
(models/vit.py), which returns the class-token logits and the
distillation token's embedding, in every format: in the float formats
(FP16_16, FP16_32, TF32) the token's two sites are stateless snaps, and
in PyTorchINT8 observers that the wrapper registers on its student
(``ViT.add_distill_sites``), as the JAX student's ``quant`` collection
holds them.  ``forward(..., calibrating=True)`` folds each micro-batch
into every observer of a PyTorchINT8 student as it runs: the JAX package's
one-pass INT8 distillation step (training/classification.py).

Loss (reference distill.py:128-151), in fp32:
  alpha * CE(student_logits, labels)
  + (1 - alpha) * T^2 * KL(log_softmax(distill_logits / T)
                           || softmax(teacher_logits / T))
with the KL reduced batchmean-style (summed over classes, averaged over
the batch).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from myrtle_vision_tpu_torch.models.vit import DISTILL_SITES, ViT
from myrtle_vision_tpu_torch.training.optim import cross_entropy_loss


def distillation_loss(student_logits, distill_logits, teacher_logits, labels,
                      temperature, alpha):
    """alpha * CE(student, labels) + (1 - alpha) * T^2 *
    KL(log_softmax(distill / T) || softmax(teacher / T)), KL batchmean
    (``F.kl_div(log_q, p, reduction="batchmean")``), in fp32."""
    t = temperature
    ce = cross_entropy_loss(student_logits, labels)
    log_q = F.log_softmax(distill_logits.float() / t, dim=-1)
    log_p = F.log_softmax(teacher_logits.float() / t, dim=-1)
    kl = (log_p.exp() * (log_p - log_q)).sum(-1).mean()
    return ce * alpha + kl * (t ** 2) * (1 - alpha)


class DistillWrapper(nn.Module):
    """The student with its distillation token and head.  ``forward(img,
    labels, teacher_logits)`` -> (the distillation loss, the student's
    fp32 logits); ``plain=True`` runs the student's plain versions, and
    ``calibrating=True`` a PyTorchINT8 student's calibrating forward
    (its observers updated, the token's two included).

    The token is drawn N(0, 1) and ``distill_mlp_linear``'s weight from
    flax's default (a normal of variance 1 / fan_in truncated at two
    standard deviations; bias 0, LayerNorm 1 and 0), on the CPU from
    ``generator`` (a fresh one seeded 0 when None)."""

    def __init__(self, student: ViT, temperature: float = 1.0,
                 alpha: float = 0.5, generator=None):
        super().__init__()
        self.student = student
        student.add_distill_sites()
        self.temperature = temperature
        self.alpha = alpha
        device = student.cls_token.device
        dim = student.dim
        self.distillation_token = nn.Parameter(
            torch.empty(1, 1, dim, device=device))
        self.distill_mlp_norm = nn.LayerNorm(dim, eps=1e-5, device=device)
        self.distill_mlp_linear = nn.Linear(dim, student.num_classes,
                                            device=device)
        self.reset_parameters(generator)

    @property
    def q_format(self):
        return self.student.q_format

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """The wrapper's own parameters (the student keeps its own)."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        token = torch.empty(self.distillation_token.shape)
        self.distillation_token.copy_(token.normal_(generator=generator))
        w = self.distill_mlp_linear.weight
        # flax lecun_normal: stddev sqrt(1 / fan_in) / 0.8796..., the
        # standard deviation of a unit normal truncated at +-2
        std = (1.0 / w.shape[1]) ** 0.5 / 0.87962566103423978
        self.distill_mlp_linear.weight.copy_(nn.init.trunc_normal_(
            torch.empty(w.shape), std=std, a=-2 * std, b=2 * std,
            generator=generator))
        self.distill_mlp_linear.bias.zero_()
        self.distill_mlp_norm.reset_parameters()

    def forward(self, img, labels, teacher_logits, plain: bool = False,
                dropout_rng=None, calibrating: bool = False):
        student_logits, tokens = self.student(
            img, plain=plain, calibrating=calibrating,
            distill_token=self.distillation_token, dropout_rng=dropout_rng)
        x = self.distill_mlp_norm(tokens)
        distill_logits = self.distill_mlp_linear(x)
        loss = distillation_loss(student_logits, distill_logits,
                                 teacher_logits, labels, self.temperature,
                                 self.alpha)
        return loss, student_logits


class DistillableViT(ViT):
    """The reference's DistillableViT (reference distill.py:11-27): the
    port's ViT already takes a ``distill_token`` in its forward and
    returns (logits, the token's embedding), and its parameters are a
    plain ViT's, so :meth:`to_vit` gives a ViT with the same
    constructor arguments and the same weights (and observers, but for a
    PyTorchINT8 student's two of its token)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._init_args = (args, kwargs)

    def to_vit(self) -> ViT:
        args, kwargs = self._init_args
        vit = ViT(*args, **kwargs)
        vit.load_state_dict({
            name: t for name, t in self.state_dict().items()
            if name.split(".")[0] not in DISTILL_SITES}, strict=True)
        return vit
