"""Tensor parallelism over a model group (port of
myrtle_vision_tpu/parallel/tp.py, and of the results of the JAX trainer's
GSPMD branch).

Parameters and optimizer state stay whole and replicated on every rank of
the group (parallel/mesh.py), so the checkpoint schema is the
reference's; each Block (models/vit.py) takes its local slices at the
operation boundary (:func:`shard_cols`, :func:`shard_rows`).  In
training a Block runs in one of three forms (``Block.tp_form``), decided
by what it would run alone:

  - ``"sharded"`` (the JAX ``tp_fused`` branch; :func:`fused_gate` held
    and the Block fuses): each fused block-half op on the local heads
    and hidden columns computes the PARTIAL output with the residual and
    the output-projection bias scaled by 1/n_tp (``res_scale``, K1-K4),
    and :func:`partial_out`'s all-reduce reassembles x + proj + bias;
  - ``"split"`` (the Block runs its discrete composition: past
    ``fuses_at``, ``MVT_NO_FUSE=1``, active dropout; GSPMD partitions
    its XLA dots): Megatron's split of the discrete Block, the
    LayerNorms replicated, ``to_qkv`` and ``fc1`` on the local columns
    with their bias, snaps and GELU, attention on the local heads,
    ``to_out`` and ``fc2`` an fp32 partial product of the local rows,
    summed over the group before the rounding, the bias, the snaps,
    dropout and the residual add run replicated (:class:`Split`);
  - ``"whole"`` (the Block fuses but the gate refused: a quantized
    format's K1-K4 chains, a distiller, heads or ``mlp_dim`` that do not
    divide; GSPMD gathers around the Pallas calls; or a discrete Block
    whose heads or ``mlp_dim`` do not divide): the whole Block on every
    rank of the group.

Every gradient that leaves a Block is whole: ``sharded`` and ``split``
take the block-half input through :func:`replicated_in`, whose backward
sums the ranks' partial input gradients, and ``whole`` computes it whole.
The Block's own parameter gradients are summed over the group after the
backward (training/trainer.py, :func:`reduce_sharded_gradients`), which
equals the JAX package's gradient because every rank's share is made a
part of it: the local slices' gradients are partial by construction (the
other slices get zero), the LayerNorms' are partial through
``replicated_in``, and what every rank computes whole -- an output bias
added after the all-reduce, every parameter of a ``whole`` Block -- is
scaled by 1/n_tp on its way back (:func:`scale_grad`; ``sharded``
scales the bias by 1/n_tp in the forward).  So a step may mix forms (a
detection batch past ``fuses_at``, the next inside it) and the sum stays
right.

The Megatron f / g pair:
  ``replicated_in`` -- identity forward, all-reduce backward;
  ``partial_out``   -- all-reduce forward, identity backward.

The JAX package's GSPMD also shards the storage of the split parameters
and their AdamW state; the port keeps them whole on every rank (at this
repo's sizes, vit_base at most, that saves no memory worth a design).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from myrtle_vision_tpu_torch.ops.fused_attention_block import fuses_at


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """A Block's place in its model group: the group, this rank's index
    in it and its size."""
    group: object
    index: int
    size: int
    # the fused gate held: a Block that fuses runs head-sharded
    fused: bool = True


class _ReplicatedIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _PartialOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, factor):
        ctx.factor = factor
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.factor, None


def scale_grad(x, factor: float):
    """Identity forward; the gradient times ``factor`` backward."""
    return _ScaleGrad.apply(x, factor)


def replicated_in(x, group):
    """Identity forward; the gradient summed over ``group`` backward."""
    return _ReplicatedIn.apply(x, group)


def partial_out(x, group):
    """``x`` summed over ``group`` forward (in x's dtype); the gradient
    as it is backward (it is replicated already)."""
    return _PartialOut.apply(x, group)


def shard_cols(w, idx: int, n_shards: int, n_sections: int = 1):
    """Local block ``idx`` of the output features of a torch (out, in)
    weight or of a bias, dim 0 (the JAX (in, out) layout's columns), which
    is ``n_sections`` equal sections each cut into ``n_shards`` blocks
    (n_sections=3 cuts the fused [q|k|v] projection so that the local
    layout stays [q_loc|k_loc|v_loc])."""
    sec = w.shape[0] // n_sections
    cl = sec // n_shards
    parts = [w[s * sec + idx * cl:s * sec + (idx + 1) * cl]
             for s in range(n_sections)]
    return parts[0] if n_sections == 1 else torch.cat(parts)


def shard_rows(w, idx: int, n_shards: int):
    """Local block ``idx`` of the input features of a torch (out, in)
    weight, dim 1 (the JAX (in, out) layout's rows)."""
    rl = w.shape[1] // n_shards
    return w[:, idx * rl:(idx + 1) * rl]


class Split:
    """A discrete Block's Megatron split over a model group (the
    ``"split"`` form of the module docstring); ``Split()`` splits nothing,
    every method the identity, so that the one-process discrete Blocks run
    the same code unchanged."""

    def __init__(self, tp: TensorParallel = None):
        self.tp = tp
        self.group = None if tp is None else tp.group
        self.index, self.size = (0, 1) if tp is None else (tp.index, tp.size)

    def replicated(self, x):
        """A block half's input: :func:`replicated_in`."""
        return x if self.tp is None else replicated_in(x, self.group)

    def cols(self, w, n_sections: int = 1):
        """The local output features of a weight or bias
        (:func:`shard_cols`)."""
        if self.tp is None:
            return w
        return shard_cols(w, self.index, self.size, n_sections)

    def rows(self, w):
        """The local input features of a weight (:func:`shard_rows`)."""
        return w if self.tp is None else shard_rows(w, self.index, self.size)

    def reduce(self, partial):
        """A row-parallel product's partial sum, summed over the group
        (:func:`partial_out`)."""
        return partial if self.tp is None else partial_out(partial,
                                                           self.group)

    def whole(self, t):
        """A parameter that every rank uses whole after the reduction (an
        output bias): its gradient scaled by 1/n_tp, so that the group's
        sum is the gradient."""
        return t if self.tp is None else scale_grad(t, 1.0 / self.size)

    def local_cols(self, full, x):
        """``full``'s last-dimension block of this rank, ``x``'s width."""
        if self.tp is None:
            return full
        w = x.shape[-1]
        return full[..., self.index * w:(self.index + 1) * w]


def train_sequence(vit) -> int:
    """Tokens of ``vit`` at its training size: the patches, the class
    token and, for a detector, the detection tokens."""
    seq = (vit.image_size // vit.patch_size) ** 2 + 1
    if vit.decoder_name == "detection":
        seq += vit.num_det_tokens
    return seq


def fused_gate(vit, n_tp: int, extra_ok: bool = True) -> bool:
    """Whether ``vit``'s fusing Blocks train head-sharded through the
    fused kernels over ``n_tp`` ranks (the ``"sharded"`` form): the JAX
    trainer's conditions
    (myrtle_vision_tpu/parallel/tp.py ``fused_gate``), each as the Block's
    own gate (models/vit.py ``Block.fuses``) reads it: a model group of
    more than one; ``extra_ok`` (the caller's exclusions: a distiller
    wraps the model); FP32 ``q_format`` (the quantized formats snap the
    residual sum, which is not linear over partial sums); heads and
    ``mlp_dim`` divisible by ``n_tp``; dropout 0; ``fuses_at`` at the
    training length; ``MVT_NO_FUSE`` unset."""
    from myrtle_vision_tpu_torch.models.vit import no_fuse

    block = vit.transformer.layers[0]
    heads, mlp_dim = block.heads, block._modules["1"].fn.fn.net[0].out_features
    return (n_tp > 1
            and extra_ok
            and vit.q_format.name == "FP32"
            and heads % n_tp == 0
            and mlp_dim % n_tp == 0
            and vit.dropout == 0.0
            and fuses_at(train_sequence(vit), heads, block.dim_head)
            and not no_fuse())


def enable(model, mesh, fused: bool = True) -> bool:
    """Give every Block of ``model`` (a ViT) its place in ``mesh``'s model
    group, so that training runs it in its form of the module docstring
    (``fused``: :func:`fused_gate` held); True where ``mesh`` has a model
    group."""
    if mesh.model_group is None:
        return False
    tp = TensorParallel(mesh.model_group, mesh.model_index,
                        mesh.tensor_parallel, fused)
    for block in model.transformer.layers:
        block.tp = tp
    return True


def sharded_parameters(model):
    """The parameters whose gradients each rank of a model group holds a
    part of, summed over the group after the backward: those of the
    Blocks that run over the group, in any form."""
    return [p for m in model.modules() if getattr(m, "tp", None) is not None
            for p in m.parameters()]


def reduce_sharded_gradients(model, group) -> None:
    """Sum the partial gradients of :func:`sharded_parameters` over the
    model group, in one all-reduce of their concatenation."""
    grads = [p.grad for p in sharded_parameters(model) if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def setup_tensor_parallel(vit, mesh, extra_ok: bool = True) -> bool:
    """On a ``mesh`` with tensor parallelism, set ``vit``'s Blocks to run
    over its model group: head-sharded where :func:`fused_gate` holds,
    else each Block split or whole as the JAX GSPMD step runs it (the
    module docstring).  True where the Blocks run over a group."""
    if mesh.tensor_parallel == 1:
        return False
    fused = fused_gate(vit, mesh.tensor_parallel, extra_ok)
    how = ("fused-kernel head sharding" if fused else
           "discrete blocks split, fused blocks whole on every rank")
    print(f"tensor parallel: {how} (x{mesh.tensor_parallel})")
    return enable(vit, mesh, fused)
