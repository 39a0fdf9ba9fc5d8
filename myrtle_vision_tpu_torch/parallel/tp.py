"""Head-sharded tensor parallelism through the fused block-half kernels
(port of myrtle_vision_tpu/parallel/tp.py).

Megatron-style tensor parallelism over a model group (parallel/mesh.py):

  - parameters stay whole and replicated on every rank of the group, so
    the checkpoint schema is the reference's; each Block (models/vit.py)
    slices its local heads and hidden columns at the kernel boundary
    (:func:`shard_cols`, :func:`shard_rows`), so the products and the
    attention working set split n_tp ways;
  - the block-half op computes the PARTIAL output with the residual and
    the output-projection bias scaled by 1/n_tp (``res_scale``, K1-K4),
    and :func:`partial_out`'s all-reduce over the group reassembles
    x + proj + bias;
  - :func:`replicated_in` on the block input sums the ranks' partial
    input gradients in the backward, so every gradient that leaves a
    block is whole.  The block parameters' own gradients are partial on
    each rank (its heads' slices, its share of the LayerNorm and bias
    gradients); their sum over the group, one all-reduce after the
    backward (training/trainer.py), equals the JAX package's psum of each
    through ``replicated_in``, because both are linear.

The Megatron f / g pair:
  ``replicated_in`` -- identity forward, all-reduce backward;
  ``partial_out``   -- all-reduce forward, identity backward.

``fused_gate`` decides, as the JAX trainer does, whether a model trains
this way; where it says no, tensor parallelism (the GSPMD form in the JAX
package) is not ported, and the train CLIs raise (ROADMAP A9b).
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


def train_sequence(vit) -> int:
    """Tokens of ``vit`` at its training size: the patches, the class
    token and, for a detector, the detection tokens."""
    seq = (vit.image_size // vit.patch_size) ** 2 + 1
    if vit.decoder_name == "detection":
        seq += vit.num_det_tokens
    return seq


def fused_gate(vit, n_tp: int, extra_ok: bool = True) -> bool:
    """Whether ``vit`` trains with head-sharded tensor parallelism through
    the fused kernels over ``n_tp`` ranks: the JAX trainer's conditions
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


def enable(model, mesh) -> bool:
    """Give every Block of ``model`` (a ViT) its place in ``mesh``'s model
    group, so that training runs its halves on the local heads; True
    where ``mesh`` has a model group.  The caller has checked
    :func:`fused_gate`."""
    if mesh.model_group is None:
        return False
    tp = TensorParallel(mesh.model_group, mesh.model_index,
                        mesh.tensor_parallel)
    for block in model.transformer.layers:
        block.tp = tp
    return True


def sharded_parameters(model):
    """The parameters whose gradients are partial on each rank of a model
    group: those of the Blocks that run tensor-parallel."""
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
    head-sharded over its model group where :func:`fused_gate` holds, and
    raise where it does not: that form (the JAX package's GSPMD one) is
    not ported (ROADMAP A9b).  True where the Blocks run sharded."""
    if mesh.tensor_parallel == 1:
        return False
    if not fused_gate(vit, mesh.tensor_parallel, extra_ok):
        raise NotImplementedError(
            f"tensor_parallel {mesh.tensor_parallel} where the fused gate "
            "does not hold (a quantized format, dropout, a distiller, "
            "heads or mlp_dim not divisible, the training length past "
            "fuses_at, or MVT_NO_FUSE=1): the JAX package's GSPMD form is "
            "not ported yet; see ROADMAP.md A9b")
    print(f"tensor parallel: fused-kernel head sharding "
          f"(x{mesh.tensor_parallel})")
    return enable(vit, mesh)
