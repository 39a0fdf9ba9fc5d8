"""The (data, model) grid of ranks of multi-GPU training (port of
myrtle_vision_tpu/parallel/mesh.py ``make_mesh`` and
``mesh_from_dist_config``).

The JAX package runs one SPMD program over a device mesh; the port runs
one process per GPU, as the reference does (``mp.spawn`` and
``DistributedDataParallel``), so a mesh here is this rank's place in the
grid and the process groups of its row and its column:

  - ``data``: the batch is split over the data index; gradients average
    over the data group (``DistributedDataParallel``, training/trainer.py);
  - ``model``: head-sharded tensor parallelism (parallel/tp.py), each rank
    of a model group running its share of the heads and hidden columns.

Ranks lie data-major, as ``make_mesh`` reshapes the devices to (n_data,
tensor_parallel): rank r is at data index r // tensor_parallel and model
index r % tensor_parallel.  ``dist_config`` is the reference's schema
({"dist_backend", "dist_url"}, with ``group_name`` accepted and the JAX
package's ``tensor_parallel``); unlike the JAX package, which leaves the
rendezvous to its runtime, the backend ("nccl" on the card, or "gloo") and
the URL are used.  Where the fused gate refuses, the port reaches the
results of the JAX package's GSPMD layout (``_TP_RULES``: ``to_qkv`` and
``fc1`` column-parallel, ``to_out`` and ``fc2`` row-parallel) by splitting
the discrete Blocks' products over the model group and running the fused
ones whole (parallel/tp.py); the parameters and their optimizer state
stay whole on every rank, where GSPMD shards their storage.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

DIST_KEYS = ("dist_backend", "dist_url", "group_name", "tensor_parallel")
BACKENDS = ("nccl", "gloo")


def parse_dist_config(dist_config: Optional[dict]) -> dict:
    """{"backend", "url", "tensor_parallel"} of a ``dist_config`` (None or
    {} take the defaults: no backend named, no URL, tensor parallel 1).
    Keys outside :data:`DIST_KEYS` raise, as in the JAX package; so does
    a backend other than nccl or gloo, or a tensor-parallel size below 1."""
    dist_config = dist_config or {}
    unknown = set(dist_config) - set(DIST_KEYS)
    if unknown:
        raise ValueError(f"unknown dist_config keys: {sorted(unknown)}")
    backend = dist_config.get("dist_backend")
    if backend is not None and backend not in BACKENDS:
        raise ValueError(f"dist_config dist_backend {backend!r}: expected "
                         f"one of {BACKENDS}")
    tp = int(dist_config.get("tensor_parallel", 1))
    if tp < 1:
        raise ValueError(f"dist_config tensor_parallel {tp}: expected >= 1")
    return {"backend": backend, "url": dist_config.get("dist_url"),
            "tensor_parallel": tp}


def backend_for(parsed: dict, device) -> str:
    """The process-group backend of ``device``: the config's, which a CPU
    device refuses if it is nccl (nothing switches backend on its own);
    without one, nccl on a CUDA device and gloo on the CPU."""
    backend = parsed["backend"]
    if backend is None:
        return "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(
            "dist_config dist_backend 'nccl' needs CUDA devices; "
            f"--device {device.type} trains over several processes with "
            "dist_backend 'gloo'")
    return backend


def rank_grid(world: int, tensor_parallel: int = 1) -> np.ndarray:
    """(n_data, tensor_parallel) array of ranks, data-major: the order in
    which ``make_mesh`` lays the devices out."""
    if world % tensor_parallel != 0:
        raise ValueError(f"device count {world} not divisible by "
                         f"tensor_parallel={tensor_parallel}")
    return np.arange(world).reshape(world // tensor_parallel,
                                    tensor_parallel)


@dataclasses.dataclass
class Mesh:
    """This rank's place in the grid, and its groups: ``data_group`` the
    ranks of its column (its model index, every data index), None with
    one data rank; ``model_group`` those of its row, None without tensor
    parallelism."""
    rank: int = 0
    world: int = 1
    tensor_parallel: int = 1
    data_group: object = None
    model_group: object = None

    @property
    def n_data(self) -> int:
        return self.world // self.tensor_parallel

    @property
    def data_index(self) -> int:
        return self.rank // self.tensor_parallel

    @property
    def model_index(self) -> int:
        return self.rank % self.tensor_parallel

    @property
    def distributed(self) -> bool:
        return self.world > 1


def make_mesh(tensor_parallel: int = 1) -> Mesh:
    """The mesh of this process: one rank without a process group; in one
    (torch.distributed initialised) the grid of its world, with the data
    and model groups made on every rank in the same order, as
    ``torch.distributed.new_subgroups_by_enumeration`` requires."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        rank_grid(1, tensor_parallel)
        return Mesh()
    world, rank = dist.get_world_size(), dist.get_rank()
    grid = rank_grid(world, tensor_parallel)
    mesh = Mesh(rank, world, tensor_parallel)
    if grid.shape[0] > 1:
        if tensor_parallel == 1:
            mesh.data_group = dist.group.WORLD
        else:
            mesh.data_group, _ = dist.new_subgroups_by_enumeration(
                grid.T.tolist())
    if tensor_parallel > 1:
        mesh.model_group, _ = dist.new_subgroups_by_enumeration(
            grid.tolist())
    return mesh


def mesh_from_dist_config(dist_config: Optional[dict]) -> Mesh:
    """:func:`make_mesh` with the config's ``tensor_parallel``, after its
    validation (:func:`parse_dist_config`)."""
    return make_mesh(parse_dist_config(dist_config)["tensor_parallel"])


def train_loader_kwargs(train_config, mesh: Mesh, batch_size: int,
                        n_batch_accum: int) -> dict:
    """The train loader's batch and sharding on ``mesh`` (data/loader.py):
    one optimizer step's images of every data rank, each rank keeping its
    block of each micro-batch (the JAX CLIs' ``process_shard``), drop_last
    with more than one data rank; one rank's step as before with one."""
    if mesh.n_data == 1:
        return dict(batch_size=batch_size * n_batch_accum,
                    drop_last=train_config["drop_last_batch"])
    return dict(batch_size=batch_size * n_batch_accum * mesh.n_data,
                drop_last=True, accum_steps=n_batch_accum,
                process_shard=(mesh.data_index, mesh.n_data))
