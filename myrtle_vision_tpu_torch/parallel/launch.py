"""How a train CLI runs over several GPUs: one process a rank, as the
reference spawns them (``mp.spawn``, ``DistributedDataParallel``).

:func:`run` calls ``train_fn(config, device, mesh)`` on every rank:

  - MVT_COORDINATOR set (with MVT_NUM_PROCESSES and MVT_PROCESS_ID, as
    the JAX package reads them): this process is one rank, launched by
    the caller; it joins the group at the coordinator's ``host:port``
    (on CUDA, on device ``rank % device_count``);
  - else, on CUDA with ``train_config.distributed`` (default true) and
    more than one visible device: one process per device, started with
    ``torch.multiprocessing`` (start method ``spawn``; the parent touches
    no CUDA context), rendezvous at ``dist_config.dist_url`` (a free
    localhost port without one), after the kernels are built once in the
    parent, so that no rank compiles inside the group's timeout;
  - else one rank, and nothing changes: no process group, no wrapper.

The backend is ``dist_config.dist_backend`` (parallel/mesh.py
``backend_for``: nccl on CUDA by default; nccl with ``--device cpu``
raises), the layout its ``tensor_parallel``.
"""
from __future__ import annotations

import os
import socket

import torch

from myrtle_vision_tpu_torch.parallel import collectives
from myrtle_vision_tpu_torch.parallel.mesh import (
    backend_for,
    mesh_from_dist_config,
    parse_dist_config,
)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _build_kernels(device) -> None:
    if device.type == "cuda":
        from myrtle_vision_tpu_torch.ops import _build

        _build.build()


def _rank(train_fn, config, device, backend, url, world, rank):
    """Join the group as ``rank``, train, leave."""
    if device.type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    collectives.init_rank(backend, url, world, rank)
    try:
        return train_fn(config, device, mesh_from_dist_config(
            config.get("dist_config")))
    finally:
        collectives.shutdown()


def _spawned(index, train_fn, config, backend, url, world):
    _rank(train_fn, config, torch.device("cuda"), backend, url, world, index)


def run(train_fn, config, device):
    """``train_fn(config, device, mesh)`` on this process's rank, or on
    one spawned rank per GPU (the module docstring); its result, or None
    in a parent that spawned."""
    parsed = parse_dist_config(config.get("dist_config"))
    coordinator = os.environ.get("MVT_COORDINATOR")
    if coordinator:
        world = int(os.environ.get("MVT_NUM_PROCESSES", 1))
        rank = int(os.environ.get("MVT_PROCESS_ID", 0))
        backend = backend_for(parsed, device)
        _build_kernels(device)
        return _rank(train_fn, config, device, backend, coordinator, world,
                     rank)
    n = 1
    if device.type == "cuda" and config["train_config"].get("distributed",
                                                            True):
        n = torch.cuda.device_count()
    if n > 1:
        backend = backend_for(parsed, device)
        url = parsed["url"] or f"tcp://localhost:{free_port()}"
        _build_kernels(device)
        torch.multiprocessing.start_processes(
            _spawned, args=(train_fn, config, backend, url, n), nprocs=n,
            start_method="spawn")
        return None
    return train_fn(config, device, mesh_from_dist_config(
        config.get("dist_config")))
