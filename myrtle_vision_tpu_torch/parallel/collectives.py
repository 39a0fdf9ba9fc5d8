"""Process-level collectives: joining a multi-process run, the rank
helpers, metric averaging and pickled gathers (port of
myrtle_vision_tpu/parallel/collectives.py; reference
utils/utils.py:128-240).

``initialize_multihost`` joins the process group of a run whose ranks
were launched one by one (MVT_COORDINATOR, MVT_NUM_PROCESSES,
MVT_PROCESS_ID, as in the JAX package); parallel/launch.py spawns one
rank per GPU where a train CLI runs alone.  Every group gets a finite
timeout (``MVT_DIST_TIMEOUT`` seconds, default :data:`TIMEOUT_S`), so that
a rank that never arrives fails the run instead of hanging it.  The host
gathers pickle their payloads (``torch.distributed.all_gather_object``),
which gloo carries for CUDA tensors too: it has no all-gather of device
tensors.  With one process every helper returns its input.
"""
from __future__ import annotations

import datetime
import os

import numpy as np
import torch.distributed as dist

TIMEOUT_S = 600.0


def timeout() -> datetime.timedelta:
    return datetime.timedelta(
        seconds=float(os.environ.get("MVT_DIST_TIMEOUT", TIMEOUT_S)))


def init_url(address: str) -> str:
    """A ``tcp://`` init URL of ``host:port`` (a URL stays as it is)."""
    return address if "://" in address else f"tcp://{address}"


def init_rank(backend: str, url: str, world: int, rank: int) -> None:
    """Join the default process group as ``rank`` of ``world``."""
    dist.init_process_group(backend, init_method=init_url(url),
                            world_size=world, rank=rank, timeout=timeout())


def initialize_multihost(backend: str = "gloo", coordinator_address=None,
                         num_processes=None, process_id=None) -> bool:
    """Join the run's process group (``backend``, the coordinator's
    ``host:port`` as the rendezvous).  Reads MVT_COORDINATOR /
    MVT_NUM_PROCESSES / MVT_PROCESS_ID where the arguments are omitted;
    False, and nothing joined, without a coordinator."""
    coordinator_address = coordinator_address or os.environ.get(
        "MVT_COORDINATOR")
    if coordinator_address is None:
        return False
    num_processes = int(num_processes or os.environ.get(
        "MVT_NUM_PROCESSES", 1))
    process_id = int(process_id or os.environ.get("MVT_PROCESS_ID", 0))
    init_rank(backend, coordinator_address, num_processes, process_id)
    return True


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def process_index() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def is_main_process() -> bool:
    return process_index() == 0


def all_gather_host(data, group=None):
    """Every rank's picklable ``data``, in rank order (the reference's
    pickled all_gather, utils.py:153-193)."""
    if process_count() == 1:
        return [data]
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, data, group=group)
    return out


def reduce_dict(metrics: dict, average: bool = True, group=None) -> dict:
    """Average (or sum) a dict of scalars over the ranks, keys sorted so
    that every rank adds the same values in the same order (reference
    utils/utils.py:196-220)."""
    if process_count() == 1:
        return metrics
    keys = sorted(metrics)
    values = np.asarray([float(metrics[k]) for k in keys], np.float32)
    gathered = all_gather_host(values, group)
    total = np.sum(np.stack(gathered), axis=0)
    if average:
        total = total / len(gathered)
    return {k: float(v) for k, v in zip(keys, total)}


def merge_coco_evaluators(evaluator, group=None):
    """Every rank's CocoEvaluator predictions merged into ``evaluator``
    (the reference's synchronize_between_processes,
    datasets/coco_eval.py:66-69)."""
    if process_count() == 1:
        return evaluator
    for preds in all_gather_host(evaluator.predictions, group):
        evaluator.update(preds)
    return evaluator
