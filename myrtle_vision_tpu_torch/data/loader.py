"""Host input pipeline of one process: threaded decode/augment, batches
in pinned host memory, copied to the device without blocking.

Port of ``DataLoader.epoch`` of myrtle_vision_tpu/data/loader.py (whose
module imports jax): the same item order (a permutation
seeded by ``seed + epoch`` under ``shuffle``, file order otherwise), the
same per-item generators, seeded by ``(seed * 100003 + epoch)`` and the
item index, and the same ``drop_last`` / ``pad_last`` semantics
(``pad_last`` repeats the last item up to ``batch_size`` and tags the
batch with ``"_n_valid"``), so that both loaders yield the same pixels.
``collate_fn`` turns the items of a batch into a dict of numpy arrays, as
the JAX loader's does (default: stack each key of dict items); every
array then goes to the device as it is, integer and bool fields
included.

``process_shard=(index, count)`` makes the loader one rank's share of a
multi-process run, as the JAX loader's: every rank takes the same
permutation and keeps, of each batch of ``batch_size`` indices laid out
as (``accum_steps``, batch_size / accum_steps), its own contiguous block
of columns [index l, (index + 1) l) of every row, l = the micro-batch /
count (the reference's DistributedSampler, classification/train.py:116);
it needs ``drop_last`` with more than one process and refuses
``pad_last``, with the JAX loader's errors.
"""
from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np
import torch


_WORKERS = 8  # decode threads (PIL releases the GIL)
_AHEAD = 3    # batches submitted ahead of the one being collated


class DataLoader:
    def __init__(self, dataset, batch_size: int, device,
                 shuffle: bool = False, seed: int = 0,
                 drop_last: bool = True, pad_last: bool = False,
                 collate_fn=None, process_shard=None, accum_steps: int = 1):
        if process_shard is not None:
            pid, pcount = process_shard
            if pcount > 1 and not drop_last:
                raise ValueError(
                    "process_shard requires drop_last=True (a ragged "
                    "final batch cannot be evenly sharded over processes)"
                )
            if pad_last:
                raise ValueError(
                    "pad_last is incompatible with process_shard; "
                    "shard-evaluate with drop_last or evaluate on one "
                    "process"
                )
            micro = batch_size // accum_steps
            if batch_size % accum_steps or micro % pcount:
                raise ValueError(
                    f"batch_size {batch_size} must split into "
                    f"accum_steps={accum_steps} x process-divisible "
                    f"micro-batches (processes={pcount})"
                )
        self.process_shard = process_shard
        self.accum_steps = accum_steps
        self.dataset = dataset
        self.batch_size = batch_size
        self.device = torch.device(device)
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.pad_last = pad_last
        self.collate_fn = collate_fn or _collate

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _to_device(self, batch: dict) -> dict:
        out = {}
        pin = self.device.type == "cuda"
        for key, arr in batch.items():
            t = torch.from_numpy(arr)
            if pin:
                t = t.pin_memory()
            out[key] = t.to(self.device, non_blocking=True)
        return out

    def epoch(self, epoch: int = 0) -> Iterator[dict]:
        """Yield batches of device tensors (by default "image" float32
        NHWC, "label" int32), plus the int "_n_valid" under
        ``pad_last``."""
        n = len(self.dataset)
        if self.shuffle:
            order = np.random.RandomState(self.seed + epoch).permutation(n)
        else:
            order = np.arange(n)
        n_batches = len(self)
        item_seed = (self.seed * 100003 + epoch) & 0x7FFFFFFF

        def fetch(idx: int):
            rng = np.random.default_rng((item_seed, int(idx)))
            return self.dataset.__getitem__(int(idx), rng=rng)

        with ThreadPoolExecutor(_WORKERS) as pool:
            pending = collections.deque()

            def submit(b):
                idxs = order[b * self.batch_size:(b + 1) * self.batch_size]
                n_valid = len(idxs)
                if self.pad_last and n_valid < self.batch_size:
                    idxs = np.concatenate(
                        [idxs, np.repeat(idxs[-1], self.batch_size - n_valid)]
                    )
                if self.process_shard is not None:
                    pid, pcount = self.process_shard
                    local = len(idxs) // self.accum_steps // pcount
                    idxs = idxs.reshape(self.accum_steps, -1)[
                        :, pid * local:(pid + 1) * local].reshape(-1)
                    n_valid = len(idxs)
                pending.append((n_valid, [pool.submit(fetch, i)
                                          for i in idxs]))

            for b in range(min(_AHEAD, n_batches)):
                submit(b)
            for b in range(n_batches):
                n_valid, futures = pending.popleft()
                if b + _AHEAD < n_batches:
                    submit(b + _AHEAD)
                items = [f.result() for f in futures]
                batch = self._to_device(self.collate_fn(items))
                if self.pad_last:
                    batch["_n_valid"] = n_valid
                yield batch


def _collate(items):
    return {key: np.stack([it[key] for it in items]) for key in items[0]}
