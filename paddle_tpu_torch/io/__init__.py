"""The data pipeline of the port (the JAX package's `io/`): datasets,
samplers, `DataLoader` with worker processes, `DevicePrefetcher`, the
`save` / `load` file format and the crash-safe `CheckpointManager`
(`io.checkpoint`).

A batch is numpy until it leaves the worker (or the collate function,
with no workers) and then a tuple (or dict) of CPU torch tensors: the
caller moves it to the card, as `hapi.Model` does, or hands the loader
to `DevicePrefetcher`, which pins and copies batches ahead of use.

The samplers shuffle with numpy's global RNG (`np.random.permutation`),
as the JAX package's do, so one numpy seed gives both packages the same
batch order, and `hapi.Model.fit(resume=)` restores it from the
snapshot's numpy RNG state. `io.checkpoint` holds the crash-safe
`CheckpointManager` and, on it, the JAX package's `AsyncCheckpointer`,
`save_sharded` and `load_sharded` (no orbax). Parts that wait:
`DataLoader.from_generator` (the static-graph reader, with `fluid/`) and
`io/crypto.py` (with `inference/`).
"""
from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from ..core.device import resolve_device
from ..testing import faults
from .dataloader_iter import (MultiprocessIter, ThreadPrefetcher,  # noqa: F401
                              WorkerInfo)
from .serialization import load, save  # noqa: F401

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
           "ChainDataset", "Subset", "random_split", "Sampler",
           "SequenceSampler", "RandomSampler", "WeightedRandomSampler",
           "BatchSampler", "DistributedBatchSampler", "default_collate_fn",
           "DataLoader", "get_worker_info", "DevicePrefetcher",
           "MultiprocessIter", "ThreadPrefetcher", "WorkerInfo", "load",
           "save"]

_PT_DL_NEXT = faults.point("dataloader.next")


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise TypeError("IterableDataset has no __getitem__")

    def __len__(self):
        raise TypeError("IterableDataset has no __len__")


class TensorDataset(Dataset):
    def __init__(self, tensors):
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = datasets

    def __len__(self):
        return min(len(d) for d in self.datasets)

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            v = d[idx]
            out.extend(v if isinstance(v, (list, tuple)) else [v])
        return tuple(out)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = datasets

    def __iter__(self):
        for d in self.datasets:
            yield from d


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = indices

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    total = len(dataset)
    if sum(lengths) != total:
        raise ValueError("lengths must sum to dataset size")
    perm = np.random.permutation(total)
    out = []
    ofs = 0
    for n in lengths:
        out.append(Subset(dataset, perm[ofs:ofs + n].tolist()))
        ofs += n
    return out


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num = num_samples

    @property
    def num_samples(self):
        return self._num if self._num is not None else len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            return iter(np.random.randint(0, n, self.num_samples).tolist())
        return iter(np.random.permutation(n)[:self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(weights, dtype=np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        return iter(np.random.choice(
            len(self.weights), self.num_samples, self.replacement,
            p).tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


def _dist_world():
    """(world size, rank) of the default process group, (1, 0) without
    one."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class DistributedBatchSampler(BatchSampler):
    """Shards the dataset across ranks: the index list padded to a
    multiple of the ranks by its own head, rank r taking every
    num_replicas-th index from r (shuffled by a RandomState seeded with
    the epoch, `set_epoch`). `num_replicas` / `rank` default to the
    default process group's, or one rank without one."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        world, me = _dist_world()
        self.dataset = dataset
        self.batch_size = batch_size
        self.nranks = num_replicas if num_replicas is not None else world
        self.local_rank = rank if rank is not None else me
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        indices = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.epoch)
            rng.shuffle(indices)
        indices = np.concatenate(
            [indices, indices[:self.total_size - n]])
        indices = indices[self.local_rank:self.total_size:self.nranks]
        batch = []
        for idx in indices.tolist():
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size


def default_collate_fn(batch):
    """Stack a list of samples: arrays (and torch tensors) by np.stack,
    ints as int64, floats as float32, tuples and dicts field by field.
    The result is numpy, so it crosses from a worker as is."""
    sample = batch[0]
    if isinstance(sample, (list, tuple)):
        return tuple(default_collate_fn([b[i] for b in batch])
                     for i in range(len(sample)))
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    if isinstance(sample, torch.Tensor):
        return np.stack([b.detach().cpu().numpy() for b in batch])
    if isinstance(sample, np.ndarray):
        return np.stack(batch)
    if isinstance(sample, (int, np.integer)):
        return np.asarray(batch, dtype=np.int64)
    if isinstance(sample, (float, np.floating)):
        return np.asarray(batch, dtype=np.float32)
    return batch


class DataLoader:
    """Batches of a dataset in the batch sampler's order: in the calling
    thread (`num_workers=0`), in worker processes (`MultiprocessIter`,
    forkserver or spawn, `timeout` seconds a batch at most, `prefetch_factor`
    batches a worker in flight), or with `use_multiprocess=False` (or
    `use_shared_memory=False`) in a background thread. Each batch passes the `dataloader.next` fault point
    and comes out as CPU torch tensors. `places`, `return_list`,
    `use_buffer_reader` and `persistent_workers` are accepted and not
    applied (workers start anew every epoch, as in the JAX package)."""

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False, use_multiprocess=True):
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.prefetch = max(2, prefetch_factor)
        self.timeout = timeout
        self.worker_init_fn = worker_init_fn
        self._use_mp = use_multiprocess and use_shared_memory
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if self._iterable_mode:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset has no len()")
        return len(self.batch_sampler)

    def _batches(self):
        if self._iterable_mode:
            it = iter(self.dataset)
            while True:
                batch = list(itertools.islice(it, self.batch_size))
                if not batch:
                    return
                if len(batch) < self.batch_size and self.drop_last:
                    return
                yield self.collate_fn(batch)
        else:
            for idxs in self.batch_sampler:
                yield self.collate_fn([self.dataset[i] for i in idxs])

    def __iter__(self):
        if self.num_workers <= 0:
            for b in self._batches():
                yield _to_tensors(_PT_DL_NEXT(payload=b))
            return
        if self._use_mp:
            it = MultiprocessIter(
                self.dataset,
                None if self._iterable_mode else self.batch_sampler,
                self.collate_fn, self.num_workers,
                prefetch_factor=self.prefetch,
                worker_init_fn=self.worker_init_fn, timeout=self.timeout,
                iterable=self._iterable_mode,
                batch_size=self.batch_size if self._iterable_mode else 1,
                drop_last=self.drop_last if self._iterable_mode else False)
            try:
                for b in it:
                    yield _to_tensors(_PT_DL_NEXT(payload=b))
            finally:
                it.shutdown()
            return
        # threaded prefetch pipeline (the buffered_reader.cc equivalent)
        for b in ThreadPrefetcher(
                self._batches(),
                depth=self.prefetch * max(1, self.num_workers)):
            yield _to_tensors(_PT_DL_NEXT(payload=b))


def _to_tensors(batch):
    if isinstance(batch, tuple):
        return tuple(_to_tensors(b) for b in batch)
    if isinstance(batch, dict):
        return {k: _to_tensors(v) for k, v in batch.items()}
    if isinstance(batch, np.ndarray):
        return torch.from_numpy(batch)
    return batch


def get_worker_info():
    from .dataloader_iter import get_worker_info as _gwi

    return _gwi()


def _tree_map(fn, batch):
    if isinstance(batch, (tuple, list)):
        return type(batch)(_tree_map(fn, b) for b in batch)
    if isinstance(batch, dict):
        return {k: _tree_map(fn, v) for k, v in batch.items()}
    return fn(batch)


def _tensors_of(batch):
    out = []
    _tree_map(lambda a: out.append(a) if isinstance(a, torch.Tensor)
              else None, batch)
    return out


class DevicePrefetcher:
    """Batches copied to the card `depth` ahead of use (the reference's
    buffered reader, which overlaps host-to-device copies with compute).

    A background thread pulls each host batch (numpy arrays or CPU
    tensors, nested in tuples, lists and dicts), pins it and copies it
    to `device` (None: the card) on a side stream, and records an event
    after the copies. The consumer's stream waits on that event before
    the batch is handed out (a `wait_stream` on the side stream as it
    stood after that batch's copies), and every tensor of the batch
    records the consumer's stream (`record_stream`), so the allocator
    never hands its memory to the next copy while the step still reads
    it. Without the wait, a step could read a batch before its copy
    lands. On the CPU the batch passes through as tensors.

    Iterating ends the pump; `close()` ends it early. An error in the
    source iterator is raised on the consumer's side. `sharding=` (a
    `parallel.sharding.Sharding`, e.g. `parallel.batch_sharding(mesh)`
    or a mesh trainer's `batch_sharding()`) hands each rank its block
    of every tensor of the batch (`Sharding.shard`: its rows over the
    batch axes), cut on the host before the copy.
    """

    _END = object()

    def __init__(self, it, sharding=None, depth=2, device=None):
        import queue
        import threading

        if sharding is not None and not hasattr(sharding, "shard"):
            raise TypeError("DevicePrefetcher(sharding=) takes a "
                            "parallel.sharding.Sharding")
        self.device = resolve_device(device)
        self._q = queue.Queue(maxsize=max(1, depth))
        self._err = None
        self._closed = False
        cuda = self.device.type == "cuda"
        stream = torch.cuda.Stream(self.device) if cuda else None

        def place(a):
            if isinstance(a, (np.ndarray, np.generic)):
                a = torch.as_tensor(a)
            if not isinstance(a, torch.Tensor):
                return a
            if sharding is not None:
                a = sharding.shard(a)
            if cuda and a.device.type == "cpu":
                a = a.pin_memory()
            return a.to(self.device, non_blocking=True)

        def _put(item):
            # a blocking put that gives up once close() is called; the END
            # sentinel goes through here too, or a full queue would strand
            # the consumer in get()
            while not self._closed:
                try:
                    self._q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    continue

        def _pump():
            try:
                for batch in it:
                    if self._closed:
                        return
                    if not cuda:
                        _put((_tree_map(place, batch), None))
                        continue
                    with torch.cuda.stream(stream):
                        placed = _tree_map(place, batch)
                        ready = torch.cuda.Event()
                        ready.record(stream)
                    _put((placed, ready))
            except BaseException as e:  # raised on the consumer's side
                self._err = e
            finally:
                _put(self._END)

        self._thread = threading.Thread(target=_pump, daemon=True)
        self._thread.start()

    def close(self):
        """Stop the pump and drop the queued batches. Call when abandoning
        iteration early; iterating to the end cleans up on its own."""
        self._closed = True
        try:
            while True:
                self._q.get_nowait()
        except Exception:
            pass
        self._thread.join(timeout=5)

    def __iter__(self):
        try:
            while True:
                item = self._q.get()
                if item is self._END:
                    if self._err is not None:
                        raise self._err
                    return
                batch, ready = item
                if ready is not None:
                    consumer = torch.cuda.current_stream(self.device)
                    consumer.wait_event(ready)
                    for t in _tensors_of(batch):
                        t.record_stream(consumer)
                yield batch
        finally:
            self.close()
