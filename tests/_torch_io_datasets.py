"""Datasets, worker hooks and a deadline for the DataLoader tests of the
port (`test_torch_io.py`, `test_torch_hapi.py`). They live in a module of
their own that imports only numpy, torch and the port: worker processes
start by forkserver or spawn and import the module of every class they
unpickle, and the test modules import JAX."""
import contextlib
import os
import signal
import threading

import numpy as np
import torch

from paddle_tpu_torch import io as tio


class Seq:
    """Map-style, for either package's DataLoader: sample i is (a float32
    vector of i's, int64 i)."""

    def __init__(self, n=23):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.full((3,), i, np.float32), np.int64(i)


class BadItem(tio.Dataset):
    def __len__(self):
        return 4

    def __getitem__(self, i):
        raise ValueError("boom")


class WorkerId(tio.Dataset):
    def __len__(self):
        return 6

    def __getitem__(self, i):
        wi = tio.get_worker_info()
        return np.int64(wi.id if wi is not None else -1)


class CudaState(tio.Dataset):
    """What a worker sees of CUDA: whether the cards are hidden and
    whether torch has opened a context."""

    def __len__(self):
        return 4

    def __getitem__(self, i):
        return (np.int64(os.environ.get("CUDA_VISIBLE_DEVICES") == ""),
                np.int64(torch.cuda.is_initialized()))


class Stream(tio.IterableDataset):
    def __iter__(self):
        for i in range(10):
            yield np.float32(i)


class ShardedStream(tio.IterableDataset):
    def __iter__(self):
        wi = tio.get_worker_info()
        wid = wi.id if wi else 0
        nw = wi.num_workers if wi else 1
        for i in range(wid, 10, nw):
            yield np.float32(i)


class UnbalancedStream(tio.IterableDataset):
    """Worker 0 holds 2 samples and worker 1 holds 20: an exhausted worker
    must not end the epoch while the other still has data."""

    def __iter__(self):
        wi = tio.get_worker_info()
        wid = wi.id if wi else 0
        for i in range(2 if wid == 0 else 20):
            yield np.float32(wid * 1000 + i)


def bad_init(wid):
    raise ValueError("init fail")


@contextlib.contextmanager
def deadline(seconds=120):
    """Fail (TimeoutError) instead of hanging when the body outlasts
    `seconds`; a no-op off the main thread, where signals cannot go."""
    if threading.current_thread() is not threading.main_thread():
        yield
        return

    def _fire(signum, frame):
        raise TimeoutError(f"test body exceeded its {seconds} s deadline")

    old = signal.signal(signal.SIGALRM, _fire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)
