"""Multiprocess DataLoader workers (the JAX package's
`io/dataloader_iter.py`, the port's own copy).

Worker processes pull batches of indices from an index queue, collate
the samples and push numpy batches back through a result queue; the
parent reorders what arrives out of order, so batches come in the
sampler's order. A worker's exception (or its `worker_init_fn`'s)
travels to the parent and is raised there; a `timeout` bounds each wait
for a batch.

Workers never touch CUDA:
  * they start by forkserver (or spawn), never by fork: a forked child of
    a process that holds a CUDA context must not use it, and fork also
    copies the parent's threads' locks. `PT_DATALOADER_START_METHOD`
    overrides the method;
  * each worker hides every card (`CUDA_VISIBLE_DEVICES=""`) before it
    unpickles the dataset, so a dataset or transform that reaches for the
    card fails in the worker instead of opening a context there;
  * batches cross as numpy; the parent turns them into tensors, and pins
    and copies them to the card (`hapi.Model`, `io.DevicePrefetcher`).
The forkserver preloads `paddle_tpu_torch.io` (and so torch) once, so a
worker forks from a process that has imported torch, instead of
importing it again (torch's import starts no thread and no CUDA).

Each worker seeds numpy with `seed + worker id`; Python's `random` is
not reseeded (the JAX package's behaviour), so transforms that draw from
it are not reproducible across runs when they run in workers.
"""
from __future__ import annotations

import atexit
import itertools
import multiprocessing as mp
import os
import pickle
import queue
import threading
import weakref

__all__ = ["WorkerInfo", "MultiprocessIter", "ThreadPrefetcher",
           "get_worker_info"]

# one process-level hook; iterators register into a weak set so per-epoch
# iterators are collectable (atexit must not pin them)
_live_iters = weakref.WeakSet()


def _shutdown_all():
    for it in list(_live_iters):
        try:
            it.shutdown()
        except Exception:
            pass


atexit.register(_shutdown_all)


class WorkerInfo:
    """fluid/dataloader/worker.py WorkerInfo equivalent."""

    def __init__(self, id, num_workers, dataset, seed):
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset
        self.seed = seed

    def __repr__(self):
        return (f"WorkerInfo(id={self.id}, num_workers={self.num_workers}, "
                f"seed={self.seed})")


_worker_info = None


def get_worker_info():
    """Inside a worker process returns its WorkerInfo, else None
    (paddle.io.get_worker_info parity)."""
    return _worker_info


def _worker_loop(dataset, index_queue, result_queue, collate_fn, wid,
                 num_workers, seed, worker_init_fn, iterable, drop_last):
    global _worker_info
    import numpy as np

    np.random.seed((seed + wid) % (2**32))
    _worker_info = WorkerInfo(wid, num_workers, dataset, seed + wid)
    if worker_init_fn is not None:
        try:
            worker_init_fn(wid)
        except Exception as e:
            result_queue.put(("init_error", None, e))
            return
    # Reference semantics (fluid/dataloader/worker.py): each worker sees the
    # FULL IterableDataset stream; the dataset shards itself via
    # get_worker_info() if it wants disjoint data.
    stream = iter(dataset) if iterable else None
    while True:
        try:
            task = index_queue.get()
        except (EOFError, OSError):
            return
        if task is None:
            return
        task_id, indices = task
        try:
            if iterable:
                samples = list(itertools.islice(stream, len(indices)))
                if not samples or (drop_last and
                                   len(samples) < len(indices)):
                    result_queue.put((task_id, None, StopIteration()))
                    continue
                batch = collate_fn(samples)
            else:
                batch = collate_fn([dataset[i] for i in indices])
            result_queue.put((task_id, batch, None))
        except Exception as e:  # ship the error to the parent
            result_queue.put((task_id, None, e))


def _worker_entry(payload, index_queue, result_queue, wid, num_workers,
                  seed, iterable, drop_last):
    """A worker's first act hides the cards; only then are the dataset,
    the collate function and `worker_init_fn` unpickled (they travel as
    bytes: a process target's arguments are unpickled before it runs,
    and a dataset holding a CUDA tensor would open a context there). An
    unpickling error is shipped to the parent as an init error."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    try:
        dataset, collate_fn, worker_init_fn = pickle.loads(payload)
    except Exception as e:
        result_queue.put(("init_error", None, e))
        return
    _worker_loop(dataset, index_queue, result_queue, collate_fn, wid,
                 num_workers, seed, worker_init_fn, iterable, drop_last)


class MultiprocessIter:
    """One epoch of multiprocess loading. Preserves batch order."""

    def __init__(self, dataset, batches, collate_fn, num_workers,
                 prefetch_factor=2, worker_init_fn=None, timeout=0,
                 iterable=False, batch_size=1, seed=0, drop_last=False):
        # spawn-family start methods only (see the module docstring)
        method = os.environ.get("PT_DATALOADER_START_METHOD")
        if method is None:
            method = "forkserver" if "forkserver" in \
                mp.get_all_start_methods() else "spawn"
        if method == "fork":
            raise ValueError("DataLoader workers start by forkserver or "
                             "spawn, never by fork")
        self._ctx = mp.get_context(method)
        if method == "forkserver":
            self._ctx.set_forkserver_preload(["paddle_tpu_torch.io"])
        self._result_queue = self._ctx.Queue()
        self._workers = []
        self._index_queues = []
        self._timeout = timeout or None
        self._iterable = iterable
        self._num_workers = num_workers
        # pending batches of indices (index-mode) or dummy slices (iterable)
        if iterable:
            self._batches = iter(lambda: list(range(batch_size)), None)
        else:
            self._batches = iter(batches)
        self._next_task = 0        # next task id to hand out
        self._next_yield = 0       # next task id to yield (ordering)
        self._cache = {}
        # iterable mode: workers that answered StopIteration once; they are
        # skipped by the dispatcher and counted at most once toward epoch end
        self._exhausted = set()
        self._task_worker = {}     # task id -> wid it was dispatched to
        self._rr = 0               # round-robin cursor over live workers
        self._sent = 0
        self._outstanding_target = num_workers * max(2, prefetch_factor)
        payload = pickle.dumps((dataset, collate_fn, worker_init_fn),
                               protocol=pickle.HIGHEST_PROTOCOL)
        for wid in range(num_workers):
            iq = self._ctx.Queue()
            w = self._ctx.Process(
                target=_worker_entry,
                args=(payload, iq, self._result_queue, wid, num_workers,
                      seed, iterable, drop_last),
                daemon=True)
            w.start()
            self._workers.append(w)
            self._index_queues.append(iq)
        self._closed = False
        _live_iters.add(self)
        for _ in range(self._outstanding_target):
            if not self._dispatch_one():
                break

    def _dispatch_one(self):
        if len(self._exhausted) >= self._num_workers:
            return False
        try:
            indices = next(self._batches)
        except StopIteration:
            return False
        for _ in range(self._num_workers):
            wid = self._rr % self._num_workers
            self._rr += 1
            if wid not in self._exhausted:
                break
        self._task_worker[self._next_task] = wid
        self._index_queues[wid].put((self._next_task, indices))
        self._next_task += 1
        self._sent += 1
        return True

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            if self._next_yield in self._cache:
                tid = self._next_yield
                batch, err = self._cache.pop(tid)
                self._next_yield += 1
                wid = self._task_worker.pop(tid, tid % self._num_workers)
                if isinstance(err, StopIteration):
                    # this iterable worker ran dry; count each worker once
                    # (in-flight tasks to an already-dry worker answer
                    # StopIteration too) and stop dispatching to it
                    self._exhausted.add(wid)
                    if len(self._exhausted) >= self._num_workers:
                        self.shutdown()
                        raise StopIteration
                    self._dispatch_one()  # keep remaining workers busy
                    continue
                if err is not None:
                    self.shutdown()
                    raise err
                self._dispatch_one()
                return batch
            if self._next_yield >= self._sent and not self._dispatch_one():
                self.shutdown()
                raise StopIteration
            try:
                task_id, batch, err = self._result_queue.get(
                    timeout=self._timeout)
            except queue.Empty:
                self.shutdown()
                raise RuntimeError(
                    f"DataLoader timed out after {self._timeout}s waiting "
                    "for worker batch")
            if task_id == "init_error":
                self.shutdown()
                raise RuntimeError(
                    "DataLoader worker_init_fn failed") from err
            self._cache[task_id] = (batch, err)

    def shutdown(self):
        if self._closed:
            return
        self._closed = True
        for iq in self._index_queues:
            try:
                iq.put(None)
            except Exception:
                pass
        for w in self._workers:
            w.join(timeout=1.0)
            if w.is_alive():
                w.terminate()
        for iq in self._index_queues:
            try:
                iq.close()
            except Exception:
                pass
        try:
            self._result_queue.close()
        except Exception:
            pass

    def __del__(self):
        try:
            self.shutdown()
        except Exception:
            pass


class ThreadPrefetcher:
    """Bounded background prefetch thread — the buffered_reader.cc
    (operators/reader/buffered_reader.cc) double-buffer equivalent."""

    def __init__(self, gen, depth=2):
        self._q = queue.Queue(maxsize=max(1, depth))
        self._stop = object()
        self._err = None

        def run():
            try:
                for item in gen:
                    self._q.put(item)
            except Exception as e:
                self._err = e
            finally:
                self._q.put(self._stop)

        self._t = threading.Thread(target=run, daemon=True)
        self._t.start()

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is self._stop:
                if self._err is not None:
                    raise self._err
                return
            yield item
