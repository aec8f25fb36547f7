"""The parameter-server training mode (the JAX package's
`distributed/ps`; reference: the PS family of operators/distributed/:
RPC client / server, `Communicator` (communicator.h:180 sync, :253
async, geo), parameter_send / recv, the large-scale sparse KV
(large_scale_kv.h:762), listen_and_serv's server-side optimize blocks,
the heartbeat monitor, and fleet's PS runtime).

Pservers are host processes running the native TCP RPC server
(`csrc/ptcore/ps_server.cc`, bound through `_native.py`: the same C
source as the JAX package's, so both clients see the same tables, bit
for bit) with server-side optimizer rules; the workers run their steps on
the card and exchange dense and sparse tensors with the servers between
steps. Sharding across several pservers is by a stable hash of the
parameter's name.

Differences from the JAX module: the bf16 wire takes and gives torch
bfloat16 tensors (their 16-bit patterns; both round to nearest even, so
the bytes are the JAX client's); a device copy is `.to(device)`; a
row-sparse gradient in `Communicator.push` (a `sparse.SelectedRows` or
the torch sparse COO tensor `nn.Embedding(sparse=True)` leaves in
`.grad`) is merged on its device (`SelectedRows.merge`, deterministic)
before the one readback, where the JAX client merges on the host.
"""
from __future__ import annotations

import ctypes
import threading
import time

import numpy as np
import torch

from ._native import load as load_library

__all__ = ["PsServer", "PsClient", "Communicator", "DistributedLookupTable",
           "run_pserver", "SparsePrefetcher", "MergedSparseStream"]


def _host(x):
    """A tensor on any device -> a host numpy array (others as they
    are)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu")
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return x


def _bf16_bits(x):
    """The bfloat16 bit patterns (uint16 numpy) of a tensor or array: a
    bfloat16 tensor as it is, anything else rounded to nearest even
    first; a uint16 array is taken as the patterns themselves."""
    if isinstance(x, np.ndarray) and x.dtype == np.uint16:
        return x
    t = x.detach().to("cpu") if isinstance(x, torch.Tensor) \
        else torch.as_tensor(np.asarray(x, np.float32))
    if t.dtype != torch.bfloat16:
        t = t.float().to(torch.bfloat16)
    return t.contiguous().view(torch.int16).numpy().view(np.uint16)


class PsServer:
    """In-process native PS server (one per pserver host).

    optimizer: 'sgd' | 'momentum' | 'adam' — the server-side optimize
    rule applied to pushed dense grads (listen_and_serv capability).
    """

    def __init__(self, port=0, trainers=1, optimizer="sgd", lr=0.01):
        self._lib = load_library()
        self._h = self._lib.pt_ps_server_start(
            port, trainers, optimizer.encode(), float(lr))
        if not self._h:
            raise RuntimeError(f"PS server failed to bind port {port}")

    @property
    def port(self):
        return self._lib.pt_ps_server_port(self._h)

    def stale_trainers(self, timeout_ms=10000):
        """Heartbeat monitor: trainers not seen within timeout."""
        return self._lib.pt_ps_server_stale(self._h, timeout_ms)

    def shutdown_requested(self):
        """True once a client issued the shutdown RPC."""
        return bool(self._lib.pt_ps_server_shutdown_requested(self._h))

    def stop(self):
        if self._h:
            self._lib.pt_ps_server_stop(self._h)
            self._lib.pt_ps_server_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.stop()
        except Exception:
            pass


class PsClient:
    """Native RPC client for one pserver endpoint.

    Thread-safe: one framed-RPC socket underlies the handle, so every
    RPC runs under a lock — the async Communicator's send and recv
    threads (and the dataset engine's Downpour plane) share one client,
    and interleaved frames corrupt the protocol ("send failed" rc=-1).
    """

    _RPC_METHODS = ("init_dense", "push_dense", "pull_dense",
                    "push_sparse", "pull_dense_if_newer", "pull_sparse",
                    "barrier", "heartbeat", "shutdown_server",
                    "save", "load")

    def __init__(self, host="127.0.0.1", port=0):
        import functools
        import threading

        self._lib = load_library()
        self._host, self._port = host, port
        self._h = self._lib.pt_ps_connect(host.encode(), port)
        if not self._h:
            raise ConnectionError(f"cannot connect to pserver {host}:{port}")
        self._mu = threading.Lock()
        for name in self._RPC_METHODS:
            fn = getattr(self, name)

            def locked(*a, _fn=fn, **k):
                with self._mu:
                    # close() nulls the handle under this same lock; a
                    # late RPC from a lingering worker thread must fail
                    # cleanly, not hand a freed pointer to native code
                    if self._h is None:
                        raise ConnectionError("ps client is closed")
                    try:
                        return _fn(*a, **k)
                    except RuntimeError as e:
                        # transient transport failure: reconnect once and
                        # retry (AsyncCommunicator resilience — a dead
                        # socket must not silently kill the send thread)
                        if "send" not in str(e) and "recv" not in str(e):
                            raise
                        self._reconnect()
                        return _fn(*a, **k)

            setattr(self, name, functools.wraps(fn)(locked))

    def _reconnect(self):
        if self._h:
            try:
                self._lib.pt_ps_disconnect(self._h)
            except Exception:
                pass
        self._h = self._lib.pt_ps_connect(self._host.encode(), self._port)
        if not self._h:
            raise ConnectionError(
                f"cannot reconnect to pserver {self._host}:{self._port}")

    def _ck(self, rc, what):
        if rc != 0:
            raise RuntimeError(
                f"ps {what} failed (rc={rc}): "
                + self._lib.pt_ps_client_error(self._h).decode())

    def init_dense(self, name, value):
        v = np.ascontiguousarray(value, np.float32).ravel()
        self._ck(self._lib.pt_ps_init_dense(
            self._h, name.encode(),
            v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), v.size),
            "init_dense")

    def push_dense(self, name, grad, optimize=True):
        g = np.ascontiguousarray(grad, np.float32).ravel()
        self._ck(self._lib.pt_ps_push_dense(
            self._h, name.encode(),
            g.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), g.size,
            1 if optimize else 0), "push_dense")

    def pull_dense(self, name, shape):
        out = np.empty(int(np.prod(shape)), np.float32)
        self._ck(self._lib.pt_ps_pull_dense(
            self._h, name.encode(),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), out.size),
            "pull_dense")
        return out.reshape(shape)

    def push_sparse(self, table, keys, grads):
        keys = np.ascontiguousarray(keys, np.int64).ravel()
        grads = np.ascontiguousarray(grads, np.float32)
        dim = grads.shape[-1]
        grads = grads.reshape(keys.size, dim)
        self._ck(self._lib.pt_ps_push_sparse(
            self._h, table.encode(), dim,
            keys.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), keys.size,
            grads.ctypes.data_as(ctypes.POINTER(ctypes.c_float))),
            "push_sparse")

    def pull_dense_if_newer(self, name, shape, version, out=None):
        """Version-gated pull (the async PullDenseWorker delta path):
        returns (array_or_None, new_version) — None means the server's
        table has not advanced past `version`, so no payload moved.
        Pass a reusable `out` buffer to avoid per-poll allocation."""
        if out is None:
            out = np.empty(int(np.prod(shape)), np.float32)
        ver = ctypes.c_uint64(int(version))
        rc = self._lib.pt_ps_pull_dense_if_newer(
            self._h, name.encode(),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), out.size,
            ctypes.byref(ver))
        if rc == 1:
            return None, ver.value
        self._ck(rc, "pull_dense_if_newer")
        return out.reshape(shape), ver.value

    def pull_sparse(self, table, keys, dim):
        keys = np.ascontiguousarray(keys, np.int64).ravel()
        out = np.empty((keys.size, dim), np.float32)
        self._ck(self._lib.pt_ps_pull_sparse(
            self._h, table.encode(), dim,
            keys.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), keys.size,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))),
            "pull_sparse")
        return out

    def push_sparse_bf16(self, table, keys, grads_bf16):
        """bf16-wire push: grads arrive as a torch bfloat16 tensor (e.g.
        straight off a device readback; another tensor or array is
        rounded to bfloat16 first, to nearest even) and ship as their
        16-bit patterns WITHOUT a host widen: the server widens while
        applying (bit-identical to the host widen it replaces) and the
        loopback RPC carries half the bytes. A uint16 numpy array is
        taken as the patterns themselves."""
        keys = np.ascontiguousarray(keys, np.int64).ravel()
        g16 = _bf16_bits(grads_bf16)
        dim = g16.shape[-1]
        g16 = np.ascontiguousarray(g16.reshape(keys.size, dim))
        self._ck(self._lib.pt_ps_push_sparse_bf16(
            self._h, table.encode(), dim,
            keys.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), keys.size,
            g16.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16))),
            "push_sparse_bf16")

    def pull_sparse_bf16(self, table, keys, dim, out=None):
        """bf16-wire pull: the server narrows fp32 rows to bf16
        (round-to-nearest-even, as `torch.Tensor.to(torch.bfloat16)`)
        before the RPC; the result lands directly in `out` (or a fresh
        CPU bfloat16 tensor) with no host-side narrow pass. `out` may be
        any contiguous [n, dim] CPU bfloat16 tensor or uint16 numpy
        buffer, e.g. a slice of a padded wire buffer."""
        keys = np.ascontiguousarray(keys, np.int64).ravel()
        if out is None:
            out = torch.empty((keys.size, dim), dtype=torch.bfloat16)
        if isinstance(out, torch.Tensor):
            if out.dtype != torch.bfloat16 or out.device.type != "cpu":
                raise ValueError(
                    f"pull_sparse_bf16 out must be a CPU bfloat16 tensor "
                    f"or a uint16 array, got {out.dtype} on {out.device}")
            if not out.is_contiguous():
                raise ValueError("pull_sparse_bf16 needs a contiguous out")
            view = out.view(torch.int16).numpy().view(np.uint16)
        else:
            view = out
            if view.dtype != np.uint16:
                raise ValueError(
                    f"pull_sparse_bf16 out must be a CPU bfloat16 tensor "
                    f"or a uint16 array, got {out.dtype}")
            if not view.flags["C_CONTIGUOUS"]:
                raise ValueError("pull_sparse_bf16 needs a contiguous out")
        if view.size != keys.size * dim:
            raise ValueError(
                f"pull_sparse_bf16 out has {view.size} elements, needs "
                f"{keys.size * dim}")
        self._ck(self._lib.pt_ps_pull_sparse_bf16(
            self._h, table.encode(), dim,
            keys.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), keys.size,
            view.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16))),
            "pull_sparse_bf16")
        return out

    def barrier(self, barrier_id=0):
        self._ck(self._lib.pt_ps_barrier(self._h, barrier_id), "barrier")

    def heartbeat(self, trainer_id):
        self._ck(self._lib.pt_ps_heartbeat(self._h, trainer_id),
                 "heartbeat")

    def save(self, path):
        """Server-side table snapshot to `path` (the server owns the IO;
        checkpoint_notify_op.cc:66 / recv_save_op.cc capability)."""
        self._ck(self._lib.pt_ps_save(self._h, str(path).encode()),
                 "save")

    def load(self, path):
        """Restore a kSave snapshot into the server's tables
        (large_scale_kv.h:762 load capability)."""
        self._ck(self._lib.pt_ps_load(self._h, str(path).encode()),
                 "load")

    def shutdown_server(self):
        self._lib.pt_ps_shutdown(self._h)

    def close(self):
        # free the native handle under the RPC lock: an in-flight RPC on
        # another thread finishes first, and any later one sees None
        # (use-after-free here segfaulted the whole process when an
        # async recv thread outlived Communicator.stop()'s join timeout)
        with self._mu:
            if self._h:
                self._lib.pt_ps_disconnect(self._h)
                self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def _shard(name, nshards):
    # stable across processes (unlike Python's salted hash())
    h = 0
    for ch in name.encode():
        h = (h * 131 + ch) & 0x7FFFFFFF
    return h % nshards


class Communicator:
    """Trainer-side grad/param exchange (communicator.h hierarchy parity).

    modes:
      'sync'  — push grads + pull params inline every step;
      'async' — background send thread merges queued grads and sends;
                background recv thread refreshes params every
                `recv_interval` s (AsyncCommunicator + PullDenseWorker);
      'geo'   — trainer keeps local params; every `geo_k` steps pushes the
                param DELTA since last sync and pulls the global value
                (GeoCommunicator / GEO-SGD).
    """

    def __init__(self, endpoints, mode="sync", trainer_id=0,
                 recv_interval=0.05, geo_k=4, send_queue_size=8):
        self.mode = mode
        self.trainer_id = trainer_id
        self.clients = [PsClient(h, int(p)) for h, p in
                        (e.split(":") for e in endpoints)]
        self.geo_k = geo_k
        self._geo_base = {}   # name -> param at last sync
        self._geo_step = 0
        self._dense_shapes = {}
        self._running = False
        # bounded like the reference's send channel (communicator.h
        # send_queue_size): an unbounded queue lets a contended host
        # batch up dozens of STALE grads and apply them in one burst —
        # async SGD diverges. push() blocks once the bound is hit.
        self.send_queue_size = max(int(send_queue_size), 1)
        self._send_q = []
        self._send_mu = threading.Lock()
        self._send_cv = threading.Condition(self._send_mu)
        self._send_error = None
        self._recv_interval = recv_interval
        self._latest = {}     # name -> freshly pulled param (async)
        self._latest_gen = 0  # bumps when recv_loop lands fresh data
        self._recv_error = None
        self._stop_evt = threading.Event()

    def _client_for(self, name):
        return self.clients[_shard(name, len(self.clients))]

    # ---------------- setup ----------------
    def init_params(self, named_params):
        """Trainer 0 pushes initial values; all trainers then barrier."""
        for name, val in named_params.items():
            val = _host(val)
            self._dense_shapes[name] = tuple(np.shape(val))
            if self.trainer_id == 0:
                self._client_for(name).init_dense(name, val)
            if self.mode == "geo":
                self._geo_base[name] = np.array(val, np.float32)
        self.clients[0].barrier(0)

    # ---------------- sync/async dense path ----------------
    def push(self, named_grads):
        """Dense grads (numpy arrays or tensors, any device) go to
        push_dense. A row-sparse gradient (a `SelectedRows`, or the torch
        sparse COO tensor of `nn.Embedding(sparse=True)`) goes straight
        to push_sparse as (rows, values), never densified: fill rows
        dropped and duplicates merged on its device, then one readback;
        bfloat16 values ride the bf16 wire where the client speaks it
        (as `MergedSparseStream` ships them)."""
        from ...sparse import SelectedRows, is_sparse_grad

        sparse = {n: g for n, g in named_grads.items() if is_sparse_grad(g)}
        for name, g in sparse.items():
            sr = g if isinstance(g, SelectedRows) else SelectedRows(g)
            m = sr.merge()
            rows = m.rows.detach().to("cpu").numpy()
            vals = m.values.detach().reshape(rows.size, -1).to("cpu")
            cli = self._client_for(name)
            if vals.dtype == torch.bfloat16 and \
                    hasattr(cli, "push_sparse_bf16"):
                cli.push_sparse_bf16(name, rows, vals.contiguous())
            else:
                cli.push_sparse(name, rows, vals.float().numpy())
        dense = {n: _host(g) for n, g in named_grads.items()
                 if n not in sparse}
        if not dense:
            return
        if self.mode == "async":
            with self._send_cv:
                while (self._running and self._send_error is None
                       and len(self._send_q) >= self.send_queue_size):
                    self._send_cv.wait(timeout=1.0)
                if self._send_error is not None:
                    raise RuntimeError(
                        "PS async send thread died") from self._send_error
                if self._running:
                    self._send_q.append(dict(dense))
                    return
            # communicator stopped (or never started): push inline so
            # the grad is neither lost nor parked on a dead queue
        for name, g in dense.items():
            self._client_for(name).push_dense(name, g)

    def pull(self, force=False):
        """force=True bypasses the async recv-thread cache and does a
        blocking dense pull from the servers (bounded-staleness
        fallback; sync mode always pulls)."""
        if self._recv_error is not None:
            raise RuntimeError(
                "PS async recv thread died") from self._recv_error
        shapes = list(self._dense_shapes.items())  # init_params may
        # grow the dict concurrently (engine pull thread vs first hook)
        if not force and self.mode == "async" and self._latest:
            return {n: self._latest[n].reshape(s)
                    for n, s in shapes if n in self._latest}
        return {n: self._client_for(n).pull_dense(n, s)
                for n, s in shapes}

    @property
    def latest_generation(self):
        """Bumps whenever the async recv thread lands genuinely fresh
        params; consumers can gate on it to tell a starved recv thread
        from a quiet server."""
        return self._latest_gen

    # ---------------- checkpoint ----------------
    def checkpoint_notify(self, dirname, load=False):
        """Notify every pserver to snapshot (or restore) its tables —
        the trainer-side checkpoint_notify_op role
        (operators/distributed_ops/checkpoint_notify_op.cc:66). Each
        shard writes `dirname/pserver_<i>.ptps`; the server process owns
        the file IO (recv_save_op semantics), so the path must be
        reachable from the pserver host. Returns the per-shard paths.

        In async mode the local send queue is flushed first so queued
        grads land in the snapshot. Multi-trainer jobs must quiesce the
        OTHER trainers themselves (e.g. `barrier()`) — trainer 0 then
        issues the notify, matching the reference's fleet save flow."""
        import os

        if not load and self.mode == "async":
            with self._send_mu:
                batch, self._send_q = self._send_q, []
            for d in batch:
                for n, g in d.items():
                    self._client_for(n).push_dense(n, g)
        paths = []
        for i, cl in enumerate(self.clients):
            p = os.path.join(str(dirname), f"pserver_{i}.ptps")
            (cl.load if load else cl.save)(p)
            paths.append(p)
        return paths

    # ---------------- geo path ----------------
    def geo_step(self, named_params):
        """Called every local step with current local params; returns
        possibly-updated params (after delta exchange every geo_k)."""
        self._geo_step += 1
        if self._geo_step % self.geo_k != 0:
            return named_params
        out = dict(named_params)
        for name, val in named_params.items():
            val = np.asarray(_host(val), np.float32)
            delta = val - self._geo_base[name]
            c = self._client_for(name)
            c.push_dense(name, delta, optimize=False)  # server adds delta
            new = c.pull_dense(name, val.shape)
            self._geo_base[name] = new.copy()
            out[name] = new
        return out

    # ---------------- async workers ----------------
    def start(self):
        if self.mode != "async" or self._running:
            return
        self._running = True

        def send_loop():
            while not self._stop_evt.is_set():
                with self._send_cv:
                    batch, self._send_q = self._send_q, []
                    if batch:
                        self._send_cv.notify_all()
                if batch:
                    # merge grads for the same var (communicator merge_add)
                    try:
                        merged = {}
                        for d in batch:
                            for n, g in d.items():
                                g = np.asarray(g, np.float32)
                                merged[n] = merged.get(n, 0) + g
                        for n, g in merged.items():
                            self._client_for(n).push_dense(n, g)
                    except Exception as e:
                        # surface on the NEXT push(): with a bounded
                        # queue a silently-dead send thread would block
                        # the trainer forever
                        with self._send_cv:
                            self._send_error = e
                            self._send_cv.notify_all()
                        return
                else:
                    time.sleep(0.002)

        def recv_loop():
            consecutive_errs = 0
            versions = {}
            scratch = {}  # reusable per-name buffers (no per-poll alloc)
            while not self._stop_evt.is_set():
                try:
                    for n, s in list(self._dense_shapes.items()):
                        # delta gate: payload moves only when the server
                        # table advanced (PullDenseWorker without the
                        # full-param re-pull every interval)
                        if n not in scratch:
                            scratch[n] = np.empty(
                                int(np.prod(s)), np.float32)
                        arr, versions[n] = self._client_for(
                            n).pull_dense_if_newer(
                                n, s, versions.get(n, 0),
                                out=scratch[n])
                        if arr is not None:
                            self._latest[n] = arr.copy()
                            self._latest_gen += 1
                    consecutive_errs = 0
                except Exception as e:  # transient: retry, then surface
                    consecutive_errs += 1
                    if consecutive_errs >= 5:
                        self._recv_error = e
                        return
                time.sleep(self._recv_interval)

        self._threads = [threading.Thread(target=send_loop, daemon=True),
                         threading.Thread(target=recv_loop, daemon=True)]
        for t in self._threads:
            t.start()

    def stop(self):
        if not self._running:
            return
        self._stop_evt.set()
        for t in self._threads:
            t.join(timeout=2.0)
        # flip state, release blocked pushers, and drain in ONE critical
        # section: a waiter waking after a separate flush would append to
        # a never-drained queue and lose its grad (late push() calls now
        # go inline — see push())
        with self._send_cv:
            self._running = False
            batch, self._send_q = self._send_q, []
            self._send_cv.notify_all()
        for d in batch:
            for n, g in d.items():
                self._client_for(n).push_dense(n, g)

    def barrier(self, bid=1):
        self.clients[0].barrier(bid)

    def close(self):
        self.stop()
        for c in self.clients:
            c.close()


class DistributedLookupTable:
    """Sparse embedding on pserver hosts (distributed_lookup_table_op +
    large_scale_kv capability): pull rows for ids, push grads back.
    Rows init lazily server-side; host RAM holds the table, the card
    only sees the dense gathered minibatch."""

    def __init__(self, comm: Communicator, table_name, dim):
        self.comm = comm
        self.table = table_name
        self.dim = dim

    def lookup(self, ids):
        ids = np.asarray(_host(ids), np.int64)
        flat = ids.ravel()
        rows = self.comm._client_for(self.table).pull_sparse(
            self.table, flat, self.dim)
        return rows.reshape(ids.shape + (self.dim,))

    def push_grad(self, ids, grads):
        ids = np.asarray(_host(ids), np.int64).ravel()
        grads = np.asarray(_host(grads), np.float32).reshape(ids.size,
                                                             self.dim)
        self.comm._client_for(self.table).push_sparse(self.table, ids,
                                                      grads)


def run_pserver(port=0, trainers=1, optimizer="sgd", lr=0.01,
                ready_file=None, block=True):
    """Pserver main loop (listen_and_serv_op capability;
    `python -m paddle_tpu_torch.distributed.ps` entry)."""
    server = PsServer(port=port, trainers=trainers, optimizer=optimizer,
                      lr=lr)
    if ready_file:
        with open(ready_file, "w") as f:
            f.write(str(server.port))
    if not block:
        return server
    try:
        # exit when a trainer sends shutdown_server (listen_and_serv
        # semantics: server loop ends on the RPC shutdown notify)
        while not server.shutdown_requested():
            time.sleep(0.2)
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()


class SparsePrefetcher:
    """Overlap sparse pulls with device compute (parameter_prefetch.cc
    capability): while the card runs step t, a background thread pulls
    the embedding rows for step t+1's ids.

    usage:
        pf = SparsePrefetcher(comm, "emb", dim)
        pf.prime(first_ids)
        for batch in data:
            rows = pf.get()            # rows for current ids
            pf.prefetch(next_ids)      # overlap next pull with compute
            ... train on rows ...
    """

    def __init__(self, comm, table, dim, to_device=False):
        """to_device: False keeps the pulled rows on the host (numpy);
        True (the card) or a device makes the prefetch thread also copy
        them there (`.to(device)`), so by get() time they are already on
        the device and the step never waits on the copy."""
        self._table = DistributedLookupTable(comm, table, dim)
        self._pending = None
        self._device = None
        if to_device is not False and to_device is not None:
            from ...core.device import resolve_device

            self._device = resolve_device(None if to_device is True
                                          else to_device)

    @property
    def _to_device(self):
        return self._device is not None

    def _put(self, *arrays):
        """Host arrays -> tensors on the device (one call each; a CPU
        device gives CPU tensors)."""
        out = tuple(torch.as_tensor(a).to(self._device, non_blocking=True)
                    for a in arrays)
        return out if len(out) > 1 else out[0]

    def _pull(self, ids, aux=None):
        rows = self._table.lookup(ids)
        if self._to_device:
            if aux is not None:
                return self._put(rows, aux)
            rows = self._put(rows)
        return rows if aux is None else (rows, aux)

    def prime(self, ids):
        self.prefetch(ids)

    def prefetch(self, ids, aux=None):
        """aux: optional host array shipped to the device on the prefetch
        thread alongside the rows (e.g. the chunk's labels), so the
        training step never pays their copy inline. When given, get()
        returns the pull result with the device aux appended."""
        import concurrent.futures

        if not hasattr(self, "_pool"):
            self._pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="pt-sparse-prefetch")
        if aux is None:
            self._pending = self._pool.submit(self._pull, ids)
        else:
            self._pending = self._pool.submit(self._pull, ids, aux)

    def get(self, timeout=60.0):
        if self._pending is None:
            raise RuntimeError("prefetch()/prime() before get()")
        out = self._pending.result(timeout=timeout)
        self._pending = None
        return out

    def close(self):
        # drain any in-flight pull BEFORE the caller tears the
        # communicator/native client down under the worker thread
        if self._pending is not None:
            try:
                self._pending.result(timeout=10.0)
            except Exception:
                pass
            self._pending = None
        if hasattr(self, "_pool"):
            # best effort: a pull stuck on a dead pserver must not hang
            # the caller's teardown forever
            self._pool.shutdown(wait=False)


class MergedSparseStream(SparsePrefetcher):
    """K-step merged sparse pull/push for async PS training.

    The reference AsyncCommunicator merges several batches' grads per
    send (communicator.h:253, `max_merge_var_num`); the same batching
    applies to the host <-> device copies, whose fixed cost dwarfs
    per-batch payloads. The pull side is SparsePrefetcher's (one
    background worker, prefetch/get protocol) with a wire-dtype
    narrowing added: embedding rows for K training batches ship to the
    device as ONE copy (bfloat16 on the wire: half the bytes; the
    pserver table stays fp32). The push side reads the K per-step
    gradients back as ONE device -> host copy, merged by row id before
    the pserver push.

    Staleness is bounded by K merged batches plus one prefetched chunk
    plus `max_pending` queued pushes, the bounded-staleness regime the
    reference async PS mode accepts.

    usage (ids chunk shaped [K, B, S]):
        ms = MergedSparseStream(comm, "emb", dim, height=VOCAB)
        ms.prime(ids0)
        for chunk in chunks:
            rows = ms.get()              # device [K,B,S,dim] wire dtype
            ms.prefetch(next_chunk)      # overlap next pull + copy
            grads = train_k_steps(rows)
            ms.push_async(chunk_ids, grads)  # one readback + merged push
        ms.drain()                       # grads all applied at the PS

    unique_wire=True moves the id dedup to the PULL side and the row
    merge onto the device: the prefetch thread np.unique's the chunk's
    ids, pulls only the unique rows, and ships (rows [Upad, D] wire
    dtype, inv [K, B, S] int32, uniq_pad); the training chunk gathers
    `rows[inv[k]]` per step, and the gradient w.r.t. the unique rows is
    the gather's index_add backward, the row merge on the device. The
    push side reads back one already-merged [Upad, D] gradient and sends
    it straight to the pserver. U is padded up to a multiple of
    `pad_rows` (sentinel id == height, zero rows) so the step sees a
    handful of shapes.
    """

    def __init__(self, comm, table, dim, height, wire_dtype="bfloat16",
                 to_device=True, max_pending=4, unique_wire=False,
                 pad_rows=16384):
        import concurrent.futures

        super().__init__(comm, table, dim, to_device=to_device)
        self._comm = comm
        self._name = table
        self._dim = dim
        self._height = height
        self._wire_dtype = wire_dtype
        self._unique_wire = bool(unique_wire)
        self._pad_rows = max(int(pad_rows), 1)
        self._max_pending = max(int(max_pending), 1)
        self._push_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="pt-merged-push")
        self._push_futs = []
        # cumulative worker-thread seconds (host-plane accounting)
        self.pull_seconds = 0.0
        self.push_seconds = 0.0
        self.chunks = 0

    def _wire_torch_dtype(self):
        if not self._wire_dtype or self._wire_dtype == "float32":
            return torch.float32
        return getattr(torch, str(self._wire_dtype))

    # ---------------- pull side (SparsePrefetcher + wire narrowing) ----
    def _pull(self, ids, aux=None):
        if self._unique_wire:
            return self._pull_unique(ids, aux)
        t0 = time.perf_counter()
        rows = torch.from_numpy(self._table.lookup(ids))  # one RPC, K batches
        wire = self._wire_torch_dtype()
        if rows.dtype != wire:
            rows = rows.to(wire)
        if self._to_device:
            if aux is not None:
                rows, aux = self._put(rows, aux)
            else:
                rows = self._put(rows)
        self.pull_seconds += time.perf_counter() - t0
        self.chunks += 1
        return rows if aux is None else (rows, aux)

    def _pull_unique(self, ids, aux=None):
        t0 = time.perf_counter()
        ids = np.asarray(_host(ids), np.int64)
        uniq, inv = np.unique(ids.ravel(), return_inverse=True)
        upad = -(-uniq.size // self._pad_rows) * self._pad_rows
        rows = torch.zeros((upad, self._dim), dtype=self._wire_torch_dtype())
        # one RPC for the UNIQUE rows only. bf16 wire: the pserver
        # narrows server-side straight into the padded wire buffer (half
        # the loopback bytes, no host narrow pass); other dtypes narrow
        # on assignment from the fp32 pull
        if self._bf16_wire():
            self._comm._client_for(self._name).pull_sparse_bf16(
                self._name, uniq, self._dim, out=rows[:uniq.size])
        else:
            rows[:uniq.size] = torch.from_numpy(self._table.lookup(uniq))
        uniq_pad = np.full(upad, self._height, np.int64)
        uniq_pad[:uniq.size] = uniq
        inv = torch.from_numpy(inv.reshape(ids.shape).astype(np.int32))
        if self._to_device:
            # one copy each for rows, inv and aux, all on this thread
            if aux is not None:
                rows, inv, aux = self._put(rows, inv, aux)
            else:
                rows, inv = self._put(rows, inv)
        self.pull_seconds += time.perf_counter() - t0
        self.chunks += 1
        out = (rows, inv, uniq_pad)
        return out if aux is None else out + (aux,)

    def _bf16_wire(self):
        """True when the bf16-on-the-wire fast path applies end to end:
        bfloat16 wire dtype AND the native client (the pure-python test
        fakes don't speak the bf16 opcodes)."""
        if self._wire_dtype != "bfloat16":
            return False
        cli = self._comm._client_for(self._name)
        return hasattr(cli, "push_sparse_bf16")

    # ---------------- push side ----------------
    def _push(self, ids, grads):
        t0 = time.perf_counter()
        # the ONE device -> host readback for K batches
        vals = grads.detach().to("cpu") if isinstance(grads, torch.Tensor) \
            else torch.as_tensor(np.asarray(grads))
        vals = vals.reshape(ids.size, self._dim)
        if self._unique_wire:
            # rows arrived pre-merged from the device index_add: drop the
            # pad sentinels and send them straight to the pserver,
            # skipping the host unique / add.at plane
            flat = ids.ravel()
            keep = torch.from_numpy(flat < self._height)
            cli = self._comm._client_for(self._name)
            if self._bf16_wire() and vals.dtype == torch.bfloat16:
                # the readback is already bf16: ship it as it is, the
                # server widens (bit-identical to a host widen)
                cli.push_sparse_bf16(self._name, flat[keep.numpy()],
                                     vals[keep].contiguous())
            else:
                cli.push_sparse(self._name, flat[keep.numpy()],
                                vals[keep].float().numpy())
        else:
            from ...sparse import SelectedRows

            self._comm.push({self._name: SelectedRows(
                ids.ravel(), vals.float(), self._height)})
        self.push_seconds += time.perf_counter() - t0

    def push_async(self, ids, grads):
        # backpressure: never hold more than max_pending grad chunks
        # (each pins a [K,B,S,D] device tensor): block on the oldest
        while len(self._push_futs) >= self._max_pending:
            self._push_futs.pop(0).result()
        # surface completed-worker exceptions; pop BEFORE result() so a
        # failed push raises once, not on every later call
        while self._push_futs and self._push_futs[0].done():
            self._push_futs.pop(0).result()
        self._push_futs.append(self._push_pool.submit(
            self._push, np.asarray(_host(ids), np.int64), grads))

    def drain(self, timeout=300.0):
        """Block until every pushed grad chunk is applied at the PS."""
        while self._push_futs:
            self._push_futs.pop(0).result(timeout=timeout)

    def close(self):
        try:
            self.drain(timeout=10.0)
        except Exception:
            pass
        self._push_pool.shutdown(wait=False)
        super().close()
