"""KV-store rendezvous and CPU barriers (the JAX package's
`distributed/rendezvous.py`, which imports no JAX; the port keeps its own
copy with the same API and timeouts).

Reference parity: the gloo store rendezvous family (HTTP / file / HDFS KV
stores that role makers use to exchange addresses and barrier before
NCCL init). `torch.distributed` has its own stores for its process
groups (`init_parallel_env` takes a `file://` or `tcp://` address);
these cover the reference's other uses (endpoint exchange, barriers
before a group exists, tests) without a process group.
"""
from __future__ import annotations

import json
import os
import socket
import socketserver
import threading
import time


class FileStore:
    """Shared-filesystem KV store (gloo FileStore parity)."""

    def __init__(self, path, world_size=1):
        self.path = path
        self.world_size = world_size
        os.makedirs(path, exist_ok=True)

    def _key(self, k):
        return os.path.join(self.path, f"kv_{k}")

    def set(self, key, value):
        if isinstance(value, str):
            value = value.encode()
        tmp = self._key(key) + ".tmp"
        with open(tmp, "wb") as f:
            f.write(value)
        os.replace(tmp, self._key(key))

    def get(self, key, timeout=60.0):
        deadline = time.time() + timeout
        p = self._key(key)
        while time.time() < deadline:
            if os.path.exists(p):
                with open(p, "rb") as f:
                    return f.read()
            time.sleep(0.02)
        raise TimeoutError(f"FileStore.get({key!r}) timed out")

    def barrier(self, rank, name="barrier", timeout=60.0):
        self.set(f"{name}_{rank}", b"1")
        deadline = time.time() + timeout
        while time.time() < deadline:
            if all(os.path.exists(self._key(f"{name}_{r}"))
                   for r in range(self.world_size)):
                return
            time.sleep(0.02)
        raise TimeoutError(f"FileStore.barrier({name!r}) timed out")


class _KVHandler(socketserver.StreamRequestHandler):
    def handle(self):
        try:
            line = self.rfile.readline()
            if not line:
                return
            req = json.loads(line)
            store = self.server.kv  # type: ignore[attr-defined]
            op = req.get("op")
            if op == "set":
                with self.server.mu:  # type: ignore[attr-defined]
                    store[req["key"]] = req["value"]
                self.wfile.write(b'{"ok": true}\n')
            elif op == "get":
                with self.server.mu:  # type: ignore[attr-defined]
                    val = store.get(req["key"])
                self.wfile.write(
                    json.dumps({"ok": val is not None,
                                "value": val}).encode() + b"\n")
            elif op == "add":
                with self.server.mu:  # type: ignore[attr-defined]
                    cur = int(store.get(req["key"], 0)) + int(req["value"])
                    store[req["key"]] = cur
                self.wfile.write(
                    json.dumps({"ok": True, "value": cur}).encode() +
                    b"\n")
            elif op == "delete":
                with self.server.mu:  # type: ignore[attr-defined]
                    store.pop(req["key"], None)
                self.wfile.write(b'{"ok": true}\n')
            else:
                self.wfile.write(json.dumps(
                    {"ok": False,
                     "error": f"unknown op {op!r}"}).encode() + b"\n")
        except Exception as e:  # report, never hang the client parser
            try:
                self.wfile.write(json.dumps(
                    {"ok": False, "error": str(e)}).encode() + b"\n")
            except Exception:
                pass


class TCPStore:
    """TCP KV store (the reference's HTTP-server KV rendezvous,
    fleet/utils/http_server.py capability, over a line protocol)."""

    def __init__(self, host="127.0.0.1", port=0, is_master=False,
                 world_size=1, timeout=60.0):
        self.world_size = world_size
        self.timeout = timeout
        if is_master:
            self._srv = socketserver.ThreadingTCPServer(
                (host, port), _KVHandler, bind_and_activate=True)
            self._srv.daemon_threads = True
            self._srv.kv = {}            # type: ignore[attr-defined]
            self._srv.mu = threading.Lock()  # type: ignore[attr-defined]
            self.host, self.port = self._srv.server_address
            self._thread = threading.Thread(
                target=self._srv.serve_forever, daemon=True)
            self._thread.start()
        else:
            self._srv = None
            self.host, self.port = host, port

    def _rpc(self, req):
        with socket.create_connection((self.host, self.port),
                                      timeout=self.timeout) as s:
            s.sendall(json.dumps(req).encode() + b"\n")
            data = s.makefile().readline()
        return json.loads(data)

    def set(self, key, value):
        if isinstance(value, bytes):
            value = value.decode()
        self._rpc({"op": "set", "key": key, "value": value})

    def get(self, key, timeout=None):
        deadline = time.time() + (timeout or self.timeout)
        while time.time() < deadline:
            r = self._rpc({"op": "get", "key": key})
            if r.get("ok"):
                return r["value"]
            time.sleep(0.02)
        raise TimeoutError(f"TCPStore.get({key!r}) timed out")

    def add(self, key, value=1):
        return self._rpc({"op": "add", "key": key,
                          "value": value})["value"]

    def delete(self, key):
        self._rpc({"op": "delete", "key": key})

    def barrier(self, name="barrier", timeout=None):
        # cohort-based: my arrival number k (SERVER-side counter, so a
        # reconnected client cannot skip a round) puts me in cohort
        # ceil(k / world); I wait until my whole cohort arrived
        k = self.add(f"__barrier_{name}", 1)
        target = ((k + self.world_size - 1) //
                  self.world_size) * self.world_size
        deadline = time.time() + (timeout or self.timeout)
        while time.time() < deadline:
            r = self._rpc({"op": "get", "key": f"__barrier_{name}"})
            if r.get("ok") and int(r["value"]) >= target:
                return
            time.sleep(0.02)
        raise TimeoutError(f"TCPStore.barrier({name!r}) timed out")

    def shutdown(self):
        if self._srv is not None:
            self._srv.shutdown()
            self._srv.server_close()
