"""Runtime stats registry (the JAX package's `utils/monitor.py`;
platform/monitor.h:76 StatRegistry parity).

Thread-safe named counters/gauges exported process-wide — the
reference's VT memory stats / communicator counters surface. Values are
plain ints/floats updated from Python or native callers via the update
helpers; `export()` snapshots everything for logging.
"""
from __future__ import annotations

import threading
import time


class _Stat:
    __slots__ = ("value", "_mu")

    def __init__(self):
        self.value = 0
        self._mu = threading.Lock()

    def add(self, v=1):
        with self._mu:
            self.value += v
            return self.value

    def set(self, v):
        with self._mu:
            self.value = v

    def get(self):
        with self._mu:
            return self.value


class StatRegistry:
    _instance = None
    _cls_mu = threading.Lock()

    def __init__(self):
        self._stats = {}
        self._mu = threading.Lock()

    @classmethod
    def instance(cls):
        with cls._cls_mu:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def stat(self, name):
        with self._mu:
            s = self._stats.get(name)
            if s is None:
                s = self._stats[name] = _Stat()
            return s

    def update(self, name, increment=1):
        return self.stat(name).add(increment)

    def set(self, name, value):
        self.stat(name).set(value)

    def get(self, name):
        with self._mu:
            s = self._stats.get(name)
        return s.get() if s is not None else 0

    def export(self):
        with self._mu:
            items = list(self._stats.items())
        return {k: s.get() for k, s in items}

    def reset(self):
        with self._mu:
            self._stats.clear()


def stat_update(name, increment=1):
    """STAT_ADD macro parity."""
    return StatRegistry.instance().update(name, increment)


def stat_set(name, value):
    StatRegistry.instance().set(name, value)


def get_stats():
    """pybind global getter parity: snapshot of every stat."""
    return StatRegistry.instance().export()


class Timer:
    """RecordEvent-adjacent scoped timer feeding a stat (microseconds)."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        us = int((time.perf_counter() - self._t0) * 1e6)
        stat_update(self.name + ".total_us", us)
        stat_update(self.name + ".count", 1)
        return False
