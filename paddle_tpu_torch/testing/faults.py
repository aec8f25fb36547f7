"""Deterministic fault injection for the port's serving path and data
pipeline (the JAX package's `testing/faults.py`, kept as the port's own
copy).

Production code holds named fault points, made once at import:

    _PT_DECODE = faults.point("serving.decode_step")
    ...
    def _decode(...):
        _PT_DECODE()                    # a hit: no-op unless armed

The serving engine's points are `serving.slot_join`, `serving.prefill`,
`serving.pattach`, `serving.decode_step`, `serving.prefill_chunk` and
`serving.preempt`; each fires on the host before the operation mutates
anything. The data pipeline adds `dataloader.next` (each batch a
DataLoader yields, as its payload) and `checkpoint.write` /
`checkpoint.read` (each shard's bytes of `io.checkpoint`). A hit may pass a payload through, so that an armed corrupt
plan can change the bytes in flight (`buf = _PT_WRITE(payload=buf)`).

Tests arm points with injection plans:

    with faults.inject("serving.decode_step", on="nth", n=3):
        ...                             # the 3rd hit raises InjectedFault

    faults.inject("serving.prefill", on="prob", p=0.2, seed=7,
                  action="delay", delay_s=0.05)

Plans (each injection keeps its own hit counter, so a failure pattern
repeats exactly from run to run):

  * ``on="nth"``    fires on exactly the Nth hit after install;
  * ``on="every"``  fires on every Kth hit (K, 2K, 3K, ...);
  * ``on="prob"``   fires with probability p from a private
    ``random.Random(seed)`` stream;
  * ``on="always"`` fires on every hit;
  * ``max_fires``   caps the fires of any plan.

Actions: ``raise`` (an exception class or instance, `InjectedFault` by
default), ``delay`` (sleep `delay_s`, to trip a watchdog), ``corrupt``
(transform the payload; by default flip one byte of a bytes payload).
Injections on one point act in install order; delays and corruptions
add up, a raise ends the hit.

A disarmed hit reads one module-global boolean: no lock, no dictionary
lookup, no allocation, so the points stay in production code.
"""
from __future__ import annotations

import random
import threading
import time

__all__ = [
    "InjectedFault", "FaultPoint", "Injection", "point", "points",
    "inject", "reset", "armed", "hit_counts",
]

_ARMED = False                 # the only thing a disarmed hit reads
_LOCK = threading.RLock()
_POINTS = {}                   # name -> FaultPoint (import-time registry)
_INJECTIONS = {}               # name -> [Injection, ...] (install order)
_HIT_COUNTS = {}               # name -> hits observed while armed


class InjectedFault(RuntimeError):
    """Default exception raised by an armed ``action="raise"`` plan."""


class FaultPoint:
    """A named instrumentation marker. Calling it is the *hit*: returns
    the payload (possibly corrupted), raises or delays per the armed
    plans, and is a single-boolean no-op when nothing is armed."""

    __slots__ = ("name",)

    def __init__(self, name):
        self.name = name

    def __call__(self, payload=None):
        if not _ARMED:
            return payload
        return _fire(self.name, payload)

    def __repr__(self):
        return f"FaultPoint({self.name!r})"


def point(name):
    """Register (idempotently) and return the named fault point."""
    with _LOCK:
        p = _POINTS.get(name)
        if p is None:
            p = _POINTS[name] = FaultPoint(str(name))
        return p


def points():
    """Sorted names of every registered fault point."""
    with _LOCK:
        return sorted(_POINTS)


def _default_corrupt(payload):
    """Flip one byte in the middle of a bytes payload (a detectable,
    deterministic 'torn write'); non-bytes payloads pass unchanged."""
    if isinstance(payload, (bytes, bytearray)) and len(payload):
        b = bytearray(payload)
        b[len(b) // 2] ^= 0xFF
        return bytes(b)
    return payload


class Injection:
    """One armed plan on one point. Context manager: ``with
    faults.inject(...):`` removes it on exit. `hits`/`fired` counters
    make 'counters match injected faults' assertions exact."""

    _ONS = ("always", "nth", "every", "prob")
    _ACTIONS = ("raise", "delay", "corrupt")

    def __init__(self, name, *, on, n, k, p, seed, action, exc,
                 delay_s, corrupt, max_fires):
        if on not in self._ONS:
            raise ValueError(f"on must be one of {self._ONS}, got {on!r}")
        if action not in self._ACTIONS:
            raise ValueError(
                f"action must be one of {self._ACTIONS}, got {action!r}")
        if on == "every" and k < 1:
            raise ValueError("every-K plans need k >= 1")
        self.point = name
        self.on = on
        self.n = int(n)
        self.k = int(k)
        self.p = float(p)
        self.action = action
        self.exc = exc
        self.delay_s = float(delay_s)
        self.corrupt = corrupt
        self.max_fires = None if max_fires is None else int(max_fires)
        self.hits = 0
        self.fired = 0
        self._rng = random.Random(seed)

    # called under _LOCK
    def _should_fire(self):
        self.hits += 1
        if self.max_fires is not None and self.fired >= self.max_fires:
            return False
        if self.on == "always":
            return True
        if self.on == "nth":
            return self.hits == self.n
        if self.on == "every":
            return self.hits % self.k == 0
        return self._rng.random() < self.p

    def remove(self):
        global _ARMED
        with _LOCK:
            lst = _INJECTIONS.get(self.point)
            if lst is not None and self in lst:
                lst.remove(self)
                if not lst:
                    del _INJECTIONS[self.point]
            if not _INJECTIONS:
                _ARMED = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.remove()
        return False

    def __repr__(self):
        return (f"Injection({self.point!r}, on={self.on!r}, "
                f"action={self.action!r}, hits={self.hits}, "
                f"fired={self.fired})")


def inject(name, *, on="always", n=1, k=1, p=1.0, seed=0,
           action="raise", exc=InjectedFault, delay_s=0.01,
           corrupt=None, max_fires=None):
    """Arm an injection plan on the named point; returns the
    `Injection` (usable as a context manager). Arms the global harness;
    `reset()` or removing the last injection disarms it."""
    global _ARMED
    inj = Injection(name, on=on, n=n, k=k, p=p, seed=seed, action=action,
                    exc=exc, delay_s=delay_s, corrupt=corrupt,
                    max_fires=max_fires)
    with _LOCK:
        point(name)
        _INJECTIONS.setdefault(name, []).append(inj)
        _ARMED = True
    return inj


def _fire(name, payload):
    # decide under the lock (counters stay exact under threads), act
    # outside it (a delay must not serialize unrelated points)
    with _LOCK:
        _HIT_COUNTS[name] = _HIT_COUNTS.get(name, 0) + 1
        firing = []
        for inj in _INJECTIONS.get(name, ()):
            if inj._should_fire():
                inj.fired += 1
                firing.append(inj)
    for inj in firing:
        if inj.action == "delay":
            time.sleep(inj.delay_s)
        elif inj.action == "corrupt":
            fn = inj.corrupt if inj.corrupt is not None else \
                _default_corrupt
            payload = fn(payload)
        else:
            e = inj.exc
            if isinstance(e, BaseException):
                raise e
            raise e(f"injected fault at {name!r} (hit #{inj.hits})")
    return payload


def reset():
    """Remove every injection, zero the hit counters, disarm. Test
    teardowns call this so faults never leak across tests."""
    global _ARMED
    with _LOCK:
        _INJECTIONS.clear()
        _HIT_COUNTS.clear()
        _ARMED = False


def armed():
    return _ARMED


def hit_counts():
    """Per-point hit counts observed while armed (disarmed hits are
    never counted — they must cost nothing)."""
    with _LOCK:
        return dict(_HIT_COUNTS)
