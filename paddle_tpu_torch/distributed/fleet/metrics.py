"""Fleet's distributed metrics: sum / max / min / auc / mae / rmse / mse /
acc over all trainers (the JAX package's `fleet/metrics.py`; reference:
python/paddle/distributed/fleet/metrics/metric.py).

Each trainer holds local metric statistics (e.g. the stat_pos / stat_neg
buckets of the auc op) and the fleet metric reduces them across the
trainers before the final formula. The reduction is a real all-reduce
over the world's process group (float64, on the host under gloo, on the
rank's device under NCCL) whenever `torch.distributed` is initialised
with more than one rank. A trainer without a world (the parameter-server
mode) reduces over a rendezvous store instead: call
`init_metric_context(store, rank, world)` or set
`PT_METRIC_STORE=<host:port>` with PADDLE_TRAINER_ID /
PADDLE_TRAINERS_NUM (the launcher exports them). With neither, world=1
semantics apply (the identity).
"""
from __future__ import annotations

import base64
import builtins
import os

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["init_metric_context", "sum", "max", "min", "auc", "mae", "rmse",
           "mse", "acc"]

_CTX = {"store": None, "rank": 0, "world": 1, "round": 0, "env_tried": False}


def init_metric_context(store, rank, world):
    """Install the store that trainers without a process group reduce
    over."""
    _CTX.update(store=store, rank=int(rank), world=int(world), round=0,
                env_tried=True)


def _maybe_init_from_env():
    if _CTX["store"] is not None or _CTX["env_tried"]:
        return
    _CTX["env_tried"] = True
    ep = os.environ.get("PT_METRIC_STORE")
    world = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    if not ep or world <= 1:
        return
    from ..rendezvous import TCPStore

    host, port = ep.rsplit(":", 1)
    _CTX.update(
        store=TCPStore(host, int(port), is_master=False, world_size=world),
        rank=int(os.environ.get("PADDLE_TRAINER_ID", "0")), world=world)


def _resolve(x, scope=None):
    """A numpy array, a tensor (any device), a sequence of numbers, or a
    static-graph variable (a fluid Variable or its name), read from
    `scope` (None: the fluid global scope), as the JAX package reads
    it."""
    if isinstance(x, str) or (hasattr(x, "block") and hasattr(x, "name")):
        from ...fluid.executor import _to_numpy, global_scope

        name = x if isinstance(x, str) else x.name
        scope = global_scope() if scope is None else scope
        if scope.find_var(name) is None:
            raise KeyError(f"fleet.metrics: variable {name!r} not in scope")
        return _to_numpy(scope.get_value(name)).astype(np.float64)
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu").double().numpy()
    return np.asarray(x)


_OPS = {"sum": (np.add, dist.ReduceOp.SUM),
        "max": (np.maximum, dist.ReduceOp.MAX),
        "min": (np.minimum, dist.ReduceOp.MIN)}


def _all_reduce(arr, mode="sum"):
    """The elementwise `mode` of a host array over every trainer."""
    arr = np.asarray(arr, np.float64)
    if dist.is_initialized() and dist.get_world_size() > 1:
        from .. import device as _device

        dev = _device() if dist.get_backend() == "nccl" else None
        t = torch.from_numpy(arr.copy()).to(dev or "cpu")
        dist.all_reduce(t, _OPS[mode][1])
        return t.cpu().numpy().reshape(arr.shape)
    _maybe_init_from_env()
    store, rank, world = _CTX["store"], _CTX["rank"], _CTX["world"]
    if store is None or world <= 1:
        return arr
    rnd = _CTX["round"]
    _CTX["round"] = rnd + 1
    # PT_METRIC_NS namespaces the rounds per job incarnation, so an
    # elastic restart against a long-lived store cannot read a crashed
    # run's leftover buffers
    ns = os.environ.get("PT_METRIC_NS", "")
    key = f"__fleet_metric_{ns}_{rnd}"
    store.set(f"{key}_{rank}",
              base64.b64encode(arr.astype("<f8").tobytes()).decode())
    parts = []
    for r in range(world):
        raw = base64.b64decode(store.get(f"{key}_{r}"))
        parts.append(np.frombuffer(raw, "<f8").reshape(arr.shape))
    op = _OPS[mode][0]
    out = parts[0]
    for p in parts[1:]:
        out = op(out, p)
    # bounded store: the last reader deletes the round's keys
    if hasattr(store, "add") and hasattr(store, "delete"):
        done = store.add(f"{key}__done", 1)
        if done >= world:
            for r in range(world):
                store.delete(f"{key}_{r}")
            store.delete(f"{key}__done")
    return out


def sum(input, scope=None):  # noqa: A001 (the reference's name)
    """Distributed sum of a local stat array."""
    return _all_reduce(_resolve(input, scope), "sum")


def max(input, scope=None):  # noqa: A001
    """Distributed elementwise max of a local stat array."""
    return _all_reduce(_resolve(input, scope), "max")


def min(input, scope=None):  # noqa: A001
    """Distributed elementwise min of a local stat array."""
    return _all_reduce(_resolve(input, scope), "min")


def auc(stat_pos, stat_neg, scope=None):
    """Distributed AUC from the bucketed stat_pos / stat_neg of the auc
    op: both histograms all-reduced, then the ROC area integrated bucket
    by bucket from the highest threshold down."""
    pos = _all_reduce(_resolve(stat_pos, scope).reshape(-1), "sum")
    neg = _all_reduce(_resolve(stat_neg, scope).reshape(-1), "sum")
    area = tp = fp = 0.0
    total = 0.0
    for i in range(len(pos) - 1, -1, -1):
        new_tp = tp + pos[i]
        new_fp = fp + neg[i]
        total += pos[i] + neg[i]
        area += (new_fp - fp) * (tp + new_tp) / 2.0
        tp, fp = new_tp, new_fp
    if tp * fp == 0 or total == 0:
        return 0.5
    return float(area / (tp * fp))


def _reduced_scalar(x, scope):
    return float(_all_reduce(_resolve(x, scope).reshape(-1), "sum").sum())


def mae(abserr, total_ins_num, scope=None):
    """Distributed mean absolute error from (sum |err|, instance count)."""
    err = _reduced_scalar(abserr, scope)
    n = _reduced_scalar(total_ins_num, scope)
    return err / builtins.max(n, 1.0)


def rmse(sqrerr, total_ins_num, scope=None):
    """Distributed root mean squared error from (sum err^2, count)."""
    return float(np.sqrt(mse(sqrerr, total_ins_num, scope)))


def mse(sqrerr, total_ins_num, scope=None):
    """Distributed mean squared error from (sum err^2, count)."""
    err = _reduced_scalar(sqrerr, scope)
    n = _reduced_scalar(total_ins_num, scope)
    return err / builtins.max(n, 1.0)


def acc(correct, total, scope=None):
    """Distributed accuracy from (correct count, total count)."""
    c = _reduced_scalar(correct, scope)
    t = _reduced_scalar(total, scope)
    return c / builtins.max(t, 1.0)
