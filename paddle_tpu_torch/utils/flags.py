"""Runtime flag registry (the JAX package's `utils/flags.py`; reference:
platform/flags.cc, fluid.set_flags / get_flags).

The registry and its defaults are the JAX package's; `FLAGS_*`
environment variables are read at import. Two flags act:

  * `FLAGS_check_nan_inf`: every float output of every op is checked and
    the op that made a NaN or an Inf raises `FloatingPointError` (a
    `TorchDispatchMode` over the calling thread, the counterpart of
    `jax_debug_nans`), and anomaly mode checks the backward's. Each op
    then waits for its result: a debugging aid, not a training mode.
  * `FLAGS_cudnn_deterministic`: torch's deterministic algorithms, cuDNN's
    deterministic mode and cuBLAS's fixed workspace
    (`CUBLAS_WORKSPACE_CONFIG`, set if absent).

The others are kept and accepted so reference programs run unmodified.
Unlike the JAX package, a flag that acts takes effect when set from the
environment at import too (JAX applies `jax_debug_nans` only in
`set_flags`).
"""
from __future__ import annotations

import os

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["get_flags", "set_flags", "flag"]

_FLAGS = {
    "FLAGS_check_nan_inf": False,
    "FLAGS_cudnn_deterministic": False,
    "FLAGS_benchmark": False,
    "FLAGS_eager_delete_tensor_gb": 0.0,
    "FLAGS_allocator_strategy": "auto_growth",
    "FLAGS_fraction_of_gpu_memory_to_use": 0.92,
    "FLAGS_paddle_num_threads": 1,
    "FLAGS_use_pinned_memory": True,
    "FLAGS_seed": 0,
    "FLAGS_max_inplace_grad_add": 0,
    "FLAGS_sync_nccl_allreduce": True,
    "FLAGS_communicator_max_merge_var_num": 20,
    "FLAGS_communicator_send_queue_size": 20,
    "FLAGS_communicator_independent_recv_thread": True,
    "FLAGS_rpc_deadline": 180000,
    "FLAGS_rpc_retry_times": 3,
}


def _coerce(cur, val):
    if isinstance(cur, bool):
        return str(val).lower() in ("1", "true", "yes", "on")
    if isinstance(cur, int):
        return int(val)
    if isinstance(cur, float):
        return float(val)
    return val


class NanInfCheck(TorchDispatchMode):
    """Raise at the first op whose float output holds a NaN or an Inf."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor) and t.is_floating_point() \
                    and t.layout == torch.strided and t.numel() \
                    and not bool(torch.isfinite(t).all()):
                raise FloatingPointError(
                    f"FLAGS_check_nan_inf: {func} produced a NaN or an Inf")
        return out


_NAN_MODE = [None]


def _apply_nan_check():
    on = bool(_FLAGS["FLAGS_check_nan_inf"])
    mode = _NAN_MODE[0]
    if on and mode is None:
        _NAN_MODE[0] = NanInfCheck()
        _NAN_MODE[0].__enter__()
    elif not on and mode is not None:
        _NAN_MODE[0] = None
        mode.__exit__(None, None, None)
    torch.autograd.set_detect_anomaly(on)


def _apply_deterministic():
    on = bool(_FLAGS["FLAGS_cudnn_deterministic"])
    if on:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(on)
    torch.backends.cudnn.deterministic = on


_APPLY = {"FLAGS_check_nan_inf": _apply_nan_check,
          "FLAGS_cudnn_deterministic": _apply_deterministic}


def set_flags(flags: dict):
    for k, v in flags.items():
        _FLAGS[k] = _coerce(_FLAGS[k], v) if k in _FLAGS else v
        if k in _APPLY:
            _APPLY[k]()


def get_flags(flags):
    if isinstance(flags, str):
        flags = [flags]
    return {k: _FLAGS.get(k) for k in flags}


def flag(name, default=None):
    return _FLAGS.get(name, default)


for _k in list(_FLAGS):
    if _k in os.environ:
        _FLAGS[_k] = _coerce(_FLAGS[_k], os.environ[_k])
        if _k in _APPLY and _FLAGS[_k]:
            _APPLY[_k]()
