"""Execution-mode switch: paddle.enable_static / disable_static (the JAX
package's `framework.py`; reference fluid/framework.py dygraph guards).
Paddle 2.0 runs dygraph by default, as both packages do; static programs
are built and run through `paddle.static` / `fluid` either way."""
from __future__ import annotations

_static_mode = [False]


def enable_static():
    _static_mode[0] = True


def disable_static():
    _static_mode[0] = False


def in_dynamic_mode() -> bool:
    return not _static_mode[0]


def in_dygraph_mode() -> bool:
    return not _static_mode[0]
