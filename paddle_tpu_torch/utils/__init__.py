"""paddle.utils (the JAX package's `utils/`): the flag registry, the stat
registry (`monitor`), custom C++ ops (`cpp_extension`), `try_import` and
`unique_name`."""
from . import cpp_extension, flags, monitor  # noqa: F401
from .flags import get_flags, set_flags  # noqa: F401

__all__ = ["cpp_extension", "flags", "monitor", "get_flags", "set_flags",
           "try_import", "unique_name"]


def try_import(name):
    import importlib

    try:
        return importlib.import_module(name)
    except ImportError as e:
        raise ImportError(f"optional dependency {name} not available: {e}")


def unique_name(prefix="tmp"):
    """`prefix_<n>`, n counting up from 0 for each prefix (the layers'
    name counter)."""
    from ..nn.layer.layers import _unique_name

    return _unique_name(prefix)
