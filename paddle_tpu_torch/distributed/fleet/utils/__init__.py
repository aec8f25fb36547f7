from .fs import HDFSClient, LocalFS  # noqa: F401

__all__ = ["LocalFS", "HDFSClient"]
