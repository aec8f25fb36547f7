"""Continuous-batching serving over a dense or paged slot pool, with
optional speculative decoding."""
from .engine import PagedServingEngine, ServingEngine
from .metrics import ServingMetrics
from .paging import OutOfPages, PageAllocator, RadixPrefixCache
from .scheduler import QueueFull, Request, RequestResult, Scheduler
from .server import ServerCrashed, ServingServer

__all__ = ["ServingEngine", "PagedServingEngine", "ServingMetrics",
           "OutOfPages", "PageAllocator", "RadixPrefixCache", "QueueFull",
           "Request", "RequestResult", "Scheduler", "ServerCrashed",
           "ServingServer"]
