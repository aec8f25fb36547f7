"""Continuous-batching serving over a dense or paged slot pool, with
optional speculative decoding, LoRA tenants and int8 weights."""
from .adapters import AdapterPool, OutOfAdapters, quantize_net
from .engine import PagedServingEngine, ServingEngine
from .metrics import ServingMetrics
from .paging import OutOfPages, PageAllocator, RadixPrefixCache
from .scheduler import QueueFull, Request, RequestResult, Scheduler
from .server import ServerCrashed, ServingServer

__all__ = ["ServingEngine", "PagedServingEngine", "AdapterPool",
           "OutOfAdapters", "quantize_net", "ServingMetrics",
           "OutOfPages", "PageAllocator", "RadixPrefixCache", "QueueFull",
           "Request", "RequestResult", "Scheduler", "ServerCrashed",
           "ServingServer"]
