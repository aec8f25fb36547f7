"""Continuous-batching serving over a dense or paged slot pool, with
optional speculative decoding, LoRA tenants, int8 weights, chunked
prefill, and traffic shaping (SLO classes, weighted fair queueing,
preemption to the prefix cache)."""
from .adapters import AdapterPool, OutOfAdapters, quantize_net
from .engine import (PagedServingEngine, ReplayDiverged, ServingEngine,
                     WatchdogTimeout)
from .metrics import ServingMetrics
from .paging import OutOfPages, PageAllocator, RadixPrefixCache
from .scheduler import QueueFull, Request, RequestResult, Scheduler
from .server import ServerCrashed, ServingServer
from .shaping import BATCH, INTERACTIVE, ShapingScheduler, SLOClass

__all__ = ["ServingEngine", "PagedServingEngine", "WatchdogTimeout",
           "ReplayDiverged", "AdapterPool", "OutOfAdapters", "quantize_net",
           "ServingMetrics", "OutOfPages", "PageAllocator",
           "RadixPrefixCache", "QueueFull", "Request", "RequestResult",
           "Scheduler", "ServerCrashed", "ServingServer", "ShapingScheduler",
           "SLOClass", "INTERACTIVE", "BATCH"]
