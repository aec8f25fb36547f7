"""Continuous-batching serving over a dense or paged slot pool, with
optional speculative decoding, LoRA tenants, int8 weights, chunked
prefill, traffic shaping (SLO classes, weighted fair queueing,
preemption to the prefix cache), the mesh-sharded engines
(`sharded.py`), `ServingCallback` hooks, the eager fallback of a failed
join and `to_prometheus`."""
from .adapters import AdapterPool, OutOfAdapters, quantize_net
from .engine import (PagedServingEngine, ReplayDiverged, ServingEngine,
                     WatchdogTimeout)
from .metrics import (CallbackList, ServingCallback, ServingMetrics,
                      to_prometheus)
from .paging import OutOfPages, PageAllocator, RadixPrefixCache
from .scheduler import QueueFull, Request, RequestResult, Scheduler
from .server import ServerCrashed, ServingServer
from .shaping import BATCH, INTERACTIVE, ShapingScheduler, SLOClass
from .sharded import ShardedPagedServingEngine, ShardedServingEngine

__all__ = ["ServingEngine", "PagedServingEngine", "WatchdogTimeout",
           "ReplayDiverged", "AdapterPool", "OutOfAdapters", "quantize_net",
           "ServingMetrics", "OutOfPages", "PageAllocator",
           "RadixPrefixCache", "QueueFull", "Request", "RequestResult",
           "Scheduler", "ServerCrashed", "ServingServer", "ShapingScheduler",
           "SLOClass", "INTERACTIVE", "BATCH", "ShardedServingEngine",
           "ShardedPagedServingEngine", "ServingCallback", "CallbackList",
           "to_prometheus"]
