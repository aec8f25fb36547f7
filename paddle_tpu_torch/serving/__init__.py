"""Continuous-batching serving over a dense slot pool."""
from .engine import ServingEngine
from .metrics import ServingMetrics
from .scheduler import QueueFull, Request, RequestResult, Scheduler
from .server import ServerCrashed, ServingServer

__all__ = ["ServingEngine", "ServingMetrics", "QueueFull", "Request",
           "RequestResult", "Scheduler", "ServerCrashed", "ServingServer"]
