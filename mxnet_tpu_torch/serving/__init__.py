"""Serving of the port: the greedy ``GenerationEngine`` (dense or paged
KV cache, fp32 or int8 weights), the paged cache's host bookkeeping
(``paging``) and the serving error types."""
from .engine import (EngineClosedError, QueueFullError, ReplicaFailedError,
                     RequestTimeoutError, ServingError)
from .generate import GenerationEngine, GenerationResult, GenerationStream

__all__ = ["GenerationEngine", "GenerationResult", "GenerationStream",
           "ServingError", "EngineClosedError", "QueueFullError",
           "RequestTimeoutError", "ReplicaFailedError"]
