"""Serving of the port: the dense greedy ``GenerationEngine`` and the
serving error types."""
from .engine import (EngineClosedError, QueueFullError, ReplicaFailedError,
                     RequestTimeoutError, ServingError)
from .generate import GenerationEngine, GenerationResult, GenerationStream

__all__ = ["GenerationEngine", "GenerationResult", "GenerationStream",
           "ServingError", "EngineClosedError", "QueueFullError",
           "RequestTimeoutError", "ReplicaFailedError"]
