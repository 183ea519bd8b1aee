"""Gluon layers of the port (the subset the GPT path uses)."""
from .basic_layers import (Dense, Dropout, Embedding, HybridSequential,
                           LayerNorm)

__all__ = ["Dense", "Dropout", "Embedding", "HybridSequential", "LayerNorm"]
