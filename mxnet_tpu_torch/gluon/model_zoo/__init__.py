"""Model zoo of the port: the GPT decoder family."""
from . import gpt

__all__ = ["gpt"]
