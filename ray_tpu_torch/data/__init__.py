"""The data-to-card path (``iter_device_batches``) and batch LLM inference
over datasets (``llm``) on the port."""

from .batches import iter_device_batches
from .llm import build_llm_processor

__all__ = ["build_llm_processor", "iter_device_batches"]
