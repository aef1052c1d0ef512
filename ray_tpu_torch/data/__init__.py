"""Batch LLM inference over datasets on the port (``llm``)."""

from .llm import build_llm_processor

__all__ = ["build_llm_processor"]
