"""Serving on the port: paged KV cache, sampler, runner, engine, multi-LoRA,
speculative decoding and the serve deployment class."""

from .cache import (KVCache, PageAllocator, PrefixCache, SequenceTable,
                    chained_page_keys, init_kv_cache)
from .engine import EngineConfig, LLMEngine, RequestState, StepOutput
from .lora import LoRAPool, init_lora_adapter, lora_delta
from .sampling import TOP_K_CAP, SamplingParams, sample_from_logits
from .serve import LLMServer, ServeHooks, build_llm_deployment
from .spec_decode import SpecConfig, SpecDecoder, accept_prefix, remote_verify

__all__ = [
    "EngineConfig", "KVCache", "LLMEngine", "LLMServer", "LoRAPool",
    "PageAllocator", "PrefixCache", "RequestState", "SamplingParams",
    "SequenceTable", "ServeHooks", "SpecConfig", "SpecDecoder", "StepOutput",
    "TOP_K_CAP", "accept_prefix", "build_llm_deployment",
    "chained_page_keys", "init_kv_cache", "init_lora_adapter", "lora_delta",
    "remote_verify", "sample_from_logits",
]
