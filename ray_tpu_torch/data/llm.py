"""Batch LLM inference over datasets (counterpart of
``ray_tpu/data/llm.py``).

The processor is a plain ``map_batches`` function; each process that runs
it lazily builds ONE engine per model, engine configuration, seed and
device, and reuses it across its batches (the reference's engine-stage
actor reuse). The engine serves ``init_params(LLAMA_CONFIGS[model],
seed)``, whose values differ from the reference's
``init_params(PRNGKey(seed))``: another generator.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from .._private.device import DeviceLike, resolve_device

_ENGINE_CACHE: Dict[Tuple, Any] = {}


def engine_key(model: str, engine_config: Optional[dict], seed: int,
               device: DeviceLike = None) -> Tuple:
    """The cache key of the engine a processor of these arguments uses."""
    return (model, tuple(sorted((engine_config or {}).items())), seed,
            resolve_device(device))


def _get_engine(key: Tuple):
    engine = _ENGINE_CACHE.get(key)
    if engine is None:
        from ..llm import EngineConfig, LLMEngine
        from ..models.llama import LLAMA_CONFIGS, init_params

        model, ecfg_items, seed, dev = key
        cfg = LLAMA_CONFIGS[model]
        engine = LLMEngine(init_params(cfg, seed, device=dev), cfg,
                           EngineConfig(**dict(ecfg_items)), device=dev)
        _ENGINE_CACHE[key] = engine
    return engine


def build_llm_processor(model: str = "tiny", *,
                        engine_config: Optional[dict] = None,
                        sampling: Optional[dict] = None,
                        prompt_column: str = "prompt_ids",
                        output_column: str = "output_ids",
                        seed: int = 0, device: DeviceLike = None):
    """A batch-format processor for ``Dataset.map_batches``: reads token
    id lists from ``prompt_column``, generates with continuous batching
    on ``device`` (default: the card, resolved where the processor runs),
    writes ``output_column``."""
    engine_config = dict(engine_config or {})
    sampling = dict(sampling or {})

    def process(batch: Dict[str, List[Any]]) -> Dict[str, List[Any]]:
        from ..llm import SamplingParams

        engine = _get_engine(engine_key(model, engine_config, seed, device))
        prompts = [list(map(int, p)) for p in batch[prompt_column]]
        outs = engine.generate(prompts, SamplingParams(**sampling))
        out = dict(batch)
        out[output_column] = outs
        return out

    return process
