"""ray_tpu_torch's batch LLM processor against ray_tpu's (CPU).

``data/llm.py``: the processor is a plain ``map_batches`` function, so
both are called in-process on the same batch. The port's
``init_params(cfg, seed)`` draws other values than
``PRNGKey(seed)``, so the parity test puts an engine built from ray_tpu's
weights (carried over with ``params_from_jax``) into the port's cache
under the processor's key; greedy ``output_ids`` must be equal.
"""

import jax
import numpy as np
import pytest
import torch

from ray_tpu.data.llm import build_llm_processor as j_build
from ray_tpu.models import LLAMA_CONFIGS as J_CONFIGS
from ray_tpu.models import init_params as j_init

from ray_tpu_torch.data import build_llm_processor
from ray_tpu_torch.data import llm as dllm
from ray_tpu_torch.llm import EngineConfig, LLMEngine, SamplingParams
from ray_tpu_torch.models import LLAMA_CONFIGS, init_params, params_from_jax

# six xdist workers share the machine's cores
torch.set_num_threads(2)

ECFG = {"max_num_seqs": 4, "page_size": 4, "num_pages": 64,
        "max_seq_len": 64}
GREEDY = {"temperature": 0.0, "max_tokens": 6}
PROMPTS = [[5, 17, 99], [3, 42, 7, 1], [2, 9, 4, 4, 8], [11]]


@pytest.fixture(autouse=True)
def empty_cache(monkeypatch):
    monkeypatch.setattr(dllm, "_ENGINE_CACHE", {})


def test_greedy_output_ids_equal_ray_tpu_s():
    batch = {"prompt_ids": [np.asarray(p) for p in PROMPTS],
             "idx": list(range(len(PROMPTS)))}
    want = j_build("tiny", engine_config=ECFG, sampling=GREEDY,
                   seed=0)(dict(batch))
    jp = jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(0),
                                         J_CONFIGS["tiny"]))
    cfg = LLAMA_CONFIGS["tiny"]
    dllm._ENGINE_CACHE[dllm.engine_key("tiny", ECFG, 0, "cpu")] = LLMEngine(
        params_from_jax(jp, device="cpu"), cfg, EngineConfig(**ECFG),
        device="cpu")
    got = build_llm_processor("tiny", engine_config=ECFG, sampling=GREEDY,
                              seed=0, device="cpu")(dict(batch))
    assert got["output_ids"] == want["output_ids"]
    assert all(len(o) == GREEDY["max_tokens"] for o in got["output_ids"])
    assert got["idx"] == batch["idx"]
    assert len(dllm._ENGINE_CACHE) == 1


def test_one_engine_per_key_reused_across_batches():
    """The first batch builds the engine from init_params(cfg, seed) on
    the device; later batches reuse it; another seed or device is another
    key. Columns are the caller's."""
    process = build_llm_processor("tiny", engine_config=ECFG,
                                  sampling=GREEDY, prompt_column="p",
                                  output_column="o", seed=3, device="cpu")
    first = process({"p": PROMPTS[:2]})
    (key, engine), = dllm._ENGINE_CACHE.items()
    assert key == ("tiny", tuple(sorted(ECFG.items())), 3,
                   torch.device("cpu"))
    second = process({"p": PROMPTS[2:]})
    assert list(dllm._ENGINE_CACHE.values()) == [engine]
    cfg = LLAMA_CONFIGS["tiny"]
    oracle = LLMEngine(init_params(cfg, 3, device="cpu"), cfg,
                       EngineConfig(**ECFG), device="cpu")
    want = oracle.generate(PROMPTS, SamplingParams(**GREEDY))
    assert first["o"] + second["o"] == want
    assert dllm.engine_key("tiny", ECFG, 4, "cpu") != key
    assert dllm.engine_key("tiny", ECFG, 3, "meta") != key


def test_the_engine_configuration_is_taken_when_built():
    """A later change to the caller's dict does not change the key."""
    ecfg = dict(ECFG)
    process = build_llm_processor("tiny", engine_config=ecfg,
                                  sampling=GREEDY, device="cpu")
    ecfg["max_num_seqs"] = 1
    process({"prompt_ids": PROMPTS[:1]})
    (key,) = dllm._ENGINE_CACHE
    assert dict(key[1]) == ECFG
