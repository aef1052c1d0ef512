"""ray_tpu_torch's fleet KV plane against ray_tpu's (CPU, f32).

``export_kv_request`` -> ``inject_request`` between two port engines, and
a ``ray_tpu`` payload injected into the port, continue the monolithic
greedy stream exactly, with no prefill on the decode engine. A payload
that cannot land (too few pages, another page size, another dtype or
device, missing arrays) falls back to a recompute prefill and still
gives the monolithic stream.

The port's payload holds host ``torch`` tensors in the cache dtype where
``ray_tpu``'s holds numpy arrays: numpy has no bf16. ``inject_request``
takes those tensors, or numpy f32 or f16; a numpy bf16 payload (what
``ray_tpu`` exports from a bf16 cache) recomputes.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from ray_tpu.llm import EngineConfig as JEngineConfig
from ray_tpu.llm import LLMEngine as JLLMEngine
from ray_tpu.llm import SamplingParams as JSamplingParams
from ray_tpu.models import LLAMA_CONFIGS as J_CONFIGS
from ray_tpu.models import init_params as j_init

from ray_tpu_torch.llm import EngineConfig, LLMEngine, SamplingParams
from ray_tpu_torch.models import LLAMA_CONFIGS, params_from_jax

# six xdist workers share the machine's cores
torch.set_num_threads(2)

CFG = LLAMA_CONFIGS["tiny"]
JCFG = J_CONFIGS["tiny"]
# tests/test_serve_kv_routing.py's engine: 16-token pages, prefix caching
ECFG = dict(max_num_seqs=2, max_seq_len=128, num_pages=64, page_size=16,
            enable_prefix_caching=True)
PROMPT = list(range(1, 40))
N = 8


@pytest.fixture(scope="module")
def weights():
    jp = j_init(jax.random.PRNGKey(0), JCFG)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _greedy(n=N):
    return SamplingParams(temperature=0.0, max_tokens=n)


def _engine(params, cfg=CFG, **ecfg):
    return LLMEngine(params, cfg, EngineConfig(**{**ECFG, **ecfg}),
                     device="cpu")


def _drain(engine, toks):
    while engine.has_unfinished():
        toks.extend(o.token for o in engine.step())
    return toks


def _prefilled(engine, prompt=PROMPT, model_id=None):
    rid = engine.add_request(list(prompt), _greedy(), model_id=model_id)
    first = []
    while not first:
        first = engine.step(skip_decode=True)
    assert len(first) == 1 and not first[0].finished
    return rid


@pytest.fixture(scope="module")
def jax_mono(weights):
    eng = JLLMEngine(weights[0], JCFG, JEngineConfig(**ECFG))
    eng.add_request(PROMPT, JSamplingParams(temperature=0.0, max_tokens=N))
    return _drain(eng, [])


def test_engine_kv_handoff_matches_monolithic(weights, jax_mono):
    mono = _engine(weights[1])
    mono.add_request(PROMPT, _greedy())
    assert _drain(mono, []) == jax_mono

    pre = _engine(weights[1])
    rid = _prefilled(pre)
    payload = pre.export_kv_request(rid)
    assert pre.requests.pop(rid).finish_reason == "handoff"
    assert not pre.has_unfinished()
    assert payload["ctx_len"] == len(PROMPT)
    assert len(payload["output"]) == 1

    dec = _engine(weights[1])
    new = dec.inject_request(payload, _greedy())
    assert dec.requests[new].ctx_len == len(PROMPT)   # joined decode
    assert _drain(dec, list(payload["output"])) == jax_mono
    stats = dec.stats()
    assert stats["injected"] == 1
    assert stats["prefills"] == stats["prefill_chunks"] == 0
    assert stats["decode_steps"] > 0
    # the shipped prompt pages now warm the decode engine's prefix cache
    assert len(dec.prefix_cache) == len(PROMPT) // ECFG["page_size"]


def test_jax_payload_continues_its_stream_on_the_port(weights, jax_mono):
    """A ray_tpu payload (numpy f32 pages) lands on the port and decodes
    ray_tpu's monolithic stream."""
    pre = JLLMEngine(weights[0], JCFG, JEngineConfig(**ECFG))
    rid = pre.add_request(PROMPT, JSamplingParams(temperature=0.0,
                                                  max_tokens=N))
    while not pre.step(skip_decode=True):
        pass
    payload = pre.export_kv_request(rid)
    assert isinstance(payload["k"], np.ndarray)
    dec = _engine(weights[1])
    dec.inject_request(payload, _greedy())
    assert _drain(dec, list(payload["output"])) == jax_mono
    assert dec.stats()["injected"] == 1
    assert dec.stats()["prefill_chunks"] == 0


@pytest.mark.parametrize("corrupt", [
    "too_few_pages", "page_size", "k_missing", "v_shape", "int_dtype",
    "meta_device", "numpy_f64", "a_list", "no_output"])
def test_corrupt_handoff_falls_back_to_recompute(weights, jax_mono,
                                                  corrupt):
    pre = _engine(weights[1])
    payload = pre.export_kv_request(_prefilled(pre))
    k = payload["k"]
    payload.update({
        "too_few_pages": {"k": k[:, :1]},
        "page_size": {"page_size": 8},
        "k_missing": {"k": None},
        "v_shape": {"v": payload["v"][..., :4]},
        "int_dtype": {"k": k.to(torch.int32)},
        "meta_device": {"k": k.to("meta")},
        "numpy_f64": {"k": k.double().numpy()},
        "a_list": {"k": k.tolist()},
        "no_output": {"output": []},
    }[corrupt])
    dec = _engine(weights[1])
    dec.inject_request(payload, _greedy())
    got = _drain(dec, list(payload["output"]))
    assert got == jax_mono
    stats = dec.stats()
    assert stats["injected"] == 0 and stats["prefill_chunks"] > 0


def test_inject_without_a_free_slot_recomputes(weights, jax_mono):
    pre = _engine(weights[1])
    payload = pre.export_kv_request(_prefilled(pre))
    dec = _engine(weights[1], max_num_seqs=1)
    other = dec.add_request([9, 8, 7], _greedy(3))
    dec.step(skip_decode=True)                       # holds the one slot
    new = dec.inject_request(payload, _greedy())
    assert dec.requests[new].slot < 0                # waiting
    outs = {other: [], new: list(payload["output"])}
    while dec.has_unfinished():
        for o in dec.step():
            outs[o.request_id].append(o.token)
    assert outs[new] == jax_mono
    assert dec.stats()["injected"] == 0


def test_inject_at_its_budget_finishes(weights):
    pre = _engine(weights[1])
    payload = pre.export_kv_request(_prefilled(pre))
    dec = _engine(weights[1])
    rid = dec.inject_request(payload, _greedy(1))
    assert dec.requests[rid].finish_reason == "length"
    assert not dec.has_unfinished()


def test_export_refusals_match_jax(weights):
    eng = _engine(weights[1])
    jeng = JLLMEngine(weights[0], JCFG, JEngineConfig(**ECFG))
    for e in (eng, jeng):
        with pytest.raises(ValueError):
            e.export_kv_request("nope")
        rid = e.add_request(PROMPT)                  # not prefilled yet
        with pytest.raises(ValueError, match="not exportable"):
            e.snapshot_kv_request(rid)
        with pytest.raises(ValueError):
            e.inject_request({"prompt": [], "ctx_len": 0})


def test_lora_request_hands_off_with_its_adapter(weights):
    """model_id travels in the payload: a LoRA request handed off to an
    engine holding the same adapter continues its own stream, and an
    engine without LoRA refuses it as the reference does."""
    from ray_tpu_torch.llm import init_lora_adapter

    adapter = init_lora_adapter(CFG, 4, seed=3, dtype=CFG.dtype,
                                device="cpu")
    adapter["b_q"] = torch.randn(adapter["b_q"].shape,
                                 generator=torch.Generator().manual_seed(4))
    adapter["b_v"] = torch.randn(adapter["b_v"].shape,
                                 generator=torch.Generator().manual_seed(5))
    lcfg = dict(lora_rank=4, enable_prefix_caching=False)

    def lora_engine():
        eng = _engine(weights[1], **lcfg)
        eng.add_lora("tuned", adapter)
        return eng

    mono = lora_engine()
    mono.add_request(PROMPT, _greedy(), model_id="tuned")
    want = _drain(mono, [])
    base = _engine(weights[1], **lcfg)
    base.add_request(PROMPT, _greedy())
    assert want != _drain(base, [])                  # the adapter acts
    pre = lora_engine()
    payload = pre.export_kv_request(_prefilled(pre, model_id="tuned"))
    assert payload["model_id"] == "tuned"
    dec = lora_engine()
    dec.inject_request(payload, _greedy())
    assert _drain(dec, list(payload["output"])) == want
    assert dec.stats()["injected"] == 1 and dec.stats()["prefills"] == 0
    with pytest.raises(ValueError, match="lora_rank"):
        _engine(weights[1]).inject_request(payload, _greedy())


def test_bf16_payload_is_host_tensors_and_round_trips_bit_equal(weights):
    """The deliberate divergence: a bf16 cache exports host bf16 tensors
    (``ray_tpu`` exports numpy, which has no bf16), and they land
    bit-equal. numpy f16 lands too; a numpy bf16 payload does not, and
    recomputes."""
    cfg = dataclasses.replace(CFG, dtype=torch.bfloat16)
    params = jax.tree.map(lambda t: t.to(torch.bfloat16), weights[1])
    pre = _engine(params, cfg)
    src = pre.requests[_prefilled(pre)]
    pages = pre.seq_table.pages_of(src.slot)[:3]
    want_k = pre.cache.k[:, pages].clone()
    payload = pre.snapshot_kv_request(src.request_id)
    k = payload["k"]
    assert isinstance(k, torch.Tensor) and k.device.type == "cpu"
    assert k.dtype == torch.bfloat16 and tuple(k.shape) == (
        cfg.n_layers, 3, ECFG["page_size"], cfg.n_kv_heads, cfg.head_dim)
    assert torch.equal(k, want_k)

    dec = _engine(params, cfg)
    rid = dec.inject_request(payload, _greedy())
    slot = dec.requests[rid].slot
    got = dec.seq_table.pages_of(slot)[:3]
    assert torch.equal(dec.cache.k[:, got], want_k)
    assert torch.equal(dec.cache.v[:, got], pre.cache.v[:, pages])

    f16 = {**payload, "k": k.to(torch.float16).numpy(),
           "v": payload["v"].to(torch.float16).numpy()}
    dec16 = _engine(params, cfg)
    dec16.inject_request(f16, _greedy())
    assert dec16.stats()["injected"] == 1

    import ml_dtypes

    nbf16 = {**payload, "k": k.float().numpy().astype(ml_dtypes.bfloat16),
             "v": payload["v"].float().numpy().astype(ml_dtypes.bfloat16)}
    decb = _engine(params, cfg)
    decb.inject_request(nbf16, _greedy())
    assert decb.stats()["injected"] == 0 and len(decb.waiting) == 1
