"""LLM serving deployment: the engine behind an async serve replica
(counterpart of ``ray_tpu/llm/serve.py``).

The continuous-batching engine steps on an executor thread; each request
registers an asyncio queue that the engine pump feeds, so many streams
multiplex over one decode batch. Pooled replicas split the work: a
"prefill" replica runs the prompt pass and ships the request's KV pages to
a "decode" replica, which injects them and decodes.

The port imports nothing of ``ray_tpu``'s host plane. Each place where the
reference reaches it (the serve request context, the object store, the
deployment handle, the failpoints, the metrics) is a field of
:class:`ServeHooks`, whose defaults work in one process. A caller that
serves through ``ray_tpu.serve`` passes that package's functions in.
The server takes ``prompt_ids`` only: a tokenizer would need
``transformers``, which the port does not import.

Usage:
    server = LLMServer("8b", seed=7)               # on the card
    out = await server.completions({"prompt_ids": [...]})
    app = build_llm_deployment("tiny", deployment=serve.deployment,
                               hooks=ServeHooks(...))
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import json
import os
import pickle
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from .._private.config import global_config
from .._private.device import resolve_device
from ..models.convert import params_from_jax
from ..models.llama import LLAMA_CONFIGS, init_params
from ..util import metrics as _local_metrics
from ..util import tracing
from .cache import make_summary
from .engine import EngineConfig, LLMEngine
from .sampling import SamplingParams
from .spec_decode import remote_verify

# the serve replica's end-of-stream marker (``next_chunk``'s last reply)
_STREAM_END = "__serve_stream_end__"


def _none() -> None:
    return None


def _put(value):
    return value


def _get(ref, timeout=None):
    return ref


async def _afire(name: str, detail: Optional[str] = None) -> None:
    return None


@dataclasses.dataclass
class ServeHooks:
    """The host plane the server reaches, passed in by the caller. The
    defaults serve in one process; ``ray_tpu``'s own functions fit each
    field (``serve.replica.current_request_id``, ``ray_tpu.put``,
    ``serve.handle.DeploymentHandle``, ``_private.failpoints.afire``,
    ``util.metrics``)."""

    # the serve request's id and tenant, or None outside a request
    current_request_id: Callable[[], Optional[str]] = _none
    current_tenant_id: Callable[[], Optional[str]] = _none
    # object store: put(value) -> ref; get(ref or [refs], timeout=) -> value
    put: Callable[[Any], Any] = _put
    get: Callable[..., Any] = _get
    # handle(deployment, method, pool=) -> an object whose
    # route(payload, request_id=, tenant_id=) gives (awaitable, replica)
    # and whose _refresh(force=) re-reads the replica set. None: a prefill
    # or fleet-verify role raises when it is configured
    handle: Optional[Callable[..., Any]] = None
    # async failpoint afire(name, detail=): raises to inject a fault
    afire: Callable[..., Any] = _afire
    # a namespace with Counter, Gauge, Histogram and LATENCY_BUCKETS
    metrics: Any = _local_metrics


class LLMServer:
    """Serve deployment class hosting one engine replica."""

    def __init__(self, model: str = "tiny", *, init: str = "random",
                 params_path: Optional[str] = None,
                 engine_config: Optional[dict] = None,
                 tokenizer: Optional[str] = None, seed: int = 0,
                 quantize: Optional[str] = None,
                 speculation: Optional[dict] = None, device=None,
                 hooks: Optional[ServeHooks] = None):
        if tokenizer is not None:
            raise ValueError(
                "ray_tpu_torch's LLMServer takes prompt_ids only: a "
                "tokenizer needs transformers, which the port does not "
                "import")
        dev = resolve_device(device)
        self.hooks = hooks or ServeHooks()
        self.model_name = model
        if model in LLAMA_CONFIGS:
            cfg = LLAMA_CONFIGS[model]
        elif os.path.isdir(model):
            cfg = None  # an HF checkpoint directory is the model source
        else:
            raise ValueError(f"unknown model {model!r}: not a named "
                             f"config or an HF checkpoint dir")
        if quantize is not None and not (cfg is None or init == "hf"):
            raise ValueError(
                "quantize applies to HF-checkpoint loading only "
                "(init='hf' / a checkpoint-dir model)")
        if cfg is None or init == "hf":
            from ..models.hf_interop import load_hf_checkpoint

            path = model if cfg is None else (params_path or model)
            if not os.path.isdir(path):
                raise ValueError(
                    f"init='hf' needs an HF checkpoint directory; "
                    f"{path!r} is not one (pass it as `model` or "
                    f"`params_path`)")
            params, cfg = load_hf_checkpoint(path, quantize=quantize,
                                             device=dev)
        elif params_path:
            # a pickled tree of numpy arrays (the reference's weights)
            with open(params_path, "rb") as f:
                params = params_from_jax(pickle.load(f), device=dev)
        elif init == "random":
            params = init_params(cfg, seed=seed, device=dev)
        else:
            raise ValueError(f"unknown init {init!r}")
        ecfg = EngineConfig(**(engine_config or {}))
        self.engine = LLMEngine(params, cfg, ecfg, device=dev)
        self._queues: Dict[str, asyncio.Queue] = {}
        self._pump_task: Optional[asyncio.Task] = None
        # request id -> tenant, stashed at submit and popped on finish
        self._tenants: Dict[str, str] = {}
        # pool role, set by configure_pool before any request lands:
        # "mono" runs everything; "prefill" runs prompt passes and ships
        # KV to the decode pool; "decode" injects KV and decodes
        self._pool = "mono"
        self._dep_name: Optional[str] = None
        self._decode_handle = None
        self._m_handoff_bytes = None
        self._m_handoff_lat = None
        self._m_handoff_retries = None
        self._last_summary = None
        # serializes engine mutation between the pump's executor thread
        # and loop-side KV export/inject
        self._engine_lock = threading.Lock()
        metrics = self.hooks.metrics
        tags = {"model": self.model_name, "pool": self._pool}
        self._m_ttft = metrics.Histogram(
            "llm_ttft_seconds", "Time to first token per request",
            boundaries=metrics.LATENCY_BUCKETS,
            tag_keys=("model", "pool", "tenant")).set_default_tags(tags)
        self._m_tpot = metrics.Histogram(
            "llm_tpot_seconds", "Time per output token (decode) "
            "per request", boundaries=metrics.LATENCY_BUCKETS,
            tag_keys=("model", "pool", "tenant")).set_default_tags(tags)
        self._m_e2e = metrics.Histogram(
            "llm_request_e2e_seconds", "Arrival-to-finish request latency",
            boundaries=metrics.LATENCY_BUCKETS,
            tag_keys=("model", "pool", "tenant")).set_default_tags(tags)
        self._m_queue = metrics.Gauge(
            "llm_queue_depth", "Requests waiting for a decode slot",
            tag_keys=("model", "pool")).set_default_tags(tags)
        self._m_occupancy = metrics.Gauge(
            "llm_batch_slot_occupancy",
            "Fraction of decode slots running (continuous batching)",
            tag_keys=("model", "pool")).set_default_tags(tags)
        self._m_kv_util = metrics.Gauge(
            "llm_kv_page_utilization", "Fraction of KV-cache pages in use",
            tag_keys=("model", "pool")).set_default_tags(tags)
        self._m_cache_hit = metrics.Counter(
            "llm_prefix_cache_hit_tokens_total",
            "Prompt tokens served from the prefix cache",
            tag_keys=("model", "pool", "tenant")).set_default_tags(tags)
        self._m_prompt = metrics.Counter(
            "llm_prompt_tokens_total", "Prompt tokens received",
            tag_keys=("model", "pool", "tenant")).set_default_tags(tags)
        self._m_generated = metrics.Counter(
            "llm_generation_tokens_total", "Tokens generated",
            tag_keys=("model", "pool", "tenant")).set_default_tags(tags)
        self._m_spec_drafted = metrics.Counter(
            "llm_spec_draft_tokens_total",
            "Draft tokens proposed by the speculation drafter",
            tag_keys=("model", "pool")).set_default_tags(tags)
        self._m_spec_accepted = metrics.Counter(
            "llm_spec_accepted_tokens_total",
            "Draft tokens accepted by target verification",
            tag_keys=("model", "pool")).set_default_tags(tags)
        self._m_spec_ratio = metrics.Gauge(
            "llm_spec_acceptance_ratio",
            "Cumulative accepted/drafted token ratio",
            tag_keys=("model", "pool")).set_default_tags(tags)
        self._m_spec_verify = metrics.Histogram(
            "llm_spec_verify_seconds",
            "Target-model batched verify forward latency",
            boundaries=metrics.LATENCY_BUCKETS,
            tag_keys=("model", "pool")).set_default_tags(tags)
        self._spec_seen = {"drafted": 0, "accepted": 0}
        self._verify_handle = None
        if speculation:
            self.configure_speculation(speculation)

    @contextlib.contextmanager
    def _locked(self):
        """The engine lock, and on the card the engine's device as the
        thread's current one: executor threads start on the first card."""
        with self._engine_lock:
            if self.engine.device.type == "cuda":
                with torch.cuda.device(self.engine.device):
                    yield
            else:
                yield

    def _handle(self, deployment_name: str, method: str, pool: str):
        if self.hooks.handle is None:
            raise ValueError(
                f"the {pool!r} pool's {method} endpoint is reached through "
                f"a deployment handle: pass ServeHooks(handle=...)")
        return self.hooks.handle(deployment_name, method, pool=pool)

    # --- serve replica hooks (fleet KV plane) ---

    def configure_pool(self, pool: Optional[str],
                       deployment_name: str) -> None:
        """Replica hook: learn this replica's role in a disaggregated
        deployment. Prefill replicas skip decode in their pump and ship
        finished prompt KV to the decode pool; metrics re-tag so
        TTFT/TPOT split by pool."""
        self._pool = pool or "mono"
        self._dep_name = deployment_name
        tags = {"model": self.model_name, "pool": self._pool}
        for m in (self._m_ttft, self._m_tpot, self._m_e2e, self._m_queue,
                  self._m_occupancy, self._m_kv_util, self._m_cache_hit,
                  self._m_prompt, self._m_generated, self._m_spec_drafted,
                  self._m_spec_accepted, self._m_spec_ratio,
                  self._m_spec_verify):
            m.set_default_tags(tags)
        if pool == "decode":
            self._configure_fleet_verify(deployment_name)
        if pool == "prefill":
            self._decode_handle = self._handle(deployment_name,
                                               "decode_from_kv", "decode")
            metrics = self.hooks.metrics
            mtags = {"model": self.model_name}
            self._m_handoff_bytes = metrics.Counter(
                "serve_kv_handoff_bytes_total",
                "KV page bytes shipped prefill->decode",
                tag_keys=("model",)).set_default_tags(mtags)
            self._m_handoff_lat = metrics.Histogram(
                "serve_kv_handoff_seconds",
                "Prefill->decode KV handoff latency (export+ship+reply)",
                boundaries=metrics.LATENCY_BUCKETS,
                tag_keys=("model",)).set_default_tags(mtags)
            self._m_handoff_retries = metrics.Counter(
                "serve_kv_handoff_retries_total",
                "KV handoffs retried against another decode replica",
                tag_keys=("model",)).set_default_tags(mtags)

    def prefix_cache_summary(self):
        """Replica hook: this engine's cached prefix pages for the fleet
        KV router. None when prefix caching is off. Never blocks on the
        engine lock (a step can hold it for long): mid-step, the previous
        snapshot goes out instead."""
        cache = self.engine.prefix_cache
        if cache is None:
            return None
        if self._engine_lock.acquire(blocking=False):
            try:
                keys = list(cache._pages.keys())
            finally:
                self._engine_lock.release()
            self._last_summary = make_summary(keys,
                                              self.engine.ecfg.page_size)
        if self._last_summary is None:
            # first poll raced a step: an empty summary, not None (None
            # means "no hook" and stops the gossip for good)
            return make_summary((), self.engine.ecfg.page_size)
        return self._last_summary

    # --- speculative decoding (llm/spec_decode.py) ---

    def configure_speculation(self, spec) -> None:
        """Enable draft/verify speculative decoding on this replica's
        engine (the ``speculation`` kwarg, or the replica's deployment
        config override)."""
        if not spec:
            return
        with self._locked():
            self.engine.enable_speculation(spec)

    def _configure_fleet_verify(self, deployment_name: str) -> None:
        """Decode-pool replica in fleet-verify mode: each drafted window
        is also verified by the prefill pool against a KV snapshot. The
        local verify stays authoritative; the remote result only
        corroborates it (the SpecDecoder's agreement counters)."""
        if self.engine.spec is None \
                or not global_config().llm_spec_fleet_verify:
            return
        self._verify_handle = self._handle(deployment_name, "verify_draft",
                                           "prefill")
        hooks = self.hooks

        def _fleet_verify(payload, draft):
            # on the pump's executor thread inside the engine's spec
            # round, bounded by the timeout: a slow prefill pool degrades
            # to local-only, never a stall
            k = payload.pop("k")
            v = payload.pop("v")
            ref = hooks.put((k, v))
            out_ref, _replica = self._verify_handle.route(
                {"handoff": payload, "kv_ref": ref,
                 "draft": [int(t) for t in draft]})
            out = hooks.get(
                out_ref,
                timeout=global_config().llm_spec_fleet_verify_timeout_s)
            return None if out is None else [int(t) for t in out]

        self.engine._spec_remote_verify = _fleet_verify

    async def verify_draft(self, payload: Dict[str, Any]):
        """Verify one drafted window against this replica's target
        weights. The KV snapshot rides the object store; an unusable one
        recomputes the prefix inside remote_verify. Returns the emitted
        tokens (accepted prefix + the target's correction/bonus token)."""
        loop = asyncio.get_running_loop()
        meta = dict(payload["handoff"])
        if payload.get("kv_ref") is not None:
            k, v = await loop.run_in_executor(
                None, lambda: self.hooks.get(payload["kv_ref"], timeout=30))
            meta["k"] = k
            meta["v"] = v
        draft = [int(t) for t in payload["draft"]]

        def _run():
            with self._locked():
                return remote_verify(self.engine, meta, draft)

        return await loop.run_in_executor(None, _run)

    def _drain_spec_stats(self) -> None:
        """Fold the SpecDecoder's cumulative counters into the serve
        metrics as deltas (the pump calls this every step)."""
        spec = self.engine.spec
        if spec is None:
            return
        d = spec.drafted_total - self._spec_seen["drafted"]
        a = spec.accepted_total - self._spec_seen["accepted"]
        if d:
            self._m_spec_drafted.inc(d)
            self._spec_seen["drafted"] = spec.drafted_total
        if a:
            self._m_spec_accepted.inc(a)
            self._spec_seen["accepted"] = spec.accepted_total
        if spec.drafted_total:
            self._m_spec_ratio.set(spec.acceptance_ratio)
        for t in spec.take_verify_times():
            self._m_spec_verify.observe(t)

    # --- engine pump: one thread hop per step, fan-out to request queues ---

    def _ensure_pump(self) -> None:
        if self._pump_task is None or self._pump_task.done():
            self._pump_task = asyncio.get_running_loop().create_task(
                self._pump())

    def _step_engine(self, submitted: Optional[float] = None):
        """One engine step on the executor thread, and the clock when it
        returned (while the tracer is on). ``serve.pump.hop`` runs from
        the pump's submit (``submitted``) to the step's start, the wait
        for the engine lock included."""
        # prefill replicas never decode: exported requests finish with
        # the handoff
        with self._locked():
            tracing.record("serve.pump.hop", submitted)
            outs = self.engine.step(skip_decode=(self._pool == "prefill"))
            return outs, tracing.stamp()

    async def _pump(self) -> None:
        loop = asyncio.get_running_loop()
        returned = None
        while self.engine.has_unfinished():
            # serve.pump.fanout: from the last step's return to this
            # submit (the wake-up, the queues, the finished requests'
            # histograms, the gauges)
            tracing.record("serve.pump.fanout", returned)
            outs, returned = await loop.run_in_executor(
                None, self._step_engine, tracing.stamp())
            for out in outs:
                q = self._queues.get(out.request_id)
                if q is not None:
                    q.put_nowait(out)
                if out.finished:
                    # the reader holds its queue; drop ours and the
                    # engine's state so a long-lived replica keeps none
                    self._queues.pop(out.request_id, None)
                    state = self.engine.requests.pop(out.request_id, None)
                    if state is not None:
                        self._observe_finished(state, time.perf_counter())
            stats = self.engine.stats()
            self._drain_spec_stats()
            self._m_queue.set(stats["waiting"])
            self._m_occupancy.set(
                stats["running"] / max(1, self.engine.ecfg.max_num_seqs))
            self._m_kv_util.set(
                1.0 - stats["free_pages"] / max(1, stats["total_pages"]))
            if not outs:
                await asyncio.sleep(0.002)

    def _observe_finished(self, state, now: float) -> None:
        """Fold one finished request into the latency histograms. The
        marks are the engine's perf_counter stamps (arrival_t,
        first_token_t), so TTFT includes queueing."""
        tags = {}
        if state.model_id:
            tags["model"] = state.model_id
        tenant = self._tenants.pop(state.request_id, None)
        if tenant:
            tags["tenant"] = tenant
        tags = tags or None
        n_out = len(state.output)
        if state.first_token_t:
            self._m_ttft.observe(state.first_token_t - state.arrival_t,
                                 tags)
            if n_out > 1:
                self._m_tpot.observe(
                    (now - state.first_token_t) / (n_out - 1), tags)
        self._m_e2e.observe(now - state.arrival_t, tags)
        if state.cached_tokens:
            self._m_cache_hit.inc(state.cached_tokens, tags)
        self._m_prompt.inc(len(state.prompt), tags)
        if n_out:
            self._m_generated.inc(n_out, tags)

    def _request_id(self) -> Optional[str]:
        rid = self.hooks.current_request_id()
        if rid and (rid in self._queues or rid in self.engine.requests):
            rid = None  # a client reused an id mid-flight: don't collide
        return rid

    async def _submit(self, prompt_ids: List[int],
                      params: SamplingParams,
                      model_id: Optional[str] = None):
        rid = self.engine.add_request(prompt_ids, params,
                                      request_id=self._request_id(),
                                      model_id=model_id)
        tenant = self.hooks.current_tenant_id()
        if tenant:
            self._tenants[rid] = tenant
        q: asyncio.Queue = asyncio.Queue()
        self._queues[rid] = q
        self._ensure_pump()
        return rid, q

    @staticmethod
    def _sampling(payload: Dict[str, Any]) -> SamplingParams:
        return SamplingParams(
            temperature=float(payload.get("temperature", 1.0)),
            top_k=int(payload.get("top_k", 0)),
            top_p=float(payload.get("top_p", 1.0)),
            max_tokens=int(payload.get("max_tokens", 64)),
            stop_token_ids=tuple(payload.get("stop_token_ids", ())))

    def _parse(self, payload: Dict[str, Any]):
        if "prompt_ids" not in payload:
            raise ValueError(
                "need 'prompt_ids' (or 'prompt' with a tokenizer configured)")
        prompt_ids = [int(t) for t in payload["prompt_ids"]]
        params = self._sampling(payload)
        # OpenAI-style per-request "model": the server's base-model name
        # rides the base weights; any other name must be a loaded LoRA
        # adapter (an unknown name is a client error, not a fallback)
        model_id = payload.get("model")
        if model_id is not None:
            if not isinstance(model_id, str):
                raise ValueError("'model' must be a string")
            if model_id in (self.model_name, "base", ""):
                model_id = None
            elif self.engine.lora_pool is None \
                    or model_id not in self.engine.lora_pool:
                loaded = (sorted(self.engine.lora_pool._slots)
                          if self.engine.lora_pool is not None else [])
                raise ValueError(
                    f"unknown model {model_id!r}: not this server's "
                    f"base model ({self.model_name!r}) or a loaded "
                    f"LoRA adapter ({loaded})")
        return prompt_ids, params, model_id

    @staticmethod
    def _body(tokens: List[int], finish_reason: Optional[str]):
        return {"object": "text_completion",
                "choices": [{"token_ids": tokens,
                             "finish_reason": finish_reason}]}

    @staticmethod
    async def _collect(queue: asyncio.Queue, tokens: List[int]):
        while True:
            out = await queue.get()
            tokens.append(out.token)
            if out.finished:
                return LLMServer._body(tokens, out.finish_reason)

    # --- API methods (serve routes by method name; HTTP hits __call__) ---

    async def __call__(self, payload: Dict[str, Any]):
        """HTTP entry: chat if 'messages' present, else completions."""
        if isinstance(payload, dict) and "messages" in payload:
            return await self.chat(payload)
        return await self.completions(payload or {})

    async def completions(self, payload: Dict[str, Any]):
        """OpenAI-completions-shaped endpoint. ``stream=True`` returns an
        async generator of ``data: {json}\\n\\n`` chunks."""
        prompt_ids, params, model_id = self._parse(payload)
        if self._pool == "prefill" and self._decode_handle is not None:
            return await self._prefill_handoff(payload, prompt_ids,
                                               params, model_id)
        _rid, queue = await self._submit(prompt_ids, params, model_id)
        if payload.get("stream"):
            return self._stream_from(queue)
        return await self._collect(queue, [])

    async def _stream_from(self, queue: asyncio.Queue):
        while True:
            out = await queue.get()
            chunk = {"token": out.token, "finished": out.finished}
            if out.finished:
                chunk["finish_reason"] = out.finish_reason
            yield f"data: {json.dumps(chunk)}\n\n"
            if out.finished:
                return

    # --- disaggregated prefill/decode (fleet KV plane) ---

    async def _prefill_handoff(self, payload: Dict[str, Any],
                               prompt_ids: List[int],
                               params: SamplingParams,
                               model_id: Optional[str]):
        """Prefill-pool request path: run the prompt pass here, export
        the sequence's KV pages, ship them to a decode replica in chunked
        puts and proxy its reply back. A failed handoff retries against
        another decode replica; after 3 attempts it raises an attributed
        error, never a hang."""
        loop = asyncio.get_running_loop()
        rid, q = await self._submit(prompt_ids, params, model_id)
        first = await q.get()
        self._queues.pop(rid, None)
        if first.finished:
            # done at its first token (stop token / max_tokens=1):
            # nothing to hand off; the pump already observed the state
            if payload.get("stream"):
                chunk = {"token": first.token, "finished": True,
                         "finish_reason": first.finish_reason}

                async def _one():
                    yield f"data: {json.dumps(chunk)}\n\n"

                return _one()
            return self._body([first.token], first.finish_reason)

        t0 = time.perf_counter()

        def _export():
            with self._locked():
                return self.engine.export_kv_request(rid)

        handoff = await loop.run_in_executor(None, _export)
        # export finished the request outside step(), so the pump never
        # emits its terminal output: observe and drop the state here
        state = self.engine.requests.pop(rid, None)
        if state is not None:
            self._observe_finished(state, time.perf_counter())
        k = handoff.pop("k")
        v = handoff.pop("v")
        nbytes = k.nbytes + v.nbytes

        # ship pages in serve_kv_handoff_chunk_bytes slices so one long
        # context does not travel as one object; k and v are host
        # tensors [L, n_pages, page, kvh, hd], sliced by page
        chunk_bytes = max(1, int(global_config().serve_kv_handoff_chunk_bytes))
        n_pages = int(k.shape[1])
        per_page = max(1, (nbytes // max(1, n_pages)))
        pages_per_chunk = max(1, chunk_bytes // per_page)

        def _ship():
            return [self.hooks.put((k[:, s:s + pages_per_chunk],
                                    v[:, s:s + pages_per_chunk]))
                    for s in range(0, n_pages, pages_per_chunk)]

        refs = await loop.run_in_executor(None, _ship)
        decode_payload = {
            "handoff": handoff,
            "kv_refs": refs,
            "sampling": {"temperature": params.temperature,
                         "top_k": params.top_k, "top_p": params.top_p,
                         "max_tokens": params.max_tokens,
                         "stop_token_ids": list(params.stop_token_ids)},
            "stream": bool(payload.get("stream")),
        }
        last_err: Optional[BaseException] = None
        result = replica = None
        for _attempt in range(3):
            try:
                await self.hooks.afire("serve.kv_handoff",
                                       detail=self._dep_name or "")
                tenant = self.hooks.current_tenant_id()
                ref, replica = await loop.run_in_executor(
                    None, lambda: self._decode_handle.route(
                        decode_payload, request_id=rid,
                        tenant_id=tenant))
                result = await ref
                break
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — retried, then attributed
                last_err = e
                self._m_handoff_retries.inc()
                # a dead decode replica is the expected failure: refresh
                # the replica set so the retry lands elsewhere
                await loop.run_in_executor(
                    None, lambda: self._decode_handle._refresh(force=True))
        else:
            raise RuntimeError(
                f"KV handoff for request {rid} failed after 3 attempts "
                f"against the decode pool of deployment "
                f"{self._dep_name!r}; last error: {last_err!r}")
        self._m_handoff_bytes.inc(nbytes)
        self._m_handoff_lat.observe(time.perf_counter() - t0)
        if isinstance(result, dict) and "__stream__" in result:
            return self._proxy_stream(replica, result["__stream__"])
        return result

    async def _proxy_stream(self, replica, stream_id: int):
        """Relay a decode replica's response stream chunk by chunk (the
        pull protocol the HTTP proxy uses)."""
        finished = False
        try:
            while True:
                chunk = await replica.next_chunk.remote(stream_id)
                if isinstance(chunk, str) and chunk == _STREAM_END:
                    finished = True
                    return
                yield chunk
        finally:
            if not finished:
                try:
                    await replica.cancel_stream.remote(stream_id)
                except Exception:  # noqa: BLE001 — the decode replica may
                    # already be dead; releasing its generator is
                    # best-effort and the client's stream ended either way
                    pass

    async def decode_from_kv(self, payload: Dict[str, Any]):
        """Decode-pool entry: pull the shipped KV chunks, inject them into
        this engine (no prompt pass) and generate the remaining tokens.
        An unusable payload recomputes the prefill inside the engine."""
        loop = asyncio.get_running_loop()
        meta = dict(payload["handoff"])
        refs = list(payload.get("kv_refs") or ())
        if refs:
            parts = await loop.run_in_executor(
                None, lambda: self.hooks.get(refs, timeout=120))
            for i, name in enumerate(("k", "v")):
                chunks = [p[i] for p in parts]
                meta[name] = chunks[0] if len(chunks) == 1 else torch.cat(
                    chunks, dim=1)
        params = self._sampling(payload.get("sampling") or {})
        rid_in = self._request_id()

        def _inject():
            with self._locked():
                return self.engine.inject_request(meta, params,
                                                  request_id=rid_in)

        rid = await loop.run_in_executor(None, _inject)
        tenant = self.hooks.current_tenant_id()
        if tenant:
            self._tenants[rid] = tenant
        pre = [int(t) for t in meta.get("output") or ()]
        state = self.engine.requests.get(rid)
        if state is not None and state.finished:
            # already at its token budget after the prefill: finished
            # inside inject, so no pump output will ever come
            self.engine.requests.pop(rid, None)
            self._observe_finished(state, time.perf_counter())
            if payload.get("stream"):
                return self._stream_decode(pre, None, state.finish_reason)
            return self._body(pre, state.finish_reason)
        q: asyncio.Queue = asyncio.Queue()
        self._queues[rid] = q
        self._ensure_pump()
        if payload.get("stream"):
            return self._stream_decode(pre, q)
        return await self._collect(q, list(pre))

    async def _stream_decode(self, pre: List[int],
                             queue: Optional[asyncio.Queue],
                             finish_reason: Optional[str] = None):
        """Stream a decode-pool response: replay the prefill-side tokens
        first (the client never saw them), then live decode."""
        for i, t in enumerate(pre):
            last = queue is None and i == len(pre) - 1
            chunk: Dict[str, Any] = {"token": t, "finished": last}
            if last:
                chunk["finish_reason"] = finish_reason
            yield f"data: {json.dumps(chunk)}\n\n"
        if queue is not None:
            async for chunk_str in self._stream_from(queue):
                yield chunk_str

    async def chat(self, payload: Dict[str, Any]):
        """Chat completions need a tokenizer, which the port has not."""
        raise ValueError("chat endpoint requires a tokenizer")

    async def stats(self, _payload=None) -> Dict[str, Any]:
        out = self.engine.stats()
        out["pool"] = self._pool
        return out


def build_llm_deployment(model: str = "tiny", *, deployment=None,
                         num_replicas: int = 1, name: str = "llm",
                         pools: Optional[dict] = None, **server_kwargs):
    """An application running LLMServer replicas through the host plane's
    ``deployment`` (``ray_tpu.serve.deployment``). ``pools={"prefill": n,
    "decode": m}`` deploys disaggregated prefill/decode pools instead of
    ``num_replicas`` monolithic replicas."""
    if deployment is None:
        raise ValueError(
            "build_llm_deployment needs the host plane's serve.deployment: "
            "pass deployment=ray_tpu.serve.deployment")
    dep = deployment(LLMServer, name=name, num_replicas=num_replicas,
                     pools=pools)
    return dep.bind(model, **server_kwargs)
