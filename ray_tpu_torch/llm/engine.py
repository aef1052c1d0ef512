"""LLMEngine: continuous batching over the paged-KV model runner.

Counterpart of ``ray_tpu/llm/engine.py``: request queue -> schedule ->
{prefill | decode burst} -> sample -> stream, with a fixed number of
decode slots, whole-prompt or chunked prefill (shortest-remaining-first
with aging), prefix caching over shared pages, and recompute
preemption. All paging is host-side; the device only sees block tables.

Host/device traffic per round: the round's small inputs are uploaded,
one decode burst of K steps runs on the device, and the [K, B] tokens
come back in one copy. The device copy of the block table is refreshed
only when the table changed or the span differs. On a CUDA card a greedy
burst on the paged kernel with no LoRA replays one captured decode step
(``runner.DecodeGraph``) K times instead of launching every op of every
layer from the host.

It serves the reference's whole single-device surface: multi-LoRA
(``lora_rank``, ``model_id``, ``add_lora``/``remove_lora``; llm/lora.py),
speculative decoding (``speculation``, ``enable_speculation``,
``verify_request``; llm/spec_decode.py) and the fleet KV plane
(``export_kv_request``, ``snapshot_kv_request``, ``inject_request``). KV
payloads hold host ``torch`` tensors in the cache dtype (the reference's
hold numpy arrays); ``inject_request`` also takes numpy f32 or f16.
MoE models (``n_experts > 0``) serve on all of it with exact (drop-free)
routing (llm/runner.py).
"""

from __future__ import annotations

import collections
import itertools
import time
from dataclasses import dataclass, field, replace
from typing import Any, Deque, Dict, List, Optional

import numpy as np
import torch

from .._private.config import global_config
from .._private.device import resolve_device
from ..models.llama import LlamaConfig
from ..ops import rope_frequencies
from ..util import tracing
from .cache import PageAllocator, PrefixCache, SequenceTable, init_kv_cache
from .lora import LoRAPool, init_lora_adapter
from .runner import (DecodeGraph, decode_burst, prefill_bucket,
                     prefill_chunk, prefill_sample, sample_logits,
                     verify_step)
from .sampling import SamplingParams
from .spec_decode import SpecDecoder, accept_prefix


@dataclass
class EngineConfig:
    max_num_seqs: int = 8           # decode slots (static batch width)
    page_size: int = 16
    num_pages: int = 512            # incl. reserved dump page 0
    max_seq_len: int = 2048
    kv_dtype: Any = None            # default: model dtype
    # decode steps fused into one burst (one host round trip per burst)
    decode_burst: int = 8
    # chunked prefill: prompts run in chunks of this many tokens, decode
    # bursts interleaving between chunks; 0 = whole-prompt prefill
    prefill_chunk: int = 0
    # finished RequestStates kept for inspection before FIFO eviction
    finished_retention: int = 1024
    # multi-LoRA (llm/lora.py): rank > 0 builds a static adapter pool of
    # max_loras slots; requests carry model_id. Incompatible with prefix
    # caching (cached pages would mix adapters) and chunked prefill.
    lora_rank: int = 0
    max_loras: int = 8
    # speculative decoding (llm/spec_decode.py): {"draft_config": ...,
    # "num_draft_tokens": k} or a SpecConfig; greedy requests get k draft
    # tokens verified a round. None = off. Incompatible with lora_rank.
    speculation: Any = None
    # automatic prefix caching over shared, refcounted pages; forces
    # chunked prefill
    enable_prefix_caching: bool = False


@dataclass
class RequestState:
    request_id: str
    prompt: List[int]
    params: SamplingParams
    output: List[int] = field(default_factory=list)
    slot: int = -1
    ctx_len: int = 0          # 0 until prefill completes
    prefill_pos: int = 0      # chunked prefill progress (tokens written)
    prompt_page_keys: Any = None
    cached_tokens: int = 0
    model_id: Optional[str] = None
    finished: bool = False
    finish_reason: Optional[str] = None
    arrival_t: float = 0.0
    first_token_t: float = 0.0


@dataclass
class StepOutput:
    request_id: str
    token: int
    finished: bool
    finish_reason: Optional[str] = None
    text_offset: int = 0


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


class LLMEngine:
    def __init__(self, params, cfg: LlamaConfig,
                 engine_config: Optional[EngineConfig] = None,
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if _first_leaf(params).device != self.device:
            raise ValueError(
                f"params live on {_first_leaf(params).device}, the engine "
                f"on {self.device}")
        self._paged_kernel = bool(global_config().llm_paged_kernel)
        self._paged_min_pages = int(
            global_config().llm_paged_kernel_min_ctx_pages)
        self.ecfg = engine_config or EngineConfig()
        if self.ecfg.max_seq_len > cfg.max_seq:
            raise ValueError("engine max_seq_len exceeds model max_seq")
        usable = self.ecfg.num_pages - 1
        need = -(-self.ecfg.max_seq_len // self.ecfg.page_size)
        if need > usable:
            # a lone running sequence must always be able to grow to
            # max_seq_len, which keeps preemption deadlock-free
            raise ValueError(
                f"num_pages={self.ecfg.num_pages} cannot hold one "
                f"max_seq_len={self.ecfg.max_seq_len} sequence "
                f"({need} pages needed, {usable} usable)")
        self.params = params
        self.cache = init_kv_cache(cfg, self.ecfg.num_pages,
                                   self.ecfg.page_size, self.ecfg.kv_dtype,
                                   device=self.device)
        self.allocator = PageAllocator(self.ecfg.num_pages,
                                       self.ecfg.page_size)
        self.lora_pool: Optional[LoRAPool] = None
        if self.ecfg.lora_rank > 0:
            if self.ecfg.enable_prefix_caching:
                raise ValueError(
                    "lora_rank and enable_prefix_caching are mutually "
                    "exclusive (cached pages would mix adapters)")
            if self.ecfg.prefill_chunk > 0:
                raise ValueError(
                    "lora_rank requires whole-prompt prefill "
                    "(prefill_chunk=0) for now")
            self.lora_pool = LoRAPool(cfg, self.ecfg.lora_rank,
                                      self.ecfg.max_loras, dtype=cfg.dtype,
                                      device=self.device)
        self.prefix_cache: Optional[PrefixCache] = None
        if self.ecfg.enable_prefix_caching:
            self.prefix_cache = PrefixCache(self.allocator)
            if self.ecfg.prefill_chunk <= 0:
                # cached-prefix requests resume mid-prompt, which is the
                # chunked runner's contract; copy, never mutate the caller's
                self.ecfg = replace(
                    self.ecfg, prefill_chunk=min(512, self.ecfg.max_seq_len))
        max_pages = self.allocator.pages_needed(self.ecfg.max_seq_len)
        self.seq_table = SequenceTable(self.ecfg.max_num_seqs, max_pages)
        self.cos, self.sin = rope_frequencies(cfg.head_dim, cfg.max_seq,
                                              cfg.rope_theta,
                                              device=self.device)
        self.spec: Optional[SpecDecoder] = None
        # fleet verify hook: (payload, draft) -> Optional[List[int]], a
        # KV snapshot shipped to a verifier racing the local verify;
        # None or an exception means local only
        self._spec_remote_verify = None
        if self.ecfg.speculation:
            self.enable_speculation(self.ecfg.speculation)
        self.waiting: Deque[RequestState] = collections.deque()
        self._prefill_queue: Deque[RequestState] = collections.deque()
        self._prefill_skips: Dict[str, int] = {}
        self.slots: List[Optional[RequestState]] = (
            [None] * self.ecfg.max_num_seqs)
        self.requests: Dict[str, RequestState] = {}
        self._finished_order: Deque[str] = collections.deque()
        self._seed = 0
        self._id = itertools.count()
        self._bt_device = None
        self._bt_version = None
        self._graph: Optional[DecodeGraph] = None
        self._counts = {"prefills": 0, "prefill_chunks": 0,
                        "decode_bursts": 0, "decode_steps": 0,
                        "paged_decode_steps": 0, "decode_graph_steps": 0,
                        "preemptions": 0,
                        "verify_steps": 0, "draft_prefills": 0,
                        "injected": 0}

    # --- public API ---

    def add_request(self, prompt_tokens: List[int],
                    params: Optional[SamplingParams] = None,
                    request_id: Optional[str] = None,
                    model_id: Optional[str] = None) -> str:
        if not prompt_tokens:
            raise ValueError("empty prompt")
        self._check_model_id(model_id)
        if len(prompt_tokens) >= self.ecfg.max_seq_len:
            raise ValueError(
                f"prompt length {len(prompt_tokens)} >= max_seq_len "
                f"{self.ecfg.max_seq_len}")
        rid = request_id or f"req-{next(self._id)}"
        state = RequestState(rid, list(prompt_tokens),
                             params or SamplingParams(),
                             arrival_t=time.perf_counter(),
                             model_id=model_id)
        self.waiting.append(state)
        self.requests[rid] = state
        return rid

    def _check_model_id(self, model_id: Optional[str]) -> None:
        if model_id is None:
            return
        if self.lora_pool is None:
            raise ValueError("model_id requires EngineConfig.lora_rank > 0")
        self.lora_pool.slot_of(model_id)   # validate at submission

    def enable_speculation(self, spec, draft_params=None) -> None:
        """Attach a drafter (spec_decode.SpecDecoder). ``spec`` is the
        ``speculation`` dict or SpecConfig; ``draft_params`` (on the
        engine's device) override the drafter's random init."""
        if self.lora_pool is not None:
            raise ValueError("speculation is incompatible with "
                             "lora_rank > 0 (drafter has no adapters)")
        self.spec = SpecDecoder(self.cfg, self.ecfg, spec,
                                draft_params=draft_params,
                                device=self.device)

    def disable_speculation(self) -> None:
        self.spec = None

    def abort_request(self, request_id: str) -> None:
        state = self.requests.get(request_id)
        if state is None or state.finished:
            return
        self._finish(state, "aborted")

    def has_unfinished(self) -> bool:
        return bool(self.waiting) or any(s is not None for s in self.slots)

    @torch.inference_mode()
    def step(self, skip_decode: bool = False) -> List[StepOutput]:
        """One scheduling round: admit waiting requests into free slots,
        advance ONE prefill work unit (a whole prompt, or one chunk),
        then one decode burst for every decoding slot. ``skip_decode``
        runs only the admission/prefill phase."""
        with tracing.span("engine.step"):
            outputs: List[StepOutput] = []
            with tracing.span("engine.admit"):
                pref = self._admit_and_pick()
            if pref is not None:
                outputs.extend(self._run_prefill(pref))
                if pref.ctx_len > 0 or pref.slot < 0 or pref.finished:
                    try:
                        self._prefill_queue.remove(pref)
                    except ValueError:
                        pass
            if not skip_decode and any(
                    s is not None and s.ctx_len > 0 for s in self.slots):
                outputs.extend(self._run_decode())
            return outputs

    def _admit_and_pick(self) -> Optional[RequestState]:
        """Admit waiting requests into free slots, up to the cap of
        admitted-but-unprefilled ones, and pick this round's prefill
        unit."""
        if any(s.slot < 0 or s.finished for s in self._prefill_queue):
            self._prefill_queue = collections.deque(
                s for s in self._prefill_queue
                if s.slot >= 0 and not s.finished)
        # admission reserves the whole sequence's pages, so the queue of
        # admitted-but-unprefilled requests is capped
        cap = 1 if self.ecfg.prefill_chunk <= 0 else 2
        while len(self._prefill_queue) < cap:
            admitted = self._admit()
            if admitted is None:
                break
            self._prefill_queue.append(admitted)
        return self._next_prefill()

    # consecutive work units a queued prefill may be passed over before
    # it runs regardless of length (anti-starvation aging for SRF)
    _PREFILL_MAX_SKIPS = 8

    def _next_prefill(self) -> Optional[RequestState]:
        """This round's prefill unit: FIFO for whole prompts; in chunked
        mode the fewest remaining prefill tokens first, with aging."""
        while self._prefill_queue and (
                self._prefill_queue[0].slot < 0
                or self._prefill_queue[0].finished):
            self._prefill_queue.popleft()
        live = [s for s in self._prefill_queue
                if s.slot >= 0 and not s.finished]
        live_ids = {s.request_id for s in live}
        for rid in [r for r in self._prefill_skips if r not in live_ids]:
            del self._prefill_skips[rid]
        if not live:
            return None
        if self.ecfg.prefill_chunk <= 0:
            return live[0]
        oldest = min(live, key=lambda s: s.arrival_t)
        if self._prefill_skips.get(oldest.request_id, 0) \
                >= self._PREFILL_MAX_SKIPS:
            pick = oldest
        else:
            pick = min(live, key=lambda s: (
                len(s.prompt) + len(s.output) - s.prefill_pos,
                s.arrival_t))
        for s in live:
            if s is pick:
                self._prefill_skips.pop(s.request_id, None)
            else:
                self._prefill_skips[s.request_id] = (
                    self._prefill_skips.get(s.request_id, 0) + 1)
        return pick

    @torch.inference_mode()
    def generate(self, prompts: List[List[int]],
                 params: Optional[SamplingParams] = None) -> List[List[int]]:
        """Run all prompts to completion; outputs are collected from
        step() results."""
        ids = [self.add_request(p, params) for p in prompts]
        collected: Dict[str, List[int]] = {rid: [] for rid in ids}
        while self.has_unfinished():
            for out in self.step():
                if out.request_id in collected:
                    collected[out.request_id].append(out.token)
        return [collected[rid] for rid in ids]

    # --- scheduling internals ---

    def _free_slot(self) -> int:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return -1

    def _admit(self) -> Optional[RequestState]:
        if not self.waiting:
            return None
        slot = self._free_slot()
        if slot < 0:
            return None
        state = self.waiting[0]
        # pages for the sequence so far + the next generated token
        seq_len = len(state.prompt) + len(state.output)
        cached_pages: List[int] = []
        if self.prefix_cache is not None:
            if state.prompt_page_keys is None:
                state.prompt_page_keys = PrefixCache.page_keys(
                    state.prompt, self.ecfg.page_size)
            hits = self.prefix_cache.lookup(state.prompt_page_keys)
            # at least one prompt token must run through prefill
            cap = (len(state.prompt) - 1) // self.ecfg.page_size
            while len(hits) > cap:
                self.allocator.free([hits.pop()])
            cached_pages = hits
        fresh_tokens = seq_len + 1 - len(cached_pages) * self.ecfg.page_size
        if not self.allocator.can_allocate(fresh_tokens):
            if self.prefix_cache is not None:
                need = self.allocator.pages_needed(fresh_tokens)
                if (self.allocator.free_pages
                        + self.prefix_cache.evictable()) >= need:
                    self.prefix_cache.evict_for(fresh_tokens)
            if not self.allocator.can_allocate(fresh_tokens):
                if cached_pages:
                    self.allocator.free(cached_pages)
                return None
        self.waiting.popleft()
        pages = cached_pages + self.allocator.allocate(
            self.allocator.pages_needed(fresh_tokens))
        state.slot = slot
        state.cached_tokens = len(cached_pages) * self.ecfg.page_size
        state.prefill_pos = state.cached_tokens
        self.slots[slot] = state
        self.seq_table.assign(slot, pages)
        return state

    # block-table span bucket width, in pages
    _SPAN_PAGES = 4

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

    def _bt(self, span: Optional[int] = None) -> torch.Tensor:
        """Device copy of the block table (narrowed to ``span`` pages),
        refreshed when the host table's version or the span changes: a
        stale copy after a preemption would read freed pages."""
        key = (self.seq_table.version, span)
        if self._bt_version != key:
            table = self.seq_table.block_tables
            if span is not None:
                table = table[:, :span]
            self._bt_device = self._to_device(table)
            self._bt_version = key
        return self._bt_device

    def _span_bucket(self, pages: int) -> int:
        b = self._SPAN_PAGES
        while b < pages:
            b *= 2
        return min(b, self.seq_table.block_tables.shape[1])

    def _active_span(self) -> int:
        """Pages covering the longest DECODING sequence, bucketed."""
        longest = max((int(self.seq_table.n_pages[s.slot])
                       for s in self.slots
                       if s is not None and s.ctx_len > 0), default=1)
        return self._span_bucket(longest)

    def _sampling_arrays(self, row_states, advance: int = 1):
        n = len(row_states)
        temp = np.ones(n, np.float32)
        top_k = np.zeros(n, np.int32)
        top_p = np.ones(n, np.float32)
        greedy = True
        for i, s in enumerate(row_states):
            if s is None:
                continue
            temp[i] = s.params.temperature
            top_k[i] = s.params.top_k
            top_p[i] = s.params.top_p
            if s.params.temperature > 0.0:
                greedy = False
        seed = self._seed
        self._seed += advance  # burst step i uses seed + i: no reuse
        return (seed, self._to_device(temp), self._to_device(top_k),
                self._to_device(top_p), greedy)

    def _run_prefill(self, state: RequestState) -> List[StepOutput]:
        """Prefill the sequence so far (prompt, plus earlier output after
        a preemption) and sample the next token; chunked mode advances one
        chunk and samples after the last."""
        seq = state.prompt + state.output
        L = len(seq)
        C = self.ecfg.prefill_chunk
        if C > 0:
            n = min(C, L - state.prefill_pos)
            with tracing.span("engine.prefill", tokens=n, padded=C):
                return self._run_prefill_chunk(state, seq, L, C)
        bucket = prefill_bucket(L, self.ecfg.max_seq_len)
        with tracing.span("engine.prefill", tokens=L, padded=bucket):
            with tracing.span("engine.prefill.prep"):
                tokens = np.zeros((1, bucket), np.int32)
                tokens[0, :L] = seq
                seed, temp, top_k, top_p, greedy = self._sampling_arrays(
                    [state])
                lora = None
                if self.lora_pool is not None:
                    lora = self.lora_pool.select(
                        [self.lora_pool.slot_of(state.model_id)])
                tokens = self._to_device(tokens)
                lens = self._to_device(np.asarray([L], np.int32))
                bt = self._to_device(
                    self.seq_table.block_tables[state.slot:state.slot + 1])
            with tracing.span("runner.prefill"):
                toks, _, _ = prefill_sample(
                    self.params, self.cache.k, self.cache.v, tokens, lens,
                    bt, self.cos, self.sin, seed, temp, top_k, top_p, lora,
                    cfg=self.cfg, greedy=greedy)
            self._counts["prefills"] += 1
            state.ctx_len = L
            with tracing.span("engine.prefill.sync"):
                tok = int(toks[0])
            if not state.output:
                state.first_token_t = time.perf_counter()
            return [self._append_token(state, tok)]

    def _run_prefill_chunk(self, state: RequestState, seq: List[int],
                           L: int, C: int) -> List[StepOutput]:
        start = state.prefill_pos
        n = min(C, L - start)
        with tracing.span("engine.prefill.prep"):
            tokens = np.zeros((1, C), np.int32)
            tokens[0, :n] = seq[start:start + n]
            pages = self._span_bucket(-(-(start + n) // self.ecfg.page_size))
            bt = self._to_device(
                self.seq_table.block_tables[state.slot:state.slot + 1,
                                            :pages])
            tokens = self._to_device(tokens)
        with tracing.span("runner.prefill"):
            logits, _, _ = prefill_chunk(
                self.params, self.cache.k, self.cache.v, tokens,
                start, n, bt, self.cos, self.sin, cfg=self.cfg)
        self._counts["prefill_chunks"] += 1
        state.prefill_pos = start + n
        if state.prefill_pos < L:
            return []  # more chunks to go; decode interleaves meanwhile
        if self.prefix_cache is not None and state.prompt_page_keys:
            table = self.seq_table.block_tables[state.slot]
            self.prefix_cache.insert(
                state.prompt_page_keys,
                [int(p) for p in table[:len(state.prompt_page_keys)]])
        seed, temp, top_k, top_p, _greedy = self._sampling_arrays([state])
        with tracing.span("engine.prefill.sync"):
            tok = int(sample_logits(logits, seed, temp, top_k, top_p)[0])
        state.ctx_len = L
        if not state.output:
            state.first_token_t = time.perf_counter()
        return [self._append_token(state, tok)]

    def _preempt(self, state: RequestState) -> None:
        """Recompute preemption: release the sequence's pages and put it
        back at the head of the waiting queue; its tokens so far
        re-prefill on readmission."""
        self._counts["preemptions"] += 1
        if self.spec is not None:
            self.spec.drop(state.slot)   # drafter KV dies with the pages
        self.allocator.free(self.seq_table.pages_of(state.slot))
        self.seq_table.clear(state.slot)
        self.slots[state.slot] = None
        state.slot = -1
        state.ctx_len = 0
        state.prefill_pos = 0
        state.cached_tokens = 0
        try:
            self._prefill_queue.remove(state)
        except ValueError:
            pass
        self.waiting.appendleft(state)

    def _pick_victim(self, exclude: RequestState) -> Optional[RequestState]:
        candidates = [s for s in self.slots
                      if s is not None and s is not exclude]
        if not candidates:
            return None
        return max(candidates, key=lambda s: s.arrival_t)  # youngest

    def _burst_width(self) -> int:
        """Fused steps this round, capped by every decoding slot's
        headroom to max_seq_len and its remaining token budget."""
        K = self.ecfg.decode_burst
        for s in self.slots:
            if s is None or s.ctx_len == 0:
                continue
            K = min(K, self.ecfg.max_seq_len - 1 - s.ctx_len + 1,
                    s.params.max_tokens - len(s.output))
        return max(1, K)

    def _provision_pages(self, s: RequestState, upto: int) -> None:
        """Ensure the slot's pages cover positions [0, upto); preempt the
        youngest others when the pool runs dry."""
        while int(self.seq_table.n_pages[s.slot]) * self.ecfg.page_size \
                < upto:
            if self.allocator.free_pages < 1 and self.prefix_cache:
                self.prefix_cache.evict(1)
            if self.allocator.free_pages >= 1:
                self.seq_table.append_page(
                    s.slot, self.allocator.allocate(1)[0])
                continue
            victim = self._pick_victim(exclude=s)
            if victim is None:
                raise MemoryError(
                    "single sequence exhausted the KV cache — "
                    "num_pages/max_seq_len misconfigured")
            self._preempt(victim)

    def _run_decode(self) -> List[StepOutput]:
        if self.spec is not None:
            outs = self._run_spec_decode()
            if outs is not None:
                return outs
        K = self._burst_width()
        with tracing.span("engine.decode", steps=K):
            return self._decode_burst(K)

    def _decode_burst(self, K: int) -> List[StepOutput]:
        B = self.ecfg.max_num_seqs
        with tracing.span("engine.decode.prep"):
            for s in [s for s in self.slots
                      if s is not None and s.ctx_len > 0]:
                if s.slot < 0:
                    continue  # preempted as a victim earlier this round
                self._provision_pages(s, s.ctx_len + K)
            active_states = [s for s in self.slots
                             if s is not None and s.ctx_len > 0]
            if not active_states:
                return []
            tokens = np.zeros(B, np.int32)
            positions = np.zeros(B, np.int32)
            active = np.zeros(B, bool)
            for s in active_states:
                tokens[s.slot] = s.output[-1] if s.output else s.prompt[-1]
                positions[s.slot] = s.ctx_len
                active[s.slot] = True
            seed, temp, top_k, top_p, greedy = self._sampling_arrays(
                self.slots, advance=K)
            lora = None
            if self.lora_pool is not None:
                ids = [0] * B
                for s in active_states:
                    ids[s.slot] = self.lora_pool.slot_of(s.model_id)
                lora = self.lora_pool.select(ids)
            pages = self._active_span()
            use_paged = self._paged_kernel or (
                self._paged_min_pages > 0 and pages >= self._paged_min_pages)
            graphed = self._graph_eligible(greedy, use_paged)
            tokens = self._to_device(tokens)
            positions = self._to_device(positions)
            # the paged kernel reads the table at full width (its columns
            # past a row's pages point at dump page 0), so that a burst
            # gives the same numbers with the graph and without it
            bt = self._bt(None if use_paged else pages)
            active = self._to_device(active)
        tracing.annotate(graphed=int(graphed))
        with tracing.span("runner.decode_burst"):
            if graphed:
                if self._graph is None:
                    self._graph = DecodeGraph(
                        self.cfg, B, self.ecfg.decode_burst, bt.shape[1],
                        self.cache.k.dtype, self.device)
                toks = self._graph.run(
                    self.params, self.cache.k, self.cache.v, tokens,
                    positions, bt, active, self.cos, self.sin, K)
            else:
                toks, _, _ = decode_burst(
                    self.params, self.cache.k, self.cache.v, tokens,
                    positions, bt, active, self.cos, self.sin, seed, temp,
                    top_k, top_p, lora, cfg=self.cfg, n_steps=K,
                    paged_kernel=use_paged, greedy=greedy)
        self._counts["decode_bursts"] += 1
        self._counts["decode_steps"] += K
        if use_paged:
            self._counts["paged_decode_steps"] += K
        if graphed:
            self._counts["decode_graph_steps"] += K
        with tracing.span("engine.decode.sync"):
            sampled = toks.cpu().numpy()  # [K, B]: the burst's one host sync
        with tracing.span("engine.decode.emit"):
            outs = []
            for s in active_states:
                for k in range(K):
                    s.ctx_len += 1
                    outs.append(self._append_token(s, int(sampled[k, s.slot])))
                    if s.finished:
                        break
        return outs

    def _graph_eligible(self, greedy: bool, use_paged: bool) -> bool:
        """Whether a burst replays the captured decode step
        (``runner.DecodeGraph``), read from the round itself: on a CUDA
        card, every row greedy (the sampler seeds a host generator each
        step, which a graph cannot replay), no LoRA pool, and the paged
        kernel. Every other burst runs ``decode_burst`` eagerly."""
        return (self.device.type == "cuda" and greedy
                and self.lora_pool is None and use_paged)

    # --- speculative decoding (spec_decode.py) ---

    def _spec_eligible(self, s: RequestState) -> bool:
        """Greedy-only speculation: accept-prefix reproduces the greedy
        oracle exactly. Sampled and LoRA requests ride the same verify
        window at position 0 only, undrafted."""
        return s.params.temperature == 0.0 and s.model_id is None

    def _run_spec_decode(self) -> Optional[List[StepOutput]]:
        """One draft+verify round over the slot batch: the drafter
        proposes k tokens per eligible slot, verify_step scores every
        slot's window in one forward (undrafted slots are a 1-token
        window and advance one token) and accept-prefix emits 1..k+1
        tokens per drafted slot. None when no slot can draft this round
        (the caller runs the plain decode burst)."""
        spec = self.spec
        kd = spec.k

        def can_draft(s: RequestState) -> bool:
            # the window [p .. p+k] must fit under max_seq_len, and a
            # request one token from its budget gains nothing
            return (self._spec_eligible(s)
                    and s.ctx_len + kd <= self.ecfg.max_seq_len - 1
                    and s.params.max_tokens - len(s.output) >= 2)

        if not any(s is not None and s.ctx_len > 0 and can_draft(s)
                   for s in self.slots):
            return None
        # provision first: it may preempt victims, so the drafted and
        # active sets are derived afterwards
        for s in [s for s in self.slots
                  if s is not None and s.ctx_len > 0]:
            if s.slot < 0:
                continue  # preempted as a victim earlier this round
            self._provision_pages(
                s, s.ctx_len + (kd + 1 if can_draft(s) else 1))
        active_states = [s for s in self.slots
                         if s is not None and s.ctx_len > 0]
        if not active_states:
            return []
        drafted_states = [s for s in active_states if can_draft(s)]
        if not drafted_states:
            return None
        # lazy drafter warm-up: a slot's first drafted round (or the
        # first after a drop) prefills the drafter's KV for its sequence
        for s in drafted_states:
            if s.slot not in spec.ready:
                seq = s.prompt + s.output
                spec.prefill(seq[:s.ctx_len], self.seq_table.block_tables[
                    s.slot:s.slot + 1])
                spec.ready.add(s.slot)
                self._counts["draft_prefills"] += 1
        span = self._active_span()
        bt = self._bt(span)
        items = []
        for s in drafted_states:
            seq = s.prompt + s.output
            p = s.ctx_len
            items.append((s.slot, seq[p - 1], seq[p], p))
        drafts = spec.draft(items, bt)
        # fleet mode: a verifier fed a KV snapshot computes the same
        # emission, so its result corroborates, never decides
        remote: Dict[int, List[int]] = {}
        if self._spec_remote_verify is not None:
            for s in drafted_states:
                try:
                    payload = self.snapshot_kv_request(s.request_id)
                    res = self._spec_remote_verify(payload, drafts[s.slot])
                except Exception:  # noqa: BLE001 — the verifier is optional
                    res = None
                if res is not None:
                    remote[s.slot] = [int(t) for t in res]
        B = self.ecfg.max_num_seqs
        S = kd + 1
        tok = np.zeros((B, S), np.int32)
        pos = np.full((B, S), -1, np.int32)
        for s in active_states:
            tok[s.slot, 0] = s.output[-1] if s.output else s.prompt[-1]
            pos[s.slot, 0] = s.ctx_len
            d = drafts.get(s.slot)
            if d:
                tok[s.slot, 1:1 + len(d)] = d
                pos[s.slot, 1:1 + len(d)] = (
                    s.ctx_len + 1 + np.arange(len(d)))
        seed, temp, top_k, top_p, greedy = self._sampling_arrays(
            self.slots, advance=1)
        t0 = time.perf_counter()
        tgt, samp0, _, _ = verify_step(
            self.params, self.cache.k, self.cache.v, self._to_device(tok),
            self._to_device(pos), bt, self.cos, self.sin, seed, temp,
            top_k, top_p, cfg=self.cfg, greedy=greedy)
        both = torch.cat([tgt, samp0[:, None]], dim=1).cpu().numpy()
        spec.verify_times.append(time.perf_counter() - t0)
        self._counts["verify_steps"] += 1
        tgt, samp0 = both[:, :S], both[:, S]
        outs: List[StepOutput] = []
        for s in active_states:
            if s.slot < 0 or s.finished:
                continue
            d = drafts.get(s.slot)
            if d:
                emitted = accept_prefix(d, tgt[s.slot].tolist())
                spec.on_round(len(d), len(emitted) - 1)
                r = remote.get(s.slot)
                if r is not None:
                    spec.remote_rounds_total += 1
                    if r == emitted:
                        spec.remote_agree_total += 1
            else:
                emitted = [int(samp0[s.slot])]
            for t in emitted:
                s.ctx_len += 1
                outs.append(self._append_token(s, t))
                if s.finished:
                    break
        return outs

    def verify_request(self, request_id: str,
                       draft: List[int]) -> List[int]:
        """One verification round for a single request against a draft
        supplied from outside (the fleet verifier: the draft came from
        another engine's drafter, the KV through inject_request). Applies
        and returns the emission, identical to the monolithic round; an
        empty draft is one plain greedy step. Greedy only; other slots
        are untouched."""
        state = self.requests.get(request_id)
        if state is None:
            raise ValueError(f"unknown request {request_id!r}")
        if state.finished or state.slot < 0 or state.ctx_len <= 0:
            raise ValueError(
                f"request {request_id!r} is not verifiable "
                f"(finished={state.finished}, ctx_len={state.ctx_len})")
        if state.params.temperature != 0.0:
            raise ValueError("speculative verification is greedy-only")
        if state.model_id is not None:
            raise ValueError("speculative verification does not "
                             "support LoRA requests")
        draft = [int(t) for t in draft]
        # clamp the window to the sequence budget, as the monolithic
        # round's eligibility rule does near max_seq_len
        while draft and (state.ctx_len + len(draft)
                         > self.ecfg.max_seq_len - 1):
            draft.pop()
        kd = len(draft)
        self._provision_pages(state, state.ctx_len + kd + 1)
        B = self.ecfg.max_num_seqs
        tok = np.zeros((B, kd + 1), np.int32)
        pos = np.full((B, kd + 1), -1, np.int32)
        seq = state.prompt + state.output
        tok[state.slot, 0] = seq[-1]
        pos[state.slot, 0] = state.ctx_len
        if kd:
            tok[state.slot, 1:] = draft
            pos[state.slot, 1:] = state.ctx_len + 1 + np.arange(kd)
        seed, temp, top_k, top_p, _g = self._sampling_arrays(
            self.slots, advance=1)
        span = self._span_bucket(int(self.seq_table.n_pages[state.slot]))
        t0 = time.perf_counter()
        tgt, _s0, _, _ = verify_step(
            self.params, self.cache.k, self.cache.v, self._to_device(tok),
            self._to_device(pos), self._bt(span), self.cos, self.sin,
            seed, temp, top_k, top_p, cfg=self.cfg, greedy=True)
        row = tgt[state.slot].tolist()
        self._counts["verify_steps"] += 1
        if self.spec is not None:
            self.spec.verify_times.append(time.perf_counter() - t0)
        emitted = accept_prefix(draft, row)
        if self.spec is not None and kd:
            self.spec.on_round(kd, len(emitted) - 1)
        for t in emitted:
            state.ctx_len += 1
            self._append_token(state, t)
            if state.finished:
                break
        return emitted

    def _append_token(self, state: RequestState, token: int) -> StepOutput:
        state.output.append(token)
        reason = None
        if token in state.params.stop_token_ids:
            reason = "stop"
        elif len(state.output) >= state.params.max_tokens:
            reason = "length"
        elif state.ctx_len + 1 >= self.ecfg.max_seq_len:
            reason = "length"
        if reason:
            self._finish(state, reason)
        return StepOutput(state.request_id, token, state.finished,
                          state.finish_reason,
                          text_offset=len(state.output) - 1)

    def _finish(self, state: RequestState, reason: str) -> None:
        state.finished = True
        state.finish_reason = reason
        if state.slot >= 0:
            if self.spec is not None:
                self.spec.drop(state.slot)
            self.allocator.free(self.seq_table.pages_of(state.slot))
            self.seq_table.clear(state.slot)
            self.slots[state.slot] = None
            state.slot = -1
        elif state in self.waiting:
            self.waiting.remove(state)
        self._finished_order.append(state.request_id)
        while len(self._finished_order) > self.ecfg.finished_retention:
            old = self._finished_order.popleft()
            stale = self.requests.get(old)
            if stale is not None and stale.finished:
                del self.requests[old]

    # --- fleet KV plane: prefill -> decode handoff ---

    def export_kv_request(self, request_id: str) -> Dict[str, Any]:
        """Export a prefilled request's KV pages for decode on another
        engine (disaggregated prefill/decode). Valid once the request has
        prefilled (ctx_len > 0). Copies its pages to host memory,
        finishes it here (reason "handoff", freeing its slot and pages)
        and returns a payload :meth:`inject_request` accepts."""
        payload = self.snapshot_kv_request(request_id)
        self._finish(self.requests[request_id], "handoff")
        return payload

    def snapshot_kv_request(self, request_id: str) -> Dict[str, Any]:
        """:meth:`export_kv_request` without the handoff: the request
        keeps running here. ``k`` and ``v`` are host tensors in the cache
        dtype, [L, n_pages, page, kvh, hd]."""
        state = self.requests.get(request_id)
        if state is None:
            raise ValueError(f"unknown request {request_id!r}")
        if state.finished or state.slot < 0 or state.ctx_len <= 0:
            raise ValueError(
                f"request {request_id!r} is not exportable "
                f"(finished={state.finished}, ctx_len={state.ctx_len})")
        n_kv = self.allocator.pages_needed(state.ctx_len)
        idx = self._to_device(np.asarray(
            self.seq_table.pages_of(state.slot)[:n_kv], np.int64))
        return {
            "prompt": list(state.prompt),
            "output": list(state.output),
            "ctx_len": state.ctx_len,
            "page_size": self.ecfg.page_size,
            "model_id": state.model_id,
            "k": self.cache.k[:, idx].cpu(),
            "v": self.cache.v[:, idx].cpu(),
        }

    def _payload_pages(self, a) -> Optional[torch.Tensor]:
        """A payload's page array as a tensor this engine can land: a
        floating tensor on the CPU or on the engine's device, or a numpy
        array of f32 or f16. Anything else (another device, another
        dtype, not an array) is None."""
        if isinstance(a, torch.Tensor):
            ok = a.is_floating_point() and a.device in (
                torch.device("cpu"), self.device)
            return a if ok else None
        if isinstance(a, np.ndarray) and a.dtype in (np.float32,
                                                     np.float16):
            return torch.tensor(a)   # a copy: the array may be read-only
        return None

    def inject_request(self, payload: Dict[str, Any],
                       params: Optional[SamplingParams] = None,
                       request_id: Optional[str] = None) -> str:
        """Admit a request whose prompt pass ran on another engine. The
        shipped pages land in free cache pages and the request joins
        decode with no prefill here. When they cannot land (no free slot,
        page-size mismatch, pool pressure, malformed or missing arrays,
        another dtype or device) the request joins the waiting queue and
        recomputes its prefill: slower, never wrong."""
        prompt = [int(t) for t in payload["prompt"]]
        output = [int(t) for t in payload.get("output") or ()]
        ctx_len = int(payload["ctx_len"])
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) >= self.ecfg.max_seq_len:
            raise ValueError(
                f"prompt length {len(prompt)} >= max_seq_len "
                f"{self.ecfg.max_seq_len}")
        model_id = payload.get("model_id")
        self._check_model_id(model_id)
        rid = request_id or f"req-{next(self._id)}"
        if rid in self.requests:
            rid = f"req-{next(self._id)}"
        state = RequestState(rid, prompt, params or SamplingParams(),
                             output=output,
                             arrival_t=time.perf_counter(),
                             model_id=model_id)
        self.requests[rid] = state
        if output and len(output) >= state.params.max_tokens:
            # already at its token budget: nothing left to decode
            self._finish(state, "length")
            return rid
        k = self._payload_pages(payload.get("k"))
        v = self._payload_pages(payload.get("v"))
        usable = (
            k is not None and v is not None and bool(output)
            and int(payload.get("page_size", -1)) == self.ecfg.page_size
            and len(prompt) <= ctx_len < self.ecfg.max_seq_len
            and k.dim() == 5
            and tuple(k.shape) == (self.cfg.n_layers, k.shape[1],
                                   self.ecfg.page_size,
                                   self.cfg.n_kv_heads,
                                   self.cfg.head_dim)
            and tuple(v.shape) == tuple(k.shape)
            and k.shape[1] >= self.allocator.pages_needed(ctx_len))
        if not usable or not self._inject_pages(state, k, v, ctx_len):
            self.waiting.append(state)  # recompute fallback
        return rid

    def _inject_pages(self, state: RequestState, k, v,
                      ctx_len: int) -> bool:
        slot = self._free_slot()
        if slot < 0:
            return False
        n_kv = self.allocator.pages_needed(ctx_len)
        # headroom for the next decoded token too (as _admit's +1)
        need = self.allocator.pages_needed(ctx_len + 1)
        if not self.allocator.can_allocate(need) and self.prefix_cache:
            self.prefix_cache.evict_for(ctx_len + 1)
        if not self.allocator.can_allocate(need):
            return False
        pages = self.allocator.allocate(need)
        idx = self._to_device(np.asarray(pages[:n_kv], np.int64))
        for cache, src in ((self.cache.k, k), (self.cache.v, v)):
            cache.index_copy_(1, idx, src[:, :n_kv].to(
                device=self.device, dtype=cache.dtype))
        self._counts["injected"] += 1
        state.slot = slot
        state.ctx_len = ctx_len
        state.prefill_pos = ctx_len
        if not state.first_token_t:
            state.first_token_t = time.perf_counter()
        self.slots[slot] = state
        self.seq_table.assign(slot, pages)
        if self.prefix_cache is not None:
            # shipped pages warm the prefix cache too: register the
            # prompt's full pages, as the chunked prefill does
            keys = PrefixCache.page_keys(state.prompt, self.ecfg.page_size)
            n_reg = min(len(keys), n_kv)
            if n_reg > 0:
                self.prefix_cache.insert(keys[:n_reg], pages[:n_reg])
                state.prompt_page_keys = keys
        return True

    # --- LoRA management ---

    def add_lora(self, name: str, adapter=None, *, seed: int = 0) -> None:
        """Load an adapter into the pool (``adapter`` defaults to a fresh
        zero-delta init at the engine's rank, from ``seed``)."""
        if self.lora_pool is None:
            raise ValueError("engine built without lora_rank")
        if adapter is None:
            adapter = init_lora_adapter(self.cfg, self.ecfg.lora_rank,
                                        seed=seed, dtype=self.cfg.dtype,
                                        device=self.device)
        self.lora_pool.add(name, adapter)

    def remove_lora(self, name: str) -> None:
        if self.lora_pool is None:
            raise ValueError("engine built without lora_rank")
        users = [s.request_id for s in self.requests.values()
                 if s.model_id == name and not s.finished]
        if users:
            # removing it mid-flight would fail a later step() for the
            # whole batch, base-model requests included
            raise RuntimeError(
                f"adapter {name!r} is in use by {len(users)} live "
                f"request(s); drain or abort them first")
        self.lora_pool.remove(name)

    # --- metrics ---

    def stats(self) -> Dict[str, Any]:
        """The reference's occupancy stats, plus counts of the device
        work units run so far (each whole-prompt prefill runs the flash
        kernel once per layer; each paged decode step runs the paged
        kernel once per layer; so does each drafter warm-up prefill,
        once per drafter layer), the decode steps replayed from the
        captured step (``decode_graph_steps``) and the captures made
        (``decode_graph_captures``), and the drafter's counters under
        "spec"."""
        out = {
            "running": sum(s is not None for s in self.slots),
            "waiting": len(self.waiting),
            "free_pages": self.allocator.free_pages,
            "total_pages": self.allocator.num_pages - 1,
            **self._counts,
            "decode_graph_captures": (self._graph.captures
                                      if self._graph is not None else 0),
        }
        if self.spec is not None:
            out["spec"] = self.spec.stats()
        return out
