"""A closed loop of streaming clients on ``LLMServer.completions``.

Each of the mix's ``clients`` streams one request at a time, greedy, and
sends its next as its stream ends; requests are taken in order from the
seeded list. The server is ``LLMServer`` with its in-process hooks, over
an ``LLMEngine`` on the benchmark's weights (the server cannot take a
weight tree: it is built on the port's smallest named model, ``tiny``, and
its public ``engine`` is then set to the benchmark's).

Set-up: weights, the engine, one request a prefill bucket that the mix
reaches (each also runs one full decode burst), then the loop itself until
``warm_completed`` requests have finished, so that the window opens on a
loop in its steady state, every decode slot busy. The window lasts
``--seconds``; then every request still open is aborted. The engine steps on one worker
thread, the loop's only executor, where the slice also starts and stops.

The benchmark's own wrapper of ``engine.step`` records each call's host
interval, its outputs (request, prompt length, token index) and how far
it moved the engine's ``decode_steps`` counter; the per-layer metrics read these. With
``--trace 1`` the last ``trace_seconds`` of the window are profiled
between two marker kernels laid at step boundaries.

After the window, and after the peak memory is read and the server and
engine are freed, a sample of the requests that streamed tokens (finished,
or cut at the close: the one with the most tokens, and others drawn from
the seed) is run through the float32 reference. The gaps by which the
served tokens' logits lie below the reference's best are reduced to the
statistics that the cell's ``limits`` name (its mean, in the cells of
``BENCHMARK.json``), each compared with its limit.
"""

from __future__ import annotations

import asyncio
import gc
import json
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from gpubench import check as chk
from gpubench import model, stats, trace
from gpubench.reference.decoder import Decoder
from gpubench.reference.lowp import fp8_round_trip
from gpubench.traffic import make_requests


class Phases:
    """Host seconds of a run's phases, from the process's start."""

    def __init__(self, t_start: float):
        self.last = t_start
        self.spans: Dict[str, float] = {}

    def at(self, name: str, t: float) -> None:
        self.spans[name] = t - self.last
        self.last = t

    def done(self, name: str) -> None:
        self.at(name, time.perf_counter())


class StepRecorder:
    """Wraps ``engine.step``: records every call, lays the trace slice's
    markers at step boundaries, and aborts every open request when asked
    (on the engine's own thread, under the server's engine lock)."""

    def __init__(self, engine, device):
        self.engine = engine
        self.inner = engine.step
        self.device = device
        self.steps: List[dict] = []
        self.trace_at: Optional[float] = None   # host time the slice begins
        self.trace_until: Optional[float] = None
        self.slice: Optional[trace.Slice] = None
        self.slice_steps = [None, None]     # first and last step inside
        self.abort = False
        engine.step = self

    def __call__(self, *args, **kwargs):
        eng = self.engine
        if self.abort:
            for rid, st in list(eng.requests.items()):
                if not st.finished:
                    eng.abort_request(rid)
        now = time.perf_counter()
        if self.slice is None and self.trace_at is not None \
                and now >= self.trace_at:
            self.slice = trace.Slice(self.device)
            self.slice.begin()
            self.slice_steps[0] = len(self.steps)
        elif self.slice is not None and self.slice_steps[1] is None \
                and self.trace_until is not None and now >= self.trace_until:
            self.slice_steps[1] = len(self.steps)
            self.slice.end()
        # the tracer's own time at this boundary, which the pump did not
        # spend
        traced = time.perf_counter() - now
        before = eng.stats()["decode_steps"]
        t0 = time.perf_counter()
        outs = self.inner(*args, **kwargs)
        t1 = time.perf_counter()
        rec = []
        for o in outs:
            st = eng.requests.get(o.request_id)
            plen = len(st.prompt) if st is not None else -1
            rec.append((o.request_id, plen, o.text_offset))
        self.steps.append({"t0": t0, "t1": t1, "out": rec, "traced": traced,
                           "decode_steps": eng.stats()["decode_steps"]
                           - before})
        return outs


def _warm_prompts(reqs, bucket_of, max_seq_len, rng, vocab):
    """One prompt a prefill bucket the mix reaches, as long as the longest
    of the mix's prompts in that bucket."""
    longest: Dict[int, int] = {}
    for r in reqs:
        b = bucket_of(len(r.prompt_ids), max_seq_len)
        longest[b] = max(longest.get(b, 0), len(r.prompt_ids))
    return [rng.integers(0, vocab, size=n).tolist()
            for _, n in sorted(longest.items())]


class Loop:
    """The clients, their requests, and what each saw."""

    def __init__(self, server, reqs, clients: int):
        self.server, self.reqs, self.clients = server, reqs, clients
        self.next = 0
        self.records: List[dict] = []
        self.completed = 0
        self.stop = False
        self.done_event = asyncio.Event()
        self.warm_target = 0

    async def client(self) -> None:
        while not self.stop:
            if self.next >= len(self.reqs):
                raise RuntimeError("the mix ran out of requests: raise "
                                   "its 'requests'")
            req = self.reqs[self.next]
            self.next += 1
            rec = {"index": req.index, "prompt_ids": req.prompt_ids,
                   "max_tokens": req.max_tokens, "tokens": [], "times": [],
                   "finished": False, "error": None,
                   "sent": time.perf_counter()}
            self.records.append(rec)
            try:
                stream = await self.server.completions({
                    "prompt_ids": req.prompt_ids,
                    "max_tokens": req.max_tokens, "temperature": 0.0,
                    "stream": True})
                async for chunk in stream:
                    now = time.perf_counter()
                    d = json.loads(chunk[len("data: "):])
                    rec["tokens"].append(int(d["token"]))
                    rec["times"].append(now)
                    if d["finished"]:
                        rec["finished"] = True
            except Exception as e:  # noqa: BLE001 - counted as failed
                rec["error"] = repr(e)
            self.completed += 1
            if self.completed >= self.warm_target:
                self.done_event.set()


async def _serve(ctx, server, recorder: StepRecorder, reqs, worker) -> dict:
    tr, wl = ctx.traffic, ctx.workload
    aio = asyncio.get_running_loop()
    aio.set_default_executor(worker)
    loop = Loop(server, reqs, int(tr["clients"]))
    loop.warm_target = int(tr.get("warm_completed", 0))
    tasks = [aio.create_task(loop.client())
             for _ in range(loop.clients)]
    try:
        if loop.warm_target > 0:
            await loop.done_event.wait()
        t0 = time.perf_counter()
        t1 = t0 + ctx.seconds
        if ctx.trace and ctx.device.type == "cuda":
            recorder.trace_at = t1 - float(wl["trace_seconds"])
            recorder.trace_until = t1
        await asyncio.sleep(t1 - time.perf_counter())
        loop.stop = True
        if recorder.slice is not None and recorder.slice_steps[1] is None:
            # the slice ends at the first step boundary after the window
            while recorder.slice_steps[1] is None and \
                    server.engine.has_unfinished():
                await asyncio.sleep(0.005)
        recorder.abort = True
        for t in tasks:
            t.cancel()
        for t in tasks:
            try:
                await t
            except asyncio.CancelledError:
                pass
        pump = server._pump_task
        if pump is not None:
            await pump
    finally:
        for t in tasks:
            t.cancel()
    return {"t0": t0, "t1": t1, "records": loop.records}


def _e2e(run: dict, steps: List[dict], setup_s: float) -> Dict[str, float]:
    t0, t1, recs = run["t0"], run["t1"], run["records"]
    done = [r for r in recs if r["finished"] and len(r["times"]) > 1
            and t0 <= r["times"][-1] <= t1]
    tpot = [(r["times"][-1] - r["times"][0]) * 1e3 / (len(r["times"]) - 1)
            for r in done]
    # each step's tokens (one a request it advanced, streamed as it
    # returns) accrue over the step: a window edge that falls inside a
    # step counts its share, not all or none of its burst
    out = {"setup_s": setup_s,
           "output_tokens_per_s": stats.prorated_rate(
               ((s["t0"], s["t1"], len(s["out"])) for s in steps), t0, t1)}
    if tpot:
        out["tpot_p90_ms"] = stats.percentile(tpot, 90)
    return out


def _label(steps):
    def label(a: float, b: float) -> str:
        mid = (a + b) / 2
        for s in steps:
            if s["t0"] <= mid <= s["t1"]:
                return "inside engine.step"
        return "between engine.step calls"
    return label


def run(ctx) -> Dict[str, Any]:
    phases = Phases(ctx.t_start)
    from ray_tpu_torch.llm import (EngineConfig, LLMEngine, LLMServer,
                                   SamplingParams)
    from ray_tpu_torch.llm.runner import prefill_bucket

    dev, spec, wl = ctx.device, ctx.spec, ctx.workload
    phases.done("imports")
    weights = model.make_weights(spec, ctx.seed, dev)
    sums = model.checksum(weights)
    cfg = model.llama_config(spec)
    params = weights
    if ctx.control == "program_int8":
        from ray_tpu_torch.ops.quant import quantize_params

        params = quantize_params(weights, cfg)
    phases.done("weights")
    ecfg = EngineConfig(**wl["engine"])
    engine = LLMEngine(params, cfg, ecfg, device=dev)
    reqs = make_requests(ctx.traffic, ctx.seed, spec.vocab)
    rng = np.random.default_rng([int(ctx.seed), 3])
    phases.done("engine_and_requests")
    engine.generate(
        _warm_prompts(reqs, prefill_bucket, ecfg.max_seq_len, rng,
                      spec.vocab),
        SamplingParams(temperature=0.0, max_tokens=ecfg.decode_burst + 1))
    server = LLMServer("tiny", device=dev, engine_config={
        "max_num_seqs": 1, "page_size": 16, "num_pages": 9,
        "max_seq_len": 128})
    server.engine = engine
    if ctx.trace and dev.type == "cuda":
        # the tracer's first start in a process takes seconds, and has to
        # be made on the main thread: here, in set-up
        trace.warm_profiler(dev)
    recorder = StepRecorder(engine, dev)
    phases.done("warm_up")
    worker = ThreadPoolExecutor(max_workers=1)
    # asyncio.run shuts the worker down with the loop
    served = asyncio.run(_serve(ctx, server, recorder, reqs, worker))
    setup_s = served["t0"] - ctx.t_start
    phases.at("pre_roll", served["t0"])
    phases.at("window", served["t1"])
    phases.done("drain")
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    tr = recorder.slice.read() if recorder.slice is not None else None
    t0, t1, recs = served["t0"], served["t1"], served["records"]
    sent = [r for r in recs if t0 <= r["sent"] <= t1]
    failed = sum(1 for r in sent if r["error"] is not None)
    records = {"spec": spec, "window": (t0, t1), "steps": recorder.steps,
               "slice_steps": recorder.slice_steps, "trace": tr}
    out = {"e2e": _e2e(served, recorder.steps, setup_s),
           "records": records,
           "attempted": len(sent), "failed": failed,
           "memory_peak_bytes": peak, "trace": tr,
           "breakdown": (trace.breakdown(tr, _label(recorder.steps))
                         if tr else None)}
    del server, engine, params, recorder
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    phases.done("free")
    out["checks"], out["readings"] = compare(ctx, weights, sums, recs)
    phases.done("reference")
    out["phases"] = phases.spans
    return out


def compare(ctx, weights, sums, recs):
    """The sample through the reference, and the control's reading when
    the cell's control is the reference in a lower precision. The numbers
    compared are the gap statistics that the cell's ``limits`` name
    (``check.gap_readings``' keys); returns the checks and, beside them,
    every statistic of the gaps (``readings``)."""
    lim = dict(ctx.workload["limits"])
    # every request that streamed tokens: finished, or cut at the close
    done = [r for r in recs if r["tokens"] and r["error"] is None]
    sample = chk.sample_requests(done, int(ctx.workload["sample"]),
                                 ctx.seed)
    n_tokens = sum(len(r["tokens"]) for r in sample)
    checks = {"weights_unchanged": chk.check(
        0 if model.checksum(weights) == sums else 1, 0),
        # a sample too small to judge is no pass
        "sampled_tokens_short": chk.check(
            max(0, int(lim.pop("min_sampled_tokens")) - n_tokens), 0)}
    if not sample:
        checks.update({k: chk.check(float("inf"), v) for k, v in lim.items()})
        return checks, {}
    seqs, pos = chk.sequences(sample)
    ref = Decoder(ctx.spec, weights).logits_at(seqs, pos)
    gaps = torch.cat([chk.served_gaps(lg, r["tokens"])
                      for lg, r in zip(ref, sample)])
    readings = {"program": chk.gap_readings(gaps)}
    if ctx.control == "reference_fp8":
        ctl = Decoder(ctx.spec, weights, fp8_round_trip).logits_at(seqs, pos)
        readings["control"] = chk.gap_readings(torch.cat(
            [chk.control_gaps(a, b) for a, b in zip(ref, ctl)]))
    for side, prefix in (("program", ""), ("control", "control_")):
        for name, limit in lim.items():
            if side in readings:
                checks[prefix + name] = chk.check(
                    readings[side][name.removesuffix("_logit_gap")], limit)
    return checks, readings
