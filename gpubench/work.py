"""The work a serving window did, from the driver's step records.

Each record of ``engine.step`` lists its outputs as (request, prompt
length, token index). Token 0 of a request comes from the prefill of its
prompt; token j > 0 from a decode step that attends over prompt + j
positions (its input, token j - 1, sits at position prompt + j - 1).
"""

from __future__ import annotations

from typing import Dict, List

from gpubench import flops


def window_steps(records) -> List[dict]:
    """The steps that ended inside the measured window."""
    t0, t1 = records["window"]
    return [s for s in records["steps"] if t0 <= s["t1"] <= t1]


def slice_steps(records) -> List[dict]:
    """The steps that ran between the trace slice's two markers."""
    a, b = records.get("slice_steps") or (None, None)
    if a is None or b is None or not records.get("trace"):
        return []
    return records["steps"][a:b]


def tally(steps: List[dict]) -> Dict[str, list]:
    """Prompt lengths prefilled, and each decoded token's context."""
    prompts, contexts = [], []
    for s in steps:
        for _rid, plen, j in s["out"]:
            if j == 0:
                prompts.append(plen)
            else:
                contexts.append(plen + j)
    return {"prompts": prompts, "contexts": contexts}


def serve_flops(spec, steps: List[dict]) -> int:
    t = tally(steps)
    return (sum(flops.prefill_flops(spec, p) for p in t["prompts"])
            + sum(flops.decode_flops(spec, c) for c in t["contexts"]))


def decode_steps(steps: List[dict]) -> int:
    """The engine's decode steps (each runs every decode slot once) over
    ``steps``."""
    return sum(s["decode_steps"] for s in steps)


# The readers of the serving metrics that cells reporting different
# throughputs share: ``metrics/<name>.py`` and ``metrics/<name>.batch.py``
# both name one of these. Each returns None where it finds nothing to read.

def outside_step_ms(records):
    """Mean host ms between one ``engine.step`` call's end and the next
    one's start over the window's steps (the server's pump: its executor
    hop, the fan-out to the request queues, the metrics), less the
    tracer's own time at a boundary."""
    if "steps" not in records:
        return None
    steps = window_steps(records)
    gaps = [b["t0"] - a["t1"] - b.get("traced", 0.0)
            for a, b in zip(steps, steps[1:])]
    return sum(gaps) / len(gaps) * 1e3 if gaps else None


def decode_rows_mean(records):
    """Rows a decode step advanced, on average over the window: the tokens
    that decode bursts emitted (every token but each request's first)
    over the engine's ``decode_steps`` in the window's steps."""
    if "steps" not in records:
        return None
    steps = window_steps(records)
    n = decode_steps(steps)
    return len(tally(steps)["contexts"]) / n if n else None


def serve_mfu(records):
    """The products' and attention's operations that the window's served
    tokens needed (unpadded prompts through prefill, decoded tokens at
    their contexts, the active experts of a mixture; see ``flops.py``),
    over the window's length, as a share of the card's dense bf16 peak,
    in %."""
    if "steps" not in records:
        return None
    t0, t1 = records["window"]
    ops = serve_flops(records["spec"], window_steps(records))
    return 100.0 * ops / (t1 - t0) / flops.PEAK_FLOPS if ops else None


def idle_share(records):
    """The share of the traced slice in which no kernel or copy ran on the
    card, in %; the slice's edges are marker kernels on the card's
    clock."""
    tr = records.get("trace")
    if "steps" not in records or not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
