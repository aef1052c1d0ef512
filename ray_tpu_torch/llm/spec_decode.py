"""Speculative decoding: a small drafter proposes k tokens per slot, the
target scores the whole window in one batched forward
(``runner.verify_step``), and accept-prefix emits the longest agreeing
prefix plus one corrected token: token for token the greedy oracle's
output, 1..k+1 tokens a round instead of 1.

Counterpart of ``ray_tpu/llm/spec_decode.py``. The emitted tokens are
exactly the first m+1 tokens of the target's greedy continuation, m the
length of the longest draft prefix that agrees with it, so any correct
computation of that continuation gives the same emission: the fleet
verifier (an engine fed a KV snapshot) and the recompute fallback for a
corrupt payload cannot diverge from the monolithic round.

The drafter keeps its own paged KV cache on the engine's device, but
mirrors the target's page pool 1:1 and shares its block tables (the same
page ids, no second allocator); shared prefix pages hold token-identical
content in both caches. Each draft round opens with a 2-token repair
window [p-1, p]: after a full accept plus the bonus token, the previous
round's last draft token never ran through the drafter, so the drafter's
KV trails the target's by at most one position, which the window
rewrites. The caches are updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from .._private.device import resolve_device
from ..models.llama import LLAMA_CONFIGS, LlamaConfig, init_params
from ..ops import rope_frequencies
from .cache import init_kv_cache
from .runner import decode_burst, prefill, prefill_bucket, verify_step

__all__ = ["SpecConfig", "SpecDecoder", "accept_prefix", "remote_verify"]


def accept_prefix(draft: Sequence[int], target: Sequence[int]) -> List[int]:
    """Greedy accept-prefix: ``target[j]`` is the target's argmax after
    window position j (the token before ``draft[j]``), so ``draft[j]`` is
    accepted iff it equals ``target[j]``. Returns the accepted prefix plus
    ``target[m]``: the correction at the first disagreement, or the bonus
    token on a full accept. ``len(target)`` must exceed ``len(draft)``."""
    m = 0
    for j, d in enumerate(draft):
        if int(d) != int(target[j]):
            break
        m += 1
    return [int(t) for t in draft[:m]] + [int(target[m])]


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """``speculation={"draft_config": ..., "num_draft_tokens": k}``.
    ``draft_config`` names an ``LLAMA_CONFIGS`` entry (or is a
    LlamaConfig); ``draft_seed`` seeds the drafter's random init when no
    params are supplied."""
    draft_config: Any
    num_draft_tokens: int = 3
    draft_seed: int = 0

    @classmethod
    def parse(cls, obj: Any) -> "SpecConfig":
        if isinstance(obj, cls):
            return obj
        if isinstance(obj, dict):
            known = {"draft_config", "num_draft_tokens", "draft_seed"}
            extra = sorted(set(obj) - known)
            if extra:
                raise ValueError(f"unknown speculation keys {extra}; "
                                 f"expected a subset of {sorted(known)}")
            if "draft_config" not in obj:
                raise ValueError("speculation requires 'draft_config'")
            return cls(draft_config=obj["draft_config"],
                       num_draft_tokens=int(obj.get("num_draft_tokens", 3)),
                       draft_seed=int(obj.get("draft_seed", 0)))
        raise TypeError(f"speculation must be a dict or SpecConfig, "
                        f"got {type(obj).__name__}")


def _resolve_draft_cfg(dc: Any) -> LlamaConfig:
    if isinstance(dc, LlamaConfig):
        return dc
    if isinstance(dc, str):
        try:
            return LLAMA_CONFIGS[dc]
        except KeyError:
            raise ValueError(
                f"unknown draft_config {dc!r}; known: "
                f"{sorted(LLAMA_CONFIGS)}") from None
    raise TypeError(f"draft_config must be a name or LlamaConfig, "
                    f"got {type(dc).__name__}")


class SpecDecoder:
    """The drafter half of speculative decoding: the draft model's params
    and paged KV cache, proposing k tokens per drafted slot. The engine
    owns scheduling, verification and emission."""

    def __init__(self, target_cfg: LlamaConfig, ecfg, spec_cfg,
                 draft_params=None, device=None):
        sc = SpecConfig.parse(spec_cfg)
        if sc.num_draft_tokens < 1:
            raise ValueError("num_draft_tokens must be >= 1")
        dcfg = _resolve_draft_cfg(sc.draft_config)
        if ecfg.max_seq_len > dcfg.max_seq:
            raise ValueError(
                f"draft model max_seq {dcfg.max_seq} < engine "
                f"max_seq_len {ecfg.max_seq_len}")
        if dcfg.vocab < target_cfg.vocab:
            # still correct (those ids always reject) but almost surely a
            # tokenizer mismatch
            raise ValueError(
                f"draft vocab {dcfg.vocab} < target vocab "
                f"{target_cfg.vocab}: drafter cannot propose every "
                f"target token")
        self.device = resolve_device(device)
        self.spec_cfg = sc
        self.dcfg = dcfg
        self.ecfg = ecfg
        self.k = sc.num_draft_tokens
        if draft_params is None:
            draft_params = init_params(dcfg, seed=sc.draft_seed,
                                       device=self.device)
        leaf = draft_params["embed"]
        leaf = leaf["q"] if isinstance(leaf, dict) else leaf
        if leaf.device != self.device:
            raise ValueError(f"draft params live on {leaf.device}, the "
                             f"engine on {self.device}")
        self.params = draft_params
        # mirrors the target's page pool 1:1: block tables are shared
        self.cache = init_kv_cache(dcfg, ecfg.num_pages, ecfg.page_size,
                                   None, device=self.device)
        self.cos, self.sin = rope_frequencies(
            dcfg.head_dim, dcfg.max_seq, dcfg.rope_theta, device=self.device)
        # slots whose draft cache covers their sequence; drop() (preempt,
        # finish, handoff) forces a fresh warm-up prefill
        self.ready: set = set()
        self.drafted_total = 0
        self.accepted_total = 0
        self.emitted_total = 0
        self.rounds_total = 0
        self.remote_rounds_total = 0
        self.remote_agree_total = 0
        self.verify_times: List[float] = []

    # --- bookkeeping ---

    def drop(self, slot: int) -> None:
        self.ready.discard(slot)

    def reset(self) -> None:
        self.ready.clear()

    def on_round(self, drafted: int, accepted: int) -> None:
        self.drafted_total += drafted
        self.accepted_total += accepted
        self.emitted_total += accepted + 1
        self.rounds_total += 1

    @property
    def acceptance_ratio(self) -> float:
        return (self.accepted_total / self.drafted_total
                if self.drafted_total else 0.0)

    def take_verify_times(self) -> List[float]:
        """The verify forwards' seconds since the last call (the serve
        pump drains them into its histogram)."""
        out, self.verify_times = self.verify_times, []
        return out

    def stats(self) -> Dict[str, Any]:
        return {
            "draft_tokens": self.drafted_total,
            "accepted_tokens": self.accepted_total,
            "rounds": self.rounds_total,
            "acceptance_ratio": self.acceptance_ratio,
            "remote_rounds": self.remote_rounds_total,
            "remote_agree": self.remote_agree_total,
        }

    # --- device work ---

    def _to_device(self, a) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

    def prefill(self, tokens: Sequence[int], block_row) -> None:
        """Warm the drafter's KV for positions [0, len(tokens)) of one
        slot (its first drafted round, or the first after a drop), through
        ``runner.prefill`` (the flash kernel on the card). ``block_row``
        is the slot's [1, max_pages] block-table row."""
        L = len(tokens)
        bucket = prefill_bucket(L, self.ecfg.max_seq_len)
        tok = np.zeros((1, bucket), np.int32)
        tok[0, :L] = tokens
        prefill(self.params, self.cache.k, self.cache.v,
                self._to_device(tok),
                self._to_device(np.asarray([L], np.int32)),
                self._to_device(block_row), self.cos, self.sin, None,
                cfg=self.dcfg)

    def draft(self, items: Sequence[Tuple[int, int, int, int]],
              bt) -> Dict[int, List[int]]:
        """Propose k tokens per drafted slot. ``items`` rows are
        ``(slot, token_at_p_minus_1, token_at_p, p)`` with p the slot's
        ctx_len; ``bt`` is the device block table [B, span] shared with
        the target. The repair window [p-1, p] yields d_1; a greedy decode
        burst (the gather path, as in the reference) continues d_2..d_k.
        Returns {slot: [d_1 .. d_k]}."""
        B = int(bt.shape[0])
        tok2 = np.zeros((B, 2), np.int32)
        pos2 = np.full((B, 2), -1, np.int32)
        pos1 = np.zeros(B, np.int32)
        active = np.zeros(B, bool)
        for slot, t_prev, t_last, p in items:
            tok2[slot] = (t_prev, t_last)
            pos2[slot] = (p - 1, p)
            pos1[slot] = p + 1
            active[slot] = True
        zf = torch.zeros(B, dtype=torch.float32, device=self.device)
        zi = torch.zeros(B, dtype=torch.int32, device=self.device)
        of = torch.ones(B, dtype=torch.float32, device=self.device)
        tgt2, _s0, _, _ = verify_step(
            self.params, self.cache.k, self.cache.v, self._to_device(tok2),
            self._to_device(pos2), bt, self.cos, self.sin, 0, zf, zi, of,
            cfg=self.dcfg, greedy=True)
        d1 = tgt2[:, 1]
        if self.k > 1:
            rest, _, _ = decode_burst(
                self.params, self.cache.k, self.cache.v, d1,
                self._to_device(pos1), bt, self._to_device(active),
                self.cos, self.sin, 0, of, zi, of, None, cfg=self.dcfg,
                n_steps=self.k - 1, paged_kernel=False, greedy=True)
            drafts = torch.cat([d1[None], rest]).cpu().numpy()   # [k, B]
        else:
            drafts = d1[None].cpu().numpy()
        return {slot: [int(t) for t in drafts[:, slot]]
                for slot, _tp, _tl, _p in items}


def remote_verify(engine, payload: Dict[str, Any],
                  draft: Sequence[int], params=None) -> List[int]:
    """Fleet verifier entry point: inject a KV snapshot into ``engine`` (a
    scratch verifier), run one verification round against ``draft`` and
    return the emission, identical to the monolithic round. An unusable
    payload falls back to local recompute: the prefill itself emits the
    first greedy token, which consumes (or corrects) the first draft
    token, and the rest of the window verifies normally. The scratch
    request is aborted before returning."""
    from .sampling import SamplingParams

    draft = [int(t) for t in draft]
    pre = [int(t) for t in payload.get("output") or ()]
    if params is None:
        # generous budget: the caller's own request clips the emission
        params = SamplingParams(
            temperature=0.0, max_tokens=len(pre) + len(draft) + 4)
    rid = engine.inject_request(payload, params=params)
    state = engine.requests[rid]
    try:
        emitted: List[int] = []
        if state.ctx_len <= 0 and not state.finished:
            # recompute fallback: admission and prefill only; the prefill
            # samples exactly one greedy token
            guard = 0
            limit = 4 * (len(payload.get("prompt") or ()) + len(pre) + 8)
            while not state.finished and state.ctx_len <= 0:
                engine.step(skip_decode=True)
                guard += 1
                if guard > limit:
                    raise RuntimeError(
                        f"recompute fallback for {rid} made no progress")
            for t in [int(t) for t in state.output[len(pre):]]:
                emitted.append(t)
                if draft and draft[0] == t:
                    draft.pop(0)
                else:
                    return emitted       # a correction ends the round
        if state.finished:
            return emitted
        emitted.extend(engine.verify_request(rid, draft))
        return emitted
    finally:
        engine.abort_request(rid)
