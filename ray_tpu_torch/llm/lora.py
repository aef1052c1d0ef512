"""Multi-LoRA serving: per-request low-rank adapters in one batched engine.

Counterpart of ``ray_tpu/llm/lora.py``. Adapters live in a stacked pool
on the engine's device, one tensor per projection: ``a_q [P, L, d, r]``,
``b_q [P, L, r, h*hd]`` (the same for wv), so a decode batch in which
every slot wears a different adapter is one indexed copy per projection
(``pool[ids]``) plus two skinny batched products. Slot 0 of the pool is
the zero adapter: a request without a ``model_id`` wears it and gets
exactly the base model (its delta is 0 and ``q + 0`` is ``q``).

The pool tensors are updated in place, so a cached selection (an indexed
copy) would go stale: ``add`` and ``remove`` clear the cache.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from .._private.device import resolve_device

__all__ = ["LoRAPool", "init_lora_adapter", "lora_delta"]

_FIELDS = ("a_q", "b_q", "a_v", "b_v")


def _shapes(cfg, rank: int) -> Dict[str, tuple]:
    L, d, hd = cfg.n_layers, cfg.dim, cfg.head_dim
    return {"a_q": (L, d, rank), "b_q": (L, rank, cfg.n_heads * hd),
            "a_v": (L, d, rank), "b_v": (L, rank, cfg.n_kv_heads * hd)}


def init_lora_adapter(cfg, rank: int, *, seed: int = 0, scale: float = 1.0,
                      dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    """One adapter's weights with the standard init: A ~ N(0, 1/r) from a
    seeded ``torch.Generator``, B = 0, so a fresh adapter is an exact
    no-op until trained. The draws differ from the JAX init (another
    generator); tests carry JAX adapters over with
    ``models.convert.lora_from_jax``."""
    dev = resolve_device(device)
    gen = torch.Generator(dev)
    gen.manual_seed(seed)
    out: Dict[str, Any] = {}
    for name, shape in _shapes(cfg, rank).items():
        if name.startswith("a_"):
            out[name] = (torch.randn(shape, generator=gen, device=dev)
                         * rank ** -0.5).to(dtype)
        else:
            out[name] = torch.zeros(shape, dtype=dtype, device=dev)
    out["scale"] = float(scale)
    return out


def lora_delta(h, a_sel, b_sel, scale_sel, out_heads: int, head_dim: int):
    """Per-slot low-rank delta: h [B, S, d]; a_sel [B, d, r];
    b_sel [B, r, out]; scale_sel [B] -> [B, S, heads, head_dim]."""
    lo = torch.einsum("bsd,bdr->bsr", h, a_sel)
    delta = torch.einsum("bsr,bro->bso", lo, b_sel)
    delta = delta * scale_sel[:, None, None].to(delta.dtype)
    B, S = h.shape[:2]
    return delta.reshape(B, S, out_heads, head_dim)


class LoRAPool:
    """Host-side registry and device-side stacked pool.

    Slot 0 is permanently the zero adapter. ``add`` writes an adapter
    into a free slot in place; ``remove`` frees it by zeroing its scale
    (the slot's stale weights then multiply to nothing, and reuse
    overwrites them)."""

    def __init__(self, cfg, rank: int, max_loras: int,
                 dtype=torch.bfloat16, device=None):
        if max_loras < 1:
            raise ValueError("max_loras must be >= 1")
        dev = resolve_device(device)
        P = max_loras + 1              # + the zero slot
        self.rank, self.max_loras = rank, max_loras
        self.cfg = cfg
        self.device = dev
        self.pool = {name: torch.zeros((P, *shape), dtype=dtype, device=dev)
                     for name, shape in _shapes(cfg, rank).items()}
        self.pool["scale"] = torch.zeros(P, dtype=torch.float32, device=dev)
        self._slots: Dict[str, int] = {}
        self._free = list(range(P - 1, 0, -1))
        self._select_cache: Dict[tuple, Dict[str, Any]] = {}

    def __contains__(self, name: str) -> bool:
        return name in self._slots

    def __len__(self) -> int:
        return len(self._slots)

    def slot_of(self, name: Optional[str]) -> int:
        if name is None:
            return 0
        if name not in self._slots:
            raise KeyError(f"unknown LoRA adapter {name!r}; add_lora it "
                           f"first (loaded: {sorted(self._slots)})")
        return self._slots[name]

    def add(self, name: str, adapter: Dict[str, Any]) -> int:
        """Write ``adapter`` (tensors, or arrays ``torch.as_tensor``
        takes, of the pool's per-slot shapes) into a free slot."""
        if name in self._slots:
            raise ValueError(f"adapter {name!r} already loaded")
        if not self._free:
            raise RuntimeError(
                f"LoRA pool full ({self.max_loras}); remove one first")
        leaves = {}
        for field in _FIELDS:
            leaf = torch.as_tensor(adapter[field])
            if tuple(leaf.shape) != tuple(self.pool[field].shape[1:]):
                raise ValueError(
                    f"adapter {field} shape {tuple(leaf.shape)} != pool "
                    f"{tuple(self.pool[field].shape[1:])}")
            leaves[field] = leaf
        slot = self._free.pop()
        for field, leaf in leaves.items():
            self.pool[field][slot] = leaf.to(self.device,
                                             self.pool[field].dtype)
        self.pool["scale"][slot] = float(adapter.get("scale", 1.0))
        self._select_cache.clear()
        self._slots[name] = slot
        return slot

    def remove(self, name: str) -> None:
        slot = self._slots.pop(name)
        self.pool["scale"][slot] = 0.0
        self._select_cache.clear()
        self._free.append(slot)

    def select(self, ids) -> Dict[str, Any]:
        """Per-slot adapter tensors for a batch: ids [B] ->
        {a_q [B, L, d, r], ..., scale [B]} (one indexed copy per
        projection), cached by the id tuple: steady-state decode selects
        the same assignment every burst. Any add or remove clears the
        cache."""
        key = tuple(int(i) for i in ids)
        cached = self._select_cache.get(key)
        if cached is not None:
            return cached
        idx = torch.tensor(key, dtype=torch.long, device=self.device)
        out = {name: t[idx] for name, t in self.pool.items()}
        if len(self._select_cache) > 64:
            self._select_cache.clear()
        self._select_cache[key] = out
        return out
