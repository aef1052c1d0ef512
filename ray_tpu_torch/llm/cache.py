"""Paged KV cache: device tensors + host-side page allocator.

Counterpart of ``ray_tpu/llm/cache.py``. The cache is a pair of stacked
tensors [layers, pages, page_size, kv_heads, head_dim] on the device,
updated in place by the runner (the JAX code donated the buffers to get
the same effect); every paging decision is made host-side.

Page 0 is the *dump page*: padded and inactive lanes write there, so the
device code never branches on validity. It is never handed out.
"""

from __future__ import annotations

import hashlib
import struct
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Sequence

import numpy as np
import torch


@dataclass
class KVCache:
    """Device-side paged cache (one pair of stacked-layer tensors)."""

    k: torch.Tensor  # [L, num_pages, page_size, kv_heads, head_dim]
    v: torch.Tensor

    @property
    def num_pages(self) -> int:
        return self.k.shape[1]

    @property
    def page_size(self) -> int:
        return self.k.shape[2]


def init_kv_cache(cfg, num_pages: int, page_size: int, dtype=None,
                  device=None) -> KVCache:
    from .._private.device import resolve_device

    dev = resolve_device(device)
    shape = (cfg.n_layers, num_pages, page_size, cfg.n_kv_heads,
             cfg.head_dim)
    dtype = dtype or cfg.dtype
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=dev),
                   v=torch.zeros(shape, dtype=dtype, device=dev))


def chained_page_keys(tokens: Sequence[int], page_size: int) -> List[bytes]:
    """Content-addressed keys for each FULL page of a token sequence:
    SHA-256 over (parent digest + the page's tokens packed as
    little-endian int64). Byte-identical to ``ray_tpu``'s
    ``serve/kv_router.chained_page_keys``, of which this is the port's
    own copy, so engines and routers of both packages agree."""
    keys: List[bytes] = []
    parent = b""
    for start in range(0, (len(tokens) // page_size) * page_size,
                       page_size):
        chunk = tokens[start:start + page_size]
        h = hashlib.sha256(parent)
        h.update(struct.pack(f"<{len(chunk)}q", *(int(t) for t in chunk)))
        parent = h.digest()
        keys.append(parent)
    return keys


# truncated digest width of the routing summaries (64-bit), as
# ``serve/kv_router.py``'s: a collision can only misroute a request to a
# replica that then prefills normally (its engine checks the full keys)
DIGEST_BYTES = 8


def truncate_keys(keys: Iterable[bytes]) -> List[bytes]:
    return [k[:DIGEST_BYTES] for k in keys]


def make_summary(keys: Iterable[bytes], page_size: int) -> Dict[str, Any]:
    """The prefix-cache summary a replica publishes for the fleet's KV
    router: its cached pages' keys, truncated, as a set. The port's copy
    of ``serve/kv_router.py::make_summary``."""
    return {"page_size": int(page_size), "digests": set(truncate_keys(keys))}


class PageAllocator:
    """Host-side free list over the page pool (page 0 reserved). Pages
    are reference-counted: prefix caching shares prompt pages across
    sequences, so ``free`` decrements and only a zero count returns the
    page to the free list."""

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is reserved)")
        self.page_size = page_size
        self.num_pages = num_pages
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._refs: dict = {}

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def pages_needed(self, n_tokens: int) -> int:
        return (n_tokens + self.page_size - 1) // self.page_size

    def can_allocate(self, n_tokens: int) -> bool:
        return self.pages_needed(n_tokens) <= len(self._free)

    def allocate(self, n_pages: int) -> List[int]:
        if n_pages > len(self._free):
            raise MemoryError(
                f"KV cache out of pages: want {n_pages}, "
                f"free {len(self._free)}")
        out = [self._free.pop() for _ in range(n_pages)]
        for p in out:
            self._refs[p] = 1
        return out

    def incref(self, page: int) -> None:
        if page not in self._refs:
            raise ValueError(f"incref on unallocated page {page}")
        self._refs[page] += 1

    def refcount(self, page: int) -> int:
        return self._refs.get(page, 0)

    def free(self, pages: List[int]) -> None:
        for p in pages:
            if not 0 < p < self.num_pages:
                raise ValueError(f"freeing invalid page {p}")
            if p not in self._refs:
                raise ValueError(f"double free of page {p}")
        for p in pages:
            self._refs[p] -= 1
            if self._refs[p] == 0:
                del self._refs[p]
                self._free.append(p)


class PrefixCache:
    """Content-addressed full prompt pages (automatic prefix caching). A
    page's key is the hash chain (parent key, the page's token ids); a
    lookup reuses the longest cached chain, shared through the
    allocator's refcounts. The cache holds one reference per cached page;
    eviction (LRU, leaves first) releases it."""

    def __init__(self, allocator: PageAllocator):
        self._alloc = allocator
        self._pages: Dict[Any, int] = {}
        self._lru: "OrderedDict[Any, None]" = OrderedDict()
        self._parent: Dict[Any, Any] = {}
        self._children: Dict[Any, int] = {}

    @staticmethod
    def page_keys(prompt, page_size: int) -> List[Any]:
        return chained_page_keys(prompt, page_size)

    def __len__(self) -> int:
        return len(self._pages)

    def lookup(self, keys: List[Any]) -> List[int]:
        """Pages of the longest cached prefix chain, each increffed for
        the caller."""
        out: List[int] = []
        for key in keys:
            page = self._pages.get(key)
            if page is None:
                break
            self._alloc.incref(page)
            self._lru.move_to_end(key)
            out.append(page)
        return out

    def insert(self, keys: List[Any], pages: List[int]) -> None:
        """Register freshly filled prompt pages; the cache takes one
        reference per NEW entry."""
        parent = 0
        for key, page in zip(keys, pages):
            if key in self._pages:
                parent = key
                continue
            self._alloc.incref(page)
            self._pages[key] = page
            self._lru[key] = None
            self._parent[key] = parent
            if parent:
                self._children[parent] = self._children.get(parent, 0) + 1
            parent = key

    def evictable(self) -> int:
        return sum(1 for p in self._pages.values()
                   if self._alloc.refcount(p) == 1)

    def evict(self, n_pages: int) -> int:
        """Release up to n_pages cache-only pages, leaf pages first, LRU
        within leaves. Returns pages released."""
        released = 0
        progress = True
        while released < n_pages and progress:
            progress = False
            for key in list(self._lru):
                if released >= n_pages:
                    break
                if self._children.get(key, 0):
                    continue
                page = self._pages[key]
                if self._alloc.refcount(page) != 1:
                    continue
                self._alloc.free([page])
                del self._pages[key]
                del self._lru[key]
                parent = self._parent.pop(key, 0)
                if parent and parent in self._children:
                    self._children[parent] -= 1
                    if not self._children[parent]:
                        del self._children[parent]
                self._children.pop(key, None)
                released += 1
                progress = True
        return released

    def evict_for(self, n_tokens: int) -> None:
        while not self._alloc.can_allocate(n_tokens):
            if not self.evict(1):
                return


class SequenceTable:
    """Per-sequence block tables (numpy, host-side; the engine uploads a
    copy when ``version`` changes)."""

    def __init__(self, max_seqs: int, max_pages_per_seq: int):
        self.block_tables = np.zeros((max_seqs, max_pages_per_seq), np.int32)
        self.n_pages = np.zeros(max_seqs, np.int32)
        self.version = 0

    def assign(self, slot: int, pages: List[int]) -> None:
        self.block_tables[slot, :] = 0
        self.block_tables[slot, :len(pages)] = pages
        self.n_pages[slot] = len(pages)
        self.version += 1

    def append_page(self, slot: int, page: int) -> None:
        idx = int(self.n_pages[slot])
        if idx >= self.block_tables.shape[1]:
            raise MemoryError(f"slot {slot}: sequence exceeds "
                              f"max_pages_per_seq={self.block_tables.shape[1]}")
        self.block_tables[slot, idx] = page
        self.n_pages[slot] = idx + 1
        self.version += 1

    def pages_of(self, slot: int) -> List[int]:
        return [int(p) for p in
                self.block_tables[slot, :int(self.n_pages[slot])]]

    def clear(self, slot: int) -> None:
        self.block_tables[slot, :] = 0
        self.n_pages[slot] = 0
        self.version += 1
