"""Batches onto the card with one batch of prefetch (counterpart of
``Dataset.iter_jax_batches``, ``ray_tpu/data/dataset.py:379-395``).

The port may not import ``Dataset``, so the counterpart is a function
over any iterator of dicts of numpy arrays (what ``Dataset.iter_batches``
yields). It yields the same batches in the same order, the last one
included, as dicts of torch tensors.

On the card each column is copied into pinned host memory and sent to
the card with a ``non_blocking`` copy on a side stream, one batch ahead:
the next batch's copy overlaps the current batch's compute. Before a
batch is yielded, the consumer's stream waits on its copy, and each
tensor is marked as used by that stream (``record_stream``), so that the
caching allocator does not hand its memory out again while the
consumer's kernels may still read it. The pinned buffers need no holding
here: a ``non_blocking`` copy out of pinned memory records an event on
its buffer in PyTorch's caching host allocator, which hands the buffer
out again only after that event, when the copy has completed.

Unlike ``jax.device_put``, which makes int64 into int32 and float64 into
float32 unless JAX runs in 64-bit mode, the port keeps every numpy dtype.
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator

import numpy as np
import torch

from .._private.device import DeviceLike, resolve_device


def iter_device_batches(batches: Iterable[Dict[str, np.ndarray]], *,
                        device: DeviceLike = None
                        ) -> Iterator[Dict[str, torch.Tensor]]:
    """Each batch of ``batches`` as a dict of tensors on ``device``
    (default: the card; raises without one). With ``device="cpu"`` a
    column is ``torch.from_numpy`` of its array: no pinning, no stream."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return ({k: torch.from_numpy(v) for k, v in batch.items()}
                for batch in batches)
    return _prefetch(iter(batches), dev)


def _stage(batch, dev, stream):
    """Start one batch's host-to-device copies on ``stream``; returns the
    device tensors and the event after their copies."""
    pinned = {}
    for k, v in batch.items():
        src = torch.from_numpy(np.ascontiguousarray(v))
        pinned[k] = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        pinned[k].copy_(src)
    with torch.cuda.stream(stream):
        # allocated on the side stream: the consumer's use is recorded at
        # hand-over
        placed = {k: p.to(dev, non_blocking=True) for k, p in pinned.items()}
        done = torch.cuda.Event()
        done.record(stream)
    return placed, done


def _prefetch(batches, dev):
    stream = torch.cuda.Stream(dev)
    pending = None
    for batch in batches:
        placed = _stage(batch, dev, stream)
        if pending is not None:
            yield _hand_over(pending, dev)
        pending = placed
    if pending is not None:
        yield _hand_over(pending, dev)


def _hand_over(staged, dev):
    placed, done = staged
    consumer = torch.cuda.current_stream(dev)
    consumer.wait_event(done)
    for t in placed.values():
        t.record_stream(consumer)
    return placed
