"""The port's device utilities (``ray_tpu_torch/util``) against
``ray_tpu.util`` on the CPU: the HBM record and the profiler.

Tolerance: none. The records must be equal, field for field.
"""

import glob
import gzip
import os

import jax.numpy as jnp
import pytest
import torch

from ray_tpu.util import hbm as ref_hbm
from ray_tpu.util import tracing as ref_tracing
from ray_tpu_torch.util import collect_hbm_stats, profile, span
from ray_tpu_torch.util.hbm import stats_from_torch

# six xdist workers share the machine's cores
torch.set_num_threads(2)

GB = 1 << 30


class _Dev:
    """A device as both packages' ``devices`` injection takes it."""

    def __init__(self, id, platform, stats):
        self.id, self.platform, self._stats = id, platform, stats

    def memory_stats(self):
        if isinstance(self._stats, Exception):
            raise self._stats
        return self._stats


class _Bare:
    """No ``id``, no ``platform``: the record falls back."""

    def memory_stats(self):
        return {"bytes_in_use": 5, "bytes_limit": 10}


def _devices():
    return [
        _Dev(0, "gpu", {"bytes_in_use": 3 * GB, "bytes_limit": 80 * GB,
                        "peak_bytes_in_use": 9 * GB,
                        "largest_free_block_bytes": 60 * GB}),
        _Dev(1, "gpu", {"bytes_in_use": GB, "bytes_limit": 80 * GB}),
        _Dev(2, "gpu", None),                       # no stats: skipped
        _Dev(3, "gpu", RuntimeError("gone")),       # raising: skipped
        _Dev(4, "gpu", {"bytes_in_use": 7, "bytes_limit": 0}),
        _Dev(5, "tpu", {"bytes_in_use": 90, "bytes_limit": 80,
                        "largest_free_block_bytes": 0}),
        _Dev(6, "gpu", {"bytes_in_use": 10, "bytes_limit": 110,
                        "largest_free_block_bytes": 400}),  # clipped at 0
        _Bare(),
    ]


def test_hbm_record_matches_the_reference():
    got = collect_hbm_stats(devices=_devices())
    want = ref_hbm.collect_hbm_stats(devices=_devices())
    assert got == want
    assert [r["device"] for r in got] == ["0", "1", "4", "5", "6", "5"]
    assert got[0]["fragmentation"] == pytest.approx(1 - 60 / 77, abs=0)


def test_hbm_record_from_torch_counters():
    """The reading step maps the caching allocator's live bytes (not its
    reserved bytes) and the card's total memory onto the reference's
    keys; the record step then gives the reference's record."""
    torch_stats = {"allocated_bytes.all.current": 2 * GB,
                   "allocated_bytes.all.peak": 5 * GB,
                   "reserved_bytes.all.current": 7 * GB}
    stats = stats_from_torch(torch_stats, free=70 * GB, total=80 * GB,
                             largest_cached_free=3 * GB)
    assert stats == {"bytes_in_use": 2 * GB, "peak_bytes_in_use": 5 * GB,
                     "bytes_limit": 80 * GB,
                     "largest_free_block_bytes": 70 * GB}
    # the cache's block counts where it is the larger
    assert stats_from_torch(torch_stats, 1 * GB, 80 * GB, 3 * GB)[
        "largest_free_block_bytes"] == 3 * GB
    devs = [_Dev(0, "gpu", stats)]
    assert collect_hbm_stats(devices=devs) == \
        ref_hbm.collect_hbm_stats(devices=devs)
    assert collect_hbm_stats(devices=devs)[0]["fragmentation"] == \
        pytest.approx(1 - 70 / 78, abs=0)


def test_hbm_without_a_card_is_empty(monkeypatch):
    assert collect_hbm_stats() == []
    assert ref_hbm.collect_hbm_stats() == []   # jax's CPU backend
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert collect_hbm_stats() == []


def test_hbm_reads_only_the_cards_this_process_used(monkeypatch):
    """Of two cards, the process has reserved memory on card 1 only: the
    free memory of card 0 is never asked for (that would open a context
    there), and only card 1 has a record."""
    asked = []

    def mem_get_info(i):
        asked.append(i)
        return 70 * GB, 80 * GB

    used = {1: {"allocated_bytes.all.current": 2 * GB,
                "allocated_bytes.all.peak": 5 * GB,
                "reserved_bytes.all.peak": 6 * GB}}
    for name, fn in (("is_available", lambda: True),
                     ("is_initialized", lambda: True),
                     ("device_count", lambda: 2),
                     ("memory_stats", lambda i: used.get(i, {})),
                     ("memory_snapshot", lambda: []),
                     ("mem_get_info", mem_get_info)):
        monkeypatch.setattr(torch.cuda, name, fn)
    got = collect_hbm_stats()
    assert asked == [1]
    assert got == [{"device": "1", "platform": "gpu",
                    "bytes_in_use": 2 * GB, "bytes_limit": 80 * GB,
                    "peak_bytes_in_use": 5 * GB,
                    "fragmentation": 1 - 70 / 78}]


def _files_naming(log_dir, name):
    hits = []
    for f in glob.glob(os.path.join(log_dir, "**"), recursive=True):
        if not os.path.isfile(f):
            continue
        data = open(f, "rb").read()
        if f.endswith(".gz"):
            data = gzip.decompress(data)
        if name.encode() in data:
            hits.append(f)
    return hits


def test_profile_writes_a_trace_naming_the_span(tmp_path):
    """Both packages' profile writes a trace under log_dir, and the trace
    names the span opened inside it."""
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    with ref_tracing.profile(ref_dir):
        with ref_tracing.span("ref.data.step"):
            jnp.ones(8).sum().block_until_ready()
    with profile(port_dir, device="cpu") as prof:
        with span("port.data.step"):
            torch.ones(8).sum()
    assert _files_naming(ref_dir, "ref.data.step")
    hits = _files_naming(port_dir, "port.data.step")
    assert len(hits) == 1 and hits[0].endswith(".pt.trace.json")
    assert any(e.name == "port.data.step" for e in prof.events())


def test_profile_writes_its_trace_when_the_block_raises(tmp_path):
    with pytest.raises(KeyError):
        with profile(str(tmp_path), device="cpu"):
            with span("port.raised"):
                raise KeyError("x")
    assert _files_naming(str(tmp_path), "port.raised")
