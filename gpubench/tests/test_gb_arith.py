"""The FLOP and byte arithmetic against hand counts, and the window
statistics."""

from __future__ import annotations

import statistics

import pytest

from gpubench import flops, stats
from gpubench.spec import spec_from_config

from conftest import TINY_CONFIG, TINY_MOE_CONFIG

# tiny: d 64, 4 heads of 16, 2 kv heads, MLP 128, 2 layers, vocab 2048
D, H, KVH, HD, M, L, V = 64, 4, 2, 16, 128, 2, 2048


def test_dense_counts_by_hand():
    s = spec_from_config(TINY_CONFIG)
    attn = D * H * HD + 2 * D * KVH * HD + H * HD * D     # 4096+4096+4096
    assert flops.layer_matmul_params(s) == attn + 3 * D * M == 36864
    assert flops.head_flops(s) == 2 * 64 * 2048
    assert flops.causal_pairs(3) == 6
    # a 3-token prompt: 3 tokens through both layers, 6 causal pairs, the
    # head at the last position
    assert flops.prefill_flops(s, 3) == (2 * 36864 * 2 * 3
                                         + 4 * 16 * 4 * 2 * 6 + 2 * 64 * 2048)
    # a token over 10 positions
    assert flops.decode_flops(s, 10) == (2 * 36864 * 2 + 2 * 64 * 2048
                                         + 4 * 16 * 4 * 2 * 10)
    # 10 positions of K and V (2 kv heads of 16, 2 bytes) and a query and
    # an output row (4 heads of 16, 2 bytes), in each of 2 layers
    assert flops.paged_decode_bytes(s, 10) == 2 * (2 * 10 * 32 * 2
                                                   + 2 * 64 * 2)


def test_mixture_counts_the_routed_experts():
    s = spec_from_config(TINY_MOE_CONFIG)
    attn = 3 * 4096
    assert flops.layer_matmul_params(s) == attn + 2 * 3 * D * M + D * 4


def test_percentile_by_hand():
    xs = [5.0, 1.0, 4.0, 2.0, 3.0]
    assert stats.percentile(xs, 0) == 1.0
    assert stats.percentile(xs, 50) == 3.0
    assert stats.percentile(xs, 90) == pytest.approx(4.6)
    assert stats.percentile(xs, 100) == 5.0
    assert stats.percentile([], 90) is None
    ys = [float(i) for i in range(1, 101)]
    assert stats.percentile(ys, 90) == pytest.approx(
        statistics.quantiles(ys, n=10, method="inclusive")[8])


def test_prorated_rate_counts_the_share_inside_the_window():
    # 100 tokens over [0, 2], 50 over [2.5, 3.5], 80 over [3.5, 5.5]: in
    # the window [1, 4.5] half the first, all the second, half the third
    spans = [(0.0, 2.0, 100), (2.5, 3.5, 50), (3.5, 5.5, 80)]
    assert stats.prorated_rate(spans, 1.0, 4.5) == pytest.approx(
        (50 + 50 + 40) / 3.5)
    # a stall (no span) inside the window lowers the rate: 20 tokens in
    # 2 s of work, over the whole 4 s window
    assert stats.prorated_rate([(0.0, 1.0, 10), (3.0, 4.0, 10)], 0.0,
                               4.0) == pytest.approx(5.0)
    with pytest.raises(ValueError):
        stats.prorated_rate(spans, 1.0, 1.0)


def test_trace_reduction_by_hand():
    from gpubench import trace

    spans = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.8)]
    assert trace.union_length(spans) == 4.0
    assert trace.gaps(spans, -1.0, 7.0) == [(-1.0, 0.0), (3.0, 5.0),
                                            (6.0, 7.0)]
    assert trace.gaps(spans, 0.5, 2.5) == []
    for name, short in (
            ("void (anonymous namespace)::paged_decode_split_kernel"
             "<__nv_bfloat16, 128>(Params)", "paged_decode_split_kernel"),
            ("void flash_fwd_tc_kernel<128>(__nv_bfloat16 const*, int)",
             "flash_fwd_tc_kernel"),
            ("void at::native::vectorized_elementwise_kernel<4, at::native::"
             "FillFunctor<float>, std::array<char*, 1ul> >(int)",
             "vectorized_elementwise_kernel"),
            ("Memcpy HtoD (Pageable -> Device)",
             "Memcpy HtoD (Pageable -> Device)")):
        assert trace.short_name(name) == short
    tr = {"kernels": {"a": 1.0, "b": 3.0}, "gaps": [(0.0, 0.5), (1.0, 3.0)]}
    assert trace.breakdown(tr, lambda a, b: f"{a}") == {
        "device_ops": [["b", 3.0], ["a", 1.0]],
        "idle_gaps": [["1.0", 2.0], ["0.0", 0.5]]}


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def _event(name, a, b):
    from types import SimpleNamespace

    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import Interval

    return SimpleNamespace(name=name, device_type=DeviceType.CUDA,
                           time_range=Interval(a, b))


@pytest.mark.parametrize("dropped", [None, "first", "second"])
def test_slice_edges_by_marker_length(dropped):
    """The slice lies between the short first marker and the long second
    one; where the tracer dropped one, the other and the host's interval
    between the two launches (here 1,000 us) give both edges."""
    from gpubench import trace

    marks = {"first": _event("void spin_kernel(long)", 100.0, 101.0),
             "second": _event("void spin_kernel(long)", 1100.0, 1111.0)}
    events = [_event("void flash_fwd_tc_kernel<128>(int)", 50.0, 90.0),
              _event("void flash_fwd_tc_kernel<128>(int)", 200.0, 500.0),
              _event("void paged_decode_split_kernel<128>(int)", 600.0,
                     700.0),
              _event("void at::native::fill(int)", 1200.0, 1210.0)]
    events += [m for k, m in marks.items() if k != dropped]
    sl = trace.Slice("cpu")
    sl.prof, sl.host_marks, sl.stop_s = _Prof(events), [5.0, 5.001], 0.0
    out = sl.read()
    lo, hi = {None: (101.0, 1100.0), "first": (100.0, 1100.0),
              "second": (101.0, 1100.0)}[dropped]
    assert out["window_s"] == pytest.approx((hi - lo) / 1e6)
    assert out["busy_s"] == pytest.approx(400e-6)
    assert out["kernels"] == pytest.approx(
        {"flash_fwd_tc_kernel": 300e-6, "paged_decode_split_kernel": 100e-6})
