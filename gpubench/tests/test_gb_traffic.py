"""The traffic generator: seeded, clipped, and the same sizes for every
seed, in the mix's order or the seed's."""

from __future__ import annotations

import json
from collections import Counter
from pathlib import Path

from gpubench import traffic

MIXES = Path(__file__).parent.parent / "traffic"


def _mix(name):
    return json.loads((MIXES / f"{name}.json").read_text())


def test_same_seed_same_requests():
    mix = dict(_mix("rag_long_context"), requests=40)
    a = traffic.make_requests(mix, 2**33 + 5, 32768)
    b = traffic.make_requests(mix, 2**33 + 5, 32768)
    c = traffic.make_requests(mix, 2**33 + 6, 32768)
    assert [(r.prompt_ids, r.max_tokens) for r in a] == \
        [(r.prompt_ids, r.max_tokens) for r in b]
    assert [r.prompt_ids for r in a] != [r.prompt_ids for r in c]


def test_lengths_clipped_and_ids_in_range():
    for name, vocab in (("rag_long_context", 32768), ("batch_short", 32000)):
        mix = dict(_mix(name), requests=64)
        for r in traffic.make_requests(mix, 7, vocab):
            p, o = mix["prompt_tokens"], mix["output_tokens"]
            assert p["min"] <= len(r.prompt_ids) <= p["max"]
            assert o["min"] <= r.max_tokens <= o["max"]
            assert 0 <= min(r.prompt_ids) and max(r.prompt_ids) < vocab
    dist = {"dist": "lognormal", "median": 100, "sigma": 3.0, "min": 50,
            "max": 150}
    assert traffic.quantile(dist, 0.001) == 50
    assert traffic.quantile(dist, 0.999) == 150
    assert traffic.quantile(dist, 0.5) == 100


def test_every_seed_gets_the_same_sizes_in_the_same_order():
    mix = dict(_mix("rag_long_context"), requests=64)
    runs = [traffic.make_requests(mix, s, 32768) for s in (1, 2, 2**40)]
    for rs in runs[1:]:
        assert [(len(r.prompt_ids), r.max_tokens) for r in rs] == \
            [(len(r.prompt_ids), r.max_tokens) for r in runs[0]]
    # each block of `strata` requests holds the whole set of slices, in
    # an order of the mix's own
    blocks = [sorted(len(r.prompt_ids) for r in runs[0][i:i + 16])
              for i in (0, 16, 32)]
    assert blocks[0] == blocks[1] == blocks[2]
    assert Counter(r.max_tokens for r in runs[0][:16]) == \
        Counter(r.max_tokens for r in runs[0][16:32])
    assert [len(r.prompt_ids) for r in runs[0][:16]] != \
        [len(r.prompt_ids) for r in runs[0][16:32]]
    other = traffic.make_requests(dict(mix, order_seed=1), 1, 32768)
    assert [len(r.prompt_ids) for r in other] != \
        [len(r.prompt_ids) for r in runs[0]]


def test_a_mix_without_order_seed_takes_its_order_from_the_run_seed():
    mix = dict(_mix("batch_short"), requests=64)
    assert mix["order_seed"] is None
    a = traffic.make_requests(mix, 2**31 + 9, 32000)
    b = traffic.make_requests(mix, 2**33 + 1, 32000)
    assert [(r.prompt_ids, r.max_tokens) for r in a] == \
        [(r.prompt_ids, r.max_tokens)
         for r in traffic.make_requests(mix, 2**31 + 9, 32000)]
    strata = mix["strata"]
    for i in range(0, 64, strata):
        # the same sizes in every block, in another order
        assert sorted(len(r.prompt_ids) for r in a[i:i + strata]) == \
            sorted(len(r.prompt_ids) for r in b[i:i + strata])
        assert Counter(r.max_tokens for r in a[i:i + strata]) == \
            Counter(r.max_tokens for r in b[i:i + strata])
    assert [len(r.prompt_ids) for r in a] != [len(r.prompt_ids) for r in b]
