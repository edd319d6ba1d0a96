"""The traffic generator: seeds change the order, never the work; the mixes
carry Table 5's classes and weights as the port has them."""
import json

import pytest

from servebench.traffic import generator
from servebench import window


@pytest.mark.parametrize("name", ["sd3_medium"])
def test_open_schedule_repeats_for_a_seed(name):
    mix = generator.load(name)
    a = generator.open_schedule(mix, 2 ** 31 + 12345, 51.0)
    b = generator.open_schedule(mix, 2 ** 31 + 12345, 51.0)
    assert a == b
    assert a != generator.open_schedule(mix, 2 ** 31 + 12346, 51.0)


@pytest.mark.parametrize("name", ["sd3_medium"])
def test_open_schedule_same_work_for_every_seed(name):
    mix = generator.load(name)
    runs = [generator.open_schedule(mix, s, 51.0) for s in (1, 2, 3_000_000_007)]
    rate = mix["load"] * mix["knee_per_s"]
    for items in runs:
        assert len(items) == round(rate * 51.0)
        assert all(0 < it.due < 51.0 for it in items)
        assert [it.due for it in items] == sorted(it.due for it in items)
    kinds = [sorted((it.resolution, it.seconds) for it in items) for items in runs]
    gaps = [sorted([items[0].due] + [b.due - a.due for a, b in zip(items, items[1:])])
            for items in runs]
    assert kinds[0] == kinds[1] == kinds[2]
    assert max(abs(x - y) for x, y in zip(gaps[0], gaps[2])) < 1e-6


def test_class_counts_follow_weights():
    mix = generator.load("sd3_medium")
    counts = generator.class_counts(mix, 80)
    assert counts == [40, 10, 10, 10, 10]
    assert sum(generator.class_counts(mix, 81)) == 81


def test_closed_sequence_blocks():
    mix = generator.load("flux_hires")
    seq = generator.closed_sequence(mix, 99)
    first = [next(seq) for _ in range(8)]
    for i in range(0, 8, 2):
        assert sorted(first[i:i + 2]) == [(1024, 0.0), (2048, 0.0)]
    seq2 = generator.closed_sequence(mix, 99)
    assert [next(seq2) for _ in range(8)] == first


@pytest.mark.parametrize("name,pipeline,level,drop", [
    ("sd3_medium", "sd3", "medium", ()),
    ("sd3_saturated", "sd3", "medium", ()),
])
def test_mix_weights_equal_table5(name, pipeline, level, drop):
    from repro_torch.core.workloads import MIXES, SLO_SCALE
    mix = generator.load(name)
    want = [((res, float(sec)), w) for (res, sec), w in MIXES[pipeline][level] if res not in drop]
    got = [((c["resolution"], float(c["seconds"])), c["weight"]) for c in mix["classes"]]
    assert sorted(got) == sorted(want)
    assert generator.SLO_SCALE == SLO_SCALE


def test_hires_classes_are_flux_medium_heaviest_weights():
    from repro_torch.core.workloads import MIXES
    top = [cls for cls, w in MIXES["flux"]["medium"] if w == 2]
    mix = generator.load("flux_hires")
    assert sorted((c["resolution"], c["seconds"]) for c in mix["classes"]) == sorted(top)
    assert {c["weight"] for c in mix["classes"]} == {1}


@pytest.mark.parametrize("name", ["sd3_medium", "sd3_saturated", "flux_hires"])
def test_every_class_has_its_standalone_latency(name):
    mix = generator.load(name)
    for c in mix["classes"]:
        assert generator.slo_s(mix, c["resolution"], float(c["seconds"])) == \
            pytest.approx(2.5 * c["standalone_s"])
        assert c["standalone_s"] > 0
    json.dumps(mix)


@pytest.mark.parametrize("name", ["sd3_medium", "sd3_saturated", "flux_hires"])
def test_sample_holds_one_request_of_each_class(name):
    mix = generator.load(name)
    keep = window.sample(mix, 2 ** 31 + 7, 51.0)
    assert len(keep) == len(mix["classes"])
    assert keep == window.sample(mix, 2 ** 31 + 7, 51.0)


def test_open_schedule_spreads_each_class_over_blocks():
    mix = generator.load("sd3_medium")
    items = generator.open_schedule(mix, 2 ** 31 + 9, 51.0)
    block = sum(c["weight"] for c in mix["classes"])
    for i in range(0, len(items) - block + 1, block):
        kinds = sorted(it.resolution for it in items[i:i + block])
        assert kinds == sorted(c["resolution"] for c in mix["classes"]
                               for _ in range(c["weight"]))


def test_open_schedule_blocks_span_alike_for_every_seed():
    mix = generator.load("sd3_medium")
    size = sum(c["weight"] for c in mix["classes"])
    rate = mix["load"] * mix["knee_per_s"]
    for seed in (1, 2, 2 ** 31 + 3):
        items = generator.open_schedule(mix, seed, 51.0)
        ends = [0.0] + [items[i + size - 1].due for i in range(0, len(items) - size + 1, size)]
        spans = [b - a for a, b in zip(ends, ends[1:])]
        assert all(0.7 * size / rate < s < 1.3 * size / rate for s in spans), spans
