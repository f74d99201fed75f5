"""The readers of the program's own regions, on hand-built profiles: each
reads its regions' time or count a batch, a step or a share of the
window, and reads nothing from a profile without them (a program that
lacks the regions)."""

import pytest

from portbench.harness import common, spans
from portbench.harness.trace import Profile


def reader(name):
    return common.load_module(common.BENCH / "layer_metrics" / f"{name}.py")


def profile(events, units=2, window_s=0.01):
    """Host events (name, start us, end us) on a 10 ms window."""
    return Profile(window_s=window_s, ops=[], host=[(s, e, name) for name, s, e in events], units=units)


QUERY = [
    ("text/process_query", 0, 10), ("text/process_query", 10, 30), ("search/stage_inputs", 30, 130),
    ("search/topk", 200, 900), ("search/topk_sync", 300, 340), ("search/topk_sync", 500, 560),
    ("search/topk_sync", 700, 800), ("search/result_wait", 1000, 1400), ("search/answers", 1400, 1700),
    ("text/process_query", 2000, 2030), ("search/stage_inputs", 2030, 2100), ("search/topk_sync", 2300, 2310),
    ("search/result_wait", 3000, 3200), ("search/answers", 3200, 3300), ("aten::copy_", 0, 5000),
]
ENCODE = [("index/next_batch", 0, 2000), ("index/encode", 2000, 2500), ("index/scores_to_host", 2500, 3500),
          ("index/write", 3500, 6000), ("index/next_batch", 6000, 6500)]
TRAIN = [("train/next_batch", 0, 500), ("train/put_batch", 500, 1500), ("train/forward", 1500, 2000),
         ("train/step_end", 2500, 4500), ("train/next_batch", 4500, 4700), ("train/put_batch", 4700, 5000),
         ("train/step_end", 6000, 6500), ("train/next_batch", 7000, 7100)]

CASES = [
    ("prep_ms.query", QUERY, (10 + 20 + 100 + 30 + 70) / 1e3 / 2),
    ("topk_syncs.query", QUERY, 4 / 2),
    ("blocked_ms.query", QUERY, (40 + 60 + 100 + 400 + 10 + 200) / 1e3 / 2),
    ("answers_ms.query", QUERY, (300 + 100) / 1e3 / 2),
    ("tokenize_wait.encode", ENCODE, 100 * 2500e-6 / 0.01),
    ("write.encode", ENCODE, 100 * 2500e-6 / 0.01),
    ("scores_wait.encode", ENCODE, 100 * 1000e-6 / 0.01),
    ("batch_wait_ms.train", TRAIN, (500 + 200 + 100) / 1e3 / 2),
    ("put_batch_ms.train", TRAIN, (1000 + 300) / 1e3 / 2),
    ("step_end_ms.train", TRAIN, (2000 + 500) / 1e3 / 2),
]


@pytest.mark.parametrize("name,events,want", CASES, ids=[c[0] for c in CASES])
def test_reader_reads_its_regions(name, events, want):
    assert reader(name).read({"profile": profile(events)}) == pytest.approx(want)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_reader_reads_nothing_without_its_regions(name):
    read = reader(name).read
    assert read({}) is None
    # the parent's program: the benchmark's own spans and torch's, none of the program's
    parent = [("portbench/stage_inputs", 0, 100), ("portbench/topk", 100, 900), ("train/forward", 0, 50),
              ("train/optimizer", 50, 60), ("aten::copy_", 0, 10)]
    assert read({"profile": profile(parent)}) is None


def test_a_missing_region_reads_nothing():
    only_prep = [("text/process_query", 0, 10)]
    assert spans.totals(profile(only_prep), ("text/process_query", "search/stage_inputs")) is None
    assert spans.totals(profile(only_prep), ("text/process_query",)) == (pytest.approx(1e-5), 1)
    assert spans.ms_per_unit(profile(only_prep, units=0), ("text/process_query",)) is None
