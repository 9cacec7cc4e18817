"""The port's span and count recorder (``utils/spans.py``) on the CPU.

Nothing is kept, and nothing allocated, unless a ``torch.profiler``
records.  Under one, a CLI call keeps one ``cli.call`` root with its
layers' spans below it, the prefetch thread's included (same call, the
span it was started under as parent); ``--trace`` writes each span into
the Chrome trace as a ``user_annotation`` on the recorder's interval;
``take`` clears; the cap counts what it drops; and each K2 launch counts
its least bytes by mode."""

import json
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from orion_kmer_tpu_torch import cli, engine, host
from orion_kmer_tpu_torch.ops import merge
from orion_kmer_tpu_torch.utils import spans

from .test_torch_devices import _meta, recorder  # noqa: F401  (a fixture)
from .util import write_file

K = 21


@pytest.fixture
def reads(tmp_path):
    rng = np.random.default_rng(15)
    text = "".join(f"@r{i}\n{''.join(rng.choice(list('ACGTN'), 150, p=[0.249] * 4 + [0.004]))}\n+\n{'I' * 150}\n"
                   for i in range(300))
    return write_file(tmp_path / "reads.fq", text)


@pytest.fixture
def clean():
    spans.take()
    yield
    spans.take()


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


def test_nothing_is_kept_or_allocated_while_nothing_records(clean):
    assert not spans.recording()
    assert spans.span("a") is spans.span("b", bytes=3) is spans.NULL
    with spans.span("a") as sp:
        sp.add("positions", 5)
        spans.count("k2.bytes", 16)
    assert spans.take() == ([], {})

    def calls(n):
        for _ in range(n):
            with spans.span("engine.wait"):
                spans.count("k2.bytes", 16)

    calls(10)
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        calls(20_000)
        after, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert after - before <= 256 and peak - before <= 1024, (before, after, peak)


def test_take_clears_and_the_cap_counts_what_it_drops(clean, monkeypatch, caplog):
    monkeypatch.setattr(spans, "CAP", 3)
    with caplog.at_level("WARNING", logger="orion_kmer_tpu_torch.spans"), _profiled():
        assert spans.recording()
        for i in range(5):
            with spans.span(f"s{i}"):
                pass
        spans.count("loose", 2)
    got = spans.take()
    assert [s.name for s in got.spans] == ["s0", "s1", "s2"]
    assert got.counts == {"loose": 2, spans.DROPPED: 2}
    assert [r.getMessage() for r in caplog.records] == [
        f"spans: 3 kept and none taken; dropping the rest (counted under {spans.DROPPED})"]  # once
    assert spans.take() == ([], {})


def test_a_span_nests_and_a_count_lands_in_the_innermost(clean):
    with _profiled():
        with spans.span("outer", bytes=4) as outer:
            with spans.span("inner") as inner:
                spans.count("k2.bytes", 16)
                inner.add("positions", 3)
            spans.count("k2.bytes", 1)
            outer.add("bytes", 1)
    inner, outer = spans.take().spans
    assert (inner.name, outer.name) == ("inner", "outer")
    assert inner.parent == outer.id and outer.parent is None and inner.call == outer.call == outer.id
    assert inner.counts == {"k2.bytes": 16, "positions": 3} and outer.counts == {"bytes": 5, "k2.bytes": 1}
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns


def _stream_positions(path):
    return sum(p.codes.shape[0] for p in host.native_chunks(path, K))


@pytest.mark.parametrize("batch", [None, 4096])
def test_a_count_keeps_its_layers_under_one_call(clean, monkeypatch, tmp_path, reads, batch):
    if batch is not None:  # several batches, each after the first with its halo
        monkeypatch.setenv("ORION_KMER_BATCH", str(batch))
    with _profiled():
        rc = cli.main(["--device", "cpu", "count", "-k", K, "-i", reads, "-o", tmp_path / "o.tsv",
                       "-m", 2, "--histogram", tmp_path / "h.txt"])
    assert rc == 0
    got = spans.take().spans
    by = {}
    for s in got:
        by.setdefault(s.name, []).append(s)
    (root,), (count_file,) = by["cli.call"], by["engine.count_file"]
    assert {"engine.wait", "ingest.parse", "engine.update", "engine.flush", "engine.fetch", "count.tail"} <= set(by)
    assert all(s.call == root.id for s in got)
    assert count_file.parent == root.id and by["count.tail"][0].parent == root.id
    for s in by["ingest.parse"]:
        assert s.thread_name == "okt-prefetch" and s.thread != root.thread
        assert s.parent == count_file.id
    assert all(s.parent == count_file.id and s.thread == root.thread for s in by["engine.wait"])
    assert sum(s.counts.get("positions", 0) for s in by["ingest.parse"]) == _stream_positions(reads)
    n_updates = len(by["engine.update"])
    assert n_updates == 1 if batch is None else n_updates > 5
    distinct = engine.count_file(reads, K, "cpu")[0].shape[0]
    assert sum(s.counts["bytes"] for s in by["engine.fetch"]) == 16 * distinct  # both planes, 8 B each


def test_build_and_query_keep_their_layers(clean, tmp_path, reads):
    genome = write_file(tmp_path / "g.fa", ">g\n" + "ACGTTGCAAGGCTTAACG" * 20 + "\n")
    db = tmp_path / "g.db"
    with _profiled():
        assert cli.main(["--device", "cpu", "build", "-k", K, "-g", genome, reads, "-o", db]) == 0
        assert cli.main(["--device", "cpu", "query", "-d", db, "-r", reads, "-c", 1, "-o", tmp_path / "ids"]) == 0
    got = spans.take().spans
    build, query = sorted((s for s in got if s.name == "cli.call"), key=lambda s: s.start_ns)
    names = {c.id: sorted({s.name for s in got if s.call == c.id}) for c in (build, query)}
    assert names[build.id] == ["cli.call", "db.add", "db.save", "db.union", "engine.count_file", "engine.fetch",
                               "engine.flush", "engine.update", "engine.wait", "ingest.parse"]
    assert names[query.id] == ["cli.call", "db.load", "db.union", "engine.wait", "ingest.parse", "query.tail"]
    assert sum(s.name == "engine.count_file" for s in got if s.call == build.id) == 2
    assert sum(s.name == "db.add" for s in got if s.call == build.id) == 2
    (save,) = [s for s in got if s.name == "db.save"]
    assert save.parent == build.id and save.counts == {"bytes": db.stat().st_size}
    parsed = sum(s.counts.get("positions", 0) for s in got if s.call == query.id and s.name == "ingest.parse")
    assert parsed == sum(p.codes.shape[0] for p in host.native_chunks(reads, K, normalize=False))


def test_the_trace_holds_each_span_on_its_interval(clean, monkeypatch, tmp_path, reads):
    """``--trace``: every span, the prefetch thread's too, is a
    ``user_annotation`` of its name on the recorder's interval, within
    1 ms on the trace's clock.  The range opens before the span's clock is
    read and closes after, so a stall of a busy host between the two
    reads only widens the annotation: every one holds its span, and nine
    in ten agree at both ends."""
    taken = []
    real_take = spans.take
    monkeypatch.setattr(spans, "take", lambda: taken.append(real_take()) or taken[-1])
    monkeypatch.setenv("ORION_KMER_BATCH", "4096")
    rc = cli.main(["--device", "cpu", "--trace", tmp_path / "trace", "count", "-k", K, "-i", reads,
                   "-o", tmp_path / "o.tsv"])
    assert rc == 0
    (got,) = taken
    (path,) = (tmp_path / "trace").iterdir()
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    assert len(events) == len(got.spans) > 10
    pairs = []  # the i-th span of a name and the i-th annotation of that name
    for name in {s.name for s in got.spans}:
        mine = sorted((s for s in got.spans if s.name == name), key=lambda s: s.start_ns)
        theirs = sorted((e for e in events if e["name"] == name), key=lambda e: e["ts"])
        assert len(mine) == len(theirs), name
        pairs += zip(mine, theirs)
    offset_us = np.median([e["ts"] - s.start_ns / 1e3 for s, e in pairs])
    close = 0
    for s, e in pairs:
        early = s.start_ns / 1e3 + offset_us - e["ts"]  # how far the range opens before the span
        late = e["ts"] + e["dur"] - (s.end_ns / 1e3 + offset_us)  # and closes after it
        assert early > -1000 and late > -1000, (s, e)
        close += abs(early) < 1000 and abs(late) < 1000
    assert close >= 0.9 * len(pairs)


@pytest.mark.parametrize("mode,call,per_key", [
    ("keys", lambda: merge.merge(_meta(8), _meta(5)), 16),
    ("payload", lambda: merge.merge(_meta(8), _meta(5), _meta(8), _meta(5)), 32),
    ("fold", lambda: merge.merge_combine(_meta(8), _meta(5), _meta(8), _meta(5)), 33),
])
def test_k2_counts_its_least_bytes_by_mode(clean, recorder, mode, call, per_key):  # noqa: F811
    call()  # nothing records
    with _profiled():
        call()
        with spans.span("engine.update") as sp:
            call()
        merge.merge(_meta(0), _meta(0))  # no launch, no bytes
    assert spans.take().counts == {"k2.bytes": 13 * per_key}
    assert sp.counts == {"k2.bytes": 13 * per_key}
    assert [n for n, _ in recorder.calls] == ["okt_merge"] * 3


def test_no_span_outlives_a_failed_call(clean, tmp_path):
    """A call that fails still closes every span it opened."""
    with _profiled():
        rc = cli.main(["--device", "cpu", "count", "-k", K, "-i", tmp_path / "missing.fq", "-o", tmp_path / "o"])
    assert rc == 1
    got = spans.take().spans
    assert [s.name for s in got][-1] == "cli.call" and spans._current.get() is None
    assert torch.autograd.profiler._is_profiler_enabled is False
