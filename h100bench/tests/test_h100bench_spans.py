"""The per-layer metrics read from the port's own spans: a traced tiny run
of each cell reads every one as a number (but K2's roofline, which needs
the card); the clock mapping is checked against the harness's call
ranges; the device's idle time is put down to the innermost span on the
CLI's thread; a port that keeps no spans reads None."""

import json
import sys
from types import SimpleNamespace

import pytest

from h100bench.harness import spans
from h100bench.harness.manifest import Manifest
from h100bench.tests.helpers import ROOT, cells, run_tiny

# the per-layer metrics read from the port's spans
NEW = ["wait_s_per_gbp.count", "parse_wait_s_per_gbp.count", "count_file_s_per_gbp.count",
       "count_tail_s_per_gbp.count", "idle_wait_s_per_gbp.count",
       "count_file_ms_per_file.build", "db_union_s.build", "db_save_s.build", "idle_union_s.build",
       "late_wait_s_per_gbp.query", "query_tail_s_per_gbp.query"]
IDLE = ["idle_wait_s_per_gbp.count", "idle_union_s.build"]  # the device's idle time by span
# spans that the CPU never opens, so their metrics read 0 there: no batch
# staged into a pinned ring (ingest.stage), no copy event waited on
# (query.late_wait)
NONE_ON_THE_CPU = ["stage_s_per_gbp.count", "late_wait_s_per_gbp.query"]
CARD_ONLY = ["k2_roofline.count", "k2_roofline.query", "fetch_gb_per_s.count"]  # no merge_kernel and no copy on the CPU


def span_metrics(cell: str) -> list[str]:
    return [m["name"] for m in Manifest(ROOT).metrics_of("per_layer", cell) if m["name"] in NEW + NONE_ON_THE_CPU]


@pytest.mark.parametrize("cell", [c for c in cells() if span_metrics(c)])
def test_a_traced_run_reads_every_span_metric(cell, capfd):
    r = run_tiny(cell, trace=True)
    assert r["correct"] is True
    for name in span_metrics(cell):
        value = r["metrics"][name]["value"]
        assert isinstance(value, float) and (value == 0.0 if name in NONE_ON_THE_CPU else value > 0), (name, value)
    assert not set(CARD_ONLY) & set(r["metrics"])
    # a cell with an idle metric sends the idle split by span, and the
    # share of it named, to standard error
    lines = [x for x in capfd.readouterr().err.splitlines() if "idle by span" in x]
    assert len(lines) == bool(set(IDLE) & set(span_metrics(cell)))
    for line in lines:
        named = float(line.split("(")[1].split(" %")[0])
        assert 50 <= named <= 100, line


# query-c10's host-side readers: listed for no cell, since the cell holds
# no host end-to-end metric for them to move (its host CPU time a call
# spreads too wide on the shared hosts)
QUERY_HOST = {"wall_windows_per_s.query": ("commands", "host_clock"),
              "db_load_s.query": ("host DB model", "host_clock"), "join_s_per_gbp.query": ("joins", "host_clock"),
              "late_wait_s_per_gbp.query": ("joins", "program_span"),
              "query_tail_s_per_gbp.query": ("joins", "program_span")}


def test_the_query_host_metrics_read_once_listed(tmp_path):
    """A ``BENCHMARK.json`` that gives query-c10 ``host_cpu_s_per_gbp``
    and lists its host-side readers, beside this ``h100bench/``, reads
    every one of them in a traced run."""
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert not set(QUERY_HOST) & {m["name"] for m in data["per_layer"]}
    next(m for m in data["end_to_end"] if m["name"] == "host_cpu_s_per_gbp")["workloads"].append("query-c10")
    data["per_layer"] += [{"name": n, "unit": "-", "better": "lower", "source": source, "layer": layer,
                           "moves": "host_cpu_s_per_gbp", "workloads": ["query-c10"]}
                          for n, (layer, source) in QUERY_HOST.items()]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    (tmp_path / "h100bench").symlink_to(ROOT / "h100bench", target_is_directory=True)
    r = run_tiny("query-c10", root=tmp_path, trace=True)
    assert r["correct"] is True
    for name in QUERY_HOST:
        value = r["metrics"][name]["value"]
        assert isinstance(value, float) and (value == 0.0 if name in NONE_ON_THE_CPU else value > 0), (name, value)


def test_a_port_without_spans_reads_none(monkeypatch):
    import orion_kmer_tpu_torch.utils

    # the import of the recorder fails, as in a port from before it
    monkeypatch.delattr(orion_kmer_tpu_torch.utils, "spans")
    monkeypatch.setitem(sys.modules, "orion_kmer_tpu_torch.utils.spans", None)
    r = run_tiny("count-k31", trace=True)
    assert r["correct"] is True
    assert not set(NEW + NONE_ON_THE_CPU) & set(r["metrics"])
    assert "parse_mbp_per_s.count" in r["metrics"]


def Span(name, id, parent, start, end, thread=1, counts=None):
    """A recorder span; times in seconds, kept in ns."""
    return SimpleNamespace(name=name, id=id, call=1, parent=parent, thread=thread, thread_name="t",
                           start_ns=round(start * 1e9), end_ns=round(end * 1e9), counts=counts or {})


def _ctx(recorded, calls, busy=(), start=100.0, end=110.0, lo=5.0):
    taken = SimpleNamespace(spans=recorded, counts={})
    ctx = SimpleNamespace(memo={}, window=SimpleNamespace(start=start, end=end, calls=len(calls)),
                          trace=SimpleNamespace(lo=lo, hi=lo + end - start, calls=calls, busy=list(busy)))
    return ctx, taken


@pytest.mark.parametrize("late_s,ok", [(0.0, True), (0.0009, True), (-0.0009, True), (0.0011, False)])
def test_the_mapping_is_checked_against_the_call_ranges(monkeypatch, late_s, ok):
    from orion_kmer_tpu_torch.utils import spans as recorder

    # the window from 100 s to 110 s on the monotonic clock, 5 s to 15 s on the trace's
    recorded = [Span("cli.call", 1, None, 101.0 + late_s, 102.0), Span("cli.call", 2, None, 103.0, 104.0)]
    ctx, taken = _ctx(recorded, [(6.0, 7.1), (8.0, 9.1)])
    monkeypatch.setattr(recorder, "take", lambda: taken)
    view = spans.of(ctx)
    assert (view is not None) is ok
    assert spans.of(ctx) is view  # taken once a run
    if ok:
        assert view.interval(recorded[1]) == pytest.approx((8.0, 9.0))


def test_a_recording_that_dropped_spans_reads_none(monkeypatch):
    from orion_kmer_tpu_torch.utils import spans as recorder

    recorded = [Span("cli.call", 1, None, 101.0, 102.0)]
    ctx, taken = _ctx(recorded, [(6.0, 7.1)])
    taken.counts[recorder.DROPPED] = 1
    monkeypatch.setattr(recorder, "take", lambda: taken)
    assert spans.of(ctx) is None


def test_the_idle_metrics_read_the_split_a_call(monkeypatch):
    from orion_kmer_tpu_torch.utils import spans as recorder

    # two calls, 1 s each; the card busy 0.2 s of the first call's wait
    recorded = [Span("cli.call", 1, None, 101.0, 102.0), Span("engine.wait", 2, 1, 101.0, 101.5),
                Span("cli.call", 3, None, 103.0, 104.0), Span("engine.wait", 4, 3, 103.0, 103.5),
                Span("ingest.parse", 5, 2, 101.0, 101.5, thread=2, counts={"positions": 7})]
    ctx, taken = _ctx(recorded, [(6.0, 7.0), (8.0, 9.0)], busy=[(6.1, 6.3)])
    monkeypatch.setattr(recorder, "take", lambda: taken)
    assert spans.idle_s_a_call(ctx, "engine.wait") == pytest.approx((0.3 + 0.5) / 2)
    assert spans.idle_s_a_call(ctx, "db.union") == 0.0  # no such span in the window
    assert spans.of(ctx).count("positions", "ingest.parse") == 7


def test_idle_time_goes_to_the_innermost_span_on_the_cli_thread():
    recorded = [
        Span("cli.call", 1, None, 0.0, 10.0),
        Span("engine.count_file", 2, 1, 1.0, 8.0),
        Span("engine.wait", 3, 2, 1.0, 3.0),
        Span("ingest.parse", 4, 2, 1.0, 7.0, thread=2),  # another thread: not the CLI's
        Span("count.tail", 5, 1, 8.0, 9.5),
    ]
    view = spans.Spans(recorded, 0.0)
    # the card busy 2-4 s and 8.5-9 s of a call from 0 to 10.5 s
    split = view.idle_by_span([(2.0, 4.0), (8.5, 9.0)], [(0.0, 10.5)])
    assert split == pytest.approx({"engine.wait": 1.0, "engine.count_file": 4.0, "count.tail": 1.0,
                                   spans.UNNAMED: 2.0})  # 0-1 s and 9.5-10.5 s: cli.call's own, and past it
    assert view.self_s("engine.count_file") == pytest.approx(1.0)  # 7 s less the union of 1-3 and 1-7
    assert view.total_s("engine.wait") == pytest.approx(2.0)


def test_idle_inside_the_calls_only():
    busy = [(0.5, 1.0), (2.0, 3.0), (5.0, 6.0)]
    assert spans.idle_in(busy, [(0.0, 2.5), (4.0, 7.0)]) == [(0.0, 0.5), (1.0, 2.0), (4.0, 5.0), (6.0, 7.0)]
    assert spans.idle_in([], [(1.0, 2.0)]) == [(1.0, 2.0)]
