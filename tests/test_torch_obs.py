"""The port's observability (fastapriori_tpu_torch/obs/) against the JAX
package's, on the CPU: the span tracer's determinism, ids, thread roots,
schema, export, disabled cost and event cap; the fetch-site census;
the metrics registry's bucket exactness, snapshot and labelled fetch
histogram (rendered byte for byte as the JAX package renders them); the
flight recorder's ring, its knob, ledger events in the ring and its
dumps (an injected watchdog timeout, the abandoned-thread cap, a prefix
required); the MetricsLogger bound, ``phase_timer`` and ``timed`` as
spans; the device-trace parser and capture; and the traced CLI of both
packages on one seeded corpus: equal bytes, ``run`` -> ``phase`` ->
``mine`` -> ``level`` with the same levels, valid traces; the CLI job's
span frame (``job_setup``, ``read_users``, each ``write`` with its
``fsync``, ``pair_program`` under ``bitmap_build``) and an untraced job
recording nothing."""

import ast
import gzip
import json
import os
import threading
import time

import numpy as np
import pytest

from conftest import random_dataset, tokenized
from fastapriori_tpu.cli import main as jax_main
from fastapriori_tpu.obs import metrics as jax_metrics
from fastapriori_tpu.obs import trace as jax_trace
from fastapriori_tpu.obs.trace import FETCH_SITE_SPANS as JAX_FETCH_SITES
from fastapriori_tpu_torch.cli import main as torch_main
from fastapriori_tpu_torch.config import MinerConfig
from fastapriori_tpu_torch.errors import InputError
from fastapriori_tpu_torch.models.apriori import FastApriori
from fastapriori_tpu_torch.obs import device_trace, flight, metrics, trace
from fastapriori_tpu_torch.obs.flight import FlightRecorder
from fastapriori_tpu_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from fastapriori_tpu_torch.obs.trace import (
    FETCH_SITE_SPANS,
    TRACER,
    Tracer,
    validate_chrome_trace,
)
from fastapriori_tpu_torch.preprocess import preprocess
from fastapriori_tpu_torch.reliability import (
    failpoints,
    ledger,
    retry,
    watchdog,
)
from fastapriori_tpu_torch.utils import logging as fa_logging
from fastapriori_tpu_torch.utils.datagen import (
    generate_transactions,
    generate_user_baskets,
)
from fastapriori_tpu_torch.utils.logging import MetricsLogger, phase_timer
from test_torch_e2e import JAX_FLAGS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "fastapriori_tpu_torch")


def _reset():
    failpoints.disarm_all()
    ledger.reset()
    for tr in (TRACER, jax_trace.TRACER):
        tr.disable()
        tr.reset()
    flight.set_dump_prefix(None)
    flight.RECORDER.reset(flight.DEFAULT_RING)
    metrics.GLOBAL.reset()
    fa_logging._active = None


@pytest.fixture(autouse=True)
def _clean_state():
    _reset()
    yield
    _reset()


D_LINES = tokenized(random_dataset(31, n_txns=220, max_len=7))


def _mine_traced():
    TRACER.enable()
    data = preprocess(D_LINES, 0.05)
    cfg = MinerConfig(min_support=0.05, engine="level")
    FastApriori(config=cfg, device="cpu").mine_levels_raw(data)
    return TRACER.span_tree()


# ---------------------------------------------------------------------------
# tracer


def test_tracer_deterministic_span_tree_across_identical_runs():
    t1 = _mine_traced()
    t2 = _mine_traced()
    assert t1, "the traced mine recorded no spans"
    assert t1 == t2
    assert {"level", "fetch.level_bits"} <= {name for _, name, _ in t1}


def test_tracer_ids_count_per_parent_occurrence():
    tr = Tracer(100)
    tr.enable()
    with tr.span("run"):
        for _ in range(2):
            with tr.span("level"):
                with tr.span("fetch.x"):
                    pass
    sids = [s for s, _, _ in tr.span_tree()]
    assert "main:run#0/level#0" in sids
    assert "main:run#0/level#1" in sids
    assert "main:run#0/level#0/fetch.x#0" in sids
    # The second level's child restarts its own occurrence count.
    assert "main:run#0/level#1/fetch.x#0" in sids


def test_tracer_thread_roots_are_thread_named():
    tr = Tracer(100)
    tr.enable()

    def work():
        with tr.span("upload"):
            pass

    # Two threads, one after the other, under one name (each run's
    # uploader): the root count continues instead of repeating an id.
    for _ in range(2):
        t = threading.Thread(target=work, name="fa-upload_0")
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    assert tr.span_tree() == [("fa-upload_0:upload#0", "upload", None),
                              ("fa-upload_0:upload#1", "upload", None)]
    names = [e["args"]["name"] for e in tr.chrome_trace()["traceEvents"]
             if e["name"] == "thread_name"]
    assert names == ["fa-upload_0"]


def test_tracer_threads_do_not_share_stacks():
    tr = Tracer(10_000)
    tr.enable()
    barrier = threading.Barrier(4)

    def work(i):
        barrier.wait(timeout=10)
        for _ in range(50):
            with tr.span("outer", i=i):
                with tr.span("inner"):
                    pass

    threads = [threading.Thread(target=work, args=(i,), name=f"w{i}")
               for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    tree = tr.span_tree()
    assert len(tree) == 400
    for sid, name, parent in tree:
        root = sid.split(":")[0]
        if name == "inner":
            assert parent.startswith(root + ":outer#")


def test_chrome_trace_schema_validates():
    _mine_traced()
    obj = TRACER.chrome_trace()
    assert validate_chrome_trace(obj) == []
    assert validate_chrome_trace(json.loads(json.dumps(obj))) == []
    assert jax_trace.validate_chrome_trace(obj) == []
    phs = {e["ph"] for e in obj["traceEvents"]}
    assert "X" in phs and "M" in phs


def test_chrome_trace_schema_catches_malformed():
    assert validate_chrome_trace({"traceEvents": []})
    assert validate_chrome_trace({"notTraceEvents": 1})
    bad = {"traceEvents": [{"ph": "X", "name": "a", "pid": 1, "tid": 1,
                            "ts": -1, "dur": 1, "args": {"sid": "s"}}]}
    assert any("ts" in p for p in validate_chrome_trace(bad))
    bad = {"traceEvents": [{"ph": "X", "name": "a", "pid": 1, "tid": 1,
                            "ts": 1, "dur": 1, "args": {}}]}
    assert any("sid" in p for p in validate_chrome_trace(bad))


def test_tracer_export_is_committed_and_loadable(tmp_path):
    _mine_traced()
    manifest = {}
    path = TRACER.export(str(tmp_path / "out.trace.json"), manifest)
    with open(path) as fh:
        assert validate_chrome_trace(json.load(fh)) == []
    assert manifest["trace"]["bytes"] == os.path.getsize(path)
    assert not os.path.exists(path + ".tmp")


def test_tracer_disabled_records_nothing_and_is_cheap():
    assert not TRACER.enabled
    with trace.span("x", k=1) as sp:
        sp.update(a=1)
        trace.instant("y")
        trace.counter("z", v=1)
        trace.annotate(a=2)
    assert TRACER.events() == []
    assert trace.span("a") is trace.span("b")  # the shared no-op
    t0 = time.perf_counter()
    for _ in range(50_000):
        with trace.span("x"):
            pass
    assert (time.perf_counter() - t0) / 50_000 < 10e-6


def test_untraced_cli_job_records_nothing(traced_corpus, tmp_path):
    """A CLI job without ``--trace`` or ``FA_TRACE``: every new section
    (job_setup, read_users, write, fsync, pair_program) stays on the
    no-op path."""
    trace.reload_from_env()
    assert torch_main([traced_corpus, str(tmp_path / "o") + "/",
                       "--min-support", "0.02", "--platform", "cpu"]) == 0
    assert not TRACER.enabled
    assert TRACER.events() == []


def test_tracer_event_cap_counts_drops():
    tr = Tracer(max_events=3)
    tr.enable()
    for _ in range(5):
        with tr.span("s"):
            pass
    assert len(tr.events()) == 3
    assert tr.dropped == 2
    assert tr.chrome_trace()["otherData"]["dropped_events"] == 2


def test_tracer_event_cap_knob(monkeypatch):
    trace.reload_from_env()
    assert trace.max_events_from_env() == trace.DEFAULT_MAX_EVENTS
    monkeypatch.setenv("FA_TRACE_EVENTS", "5")
    trace.reload_from_env()
    tr = Tracer()
    assert tr.max_events == 5
    tr.enable()
    for _ in range(7):
        with tr.span("s"):
            pass
    assert len(tr.events()) == 5 and tr.dropped == 2
    assert TRACER.max_events == 5
    monkeypatch.setenv("FA_TRACE_EVENTS", "many")
    with pytest.raises(InputError, match="FA_TRACE_EVENTS"):
        trace.reload_from_env()
    monkeypatch.setenv("FA_TRACE_EVENTS", "0")
    with pytest.raises(InputError, match="out of range"):
        Tracer()
    # maybe_enable parses it on every run, recording or not.
    with pytest.raises(InputError, match="FA_TRACE_EVENTS"):
        trace.maybe_enable(False)
    monkeypatch.delenv("FA_TRACE_EVENTS")
    trace.reload_from_env()
    assert TRACER.max_events == trace.DEFAULT_MAX_EVENTS


def test_fa_trace_knob_is_strict(monkeypatch):
    monkeypatch.setenv("FA_TRACE", "sure")
    trace.reload_from_env()
    try:
        with pytest.raises(InputError, match="FA_TRACE"):
            trace.maybe_enable()
        monkeypatch.setenv("FA_TRACE", "1")
        trace.reload_from_env()
        assert trace.maybe_enable() is True
    finally:
        monkeypatch.delenv("FA_TRACE")
        trace.reload_from_env()


# ---------------------------------------------------------------------------
# audited fetches


def test_fetch_spans_cover_declared_sites():
    TRACER.enable()
    retry.fetch(lambda: np.arange(4), "level_bits")
    assert "fetch.level_bits" in {n for _, n, _ in TRACER.span_tree()}
    assert all(s.startswith("fetch.") for s in FETCH_SITE_SPANS)
    assert len(set(FETCH_SITE_SPANS)) == len(FETCH_SITE_SPANS)


def test_retry_annotations_land_on_fetch_span():
    TRACER.enable()
    failpoints.arm("fetch.level_bits", "oom*1")
    retry.fetch(lambda: np.arange(4), "level_bits",
                retry.RetryPolicy(base_delay_s=0.0))
    (sp,) = [e for e in TRACER.events() if e["ph"] == "X"]
    assert sp["name"] == "fetch.level_bits"
    assert sp["args"]["retries"] == 1
    # The ledger's retry landed as an instant under the fetch span.
    (inst,) = [e for e in TRACER.events() if e["name"] == "degraded"]
    assert inst["parent"] == sp["sid"] and inst["args"]["kind"] == "retry"


def test_retry_failure_annotates_span():
    TRACER.enable()
    failpoints.arm("fetch.level_bits", "oom*5")
    with pytest.raises(RuntimeError, match="RESOURCE_EXHAUSTED"):
        retry.fetch(lambda: np.arange(4), "level_bits",
                    retry.RetryPolicy(max_attempts=2, base_delay_s=0.0))
    (sp,) = [e for e in TRACER.events() if e["ph"] == "X"]
    assert sp["args"]["failed"] == "RuntimeError"
    assert sp["args"]["attempts"] == 2
    assert sp["args"]["error"] == "RuntimeError"


def test_fetch_latency_observed_per_site():
    retry.fetch(lambda: np.arange(4), "level_bits")
    retry.fetch(lambda: np.arange(4), "level_bits")
    retry.call_with_retries(lambda: 1, "write.x")  # not a fetch site
    snap = metrics.GLOBAL.snapshot()["fa_fetch_latency_ms"]
    assert list(snap) == ["level_bits"] and snap["level_bits"]["count"] == 2


# The calls that carry a fetch site label in the port, and the
# parameters of functions that default one.
_SITE_CALLS = {"fetch", "fetch_async", "gather_level_counts_start",
               "pair_regather", "_pair_level", "AsyncFetch"}


def _strings(node):
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        yield node.value
    elif isinstance(node, ast.IfExp):
        yield from _strings(node.body)
        yield from _strings(node.orelse)


def _port_fetch_sites():
    sites = set()
    for dirpath, _, names in os.walk(PKG):
        for n in names:
            if not n.endswith(".py"):
                continue
            with open(os.path.join(dirpath, n)) as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Call):
                    fn = node.func
                    name = getattr(fn, "attr", getattr(fn, "id", None))
                    if name in _SITE_CALLS:
                        for arg in node.args + [k.value for k in
                                                node.keywords]:
                            sites.update(_strings(arg))
                elif isinstance(node, ast.FunctionDef):
                    args = node.args.args + node.args.kwonlyargs
                    defaults = ([None] * (len(node.args.args)
                                          - len(node.args.defaults))
                                + node.args.defaults
                                + node.args.kw_defaults)
                    for a, d in zip(args, defaults):
                        if a.arg == "site" and d is not None:
                            sites.update(_strings(d))
    return {"fetch." + s for s in sites}


def test_fetch_site_census_is_the_ports_sites():
    """Every fetch site label the port's code passes to the audited
    fetch is in FETCH_SITE_SPANS, every entry is used, and each is one of
    the JAX package's sites."""
    found = _port_fetch_sites()
    assert found == set(FETCH_SITE_SPANS)
    assert set(FETCH_SITE_SPANS) <= set(JAX_FETCH_SITES)


def test_traced_runs_open_exactly_the_census_fetch_spans(tmp_path):
    """The production paths of the port's fetch-site inventory
    (tests/test_torch_reliability.py) and a served batch of the serving
    tier, traced: the fetch spans they open are the census."""
    from fastapriori_tpu_torch.serve import ServingState
    from test_torch_reliability import FETCH_SITES, _deep_lines, _recommend

    d = tmp_path / "in"
    d.mkdir()
    (d / "D.dat").write_text("".join(x + "\n" for x in _deep_lines()))
    (d / "U.dat").write_text(
        "".join(x + "\n" for x in random_dataset(13, n_txns=30)))
    corpus = str(d) + "/"
    seen = set()
    for knobs, rec_knobs in FETCH_SITES.values():
        knobs = dict(knobs)
        if knobs.get("checkpoint_prefix"):
            knobs["checkpoint_prefix"] = str(tmp_path) + "/ck-"
        TRACER.enable()
        miner = FastApriori(config=MinerConfig(min_support=0.08, **knobs),
                            device="cpu")
        levels, data = miner.run_file_raw(corpus + "D.dat")
        if rec_knobs is not None:
            _recommend(corpus, levels, data, **rec_knobs)
        seen |= {n for _, n, _ in TRACER.span_tree()
                 if n.startswith("fetch.")}
    TRACER.enable()
    state = ServingState(levels, data.item_counts, data.freq_items,
                         data.item_to_rank, device="cpu", engine="device")
    state.warm()  # fetch.serve_swap_ready
    state.recommend_batch([["1", "2"], ["3"]])  # fetch.serve_match
    seen |= {n for _, n, _ in TRACER.span_tree() if n.startswith("fetch.")}
    assert seen == set(FETCH_SITE_SPANS)


# ---------------------------------------------------------------------------
# metrics registry


def test_histogram_bucket_exactness():
    h = Histogram("h", (1.0, 2.0, 5.0))
    for v in (0.5, 1.0, 1.5, 2.0, 4.9, 5.0, 5.1, 100.0):
        h.observe(v)
    assert h.counts == [2, 2, 2, 2]  # a value equal to a bound is in it
    assert h.total == 8
    assert h.sum == pytest.approx(120.0)
    text = "\n".join(h.render())
    assert 'h_bucket{le="1"} 2' in text
    assert 'h_bucket{le="2"} 4' in text
    assert 'h_bucket{le="5"} 6' in text
    assert 'h_bucket{le="+Inf"} 8' in text
    assert "h_count 8" in text


def test_histogram_rejects_unsorted_bounds():
    with pytest.raises(ValueError):
        Histogram("h", (2.0, 1.0))
    with pytest.raises(ValueError):
        Histogram("h", (1.0, 1.0))


def test_counter_gauge_and_registry_snapshot():
    reg = MetricsRegistry()
    c = reg.counter("c_total")
    g = reg.gauge("g")
    c.inc()
    c.inc(3)
    g.set(7)
    g.set(2)
    assert isinstance(c, Counter) and isinstance(g, Gauge)
    snap = reg.snapshot()
    assert snap["c_total"] == 4
    assert snap["g"] == {"value": 2, "max": 7}
    assert reg.counter("c_total") is c
    text = reg.render()
    assert "c_total 4" in text and "g_max 7" in text


def _fill(m):
    reg = m.MetricsRegistry()
    reg.counter("c_total", "a counter").inc(5)
    reg.gauge("q").set(3)
    h = reg.histogram("lat_ms")
    for v in (0.1, 0.25, 3.0, 700.0, 1e5):
        h.observe(v)
    lh = reg.labeled_histogram("fetch_ms")
    for site, v in (("a", 1.0), ("b", 2.5), ("a", 40.0)):
        lh.observe(site, v)
    return reg


def test_registry_renders_as_the_jax_package():
    ours, theirs = _fill(metrics), _fill(jax_metrics)
    assert ours.render() == theirs.render()
    assert ours.snapshot() == theirs.snapshot()
    snaps = [ours.snapshot(), theirs.snapshot()]
    assert (metrics.merge_snapshots(snaps)
            == jax_metrics.merge_snapshots(snaps))
    merged = metrics.merge_snapshots(snaps)
    assert merged["c_total"] == 10
    assert metrics.render_snapshot(merged) == jax_metrics.render_snapshot(
        merged)
    with pytest.raises(ValueError):
        metrics.merge_snapshots([{"x": 1}, {"x": {"value": 1, "max": 1}}])


def test_labeled_fetch_latency_histogram():
    metrics.fetch_latency_observe("rec_match", 3.0)
    metrics.fetch_latency_observe("rec_match", 700.0)
    metrics.fetch_latency_observe("level_bits", 1.0)
    text = metrics.GLOBAL.render()
    assert 'fa_fetch_latency_ms_count{site="rec_match"} 2' in text
    assert 'fa_fetch_latency_ms_count{site="level_bits"} 1' in text
    snap = metrics.GLOBAL.snapshot()["fa_fetch_latency_ms"]
    assert snap["rec_match"]["count"] == 2


def test_metrics_dump_knob_strictness(monkeypatch):
    monkeypatch.setenv("FA_METRICS_DUMP_S", "nope")
    metrics.reload_from_env()
    with pytest.raises(InputError):
        metrics.dump_interval_s()
    monkeypatch.setenv("FA_METRICS_DUMP_S", "0.5")
    metrics.reload_from_env()
    assert metrics.dump_interval_s() == 0.5
    monkeypatch.delenv("FA_METRICS_DUMP_S")
    metrics.reload_from_env()
    assert metrics.dump_interval_s() == 5.0


# ---------------------------------------------------------------------------
# flight recorder


def test_flight_ring_overwrite_order():
    rec = FlightRecorder(cap=4)
    for i in range(7):
        rec.note("ledger", i=i)
    snap = rec.snapshot()
    assert [e["i"] for e in snap] == [3, 4, 5, 6]  # oldest dropped first
    assert [e["seq"] for e in snap] == [4, 5, 6, 7]
    assert snap[0]["kind"] == "ledger"


def test_flight_ring_size_knob(monkeypatch):
    monkeypatch.setenv("FA_FLIGHT_RECORDER_N", "2")
    assert FlightRecorder().cap == 2
    flight.reload_from_env()
    assert flight.RECORDER.cap == 2
    monkeypatch.setenv("FA_FLIGHT_RECORDER_N", "0")
    rec = FlightRecorder()
    rec.note("ledger", x=1)
    assert rec.snapshot() == []  # disabled
    monkeypatch.setenv("FA_FLIGHT_RECORDER_N", "junk")
    with pytest.raises(InputError):
        FlightRecorder()
    with pytest.raises(InputError):
        flight.reload_from_env()


def test_ledger_events_enter_flight_ring():
    ledger.record("retry", site="fetch.x", attempt=1)
    assert any(e["kind"] == "ledger" and e.get("event") == "retry"
               for e in flight.snapshot())


def test_spans_enter_flight_ring_only_while_tracing():
    with trace.span("quiet"):
        pass
    assert flight.snapshot() == []
    TRACER.enable()
    with trace.span("level", k=4):
        pass
    (e,) = flight.snapshot()
    assert (e["kind"], e["name"], e["k"]) == ("span", "level", 4)


def test_flight_dump_on_injected_watchdog_timeout(tmp_path):
    prefix = str(tmp_path) + "/"
    with pytest.raises(watchdog.DispatchTimeout):
        watchdog.guard(lambda: time.sleep(2.0), "fetch.slow",
                       timeout_s=0.05)
    path = flight.dump(prefix, "test: injected watchdog_timeout")
    with open(path) as fh:
        body = json.load(fh)
    assert body["reason"].startswith("test:")
    assert any(e.get("event") == "watchdog_timeout"
               and e.get("site") == "fetch.slow" for e in body["events"])
    from fastapriori_tpu_torch.io.resume import validate_artifact_bytes

    with open(path, "rb") as fh:
        validate_artifact_bytes(prefix, "flight.json", fh.read())


def test_flight_auto_dump_requires_prefix(tmp_path):
    assert flight.auto_dump("no prefix registered") is None
    flight.set_dump_prefix(str(tmp_path) + "/")
    ledger.record("retry", site="fetch.x", attempt=1)
    path = flight.auto_dump("now registered")
    assert path is not None
    with open(path) as fh:
        assert json.load(fh)["reason"] == "now registered"


def test_flight_auto_dump_never_raises(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("x")
    flight.set_dump_prefix(str(blocker) + "/")  # a directory under a file
    assert flight.auto_dump("unwritable") is None


def test_abandoned_thread_cap_dumps_flight(tmp_path, monkeypatch):
    monkeypatch.setenv("FA_DISPATCH_MAX_ABANDONED", "1")
    watchdog.reload_from_env()
    watchdog.reset_abandoned()
    flight.set_dump_prefix(str(tmp_path) + "/")
    release = threading.Event()
    try:
        with pytest.raises(watchdog.DispatchTimeout):
            watchdog.guard(lambda: release.wait(30.0), "fetch.wedge",
                           timeout_s=0.05)
        with pytest.raises(watchdog.AbandonedThreadCap):
            watchdog.guard(lambda: release.wait(30.0), "fetch.wedge",
                           timeout_s=0.05)
    finally:
        release.set()
        watchdog.reset_abandoned()
        monkeypatch.delenv("FA_DISPATCH_MAX_ABANDONED")
        watchdog.reload_from_env()
    with open(str(tmp_path) + "/flight.json") as fh:
        body = json.load(fh)
    assert body["reason"] == "abandoned_thread_cap"
    assert body["context"]["site"] == "fetch.wedge"
    assert sum(e.get("event") == "watchdog_timeout"
               for e in body["events"]) == 2


# ---------------------------------------------------------------------------
# MetricsLogger and phase_timer


def test_metrics_logger_records_are_bounded():
    log = MetricsLogger(enabled=False, records_cap=5)
    for i in range(8):
        log.emit("e", i=i)
    assert len(log.records) == 5
    assert log.records_dropped == 3
    assert [r["i"] for r in log.records] == [0, 1, 2, 3, 4]


def test_metrics_logger_timed_respects_bound():
    log = MetricsLogger(enabled=False, records_cap=1)
    with log.timed("a"):
        pass
    with log.timed("b"):
        pass
    assert len(log.records) == 1 and log.records_dropped == 1


def test_phase_timer_routes_through_tracer_and_logger(capsys):
    TRACER.enable()
    log = MetricsLogger(enabled=False)
    with phase_timer("get freqItemsets", enabled=True, metrics=log):
        pass
    err = capsys.readouterr().err
    assert "==== Use Time get freqItemsets" in err
    assert log.records[-1]["event"] == "phase"
    assert log.records[-1]["label"] == "get freqItemsets"
    assert "phase" in {name for _, name, _ in TRACER.span_tree()}
    with phase_timer("quiet", enabled=False, metrics=log):
        pass
    assert "====" not in capsys.readouterr().err


def test_phase_timer_uses_active_logger(capsys):
    log = MetricsLogger(enabled=True)
    assert fa_logging.active_logger() is log
    MetricsLogger(enabled=False)  # a disabled logger never binds
    assert fa_logging.active_logger() is log
    with phase_timer("p", enabled=False):
        pass
    assert log.records[-1]["event"] == "phase"
    assert '"event": "phase"' in capsys.readouterr().err


def test_timed_sections_become_spans():
    TRACER.enable()
    log = MetricsLogger(enabled=False)
    with log.timed("level", k=4) as m:
        m.update(frequent=10)
    log.emit("engine_auto", choice="level")
    spans = [e for e in TRACER.events() if e["ph"] == "X"]
    assert spans[0]["name"] == "level"
    assert spans[0]["args"]["frequent"] == 10
    assert spans[0]["args"]["wall_ms"] == log.records[0]["wall_ms"]
    (inst,) = [e for e in TRACER.events() if e["ph"] == "i"]
    assert inst["name"] == "engine_auto"
    assert log.records[0] == {"event": "level", "k": 4, "frequent": 10,
                              "wall_ms": log.records[0]["wall_ms"]}


def test_timed_section_that_raises_still_records():
    TRACER.enable()
    log = MetricsLogger(enabled=False)
    with pytest.raises(KeyError):
        with log.timed("level", k=5) as m:
            m.update(candidates=3)
            raise KeyError("boom")
    assert log.records[0]["candidates"] == 3
    assert "wall_ms" in log.records[0]
    (sp,) = [e for e in TRACER.events() if e["ph"] == "X"]
    assert sp["args"]["error"] == "KeyError"


# ---------------------------------------------------------------------------
# device trace


def _write_trace(path, events):
    with gzip.open(path, "wt") as fh:
        json.dump({"traceEvents": events}, fh)


K1_PACK = ("void (anonymous namespace)::pack_kernel(signed char const*, "
           "signed char const*, (anonymous namespace)::Scratch, int, int)")
K2_PACK = ("void (anonymous namespace)::pack_kernel(signed char const*, "
           "unsigned int*, int*, int, int)")


def test_kernel_summary_keeps_full_names_and_stages(tmp_path):
    events = [
        {"ph": "X", "cat": "kernel", "name": K1_PACK, "dur": 2.0},
        {"ph": "X", "cat": "kernel", "name": K2_PACK, "dur": 3.0},
        {"ph": "X", "cat": "kernel", "name": "void (anonymous namespace)::"
         "level_counts_packed<16, true>(signed char const*)", "dur": 10.0},
        {"ph": "X", "cat": "kernel", "name": "void (anonymous namespace)::"
         "level_counts_packed<16, true>(signed char const*)", "dur": 5.0},
        {"ph": "X", "cat": "kernel",
         "name": "void first_match_kernel<true>(unsigned int const*)",
         "dur": 4.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pinned -> "
         "Device)", "dur": 1.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "dur": 99.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "dur": 7.0},
        {"ph": "i", "cat": "kernel", "name": "marker"},
    ]
    _write_trace(tmp_path / f"capture_1{device_trace.TRACE_SUFFIX}", events)
    out = device_trace.kernel_summary(str(tmp_path))
    rows = {r["name"]: r for r in out["kernels"]}
    assert len(rows) == 5  # device events only; two pack_kernel rows
    assert rows[K1_PACK]["stage"] == "mine.count"
    assert rows[K2_PACK]["stage"] == "serve.scan"
    k1 = [r for r in out["kernels"] if "level_counts_packed" in r["name"]]
    assert k1[0]["calls"] == 2 and k1[0]["total_us"] == 15.0
    assert out["kernels"][0] is k1[0]  # longest first
    assert out["by_stage"] == {"mine.count": 17.0, "serve.scan": 7.0,
                               "xfer": 1.0}
    assert len(device_trace.kernel_summary(str(tmp_path), top=2)[
        "kernels"]) == 2
    # The newest capture wins; a file path works too.
    _write_trace(tmp_path / f"capture_2{device_trace.TRACE_SUFFIX}", [])
    assert device_trace.kernel_summary(str(tmp_path))["kernels"] == []
    path = str(tmp_path / f"capture_1{device_trace.TRACE_SUFFIX}")
    assert len(device_trace.kernel_summary(path)["kernels"]) == 5


@pytest.mark.parametrize("name,stage", [
    ("vertical_counts_kernel(unsigned int const*)", "mine.count"),
    ("run_starts_kernel(int const*)", "mine.count"),
    ("prep_rows_kernel(signed char const*)", "mine.count"),
    ("first_match_kernel<false>(unsigned int const*)", "serve.scan"),
    ("pack_kernel", "serve.scan"),
    ("void at::native::vectorized_elementwise_kernel<4, copy>", "xfer"),
    ("Memcpy DtoH (Device -> Pinned)", "xfer"),
    ("cutlass_80_tensorop_s1688gemm", "other"),
])
def test_stage_for_kernel(name, stage):
    assert device_trace.stage_for_kernel(name) == stage


def test_kernel_summary_missing_or_malformed(tmp_path):
    assert device_trace.kernel_summary(str(tmp_path)) == {
        "trace": None, "kernels": [], "by_stage": {}}
    bad = tmp_path / f"capture_1{device_trace.TRACE_SUFFIX}"
    bad.write_bytes(b"not gzip")
    out = device_trace.kernel_summary(str(tmp_path))
    assert out["trace"] == str(bad) and out["kernels"] == []


def test_device_trace_knob_is_strict(monkeypatch, tmp_path):
    monkeypatch.setenv("FA_DEVICE_TRACE", "perhaps")
    device_trace.reload_from_env()
    try:
        with pytest.raises(InputError, match="FA_DEVICE_TRACE"):
            with device_trace.capture(str(tmp_path)):
                pass
        monkeypatch.setenv("FA_DEVICE_TRACE", "0")
        device_trace.reload_from_env()
        with device_trace.capture(str(tmp_path)) as info:
            pass
        assert info == {"active": False, "trace_dir": str(tmp_path)}
        assert os.listdir(tmp_path) == []
    finally:
        monkeypatch.delenv("FA_DEVICE_TRACE")
        device_trace.reload_from_env()


def test_capture_on_the_cpu_writes_a_trace(tmp_path):
    import torch

    with device_trace.capture(str(tmp_path / "prof"), explicit=True) as info:
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    assert info["active"] is True
    assert info["trace"].endswith(device_trace.TRACE_SUFFIX)
    assert info["device_events"] == 0  # no card here
    with gzip.open(info["trace"], "rt") as fh:
        doc = json.load(fh)
    assert any(e.get("name") == "aten::mm" for e in doc["traceEvents"])
    assert ledger.summary() == {}  # no card: an empty device trace is fine
    assert not [n for n in os.listdir(tmp_path / "prof")
                if not n.endswith(device_trace.TRACE_SUFFIX)]


def test_capture_failure_is_ledgered_not_raised(tmp_path, monkeypatch):
    import torch.profiler

    class Broken:
        def __init__(self, *a, **k):
            raise RuntimeError("CUPTI unavailable")

    monkeypatch.setattr(torch.profiler, "profile", Broken)
    ran = []
    with device_trace.capture(str(tmp_path), explicit=True) as info:
        ran.append(1)
    assert ran == [1] and info["active"] is False
    (ev,) = ledger.snapshot()
    assert ev["kind"] == "device_trace_unavailable"
    assert ev["phase"] == "start" and "CUPTI" in ev["error"]


def test_cli_profile_dir_on_the_cpu(tmp_path, capsys):
    (tmp_path / "D.dat").write_text(
        "".join(x + "\n" for x in random_dataset(3)))
    (tmp_path / "U.dat").write_text("1 2\n3\n")
    prof = tmp_path / "prof"
    assert torch_main([str(tmp_path) + "/", str(tmp_path) + "/o-",
                       "--min-support", "0.1", "--platform", "cpu",
                       "--profile-dir", str(prof)]) == 0
    assert "device trace written: " in capsys.readouterr().err
    assert device_trace.find_device_trace(str(prof)) is not None
    assert ledger.summary() == {}


# ---------------------------------------------------------------------------
# the traced CLI of both packages

# Span names one package's traced run has and the other's has not, on
# the corpus below, and why:
# - "upload": the port's block uploader thread (device.py BlockUploader)
#   is a span per block it copies; the JAX package uploads in the ingest
#   callback, with no span of its own;
# - "fetch.rec_match": the port scans on the device from 10^5 distinct
#   basket x rule checks (models/recommender.py DEVICE_MIN_CHECKS), the
#   JAX package from 3 * 10^7, so here only the port's scan fetches.
# - the job's frame, user and writer spans ("job_setup", "read_users",
#   "user_fanout", "write", "write_format", "fsync") and the pair
#   program's launch ("pair_program"), which the port's benchmark reads
#   and the JAX package does not open.
ONLY_PORT = {"upload", "fetch.rec_match", "job_setup", "read_users",
             "user_fanout", "write", "write_format", "fsync",
             "pair_program"}
ONLY_JAX: set = set()


@pytest.fixture(scope="module")
def traced_corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("traced")
    (d / "D.dat").write_text("\n".join(generate_transactions(
        n_txns=3000, n_items=100, seed=5)) + "\n")
    (d / "U.dat").write_text("\n".join(generate_user_baskets(
        n_users=500, n_items=100, seed=6)) + "\n")
    return str(d) + "/"


def _spans(path):
    with open(path) as fh:
        doc = json.load(fh)
    return doc, [e for e in doc["traceEvents"] if e["ph"] == "X"]


def test_traced_cli_matches_the_jax_cli(traced_corpus, tmp_path, capsys):
    t_trace, j_trace = tmp_path / "t.json", tmp_path / "j.json"
    assert torch_main([traced_corpus, str(tmp_path / "t") + "/",
                       "--min-support", "0.02", "--platform", "cpu",
                       "--engine", "level", "--trace", str(t_trace)]) == 0
    assert jax_main([traced_corpus, str(tmp_path / "j") + "/",
                     "--min-support", "0.02", *JAX_FLAGS,
                     "--trace", str(j_trace)]) == 0
    err = capsys.readouterr().err
    assert err.count("trace written: ") == 2
    for name in ("freqItemset", "recommends"):
        got = (tmp_path / "t" / name).read_bytes()
        assert got and got == (tmp_path / "j" / name).read_bytes()
    levels = {}
    names = {}
    for side, path in (("port", t_trace), ("jax", j_trace)):
        doc, spans = _spans(path)
        assert validate_chrome_trace(doc) == []
        assert jax_trace.validate_chrome_trace(doc) == []
        by_sid = {e["args"]["sid"]: e for e in spans}
        assert "main:run#0" in by_sid
        assert {by_sid["main:run#0/phase#0"]["args"]["label"],
                by_sid["main:run#0/phase#1"]["args"]["label"]} == {
                    "get freqItemsets", "get recommends"}
        assert by_sid["main:run#0/phase#0/mine#0"]["name"] == "mine"
        lv = [e for e in spans if e["name"] == "level"]
        assert all(e["args"]["sid"].startswith("main:run#0/phase#0/mine#0/")
                   for e in lv)
        levels[side] = {e["args"]["k"] for e in lv}
        names[side] = {e["name"] for e in spans}
    assert levels["port"] == levels["jax"] and len(levels["port"]) >= 3
    assert names["port"] - names["jax"] == ONLY_PORT
    assert names["jax"] - names["port"] == ONLY_JAX


@pytest.mark.parametrize("layout", ["bitmap", "vertical"])
def test_traced_cli_span_ids_repeat_across_identical_runs(
        layout, traced_corpus, tmp_path, monkeypatch):
    """The port's threads (the uploader, the watchdog's workers) leave
    the span tree of two identical runs equal."""
    monkeypatch.setenv("FA_MINE_ENGINE", layout)
    monkeypatch.setenv("FA_INGEST_THREADS", "3")
    monkeypatch.setenv("FA_DISPATCH_TIMEOUT_S", "60")
    watchdog.reload_from_env()
    trees = []
    try:
        for i in range(2):
            path = tmp_path / f"{i}.json"
            assert torch_main([traced_corpus, str(tmp_path / str(i)) + "/",
                               "--min-support", "0.02", "--platform", "cpu",
                               "--engine", "level", "--trace",
                               str(path)]) == 0
            trees.append(TRACER.span_tree())
    finally:
        monkeypatch.delenv("FA_DISPATCH_TIMEOUT_S")
        watchdog.reload_from_env()
    assert trees[0] == trees[1]
    roots = {sid.split(":")[0] for sid, _, _ in trees[0]}
    assert "main" in roots
    if layout == "bitmap":
        assert "fa-upload_0" in roots
    assert ledger.summary() == {}


def _job_spans(traced_corpus, out):
    """One CLI job on the CPU recorded through ``FA_TRACE`` (the
    benchmark's way: no export): its completed spans."""
    assert torch_main([traced_corpus, out, "--min-support", "0.02",
                       "--platform", "cpu"]) == 0
    return [e for e in TRACER.events() if e["ph"] == "X"]


def test_traced_cli_job_span_tree(traced_corpus, tmp_path, monkeypatch):
    """The job's span frame: ``run`` holds every span of the main
    thread, among them ``job_setup``, ``read_users`` and both phases;
    each write has its artifact and one ``fsync`` child; the pair
    program's launch sits under ``bitmap_build``; the tree repeats.
    ``freqItemset`` and ``recommends`` are laid out under a
    ``write_format`` child first, their ``write`` spans carrying the
    ``lines`` and the ``formatter`` (the native library loads here)."""
    monkeypatch.setenv("FA_TRACE", "1")
    trace.reload_from_env()
    trees = []
    try:
        for i in range(2):
            spans = _job_spans(traced_corpus, str(tmp_path / str(i)) + "/")
            trees.append(TRACER.span_tree())
    finally:
        monkeypatch.delenv("FA_TRACE")
        trace.reload_from_env()
    assert trees[0] == trees[1]
    by_sid = {e["sid"]: e for e in spans}
    main = [e for e in spans if e["thread"] == "main"]
    assert [e["sid"] for e in main if e["parent"] is None] == ["main:run#0"]
    for sid in ("job_setup#0", "read_users#0", "phase#0", "phase#1"):
        assert by_sid[f"main:run#0/{sid}"]["parent"] == "main:run#0"
    assert by_sid["main:run#0/read_users#0"]["args"]["lines"] == 500
    assert by_sid["main:run#0/phase#1/user_fanout#0"]["args"]["users"] == 500
    writes = [e for e in spans if e["name"] == "write"]
    assert sorted(e["args"]["artifact"] for e in writes) == [
        "MANIFEST.json", "MANIFEST.json", "freqItemset", "recommends"]
    for w in writes:
        assert w["parent"].startswith("main:run#0/phase#")
        kids = [e for e in spans if e["parent"] == w["sid"]]
        if w["args"]["artifact"] == "MANIFEST.json":
            assert [e["name"] for e in kids] == ["fsync"]
        else:
            assert [e["name"] for e in kids] == ["write_format", "fsync"]
            assert w["args"]["formatter"] == "native"
        assert w["args"]["bytes"] > 0
    written = {e["args"]["artifact"]: e["args"]["bytes"] for e in writes
               if e["args"]["artifact"] != "MANIFEST.json"}
    for name, size in written.items():
        assert os.path.getsize(tmp_path / "1" / name) == size
    lines = {e["args"]["artifact"]: e["args"]["lines"] for e in writes
             if e["args"]["artifact"] != "MANIFEST.json"}
    for name, n in lines.items():
        assert (tmp_path / "1" / name).read_bytes().count(b"\n") == n
    assert lines["recommends"] == 500
    pair = [e for e in spans if e["name"] == "pair_program"]
    assert pair, "the CPU path launches the pair program on this corpus"
    assert all(by_sid[e["parent"]]["name"] == "bitmap_build" for e in pair)
