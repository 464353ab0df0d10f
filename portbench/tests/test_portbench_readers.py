"""The readers of the job's spans, on synthetic runs built from hand-made
spans, job intervals and a device trace stub: unions count nested and
overlapping spans once, `run` and `phase` never count as covered, device
time is charged by the span open at a kernel's launch, and a reader with
nothing to read returns None."""

import os

import numpy as np
import pytest

from portbench import devtrace, harness
from portbench.tests.helpers import ROOT

NEW = ("user_input_ms", "write_ms", "fsync_ms", "job_setup_ms",
       "pair_program_device_ms", "pair_wait_ms", "job_unspanned_ms")


def _reader(name):
    return harness.load_module(
        os.path.join(ROOT, "portbench", "metrics", name + ".py"), name)


def _spans(rows):
    """Spans from ``(name, start s, end s)`` rows on the main thread."""
    sp = devtrace.Spans()
    sp.add_tracer_events([{"ph": "X", "name": n, "ts_us": t0 * 1e6,
                           "dur_us": (t1 - t0) * 1e6, "thread": "main"}
                          for n, t0, t1 in rows], epoch=0.0)
    return sp


class _Run:
    def __init__(self, spans=None, jobs=(), trace=None):
        self.records = {"jobs": list(jobs)}
        if spans is not None:
            self.records["spans"] = spans
        if trace is not None:
            self.records["trace"] = trace


def _trace(ops):
    """A device trace of ``(category, launch s, duration s)`` rows."""
    tr = devtrace.Trace.__new__(devtrace.Trace)
    tr.cat = np.array([c for c, _, _ in ops], dtype=object)
    tr.name = [f"op{i}" for i in range(len(ops))]
    tr.launch = np.array([t for _, t, _ in ops], dtype=float)
    tr.start = tr.launch + 1e-4
    tr.dur = np.array([d for _, _, d in ops], dtype=float)
    tr.is_kernel = tr.cat == "kernel"
    return tr


# Two jobs, [0, 10] and [10, 20] s; nested, overlapping and frame spans.
JOBS = [(0.0, 10.0), (10.0, 20.0)]
ROWS = [
    ("run", 0.0, 10.0), ("phase", 1.0, 9.0), ("job_setup", 0.5, 1.0),
    ("preprocess", 1.0, 3.0), ("bitmap_build", 2.0, 4.0),   # overlap
    ("pair_program", 2.5, 3.0),                             # nested
    ("fetch.pair_pre", 4.0, 4.5),
    ("level", 5.0, 6.0), ("write", 6.0, 8.0), ("fsync", 7.0, 8.0),
    ("run", 10.0, 20.0), ("read_users", 10.0, 11.0),
    ("user_dedup", 10.5, 12.0), ("gen_rules", 12.0, 13.0),
    ("first_match", 14.0, 15.0), ("user_fanout", 15.0, 15.5),
    ("write", 19.0, 20.5),                                  # past the job
    ("upload", 16.0, 18.0),                                 # read by none
]


def test_job_unspanned_counts_each_covered_second_once():
    # Job 1 covered [0.5, 4.5] and [5, 8]: 7 s of 10; job 2 [10, 13],
    # [14, 15.5] and [19, 20]: 5.5 s of 10.
    got = _reader("job_unspanned_ms").read(_Run(_spans(ROWS), JOBS))
    assert got == pytest.approx((3.0 + 4.5) * 1e3 / 2)


def test_job_unspanned_ignores_run_and_phase():
    frames = [r for r in ROWS if r[0] not in ("run", "phase")]
    read = _reader("job_unspanned_ms").read
    assert read(_Run(_spans(ROWS), JOBS)) == \
        read(_Run(_spans(frames), JOBS))
    # Frames alone cover nothing a metric reads.
    assert read(_Run(_spans([("run", 0.0, 10.0), ("phase", 1.0, 9.0)]),
                     JOBS[:1])) is None


@pytest.mark.parametrize("name,ms", [
    ("user_input_ms", 2.5e3 / 2),     # [10, 12] (two overlap), [15, 15.5]
    ("write_ms", 3.5e3 / 2),          # [6, 8] and [19, 20.5]
    ("fsync_ms", 1.0e3 / 2),
    ("job_setup_ms", 0.5e3 / 2),
    ("pair_wait_ms", 0.5e3 / 2),
])
def test_span_readers_take_the_union_per_job(name, ms):
    assert _reader(name).read(_Run(_spans(ROWS), JOBS)) == \
        pytest.approx(ms)


def test_pair_program_device_time_counts_its_kernels_alone():
    tr = _trace([
        ("kernel", 2.6, 0.004),       # launched in pair_program
        ("kernel", 2.9, 0.002),       # launched in pair_program
        ("gpu_memcpy", 2.7, 0.050),   # a copy, not a kernel
        ("kernel", 3.5, 0.100),       # bitmap_build, after the launch
        ("kernel", 5.5, 0.200),       # the level loop
        ("kernel", np.nan, 0.300),    # no launch recorded
    ])
    got = _reader("pair_program_device_ms").read(
        _Run(_spans(ROWS), JOBS, tr))
    assert got == pytest.approx(0.006 * 1e3 / 2)


@pytest.mark.parametrize("name", NEW)
def test_readers_find_nothing_without_their_spans(name):
    read = _reader(name).read
    tr = _trace([("kernel", 2.6, 0.004)])
    assert read(_Run(None, JOBS, tr)) is None
    assert read(_Run(_spans([("upload", 0.0, 1.0)]), JOBS, tr)) is None
    assert read(_Run(_spans(ROWS), [], tr)) is None


def test_pair_program_device_time_needs_the_trace_and_a_kernel():
    read = _reader("pair_program_device_ms").read
    assert read(_Run(_spans(ROWS), JOBS)) is None
    assert read(_Run(_spans(ROWS), JOBS, _trace([
        ("gpu_memcpy", 2.6, 0.004), ("kernel", 5.5, 0.1)]))) is None
