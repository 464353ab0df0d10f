"""The vertical-layout benchmark cell (``t20n10k-vertical-batch``) on the
CPU at a small size.

- The port's CLI on Quest T20.I6 corpora over a 10,000-id universe, made
  by the benchmark's generator (``portbench/gen.py``) from the cell's
  configuration with fewer transactions and users: the zero-flag auto
  choice takes the vertical engine, and ``freqItemset`` and
  ``recommends`` equal the benchmark's NumPy reference byte for byte.
- The vertical engine's spans: one ``vertical_pairs`` in level 2's
  ``level``, one ``vertical_count`` per K3 launch with its ``k``,
  candidates, lanes and ``vops``; the arena's upload bytes and layout on
  ``arena_build``; none of them on the bitmap path.
- The cell's three readers (``vertical_pair_device_ms``,
  ``k3_device_ms``, ``k3_roofline_pct``) on synthetic spans and device
  traces, and the cell run whole through the harness at the small size.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from fastapriori_tpu_torch import cli
from fastapriori_tpu_torch.obs import trace
from fastapriori_tpu_torch.obs.trace import TRACER
from portbench import gen, roofline
from portbench.reference import apriori
from portbench.roofline_levels import count_least_s_from
from portbench.tests.helpers import tiny_root
from portbench.tests import records

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "t20n10k-vertical-batch"
CONFIG = "t20i6d100k-n10k"
VERTICAL_SPANS = ("vertical_pairs", "vertical_count")
# The cell's configuration with 3,000 transactions and 300 users: still
# T20.I6 over 10,000 ids at min support 0.005, F = 1,519 frequent items
# at density 0.87 %, so the defaults' auto rule (>= 512 items, <= 1 %)
# picks vertical without a lowered threshold; levels 2-10.
SMALL = {"n_txns": 3000, "n_users": 300}


def _config(name=CONFIG, **cut):
    with open(os.path.join(ROOT, "portbench", "configs",
                           name + ".json")) as f:
        cfg = json.load(f)
    cfg.update(cut)
    return cfg


def _inputs(tmp_path, cfg, seed):
    made = gen.make_inputs(cfg, seed)
    d = tmp_path / "in"
    d.mkdir()
    for name in ("D.dat", "U.dat"):
        (d / name).write_bytes(made[name])
    return str(d) + "/", made


def _events(err, name):
    out = []
    for line in err.splitlines():
        if line.startswith("{"):
            rec = json.loads(line)
            if rec.get("event") == name:
                out.append(rec)
    return out


@pytest.fixture
def traced(monkeypatch):
    """Spans recorded process-wide (``FA_TRACE``, the benchmark's way),
    switched off again afterwards."""
    monkeypatch.setenv("FA_TRACE", "1")
    trace.reload_from_env()
    yield
    monkeypatch.delenv("FA_TRACE")
    trace.reload_from_env()
    TRACER.disable()
    TRACER.reset()


def _job(in_dir, out_dir, cfg, *extra):
    return cli.main([in_dir, out_dir, "--min-support",
                     repr(float(cfg["min_support"])), "--platform", "cpu",
                     *extra])


@pytest.mark.parametrize("seed", [3, 4300002201, 2**31 + 17])
def test_auto_picks_vertical_and_writes_the_references_bytes(
        seed, tmp_path, monkeypatch, capsys):
    monkeypatch.delenv("FA_MINE_ENGINE", raising=False)
    cfg = _config(**SMALL)
    in_dir, made = _inputs(tmp_path, cfg, seed)
    out = str(tmp_path / "out") + "/"
    assert _job(in_dir, out, cfg, "--metrics") == 0
    err = capsys.readouterr().err
    (eng,) = _events(err, "mine_engine")
    assert eng["engine"] == "vertical" and eng["requested"] == "auto"
    assert 0 < eng["density"] <= 0.01
    assert len(_events(err, "arena_build")) == 1
    assert not _events(err, "bitmap_build")
    ref = apriori.Result(made["D.dat"], made["U.dat"],
                         float(cfg["min_support"]))
    assert len(ref.mined.levels) >= 6
    with open(out + "freqItemset", "rb") as f:
        assert f.read() == ref.freq_itemset
    with open(out + "recommends", "rb") as f:
        assert f.read() == ref.recommends


def test_vertical_spans_one_per_k3_launch(tmp_path, monkeypatch, capsys,
                                          traced):
    monkeypatch.delenv("FA_MINE_ENGINE", raising=False)
    cfg = _config(**SMALL)
    in_dir, _ = _inputs(tmp_path, cfg, 5)
    assert _job(in_dir, str(tmp_path / "out") + "/", cfg, "--metrics") == 0
    err = capsys.readouterr().err
    spans = [e for e in TRACER.events() if e["ph"] == "X"]
    by_sid = {e["sid"]: e for e in spans}
    levels = {e["k"]: e for e in _events(err, "level")}
    (pairs,) = [e for e in spans if e["name"] == "vertical_pairs"]
    parent = by_sid[pairs["parent"]]
    assert parent["name"] == "level" and parent["args"]["k"] == 2
    (arena,) = _events(err, "arena_build")
    assert pairs["args"] == {"f": _events(err, "preprocess")[0]["num_items"],
                             "lanes": arena["shape"][1],
                             "chunks": levels[2]["chunks"]}
    counts = [e for e in spans if e["name"] == "vertical_count"]
    launched = {k: e["launches"] for k, e in levels.items() if k >= 3}
    assert len(counts) == sum(launched.values()) == len(launched) >= 5
    for e in counts:
        a = e["args"]
        assert set(a) == {"k", "candidates", "lanes", "vops"}
        lv = by_sid[e["parent"]]
        assert lv["name"] == "level" and lv["args"]["k"] == a["k"]
        assert a["candidates"] == levels[a["k"]]["candidates"]
        assert a["vops"] == levels[a["k"]]["vops"]
        assert a["lanes"] == arena["shape"][1]
    (build,) = [e for e in spans if e["name"] == "arena_build"]
    assert build["args"]["upload_bytes"] == arena["upload_bytes"] > 0
    assert build["args"]["csr_bytes"] == arena["csr_bytes"] > 0


@pytest.mark.parametrize("engine", ["auto", "level"])
def test_bitmap_path_opens_no_vertical_span(engine, tmp_path, monkeypatch,
                                            traced):
    """T10's shape takes the bitmap layout: the auto engine (fused) and
    the level engine, whose loop counts with K1, open no vertical span."""
    monkeypatch.delenv("FA_MINE_ENGINE", raising=False)
    cfg = _config("t10i4d100k", n_txns=3000, n_users=300,
                  min_support=0.008)
    in_dir, made = _inputs(tmp_path, cfg, 7)
    out = str(tmp_path / "out") + "/"
    assert _job(in_dir, out, cfg, "--engine", engine) == 0
    spans = [e for e in TRACER.events() if e["ph"] == "X"]
    names = {e["name"] for e in spans}
    assert "bitmap_build" in names and "arena_build" not in names
    assert not names & set(VERTICAL_SPANS)
    if engine == "level":
        assert any(e["args"].get("launches", 0) > 0 for e in spans
                   if e["name"] == "level")
    ref = apriori.Result(made["D.dat"], made["U.dat"],
                         float(cfg["min_support"]))
    with open(out + "freqItemset", "rb") as f:
        assert f.read() == ref.freq_itemset


# ---------------------------------------------------------------------------
# the readers


class _Run:
    def __init__(self, spans=None, jobs=(), trace_=None, ref=None):
        self.records = {"jobs": list(jobs)}
        if spans is not None:
            self.records["spans"] = spans
        if trace_ is not None:
            self.records["trace"] = trace_
        if ref is not None:
            self.records["ref"] = ref


class _Ref:
    """What the roofline reads of the reference's result."""

    def __init__(self, mined):
        self.mined = mined


def _mined(f=100, nb=1000, work=((2, 4950, 9000), (3, 300, 5000),
                                 (4, 40, 700))):
    m = apriori.Mined()
    m.items = np.arange(f)
    m.n_baskets = nb
    m.work = [{"k": k, "candidates": c, "pairs": p} for k, c, p in work]
    return m


# Two jobs: each a level 2 with its pair phase and two K3 launches (the
# second job's second level span holds no K3 span).
JOBS = [(0.0, 10.0), (10.0, 20.0)]
ROWS = [
    ("arena_build", 1.0, 2.0),
    ("level", 2.0, 4.0), ("vertical_pairs", 2.5, 3.5),
    ("level", 4.0, 5.0), ("vertical_count", 4.2, 4.4),
    ("level", 5.0, 6.0), ("vertical_count", 5.2, 5.4),
    ("level", 12.0, 14.0), ("vertical_pairs", 12.5, 13.5),
    ("level", 14.0, 15.0), ("vertical_count", 14.2, 14.4),
    ("level", 15.0, 16.0),
]
OPS = [
    ("kernel", 1.5, 0.100),       # the arena's scatter: no reader's
    ("kernel", 2.6, 0.004),       # pair phase
    ("kernel", 3.0, 0.002),       # pair phase
    ("gpu_memcpy", 3.1, 0.050),   # a copy, not a kernel
    ("kernel", 3.8, 0.200),       # level 2 after its pair phase
    ("kernel", 4.3, 0.010),       # K3
    ("kernel", 5.3, 0.020),       # K3
    ("kernel", 5.6, 0.300),       # level 4 after its launch
    ("kernel", 13.0, 0.006),      # pair phase
    ("kernel", 14.3, 0.030),      # K3
    ("kernel", 15.5, 0.400),      # a level with no K3 span
    ("kernel", np.nan, 0.500),    # no launch recorded
]


@pytest.mark.parametrize("name,ms", [
    ("vertical_pair_device_ms", (0.004 + 0.002 + 0.006) * 1e3 / 2),
    ("k3_device_ms", (0.010 + 0.020 + 0.030) * 1e3 / 2),
])
def test_device_readers_charge_the_kernels_launched_in_their_spans(name, ms):
    got = records.reader(name).read(
        _Run(records.spans(ROWS), JOBS, records.device_trace(OPS)))
    assert got == pytest.approx(ms)


def test_k3_roofline_is_the_k3_levels_least_time_over_k3_device_time():
    mined = _mined()
    got = records.reader("k3_roofline_pct").read(
        _Run(records.spans(ROWS), JOBS, records.device_trace(OPS),
             _Ref(mined)))
    want = 100.0 * 2 * count_least_s_from(mined, 3) / 0.060
    assert got == pytest.approx(want)
    assert 0 < got < 100


def test_level_roofline_keeps_count_least_s_terms():
    mined = _mined()
    assert count_least_s_from(mined, 2) == pytest.approx(
        roofline.count_least_s(mined))
    level2 = _mined(work=((2, 4950, 9000),))
    assert count_least_s_from(mined, 3) == pytest.approx(
        roofline.count_least_s(mined) - roofline.count_least_s(level2))
    assert count_least_s_from(mined, 5) == 0.0


@pytest.mark.parametrize("name", ["vertical_pair_device_ms", "k3_device_ms",
                                  "k3_roofline_pct"])
def test_new_readers_find_nothing_without_their_kernels(name):
    read = records.reader(name).read
    ref = _Ref(_mined())
    tr = records.device_trace(OPS)
    # No spans, spans of the bitmap path only, no jobs, no trace.
    assert read(_Run(None, JOBS, tr, ref)) is None
    assert read(_Run(records.spans([("bitmap_build", 2.0, 4.0),
                             ("level", 4.0, 6.0)]), JOBS, tr, ref)) is None
    assert read(_Run(records.spans(ROWS), [], tr, ref)) is None
    assert read(_Run(records.spans(ROWS), JOBS, None, ref)) is None
    # Spans, but no kernel launched in them (a copy only).
    assert read(_Run(records.spans(ROWS), JOBS, records.device_trace([
        ("gpu_memcpy", 2.6, 0.004), ("gpu_memcpy", 4.3, 0.004),
        ("kernel", 8.0, 0.1)]), ref)) is None


def test_cell_runs_whole_through_the_harness(tmp_path):
    """The cell through ``portbench/run.py``'s ``main`` on the CPU with a
    traced window, in a process of its own (the harness refuses a process
    that loaded JAX, as this one has): correct against the reference, and
    the span readers report; the device readers find no kernel there."""
    root = tiny_root(tmp_path)
    path = os.path.join(root, "portbench", "configs", CONFIG + ".json")
    cfg = _config(**SMALL)
    with open(path, "w") as f:
        json.dump(cfg, f)
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from portbench import run; sys.exit(run.main(["
            "'--workload', sys.argv[2], '--seed', '4300002203', "
            "'--seconds', '1', '--trace', '1'], root=sys.argv[1], "
            "platform='cpu'))")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("FA_", "PYTEST_"))}
    proc = subprocess.run([sys.executable, "-c", code, root, CELL],
                          cwd=root, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    for name in ("ingest_ms", "layout_build_ms", "mine_levels_ms",
                 "rules_ms", "recommend_ms", "user_input_ms", "write_ms",
                 "job_unspanned_ms"):
        assert line["metrics"][name]["value"] > 0, name
    for name in ("vertical_pair_device_ms", "k3_device_ms",
                 "k3_roofline_pct", "pair_program_device_ms"):
        assert name not in line["metrics"]
