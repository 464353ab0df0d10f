"""The dense long-pattern benchmark cell (``t40-batch``) on the CPU at a
small size.

- The cell's configuration (FIMI T40I10D100K, IBM Quest) and the inputs
  the benchmark's generator makes from it: the row count, baskets of 40
  items on average, and a ``--seed`` that relabels the same corpus.
- The port's CLI with zero flags on a T40 corpus cut to 1,500
  transactions at min support 0.023, where the lattice (levels 2-8:
  227, 474, 1,013, 1,610, 1,568, 793, 154) outgrows level 2's row
  budget twice, as the full corpus does at 1 %: the bitmap layout, K1's
  dense form in the pair program's level 3, the fused engine, and
  ``freqItemset`` and ``recommends`` equal the NumPy reference's bytes.
- The fused engine's attempts on both input forms: each ``fused_mine``
  span's ``attempt``, ``overflow_k``, ``needed``, ``live_rows`` and
  ``macs``, and the ``fused_outcome`` event, for a mine that regrows
  512 -> 1,024 -> 2,048 and completes, and for one whose memory budget
  puts the ceiling below the need, so that the level engine takes over.
- The cell's three readers (``fused_device_ms``, ``fused_regrow_ms``,
  ``fused_attempts``) on synthetic spans and device traces, and the
  cell run whole through the harness at the small size.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from fastapriori_tpu_torch import cli
from fastapriori_tpu_torch.config import MinerConfig
from fastapriori_tpu_torch.io.writer import save_freq_itemsets_levels
from fastapriori_tpu_torch.models.apriori import FastApriori
from fastapriori_tpu_torch.obs.trace import TRACER
from portbench import devtrace, gen
from portbench.reference import apriori
from portbench.tests import records
from portbench.tests.helpers import tiny_root

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "t40-batch"
CONFIG = "t40i10d100k"
# The cell's configuration with 1,500 transactions and 300 users, mined
# at min support 0.023: F = 842 at density 4.5 %, n2 = 227, so the first
# row budget is 512 and the lattice needs 2,048.
SMALL = {"n_txns": 1500, "n_users": 300, "min_support": 0.023}
LEVELS = [227, 474, 1013, 1610, 1568, 793, 154]


def _config(**cut):
    with open(os.path.join(ROOT, "portbench", "configs",
                           CONFIG + ".json")) as f:
        cfg = json.load(f)
    cfg.update(cut)
    return cfg


def _inputs(tmp_path, cfg, seed):
    made = gen.make_inputs(cfg, seed)
    d = tmp_path / "in"
    d.mkdir(parents=True)
    for name in ("D.dat", "U.dat"):
        (d / name).write_bytes(made[name])
    return str(d) + "/", made


def _reference(cfg, made):
    ref = apriori.Result(made["D.dat"], made["U.dat"],
                         float(cfg["min_support"]))
    assert [lv.shape[0] for lv, _ in ref.mined.levels] == LEVELS
    return ref


def _events(err, name):
    out = []
    for line in err.splitlines():
        if line.startswith("{"):
            rec = json.loads(line)
            if rec.get("event") == name:
                out.append(rec)
    return out


@pytest.fixture
def traced():
    """Spans recorded by the process's tracer, as the CLI records them
    under ``FA_TRACE``; switched off again afterwards."""
    TRACER.enable()
    yield
    TRACER.disable()
    TRACER.reset()


# ---------------------------------------------------------------------------
# the configuration


def test_configuration_is_t40i10d100k_uncut():
    cfg = _config()
    assert cfg["source"] == "http://fimi.uantwerpen.be/data/T40I10D100K.dat"
    assert (cfg["n_txns"], cfg["n_items"], cfg["avg_txn_len"],
            cfg["avg_pattern_len"], cfg["n_patterns"]) == (
                100_000, 1000, 40, 10, 2000)
    assert (cfg["min_support"], cfg["flags"], cfg["env"],
            cfg["reduced"]) == (0.01, [], {}, [])
    assert cfg["reference"] == "portbench/reference/apriori.py"
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    (cell,) = [w for w in bench["workloads"] if w["name"] == CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        CONFIG, "batch_closed", 1)
    (entry,) = [c for c in bench["configs"] if c["name"] == CONFIG]
    assert entry["file"] == f"portbench/configs/{CONFIG}.json"
    assert entry["source"] == cfg["source"] and entry["reduced"] == []


def test_inputs_have_the_rows_the_mean_length_and_a_relabelling_seed():
    cfg = _config(n_txns=4000, n_users=500)
    a, b = gen.make_inputs(cfg, 3), gen.make_inputs(cfg, 2**31 + 17)
    (flat, lens), (u_flat, u_lens) = a["D"], a["U"]
    assert lens.shape[0] == 4000 and u_lens.shape[0] == 500
    assert a["D.dat"].count(b"\n") == 4000
    assert 37.0 <= lens.mean() <= 43.0
    assert flat.min() >= 1 and flat.max() <= cfg["n_items"]
    # Another seed: the same corpus under other names and in another
    # order (the same lengths and the same item supports, sorted).
    assert a["D.dat"] != b["D.dat"]
    assert np.array_equal(np.sort(lens), np.sort(b["D"][1]))
    assert np.array_equal(
        np.sort(np.bincount(flat, minlength=cfg["n_items"] + 1)[1:]),
        np.sort(np.bincount(b["D"][0], minlength=cfg["n_items"] + 1)[1:]))
    assert gen.make_inputs(cfg, 3)["D.dat"] == a["D.dat"]


# ---------------------------------------------------------------------------
# the CLI with zero flags


@pytest.mark.parametrize("seed", [3, 4300002701])
def test_zero_flag_cli_takes_bitmap_and_fused_and_writes_the_references_bytes(
        seed, tmp_path, monkeypatch, capsys):
    monkeypatch.delenv("FA_MINE_ENGINE", raising=False)
    cfg = _config(**SMALL)
    in_dir, made = _inputs(tmp_path, cfg, seed)
    out = str(tmp_path / "out") + "/"
    assert cli.main([in_dir, out, "--min-support",
                     repr(float(cfg["min_support"])), "--platform", "cpu",
                     "--metrics"]) == 0
    err = capsys.readouterr().err
    (eng,) = _events(err, "mine_engine")
    assert eng["engine"] == "bitmap" and eng["requested"] == "auto"
    assert eng["density"] > 0.01
    (build,) = _events(err, "bitmap_build")
    assert build["l3_form"] == "dense"
    (auto,) = _events(err, "engine_auto")
    assert auto["choice"] == "fused" and auto["n2"] == LEVELS[0]
    (outcome,) = _events(err, "fused_outcome")
    assert outcome["completed"] is True and outcome["attempts"] == 3
    assert not _events(err, "level") and not _events(err, "fused_fallback")
    ref = _reference(cfg, made)
    with open(out + "freqItemset", "rb") as f:
        assert f.read() == ref.freq_itemset
    with open(out + "recommends", "rb") as f:
        assert f.read() == ref.recommends


# ---------------------------------------------------------------------------
# the fused engine's attempts


def _mine(tmp_path, cfg, blocks, **knobs):
    """The object API's mine of the small corpus on one input form
    (``blocks`` 4: the pipelined ingest's resident bitmap; 1: the
    one-call packed upload), and its freqItemset bytes."""
    in_dir, made = _inputs(tmp_path, cfg, 5)
    miner = FastApriori(config=MinerConfig(
        min_support=float(cfg["min_support"]), engine="auto",
        ingest_pipeline_blocks=blocks, ingest_threads=2, **knobs),
        device="cpu")
    levels, data = miner.run_file_raw(in_dir + "D.dat")
    out = str(tmp_path / "out") + "/"
    os.makedirs(out, exist_ok=True)
    save_freq_itemsets_levels(out, levels, data.freq_items, manifest={},
                              item_counts=data.item_counts)
    with open(out + "freqItemset", "rb") as f:
        return miner, f.read(), made


def _records(miner, name):
    return [r for r in miner.metrics.records if r["event"] == name]


def _fused_spans():
    return [e["args"] for e in TRACER.events()
            if e["ph"] == "X" and e["name"] == "fused_mine"]


@pytest.mark.parametrize("blocks", [4, 1], ids=["resident", "packed"])
def test_mine_regrows_twice_and_the_spans_say_so(tmp_path, blocks, traced):
    cfg = _config(**SMALL)
    miner, freq, made = _mine(tmp_path, cfg, blocks)
    assert freq == _reference(cfg, made).freq_itemset
    spans = _fused_spans()
    assert spans == [{k: v for k, v in r.items() if k != "event"}
                     for r in _records(miner, "fused_mine")]
    assert [s["attempt"] for s in spans] == [1, 2, 3]
    assert [s["m_cap"] for s in spans] == [512, 1024, 2048]
    assert all(s["packed_input"] == (blocks == 1) for s in spans)
    # Each attempt thrown away names its first level over the budget
    # and that level's survivors; the last one completes.
    assert [(s["incomplete"], s["overflow_k"], s["needed"])
            for s in spans] == [(True, 4, LEVELS[2]), (True, 5, LEVELS[3]),
                                (False, None, None)]
    # Each attempt's products ran over its levels' live rows: level 2's
    # Gram, then per loop iteration k the candidate, membership and
    # count products at level k - 1's rows rounded up to 256, at most the
    # budget, while level k - 1 fits it and holds k rows or more.
    t, f = 1504, 896  # the small corpus's padded bitmap; one weight digit
    for s in spans:
        live = []
        for k, m in enumerate(LEVELS, start=3):
            if m > s["m_cap"] or m < k:
                break
            live.append(min(s["m_cap"], -(-m // 256) * 256))
        assert s["live_rows"] == sum(live)
        assert s["macs"] == t * f * f + sum(
            2 * m * m * f + 2 * t * m * f for m in live)
    assert [s["live_rows"] for s in spans] == [768, 1792, 6656]
    (outcome,) = _records(miner, "fused_outcome")
    assert outcome == {
        "event": "fused_outcome", "attempts": 3, "m_cap": 2048,
        "completed": True, "handed_k": None,
        "wasted_macs": spans[0]["macs"] + spans[1]["macs"]}
    assert outcome["wasted_macs"] > 0
    assert not _records(miner, "fused_fallback")


@pytest.mark.parametrize("blocks", [4, 1], ids=["resident", "packed"])
def test_ceiling_below_the_need_hands_over_to_the_level_engine(
        tmp_path, blocks):
    """A memory budget between the 1,024- and the 2,048-row attempts'
    models puts the ceiling at 1,024: both attempts overflow, levels 2-4
    are salvaged and the level engine mines from level 5."""
    cfg = _config(**SMALL)
    free, _, _ = _mine(tmp_path / "free", cfg, blocks)
    model = {r["m_cap"]: r["model_bytes"]
             for r in _records(free, "fused_mine")}
    budget = (model[1024] + model[2048]) // 2
    miner, freq, made = _mine(tmp_path / "capped", cfg, blocks,
                              fused_hbm_budget_bytes=budget)
    assert freq == _reference(cfg, made).freq_itemset
    attempts = _records(miner, "fused_mine")
    assert [(r["attempt"], r["m_cap"], r["overflow_k"], r["needed"])
            for r in attempts] == [(1, 512, 4, LEVELS[2]),
                                   (2, 1024, 5, LEVELS[3])]
    (outcome,) = _records(miner, "fused_outcome")
    assert outcome == {
        "event": "fused_outcome", "attempts": 2, "m_cap": 1024,
        "completed": False, "handed_k": 5,
        "wasted_macs": attempts[0]["macs"]}
    (fb,) = _records(miner, "fused_fallback")
    assert fb["resume_levels"] == 3
    (res,) = _records(miner, "level_resume")
    assert res["from_k"] == outcome["handed_k"]
    assert {r["k"] for r in _records(miner, "level")} >= {5, 6, 7, 8}


# ---------------------------------------------------------------------------
# the readers


class _Run:
    def __init__(self, spans=None, jobs=(), trace_=None):
        self.records = {"jobs": list(jobs)}
        if spans is not None:
            self.records["spans"] = spans
        if trace_ is not None:
            self.records["trace"] = trace_


def _spans(rows):
    """Spans from ``(name, start s, end s, args)`` rows."""
    sp = devtrace.Spans()
    sp.add_tracer_events([{"ph": "X", "name": n, "ts_us": t0 * 1e6,
                           "dur_us": (t1 - t0) * 1e6, "thread": "main",
                           "args": args}
                          for n, t0, t1, args in rows], epoch=0.0)
    return sp


# Two jobs: the first regrows twice (two attempts thrown away), the
# second completes at its first budget.
JOBS = [(0.0, 10.0), (10.0, 20.0)]
ROWS = [
    ("bitmap_build", 0.5, 1.0, {}), ("pair_program", 0.6, 0.7, {}),
    ("fused_mine", 1.0, 2.0, {"attempt": 1, "incomplete": True}),
    ("fused_mine", 2.0, 3.5, {"attempt": 2, "incomplete": True}),
    ("fused_mine", 3.5, 6.0, {"attempt": 3, "incomplete": False}),
    ("fused_mine", 11.0, 13.0, {"attempt": 1, "incomplete": False}),
]
OPS = [
    ("kernel", 0.65, 0.007),      # the pair program: no reader's
    ("kernel", 1.2, 0.100),       # attempt 1
    ("gpu_memcpy", 1.5, 0.050),   # a copy, not a kernel
    ("kernel", 2.5, 0.200),       # attempt 2
    ("kernel", 4.0, 0.400),       # attempt 3
    ("kernel", 7.0, 0.300),       # rules, after the mine
    ("kernel", 12.0, 0.500),      # the second job's attempt
    ("kernel", np.nan, 0.900),    # no launch recorded
]


@pytest.mark.parametrize("name,value", [
    ("fused_device_ms", (0.100 + 0.200 + 0.400 + 0.500) * 1e3 / 2),
    ("fused_regrow_ms", (1.0 + 1.5) * 1e3 / 2),
    ("fused_attempts", 4 / 2),
])
def test_fused_readers_on_synthetic_records(name, value):
    got = records.reader(name).read(
        _Run(_spans(ROWS), JOBS, records.device_trace(OPS)))
    assert got == pytest.approx(value)


def test_regrow_reads_zero_where_every_attempt_completed():
    rows = [r for r in ROWS if not r[3].get("incomplete")]
    run = _Run(_spans(rows), JOBS, records.device_trace(OPS))
    assert records.reader("fused_regrow_ms").read(run) == 0.0
    assert records.reader("fused_attempts").read(run) == pytest.approx(1.0)


@pytest.mark.parametrize("name", ["fused_device_ms", "fused_regrow_ms",
                                  "fused_attempts"])
def test_fused_readers_find_nothing_without_a_fused_attempt(name):
    read = records.reader(name).read
    tr = records.device_trace(OPS)
    # The vertical path's spans, the level engine's, no spans, no jobs.
    vertical = _spans([("arena_build", 0.5, 1.0, {}),
                       ("level", 1.0, 3.0, {"k": 2}),
                       ("vertical_pairs", 1.2, 2.0, {}),
                       ("vertical_count", 3.2, 3.4, {"k": 3})])
    level = _spans([("bitmap_build", 0.5, 1.0, {}),
                    ("level", 1.0, 6.0, {"k": 3})])
    assert read(_Run(vertical, JOBS, tr)) is None
    assert read(_Run(level, JOBS, tr)) is None
    assert read(_Run(None, JOBS, tr)) is None
    assert read(_Run(_spans(ROWS), [], tr)) is None
    if name == "fused_device_ms":
        # No trace, or only a copy launched in the fused spans.
        assert read(_Run(_spans(ROWS), JOBS, None)) is None
        assert read(_Run(_spans(ROWS), JOBS, records.device_trace([
            ("gpu_memcpy", 1.2, 0.1), ("kernel", 7.0, 0.3)]))) is None


# ---------------------------------------------------------------------------
# the cell through the harness


def test_cell_runs_whole_through_the_harness(tmp_path):
    """The cell through ``portbench/run.py``'s ``main`` on the CPU with a
    traced window, in a process of its own (the harness refuses a process
    that loaded JAX, as this one has): correct against the reference, the
    span readers report three attempts a job, and the device readers find
    no kernel on the CPU."""
    root = tiny_root(tmp_path)
    path = os.path.join(root, "portbench", "configs", CONFIG + ".json")
    with open(path, "w") as f:
        json.dump(_config(**SMALL), f)
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from portbench import run; sys.exit(run.main(["
            "'--workload', sys.argv[2], '--seed', '4300002703', "
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
    metrics = line["metrics"]
    for name in ("ingest_ms", "layout_build_ms", "mine_levels_ms",
                 "rules_ms", "recommend_ms", "user_input_ms", "write_ms",
                 "job_unspanned_ms", "fused_regrow_ms"):
        assert metrics[name]["value"] > 0, name
    assert metrics["fused_attempts"] == {"value": 3.0, "unit": "attempts"}
    assert metrics["fused_regrow_ms"]["value"] < metrics[
        "mine_levels_ms"]["value"]
    for name in ("fused_device_ms", "pair_program_device_ms",
                 "count_roofline_pct", "vertical_pair_device_ms"):
        assert name not in metrics
