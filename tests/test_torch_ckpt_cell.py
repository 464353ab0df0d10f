"""The crash-safe batch cell (``t10-ckpt-batch``) on the CPU at a small
size.

- The configuration: FIMI T10I4D100K uncut, as ``t10-batch`` mines it,
  with ``--checkpoint-every-level`` at the default cadence of 1.
- The reference's checkpoint side (``portbench/reference/checkpoint.py``)
  against the port's writer: the levels through the job's item table,
  the meta, a cut that the port resumes from.
- The cell's four readers (``ckpt_ms``, ``ckpt_mb``,
  ``level_loop_device_ms``, ``level_loop_roofline_pct``) on synthetic
  spans and device traces, and None where no span ran.
- The cell run whole through ``portbench/run.py`` at a small size: a
  sound run is correct with every commit counted, and three broken ones
  are refused by the checks made for them: a job that skips one commit,
  a checkpoint with one support off by one, a resume that writes wrong
  bytes.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from fastapriori_tpu_torch.config import MinerConfig
from fastapriori_tpu_torch.io import checkpoint as ckpt
from fastapriori_tpu_torch.models.apriori import FastApriori
from portbench import devtrace, gen
from portbench.reference import apriori
from portbench.reference import checkpoint as ref_ckpt
from portbench.tests import records
from portbench.tests.helpers import tiny_root

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "t10-ckpt-batch"
CONFIG = "t10i4d100k-ckpt"
# The configuration with 2,000 transactions and 300 users at min support
# 0.005: F = 760 over the 1,000 items, levels 2-10 as in the full corpus.
SMALL = {"n_txns": 2000, "n_users": 300, "min_support": 0.005}
LEVELS = [1021, 1190, 1148, 860, 499, 216, 65, 12, 1]
# Keys the crash-safe configuration states beyond T10's, or states anew.
OWN = {"name", "source", "deployment", "flags", "guarantees", "assumed"}


def _config(name=CONFIG, **cut):
    with open(os.path.join(ROOT, "portbench", "configs",
                           name + ".json")) as f:
        cfg = json.load(f)
    cfg.update(cut)
    return cfg


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# the configuration


def test_configuration_is_t10_uncut_with_the_flag():
    cfg, t10 = _config(), _config("t10i4d100k")
    assert {k: v for k, v in cfg.items() if k not in OWN} == {
        k: v for k, v in t10.items() if k not in OWN}
    assert cfg["flags"] == ["--checkpoint-every-level"]
    assert cfg["reduced"] == [] and cfg["env"] == {}
    assert cfg["assumed"][:-1] == t10["assumed"]
    assert "checkpointInterval" in cfg["assumed"][-1]
    assert cfg["guarantees"].startswith(t10["guarantees"])
    assert cfg["reference"] == "portbench/reference/apriori.py"
    bench = _bench()
    (cell,) = [w for w in bench["workloads"] if w["name"] == CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        CONFIG, "batch_ckpt_closed", 1)
    (entry,) = [c for c in bench["configs"] if c["name"] == CONFIG]
    assert entry["file"] == f"portbench/configs/{CONFIG}.json"
    assert entry["source"] == cfg["source"] and entry["reduced"] == []
    (t10_entry,) = [c for c in bench["configs"] if c["name"] == "t10i4d100k"]
    assert entry["source"] != t10_entry["source"]
    with open(os.path.join(ROOT, "portbench", "mixes",
                           "batch_ckpt_closed.json")) as f:
        mix = json.load(f)
    assert (mix["driver"], mix["warm_jobs"], mix["out_dirs"]) == (
        "batch_ckpt", 2, 2)


def test_the_cell_reports_job_s_and_the_readers_that_find_spans_there():
    bench = _bench()
    (job_s,) = [m for m in bench["end_to_end"] if m["name"] == "job_s"]
    assert CELL in job_s["workloads"]
    listed = {m["name"] for m in bench["per_layer"]
              if CELL in m["workloads"]}
    assert {"ckpt_ms", "ckpt_mb", "level_loop_device_ms",
            "level_loop_roofline_pct", "mine_levels_ms", "write_ms",
            "fsync_ms", "pair_program_device_ms"} <= listed
    assert not listed & {"fused_device_ms", "fused_regrow_ms",
                         "fused_attempts", "k3_device_ms",
                         "vertical_pair_device_ms"}
    for m in bench["per_layer"]:
        if m["name"].startswith(("ckpt_", "level_loop_")):
            assert m["workloads"] == [CELL] and m["moves"] == "job_s"


# ---------------------------------------------------------------------------
# the reference's checkpoint side against the port's writer


@pytest.fixture(scope="module")
def small_mine(tmp_path_factory):
    """The small corpus mined by the port with a checkpoint after every
    level, its checkpoint's path, and the reference."""
    tmp = tmp_path_factory.mktemp("ckpt_cell")
    cfg = _config(**SMALL)
    made = gen.make_inputs(cfg, 4300002905)
    (tmp / "D.dat").write_bytes(made["D.dat"])
    prefix = str(tmp / "ck") + "/"
    miner = FastApriori(config=MinerConfig(
        min_support=cfg["min_support"], checkpoint_prefix=prefix),
        device="cpu")
    levels, data = miner.run_file_raw(str(tmp / "D.dat"))
    ref = apriori.Result(made["D.dat"], made["U.dat"], cfg["min_support"])
    assert [lv.shape[0] for lv, _ in ref.mined.levels] == LEVELS
    return {"tmp": tmp, "prefix": prefix, "levels": levels, "data": data,
            "ref": ref, "path": prefix + ckpt.CHECKPOINT_NAME}


def test_reference_reads_the_ports_checkpoint_through_its_item_table(
        small_mine):
    m = small_mine
    mined, table = m["ref"].mined, m["data"].freq_items
    assert ref_ckpt.matches(m["path"], mined, table)
    got, meta = ref_ckpt.read(m["path"])
    assert meta == {"n_raw": 2000, "min_count": 10, "num_items": 760,
                    "fence": 0}
    assert meta == dict(ref_ckpt.expected_meta(mined), fence=0)
    want = ref_ckpt.expected_levels(mined, table)
    for (gm, gc), (wm, wc), (pm, pc) in zip(got, want, m["levels"]):
        assert gm.dtype == np.int32 and gc.dtype == np.int64
        assert np.array_equal(gm, wm) and np.array_equal(gc, wc)
        assert np.array_equal(gm, pm) and np.array_equal(gc, pc)
    assert [lv.shape[0] for lv, _ in got] == LEVELS


def test_reference_refuses_a_changed_checkpoint_or_table(small_mine):
    m = small_mine
    mined, table = m["ref"].mined, list(m["data"].freq_items)
    levels, meta = ckpt.load_checkpoint(m["prefix"])
    meta = {k: meta[k] for k in ("n_raw", "min_count", "num_items")}
    bad = str(m["tmp"] / "bad") + "/"
    # One support off by one.
    off = [(mat, cnt.copy()) for mat, cnt in levels]
    off[2][1][7] += 1
    ckpt.save_checkpoint(bad, off, meta)
    assert not ref_ckpt.matches(bad + ckpt.CHECKPOINT_NAME, mined, table)
    # A level short, and another min count.
    ckpt.save_checkpoint(bad, levels[:-1], meta)
    assert not ref_ckpt.matches(bad + ckpt.CHECKPOINT_NAME, mined, table)
    ckpt.save_checkpoint(bad, levels, dict(meta, min_count=11))
    assert not ref_ckpt.matches(bad + ckpt.CHECKPOINT_NAME, mined, table)
    # Two items swapped in the table, or not the reference's items.
    swapped = table[:]
    swapped[0], swapped[1] = swapped[1], swapped[0]
    assert not ref_ckpt.matches(m["path"], mined, swapped)
    assert ref_ckpt.expected_levels(mined, table[:-1]) is None
    # Not an npz at all.
    with open(bad + "junk.npz", "wb") as f:
        f.write(b"not a checkpoint")
    assert not ref_ckpt.matches(bad + "junk.npz", mined, table)


def test_the_cut_resumes_to_the_clean_levels(small_mine):
    m = small_mine
    cut = str(m["tmp"] / "cut") + "/"
    os.makedirs(cut, exist_ok=True)
    ref_ckpt.cut(m["path"], 4, cut + ckpt.CHECKPOINT_NAME)
    levels, meta = ckpt.load_checkpoint(cut)
    assert [mat.shape[1] for mat, _ in levels] == [2, 3, 4, 5]
    for (gm, gc), (wm, wc) in zip(levels, m["levels"]):
        assert np.array_equal(gm, wm) and np.array_equal(gc, wc)
    resumed = FastApriori(config=MinerConfig(
        min_support=SMALL["min_support"]), device="cpu")
    resumed.set_resume_levels(levels, meta, label=cut)
    got = resumed.run_file_raw(str(m["tmp"] / "D.dat"))[0]
    assert len(got) == len(m["levels"])
    for (gm, gc), (wm, wc) in zip(got, m["levels"]):
        assert np.array_equal(gm, wm) and np.array_equal(gc, wc)
    with pytest.raises(ValueError):
        ref_ckpt.cut(m["path"], 10, cut + "x.npz")


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


def _spans(rows):
    """Spans from ``(name, start s, end s, args)`` rows."""
    sp = devtrace.Spans()
    sp.add_tracer_events([{"ph": "X", "name": n, "ts_us": t0 * 1e6,
                           "dur_us": (t1 - t0) * 1e6, "thread": "main",
                           "args": args}
                          for n, t0, t1, args in rows], epoch=0.0)
    return sp


# Two jobs: levels 2-3 from the pair program, then K1's own levels, a
# commit after each; the second job's last levels in a fold.
JOBS = [(0.0, 10.0), (10.0, 20.0)]
ROWS = [
    ("bitmap_build", 0.5, 1.0, {}), ("pair_program", 0.6, 0.7, {}),
    ("level", 1.0, 1.1, {"k": 2}),
    ("checkpoint", 1.1, 1.2, {"levels": 1, "k": 2, "bytes": 1000}),
    ("level", 1.2, 1.3, {"k": 3}),
    ("checkpoint", 1.3, 1.5, {"levels": 2, "k": 3, "bytes": 3000}),
    ("level", 1.5, 2.0, {"k": 4}),
    ("checkpoint", 2.0, 2.3, {"levels": 3, "k": 4, "bytes": 5000}),
    ("tail_fuse", 11.0, 12.0, {"k0": 3}),
    ("checkpoint", 12.0, 12.4, {"levels": 3, "k": 4, "bytes": 5000}),
]
OPS = [
    ("kernel", 0.65, 0.007),      # the pair program: no reader's
    ("kernel", 1.6, 0.020),       # K1 at level 4
    ("gpu_memcpy", 1.7, 0.050),   # a copy, not a kernel
    ("kernel", 2.1, 0.300),       # under a commit: no reader's
    ("kernel", 11.5, 0.060),      # the fold
    ("kernel", np.nan, 0.900),    # no launch recorded
]


class _Mined:
    """The reference's work at levels 2..5 (roofline_levels' inputs)."""
    n_freq = 384
    n_baskets = 1000
    work = [{"k": k, "candidates": 100, "pairs": 10_000}
            for k in (2, 3, 4, 5)]


def _least_k4():
    from portbench.roofline_levels import count_least_s_from

    return count_least_s_from(_Mined, 4)


@pytest.mark.parametrize("name,value", [
    ("ckpt_ms", (0.1 + 0.2 + 0.3 + 0.4) * 1e3 / 2),
    ("ckpt_mb", (1000 + 3000 + 5000 + 5000) / 1e6 / 2),
    ("level_loop_device_ms", (0.020 + 0.060) * 1e3 / 2),
    ("level_loop_roofline_pct", None),
])
def test_ckpt_readers_on_synthetic_records(name, value):
    class Ref:
        mined = _Mined

    got = records.reader(name).read(
        _Run(_spans(ROWS), JOBS, records.device_trace(OPS), Ref))
    if value is None:  # two jobs' k >= 4 work over the kernels' time
        value = 100.0 * 2 * _least_k4() / (0.020 + 0.060)
    assert got == pytest.approx(value)


@pytest.mark.parametrize("name", ["ckpt_ms", "ckpt_mb",
                                  "level_loop_device_ms",
                                  "level_loop_roofline_pct"])
def test_ckpt_readers_find_nothing_where_no_span_ran(name):
    class Ref:
        mined = _Mined

    read = records.reader(name).read
    tr = records.device_trace(OPS)
    # The fused engine's spans (no commit, no level), no spans, no jobs.
    fused = _spans([("bitmap_build", 0.5, 1.0, {}),
                    ("fused_mine", 1.0, 3.0, {"attempt": 1})])
    assert read(_Run(fused, JOBS, tr, Ref)) is None
    assert read(_Run(None, JOBS, tr, Ref)) is None
    assert read(_Run(_spans(ROWS), [], tr, Ref)) is None
    if name == "ckpt_mb":
        # Commits whose spans carry no ``bytes`` arg (an older program).
        old = _spans([(n, t0, t1, {k: v for k, v in a.items()
                                   if k != "bytes"})
                      for n, t0, t1, a in ROWS])
        assert read(_Run(old, JOBS, tr, Ref)) is None
    if name.startswith("level_loop"):
        # No trace, or only a copy launched under the level spans.
        assert read(_Run(_spans(ROWS), JOBS, None, Ref)) is None
        assert read(_Run(_spans(ROWS), JOBS, records.device_trace([
            ("gpu_memcpy", 1.6, 0.1), ("kernel", 2.1, 0.3)]), Ref)) is None


# ---------------------------------------------------------------------------
# the cell through the harness

# Faults put into the port before a run (none for the sound run), each
# where one check must see it: a job that skips its level-4 commit;
# every commit's level 3 with one support off by one; a resume that
# drops one itemset of every resumed level.
FAULTS = {
    "sound": "",
    "skip_commit": """
from fastapriori_tpu_torch.models.apriori import FastApriori
orig = FastApriori._checkpoint_levels
def fault(self, levels, data):
    if levels[-1][0].shape[1] != 4:
        orig(self, levels, data)
FastApriori._checkpoint_levels = fault
""",
    "support_off": """
from fastapriori_tpu_torch.io import checkpoint
orig = checkpoint.save_checkpoint
def fault(prefix, levels, meta):
    levels = list(levels)
    if len(levels) >= 2:
        mat, cnt = levels[1]
        cnt = cnt.copy()
        cnt[0] += 1
        levels[1] = (mat, cnt)
    return orig(prefix, levels, meta)
checkpoint.save_checkpoint = fault
""",
    "resume_wrong": """
from fastapriori_tpu_torch.models.apriori import FastApriori
orig = FastApriori.set_resume_levels
def fault(self, levels, meta=None, label="checkpoint"):
    return orig(self, [(m[:-1], c[:-1]) for m, c in levels], meta, label)
FastApriori.set_resume_levels = fault
""",
}
SCRIPT = """
import json, sys
sys.path.insert(0, sys.argv[1])
from portbench.tests.helpers import run_cell
exec(sys.argv[3], {})
rc, line, err = run_cell(sys.argv[1], "t10-ckpt-batch", seed=4300002907,
                         seconds=0.5, trace=int(sys.argv[3] == ""))
print(json.dumps({"rc": rc, "line": line, "err": err[-3000:]}))
"""


def _cell_run(tmp_path, fault):
    """One run of the cell in a process of its own (the harness refuses a
    process that loaded JAX), on the small configuration, with ``fault``
    put into the port first; the sound run is traced."""
    root = tiny_root(tmp_path)
    path = os.path.join(root, "portbench", "configs", CONFIG + ".json")
    with open(path, "w") as f:
        json.dump(_config(**SMALL), f)
    os.symlink(os.path.join(ROOT, "portbench", "tests"),
               os.path.join(root, "portbench", "tests"))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("FA_", "PYTEST_"))}
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT, root, CELL, FAULTS[fault]],
        cwd=root, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _checks(got):
    assert got["rc"] == 0, got["err"]
    return {k: v["value"] for k, v in got["line"]["checks"].items()}


def test_cell_runs_whole_through_the_harness(tmp_path):
    """A traced run on the CPU: correct, a commit at each of the nine
    levels, the resume equal to the reference; the span readers report,
    the device readers find no kernel on the CPU."""
    got = _cell_run(tmp_path, "sound")
    checks = _checks(got)
    assert got["line"]["correct"] is True, checks
    assert set(checks) >= {"ckpt_commits_wrong_jobs", "ckpt_wrong_jobs",
                           "ckpt_resume_wrong", "freqItemset_wrong_jobs"}
    assert "commits [1, 2, 3, 4, 5, 6, 7, 8, 9]" in got["err"]
    assert "resume from levels 2..5: exit 0, the reference bytes" in \
        got["err"]
    metrics = got["line"]["metrics"]
    for name in ("ckpt_ms", "ckpt_mb", "mine_levels_ms", "write_ms",
                 "fsync_ms"):
        assert metrics[name]["value"] > 0, name
    # Nine commits: the final npz and the eight before it.
    assert 0.2 < metrics["ckpt_mb"]["value"] < 2.0
    for name in ("level_loop_device_ms", "level_loop_roofline_pct",
                 "fused_attempts"):
        assert name not in metrics


@pytest.mark.parametrize("fault,check", [
    ("skip_commit", "ckpt_commits_wrong_jobs"),
    ("support_off", "ckpt_wrong_jobs"),
    ("resume_wrong", "ckpt_resume_wrong"),
])
def test_a_broken_durability_path_is_refused(tmp_path, fault, check):
    got = _cell_run(tmp_path, fault)
    checks = _checks(got)
    assert got["line"]["correct"] is False
    assert checks[check] >= 1
    # The mined files stay right: the fault is the checkpoint's alone.
    assert checks["freqItemset_wrong_jobs"] == 0
    assert checks["recommends_wrong_jobs"] == 0
    if fault == "skip_commit":
        assert checks["ckpt_commits_wrong_jobs"] == got["line"]["attempted"]
        assert checks["ckpt_wrong_jobs"] == checks["ckpt_resume_wrong"] == 0
    if fault == "resume_wrong":
        assert checks["ckpt_commits_wrong_jobs"] == 0
        assert checks["ckpt_wrong_jobs"] == 0
