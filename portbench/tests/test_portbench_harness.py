"""The harness is driven by data, its file keeps to the contract, and a
run with its timed path broken comes out not correct.

Runs drive the port's CPU path at a tiny size in a temporary copy of the
benchmark (``helpers.tiny_root``), with the look for a card skipped.
"""

import hashlib
import json
import os
import re

import pytest

from portbench.tests.helpers import ROOT, run_cell, tiny_root

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _bench():
    return json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_benchmark_file_keeps_to_the_contract():
    b = _bench()
    assert set(b) == TOP_KEYS
    assert b["command"] == ["python3", "portbench/run.py"]
    assert b["paths"] == ["portbench"]
    assert 1 <= b["run_seconds"] <= 51
    configs = {c["name"] for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and \
            _line(c["why"])
        assert c["file"].startswith("portbench/configs/")
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert all(NAME.match(k) for k in c["reduced"])
    used = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert _line(w["why"])
        assert os.path.isfile(os.path.join(
            ROOT, "portbench", "mixes", w["traffic"] + ".json"))
        used.add(w["config"])
    assert used == configs
    cells = {w["name"] for w in b["workloads"]}
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    e2e = {}
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        e2e[m["name"]] = set(m.get("workloads", cells))
    assert e2e["setup_s"] == cells
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and _line(m["layer"])
        assert set(m["workloads"]) <= e2e[m["moves"]]
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert os.path.isfile(os.path.join(ROOT, "portbench", "metrics",
                                           m["name"] + ".py"))
    for cell in cells:  # setup_s, one more end-to-end, one per-layer
        assert sum(cell in s for s in e2e.values()) >= 2
        assert any(cell in m["workloads"] for m in b["per_layer"])
    assert len(json.dumps(b)) <= 64 * 1024


def _tree_digest(root: str) -> dict:
    out = {}
    for dirpath, _, files in os.walk(os.path.join(root, "portbench")):
        for f in files:
            p = os.path.join(dirpath, f)
            out[os.path.relpath(p, root)] = hashlib.sha256(
                open(p, "rb").read()).hexdigest()
    return out


def test_a_configuration_mix_and_metric_are_added_as_files(tmp_path):
    root = tiny_root(tmp_path)
    before = _tree_digest(root)
    pb = os.path.join(root, "portbench")
    cfg = json.load(open(os.path.join(pb, "configs", "t10i4d100k.json")))
    cfg.update(name="t10-small", n_txns=2000, min_support=0.03)
    json.dump(cfg, open(os.path.join(pb, "configs", "t10-small.json"), "w"))
    mix = json.load(open(os.path.join(pb, "mixes", "batch_closed.json")))
    mix.update(name="batch_one_dir", out_dirs=1, warm_jobs=1)
    json.dump(mix, open(os.path.join(pb, "mixes", "batch_one_dir.json"),
                        "w"))
    with open(os.path.join(pb, "metrics", "jobs_seen.py"), "w") as f:
        f.write("def read(run):\n    return len(run.records['jobs'])\n")
    b = json.load(open(os.path.join(root, "BENCHMARK.json")))
    b["configs"].append({"name": "t10-small", "source": "x",
                         "file": "portbench/configs/t10-small.json",
                         "reduced": ["n_txns"], "why": "test"})
    b["workloads"].append({"name": "t10-small.one", "config": "t10-small",
                           "traffic": "batch_one_dir", "chips": 1,
                           "why": "test"})
    b["end_to_end"].append({"name": "jobs_seen", "unit": "jobs",
                            "better": "higher", "bound": 0.1,
                            "source": "host_clock",
                            "workloads": ["t10-small.one"]})
    json.dump(b, open(os.path.join(root, "BENCHMARK.json"), "w"))
    rc, line, err = run_cell(root, "t10-small.one", seconds=1.0)
    assert rc == 0, err[-2000:]
    assert line["correct"] is True
    assert set(line["metrics"]) == {"setup_s", "jobs_seen"}
    assert line["metrics"]["jobs_seen"]["value"] == line["attempted"] > 0
    assert list(line)[-1] == "checks"
    assert set(line) >= {"correct", "attempted", "failed", "metrics",
                         "device"}
    after = _tree_digest(root)
    assert {k: v for k, v in after.items() if k in before} == before


@pytest.mark.parametrize("workload,trace", [
    ("t10-batch", 0), ("t10-batch", 1)])
def test_a_sound_run_is_correct(tmp_path, workload, trace):
    root = tiny_root(tmp_path)
    rc, line, err = run_cell(root, workload, trace=trace)
    assert rc == 0, err[-2000:]
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    b = json.load(open(os.path.join(root, "BENCHMARK.json")))
    want = [m["name"] for m in (b["per_layer"] if trace else
                                b["end_to_end"])
            if workload in m.get("workloads", [workload])]
    # On the CPU the device's numbers have nothing to read.
    got = set(line["metrics"])
    assert got <= set(want)
    if not trace:
        assert got == set(want)
    assert err.rstrip().splitlines()[-1].startswith("check ")


def _half_input(monkeypatch):
    from fastapriori_tpu_torch.models import apriori

    orig = apriori.FastApriori.run_file_raw

    def half(self, d_path):
        data = open(d_path, "rb").read().split(b"\n")
        part = d_path + ".half"
        with open(part, "wb") as f:
            f.write(b"\n".join(data[: len(data) // 2]) + b"\n")
        return orig(self, part)

    monkeypatch.setattr(apriori.FastApriori, "run_file_raw", half)


def _altered_answer(monkeypatch):
    from fastapriori_tpu_torch.io import writer

    orig = writer.save_recommends

    def altered(prefix, recommends, manifest=None):
        recs = sorted(recommends, key=lambda x: x[0])
        row, item = recs[0]
        recs[0] = (row, "999999" if item != "999999" else "0")
        return orig(prefix, recs, manifest)

    monkeypatch.setattr(writer, "save_recommends", altered)


def _unchanged_state(monkeypatch):
    from fastapriori_tpu_torch import cli

    monkeypatch.setattr(cli, "_phases", lambda *a, **k: None)


@pytest.mark.parametrize("fault", [_half_input, _altered_answer,
                                   _unchanged_state])
def test_a_broken_batch_job_is_not_correct(tmp_path, monkeypatch, fault):
    fault(monkeypatch)
    rc, line, err = run_cell(tiny_root(tmp_path), "t10-batch")
    assert rc == 0, err[-2000:]
    assert line["correct"] is False


def _float32_confidences(monkeypatch):
    """The port's rule table ranked and reported in float32."""
    from fastapriori_tpu_torch.models import recommender

    orig = recommender.sort_rule_arrays

    def rounded(survivors, freq_items):
        return orig([(a, c, cf.astype("float32").astype("float64"))
                     for a, c, cf in survivors], freq_items)

    monkeypatch.setattr(recommender, "sort_rule_arrays", rounded)


def test_a_port_ranking_in_float32_is_not_correct(tmp_path, monkeypatch):
    _float32_confidences(monkeypatch)
    rc, line, err = run_cell(tiny_root(tmp_path), "t10-batch")
    assert rc == 0, err[-2000:]
    assert line["correct"] is False
    assert line["checks"]["rules_wrong_jobs"]["value"] == line["attempted"]


@pytest.mark.parametrize("precision,correct", [
    ("float64", True), ("float32", False), ("bfloat16", False)])
def test_the_control_is_not_correct(tmp_path, precision, correct):
    """The reference in the port's place, driven through the batch
    driver's own comparison: at the configuration's float64 it passes, at
    float32 (the nearest step below) and bfloat16 it is refused."""
    from portbench import control

    rc, line, err = run_cell(tiny_root(tmp_path), "t10-batch",
                             jobs=control.reference_jobs(precision))
    assert rc == 0, err[-2000:]
    assert line["attempted"] > 0
    assert line["correct"] is correct, line["checks"]
    if not correct:
        assert line["checks"]["rules_wrong_jobs"]["value"] == \
            line["attempted"]


def test_no_card_no_result(tmp_path, capsys):
    from portbench import run

    root = tiny_root(tmp_path)
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = run.main(["--workload", "t10-batch", "--seed", "1", "--seconds",
                   "1", "--trace", "0"], root=root)
    out = capsys.readouterr()
    assert rc != 0 and out.out.strip() == ""
