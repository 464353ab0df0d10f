"""The output writers' layout (``fastapriori_tpu_torch/io/writer.py``).

``freqItemset``, ``freqItems`` (``--save-counts``) and ``recommends`` are
built whole, as one chunk, by the native library's ``fa_format_lines``
and, when the library is unavailable, by NumPy and ``list.sort``.  Each
case writes the artifacts both ways and holds the two to the bytes that
the benchmark's plain reference (``portbench/reference/apriori.py``
``freq_itemset_bytes``, ``recommends_bytes``) builds, line by line, and
to the same manifest entries: item strings that are prefixes of one
another, multi-byte UTF-8, no levels past the 1-itemsets, a level with
no rows, a level of k = 15, counts, rows given out of order, the
``write.freqItemset`` truncation failpoint, and the ``write`` spans'
``lines`` and ``formatter`` with their ``write_format`` child.  Then the
benchmark's ``write_format_ms`` reader, on synthetic spans and in the
``t10-batch`` cell run small on the CPU.
"""

import hashlib
import json
import os
import random
import subprocess
import sys

import numpy as np
import pytest

from fastapriori_tpu_torch.io import writer
from fastapriori_tpu_torch.native import loader
from fastapriori_tpu_torch.obs.trace import TRACER
from fastapriori_tpu_torch.reliability import failpoints, ledger
from portbench.reference import apriori
from portbench.tests import records
from portbench.tests.helpers import ROOT


@pytest.fixture(autouse=True)
def _clean_state():
    def clean():
        failpoints.disarm_all()
        ledger.reset()
        TRACER.disable()
        TRACER.reset()

    clean()
    yield
    clean()


def _levels(rng, n_items, shape):
    """Random distinct ascending rank rows, ``shape`` = [(k, rows), ...],
    each row with a count."""
    out = []
    for k, n in shape:
        rows = set()
        while len(rows) < n:
            rows.add(tuple(sorted(rng.sample(range(n_items), k))))
        mat = np.array(sorted(rows), dtype=np.int32).reshape(n, k)
        cnts = np.array([rng.randrange(1, 10**7) for _ in range(n)],
                        dtype=np.int64)
        out.append((mat, cnts))
    return out


def _case(name):
    """(items, levels, item counts) of a named case."""
    rng = random.Random(name)
    if name.startswith("random"):
        items = [str(x) for x in rng.sample(range(10_000), 60)]
        shape = [(2, 300), (3, 200), (4, 80), (5, 20)]
    elif name == "prefixes":
        items = ["1", "12", "123", "1a", "2", "12a", "a", "", "0"]
        shape = [(2, 20), (3, 40), (4, 20)]
    elif name == "utf8":
        items = ["é", "e", "ü", "日本", "日", "a", "ß", "\U0001f600", "z",
                 "éa", "E"]
        shape = [(2, 40), (3, 60), (5, 10)]
    elif name == "ones_only":
        items = [str(x) for x in range(25)]
        shape = []
    elif name == "empty_level":
        items = [str(x) for x in range(30)]
        shape = [(2, 50), (3, 0)]
    elif name == "k15":
        items = [str(x) for x in rng.sample(range(100), 20)]
        shape = [(2, 60), (14, 5), (15, 3)]
    elif name == "large_mixed":
        # Buckets of hundreds of lines a byte deep, past the sort's
        # comparison cut-off, with prefixes and multi-byte items in them.
        items = [str(x) for x in rng.sample(range(1000), 150)] + [
            "1", "12", "123", "1a", "é", "éa", "日本", "日", ""]
        shape = [(2, 3000), (3, 3000), (4, 1500), (6, 400)]
    else:  # "one_first_byte": every line starts with the same bytes
        items = ["item" + str(x) for x in rng.sample(range(500), 80)]
        shape = [(2, 1500), (3, 1500), (5, 300)]
    counts = np.array([rng.randrange(1, 10**9) for _ in items],
                      dtype=np.int64)
    return items, _levels(rng, len(items), shape), counts


CASES = ["random0", "random1", "prefixes", "utf8", "ones_only",
         "empty_level", "k15", "large_mixed", "one_first_byte"]


def _reference_itemsets(items, levels, counts=None):
    """``freq_itemset_bytes``' construction over string items: every
    1-itemset, each level row's tokens in descending rank order, one
    space apart (``[count]`` after the line with ``counts``), the lines
    sorted, each ended by a newline."""
    tok = np.array(items, dtype=object)
    lines = list(items) if counts is None else [
        f"{t}[{int(c)}]" for t, c in zip(items, counts)]
    for mat, cnts in levels:
        for row, c in zip(tok[mat[:, ::-1]].tolist(), cnts.tolist()):
            lines.append(" ".join(row) + ("" if counts is None
                                          else f"[{c}]"))
    lines.sort()
    return "".join(line + "\n" for line in lines).encode()


def _entry(data):
    return {"bytes": len(data), "sha256": hashlib.sha256(data).hexdigest()}


def _both_ways(tmp_path, monkeypatch, save, names):
    """``save(prefix, manifest)`` with the native library, then with it
    unavailable: per side the files' bytes, the manifest and the
    ``write`` spans' args by artifact, after checking each span's one
    ``write_format`` child."""
    out = {}
    for side in ("native", "python"):
        if side == "python":
            monkeypatch.setattr(loader, "get_lib", lambda: None)
        prefix = str(tmp_path / side) + "/"
        manifest = {}
        TRACER.reset()
        TRACER.enable()
        save(prefix, manifest)
        TRACER.disable()
        events = [e for e in TRACER.events() if e["ph"] == "X"]
        writes = {e["args"]["artifact"]: e for e in events
                  if e["name"] == "write"}
        for name in names:
            children = [e for e in events if e["name"] == "write_format"
                        and e["parent"] == writes[name]["sid"]]
            assert len(children) == 1, (side, name)
        files = {}
        for name in names:
            with open(prefix + name, "rb") as f:
                files[name] = f.read()
        out[side] = (files, manifest,
                     {n: writes[n]["args"] for n in names})
    return out


@pytest.mark.parametrize("with_counts", [False, True],
                         ids=["freqItemset", "freqItems"])
@pytest.mark.parametrize("case", CASES)
def test_itemset_files_equal_the_reference_both_ways(
        tmp_path, monkeypatch, case, with_counts):
    items, levels, counts = _case(case)
    names = ["freqItemset"] + (["freqItems"] if with_counts else [])
    got = _both_ways(
        tmp_path, monkeypatch,
        lambda prefix, manifest: writer.save_freq_itemsets_levels(
            prefix, levels, items, manifest=manifest, item_counts=counts,
            with_counts_path=with_counts),
        names)
    want = {"freqItemset": _reference_itemsets(items, levels),
            "freqItems": _reference_itemsets(items, levels, counts)}
    n_lines = len(items) + sum(len(mat) for mat, _ in levels)
    for side, (files, manifest, spans) in got.items():
        for name in names:
            assert files[name] == want[name], (side, name)
            assert manifest[name] == _entry(want[name])
            assert spans[name]["lines"] == n_lines
            assert spans[name]["formatter"] == side
            assert spans[name]["bytes"] == len(want[name])
    assert got["native"][1] == got["python"][1]


@pytest.mark.parametrize("case", ["random0", "random1", "k15"])
def test_numeric_items_equal_freq_itemset_bytes(tmp_path, case):
    items, levels, _ = _case(case)
    mined = apriori.Mined()
    mined.items = np.array([int(t) for t in items], dtype=np.int64)
    mined.levels = levels
    writer.save_freq_itemsets_levels(str(tmp_path) + "/", levels, items)
    assert (tmp_path / "freqItemset").read_bytes() == \
        apriori.freq_itemset_bytes(mined)


@pytest.mark.parametrize("with_counts", [False, True])
@pytest.mark.parametrize("case", ["prefixes", "utf8"])
def test_pair_writers_equal_the_level_writer(tmp_path, case, with_counts):
    items, levels, counts = _case(case)
    pairs = [(frozenset([r]), int(c)) for r, c in enumerate(counts)]
    for mat, cnts in levels:
        pairs += [(frozenset(row), c)
                  for row, c in zip(mat.tolist(), cnts.tolist())]
    random.Random(case).shuffle(pairs)
    save = (writer.save_freq_itemsets_with_count if with_counts
            else writer.save_freq_itemsets)
    save(str(tmp_path) + "/", pairs, items)
    name = "freqItems" if with_counts else "freqItemset"
    assert (tmp_path / name).read_bytes() == _reference_itemsets(
        items, levels, counts if with_counts else None)


@pytest.mark.parametrize("n_rows", [0, 1, 7, 2_000])
def test_recommends_in_row_order_both_ways(tmp_path, monkeypatch, n_rows):
    rng = random.Random(n_rows)
    pool = ["0", "12", "é", "1", "日本", ""]
    items = [rng.choice(pool) for _ in range(n_rows)]
    recs = list(enumerate(items))
    rng.shuffle(recs)
    got = _both_ways(
        tmp_path, monkeypatch,
        lambda prefix, manifest: writer.save_recommends(
            prefix, recs, manifest=manifest),
        ["recommends"])
    want = apriori.recommends_bytes(items)
    for side, (files, manifest, spans) in got.items():
        assert files["recommends"] == want, side
        assert manifest["recommends"] == _entry(want)
        assert spans["recommends"]["lines"] == n_rows
        assert spans["recommends"]["formatter"] == side


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_truncation_failpoint_cuts_the_bytes_not_the_manifest(
        tmp_path, monkeypatch, native):
    items, levels, _ = _case("utf8")
    want = _reference_itemsets(items, levels)
    if not native:
        monkeypatch.setattr(loader, "get_lib", lambda: None)
    failpoints.arm("write.freqItemset", "truncate@37")
    manifest = {}
    writer.save_freq_itemsets_levels(str(tmp_path) + "/", levels, items,
                                     manifest=manifest)
    assert (tmp_path / "freqItemset").read_bytes() == want[:37]
    assert not (tmp_path / "freqItemset.tmp").exists()
    assert manifest["freqItemset"] == _entry(want)


def test_format_lines_refuses_token_ids_out_of_range():
    with pytest.raises(ValueError, match="out of range"):
        loader.format_lines(["a", "b"], [np.array([[0, 2]])])
    with pytest.raises(ValueError, match="out of range"):
        loader.format_lines(["a", "b"], [np.array([[-1]])])


# ---------------------------------------------------------------------------
# the benchmark's reader of the layout span


class _Run:
    def __init__(self, spans, jobs):
        self.records = {"jobs": list(jobs), "spans": spans}


def test_write_format_reader_reads_the_layout_spans_per_job():
    read = records.reader("write_format_ms").read
    jobs = [(0.0, 10.0), (10.0, 20.0)]
    rows = [("write", 1.0, 2.0), ("write_format", 1.0, 1.5),
            ("fsync", 1.8, 2.0), ("write", 12.0, 12.5),
            ("write_format", 12.0, 12.25)]
    assert read(_Run(records.spans(rows), jobs)) == pytest.approx(
        (0.5 + 0.25) * 1e3 / 2)
    # The parent's program opens no such span: nothing to read.
    parent = [r for r in rows if r[0] != "write_format"]
    assert read(_Run(records.spans(parent), jobs)) is None


def test_write_format_metric_is_listed_for_every_cell():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    entry = [m for m in bench["per_layer"] if m["name"] == "write_format_ms"]
    cells = [w["name"] for w in bench["workloads"]]
    assert entry == [{"name": "write_format_ms", "unit": "ms",
                      "better": "lower", "source": "program_span",
                      "layer": "writers", "moves": "job_s",
                      "workloads": cells}]


SCRIPT = """
import json, sys
sys.path.insert(0, sys.argv[1])
from portbench.tests.helpers import run_cell, tiny_root
import pathlib
rc, line, err = run_cell(tiny_root(pathlib.Path(sys.argv[2])), "t10-batch",
                         seed=4300003001, seconds=0.5, trace=1)
print(json.dumps({"rc": rc, "line": line, "err": err[-3000:]}))
"""


def test_t10_cell_reports_the_layout_inside_the_writes(tmp_path):
    """The cell at the harness's tiny size on the CPU, traced, in a
    process of its own (the harness refuses a process that loaded JAX):
    correct, and ``write_format_ms`` read inside ``write_ms``."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("FA_", "PYTEST_"))}
    proc = subprocess.run([sys.executable, "-c", SCRIPT, ROOT,
                           str(tmp_path)], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["rc"] == 0, got["err"]
    assert got["line"]["correct"] is True, got["line"]["checks"]
    metrics = got["line"]["metrics"]
    assert 0 < metrics["write_format_ms"]["value"] < \
        metrics["write_ms"]["value"]
