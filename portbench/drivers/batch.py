"""Batch jobs, closed loop: one whole CLI run after another in this
process (read ``D.dat`` and ``U.dat``, mine, rules, recommend, write
``freqItemset`` and ``recommends``), for the run's seconds.

Jobs write to ``out_dirs`` directories in turn; a directory's two files
are hashed before the next job reuses it, and the rule table each job
builds (``AssociationRules.rule_arrays``: the priority-ordered rules
with their float64 confidences, which the recommendation scan reads) is
kept by reference.  After the window the reference computes both files
and its rule table once from the same input, and every job is compared
with them: its files byte for byte through their SHA-256, its table
rule for rule (``rule_table_matches``).

What runs a job is ``run.jobs``, a context manager factory; by default
the port's CLI (:func:`port_jobs`).  The controls (``control.py``) put
the reference at a lower precision in its place.
"""

from __future__ import annotations

import contextlib
import gc
import hashlib
import os
import time

import numpy as np

from portbench import devtrace, harness
from portbench.reference import apriori

FILES = ("freqItemset", "recommends")


@contextlib.contextmanager
def port_jobs(run: harness.Run, in_dir: str, argv_tail: list, publish):
    """The system under test: ``job(out_dir)`` runs the port's CLI in this
    process and returns its exit code.  Each rule table a job builds is
    handed to ``publish(freq_items, arrays)`` as the recommender returns
    it (a wrapper around ``AssociationRules.rule_arrays``, removed
    afterwards)."""
    from fastapriori_tpu_torch import cli
    from fastapriori_tpu_torch.models.recommender import AssociationRules

    orig = AssociationRules.rule_arrays

    def rule_arrays(self):
        out = orig(self)
        publish(self.freq_items, out)
        return out

    AssociationRules.rule_arrays = rule_arrays
    try:
        yield lambda out: cli.main([in_dir, out] + argv_tail)
    finally:
        AssociationRules.rule_arrays = orig


def rule_table_matches(ref: apriori.Result, freq_items, arrays) -> bool:
    """A job's rule table against the reference's: the same number of
    rules; confidence and consequent item equal at every position of the
    priority order (float64 values compared exactly); and the same rules,
    each antecedent's items as a set, with their confidences.  ``arrays``
    is the port's ``(ant ranks [R, k] 0-padded, lens [R], cons ranks [R],
    conf float64 [R])`` over ``freq_items``."""
    ant, lens, cons, conf = (np.asarray(a) for a in arrays)
    rules = ref.rules
    if conf.dtype != np.float64 or cons.shape[0] != len(rules):
        return False
    items = np.array([int(x) for x in freq_items], dtype=np.int64)
    want_cons = ref.mined.items[rules.cons]
    if not (np.array_equal(conf, rules.conf.astype(np.float64))
            and np.array_equal(items[cons], want_cons)):
        return False
    width = max(ant.shape[1], rules.ant.shape[1])

    def canonical(ids, valid, cons_ids, cf):
        a = np.where(valid, ids, -1)
        a = np.sort(np.where(a < 0, np.iinfo(np.int64).max, a), axis=1)
        a = np.pad(a, ((0, 0), (0, width - a.shape[1])),
                   constant_values=np.iinfo(np.int64).max)
        rows = np.concatenate([cons_ids[:, None],
                               np.ascontiguousarray(cf).view(np.int64)[:, None],
                               a], axis=1)
        return rows[np.lexsort(rows.T[::-1])]

    col = np.arange(ant.shape[1])[None, :]
    got = canonical(items[ant], col < lens[:, None], items[cons], conf)
    ref_ant = rules.ant
    want = canonical(ref.mined.items[np.maximum(ref_ant, 0)], ref_ant >= 0,
                     want_cons, rules.conf.astype(np.float64))
    return np.array_equal(got, want)


def _digest(out_dir: str) -> tuple:
    """The SHA-256 of each output file (None for a file the job did not
    write); the files are removed, so a job that writes nothing cannot
    pass with an earlier job's."""
    out = []
    for name in FILES:
        path = os.path.join(out_dir, name)
        try:
            with open(path, "rb") as f:
                out.append(hashlib.sha256(f.read()).hexdigest())
        except FileNotFoundError:
            out.append(None)
            continue
        os.remove(path)
    return tuple(out)


def run(run: harness.Run) -> None:
    from fastapriori_tpu_torch.obs import trace

    # The CLI records spans when FA_TRACE says so (set for a traced run);
    # the flag is read anew here, not from an earlier run in the process.
    trace.reload_from_env()

    cfg, mix = run.config, run.mix
    in_dir = os.path.join(run.dir, "in") + "/"
    os.makedirs(in_dir, exist_ok=True)
    for name in ("D.dat", "U.dat"):
        with open(in_dir + name, "wb") as f:
            f.write(run.inputs[name])
    outs = []
    for i in range(int(mix["out_dirs"])):
        outs.append(os.path.join(run.dir, f"out{i}") + "/")
        os.makedirs(outs[-1], exist_ok=True)
    argv_tail = ["--min-support", repr(float(cfg["min_support"]))]
    argv_tail += list(cfg.get("flags", []))
    if run.platform == "cpu":
        argv_tail += ["--platform", "cpu"]
    tables: list = []  # per job, the rule tables it built

    def publish(freq_items, arrays) -> None:
        if tables and not any(a is arrays for _, a in tables[-1]):
            tables[-1].append((list(freq_items), arrays))

    with (run.jobs or port_jobs)(run, in_dir, argv_tail, publish) as job:
        _jobs(run, job, outs, tables)


def _jobs(run: harness.Run, job, outs: list, tables: list) -> None:
    from fastapriori_tpu_torch.obs import trace

    cfg, mix = run.config, run.mix
    for i in range(int(mix["warm_jobs"])):
        tables.append([])
        rc = job(outs[i % len(outs)])
        if rc != 0:
            raise harness.CellError(f"warm-up job {i} exited {rc}")
        _digest(outs[i % len(outs)])
    del tables[:]
    # What set-up left (imports, the warm-up's objects) is moved out of
    # the cyclic collector's reach, as a long-lived service does: its full
    # passes then walk the window's own objects, not every module's.
    gc.collect()
    gc.freeze()

    spans = devtrace.Spans()
    cap = (devtrace.Capture(os.path.join(run.dir, "window.trace.json"))
           if run.trace else contextlib.nullcontext())
    digests, times, codes = [], [], []
    pending = [None] * len(outs)  # the job whose files each dir holds
    first_bytes = None
    with cap, harness.GcWatch() as gcw:
        run.t_window0 = time.perf_counter()
        while time.perf_counter() - run.t_window0 < run.seconds:
            slot = len(times) % len(outs)
            if pending[slot] is not None:
                digests[pending[slot]] = _digest(outs[slot])
            tables.append([])
            t0 = time.perf_counter()
            rc = job(outs[slot])
            t1 = time.perf_counter()
            times.append((t0, t1))
            codes.append(rc)
            digests.append(None)
            pending[slot] = len(times) - 1 if rc == 0 else None
            if run.trace:
                spans.add_tracer_events(trace.TRACER.events(),
                                        devtrace.tracer_epoch())
            if first_bytes is None and rc == 0:
                first_bytes = []
                for name in FILES:
                    path = os.path.join(outs[slot], name)
                    with contextlib.suppress(FileNotFoundError), \
                            open(path, "rb") as f:
                        first_bytes.append(f.read())
        t_end = time.perf_counter()
    for slot, j in enumerate(pending):
        if j is not None:
            digests[j] = _digest(outs[slot])
    run.attempted = len(times)
    run.failed = sum(1 for rc in codes if rc != 0)
    run.records.update(jobs=times, window=(run.t_window0, t_end),
                       spans=spans)
    run.values["setup_s"] = run.t_window0 - run.t_start
    run.values["job_s"] = (t_end - run.t_window0) / max(len(times), 1)
    harness.log(f"{len(times)} jobs in {t_end - run.t_window0:.3f} s, "
                f"{run.failed} failed; Python's collector: {gcw.summary()}; "
                "job walls (s): " + " ".join(f"{b - a:.4f}" for a, b in times))
    run.read_device_memory()
    if run.trace:
        run.records["trace"] = devtrace.window_device(run, cap, spans,
                                                      harness.log)
    # The program's state is freed before the reference runs.
    gc.unfreeze()
    gc.collect()
    run.free_device()

    t = time.perf_counter()
    ref = apriori.Result(run.inputs["D.dat"], run.inputs["U.dat"],
                         float(cfg["min_support"]))
    harness.log(f"reference: {time.perf_counter() - t:.3f} s, "
                f"{len(ref.rules)} rules, {ref.mined.n_freq} frequent "
                f"items, levels {[lv.shape[0] for lv, _ in ref.mined.levels]}")
    run.records["ref"] = ref
    want = (hashlib.sha256(ref.freq_itemset).hexdigest(),
            hashlib.sha256(ref.recommends).hexdigest())
    wrong = [sum(1 for d in digests if d is None or d[i] != want[i])
             for i in range(len(FILES))]
    rules_wrong = sum(
        1 for built in tables
        if len(built) != 1 or not rule_table_matches(ref, *built[0]))
    if tables and len(tables[0]) == 1:
        _, (_, _, cons, conf) = tables[0][0]
        n = min(len(conf), len(ref.rules))
        harness.log(
            f"first job's rule table: {len(conf)} rules against "
            f"{len(ref.rules)}; confidences differing at "
            f"{int((np.asarray(conf[:n]) != ref.rules.conf[:n]).sum())} "
            "positions")
    if first_bytes is not None and len(first_bytes) == len(FILES):
        for name, got, exp in zip(FILES, first_bytes,
                                  (ref.freq_itemset, ref.recommends)):
            if got != exp:
                a, b = got.split(b"\n"), exp.split(b"\n")
                i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                         min(len(a), len(b)))
                harness.log(f"first job's {name} differs from the "
                            f"reference at line {i + 1}: "
                            f"{a[i:i + 1]!r} against {b[i:i + 1]!r} "
                            f"({len(a) - 1} lines against {len(b) - 1})")
    run.check("jobs_failed", run.failed, 0)
    run.check("freqItemset_wrong_jobs", wrong[0], 0)
    run.check("recommends_wrong_jobs", wrong[1], 0)
    run.check("rules_wrong_jobs", rules_wrong, 0)
    run.check("jobs_short", 0 if times else 1, 0)
