"""Crash-safe batch jobs, closed loop: the batch driver's jobs
(``drivers/batch.py``, reused whole) run with the configuration's
``--checkpoint-every-level``, and each job is also held to its
durability guarantee.

Inside the window, around each job: every call the job makes to the
port's ``io.checkpoint.save_checkpoint`` is recorded with the number of
levels it commits (a wrapper, removed afterwards, as the batch driver
wraps ``rule_arrays``); after the job its ``checkpoint.npz`` is hashed
and removed with the run manifest beside it, so a job that commits
nothing cannot pass with an earlier job's file.  The first window job's
checkpoint bytes are kept.  Nothing is read back inside the window.

After the window and the batch driver's own checks, three more, each
with limit 0:

- ``ckpt_commits_wrong_jobs``: jobs whose commits are not one per level
  2..L (L the reference's deepest level), each holding one level more
  than the last;
- ``ckpt_wrong_jobs``: jobs whose checkpoint's SHA-256 differs from the
  verified one: the kept bytes, read with ``np.load`` and equal to the
  reference's levels through that job's item table, with int64 supports
  and the reference's meta (``reference/checkpoint.py``);
- ``ckpt_resume_wrong``: one ``--resume-from`` job, outside the window,
  from the verified checkpoint cut to levels 2..5 (rewritten in plain
  NumPy): 1 unless it exits 0 and writes the reference's
  ``freqItemset`` and ``recommends`` bytes.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import shutil

from portbench import harness
from portbench.drivers import batch
from portbench.reference import checkpoint as ref_ckpt

CKPT = "checkpoint.npz"
MANIFEST = "MANIFEST.json"
# The resume job starts from levels 2..5, as a job killed after level 5.
RESUME_LEVELS = 4


def _take_checkpoint(out_dir: str):
    """The bytes of the job's checkpoint (None where it wrote none); the
    file and the manifest beside it are removed."""
    raw = None
    with contextlib.suppress(FileNotFoundError), \
            open(os.path.join(out_dir, CKPT), "rb") as f:
        raw = f.read()
    for name in (CKPT, MANIFEST):
        with contextlib.suppress(FileNotFoundError):
            os.remove(os.path.join(out_dir, name))
    return raw


class Jobs:
    """What each job of the run committed: per job (warm-up included, in
    order) the levels of each ``save_checkpoint`` call and its
    checkpoint's digest; the first window job's checkpoint bytes and item
    table."""

    def __init__(self, warm: int):
        self.warm = warm
        self.commits: list = []
        self.digests: list = []
        self.table = None  # the running job's item table
        self.first = None  # (checkpoint bytes, item table)

    def factory(self, inner):
        """A ``run.jobs`` factory around ``inner`` (the port's, or a
        control's)."""

        @contextlib.contextmanager
        def jobs(run, in_dir, argv_tail, publish):
            from fastapriori_tpu_torch.io import checkpoint

            orig = checkpoint.save_checkpoint

            def save_checkpoint(prefix, levels, meta):
                self.commits[-1].append(len(levels))
                return orig(prefix, levels, meta)

            def table(freq_items, arrays) -> None:
                if self.table is None:
                    self.table = list(freq_items)
                publish(freq_items, arrays)

            checkpoint.save_checkpoint = save_checkpoint
            try:
                with inner(run, in_dir, argv_tail, table) as job:
                    yield lambda out: self._job(job, out)
            finally:
                checkpoint.save_checkpoint = orig

        return jobs

    def _job(self, job, out: str) -> int:
        self.commits.append([])
        self.table = None
        rc = job(out)
        raw = _take_checkpoint(out)
        self.digests.append(None if raw is None
                            else hashlib.sha256(raw).hexdigest())
        if (self.first is None and rc == 0 and raw is not None
                and len(self.digests) > self.warm):
            self.first = (raw, self.table or [])
        return rc


def run(run: harness.Run) -> None:
    jobs = Jobs(int(run.mix["warm_jobs"]))
    inner = run.jobs or batch.port_jobs
    run.jobs = jobs.factory(inner)
    try:
        batch.run(run)
    finally:
        run.jobs = inner
    ref = run.records["ref"]
    n_levels = len(ref.mined.levels)
    commits = jobs.commits[jobs.warm:]
    digests = jobs.digests[jobs.warm:]
    commits_wrong = sum(1 for c in commits if c != list(
        range(1, n_levels + 1)))
    verified = None
    kept = os.path.join(run.dir, "first_" + CKPT)
    with contextlib.suppress(FileNotFoundError):
        os.remove(kept)
    if jobs.first is not None:
        raw, table = jobs.first
        with open(kept, "wb") as f:
            f.write(raw)
        if ref_ckpt.matches(kept, ref.mined, table):
            verified = hashlib.sha256(raw).hexdigest()
    ckpt_wrong = sum(1 for d in digests if verified is None or d != verified)
    harness.log(
        f"checkpoints: {n_levels} levels in the reference; first window "
        f"job's commits {commits[0] if commits else None}, its checkpoint "
        f"{'verified' if verified else 'not verified'}; "
        f"{len(set(digests))} distinct digests in {len(digests)} jobs")
    resume_wrong = 1
    if verified is not None:
        resume_wrong = _resume_job(run, kept, min(RESUME_LEVELS,
                                                  n_levels - 1) or 1)
    run.check("ckpt_commits_wrong_jobs", commits_wrong, 0)
    run.check("ckpt_wrong_jobs", ckpt_wrong, 0)
    run.check("ckpt_resume_wrong", resume_wrong, 0)


def _resume_job(run: harness.Run, path: str, keep: int) -> int:
    """One ``--resume-from`` job from the checkpoint at ``path`` cut to its
    first ``keep`` levels: 0 when it exits 0 with the reference's two
    files, else 1."""
    from fastapriori_tpu_torch import cli

    ref = run.records["ref"]
    src = os.path.join(run.dir, "resume_from") + "/"
    out = os.path.join(run.dir, "resume_out") + "/"
    for d in (src, out):
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
    ref_ckpt.cut(path, keep, src + CKPT)
    argv = [os.path.join(run.dir, "in") + "/", out, "--min-support",
            repr(float(run.config["min_support"]))]
    argv += list(run.config.get("flags", []))
    if run.platform == "cpu":
        argv += ["--platform", "cpu"]
    rc = cli.main(argv + ["--resume-from", src])
    got = []
    for name in batch.FILES:
        with contextlib.suppress(FileNotFoundError), \
                open(out + name, "rb") as f:
            got.append(f.read())
    ok = rc == 0 and got == [ref.freq_itemset, ref.recommends]
    harness.log(f"resume from levels 2..{keep + 1}: exit {rc}, "
                f"{'the reference bytes' if ok else 'wrong bytes'}")
    return 0 if ok else 1
