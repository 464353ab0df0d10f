"""job_unspanned_ms: per job, the harness's job interval
(``run.records["jobs"]``) less the union of every span that a per-layer
metric reads, so nested and overlapping spans count once.  The frame
spans `run` and `phase` are left out: they cover the whole job and name
nothing in it."""

import numpy as np

READ_SPANS = (
    "preprocess",                                  # ingest_ms
    "bitmap_build", "arena_build",                 # layout_build_ms
    "level", "tail_fuse", "fused_mine", "counts_resolve",  # mine_levels_ms
    "gen_rules",                                   # rules_ms
    "first_match",                                 # recommend_ms
    "read_users", "user_dedup", "user_fanout",     # user_input_ms
    "write",                                       # write_ms
    "job_setup",                                   # job_setup_ms
    "fetch.pair_pre",                              # pair_wait_ms
)


def read(run):
    spans = run.records.get("spans")
    jobs = run.records.get("jobs")
    if spans is None or not jobs or not spans.of(READ_SPANS):
        return None
    iv = spans.intervals(READ_SPANS)
    dark = 0.0
    for t0, t1 in jobs:
        cut = np.clip(iv, t0, t1)
        dark += (t1 - t0) - float((cut[:, 1] - cut[:, 0]).sum())
    return dark * 1e3 / len(jobs)
