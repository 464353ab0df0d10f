"""level_loop_roofline_pct: the least time for the window's counting work
at levels k >= 4 (every job, from the reference's candidates and
contained pairs; roofline_levels.py) over the device time of the kernels
launched under the `level` and `tail_fuse` spans, so the same work is
charged whatever engine counts it; None where no such kernel ran."""

from portbench.readers import roofline_pct
from portbench.roofline_levels import count_least_s_from


def read(run):
    ref = run.records.get("ref")
    if ref is None or not run.records.get("jobs"):
        return None
    least = len(run.records["jobs"]) * count_least_s_from(ref.mined, 4)
    return roofline_pct(run, least, ("level", "tail_fuse"))
