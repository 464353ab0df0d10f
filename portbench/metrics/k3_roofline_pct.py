"""k3_roofline_pct: the least time for the window's counting work at
levels k >= 3 (every job, from the reference's candidates and contained
pairs; roofline_levels.py) over the device time of the kernels launched
under the `vertical_count` spans (K3's launches); None where none ran."""

from portbench.readers import roofline_pct
from portbench.roofline_levels import count_least_s_from


def read(run):
    ref = run.records.get("ref")
    if ref is None or not run.records.get("jobs"):
        return None
    least = len(run.records["jobs"]) * count_least_s_from(ref.mined, 3)
    return roofline_pct(run, least, ("vertical_count",))
