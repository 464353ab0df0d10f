"""count_roofline_pct: the least time for the window's counting work
(every level of every job, from the reference's candidates and contained
pairs; roofline.py) over the device time of every kernel launched while
the mine ran (the `mine` span: ingest's packing, the pair program, the
levels, the folds)."""

from portbench import roofline
from portbench.readers import roofline_pct


def read(run):
    ref = run.records.get("ref")
    if ref is None or not run.records.get("jobs"):
        return None
    least = len(run.records["jobs"]) * roofline.count_least_s(ref.mined)
    return roofline_pct(run, least, ("mine",))
