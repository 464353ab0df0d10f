"""scan_roofline_pct.batch: the least time for the window's first-match
work (each distinct basket scanned to its first match, from the
reference; roofline.py) over the device time of the kernels launched in
the `first_match` sections."""

from portbench import roofline
from portbench.readers import roofline_pct


def read(run):
    ref = run.records.get("ref")
    if ref is None or not run.records.get("jobs"):
        return None
    least = len(run.records["jobs"]) * roofline.scan_least_s(ref)
    return roofline_pct(run, least, ("first_match",))
