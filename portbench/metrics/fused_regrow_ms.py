"""fused_regrow_ms: host ms per job under the `fused_mine` spans whose
args say `incomplete`: the fused engine's attempts whose row budget (or
level bound) did not hold the lattice, so that a larger budget started
again from level 2, or the level engine took over from their complete
levels.  0 where every attempt completed; None where no fused attempt
ran."""

import numpy as np

from portbench import devtrace


def read(run):
    spans = run.records.get("spans")
    n = len(run.records.get("jobs", ()))
    if spans is None or not n:
        return None
    idx = spans.of(("fused_mine",))
    if not idx:
        return None
    iv = np.array([[spans.t0[i], spans.t1[i]] for i in idx
                   if spans.args[i].get("incomplete")]).reshape(-1, 2)
    iv = devtrace.merge(iv)
    return float((iv[:, 1] - iv[:, 0]).sum()) * 1e3 / n
