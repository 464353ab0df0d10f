"""The counting roofline of some levels only: ``roofline.count_least_s``
over the reference's levels k >= ``k_min``, so a share over one engine's
kernels charges the same work whatever counts it."""

from __future__ import annotations

import types

from portbench import roofline


def count_least_s_from(mined, k_min: int) -> float:
    """One mine's counting work at levels ``k >= k_min``; at ``k_min`` 2
    it is ``roofline.count_least_s``."""
    return roofline.count_least_s(types.SimpleNamespace(
        n_freq=mined.n_freq, n_baskets=mined.n_baskets,
        work=[w for w in mined.work if w["k"] >= k_min]))
