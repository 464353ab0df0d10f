"""device_idle_pct.batch: share of the traced window with no kernel, copy
or fill on the card (torch.profiler)."""

from portbench.readers import idle_pct


def read(run):
    return idle_pct(run)
