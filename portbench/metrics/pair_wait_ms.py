"""pair_wait_ms: the host's wait for the pair program's packed output
(the audited fetch `fetch.pair_pre`, at the engine choice or at level 2),
per job, from the program's spans: the part of the pair program's device
time that the host's own work does not hide."""

from portbench.readers import span_ms_per_unit


def read(run):
    return span_ms_per_unit(run, ("fetch.pair_pre",))
