"""write_ms: the artifact writes (`write` sections: freqItemset,
recommends and the manifest after each phase, the lines' formatting and
the fsync included), per job, from the program's spans."""

from portbench.readers import span_ms_per_unit


def read(run):
    return span_ms_per_unit(run, ("write",))
