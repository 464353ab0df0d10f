"""ingest_ms: the `preprocess` section (native capture ingest, the
layout probe, block packing), per job, from the program's spans."""

from portbench.readers import span_ms_per_unit


def read(run):
    return span_ms_per_unit(run, ("preprocess",))
