"""fsync_ms: the durable tail of the artifact writes (`fsync` sections:
flush, fsync, close and the atomic rename), per job, from the program's
spans."""

from portbench.readers import span_ms_per_unit


def read(run):
    return span_ms_per_unit(run, ("fsync",))
