"""ckpt_ms: the per-level checkpoint commits (`checkpoint` sections, one
after each completed level under --checkpoint-every-level: the npz built
in memory, its atomic write and fsync, the manifest's merge, write and
fsync), host ms per job, from the program's spans; None where no job
committed."""

from portbench.readers import span_ms_per_unit


def read(run):
    return span_ms_per_unit(run, ("checkpoint",))
