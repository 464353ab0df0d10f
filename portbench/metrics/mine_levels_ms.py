"""mine_levels_ms: the level loop (`level`, `tail_fuse`, `fused_mine`,
`counts_resolve` sections, their union), per job, from the program's
spans."""

from portbench.readers import span_ms_per_unit


def read(run):
    return span_ms_per_unit(
        run, ("level", "tail_fuse", "fused_mine", "counts_resolve"))
