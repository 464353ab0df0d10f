"""layout_build_ms: the bitmap assembly or the tid arena build and
upload (`bitmap_build` / `arena_build`), per job, from the program's
spans."""

from portbench.readers import span_ms_per_unit


def read(run):
    return span_ms_per_unit(run, ("bitmap_build", "arena_build"))
