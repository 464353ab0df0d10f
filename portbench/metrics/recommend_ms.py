"""recommend_ms: the first-match scan with its table (`first_match`),
per job, from the program's spans."""

from portbench.readers import span_ms_per_unit


def read(run):
    return span_ms_per_unit(run, ("first_match",))
