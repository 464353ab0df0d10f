"""rules_ms: the rule join, prune and priority sort (`gen_rules`), per
job, from the program's spans."""

from portbench.readers import span_ms_per_unit


def read(run):
    return span_ms_per_unit(run, ("gen_rules",))
