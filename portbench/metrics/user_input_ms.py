"""user_input_ms: the per-user side of the recommendation: reading
``U.dat``, deduplicating the baskets and handing each distinct basket's
answer back to its users (the union of the `read_users`, `user_dedup`
and `user_fanout` sections), per job, from the program's spans."""

from portbench.readers import span_ms_per_unit


def read(run):
    return span_ms_per_unit(run, ("read_users", "user_dedup", "user_fanout"))
