"""job_setup_ms: the CLI job's set-up between the tracer's enable and the
first phase (`job_setup`: the device context, the miner, the first
rendezvous), per job, from the program's spans."""

from portbench.readers import span_ms_per_unit


def read(run):
    return span_ms_per_unit(run, ("job_setup",))
