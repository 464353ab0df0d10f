"""job_s: the whole window over the jobs completed in it (host clock); a
job is one whole CLI run, from reading the inputs to the written files."""


def read(run):
    return run.values.get("job_s")
