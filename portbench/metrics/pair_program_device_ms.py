"""pair_program_device_ms: device time of the kernels launched under the
`pair_program` span (the pair program's launch call, inside
`bitmap_build`), per job; None where no such kernel ran."""


def read(run):
    tr = run.records.get("trace")
    spans = run.records.get("spans")
    n = len(run.records.get("jobs", ()))
    if tr is None or spans is None or not n \
            or not spans.of(("pair_program",)):
        return None
    device_s = tr.kernel_s_launched_in(spans.intervals(("pair_program",)))
    if device_s <= 0:
        return None
    return device_s * 1e3 / n
