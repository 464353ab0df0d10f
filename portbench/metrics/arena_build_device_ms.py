"""arena_build_device_ms: device time of the kernels launched under the
`arena_build` span (the vertical engine's layout build: on the card the
arena kernels from the basket CSR and the weight planes' lane mask), per
job; None where no such kernel ran."""

from portbench.span_device import device_ms_per_job


def read(run):
    return device_ms_per_job(run, ("arena_build",))
