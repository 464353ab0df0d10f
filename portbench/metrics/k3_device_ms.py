"""k3_device_ms: device time of the kernels launched under the
`vertical_count` spans (one a K3 launch of the vertical level loop,
levels k >= 3), per job; None where no such kernel ran."""

from portbench.span_device import device_ms_per_job


def read(run):
    return device_ms_per_job(run, ("vertical_count",))
