"""level_loop_device_ms: device time of the kernels launched under the
`level` and `tail_fuse` spans (the level engine's own levels, K1 or K3,
and any tail fold or fused segment), per job; None where no such kernel
ran."""

from portbench.span_device import device_ms_per_job


def read(run):
    return device_ms_per_job(run, ("level", "tail_fuse"))
