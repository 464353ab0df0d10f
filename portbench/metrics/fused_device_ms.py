"""fused_device_ms: device time of the kernels launched under the
`fused_mine` spans (the fused engine's attempts, one span each, those
thrown away included), per job; None where no fused attempt ran (the
vertical path, or the level engine)."""

from portbench.span_device import device_ms_per_job


def read(run):
    return device_ms_per_job(run, ("fused_mine",))
