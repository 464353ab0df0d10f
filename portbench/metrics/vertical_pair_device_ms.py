"""vertical_pair_device_ms: device time of the kernels launched under
the `vertical_pairs` span (the vertical engine's level 2: the pair
products over the tid arena's lane chunks and their threshold, inside
level 2's `level`), per job; None where no such kernel ran."""

from portbench.span_device import device_ms_per_job


def read(run):
    return device_ms_per_job(run, ("vertical_pairs",))
