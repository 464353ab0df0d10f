"""write_format_ms: the layout of the formatted artifacts (`write_format`
sections inside `freqItemset`'s, `freqItems`' and `recommends`' `write`:
the lines built, sorted and laid out as one chunk before the first byte
is written), per job, from the program's spans.  None where the program
opens no such span."""

from portbench.readers import span_ms_per_unit


def read(run):
    return span_ms_per_unit(run, ("write_format",))
