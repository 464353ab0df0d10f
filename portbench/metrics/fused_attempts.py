"""fused_attempts: the fused engine's attempts per job, one `fused_mine`
span each (1 where the first row budget held the lattice); None where
no fused attempt ran."""


def read(run):
    spans = run.records.get("spans")
    n = len(run.records.get("jobs", ()))
    if spans is None or not n:
        return None
    k = len(spans.of(("fused_mine",)))
    return k / n if k else None
