"""ckpt_mb: the bytes the per-level checkpoint commits wrote (the
`bytes` arg of each `checkpoint` span: the npz's size), in MB (10^6
bytes) per job; None where no span carries the arg."""


def read(run):
    spans = run.records.get("spans")
    n = len(run.records.get("jobs", ()))
    if spans is None or not n:
        return None
    sizes = [spans.args[i]["bytes"] for i in spans.of(("checkpoint",))
             if "bytes" in spans.args[i]]
    if not sizes:
        return None
    return sum(sizes) / 1e6 / n
