"""setup_s: process start to the first timed job or request (host clock):
imports, CUDA, the kernel libraries, the inputs made from the seed and the
cell's warm-up."""


def read(run):
    return run.values.get("setup_s")
