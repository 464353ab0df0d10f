"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell comes from ``BENCHMARK.json``; its configuration, traffic mix,
driver and metric readers are files under ``portbench/`` found by name
(``harness.py``).  Set-up (imports, CUDA, the port's kernel libraries
from their build cache, the inputs made from ``--seed``, the cell's own
warm-up) runs before the window; the window measures for ``--seconds``;
the reference then judges what the window produced.  The last line of
standard output is the result as one JSON object; the numbers that
decide ``correct`` are the last lines of standard error.  Exits 2 with
no result when the run cannot be made (no CUDA card, too few cards, a
missing file) and 3 when a JAX module was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def prepare_environment(run) -> None:
    """Caches at fixed paths inside the checkout, the configuration's
    deployment settings, and span recording for a traced run; all before
    the port is imported (it reads its settings once)."""
    cache = os.path.join(run.root, ".portbench", "cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    for key, value in run.config.get("env", {}).items():
        os.environ[key] = str(value)
    if run.trace:
        os.environ["FA_TRACE"] = "1"
        os.environ["FA_TRACE_EVENTS"] = str(4_000_000)


def main(argv=None, root: str = ROOT, platform: str = "cuda",
         jobs=None) -> int:
    """One run; ``platform="cpu"`` skips the look for a card and runs the
    port's CPU path (the harness's own tests, at tiny sizes); ``jobs``
    puts another system in the port's place (``control.py``)."""
    args = parse(sys.argv[1:] if argv is None else argv)
    if root not in sys.path:
        sys.path.insert(0, root)
    from portbench import gen, harness

    try:
        run = harness.Run(harness.benchmark(root), args.workload, args.seed,
                          args.seconds, bool(args.trace), root=root,
                          t_start=T_START if argv is None else None)
        run.platform = platform
        run.jobs = jobs
        prepare_environment(run)
        made = {}
        maker = threading.Thread(
            target=lambda: made.update(gen.make_inputs(run.config,
                                                       run.seed)),
            name="portbench-inputs")
        maker.start()
        try:
            if platform == "cuda":
                run.device = harness.card_info(run.chips)
            else:
                run.device = {"platform": "cpu", "kind": "cpu", "count": 1}
        finally:
            maker.join()
        if not made:
            raise harness.CellError("making the inputs failed")
        run.inputs = made
        driver = harness.load_module(
            os.path.join(run.home, "drivers", run.mix["driver"] + ".py"),
            run.mix["driver"])
        driver.run(run)
    except (harness.CellError, FileNotFoundError) as e:
        print(f"portbench: cannot run: {e}", file=sys.stderr)
        return 2
    bad = harness.forbidden_loaded()
    if bad:
        print(f"portbench: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    harness.emit(run, run.read_metrics())
    return 0


if __name__ == "__main__":
    sys.exit(main())
