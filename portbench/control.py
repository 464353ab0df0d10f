"""The controls of ``correct``: the reference put in the port's place at a
lower precision, driven through the cell's own run and judged by its own
checks at the cell's own size.

The configuration states its confidences in double precision.  A control
job computes the reference with its confidences in float32 (the nearest
step below) or bfloat16, writes its ``freqItemset`` and ``recommends``
into the job's directory and hands its rule table to the driver as the
port's recommender would; the driver then compares every job of the
window with the float64 reference as it does the port's.  For each seed
and precision the run's result line is printed, with its checks.

    python3 portbench/control.py --workload t10-batch --seeds 1,2,3 \\
        --seconds 5
"""

import argparse
import contextlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def reference_jobs(precision: str):
    """A ``run.jobs`` factory: each job is the reference at ``precision``
    (computed once a run, written anew by each job)."""

    @contextlib.contextmanager
    def jobs(run, in_dir, argv_tail, publish):
        import numpy as np

        from portbench.reference import apriori

        got = {}

        def job(out: str) -> int:
            if not got:
                got["r"] = apriori.Result(
                    run.inputs["D.dat"], run.inputs["U.dat"],
                    float(run.config["min_support"]), precision=precision)
            r = got["r"]
            for name, data in (("freqItemset", r.freq_itemset),
                               ("recommends", r.recommends)):
                with open(os.path.join(out, name), "wb") as f:
                    f.write(data)
            rules = r.rules
            lens = (rules.ant >= 0).sum(axis=1).astype(np.int32)
            publish([str(x) for x in r.mined.items.tolist()],
                    (np.maximum(rules.ant, 0).astype(np.int32), lens,
                     rules.cons.astype(np.int32),
                     rules.conf.astype(np.float64)))
            return 0

        yield job

    return jobs


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--precisions", default="float32,bfloat16")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from portbench import run

    for seed in (int(s) for s in args.seeds.split(",")):
        for precision in args.precisions.split(","):
            print(json.dumps({"control": precision, "seed": seed}),
                  flush=True)
            rc = run.main(["--workload", args.workload, "--seed", str(seed),
                           "--seconds", str(args.seconds), "--trace", "0"],
                          jobs=reference_jobs(precision))
            if rc != 0:
                return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
