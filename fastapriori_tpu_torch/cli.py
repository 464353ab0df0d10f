"""Command-line driver (counterpart: fastapriori_tpu/cli.py ``_run``;
reference C1, Main.scala:15-41).

    python -m fastapriori_tpu_torch <input-prefix> <output-prefix> [tmp] \\
        [--min-support S] [--engine auto|level] [--metrics] \\
        [--platform default|cpu]

- ``input`` prefix: reads ``<input>D.dat`` and ``<input>U.dat`` (path
  concatenation, Utils.scala:21-23 — a trailing slash matters);
- ``output`` prefix: writes ``<output>freqItemset``,
  ``<output>recommends`` and ``<output>MANIFEST.json``;
- a third positional argument is accepted and ignored, like the
  reference;
- ``--platform default`` runs on the CUDA device (an error without one);
  ``--platform cpu`` runs every kernel's plain PyTorch version on the CPU;
- the mining layout has no flag, as in the JAX package's CLI: the
  environment variable ``FA_MINE_ENGINE`` (``auto``, ``bitmap`` or
  ``vertical``; strictly parsed) picks it, ``auto`` by default.

User-correctable failures print one line and exit 2.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional

from fastapriori_tpu_torch.config import DEFAULT_MIN_SUPPORT, MinerConfig
from fastapriori_tpu_torch.errors import InputError


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="fastapriori_tpu_torch",
        description="Apriori mining + association-rule recommendation on "
        "one CUDA GPU (reference-compatible CLI)",
        epilog="The environment variable FA_MINE_ENGINE=auto|bitmap|vertical "
        "picks the mining layout (default auto: vertical on sparse corpora "
        "with many frequent items, else bitmap).",
    )
    p.add_argument("input", help="input prefix containing D.dat and U.dat")
    p.add_argument("output", help="output prefix for freqItemset/recommends")
    p.add_argument("tmp", nargs="?", default=None,
                   help="temporary path (accepted and ignored, like the "
                   "reference)")
    p.add_argument("--min-support", type=float, default=DEFAULT_MIN_SUPPORT,
                   help=f"minimum support (default {DEFAULT_MIN_SUPPORT}, "
                   "the reference's hardcoded value)")
    p.add_argument("--engine", choices=["auto", "fused", "level"],
                   default="auto",
                   help="mining engine: auto resolves to level in this "
                   "port; fused is not ported yet")
    p.add_argument("--metrics", action="store_true",
                   help="emit structured JSON metrics to stderr")
    p.add_argument("--platform", choices=["default", "cpu"],
                   default="default",
                   help="default = the CUDA device; cpu = plain PyTorch "
                   "versions of every kernel on the CPU")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return _run(args)
    except InputError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    except FileNotFoundError as e:
        missing = e.filename if e.filename else str(e)
        print(f"error: file {missing!r} not found — the input prefix must "
              "point at D.dat and U.dat (prefix + 'D.dat', trailing slash "
              "matters, as with the reference)", file=sys.stderr)
        return 2


def _run(args) -> int:
    from fastapriori_tpu_torch.io.reader import read_dat
    from fastapriori_tpu_torch.io.writer import (
        save_freq_itemsets_levels,
        save_recommends,
        write_manifest,
    )
    from fastapriori_tpu_torch.models.apriori import FastApriori
    from fastapriori_tpu_torch.models.recommender import AssociationRules

    config = MinerConfig(
        min_support=args.min_support,
        engine=args.engine,
        log_metrics=args.metrics,
    )
    device = "cpu" if args.platform == "cpu" else "cuda"
    miner = FastApriori(config=config, device=device)
    u_lines = read_dat(args.input + "U.dat")

    t1 = time.perf_counter()
    levels, data = miner.run_file_raw(args.input + "D.dat")
    manifest: dict = {}
    save_freq_itemsets_levels(args.output, levels, data.freq_items,
                              manifest=manifest)
    write_manifest(args.output, manifest)
    print("==== Total time for get freqItemsets "
          f"{int((time.perf_counter() - t1) * 1e3)}", file=sys.stderr)

    t2 = time.perf_counter()
    recommender = AssociationRules(
        data.freq_items, data.item_to_rank, levels, data.item_counts,
        config=config, device=device,
    )
    recommends = recommender.run(u_lines)
    manifest = {}
    save_recommends(args.output, recommends, manifest=manifest)
    write_manifest(args.output, manifest)
    print("==== Total time for get recommends "
          f"{int((time.perf_counter() - t2) * 1e3)}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
