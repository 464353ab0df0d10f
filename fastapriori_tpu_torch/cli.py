"""Command-line driver (counterpart: fastapriori_tpu/cli.py ``_run``;
reference C1, Main.scala:15-41).

    python -m fastapriori_tpu_torch <input-prefix> <output-prefix> [tmp] \\
        [--min-support S] [--engine auto|fused|level] [--metrics] \\
        [--platform default|cpu] [--save-counts] [--resume-from PREFIX] \\
        [--checkpoint-every-level] [--checkpoint-cadence N] \\
        [--trace PATH] [--profile-dir DIR]

- ``input`` prefix: reads ``<input>D.dat`` and ``<input>U.dat`` (path
  concatenation, Utils.scala:21-23 — a trailing slash matters);
- ``output`` prefix: writes ``<output>freqItemset``,
  ``<output>recommends`` and ``<output>MANIFEST.json``;
- a third positional argument is accepted and ignored, like the
  reference;
- ``--engine`` picks how the bitmap layout counts the levels, as in the
  JAX package: ``auto`` (the default) runs the fused whole-loop engine
  when the level-2 survivor budget and the level-3 candidate census fit
  its memory-derived row-budget ceiling, else the level engine;
  ``fused`` forces the fused attempt (complete levels go on in the level
  engine when its ceiling or level bound stops it); ``level`` counts
  level by level with K1, folding the shallow tail into one device loop
  on CUDA;
- ``--platform default`` runs on the CUDA device (an error without one);
  ``--platform cpu`` runs every kernel's plain PyTorch version on the CPU;
- the mining layout has no flag, as in the JAX package's CLI: the
  environment variable ``FA_MINE_ENGINE`` (``auto``, ``bitmap`` or
  ``vertical``; strictly parsed) picks it, ``auto`` by default; nor has
  the rule engine: ``FA_RULE_ENGINE`` (``auto``, ``host`` or ``device``;
  strictly parsed; rules/gen.py) overrides ``auto``;
- ``--save-counts`` also writes the phase-1 artifacts ``<output>freqItems``
  (itemsets with ``[count]`` suffixes), ``FreqItems`` and
  ``ItemsToRank``; ``--resume-from PREFIX`` with those artifacts skips
  mining and runs the recommend phase only (a torn set falls back to a
  checkpoint under the same prefix), or with only the
  ``checkpoint.npz`` of a ``--checkpoint-every-level`` run re-ingests
  D.dat and restarts the level loop after the deepest saved level;
  ``--checkpoint-cadence`` is the levels per device segment of
  ``--engine fused`` under ``--checkpoint-every-level``.  Prefixes with
  a scheme (``gs://`` ...) need fsspec;
- ``--trace PATH`` records the span tracer (run -> phase -> mine ->
  level and the other metrics sections -> audited fetches; obs/trace.py)
  and writes its Chrome trace JSON to PATH (Perfetto loads it);
  ``FA_TRACE=1`` records without writing;
- ``--profile-dir DIR`` captures a ``torch.profiler`` trace of both
  phases into DIR (obs/device_trace.py; ``kernel_summary(DIR)`` gives
  each kernel's device time and stage); the JAX CLI's profiles the
  mining phase alone, but K2 runs in the recommend phase.

Phase walls print as the reference's ``====`` lines, and are ``phase``
spans and ``phase`` metrics events as well.  User-correctable failures
print one line and exit 2, after the flight recorder has written
``<output>flight.json`` (obs/flight.py: the last span, ledger and
watchdog events, reason ``classified_error``); an injected crash
(``FA_FAILPOINTS=<site>:abort``) prints the site and exits 1.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time
from typing import List, Optional

from fastapriori_tpu_torch.config import DEFAULT_MIN_SUPPORT, MinerConfig
from fastapriori_tpu_torch.errors import InputError
from fastapriori_tpu_torch.reliability.failpoints import InjectedAbort


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="fastapriori_tpu_torch",
        description="Apriori mining + association-rule recommendation on "
        "one CUDA GPU (reference-compatible CLI)",
        epilog="The environment variable FA_MINE_ENGINE=auto|bitmap|vertical "
        "picks the mining layout (default auto: vertical on sparse corpora "
        "with many frequent items, else bitmap); FA_RULE_ENGINE="
        "auto|host|device picks the rule engine (default auto: the device "
        "join from 2^21 raw rules on a CUDA device, else the host).",
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
                   help="mining engine: auto runs the fused whole-loop "
                   "engine when the level-2 survivor budget and the level-3 "
                   "candidate census fit its row-budget ceiling, else the "
                   "level engine; fused forces the fused attempt; level "
                   "counts level by level")
    p.add_argument("--metrics", action="store_true",
                   help="emit structured JSON metrics to stderr")
    p.add_argument("--platform", choices=["default", "cpu"],
                   default="default",
                   help="default = the CUDA device; cpu = plain PyTorch "
                   "versions of every kernel on the CPU")
    p.add_argument("--save-counts", action="store_true",
                   help="also write <output>freqItems with [count] suffixes "
                   "(the reference's unused saveFreqItemsetWithCount, "
                   "Utils.scala:51-63) — the resume artifact")
    p.add_argument("--resume-from", default=None,
                   help="prefix holding previous run artifacts: with a "
                   "complete freqItems table, skips mining and runs "
                   "recommendation only (reference Utils.getAll, "
                   "Utils.scala:65-81); with only a mid-mine checkpoint.npz "
                   "(from --checkpoint-every-level), restarts mining from "
                   "the deepest completed level.  Artifacts are validated "
                   "against the run's MANIFEST.json when present")
    p.add_argument("--checkpoint-every-level", action="store_true",
                   help="crash-safe mining: atomically rewrite "
                   "<output>checkpoint.npz after every completed Apriori "
                   "level so an interrupted mine resumes mid-lattice via "
                   "--resume-from (costs eager per-level count fetches; "
                   "with --engine fused the lattice mines in resumable "
                   "device segments instead of skipping the engine)")
    p.add_argument("--checkpoint-cadence", type=int, default=1,
                   help="with --engine fused and --checkpoint-every-level: "
                   "levels mined per device segment between checkpoint "
                   "commits (default 1 = a durable checkpoint after every "
                   "level, matching the level engine)")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of the mining and "
                   "recommend phases here (CPU and CUDA activity, a gzip "
                   "Chrome trace)")
    p.add_argument("--trace", default=None, metavar="PATH",
                   help="record the span tracer (run → phase → mine → "
                   "level → fetch) and export Chrome-trace-event JSON here "
                   "— load it in Perfetto (ui.perfetto.dev); FA_TRACE=1 "
                   "records without exporting")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return _run(args)
    except InputError as e:
        # A classified failure: the flight recorder's post-mortem (the
        # last span, ledger and watchdog events) goes next to the run's
        # other artifacts before the one-line message.
        from fastapriori_tpu_torch.obs import flight

        flight.auto_dump("classified_error",
                         extra={"error": f"InputError: {e}"[:400]})
        print(f"error: {e}", file=sys.stderr)
        return 2
    except FileNotFoundError as e:
        missing = e.filename if e.filename else str(e)
        if str(missing).endswith(("D.dat", "U.dat")):
            print(f"error: file {missing!r} not found — the input prefix "
                  "must point at D.dat and U.dat (prefix + 'D.dat', "
                  "trailing slash matters, as with the reference)",
                  file=sys.stderr)
        else:
            print(f"error: file {missing!r} not found", file=sys.stderr)
        return 2
    except InjectedAbort as e:
        # A stand-in for a crash: nothing after the failpoint ran.
        print(f"error: aborted: {e}", file=sys.stderr)
        return 1


def _load_resume(prefix: str):
    """The ``--resume-from`` dispatch: ``("phase1", (freq_itemsets,
    item_to_rank, freq_items))`` when the phase-1 artifacts load,
    ``("checkpoint", (levels, meta))`` when only a checkpoint does (also
    for a torn phase-1 set beside a checkpoint); InputError when neither
    is there."""
    from fastapriori_tpu_torch.io.checkpoint import (
        checkpoint_available,
        load_checkpoint,
    )
    from fastapriori_tpu_torch.io.resume import load_phase1, phase1_available

    if phase1_available(prefix):
        try:
            return "phase1", load_phase1(prefix)
        except InputError:
            if not checkpoint_available(prefix):
                raise
            return "checkpoint", load_checkpoint(prefix)
    if checkpoint_available(prefix):
        return "checkpoint", load_checkpoint(prefix)
    raise InputError(
        f"--resume-from {prefix!r}: found neither the phase-1 artifacts a "
        "--save-counts run writes (freqItems, FreqItems, ItemsToRank) nor "
        "the mid-mine checkpoint.npz a --checkpoint-every-level run writes"
    )


def _run(args) -> int:
    from fastapriori_tpu_torch.io.reader import read_dat
    from fastapriori_tpu_torch.models.apriori import FastApriori
    from fastapriori_tpu_torch.obs import device_trace, flight, trace

    config = MinerConfig(
        min_support=args.min_support,
        engine=args.engine,
        log_metrics=args.metrics,
        # Nothing after mining reads the basket CSR: the pipelined ingest
        # keeps none (the JAX CLI's setting).
        retain_csr=False,
        checkpoint_prefix=(args.output if args.checkpoint_every_level
                           else None),
        checkpoint_every_levels=max(args.checkpoint_cadence, 1),
    )
    device = "cpu" if args.platform == "cpu" else "cuda"
    # Observability: the strict knobs, span recording on --trace or
    # FA_TRACE, and the flight recorder's dumps under this run's prefix.
    flight.reload_from_env()
    device_trace.enabled_by_env()
    trace.maybe_enable(bool(args.trace))
    flight.set_dump_prefix(args.output)
    miner = FastApriori(config=config, device=device)
    u_lines = read_dat(args.input + "U.dat")

    # --profile-dir captures both phases: K2, the recommend scan's
    # kernel, runs in the second.
    profile = (device_trace.capture(args.profile_dir, explicit=True)
               if args.profile_dir else contextlib.nullcontext({}))
    with trace.span("run", cmd="mine"), profile as captured:
        _phases(args, config, device, miner, u_lines)
    if captured.get("active"):
        print(f"device trace written: {captured['trace']} "
              f"({captured['device_events']} device events)",
              file=sys.stderr)
    if args.trace:
        path = trace.TRACER.export(args.trace)
        print(f"trace written: {path} ({len(trace.TRACER.events())} events; "
              "load in Perfetto)", file=sys.stderr)
    return 0


def _phases(args, config: MinerConfig, device: str, miner, u_lines) -> None:
    """The reference's two phases, each a ``phase`` span with its
    ``====`` wall: mining (or the phase-1 artifacts of
    ``--resume-from``) and its writes, then recommendation and its
    writes."""
    from fastapriori_tpu_torch.io.resume import phase1_levels, save_phase1_aux
    from fastapriori_tpu_torch.io.writer import (
        save_freq_itemsets_levels,
        save_recommends,
        write_manifest,
    )
    from fastapriori_tpu_torch.models.recommender import AssociationRules
    from fastapriori_tpu_torch.utils.logging import phase_timer

    t1 = time.perf_counter()
    with phase_timer("get freqItemsets", enabled=False):
        kind, resumed = (_load_resume(args.resume_from) if args.resume_from
                         else (None, None))
        if kind == "phase1":
            # The recommend phase alone, from the phase-1 artifacts.
            freq_itemsets, item_to_rank, freq_items = resumed
            levels, item_counts = phase1_levels(freq_itemsets,
                                                len(freq_items))
        else:
            if kind == "checkpoint":
                ck_levels, ck_meta = resumed
                miner.set_resume_levels(ck_levels, ck_meta,
                                        label=args.resume_from)
            levels, data = miner.run_file_raw(args.input + "D.dat")
            freq_items, item_to_rank = data.freq_items, data.item_to_rank
            item_counts = data.item_counts
            manifest: dict = {}
            save_freq_itemsets_levels(
                args.output, levels, freq_items, manifest=manifest,
                item_counts=item_counts, with_counts_path=args.save_counts)
            if args.save_counts:
                save_phase1_aux(args.output, freq_items, item_to_rank,
                                manifest=manifest)
            write_manifest(args.output, manifest)
    print("==== Total time for get freqItemsets "
          f"{int((time.perf_counter() - t1) * 1e3)}", file=sys.stderr)

    t2 = time.perf_counter()
    with phase_timer("get recommends", enabled=False):
        recommender = AssociationRules(
            freq_items, item_to_rank, levels, item_counts,
            config=config, device=device,
        )
        recommends = recommender.run(u_lines)
        manifest = {}
        save_recommends(args.output, recommends, manifest=manifest)
        write_manifest(args.output, manifest)
    print("==== Total time for get recommends "
          f"{int((time.perf_counter() - t2) * 1e3)}", file=sys.stderr)


if __name__ == "__main__":
    sys.exit(main())
