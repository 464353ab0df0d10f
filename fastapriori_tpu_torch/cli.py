"""Command-line driver (counterpart: fastapriori_tpu/cli.py ``_run``;
reference C1, Main.scala:15-41).

    python -m fastapriori_tpu_torch <input-prefix> <output-prefix> [tmp] \\
        [--min-support S] [--engine auto|fused|level] [--metrics] \\
        [--platform default|cpu] [--num-devices S] [--cand-devices C] \\
        [--save-counts] [--resume-from PREFIX] \\
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
- ``--num-devices S`` mines and recommends on S transaction shards
  (parallel/mesh.py): S cards on CUDA (more than are visible exits 2;
  the default is every visible card), S CPU shards with ``--platform
  cpu`` (default 1); ``--cand-devices C`` splits them into a ``(S/C,
  C)`` grid whose cand axis shares out each level's prefix rows.  The
  counts cross the shards through the dense psum, the threshold-sparse
  exchange or its two-level form, chosen as the JAX package chooses
  (``FA_COUNT_REDUCE``, ``FA_COUNT_SPARSE_CAP``, ``FA_EXCHANGE_GROUPS``);
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
  mining phase alone, but K2 runs in the recommend phase;
- ``--distributed`` joins the ``env://`` world of ``torch.distributed``
  (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``; parallel/mesh.py ``initialize_distributed``), as the
  JAX CLI joins ``jax.distributed``: each rank ingests its own byte
  range of D.dat and mines its own rows on its own card
  (``cuda:(LOCAL_RANK mod visible)``, ``--num-devices`` shards of it),
  the counts crossing the ranks; rank 0 alone writes; ``--trace`` and
  the flight recorder write per-rank files.  The backend is NCCL when
  every rank has a card of its own, gloo otherwise (the CPU, ranks
  sharing a card); one that does not start exits 2.  The NCCL path is
  checked by tests/test_torch_nccl.py and ``chip_smoke.py --cards N``
  on a host with two cards or more.  Without the variables the run is
  one process, with a notice.  A rank that fails ends every other rank
  with exit 3 within ``FA_QUORUM_TIMEOUT_S`` (no rank writes);
  ``--checkpoint-every-level`` and ``--resume-from`` run in a world
  (rank 0 writes the checkpoint, every rank resumes from it);
- the quorum domain (reliability/quorum.py), as in the JAX CLI: a
  ``--distributed`` world of more than one rank has one over the
  process group, and ``FA_QUORUM_DIR`` with ``FA_QUORUM_RANK`` and
  ``FA_QUORUM_PROCS`` makes one-process ranks (each mining the whole
  corpus, each writing under its own output prefix) a file domain.
  Every rank meets the others at ``run.start``, ``mine.end``,
  ``rules.start`` and ``run.end``; a cascade walk on one rank is adopted
  by all; the writer's checkpoints and manifests carry the domain's
  fence (a stale one is refused, exit 2); a lost peer or a divergent
  mesh exits 3 naming the rank; with ``FA_EPOCH_RETRY_MAX`` > 0 the
  survivors of a file domain finish without the dead rank.  A run in a
  domain ends with a ``quorum`` metrics event (transport, mesh epoch,
  members, fence, the epoch trail).

``python -m fastapriori_tpu_torch serve <input> [<output>] ...`` is the
serving tier (counterpart: the JAX CLI's ``serve`` subcommand): build the
model once (mine ``<input>D.dat``, or ``--from-serving PREFIX``), mount
its rule table on the device, answer ``--requests`` (default
``<input>U.dat``; ``-`` reads stdin) through the micro-batching server
(closed submission, or ``--rate`` open loop; ``--hosts N`` in-process
hosts behind the router) and write ``<output>recommends`` with its
manifest, or the answers to stdout.  Its flags are the JAX CLI's, with
``--num-devices`` as above.  Unlike the JAX CLI, a run in which any batch failed
(a ``serve_error``) exits 1 and writes no ``recommends``.

Phase walls print as the reference's ``====`` lines, and are ``phase``
spans and ``phase`` metrics events as well.  User-correctable failures
print one line and exit 2, after the flight recorder has written
``<output>flight.json`` (obs/flight.py: the last span, ledger and
watchdog events, reason ``classified_error``); an injected crash
(``FA_FAILPOINTS=<site>:abort``) prints the site and exits 1; a
fault-domain failure (``PeerLost``, ``MeshDivergence``,
``MeshEpochAbort``) prints one line and exits 3.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time
from typing import List, Optional

from fastapriori_tpu_torch.config import DEFAULT_MIN_SUPPORT, MinerConfig
from fastapriori_tpu_torch.errors import InputError
from fastapriori_tpu_torch.reliability.failpoints import InjectedAbort
from fastapriori_tpu_torch.reliability.quorum import (
    MeshDivergence,
    MeshEpochAbort,
    PeerLost,
)


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
    _add_mesh_flags(p, cand=True)
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
                   "under --engine auto or level every level is counted "
                   "and committed on its own, with no tail fold; with "
                   "--engine fused the lattice mines in resumable device "
                   "segments instead of skipping the engine)")
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
    p.add_argument("--distributed", action="store_true",
                   help="join the torch.distributed env:// world (RANK, "
                   "WORLD_SIZE, MASTER_ADDR, MASTER_PORT, LOCAL_RANK): "
                   "each rank ingests and mines its own part of D.dat, "
                   "rank 0 writes")
    return p


def build_serve_parser() -> argparse.ArgumentParser:
    """The ``serve`` subcommand's flags (counterpart: the JAX CLI's
    ``build_serve_parser``, without ``--num-devices``)."""
    p = argparse.ArgumentParser(
        prog="fastapriori_tpu_torch serve",
        description="resident recommend service: mount the model's rule "
        "table on the device once, serve baskets from a file or stdin "
        "through the micro-batching request loop",
    )
    p.add_argument("input", help="input prefix containing D.dat (model "
                   "build; ignored with --from-serving)")
    p.add_argument("output", nargs="?", default=None,
                   help="output prefix: writes <output>recommends (and its "
                   "manifest); omitted = answers to stdout")
    p.add_argument("--requests", default=None,
                   help="request source: a file of basket lines, or '-' "
                   "for stdin (default: <input>U.dat)")
    p.add_argument("--from-serving", default=None,
                   help="warm restart: load <prefix>serving.npz instead of "
                   "mining <input>D.dat")
    p.add_argument("--save-serving", action="store_true",
                   help="after the model builds, write <output>serving.npz "
                   "(needs an output prefix)")
    p.add_argument("--min-support", type=float, default=DEFAULT_MIN_SUPPORT,
                   help=f"minimum support for the model build (default "
                   f"{DEFAULT_MIN_SUPPORT})")
    p.add_argument("--serve-engine", choices=["auto", "device", "host"],
                   default="auto",
                   help="scan engine: auto takes the device table when the "
                   "device rule engine built one or a full micro-batch "
                   "reaches the batch path's device threshold; host forces "
                   "the host scan")
    p.add_argument("--batch-rows", type=int, default=None,
                   help="micro-batch rows (pow2-bucketed; default "
                   "config.rec_batch_rows / FA_REC_BATCH)")
    p.add_argument("--linger-ms", type=float, default=None,
                   help="the most ms a partial micro-batch waits to fill "
                   "(default config.serve_linger_ms)")
    p.add_argument("--queue-depth", type=int, default=None,
                   help="admission queue bound in requests (default 4x the "
                   "micro-batch rows); a full queue sheds ('0', recorded)")
    p.add_argument("--pipeline-depth", type=int, default=None,
                   help="the pack-to-scan ring's depth (default "
                   "FA_SERVE_PIPELINE_DEPTH=2; 0 = the serial dispatcher)")
    p.add_argument("--hosts", type=int, default=None,
                   help="in-process serving hosts behind the router "
                   "(default FA_SERVE_HOSTS=1)")
    p.add_argument("--rate", type=float, default=None,
                   help="open-loop pacing in requests/s (seeded Poisson "
                   "schedule; overload sheds); default: closed submission")
    p.add_argument("--seed", type=int, default=0,
                   help="arrival-schedule seed for --rate (default 0)")
    p.add_argument("--metrics", action="store_true",
                   help="emit structured JSON metrics to stderr")
    p.add_argument("--trace", default=None, metavar="PATH",
                   help="record the span tracer (serve.batch, serve.dedup, "
                   "serve.pack, serve.scan, serve.respond, fetch.<site>) "
                   "and export Chrome-trace-event JSON here")
    p.add_argument("--metrics-dump", default=None, metavar="PATH",
                   help="rewrite the server's Prometheus-text metrics here "
                   "every FA_METRICS_DUMP_S seconds (atomically), and once "
                   "at shutdown")
    p.add_argument("--platform", choices=["default", "cpu"],
                   default="default",
                   help="default = the CUDA device; cpu = plain PyTorch "
                   "versions of every kernel on the CPU")
    _add_mesh_flags(p, cand=False)
    return p


def _add_mesh_flags(p: argparse.ArgumentParser, cand: bool) -> None:
    """``--num-devices`` (both CLIs) and ``--cand-devices`` (the batch
    CLI), as in the JAX package's CLI."""
    p.add_argument("--num-devices", type=int, default=None,
                   help="transaction shards of the device mesh: CUDA "
                   "cards (default: every visible card; more than are "
                   "visible is an error), or CPU shards with --platform "
                   "cpu (default 1)")
    if cand:
        p.add_argument("--cand-devices", type=int, default=1,
                       help="split the devices into a (txn, cand) grid "
                       "whose cand axis shares out each level's prefix "
                       "rows; must divide the device count (default 1)")


def _context(args, device: str, context=None):
    """The run's DeviceContext: the injected one, else the mesh the
    flags ask for (the default platform without ``--num-devices``:
    every visible card)."""
    if context is not None:
        return context
    from fastapriori_tpu_torch.device import DeviceContext

    return DeviceContext(None if device == "cuda" else device,
                         num_devices=args.num_devices,
                         cand_devices=getattr(args, "cand_devices", 1))


def main(argv: Optional[List[str]] = None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "serve":
        return _serve_main(list(argv[1:]))
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
    except (PeerLost, MeshDivergence, MeshEpochAbort) as e:
        # A fault-domain failure is classified, as in the JAX CLI: a lost
        # peer or a divergent mesh names the rank and exits 3 (the quorum
        # domain already dumped its epoch trail to the flight recorder).
        from fastapriori_tpu_torch.parallel import mesh

        print(f"error: {e}", file=sys.stderr)
        if mesh.process_count() > 1:
            # A lost world: a collective may still be pending on the dead
            # peer, and the interpreter's exit would wait on it.
            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(3)
        return 3


def _serve_main(argv: List[str]) -> int:
    args = build_serve_parser().parse_args(argv)
    try:
        return _run_serve(args)
    except InputError as e:
        from fastapriori_tpu_torch.obs import flight

        flight.auto_dump("classified_error",
                         extra={"error": f"InputError: {e}"[:400]})
        print(f"error: {e}", file=sys.stderr)
        return 2
    except FileNotFoundError as e:
        missing = e.filename if e.filename else str(e)
        print(f"error: file {missing!r} not found", file=sys.stderr)
        return 2
    except InjectedAbort as e:
        print(f"error: aborted: {e}", file=sys.stderr)
        return 1


def _start_metrics_dump(server, path: Optional[str]):
    """``serve --metrics-dump PATH``: a thread that atomically rewrites
    the server's Prometheus text every ``FA_METRICS_DUMP_S`` seconds.
    Returns a callable that stops it (bounded) and writes the final
    snapshot, or None without a path."""
    if not path:
        return None
    import threading

    from fastapriori_tpu_torch.io.writer import write_artifact_bytes
    from fastapriori_tpu_torch.obs.metrics import dump_interval_s

    interval = dump_interval_s()
    stop = threading.Event()

    def write_once() -> None:
        write_artifact_bytes(
            path, [server.metrics_text().encode("utf-8")], "metrics")

    def loop() -> None:
        while not stop.wait(interval):
            write_once()

    t = threading.Thread(target=loop, name="fa-metrics-dump", daemon=True)
    t.start()

    def finish() -> None:
        stop.set()
        t.join(10.0)
        write_once()

    return finish


def _mount_serving(args, config: MinerConfig, ctx, n_hosts: int):
    """The serve CLI's model and its server: the state mined or loaded,
    saved with ``--save-serving``, behind one started RecommendServer or,
    at ``n_hosts`` > 1, a MeshRouter over that many in-process hosts,
    each with its own state loaded from the serving artifact (a mined
    model is saved to a scratch prefix first, removed after the loads)."""
    import os
    import shutil
    import tempfile

    from fastapriori_tpu_torch.serve import (
        LocalHost,
        MeshRouter,
        RecommendServer,
        ServingState,
    )

    if args.from_serving:
        state = ServingState.load(args.from_serving, config=config,
                                  engine=args.serve_engine, context=ctx)
    else:
        state = ServingState.from_mine(args.input + "D.dat", config=config,
                                       engine=args.serve_engine,
                                       context=ctx)
    if args.save_serving:
        state.save(args.output)

    def server_for(st):
        return RecommendServer(
            st, batch_rows=args.batch_rows, linger_ms=args.linger_ms,
            queue_depth=args.queue_depth,
            pipeline_depth=args.pipeline_depth).start()

    if n_hosts == 1:
        return server_for(state)
    scratch = None
    if args.from_serving:
        prefix = args.from_serving
    elif args.save_serving:
        prefix = args.output
    else:
        scratch = tempfile.mkdtemp(prefix="fa_serve_hosts_")
        prefix = os.path.join(scratch, "m_")
        state.save(prefix)
    try:
        states = [state] + [
            ServingState.load(prefix, config=config, engine=args.serve_engine,
                              context=ctx)
            for _ in range(n_hosts - 1)]
    finally:
        if scratch is not None:
            shutil.rmtree(scratch, ignore_errors=True)
    return MeshRouter([LocalHost(f"host{i}", server_for(st))
                       for i, st in enumerate(states)])


def _run_serve(args, context=None) -> int:
    """The ``serve`` subcommand; ``context``: a DeviceContext to serve on
    instead of the one the flags ask for (``chip_smoke.py`` injects a
    mesh of one card named S times)."""
    from fastapriori_tpu_torch.device import resolve_device
    from fastapriori_tpu_torch.io.reader import read_dat, tokenize_line
    from fastapriori_tpu_torch.io.writer import save_recommends, write_manifest
    from fastapriori_tpu_torch.obs import flight, trace
    from fastapriori_tpu_torch.serve import run_open_loop
    from fastapriori_tpu_torch.serve.router import hosts_from_env
    from fastapriori_tpu_torch.utils.logging import MetricsLogger

    if args.save_serving and not args.output:
        raise InputError("--save-serving writes <output>serving.npz and "
                         "therefore needs an output prefix")
    device = "cpu" if args.platform == "cpu" else "cuda"
    resolve_device(device)  # no CUDA device and no --platform cpu: exit 2
    ctx = _context(args, device, context)
    flight.reload_from_env()
    trace.maybe_enable(bool(args.trace))
    flight.set_dump_prefix(args.output or args.input)
    config = MinerConfig(min_support=args.min_support,
                         log_metrics=args.metrics, retain_csr=False)
    n_hosts = args.hosts if args.hosts is not None else hosts_from_env()
    if n_hosts < 1:
        raise InputError(f"--hosts must be >= 1, got {n_hosts}")
    t0 = time.perf_counter()
    server = _mount_serving(args, config, ctx, n_hosts)
    print("==== Total time for serve model mount "
          f"{int((time.perf_counter() - t0) * 1e3)}", file=sys.stderr)
    metrics = MetricsLogger(enabled=args.metrics)
    dump_stop = _start_metrics_dump(server, args.metrics_dump)

    req_path = args.requests or (args.input + "U.dat")
    if req_path == "-":
        lines = (tokenize_line(ln) for ln in sys.stdin)
    else:
        lines = iter(read_dat(req_path))
    t1 = time.perf_counter()
    reqs = []
    if args.rate is not None:
        # Open loop: request i is pool[i], so answers align with rows.
        pool = list(lines)
        if pool:
            result = run_open_loop(server, pool, rate_rps=args.rate,
                                   n_requests=len(pool), seed=args.seed,
                                   requests_out=reqs)
            import json

            print(json.dumps({"serve_open_loop": result}), file=sys.stderr)
    else:
        for tokens in lines:
            # A mesh spills and sheds (never blocks) when every host is
            # full; one server waits for room.
            reqs.append(server.submit(tokens) if n_hosts > 1
                        else server.submit_wait(tokens))
    completed = server.wait_for(reqs, timeout_s=600.0)
    served_wall = time.perf_counter() - t1
    stats = server.stats()
    if n_hosts > 1:
        stopped = server.drain() and server.stop()
    else:
        stopped = server.stop(drain=True)
    if dump_stop is not None:
        dump_stop()
    metrics.emit("serve", wall_ms=round(served_wall * 1e3, 3), **stats)
    if args.trace:
        path = trace.TRACER.export(args.trace)
        print(f"trace written: {path} ({len(trace.TRACER.events())} events; "
              "load in Perfetto)", file=sys.stderr)
    if not completed or not stopped:
        pending = sum(1 for r in reqs if not r.done)
        print(f"error: serve did not complete inside the bound ({pending} "
              f"of {len(reqs)} requests unfinished, dispatcher "
              f"{'stopped' if stopped else 'STILL RUNNING'}) — no output "
              "written", file=sys.stderr)
        return 1
    failed = sum(1 for r in reqs if r.error is not None)
    if stats["errors"] or failed:
        print(f"error: serve: {stats['errors']} batches failed "
              f"({failed} requests failed"
              + (f", dispatcher stopped: {stats.get('fatal')}"
                 if stats.get("fatal") else "")
              + ") — no output written", file=sys.stderr)
        return 1

    recommends = [(i, r.item if r.item is not None else "0")
                  for i, r in enumerate(reqs)]
    if args.output:
        manifest: dict = {}
        save_recommends(args.output, recommends, manifest=manifest)
        write_manifest(args.output, manifest)
    else:
        for _, item in recommends:
            print(item)
    avg_batch = stats.get("avg_batch")
    if avg_batch is None:  # a mesh's stats: the average from the totals
        avg_batch = round(stats["served"] / max(stats["batches"], 1), 1)
    engine = (stats.get("model") or {}).get("engine")
    if engine is None:
        ph = stats.get("per_host") or [{}]
        engine = (ph[0].get("model") or {}).get("engine", "?")
    mesh_note = (f"{stats['hosts']} hosts ({stats.get('router_shed', 0)} "
                 f"router-shed), " if n_hosts > 1 else "")
    print(f"==== serve: {stats['served']} served, {stats['shed']} shed, "
          f"{mesh_note}{stats['batches']} batches (avg {avg_batch} rows), "
          f"engine {engine}, {int(served_wall * 1e3)} ms", file=sys.stderr)
    return 0


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


def _join_world(device: str):
    """``--distributed``: the world, or None for one process (no
    ``env://`` variables: a notice, as the JAX CLI's; a world of one)."""
    from fastapriori_tpu_torch.parallel import mesh

    try:
        world = mesh.initialize_distributed(device)
    except ValueError as e:
        print(f"--distributed: {e} — running single-process (launch one "
              "process per rank with MASTER_ADDR, MASTER_PORT, RANK and "
              "WORLD_SIZE set)", file=sys.stderr)
        return None
    except RuntimeError as e:
        # Never a retry on another backend: the launch decides it.
        raise InputError(f"--distributed initialization failed: {e}")
    return world


def _run(args, context=None) -> int:
    """The batch run; ``context``: a DeviceContext to run on instead of
    the one the flags ask for (``chip_smoke.py`` injects a mesh of one
    card named S times)."""
    from fastapriori_tpu_torch.device import resolve_device
    from fastapriori_tpu_torch.parallel import mesh
    from fastapriori_tpu_torch.reliability import quorum

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
        num_devices=args.num_devices,
        cand_devices=args.cand_devices,
    )
    device = "cpu" if args.platform == "cpu" else "cuda"
    world = None
    if getattr(args, "distributed", False):
        resolve_device(device)  # no CUDA device and no --platform cpu
        world = _join_world(device)
    status = "failed"
    try:
        # The run's quorum domain: FA_QUORUM_* read now (a file domain),
        # else the world's torch domain, else none.
        quorum.reload_from_env()
        rc = _run_in_world(args, config, device, world, context)
        status = "done"
        return rc
    except InjectedAbort:
        status = "aborted"
        raise
    finally:
        # Leaving the domain posts this rank's exit marker: a peer that
        # still waits sees the loss at once.
        quorum.shutdown(status)
        if world is not None:
            mesh.shutdown_distributed()


def _run_in_world(args, config, device: str, world, context) -> int:
    from fastapriori_tpu_torch.io.reader import read_dat
    from fastapriori_tpu_torch.models.apriori import FastApriori
    from fastapriori_tpu_torch.obs import device_trace, flight, trace
    from fastapriori_tpu_torch.reliability import quorum

    # Observability: the strict knobs, span recording on --trace or
    # FA_TRACE, and the flight recorder's dumps under this run's prefix
    # (per rank in a domain of more than one process).
    flight.reload_from_env()
    device_trace.enabled_by_env()
    trace.maybe_enable(bool(args.trace))
    # The run's root span holds everything from here to the export: the
    # job's set-up, reading U.dat, both phases and the last rendezvous.
    with trace.span("run", cmd="mine"):
        with trace.span("job_setup"):
            dom = quorum.active()
            multi_rank = dom is not None and dom.nprocs > 1
            flight.set_dump_prefix(args.output + (f"rank{dom.rank}."
                                                  if multi_rank else ""))
            miner = FastApriori(config=config,
                                context=_context(args, device, context))
            if world is not None:
                miner.metrics.emit(
                    "distributed", backend=world.backend, world=world.size,
                    rank=world.rank, device=str(miner.ctx.device),
                    local_shards=miner.ctx.local_txn_shards)
            # Every rank up before any work: a peer that never starts is
            # a classified PeerLost within the bound; a rank that waits
            # here while a peer aborts the mesh meets it under the new
            # epoch.
            quorum.sync_or_rejoin("run.start", wait=True)
        with trace.span("read_users") as sp:
            u_lines = read_dat(args.input + "U.dat")
            sp.update(lines=len(u_lines))

        # --profile-dir captures both phases: K2, the recommend scan's
        # kernel, runs in the second.
        profile = (device_trace.capture(args.profile_dir, explicit=True)
                   if args.profile_dir else contextlib.nullcontext({}))
        with profile as captured:
            _phases(args, config, device, miner, u_lines)
        # The last rendezvous: no rank leaves while a peer still needs it.
        quorum.sync_or_rejoin("run.end", wait=True)
        if dom is not None:
            _emit_quorum(miner.metrics, dom)
        if captured.get("active"):
            print(f"device trace written: {captured['trace']} "
                  f"({captured['device_events']} device events)",
                  file=sys.stderr)
    if args.trace:
        path = trace.TRACER.export(quorum.rank_path(args.trace))
        print(f"trace written: {path} ({len(trace.TRACER.events())} events; "
              "load in Perfetto)", file=sys.stderr)
    return 0


def _emit_quorum(metrics, dom) -> None:
    """One ``quorum`` metrics event at the end of a run in a domain: its
    transport, rank, mesh epoch and members, the fence (a file domain's)
    and the epoch trail of every sync the run completed."""
    from fastapriori_tpu_torch.reliability import quorum

    file_t = isinstance(dom.transport, quorum.FileTransport)
    metrics.emit(
        "quorum", transport="file" if file_t else "torch", rank=dom.rank,
        nprocs=dom.nprocs, mesh_epoch=dom.mesh_epoch,
        members=list(dom.members),
        fence=dom.transport.current_fence() if file_t else None,
        epoch_trail=dom.epoch_trail())


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
    from fastapriori_tpu_torch.parallel import mesh
    from fastapriori_tpu_torch.reliability import quorum
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
            # In a multi-process world each rank ingests its own byte
            # range (run_file_sharded); the levels are every rank's.
            levels, data = miner.run_file_raw(args.input + "D.dat")
            freq_items, item_to_rank = data.freq_items, data.item_to_rank
            item_counts = data.item_counts
            # Every rank arrives before the one writer writes: a rank
            # whose peer failed stops here.  Rank 0 of the world writes
            # (every rank of a file domain, each under its own prefix),
            # its manifest stamped with the quorum writer's fence.
            mesh.agree()
            if mesh.process_index() == 0:
                manifest: dict = {}
                save_freq_itemsets_levels(
                    args.output, levels, freq_items, manifest=manifest,
                    item_counts=item_counts,
                    with_counts_path=args.save_counts)
                if args.save_counts:
                    save_phase1_aux(args.output, freq_items, item_to_rank,
                                    manifest=manifest)
                write_manifest(args.output, manifest,
                               fence=quorum.writer_fence())
    print("==== Total time for get freqItemsets "
          f"{int((time.perf_counter() - t1) * 1e3)}", file=sys.stderr)
    # Every rank arrives here, however many level boundaries it took: a
    # rank killed mid-mine is found by its peers within the bound.
    quorum.sync_or_rejoin("mine.end", wait=True)

    t2 = time.perf_counter()
    with phase_timer("get recommends", enabled=False):
        recommender = AssociationRules(
            [], freq_items, item_to_rank,
            levels=levels, item_counts=item_counts,
            config=config, context=miner.ctx,
        )
        recommends = recommender.run(u_lines)
        mesh.agree()
        if mesh.process_index() == 0:
            manifest = {}
            save_recommends(args.output, recommends, manifest=manifest)
            write_manifest(args.output, manifest,
                           fence=quorum.writer_fence())
    print("==== Total time for get recommends "
          f"{int((time.perf_counter() - t2) * 1e3)}", file=sys.stderr)


if __name__ == "__main__":
    sys.exit(main())
