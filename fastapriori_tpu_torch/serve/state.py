"""ServingState: the "serve model" half of the API split (counterpart:
fastapriori_tpu/serve/state.py ``ServingState``, ``PackedBatch`` and
``model_signature``).

A serving process needs the recommend half of the batch run as an object
of its own: rules generated and priority-sorted once, the rule table
mounted on the device once (:meth:`AssociationRules.serve_scan
<fastapriori_tpu_torch.models.recommender.AssociationRules.serve_scan>`:
the table built on the device from the device rule engine's state, else
the host-built table uploaded once), then one K2 launch per request
micro-batch.

- :meth:`ServingState.from_mine` mines ``D.dat`` through
  ``FastApriori.run_file_raw``; :meth:`save` / :meth:`load` persist the
  mining result as ``<prefix>serving.npz`` through the crash-safe
  writer and the run manifest, in the JAX package's layout, so either
  package loads the other's artifact and serves the same bytes (rule
  generation is deterministic in the mining result).
- :meth:`recommend_batch` serves one micro-batch: dedup (the
  reference's C10), K2 over the distinct baskets in blocks of at most
  :meth:`batch_rows` rows, each block padded only to the next power of
  two of its real rows (at least 32), fan out.  The consequents come
  back through the audited ``fetch.serve_match`` site.
- :meth:`pack_batch` / :meth:`scan_packed` split it for the two-stage
  server: the pack stage (dedup and the numpy bitmap blocks) touches no
  CUDA; the scan stage uploads, launches and fetches.

No fallback hides the card: the JAX package walks ``serve_scan``
(pallas -> xla) and then ``rule_scan`` (device -> host) when a scan's
transient failures outlast their retries; here both chains are named
(reliability/watchdog.py) but never walked.  An exhausted
``fetch.serve_match`` or a K2 launch error raises to the server, which
records a ``serve_error`` for that batch.  ``engine="host"`` is the
user's explicit choice of the host scan and stays.

Model identity: :attr:`ServingState.signature` (sha256 over the level
matrices, counts and item vocabulary, as the JAX package computes it)
names the model that served each response.
"""

from __future__ import annotations

import hashlib
import io
import time
import zipfile
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from fastapriori_tpu_torch.config import MinerConfig
from fastapriori_tpu_torch.errors import InputError
from fastapriori_tpu_torch.io.reader import _open_bytes
from fastapriori_tpu_torch.io.writer import (
    write_artifact_bytes,
    write_manifest,
)
from fastapriori_tpu_torch.obs import trace
from fastapriori_tpu_torch.preprocess import dedup_user_baskets
from fastapriori_tpu_torch.reliability import failpoints, ledger

SERVING_NAME = "serving.npz"

Level = Tuple[np.ndarray, np.ndarray]


class PackedBatch:
    """One request micro-batch after the pack stage: deduplicated and,
    on the device engine, cut into numpy bitmap blocks, with nothing
    launched yet.  ``state`` pins the model it was packed against (the
    server's swap barrier scans it on that same state).  ``deferred``:
    the state's ``recommend_batch`` is overridden on the instance (the
    tests' gating seam), so the raw lines ride to the scan stage."""

    __slots__ = (
        "state", "n_lines", "baskets", "indexes", "blocks", "mb", "lines",
        "deferred",
    )

    def __init__(self, state: "ServingState", n_lines: int):
        self.state = state
        self.n_lines = n_lines
        self.baskets: Optional[List[np.ndarray]] = None
        self.indexes = None
        # [(b0, n, bitmap, blen)] numpy, one per K2 launch.
        self.blocks: Optional[list] = None
        self.mb = 0  # the batch_rows the blocks were cut at
        self.lines = None
        self.deferred = False


def model_signature(
    levels: Sequence[Level],
    item_counts: np.ndarray,
    freq_items: Sequence[str],
) -> str:
    """The model's identity: sha256 over the int32 level matrices, their
    int64 counts, the 1-itemset counts and the item vocabulary, the JAX
    package's bytes in the JAX package's order, so equal mining results
    have equal signatures in both packages."""
    h = hashlib.sha256()
    h.update(np.int64(len(levels)).tobytes())
    for mat, cnt in levels:
        h.update(np.ascontiguousarray(mat, dtype=np.int32).tobytes())
        h.update(np.ascontiguousarray(cnt, dtype=np.int64).tobytes())
    h.update(np.ascontiguousarray(item_counts, dtype=np.int64).tobytes())
    h.update("\x00".join(freq_items).encode("utf-8"))
    return h.hexdigest()[:16]


class ServingState:
    """A resident, checkpointable recommend model (module docstring).

    Construction is cheap; rule generation, the table's mount and K2's
    first launch run in :meth:`warm` (or at the first batch).  A model
    refresh builds a new instance, hot-swaps it in through the server
    and :meth:`release`\\ s this one.  ``device`` and ``context`` (a
    DeviceContext to serve on: on a mesh of S transaction shards one K2
    launch per shard and block, over its rows of the block against the
    host-built table, or over the whole block against its rank-strided
    slice of the device-built one) as for
    :class:`~fastapriori_tpu_torch.models.apriori.FastApriori`."""

    def __init__(
        self,
        levels: Sequence[Level],
        item_counts: np.ndarray,
        freq_items: Sequence[str],
        item_to_rank: Optional[Dict[str, int]] = None,
        config: Optional[MinerConfig] = None,
        device=None,
        engine: str = "auto",
        source: str = "build",
        context=None,
    ):
        if engine not in ("auto", "device", "host"):
            raise InputError(
                f"unrecognized ServingState engine {engine!r}: use one "
                "of auto/device/host"
            )
        from fastapriori_tpu_torch.models.recommender import AssociationRules

        self.levels = [
            (np.ascontiguousarray(m, dtype=np.int32),
             np.ascontiguousarray(c, dtype=np.int64))
            for m, c in levels
        ]
        self.item_counts = np.ascontiguousarray(item_counts, np.int64)
        self.freq_items = list(freq_items)
        self.item_to_rank = (
            dict(item_to_rank) if item_to_rank is not None
            else {item: r for r, item in enumerate(self.freq_items)}
        )
        self.config = config or MinerConfig()
        self.signature = model_signature(
            self.levels, self.item_counts, self.freq_items)
        self.source = source
        self._rec = AssociationRules(
            self.freq_items, self.item_to_rank, self.levels,
            self.item_counts, config=self.config, device=device,
            context=context,
        )
        self._engine_req = engine
        self._engine: Optional[str] = None  # resolved at warm()
        self._handle = None
        self._batch_rows_override: Optional[int] = None
        self._released = False
        self.warm_ms = 0.0
        # Per instance: K2 launches (the warm probe's included; one per
        # transaction shard per block) and the rows they covered; the
        # server's stats() reads them.
        self.scan_dispatches = 0
        self.scan_rows = 0
        # The recommender's table upload bytes when warm() mounted the
        # table (None: not mounted).
        self._mount_upload_bytes: Optional[int] = None

    @property
    def rule_table_host_bytes(self) -> int:
        """Rule-table bytes uploaded from the host after the mount: 0 on
        both forms while the mounted table serves (built on the device,
        or uploaded once inside :meth:`warm`); any re-upload counts."""
        if self._mount_upload_bytes is None:
            return 0
        return self._rec.table_upload_bytes - self._mount_upload_bytes

    @property
    def ctx(self):
        """The state's DeviceContext (``sync_check`` holds each batch's
        upload-launch-fetch issue to no host synchronisation)."""
        return self._rec.ctx

    # -- build / load ---------------------------------------------------
    @classmethod
    def from_mine(
        cls,
        d_path: str,
        config: Optional[MinerConfig] = None,
        engine: str = "auto",
        source: str = "mine",
        device=None,
        context=None,
    ) -> "ServingState":
        """Mine ``d_path`` and wrap the result (the ``serve`` CLI's model
        build), serving on the miner's context."""
        from fastapriori_tpu_torch.models.apriori import FastApriori

        config = config or MinerConfig()
        miner = FastApriori(config=config, device=device, context=context)
        levels, data = miner.run_file_raw(d_path)
        return cls(
            levels, data.item_counts, data.freq_items, data.item_to_rank,
            config=config, engine=engine, source=source, context=miner.ctx,
        )

    def save(self, prefix: str) -> str:
        """Write ``<prefix>serving.npz`` through the crash-safe writer and
        its manifest entry (a killed save leaves the old artifact or the
        new one; a truncated one fails validation at load), its manifest
        stamped with the quorum writer's fence (None without a
        domain)."""
        from fastapriori_tpu_torch.reliability import quorum

        arrays = {
            "meta": np.array(
                [1, len(self.levels), len(self.freq_items)], dtype=np.int64),
            "item_counts": self.item_counts,
            "freq_items": np.asarray(self.freq_items, dtype=np.str_),
            "signature": np.asarray([self.signature], dtype=np.str_),
        }
        for i, (mat, cnt) in enumerate(self.levels):
            arrays[f"mat_{i}"] = mat
            arrays[f"cnt_{i}"] = cnt
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        manifest: Dict[str, dict] = {}
        path = write_artifact_bytes(
            prefix + SERVING_NAME, [buf.getvalue()], SERVING_NAME, manifest)
        write_manifest(prefix, manifest, fence=quorum.writer_fence())
        return path

    @classmethod
    def load(
        cls,
        prefix: str,
        config: Optional[MinerConfig] = None,
        device=None,
        engine: str = "auto",
        context=None,
    ) -> "ServingState":
        """Warm restart from ``<prefix>serving.npz`` (validated against
        the manifest: a truncated or corrupt artifact is an InputError
        naming the file).  The stored signature must equal the one
        recomputed from the stored arrays.  One ``serving_restart``
        ledger event per signature."""
        from fastapriori_tpu_torch.io.resume import validate_artifact_bytes

        failpoints.fire("serving.load")
        path = prefix + SERVING_NAME
        try:
            with _open_bytes(path) as f:
                raw = f.read()
        except FileNotFoundError:
            raise InputError(
                f"serving checkpoint {path!r} not found — write one "
                "with ServingState.save (CLI: serve --save-serving)"
            ) from None
        validate_artifact_bytes(prefix, SERVING_NAME, raw)
        try:
            with np.load(io.BytesIO(raw)) as z:
                meta = z["meta"]
                if int(meta[0]) != 1:
                    raise ValueError(f"unknown version {int(meta[0])}")
                n_levels = int(meta[1])
                freq_items = [str(s) for s in z["freq_items"]]
                item_counts = z["item_counts"]
                stored_sig = str(z["signature"][0])
                levels = [(z[f"mat_{i}"], z[f"cnt_{i}"])
                          for i in range(n_levels)]
        except (KeyError, ValueError, OSError, zipfile.BadZipFile) as e:
            raise InputError(
                f"corrupt serving checkpoint {path!r}: {e} — regenerate "
                "it with ServingState.save"
            ) from None
        state = cls(levels, item_counts, freq_items, config=config,
                    device=device, engine=engine, source="restart",
                    context=context)
        if state.signature != stored_sig:
            raise InputError(
                f"serving checkpoint {path!r} signature mismatch "
                f"(stored {stored_sig}, recomputed {state.signature}) — "
                "the artifact does not describe the model it claims"
            )
        ledger.record("serving_restart", once_key=state.signature,
                      signature=state.signature, n_levels=len(levels))
        return state

    # -- model facts ----------------------------------------------------
    @property
    def n_rules(self) -> int:
        return self._rec.n_rules

    def batch_rows(self) -> int:
        """The largest scan block: the server's pinned bound
        (:meth:`set_batch_rows`), else the recommender's
        ``rec_batch_rows`` (config and ``FA_REC_BATCH``, pow2-bucketed),
        so the micro-batcher's collection bound and the scan's block are
        one number."""
        if self._batch_rows_override is not None:
            return self._batch_rows_override
        return self._rec.rec_batch_rows()

    def set_batch_rows(self, rows: int) -> None:
        """Pin the block bound through the shared bucketing
        (models/recommender.py ``bucket_batch_rows``)."""
        from fastapriori_tpu_torch.models.recommender import (
            bucket_batch_rows,
        )

        self._batch_rows_override = bucket_batch_rows(rows)

    def describe(self) -> dict:
        """Model facts for the serving record and stats (``n_rules`` None
        until the rules exist: describing a state generates nothing)."""
        arrays = self._rec._rule_arrays
        out = {
            "signature": self.signature,
            "source": self.source,
            "engine": self._engine or self._engine_req,
            "n_rules": len(arrays[1]) if arrays is not None else None,
            "n_items": len(self.freq_items),
            "batch_rows": self.batch_rows(),
            "scan_dispatches": self.scan_dispatches,
            "scan_rows": self.scan_rows,
            "rule_table_host_bytes": self.rule_table_host_bytes,
            "warm_ms": round(self.warm_ms, 3),
        }
        if self._handle is not None:
            out["resident_table"] = bool(self._handle.resident)
            out["scan_shards"] = self._handle.shards
            out["table_bytes"] = self._handle.table_bytes
            out["kernel"] = self._handle.kernel
        return out

    # -- serving --------------------------------------------------------
    def _resolve_engine(self) -> str:
        """``auto``: the device scan when the device rule engine left a
        table to build on the device, else the batch path's rule
        (models/recommender.py ``device_scan_wanted``) on one full block,
        so the choice depends on the model, not on the traffic."""
        if self._engine is not None:
            return self._engine
        from fastapriori_tpu_torch.models.recommender import (
            device_scan_wanted,
        )

        eng = self._engine_req
        rec = self._rec
        n_rules = self.n_rules  # generates the rules
        if eng == "auto":
            if rec._scan_state is not None or rec._scan_table is not None:
                eng = "device"
            else:
                eng = ("device" if device_scan_wanted(self.batch_rows(),
                                                      n_rules)
                       else "host")
        if eng == "device" and not n_rules:
            eng = "host"
        if eng == "host" and rec._scan_state is not None:
            # The host scan never reads the engine's resident state.
            rec._scan_state.release()
            rec._scan_state = None
        self._engine = eng
        ledger.record("serve_engine", once_key=f"{self.signature}:{eng}",
                      engine=eng, signature=self.signature, rules=n_rules)
        return eng

    def bind_thread(self) -> None:
        """Make this state's device the calling thread's current CUDA
        device (each server thread that launches calls it first)."""
        dev = self._rec.ctx.device
        if dev.type == "cuda":
            import torch

            torch.cuda.set_device(dev)

    def warm(self) -> None:
        """Resolve the engine, mount the table and launch K2 once on a
        one-basket block (:meth:`device_ready`), so the first request
        does not pay for generating the rules, the table's upload or
        loading K2's module.  After it no rule-table byte crosses the
        host link."""
        t0 = time.perf_counter()
        if self._resolve_engine() == "device" and self._handle is None:
            self._handle = self._rec.serve_scan()
            self._mount_upload_bytes = self._rec.table_upload_bytes
            self.device_ready()
        self.warm_ms = (time.perf_counter() - t0) * 1e3

    def device_ready(self) -> bool:
        """The swap path's readiness probe: on the device engine, one
        one-basket block through upload, K2 and the audited
        ``fetch.serve_swap_ready`` (a table that cannot serve fails here,
        classified, before a barrier commits it); False on the host
        engine."""
        if self._resolve_engine() != "device":
            return False
        if self._handle is None:
            self.warm()
            return True
        block = self._pack_blocks([np.zeros(1, dtype=np.int32)])[0]
        _, cons = self._handle.scan(block[2], block[3])
        self.scan_dispatches += self._handle.launches
        self.scan_rows += block[2].shape[0]
        self._rec.ctx.fetch(cons, "serve_swap_ready")
        return True

    def _pack_blocks(self, baskets: List[np.ndarray]) -> list:
        """The host half of the scan: distinct baskets cut into numpy
        bitmap blocks of at most :meth:`batch_rows` baskets by the batch
        path's cutter (models/recommender.py ``micro_batches``).  Pure
        numpy, no device work: the pack thread runs it."""
        return list(self._rec.micro_batches(baskets, self.batch_rows()))

    def _dispatch_packed(self, blocks: list) -> list:
        """Upload, launch K2 and start the audited fetch of each block's
        consequents, without waiting for any of them (under the
        context's ``sync_free`` when ``sync_check`` is on).  The host
        blocks stay referenced beside their fetch."""
        h = self._handle
        ctx = self._rec.ctx
        fetches = []
        with ctx.sync_free():
            for b0, n, bm, blen in blocks:
                _, cons = h.scan(bm, blen)
                fetches.append((b0, n, ctx.fetch_async(cons, "serve_match"),
                                (bm, blen)))
                self.scan_dispatches += h.launches
                self.scan_rows += bm.shape[0]
        return fetches

    @staticmethod
    def _fetch_blocks(fetches: list, total: int) -> np.ndarray:
        """Wait for the fetches; the consequent per distinct basket (-1:
        no match)."""
        cons_out = np.full(total, -1, dtype=np.int64)
        for b0, n, fetch, _ in fetches:
            cons_out[b0 : b0 + n] = fetch.result()[:n]
        return cons_out

    def _scan_blocks(self, baskets: List[np.ndarray]) -> np.ndarray:
        """Pack and scan distinct baskets: ``serve.pack`` the host side
        (the bitmap blocks, the launches), ``serve.scan`` the waits on
        the ``fetch.serve_match`` fetches."""
        with trace.span("serve.pack", baskets=len(baskets)):
            fetches = self._dispatch_packed(self._pack_blocks(baskets))
        with trace.span("serve.scan", dispatches=len(fetches)):
            return self._fetch_blocks(fetches, len(baskets))

    def pack_batch(self, lines: Sequence[Sequence[str]]) -> PackedBatch:
        """Stage 1 of the two-stage server: dedup and, on a state whose
        engine is resolved as the device's, the bitmap blocks; no CUDA
        work (an unresolved state packs at the scan stage, which
        resolves it).  ``recommend_batch(lines)`` is
        ``scan_packed(pack_batch(lines))``; a state whose
        ``recommend_batch`` is overridden on the instance defers the raw
        lines to :meth:`scan_packed`."""
        if self.__dict__.get("recommend_batch") is not None:
            packed = PackedBatch(self, len(lines))
            packed.deferred = True
            packed.lines = [list(ln) for ln in lines]
            return packed
        return self._pack_real(lines)

    def _pack_real(self, lines: Sequence[Sequence[str]]) -> PackedBatch:
        if self._released:
            raise InputError(
                "ServingState was released (hot-swapped out); build or "
                "load a fresh state to serve"
            )
        with trace.span("serve.dedup", rows=len(lines)) as sp:
            baskets, indexes, _empty = dedup_user_baskets(
                lines, self.item_to_rank)
            sp.update(distinct=len(baskets))
        packed = PackedBatch(self, len(lines))
        packed.baskets = baskets
        packed.indexes = indexes
        if baskets and self._engine == "device":
            with trace.span("serve.pack", baskets=len(baskets)):
                packed.blocks = self._pack_blocks(baskets)
            packed.mb = self.batch_rows()
        return packed

    def recommend_batch(self, lines: Sequence[Sequence[str]]) -> List[str]:
        """Serve one request micro-batch: one recommended item (or "0")
        per line, in input order.  A failure of the device scan (an
        exhausted ``fetch.serve_match``, K2's launch) raises: nothing
        moves the batch to the host scan."""
        return self.scan_packed(self._pack_real(lines))

    def scan_packed(self, packed: PackedBatch) -> List[str]:
        """Stage 2: scan a :class:`PackedBatch` on the resolved engine
        and fan the consequents out to input order.  Blocks cut at
        another ``batch_rows`` (a swap re-pinned it) are cut again from
        the baskets."""
        if packed.deferred:
            return self.recommend_batch(packed.lines)
        if self._released:
            raise InputError(
                "ServingState was released (hot-swapped out); build or "
                "load a fresh state to serve"
            )
        baskets, indexes = packed.baskets, packed.indexes
        out = ["0"] * packed.n_lines
        if not baskets or not self.n_rules:
            return out
        if self._resolve_engine() == "device":
            if self._handle is None:
                self.warm()
            if packed.blocks is not None and packed.mb == self.batch_rows():
                with trace.span("serve.scan", dispatches=len(packed.blocks)):
                    fetches = self._dispatch_packed(packed.blocks)
                    cons = self._fetch_blocks(fetches, len(baskets))
            else:
                cons = self._scan_blocks(baskets)
        else:
            with trace.span("serve.host_scan", baskets=len(baskets)):
                cons = np.asarray(self._rec._host_first_match(baskets),
                                  dtype=np.int64)
        for rows, c in zip(indexes, cons):
            if c >= 0:
                item = self.freq_items[int(c)]
                for i in rows:
                    out[i] = item
        return out

    def _drop_device_table(self) -> None:
        """Drop every device reference this state holds: the handle (and
        the table its scan closes over), the engine's resident state and
        both table forms."""
        self._handle = None
        rec = self._rec
        if rec._scan_state is not None:
            rec._scan_state.release()
            rec._scan_state = None
        rec._scan_table = None
        rec._table_dev = None

    def release(self) -> None:
        """Free the device table (a swapped-out model must not pin device
        memory); later batches on this state raise."""
        self._released = True
        self._drop_device_table()

    def resident_device_bytes(self) -> int:
        """Device bytes the state pins: the mounted table plus any
        device rule state not yet built into it."""
        h = self._handle
        # The strided table's slices, one per shard.
        total = h.table_bytes * h.shards if h is not None else 0
        state = self._rec._scan_state
        if state is not None:
            total += state.device_bytes()
        return total
