"""Device placement (counterpart: the one-process part of
fastapriori_tpu/parallel/mesh.py ``DeviceContext`` — the mesh of shard
devices (parallel/mesh.py) with its placements, upload,
the vertical engine's arena build on the card, its arena and plane
uploads, fetch, the ingest-
overlapped pair program ``ingest_pair_miner``, its overflow
``pair_regather``, the remembered pair budgets, the fused engine's
memos (``fused_m_cap_hint``, ``fused_failed``, ``auto_level``) with the
device's memory size for its memory model, and the survivor-count
gather ``gather_level_counts_start`` / ``finish_level_counts`` with
``PendingCounts`` and ``_pad_positions``; the collectives are
parallel/mesh.py's).

Every device -> host read goes through the reliability core's audited
fetch (reliability/retry.py ``fetch`` / ``fetch_async``) under the site
name of the JAX package's inventory: the ``fetch.<site>`` failpoint,
bounded retries of transient errors, and the dispatch watchdog.

The pipelined ingest's uploads (:class:`BlockUploader`) go through pinned
host memory on a side stream, so they overlap the host's compression of
the next block; the main stream waits for that stream before it reads
them.  Nothing between the last block's arrival and the pair program's
fetch waits for the device: :meth:`DeviceContext.sync_free` can hold that
region to it (``torch.cuda.set_sync_debug_mode("error")``).

Entry points run on ``cuda`` unless the caller asks for ``cpu``.  With no
CUDA device and no such request, :func:`resolve_device` raises
``InputError``: the port never quietly runs on the CPU.
"""

from __future__ import annotations

import contextlib
import functools
import os
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from fastapriori_tpu_torch.errors import InputError
from fastapriori_tpu_torch.obs import trace
from fastapriori_tpu_torch.ops.bitmap import next_pow2, unpack_bitmap
from fastapriori_tpu_torch.ops.count import (
    frequent_pair_mask,
    l3_threshold_pack,
    local_pair_regather,
    pair_threshold_pack,
)
from fastapriori_tpu_torch.ops.level_kernel import (
    level_counts,
    level_counts_plain,
)
from fastapriori_tpu_torch.ops.vertical_kernel import (
    build_arena,
    build_arena_plain,
    lane_plane_mask,
)
from fastapriori_tpu_torch.parallel import mesh
from fastapriori_tpu_torch.parallel.mesh import Mesh, resolve_devices
from fastapriori_tpu_torch.reliability import failpoints, retry
from fastapriori_tpu_torch.reliability.retry import AsyncFetch


def resolve_device(device: Optional[Union[str, torch.device]] = None):
    """``None``/``"cuda"`` -> the current CUDA device (InputError when
    there is none); ``"cpu"`` -> the CPU, where every kernel wrapper runs
    its plain PyTorch version."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise InputError(
                "no CUDA device is available; this port runs on the GPU "
                "unless asked otherwise (--platform cpu on the CLI, "
                "device='cpu' in the API)"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        # The pair Gram and the heavy-row corrections are float matmuls
        # that are exact only in full precision (models/apriori.py): keep
        # cuBLAS off TF32 for the process.
        torch.backends.cuda.matmul.allow_tf32 = False
    elif dev.type != "cpu":
        raise InputError(f"unsupported device {str(dev)!r}: use cuda or cpu")
    return dev


# Fewest positions a gather segment is padded to.  PyTorch's CUDA
# index_select takes another kernel for at most 16 indexes, and a fresh
# process loads that kernel's module at its first launch (the zero-flag
# run's resolve waited on it: PERF.md, PR 10); 32 keeps every segment on
# the one kernel the larger gathers load anyway.
GATHER_MIN_POSITIONS = 32


def _pad_positions(pos: np.ndarray) -> np.ndarray:
    """Gather positions padded with 0 (a valid index whose gathered value
    :class:`PendingCounts` strips) to the next power of two, at least
    :data:`GATHER_MIN_POSITIONS`, so the gather's shapes come from a few
    buckets and take one kernel."""
    out = np.zeros(next_pow2(max(int(pos.size), GATHER_MIN_POSITIONS)),
                   dtype=np.int64)
    out[: pos.size] = pos
    return out


class PendingCounts:
    """A started survivor-count gather whose compact output is on its way
    to the host (an audited :class:`AsyncFetch`); :meth:`result` waits,
    decodes the
    optional u24 3-byte planes and strips each segment's position
    padding, so the caller gets exactly its counts, concatenated in
    segment order."""

    def __init__(self, fetch: AsyncFetch, seg_real: Sequence[int],
                 seg_pad: Sequence[int], u24: bool):
        self._fetch = fetch
        self._seg_real = list(seg_real)
        self._seg_pad = list(seg_pad)
        self._u24 = u24

    def result(self) -> np.ndarray:
        out = self._fetch.result()
        if self._u24:
            dec = (out[0].astype(np.int64)
                   | (out[1].astype(np.int64) << 8)
                   | (out[2].astype(np.int64) << 16))
        else:
            dec = out.astype(np.int64)
        parts, off = [], 0
        for real, pad in zip(self._seg_real, self._seg_pad):
            parts.append(dec[off : off + real])
            off += pad
        return np.concatenate(parts) if parts else np.empty(0, np.int64)


class BlockUploader:
    """Host arrays to the device on one worker thread, in submission
    order.  On CUDA each array is copied into pinned memory and sent on
    a side stream (entered in the worker thread: the current stream is
    per thread); the pinned buffers stay referenced until :meth:`close`
    has waited for their copies.  On the CPU the array itself becomes
    the tensor.  The worker thread is ``fa-upload_0``; with tracing on,
    each submission is an ``upload`` span there (its host time: the
    pinned copy and the copy's launch)."""

    def __init__(self, device: torch.device):
        self.device = device
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="fa-upload")
        self._stream = (
            torch.cuda.Stream(device) if device.type == "cuda" else None
        )
        self._held: List[Tuple[torch.Tensor, torch.cuda.Event]] = []

    def submit(self, x: np.ndarray) -> Future:
        return self._pool.submit(self._put, x)

    def _put(self, x: np.ndarray) -> torch.Tensor:
        with trace.span("upload", bytes=int(x.nbytes)):
            return self._put_now(x)

    def _put_now(self, x: np.ndarray) -> torch.Tensor:
        host = torch.from_numpy(x)
        if self._stream is None:
            return host
        with torch.cuda.stream(self._stream):
            pinned = host.pin_memory()
            dev = pinned.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        self._held.append((pinned, event))
        return dev

    def gather(self, futures: Sequence[Future]) -> List[torch.Tensor]:
        """The uploaded tensors, with the current stream ordered after
        their copies (and the tensors marked as used there, so their
        memory is not handed out again before it has read them)."""
        out = [fu.result() for fu in futures]
        if self._stream is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_stream(self._stream)
            for t in out:
                t.record_stream(cur)
        return out

    def close(self) -> None:
        self._pool.shutdown()
        for _, event in self._held:
            event.synchronize()
        self._held.clear()


class DeviceContext:
    """The device mesh of one process (parallel/mesh.py ``Mesh``): host
    arrays go up with :meth:`upload` (shard 0's device) or the placement
    methods (:meth:`shard_rows`, :meth:`shard_lanes`, :meth:`place`),
    results come back with :meth:`fetch`.  ``num_devices`` /
    ``cand_devices`` / ``devices`` as for parallel/mesh.py
    ``resolve_devices`` and ``Mesh``: with ``num_devices`` None, one
    shard on a named ``device``, every visible card when ``device`` is
    None too.  ``device`` is shard 0's device.
    ``sync_check``: run the pipelined ingest's pair dispatch under
    :meth:`sync_free` (a test of the overlap; off by default).

    ``exchange_spec``: the two-level exchange topology of the mine's
    sparse reductions (parallel/hier.py), or None for flat; the engine
    installs it once per mine (models/apriori.py ``_exchange_spec``) and
    a cascade walk sets it back to None."""

    def __init__(self, device: Optional[Union[str, torch.device]] = None,
                 num_devices: Optional[int] = None, cand_devices: int = 1,
                 devices: Optional[Sequence] = None):
        card = mesh.rank_card()
        named = None if device is None else torch.device(device)
        if (card is not None and devices is None
                and (named is None or named.type == "cuda")):
            # A --distributed rank's shards all lie on its own card; a
            # caller who names another card is refused, not moved.
            if named is not None and named.index not in (None, card.index):
                raise InputError(
                    f"device {str(named)!r} is not this rank's card "
                    f"{str(card)!r} (cuda:(LOCAL_RANK mod visible cards))")
            devices = [card] * (num_devices or 1)
        self.mesh = Mesh(resolve_devices(device, num_devices, devices),
                         cand_devices)
        self.device = self.mesh.devices[0]
        self.exchange_spec: Optional[Tuple[int, int]] = None
        self.sync_check = False
        self._pair_caps: Dict[tuple, int] = {}
        self._fused_hints: Dict[tuple, int] = {}
        self._fused_fails: set = set()
        self._auto_level: set = set()

    @property
    def platform(self) -> str:
        return self.device.type

    @property
    def n_devices(self) -> int:
        """Shard positions of the global mesh (every process's)."""
        return self.mesh.n_devices * self.mesh.world

    @property
    def txn_shards(self) -> int:
        """Transaction shards of the global mesh (every process's)."""
        return self.mesh.txn_shards * self.mesh.world

    @property
    def local_txn_shards(self) -> int:
        """Transaction shards this process holds (the length of the
        per-shard lists)."""
        return self.mesh.txn_shards

    @property
    def cand_shards(self) -> int:
        return self.mesh.cand_shards

    @property
    def world(self) -> int:
        """Processes of the mesh (1 unless ``--distributed`` joined
        several)."""
        return self.mesh.world

    def upload(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def place(self, x: np.ndarray, devices: Sequence[torch.device],
              non_blocking: bool = False) -> List[torch.Tensor]:
        """``x`` on each of ``devices``, uploaded once per distinct
        device; ``non_blocking`` as :meth:`upload_async` (through pinned
        memory, the host does not wait)."""
        host = torch.from_numpy(np.ascontiguousarray(x))
        if non_blocking and any(d.type == "cuda" for d in devices):
            host = host.pin_memory()
        copies: Dict[torch.device, torch.Tensor] = {}
        out = []
        for d in devices:
            if d not in copies:
                copies[d] = host.to(d, non_blocking=non_blocking)
            out.append(copies[d])
        return out

    def shard_rows(self, x: np.ndarray, axis: int = 0,
                   txn_only: bool = False) -> List[torch.Tensor]:
        """Rows (``axis`` 0) or columns (``axis`` -1) of ``x`` split into
        this process's ``local_txn_shards`` contiguous blocks: the
        per-position list of the mesh (position ``t·C + c`` holds block
        t, one upload per distinct device and block), or with
        ``txn_only`` the list over the transaction shards of candidate
        block 0.  The axis must divide evenly.  In a multi-process world
        ``x`` holds this process's rows only (the JAX package's
        ``shard_rows_local``, ``upload_packed_local`` and
        ``shard_weight_digits_local``): each rank uploads its own rows to
        its own card, and bulk data never crosses ranks."""
        t_sh = self.local_txn_shards
        cols = 1 if txn_only else self.cand_shards
        n = x.shape[axis]
        assert n % t_sh == 0, (x.shape, t_sh)
        per = n // t_sh
        out = []
        for t in range(t_sh):
            sl = [slice(None)] * x.ndim
            sl[axis] = slice(t * per, (t + 1) * per)
            out.extend(self.place(x[tuple(sl)],
                                  [self.mesh.device(t, c)
                                   for c in range(cols)]))
        return out

    def shard_lanes(self, x: torch.Tensor) -> List[torch.Tensor]:
        """A device tensor's last axis (the vertical engine's lanes) split
        into this process's ``local_txn_shards`` contiguous blocks, each
        on its shard's device: the per-position list (``[x]`` itself on
        one shard).  In a multi-process world ``x`` holds this process's
        lanes (as the JAX package's lane-local arena and plane
        uploads)."""
        if self.mesh.n_devices == 1:
            return [x]
        t_sh = self.local_txn_shards
        per = x.shape[-1] // t_sh
        assert per * t_sh == x.shape[-1], (x.shape, t_sh)
        out = []
        for t in range(t_sh):
            blk = x[..., t * per : (t + 1) * per].contiguous()
            out.extend(mesh.broadcast(
                blk, [self.mesh.device(t, c)
                      for c in range(self.cand_shards)]))
        return out

    def txn_parts(self, parts: Sequence[torch.Tensor],
                  c: int = 0) -> List[torch.Tensor]:
        """Candidate block ``c``'s tensors of a per-position list, in
        transaction-shard order."""
        return [parts[t * self.cand_shards + c]
                for t in range(self.local_txn_shards)]

    def local_row_slice(self, n_rows: int) -> slice:
        """This process's contiguous rows of ``n_rows`` split over the
        global transaction shards (process-major; all of them in one
        process); InputError when they do not divide evenly.  A result
        of such rows comes back whole through parallel/mesh.py's
        ``tiled_all_gather`` (the JAX package's ``local_rows`` and one
        ``process_allgather``)."""
        world = self.mesh.world
        if world == 1:
            return slice(0, n_rows)
        if self.cand_shards != 1 or n_rows % world != 0:
            raise InputError(
                "multi-process row sharding needs a 1-D txn mesh and rows "
                f"divisible by the processes (cand_shards="
                f"{self.cand_shards}, rows={n_rows}, processes={world})")
        per = n_rows // world
        return slice(self.mesh.rank * per, (self.mesh.rank + 1) * per)

    def shard_rule_rows(self, x: np.ndarray,
                        shards: int) -> List[torch.Tensor]:
        """The rows of a rule-phase table split over the first ``shards``
        transaction shards (the rule join's query rows; one shard: the
        whole table on shard 0), uploaded without waiting; the
        ``rules.upload`` failpoint site of every rule-table placement."""
        failpoints.fire("rules.upload")
        assert x.shape[0] % shards == 0, (x.shape, shards)
        per = x.shape[0] // shards
        return [self.place(x[t * per : (t + 1) * per], [d],
                           non_blocking=True)[0]
                for t, d in enumerate(self.mesh.txn_devices()[:shards])]

    def replicate_rule_table(self, x: np.ndarray,
                             shards: int) -> List[torch.Tensor]:
        """A small rule-phase side table (1-itemset counts, consequent
        priorities) on each of the first ``shards`` transaction shards'
        devices, one upload per distinct device; the same
        ``rules.upload`` failpoint site."""
        failpoints.fire("rules.upload")
        return self.place(x, self.mesh.txn_devices()[:shards],
                          non_blocking=True)

    def upload_async(self, x: np.ndarray) -> torch.Tensor:
        """Like :meth:`upload`, but on CUDA through pinned memory with a
        non-blocking copy on the current stream: the host does not wait
        for the work already queued there."""
        host = torch.from_numpy(np.ascontiguousarray(x))
        if self.device.type != "cuda":
            return host
        return host.pin_memory().to(self.device, non_blocking=True)

    def block_uploader(self) -> BlockUploader:
        return BlockUploader(self.device)

    def plain_kernels(self) -> bool:
        """``FA_NO_PALLAS`` (strictly parsed on every device: a value it
        does not know is an InputError): true on a CUDA device means the
        caller runs each hand kernel's plain PyTorch version on the card
        (K1 ``level_counts_plain``, K2 ``first_match_plain``, K3
        ``vertical_counts_plain``), an explicit choice of the user that
        the ledger records once per run (``pallas_disabled``).  On the
        CPU the wrappers run their plain versions anyway: False, and no
        event, as the JAX package off the TPU."""
        from fastapriori_tpu_torch.reliability import ledger
        from fastapriori_tpu_torch.utils.env import env_flag

        off = env_flag("FA_NO_PALLAS", False)
        if not off or self.device.type != "cuda":
            return False
        ledger.record_once("pallas_disabled", "env", reason="FA_NO_PALLAS",
                           value=os.environ.get("FA_NO_PALLAS", ""))
        return True

    @contextlib.contextmanager
    def sync_free(self):
        """With ``sync_check`` on CUDA: any operation in the block that
        waits for the device raises (``torch.cuda.set_sync_debug_mode
        ("error")``).  Else a no-op."""
        if not (self.sync_check and self.device.type == "cuda"):
            yield
            return
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(prev)

    @property
    def memory_bytes(self) -> int:
        """The device's memory for the fused engine's memory model: the
        CUDA card's total, or the reference's 16 GiB default on the
        CPU."""
        if self.device.type == "cuda":
            return torch.cuda.get_device_properties(self.device).total_memory
        return 16 * 2**30

    def fused_m_cap_hint(self, profile: tuple) -> Optional[int]:
        """The last row budget at which the fused engine completed this
        profile: repeat runs skip the sizing pre-pass and start there."""
        return self._fused_hints.get(profile)

    def record_fused_m_cap(self, profile: tuple, m_cap: int) -> None:
        self._fused_hints[profile] = m_cap

    def fused_failed(self, profile: tuple) -> bool:
        """A fused run of this profile exhausted its row-budget ceiling:
        repeat runs go straight to the level engine."""
        return profile in self._fused_fails

    def record_fused_fail(self, profile: tuple) -> None:
        self._fused_fails.add(profile)

    def auto_level(self, profile: tuple) -> bool:
        """The auto choice already picked the level engine for this
        profile (kept apart from the failure memo, so that a forced fused
        run is not blocked by a mere choice)."""
        return profile in self._auto_level

    def record_auto_level(self, profile: tuple) -> None:
        self._auto_level.add(profile)

    def pair_cap_hint(self, key: tuple) -> Optional[int]:
        """The last budget that held this profile's survivors: repeat
        runs start there instead of paying the overflow path again."""
        return self._pair_caps.get(key)

    def record_pair_cap(self, key: tuple, cap: int) -> None:
        self._pair_caps[key] = cap

    def ingest_pair_miner(
        self,
        blocks: Sequence[torch.Tensor],  # packed uint8 [t_i, F // 8]
        ws: Sequence[torch.Tensor],  # int32 [t_i] raw block weights
        t_pad: int,
        min_count: int,
        num_items: int,
        cap: int,
        census: bool,
        l3: Optional[Tuple[int, int, int, str]] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """From the uploaded packed blocks to ``(bitmap int8[t_pad, F],
        packed pair output, counts int32[F, F])`` in one sequence of
        device work, issued the moment the last block has landed: concat,
        zero tail rows, unpack, the pair Gram as one float32 product over
        the raw weights (exact while every count < 2^24: the caller gates
        on ``n_raw``; so no weight-digit split and no heavy-row
        correction, which the host is still assembling), then
        ops/count.py ``pair_threshold_pack``.  ``l3=(p3, cap3, n_digits,
        form)`` appends ``l3_threshold_pack``'s level 3, cut from the
        same mask and counted by K1 in ``form`` once per weight digit
        (``"plain"``: K1's plain version on the card, ``FA_NO_PALLAS``).
        ``counts`` stays on the device for an overflow
        :meth:`pair_regather`."""
        pk = torch.cat(list(blocks)) if len(blocks) > 1 else blocks[0]
        w = torch.cat(list(ws)) if len(ws) > 1 else ws[0]
        total = pk.shape[0]
        if t_pad > total:
            pk = torch.cat([pk, pk.new_zeros((t_pad - total, pk.shape[1]))])
            w = torch.cat([w, w.new_zeros(t_pad - total)])
        bitmap = unpack_bitmap(pk)
        b_f = bitmap.to(torch.float32)
        w_f = w.to(torch.float32)
        counts = ((b_f * w_f[:, None]).T @ b_f).to(torch.int32)
        del b_f
        packed = pair_threshold_pack(counts, min_count, num_items, cap,
                                     census)
        if l3 is not None:
            p3, cap3, n_digits, form = l3
            count_fn = (level_counts_plain if form == "plain" else
                        functools.partial(level_counts, form=form))
            mask = frequent_pair_mask(counts, min_count, num_items)
            packed = torch.cat([packed, l3_threshold_pack(
                bitmap, w, mask, packed[2 * cap], min_count, num_items,
                p3, cap3, n_digits, count_fn,
            )])
        return bitmap, packed, counts

    def pair_regather(
        self, counts: torch.Tensor, min_count: int, num_items: int, cap: int,
        site: str = "pair_regather", extra: Optional[torch.Tensor] = None,
    ) -> Tuple[np.ndarray, np.ndarray, int, Optional[int]]:
        """The first ``cap`` frequent pairs of a resident count matrix
        (ops/count.py ``local_pair_regather``): host int64 ``(flat_idx,
        counts, n2, extra)``, one fetch under ``fetch.<site>`` (``pair``
        or ``vpair`` for a pair level's first extraction, with
        ``_sparse`` under the sparse reduction, ``pair_regather`` for
        the overflow path's); ``extra``, a device scalar riding the same
        fetch (the sparse union count), comes back as a host int (None
        without)."""
        idx, cnt, n2 = local_pair_regather(counts, min_count, num_items, cap)
        parts = [idx, cnt.long(), n2.long()[None]]
        if extra is not None:
            parts.append(extra.long().reshape(1))
        out = self.fetch(torch.cat(parts), site)
        return (out[:cap], out[cap : 2 * cap], int(out[2 * cap]),
                int(out[2 * cap + 1]) if extra is not None else None)

    @staticmethod
    def fetch_async(x: torch.Tensor, site: str) -> AsyncFetch:
        """An audited fetch of ``x`` started now, read later."""
        return retry.fetch_async(x, site)

    @staticmethod
    def gather_level_counts_start(
        pending: Sequence[Tuple[torch.Tensor, np.ndarray]],
        u24: bool = False,
        site: str = "counts",
    ) -> PendingCounts:
        """The survivor-count gather: each ``(counts_dev, flat
        positions)`` pair's counts gathered on the device, concatenated,
        and one non-blocking audited fetch of the result started under
        ``fetch.<site>``; the host does not wait.  ``pending`` holds at
        least one pair.  The positions go up as one pinned upload, each
        segment padded by :func:`_pad_positions`.  ``u24``: every count
        is < 2^24 (the caller's gate), so three uint8 planes cross
        instead of int32."""
        dev = pending[0][0].device
        real = [np.asarray(p) for _, p in pending]
        padded = [_pad_positions(p) for p in real]
        pos = torch.from_numpy(np.concatenate(padded))
        if dev.type == "cuda":
            pos = pos.pin_memory().to(dev, non_blocking=True)
        segs = torch.split(pos, [p.size for p in padded])
        g = torch.cat([c.reshape(-1).index_select(0, p)
                       for (c, _), p in zip(pending, segs)])
        if u24:
            g = torch.stack([((g >> s) & 0xFF).to(torch.uint8)
                             for s in (0, 8, 16)])
        return PendingCounts(retry.fetch_async(g, site),
                             [p.size for p in real], [p.size for p in padded],
                             u24)

    @staticmethod
    def finish_level_counts(handle: PendingCounts) -> np.ndarray:
        """The host int64 counts of a :meth:`gather_level_counts_start`
        handle (waits for its fetch)."""
        return handle.result()

    def build_tid_arena_on_device(
        self, indices: np.ndarray, offsets: np.ndarray, num_items: int,
        f_pad: int, nl: int, plain: bool = False,
    ) -> Tuple[torch.Tensor, int]:
        """The vertical engine's int32 ``[f_pad+1, nl]`` arena built on
        this context's device from the basket CSR (ops/vertical_kernel.py
        ``build_arena``: the kernel on a card, its plain version on the
        CPU), the JAX package's host-built arena bit for bit.  On CUDA the
        CSR goes up through pinned memory, non-blocking on the current
        stream, and the kernel launches behind it: the host does not
        wait for the device.  ``plain`` (the caller's
        :meth:`plain_kernels`) builds with the plain version on the
        card.  Returns ``(arena, csr_bytes)``, the bytes of the CSR
        uploaded."""
        cuda = self.device.type == "cuda"
        # One copy of the CSR into (pinned) host memory: the ingest's
        # arrays are read-only, which torch.from_numpy warns about.
        idx, off = (torch.empty(len(x), dtype=dtype, pin_memory=cuda)
                    for x, dtype in ((indices, torch.int32),
                                     (offsets, torch.int64)))
        idx.numpy()[:] = indices
        off.numpy()[:] = offsets
        csr_bytes = idx.numel() * 4 + off.numel() * 8
        if cuda:
            idx, off = (x.to(self.device, non_blocking=True)
                        for x in (idx, off))
            if plain:
                return build_arena_plain(idx, off, f_pad, nl), csr_bytes
        return build_arena(idx, off, num_items, f_pad, nl), csr_bytes

    def upload_lane_planes(self, planes_np: np.ndarray) -> torch.Tensor:
        """The uint32 ``[B, NL]`` weight bit-planes as int32 (the same
        bits), beside the arena; K3's per-lane plane mask is derived from
        them here, once (ops/vertical_kernel.py ``lane_plane_mask``)."""
        planes = self.upload(planes_np.view(np.int32))
        lane_plane_mask(planes)
        return planes

    @staticmethod
    def fetch(x: torch.Tensor, site: str) -> np.ndarray:
        """An audited, retried fetch of ``x`` under ``fetch.<site>``."""
        return retry.fetch(lambda: x.cpu().numpy(), site)
