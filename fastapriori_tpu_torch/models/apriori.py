"""Mining engine (counterpart: fastapriori_tpu/models/apriori.py
``FastApriori.run_file_raw`` — the pipelined capture ingest
``_run_file_pipelined_capture`` with ``_can_pipeline_ingest``,
``_pipeline_engine_probe``, ``_assemble_blocks`` and the ingest-overlapped
pair + level-3 program, the fused whole-loop engine (``_mine_fused``,
``_fused_resident``, ``_size_fused_budget``, ``_auto_fused_ok``,
``_fused_attempt_loop``) and the level engine with its shallow-tail fold
(``_mine_levels``, ``_level_loop_impl``, ``_tail_entry_ok``,
``_mine_tail``, ``_count_level``) with its deferred survivor counts
(``_drain_pending``, ``_resolve_pending_counts``), per-level checkpoints
and resume (``set_resume_levels``, ``_take_resume``,
``_checkpoint_levels``, the fused engine's checkpoint segments), the
cascade's safe wrappers (``_mine_vertical_safe``,
``_fused_resident_safe``), ``_split_weights``, ``_mine_engine`` and
``_mine_vertical``, with the quorum domain's consults and the elastic
arm; reference C6-C9, FastApriori.scala:31-160).

``run_file_raw`` ingests D.dat in one native call that cuts it into
``ingest_pipeline_blocks`` line-aligned blocks (pass 1 over
``ingest_threads`` segments, then the blocks replayed on as many
threads).  A pass-1 probe picks the layout before any block arrives.  On
the bitmap layout each block is bit-packed in its callback and uploaded
on a side stream while the next block is compressed; when the last block
lands, one sequence of device work (device.py ``ingest_pair_miner``)
builds the bitmap and counts levels 2 and 3, and its packed result is
fetched asynchronously while the host assembles the weights.  Level 2,
and level 3 when it fits its budgets, are then reads of that fetch.
Without the native library, or with ``ingest_pipeline_blocks <= 1``, the
one-call scan runs instead and the bitmap is built after it.

Blocks are deduplicated apart: identical baskets of two blocks stay two
weighted rows, so the arrays of the returned ``CompressedData`` depend on
the block and thread counts, its weighted counts do not.

Two layouts count the same lattice:

- ``bitmap``: the transaction x item bitmap; level 2 is one pair Gram
  matrix thresholded on the device, every level k >= 3 is counted by K1
  (ops/count.py ``local_level_gather``);
- ``vertical``: per-item packed tid lanes (ops/vertical.py); level 2 is
  a Gram product over unpacked lane chunks, every level k >= 3 is
  counted by K3 (``vertical_level_local``).

``mine_engine`` (``FA_MINE_ENGINE`` over ``MinerConfig.mine_engine``)
picks the layout; a forced ``vertical`` runs the vertical engine or
raises InputError, never the bitmap engine.  Both layouts share the level
loop: candidates generated on the host (models/candidates.py
``gen_candidates_stream``: the native join + prune when its library is
available), one launch per chunk of at most ``level_prefix_cap`` prefix
rows (:func:`level_chunks`).
The result is the reference's ``[(int32[N, k] lex-sorted member matrix,
int64[N] counts), ...]`` for k = 2, 3, ...; 1-itemsets live in
``data.item_counts``.

On the bitmap layout ``engine`` picks how the levels are counted, as
the reference package does:

- ``auto`` (the default) offers the whole lattice to the fused engine
  (ops/fused.py) first: it runs when the row budget sized from the
  level-2 survivor count (2x headroom, a power of two) and the level-3
  candidate census both fit the ceiling ``min(fused_m_cap_max, what the
  memory model admits)``, and says so in an ``engine_auto`` event; else
  the level engine runs.  On the pipelined ingest the pair program's
  count and census make that choice; on the one-call path a pre-pass
  over the packed bitmap does.
- ``fused`` always makes the fused attempt; when its row budget
  overflows it retries at the overflowing level's true need up to the
  ceiling, and when the ceiling or ``fused_l_max`` stops it, the
  complete levels seed the level engine (a ``fused_fallback`` event).
- ``level`` counts each level k >= 3 with K1 (or K3).  Once a level
  k >= 4 seed has at most ``tail_fuse_rows`` rows (None: 65,536 on CUDA,
  off on the CPU), the remaining levels run as one tail fold
  (ops/fused.py ``tail_mine``, a ``tail_fuse`` event); a fold that
  overflows its budgets resumes per level from its last complete level.

How a level's counts reach the host (``_level_loop``): by default each
level reads only its survivor bitmask (one fetch per level, all its
chunks issued before it), the per-candidate counts stay on the device,
and one gather and one fetch after the loop resolve them
(``counts_resolve``); past ``pending_fetch_budget_bytes`` a mid-loop
drain compacts them (``counts_drain``), and a tail fold that ends the
mine gathers them inside its own program.  With ``checkpoint_prefix``
each completed level is written to ``<prefix>checkpoint.npz`` with its
counts, fetched eagerly, and ``set_resume_levels`` seeds a later mine
from such a checkpoint: the level loop restarts after its deepest level.
A resume or a checkpoint prefix skips the fused whole-loop engine, except
that ``engine="fused"`` with a checkpoint prefix mines in checkpointed
segments of ``checkpoint_every_levels`` levels.  A transient error that
an audited fetch's retries gave up on walks the cascade
(reliability/retry.py ``exhausted``): fused -> level, tail -> level,
vertical -> bitmap; an error raised anywhere else, a kernel's launch
included, propagates.

In a quorum domain (reliability/quorum.py) every engine choice honours
the domain's floors (the layout, the fused offer, the count reduction,
the exchange topology), synced at ``mine.start`` as each layout's mine
begins, and again before each level's dispatch after the ``level.<k>``
sync (the vertical loop hands its complete levels to the bitmap loop
when a peer left the vertical layout).  Checkpoints are written by the writer
rank only, stamped with the domain's fence.  A file domain's weight
totals are cross-checked across its ranks once per mine
(``mine.wstotals``), and a sharded ingest's totals cross over the
domain's transport.  With elastic continuation on, counts are read
eagerly, and a lost peer re-seeds the mine from its last complete
level under the next mesh epoch (:meth:`FastApriori._mine_elastic`).
"""

from __future__ import annotations

import dataclasses
import mmap
import time
from typing import Dict, FrozenSet, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from fastapriori_tpu_torch.config import ENGINES, MINE_ENGINES, MinerConfig
from fastapriori_tpu_torch.device import DeviceContext
from fastapriori_tpu_torch.errors import InputError
from fastapriori_tpu_torch.models.candidates import (
    concat_blocks,
    gen_candidates_stream,
)
from fastapriori_tpu_torch.ops.bitmap import (
    build_bitmap,
    build_bitmap_csr,
    build_packed_bitmap_csr,
    next_pow2,
    pad_axis,
    unpack_bitmap,
    weight_digits,
)
from fastapriori_tpu_torch.ops.count import (
    TRI_F_CAP,
    _pair_triangles,
    dense_psum,
    frequent_pair_mask,
    heavy_pair_correction,
    local_level_gather,
    local_pair_counts,
    local_sparse_psum,
    sparse_psum_bytes,
    sparse_stage_bytes,
    sparse_union_cap,
    survivor_bits,
)
from fastapriori_tpu_torch.ops.fused import (
    decode_level_matrices,
    make_fused_miner,
    make_pair_counter,
    make_tail_miner,
    tail_slot_caps,
    unpack_fused_result,
    unpack_tail_result,
)
from fastapriori_tpu_torch.obs import trace
from fastapriori_tpu_torch.parallel import hier, mesh
from fastapriori_tpu_torch.ops.level_kernel import (
    level_counts,
    level_counts_plain,
)
from fastapriori_tpu_torch.ops.vertical import (
    PAIR_TXN_CHUNK,
    build_tid_arena_csr,
    compress_arena,
    vertical_level_local,
    vertical_level_word_ops,
    vertical_member_bytes,
    vertical_pair_local,
    weight_bit_planes,
)
from fastapriori_tpu_torch.ops.vertical_kernel import (
    lane_plane_mask,
    vertical_counts_plain,
)
from fastapriori_tpu_torch.preprocess import (
    CompressedData,
    ingest_thread_count,
    native_choice,
    preprocess,
    preprocess_file,
    preprocess_file_sharded,
)
from fastapriori_tpu_torch.reliability import (
    failpoints,
    ledger,
    quorum,
    retry,
    watchdog,
)
from fastapriori_tpu_torch.utils.env import env_choice, env_int
from fastapriori_tpu_torch.utils.logging import MetricsLogger

Levels = List[Tuple[np.ndarray, np.ndarray]]
ItemsetWithCount = Tuple[FrozenSet[int], int]

# Heavy-row remainder bounds: above either, the engine runs every weight
# digit through K1 instead (the remainder arrays would no longer be tiny).
HEAVY_SPLIT_CAP = 4096
HEAVY_SPLIT_BYTES = 16 << 20


class _MineEngineClamp(RuntimeError):
    """A level-boundary adoption walked ``mine_engine`` vertical ->
    bitmap while this rank was in the vertical loop: carries the
    complete levels up to :meth:`FastApriori._mine_vertical_safe`, which
    re-seeds the bitmap loop from that boundary.  ``ABORTED`` keeps it a
    transient, as in the JAX package."""

    def __init__(self, levels: Levels, k: int):
        self.levels = levels
        self.k = k
        super().__init__(f"ABORTED: mine_engine clamped vertical->bitmap at "
                         f"level {k} by quorum consensus")


def resolve_engine(engine: str) -> str:
    if engine not in ENGINES:
        raise InputError(
            f"unrecognized engine {engine!r}: use one of {'/'.join(ENGINES)}"
        )
    return engine


def weight_digit_count(max_weight: int) -> int:
    """Base-128 digits of the largest weight."""
    n = 1
    while 128**n <= max_weight:
        n += 1
    return n


def fused_bytes(cfg: MinerConfig, t_pad: int, f_pad: int, n_chunks: int,
                unpacked_resident: bool = False,
                tail_chunked: bool = False):
    """The port's device-byte model of ops/fused.py: ``(fixed, at)`` with
    ``fixed`` the bytes that do not grow with the row budget and ``at(m)``
    the ones that do, assuming the big intermediates coexist (``t_pad``:
    one shard's rows).

    - fixed: the bitmap (unpacked int8, or packed with one chunk
      unpacked), the raw weights, one digit's weighted chunk and its
      transpose, and level 2's ``[F, F]`` counts, part and mask;
    - candidates: ``D = S Sᵀ`` int32 and its bool ``E`` (5·m², or a
      512 MiB-capped row block when the tail fold chunks them);
    - ``[m, F]`` tensors: S, its transpose, the next S, rowmax's int64
      operand, the votes, the masks, the count accumulator and one
      digit's part (28·m·F);
    - per chunk: the int32 membership ``[m, t_c]`` and its bool test
      (5·t_c·m); the packed output (3·l_max + 1)·4·m."""
    t_c = t_pad // max(n_chunks, 1)
    if unpacked_resident:
        fixed = t_pad * f_pad + 4 * t_pad
    else:
        fixed = t_pad * f_pad // 8 + 4 * t_pad + 2 * t_c * f_pad
    fixed += 3 * t_c * f_pad + 9 * f_pad * f_pad

    def at(m: int) -> int:
        cand = 5 * m * m
        if tail_chunked:
            cand = min(cand, 5 * ((512 << 20) // 8))
        return (cand + 28 * m * f_pad + 5 * t_c * m
                + (3 * cfg.fused_l_max + 1) * m * 4)

    return fixed, at


def fused_card_bytes(cfg: MinerConfig, ctx: DeviceContext, t_pad: int,
                     f_pad: int, n_chunks: int,
                     unpacked_resident: bool = False,
                     tail_chunked: bool = False):
    """:func:`fused_bytes` on the busiest device of the mesh: each
    transaction shard holds its own rows and intermediates, and the
    shards that share a device add up there."""
    k = ctx.mesh.txn_shards_per_device()
    fixed, at = fused_bytes(cfg, t_pad // ctx.txn_shards, f_pad, n_chunks,
                            unpacked_resident, tail_chunked)
    return k * fixed, lambda m: k * at(m)


def fused_m_cap_memory_limit(
    cfg: MinerConfig,
    ctx: DeviceContext,
    t_pad: int,
    f_pad: int,
    n_chunks: int,
    unpacked_resident: bool = False,
    cap: Optional[int] = None,
    tail_chunked: bool = False,
) -> int:
    """The largest power-of-two row budget whose fused loop fits the
    memory budget under :func:`fused_card_bytes` (the reference's
    ``_fused_m_cap_memory_limit`` over the port's own intermediates):
    ``fused_hbm_budget_bytes``, or ``fused_hbm_fraction`` of the device's
    memory.  0 when even the floor budget ``next_pow2(fused_l_max + 2)``
    does not fit.  ``cap`` bounds the search (default
    ``fused_m_cap_max``; the tail fold passes its own need)."""
    budget = cfg.fused_hbm_budget_bytes
    if budget is None:
        budget = int(cfg.fused_hbm_fraction * ctx.memory_bytes)
    fixed, at = fused_card_bytes(cfg, ctx, t_pad, f_pad, n_chunks,
                                 unpacked_resident, tail_chunked)
    if cap is None:
        cap = cfg.fused_m_cap_max
    m = next_pow2(cfg.fused_l_max + 2)
    if fixed + at(m) > budget:
        return 0
    while 2 * m <= cap and fixed + at(2 * m) <= budget:
        m *= 2
    return m


def has_csr(data: CompressedData) -> bool:
    """The baskets are there as CSR (the vertical engine builds its arena
    from them)."""
    return (
        data.total_count == 0
        or len(data.basket_offsets) == data.total_count + 1
    )


def density_from_tables(n_raw: int, num_items: int, occ_total: float) -> float:
    """Frequent-item occurrence mass over the full ``T × F`` bitmap: the
    fraction of bitmap cells the pair Gram multiplies that are set (the
    JAX package's ``_density_from_tables``)."""
    if num_items <= 0 or n_raw <= 0:
        return 1.0
    return float(occ_total) / (float(n_raw) * num_items)


def split_weights(
    weights: np.ndarray,
    t_pad: int,
    indices: np.ndarray,
    offsets: np.ndarray,
    num_items: int,
    item_tile: int,
    heavy_pre: Optional[List[np.ndarray]] = None,
):
    """Single-low-digit weight split (reference ``_split_weights``):
    every row runs the kernels with ``w % 128`` and the exact remainder
    ``w - w % 128`` of the rows with multiplicity >= 128 rides a small
    heavy-row bitmap.  Returns ``(w_digits int8[D, T_pad], scales,
    heavy_b | None, heavy_w | None)``; heavy None = every digit goes
    through the kernels (no heavy rows, or too many).

    ``heavy_pre``: the heavy rows' baskets, pulled out in the pipelined
    ingest's block callback when no global CSR is kept
    (``retain_csr=False``), in the order ``np.flatnonzero(weights >=
    128)`` gives."""
    heavy_idx = np.flatnonzero(weights >= 128)
    f_pad = pad_axis(num_items + 1, item_tile)
    if (
        heavy_idx.size == 0
        or heavy_idx.size > HEAVY_SPLIT_CAP
        or heavy_idx.size * f_pad > HEAVY_SPLIT_BYTES
    ):
        w_digits, scales = weight_digits(weights, t_pad)
        return w_digits, scales, None, None
    w_digits, scales = weight_digits(
        (weights % 128).astype(np.int32), t_pad
    )
    if heavy_pre is not None:
        if len(heavy_pre) != heavy_idx.size:
            raise ValueError(f"{len(heavy_pre)} heavy baskets for "
                             f"{heavy_idx.size} heavy rows")
        baskets = heavy_pre
    else:
        baskets = [indices[offsets[i] : offsets[i + 1]] for i in heavy_idx]
    heavy_b = build_bitmap(baskets, num_items, 8, item_tile)
    heavy_w = np.zeros(heavy_b.shape[0], dtype=np.int32)
    heavy_w[: heavy_idx.size] = weights[heavy_idx] - (weights[heavy_idx] % 128)
    return w_digits, scales, heavy_b, heavy_w


def txn_multiple(config: MinerConfig, n_chunks: int, shards: int = 1) -> int:
    """Padding multiple of the bitmap's transaction axis: ``shards``
    equal blocks of whole chunks (the level-3 fold and the tail fold
    count chunk by chunk; the reference's ``_txn_multiple`` times the
    transaction shards, without its TPU tile alignment)."""
    return max(config.txn_tile, 32) * n_chunks * shards


def empty_compressed(
    n_raw: int, min_count: int, freq_items, item_to_rank, item_counts
) -> CompressedData:
    """The global tables with no baskets (fewer than two frequent items,
    or an ingest with no block)."""
    return CompressedData(
        n_raw=n_raw,
        min_count=min_count,
        freq_items=freq_items,
        item_to_rank=item_to_rank,
        item_counts=item_counts,
        basket_indices=np.empty(0, np.int32),
        basket_offsets=np.zeros(1, np.int64),
        weights=np.empty(0, np.int32),
    )


def concat_block_csr(blocks):
    """Block-order concatenation of per-block ``(indices, offsets,
    weights)`` CSRs into one (each block's ``offsets[0] == 0``).
    Identical baskets of two blocks stay two weighted rows."""
    w_np = np.concatenate([bw for _, _, bw in blocks])
    indices = np.concatenate([bi for bi, _, _ in blocks])
    offs = [np.zeros(1, dtype=np.int64)]
    base = 0
    for _, bo, _ in blocks:
        offs.append(bo[1:].astype(np.int64) + base)
        base += int(bo[-1])
    return indices, np.concatenate(offs), w_np


def level_chunks(
    level: np.ndarray,
    x_idx: np.ndarray,
    ys: np.ndarray,
    f_pad: int,
    config: MinerConfig,
) -> Iterator[Tuple[np.ndarray, np.ndarray, slice]]:
    """Cut one level's candidates into K1 or K3 launches, in global
    order: yields ``(prefix_cols int32[P_cap, s], cand_idx int64[n], sl)``
    where candidates ``sl`` are counted at flat positions
    ``row * f_pad + y`` of the launch's [P_cap, F_pad] count space, in
    whole runs per prefix row (``row`` does not decrease).  A launch takes
    at most ``level_prefix_cap`` prefixes and
    ``max(level_cand_cap, f_pad)`` candidates; P_cap is the level's prefix
    count in a power-of-two bucket, padded rows pointing at the all-zero
    column (the reference's ``_count_level`` at one cand shard).  P_cap is
    also the largest power of two with ``P_cap * f_pad < 2^31``, so every
    flat position fits the kernels' int32 candidate indexes."""
    s = level.shape[1]
    zcol = f_pad - 1
    uniq_x, run_start = np.unique(x_idx, return_index=True)
    run_end = np.concatenate([run_start[1:], [x_idx.size]])
    p_cap = min(
        max(next_pow2(uniq_x.size), config.min_prefix_bucket),
        config.level_prefix_cap,
        1 << (((2**31 - 1) // f_pad).bit_length() - 1),
    )
    c_bound = max(config.level_cand_cap, f_pad)
    start = 0
    while start < uniq_x.size:
        hi = min(start + p_cap, uniq_x.size)
        base = int(run_start[start])
        end = start + max(
            int(np.searchsorted(run_end[start:hi] - base, c_bound,
                                side="right")),
            1,
        )
        n_c = int(run_end[end - 1]) - base
        prefix_cols = np.full((p_cap, s), zcol, dtype=np.int32)
        prefix_cols[: end - start] = level[uniq_x[start:end]]
        sl = slice(base, base + n_c)
        row = np.searchsorted(uniq_x, x_idx[sl]) - start
        yield prefix_cols, row.astype(np.int64) * f_pad + ys[sl], sl
        start = end


class FastApriori:
    """Mining engine; API mirrors the reference class and the JAX
    package's argument order (``FastApriori(min_support, num_devices,
    config, context)``; ``run``/``run_file`` return frozensets,
    ``run_file_raw`` the level matrices).  ``device`` (keyword):
    ``None``/``"cuda"`` (the default: InputError without a GPU) or
    ``"cpu"`` (every kernel wrapper runs its plain version).
    ``context``: a DeviceContext to share (it remembers grown pair
    budgets across runs); made from ``device`` when None."""

    def __init__(
        self,
        min_support: Optional[float] = None,
        num_devices: Optional[int] = None,
        config: Optional[MinerConfig] = None,
        context: Optional[DeviceContext] = None,
        *,
        device=None,
    ):
        self.config = (
            dataclasses.replace(config) if config is not None else MinerConfig()
        )
        if min_support is not None:
            self.config.min_support = min_support
        if num_devices is not None:
            self.config.num_devices = num_devices
        self.engine = resolve_engine(self.config.engine)
        self._device = device
        self.ctx = context if context is not None else self._new_context()
        # Degradation events (the ledger) go to this miner's metrics.
        self.metrics = MetricsLogger(
            enabled=self.config.log_metrics).bind_global_ledger()
        # Levels an interrupted run completed, consumed by the next mine.
        self._resume_levels: Optional[Levels] = None
        self._resume_meta: Optional[Dict[str, int]] = None
        self._resume_label = "checkpoint"
        # The exchanged per-shard weight totals of a sharded ingest, per
        # (t_pad, processes): one exchange per mine; and the one-shot
        # cross-check of a file domain's full replicas.
        self._wstotals_cache: Dict[tuple, np.ndarray] = {}
        self._wstotals_verified = False
        # The last checkpointed levels and meta, kept on every rank: an
        # elastic rejoin may make this rank the writer, which re-commits
        # them under the new fence.
        self._ckpt_stash: Optional[Tuple[Levels, Dict[str, int]]] = None
        # The complete levels of the mine in flight (the elastic arm
        # re-seeds from them).
        self._progress: Levels = []

    def _new_context(self) -> DeviceContext:
        return DeviceContext(self._device,
                             num_devices=self.config.num_devices,
                             cand_devices=self.config.cand_devices)

    @property
    def context(self) -> DeviceContext:
        return self.ctx

    # Fluent setters (FastApriori.scala:21-29).
    def set_min_support(self, min_support: float) -> "FastApriori":
        self.config.min_support = min_support
        return self

    def set_num_devices(self, num_devices: Optional[int]) -> "FastApriori":
        """A new mesh of ``num_devices`` shards on this miner's device."""
        self.config.num_devices = num_devices
        self.ctx = self._new_context()
        return self

    def run(
        self, transactions: Sequence[Sequence[str]]
    ) -> Tuple[List[ItemsetWithCount], Dict[str, int], List[str]]:
        """Full mining from tokenized lines (FastApriori.run, :31-44):
        ``(frequent itemsets with counts, item_to_rank, freq_items)``,
        levels >= 2 first, then the 1-itemsets with their raw occurrence
        counts (:41, :83)."""
        with trace.span("mine", source="transactions"):
            with self.metrics.timed("preprocess") as m:
                data = preprocess(transactions, self.config.min_support)
                m.update(n_raw=data.n_raw, min_count=data.min_count,
                         num_items=data.num_items,
                         total_count=data.total_count)
            freq_itemsets = self.mine_compressed(data)
        return freq_itemsets, data.item_to_rank, data.freq_items

    def run_file(
        self, d_path: str
    ) -> Tuple[List[ItemsetWithCount], Dict[str, int], List[str]]:
        """:meth:`run` from ``D.dat`` on disk, through the native ingest
        (:meth:`run_file_raw`)."""
        levels, data = self.run_file_raw(d_path)
        return (self._decode_levels(levels, data), data.item_to_rank,
                data.freq_items)

    def mine_compressed(
        self, data: CompressedData
    ) -> List[ItemsetWithCount]:
        """Levels >= 2 on the device, then the 1-itemsets, as
        frozensets."""
        return self._decode_levels(self.mine_levels_raw(data), data)

    def _decode_levels(
        self, levels: Levels, data: CompressedData
    ) -> List[ItemsetWithCount]:
        """The frozenset form of the level matrices plus the 1-itemsets
        (the CLI stays in matrix form and never pays this)."""
        with self.metrics.timed("decode") as m:
            out: List[ItemsetWithCount] = []
            for mat, cnts in levels:
                out.extend(zip(map(frozenset, mat.tolist()), cnts.tolist()))
            m.update(n=len(out))
        out.extend((frozenset((r,)), int(c))
                   for r, c in enumerate(data.item_counts))
        return out

    def set_resume_levels(
        self,
        levels: Levels,
        meta: Optional[Dict[str, int]] = None,
        label: str = "checkpoint",
    ) -> "FastApriori":
        """Seed the next mine with levels an interrupted run completed
        (``--resume-from`` a ``--checkpoint-every-level`` checkpoint,
        io/checkpoint.py): the level loop restarts after the deepest one.
        ``meta`` (``n_raw``, ``min_count``, ``num_items``) pins them to
        their dataset; a mismatch with the ingested data is an
        InputError."""
        self._resume_levels = levels
        self._resume_meta = meta
        self._resume_label = label
        return self

    def _take_resume(self, data: CompressedData) -> Optional[Levels]:
        """The resume levels, once: a later mine on this instance never
        grafts them again."""
        levels = self._resume_levels
        if not levels:
            return None
        meta, label = self._resume_meta, self._resume_label
        self._resume_levels = None
        self._resume_meta = None
        if meta is not None:
            from fastapriori_tpu_torch.io.checkpoint import check_meta

            check_meta(meta, n_raw=data.n_raw, min_count=data.min_count,
                       num_items=data.num_items, prefix=label)
        return list(levels)

    def _checkpoint_levels(self, levels: Levels,
                           data: CompressedData) -> None:
        """After a completed level: with ``checkpoint_prefix``, the
        writer (rank 0 of the world and the quorum domain's writer)
        atomically rewrites ``<prefix>checkpoint.npz`` and its manifest
        entry (a ``checkpoint`` metrics event), stamped with the domain's
        fence (a superseded writer raises ``StaleFenceError``); then the
        ``level.<k>`` failpoint, k the deepest level written, so a test
        can kill the run where the checkpoint exists and nothing after
        it does; then the domain's ``level.<k>`` sync, which adopts a
        peer's walks before the next level and finds a dead peer."""
        if not levels:
            return
        self._progress = list(levels)
        k = int(levels[-1][0].shape[1])
        prefix = self.config.checkpoint_prefix
        if prefix:
            meta = {"n_raw": data.n_raw, "min_count": data.min_count,
                    "num_items": data.num_items}
            self._ckpt_stash = (list(levels), meta)
            dom = quorum.active()
            if dom is not None:
                dom.add_rejoin_hook(self._recommit_checkpoint)
            if mesh.process_index() == 0 and quorum.is_writer():
                from fastapriori_tpu_torch.io.checkpoint import (
                    save_checkpoint,
                )

                with self.metrics.timed("checkpoint", levels=len(levels),
                                        k=k) as m:
                    fence = quorum.checkpoint_fence()
                    save_checkpoint(prefix, levels, dict(meta, fence=fence))
                    if fence:
                        m.update(fence=fence)
        failpoints.fire(f"level.{k}")
        quorum.sync(f"level.{k}")

    def _recommit_checkpoint(self) -> None:
        """The elastic rejoin's hook: the writer re-commits the last
        checkpointed levels under the re-derived fence, so no checkpoint
        is left at the old fence while later manifests carry the new
        one.  Local file I/O only: no failpoint, no sync."""
        stash = self._ckpt_stash
        prefix = self.config.checkpoint_prefix
        if stash is None or not prefix:
            return
        if mesh.process_index() != 0 or not quorum.is_writer():
            return
        from fastapriori_tpu_torch.io.checkpoint import save_checkpoint

        levels, meta = stash
        save_checkpoint(prefix, levels,
                        dict(meta, fence=quorum.checkpoint_fence()))

    def run_file_raw(self, d_path: str) -> Tuple[Levels, CompressedData]:
        """Mine ``D.dat``: returns the level matrices (k >= 2) and the
        preprocessed data (item tables, 1-itemset counts).  Under the
        pipelined ingest (the default) the data's rows are deduplicated
        per block, and with ``retain_csr=False`` it holds no basket
        CSR.  In a multi-process world: :meth:`run_file_sharded`."""
        if self.ctx.world > 1:
            # In a multi-process world each process ingests its own part.
            return self.run_file_sharded(d_path)
        # The mining root span: every metrics.timed section below
        # (preprocess, level, tail_fuse, fused_mine, counts_resolve,
        # checkpoint ...) nests under it.
        with trace.span("mine", path=d_path):
            return self._run_file_raw(d_path)

    def run_file_sharded(self, d_path: str) -> Tuple[Levels, CompressedData]:
        """Mining in a multi-process world (counterpart: the JAX package's
        ``run_file_sharded``): every process calls it; each ingests only
        its own byte range of ``D.dat`` (preprocess.py
        ``preprocess_file_sharded``) and places its own rows on its own
        shards, so the bulk data never crosses processes; the returned
        levels are the same on every process."""
        with trace.span("mine", path=d_path, sharded=True):
            with self.metrics.timed("preprocess", path=d_path) as m:
                data = preprocess_file_sharded(d_path,
                                               self.config.min_support)
                m.update(n_raw=data.n_raw, min_count=data.min_count,
                         num_items=data.num_items,
                         local_count=data.total_count,
                         global_count=data.shard.global_count,
                         native=True, pipelined=False, capture=False,
                         threads=1)
            return self.mine_levels_raw(data), data

    def _run_file_raw(self, d_path: str) -> Tuple[Levels, CompressedData]:
        # Parsed before the ingest, so a bad FA_INGEST_THREADS fails every
        # run.
        n_threads = ingest_thread_count(self.config.ingest_threads)
        remote = "://" in d_path
        if not remote and self._can_pipeline_ingest():
            return self._run_file_pipelined_capture(d_path, n_threads)
        with self.metrics.timed("preprocess", path=d_path) as m:
            # A local file always passes the native size gate; a remote
            # one is read through fsspec by the Python ingest.
            native, reason = native_choice(False if remote else None,
                                           1 << 62)
            data = preprocess_file(d_path, self.config.min_support,
                                   native=native)
            m.update(
                n_raw=data.n_raw,
                min_count=data.min_count,
                num_items=data.num_items,
                total_count=data.total_count,
                native=native,
                pipelined=False,
                capture=False,
                threads=1,
            )
            if not native:
                m.update(native_reason=reason)
        return self.mine_levels_raw(data), data

    def _can_pipeline_ingest(self) -> bool:
        """The pipelined capture ingest runs on a one-device mesh whenever
        the native library is available and ``ingest_pipeline_blocks >
        1`` (the reference's conditions; the port is one process and the
        caller checked the path is local).  A mesh of more than one shard
        takes the one-call ingest, as in the reference."""
        if (self.config.ingest_pipeline_blocks <= 1
                or self.ctx.n_devices != 1):
            return False
        return native_choice(None, 1 << 62)[0]

    def _pipeline_engine_probe(
        self, n_raw: int, num_items: int, occ_total: float
    ) -> str:
        """The layout from pass-1 tables alone, before any block arrives:
        the decision of :meth:`_mine_engine` (the CSR is always there
        on this path)."""
        req = self._requested_mine_engine()
        if req == "bitmap" or self._quorum_left_vertical(req):
            return "bitmap"
        if req == "vertical":
            return req
        cfg = self.config
        density = density_from_tables(n_raw, num_items, occ_total)
        if (
            num_items >= cfg.vertical_min_items
            and density <= cfg.vertical_density_max
        ):
            return "vertical"
        return "bitmap"

    def _emit_mine_engine(self, layout: str, requested: str, density: float,
                          **extra) -> None:
        self.metrics.emit(
            "mine_engine",
            engine=layout,
            requested=requested,
            density=round(density, 6),
            level_engine=self.engine,
            device=str(self.ctx.device),
            **extra,
        )

    def _upload_heavy(self, heavy_b, heavy_w):
        """The heavy-row remainder arrays on the device (None -> None:
        every weight digit goes through K1)."""
        if heavy_b is None:
            return None
        return self.ctx.upload_async(heavy_b), self.ctx.upload_async(heavy_w)

    @staticmethod
    def _heavy_stats(heavy_b, heavy_w) -> Tuple[int, int]:
        """(heavy rows, bytes uploaded for them)."""
        if heavy_b is None:
            return 0, 0
        return int(np.count_nonzero(heavy_w)), heavy_b.nbytes + heavy_w.nbytes

    def _assemble_blocks(self, blocks, multiple: int, f: int,
                         heavy_pre=None):
        """Host assembly of the per-block CSRs: concatenated weights, the
        weight digits (the single-low-digit split when heavy rows are
        few) and the global CSR.  ``heavy_pre`` (``retain_csr=False``):
        the blocks carry no item arrays, no global CSR is built, and the
        heavy rows' baskets come from the block callback."""
        total = sum(len(bw) for _, _, bw in blocks)
        t_pad = pad_axis(total, multiple)
        if heavy_pre is None:
            indices, offsets, w_np = concat_block_csr(blocks)
        else:
            w_np = np.concatenate([bw for _, _, bw in blocks])
            indices = np.empty(0, np.int32)
            offsets = np.zeros(1, np.int64)
        w_digits_np, scales, heavy_b, heavy_w = split_weights(
            w_np, t_pad, indices, offsets, f, self.config.item_tile,
            heavy_pre=heavy_pre,
        )
        return (total, t_pad, w_np, w_digits_np, scales, indices, offsets,
                heavy_b, heavy_w)

    @staticmethod
    def _device_concat_unpack(dev_blocks, total: int, t_pad: int,
                              f_pad: int) -> torch.Tensor:
        """The uploaded packed blocks concatenated on the device, zero
        rows to ``t_pad``, unpacked to the int8 bitmap."""
        parts = list(dev_blocks)
        if t_pad > total:
            parts.append(parts[0].new_zeros((t_pad - total, f_pad // 8)))
        return unpack_bitmap(torch.cat(parts))

    def _run_file_pipelined_capture(
        self, d_path: str, n_threads: int
    ) -> Tuple[Levels, CompressedData]:
        """Capture-replay pipelined ingest: one native call
        (native/loader.py ``preprocess_buffer_blocks``) runs pass 1 over
        ``n_threads`` segments, assigns ranks, fires ``on_pass1`` (the
        layout probe) and replays the blocks on ``n_threads`` threads;
        each block arrives through a callback on this thread, in block
        order, while the call runs.  On the bitmap layout the callback
        packs the block and submits its upload, so transfers run while
        the next block is compressed; on the vertical layout it keeps the
        block CSR for the arena build.

        The reference's re-tokenizing ``_run_file_pipelined`` serves only
        a native library that lacks the blocks entry point; the port's
        library always has it (native/loader.py
        ``has_preprocess_buffer_blocks``), so that path is not ported."""
        from fastapriori_tpu_torch.native.loader import (
            preprocess_buffer_blocks,
        )

        cfg = self.config
        ctx = self.ctx
        blocks: list = []
        heavy_pre: list = []
        dev_futures: list = []
        w_futures: list = []
        state = {"f_pad": None, "upload_bytes": 0, "pack_s": 0.0}
        req_engine = self._requested_mine_engine()
        engine_state = {"engine": "bitmap" if req_engine == "auto"
                        else req_engine}

        def on_pass1(n_raw_, min_count_, f_, counts_):
            engine_state["engine"] = self._pipeline_engine_probe(
                n_raw_, f_, float(counts_.sum())
            )

        def on_block(f_, offsets, items, weights):
            state.setdefault("t_first_block", time.perf_counter())
            if engine_state["engine"] == "vertical":
                # The arena build reads the CSR after the call; a
                # copy_items=False view dies with this callback.
                items_c = items if items.flags.writeable else items.copy()
                blocks.append((items_c, offsets, weights))
                return
            tp0 = time.perf_counter()
            pk, f_pad = build_packed_bitmap_csr(items, offsets, f_, 1,
                                                cfg.item_tile)
            state["pack_s"] += time.perf_counter() - tp0
            state["f_pad"] = f_pad
            state["upload_bytes"] += pk.nbytes + weights.nbytes
            dev_futures.append(uploader.submit(pk))
            # The raw weights go up too: the pair program counts with
            # them before the host has split them into digits.
            w_futures.append(uploader.submit(weights))
            if cfg.retain_csr:
                if not items.flags.writeable:
                    raise RuntimeError(
                        "retain_csr needs copy_items=True: a read-only "
                        "item view lives only inside its callback"
                    )
                blocks.append((items, offsets, weights))
                return
            # retain_csr=False: `items` is valid only now, so the heavy
            # rows' baskets are taken here (up to the split's cap: past
            # it every digit goes through K1 and they are not read).
            for i in np.flatnonzero(weights >= 128):
                if len(heavy_pre) > HEAVY_SPLIT_CAP:
                    break
                heavy_pre.append(items[offsets[i] : offsets[i + 1]].copy())
            blocks.append((None, offsets, weights))

        uploader = ctx.block_uploader()
        try:
            with self.metrics.timed("preprocess", path=d_path) as m:
                with open(d_path, "rb") as fh:
                    try:
                        buf = np.frombuffer(
                            mmap.mmap(fh.fileno(), 0,
                                      access=mmap.ACCESS_READ),
                            dtype=np.uint8,
                        )
                    except (ValueError, OSError):  # an empty file
                        buf = fh.read()
                t0 = time.perf_counter()
                n_raw, min_count, freq_items, item_counts = (
                    preprocess_buffer_blocks(
                        buf,
                        cfg.min_support,
                        max(cfg.ingest_pipeline_blocks, 1),
                        on_block,
                        n_threads=n_threads,
                        copy_items=cfg.retain_csr,
                        on_pass1=on_pass1 if req_engine == "auto" else None,
                    )
                )
                t1 = time.perf_counter()
                del buf
                item_to_rank = {t: r for r, t in enumerate(freq_items)}
                f = len(freq_items)
                t_first = state.get("t_first_block", t1)
                m.update(
                    n_raw=n_raw,
                    min_count=min_count,
                    num_items=f,
                    total_count=sum(len(bw) for _, _, bw in blocks),
                    native=True,
                    pipelined=True,
                    capture=True,
                    threads=n_threads,
                    engine=engine_state["engine"],
                    pass1_s=round(t_first - t0, 3),
                    pass2_s=round(t1 - t_first, 3),
                    pack_s=round(state["pack_s"], 3),
                )
            if f < 2 or not blocks:
                return [], empty_compressed(
                    n_raw, min_count, freq_items, item_to_rank, item_counts
                )
            density = density_from_tables(n_raw, f,
                                          float(np.sum(item_counts)))
            if engine_state["engine"] == "vertical":
                indices, offsets, w_np = concat_block_csr(blocks)
                data = CompressedData(
                    n_raw=n_raw,
                    min_count=min_count,
                    freq_items=freq_items,
                    item_to_rank=item_to_rank,
                    item_counts=item_counts,
                    basket_indices=indices,
                    basket_offsets=offsets,
                    weights=w_np,
                )
                self._emit_mine_engine("vertical", req_engine, density,
                                       probe="pass1")
                return self._mine_elastic(data, vertical=True), data
            self._emit_mine_engine("bitmap", req_engine, density,
                                   probe="pass1")
            n_chunks = max(1, -(-n_raw // cfg.level_txn_chunk))
            multiple = txn_multiple(cfg, n_chunks)
            with self.metrics.timed("bitmap_build") as m:
                f_pad = state["f_pad"]
                pair_pre = None
                # The pair program rides the ingest: issued now, it runs
                # on the device while the host assembles the weights
                # below.  Its float32 Gram is exact while every count <
                # 2^24, and its packed output's int32 flat indexes need
                # F_pad² < 2^31.
                if n_raw < 2**24 and f_pad * f_pad < 2**31:
                    t_pad_pre = pad_axis(sum(len(bw) for _, _, bw in blocks),
                                         multiple)
                    cap_key = ("pair_cap", t_pad_pre, f, min_count)
                    cap = max(cfg.pair_cap, ctx.pair_cap_hint(cap_key) or 0)
                    census = f_pad <= TRI_F_CAP
                    l3_keys = (
                        ("pair_l3p", t_pad_pre, f, min_count),
                        ("pair_l3c", t_pad_pre, f, min_count),
                    )
                    l3 = None
                    if census and cfg.pair_l3_rows > 0:
                        p3 = min(max(cfg.pair_l3_rows,
                                     ctx.pair_cap_hint(l3_keys[0]) or 0),
                                 cap)
                        cap3 = max(cfg.pair_l3_cap,
                                   ctx.pair_cap_hint(l3_keys[1]) or 0)
                        l3 = (p3, cap3, n_chunks)
                    t_issue = time.perf_counter()
                    with ctx.sync_free():
                        dev_blocks = uploader.gather(dev_futures)
                        dev_ws = uploader.gather(w_futures)
                        t_landed = time.perf_counter()
                        start = ctx.timing_event()
                        bitmap, packed, counts_dev = ctx.ingest_pair_miner(
                            dev_blocks, dev_ws, t_pad_pre, min_count, f, cap,
                            census, l3,
                        )
                        pair_pre = {
                            "events": (start, ctx.timing_event()),
                            "fetch": ctx.fetch_async(packed, "pair_pre"),
                            "counts_dev": counts_dev,
                            "cap": cap,
                            "cap_key": cap_key,
                            "l3": l3,
                            "l3_keys": l3_keys,
                        }
                    t_issued = time.perf_counter()
                    m.update(
                        upload_wait_ms=round((t_landed - t_issue) * 1e3, 3),
                        pair_issue_ms=round((t_issued - t_landed) * 1e3, 3),
                    )
                t_asm = time.perf_counter()
                (
                    total, t_pad, w_np, w_digits_np, scales, indices,
                    offsets, heavy_b, heavy_w,
                ) = self._assemble_blocks(
                    blocks, multiple, f,
                    heavy_pre=None if cfg.retain_csr else heavy_pre,
                )
                if pair_pre is None:
                    bitmap = self._device_concat_unpack(
                        uploader.gather(dev_futures), total, t_pad, f_pad
                    )
                    # The raw weights went up for the pair program only.
                    state["upload_bytes"] -= sum(
                        bw.nbytes for _, _, bw in blocks
                    )
                w_digits = ctx.upload_async(w_digits_np)
                heavy = self._upload_heavy(heavy_b, heavy_w)
                heavy_rows, heavy_bytes = self._heavy_stats(heavy_b, heavy_w)
                m.update(
                    assemble_ms=round((time.perf_counter() - t_asm) * 1e3,
                                      3),
                    shape=[t_pad, f_pad],
                    digits=len(scales),
                    blocks=len(blocks),
                    heavy_rows=heavy_rows,
                    pair_overlapped=pair_pre is not None,
                    upload_bytes=state["upload_bytes"] + w_digits_np.nbytes
                    + heavy_bytes,
                )
        finally:
            uploader.close()

        data = CompressedData(
            n_raw=n_raw,
            min_count=min_count,
            freq_items=freq_items,
            item_to_rank=item_to_rank,
            item_counts=item_counts,
            basket_indices=indices,
            basket_offsets=offsets,
            weights=w_np,
        )
        levels = self._mine_elastic(
            data,
            preupload=(bitmap, w_digits, scales, n_chunks, t_pad, f_pad,
                       heavy),
            try_fused=True, pair_pre=pair_pre,
        )
        return levels, data

    def mine_levels_raw(self, data: CompressedData) -> Levels:
        """Levels >= 2 as lex-sorted member matrices with counts."""
        if self.ctx.world > 1 and not self._multi(data):
            raise InputError(
                "a multi-process world mines each process's shard of a "
                "sharded ingest (run_file_sharded); this data holds every "
                "row, which each process would count again")
        total = (data.shard.global_count if data.shard is not None
                 else data.total_count)
        if data.num_items < 2 or total == 0:
            return []
        layout, requested, density = self._mine_engine(data)
        self._emit_mine_engine(layout, requested, density)
        if layout == "vertical":
            return self._mine_elastic(data, vertical=True)
        if not has_csr(data):
            # The packed upload and the bitmap build read the CSR: mining
            # an empty one would return an empty lattice.
            raise InputError(
                "CompressedData carries no basket CSR (produced by the "
                "pipelined capture ingest with retain_csr=False); "
                "re-ingest with retain_csr=True to mine it through this "
                "path"
            )
        # A resume or a checkpoint prefix skips the whole-lattice fused
        # loop: it has no mid-points to seed or checkpoint (engine "fused"
        # under a checkpoint prefix mines in segments in the level loop).
        if (self.engine in ("fused", "auto")
                and not (self._resume_levels or self.config.checkpoint_prefix)
                and quorum.stage_allowed("engine", "fused")):
            reason = "row_budget_or_bound"
            try:
                levels, partial = self._mine_fused(
                    data, auto=self.engine == "auto")
            except Exception as exc:
                # A transient at the fused fetch that outlasted its
                # retries: the level engine (with its own fetch budgets).
                if not retry.exhausted(exc):
                    raise
                levels, partial, reason = None, None, "transient_exhausted"
            if levels is not None:
                return levels
            # Row budget, level bound, the auto choice or a transient:
            # the level engine, resumed from the salvaged complete levels.
            self._fused_fallback(partial, reason)
            return self._mine_elastic(data, resume=partial or None)
        return self._mine_elastic(data)

    def _mine_elastic(self, data: CompressedData, vertical: bool = False,
                      **kw) -> Levels:
        """The layout's mine (:meth:`_mine_vertical_safe`, else
        :meth:`_mine_levels` with ``kw``) inside the elastic arm: on a
        ``PeerLost`` or ``MeshEpochAbort`` the survivors meet again under
        the next mesh epoch (reliability/quorum.py ``elastic_rejoin``,
        which re-raises, classified, when continuation is off or spent)
        and the mine starts again from the last complete level
        boundary: the weight totals and their cross-check are re-derived
        for the survivors, the domain's floors re-read at
        ``mine.start``, and the fused offer and the ingest's pair
        program (the aborted epoch's work) are not used again."""
        saved = (self._resume_levels, self._resume_meta, self._resume_label)
        self._progress = []
        while True:
            try:
                if vertical:
                    return self._mine_vertical_safe(data)
                return self._mine_levels(data, **kw)
            except (quorum.PeerLost, quorum.MeshEpochAbort) as exc:
                quorum.elastic_rejoin(exc)
                from fastapriori_tpu_torch.obs import flight

                self._wstotals_cache.clear()
                self._wstotals_verified = False
                done = [lv for lv in self._progress if lv[1] is not None]
                self._progress = []
                if done:
                    self.set_resume_levels(done, None, "elastic")
                else:
                    (self._resume_levels, self._resume_meta,
                     self._resume_label) = saved
                kw = {"preupload": kw.get("preupload")}
                flight.note(
                    "mesh_epoch_reseed", mesh_epoch=quorum.mesh_epoch(),
                    members=quorum.mesh_members(),
                    resume_from_k=(int(done[-1][0].shape[1]) if done
                                   else None),
                    levels_kept=len(done))

    _COUNT_REDUCE = ("auto", "dense", "sparse")

    def _count_reduce_engine(self) -> Tuple[str, str]:
        """``(engine, requested)`` of the count reduction:
        ``FA_COUNT_REDUCE`` over ``config.count_reduce``, both strictly
        parsed.  Sparse where the JAX package defines it, on two or more
        transaction shards of a 1-D mesh (auto takes it there, with a
        ``count_reduce_engine`` ledger event); elsewhere dense: auto and
        dense quietly, a forced sparse with a ``count_reduce_fallback``
        event and a ``count_reduce`` cascade walk (reason
        ``one_txn_shard`` or ``cand_mesh``).  Resolved where the JAX
        package resolves it: once per level loop and once per fused
        attempt.  ``FA_COUNT_SPARSE_CAP`` and ``FA_EXCHANGE_GROUPS`` are
        parsed here too, on every mine, so a typo fails a one-shard run
        as well."""
        env_int("FA_COUNT_SPARSE_CAP", 0, minimum=0)
        env_int("FA_EXCHANGE_GROUPS", -1, minimum=0)
        req = env_choice("FA_COUNT_REDUCE", self._COUNT_REDUCE)
        if req is None:
            req = self.config.count_reduce
            if req not in self._COUNT_REDUCE:
                raise InputError(
                    f"unrecognized MinerConfig.count_reduce value {req!r}: "
                    f"use one of {'/'.join(self._COUNT_REDUCE)}"
                )
        if req == "dense":
            return "dense", req
        reason = None
        if self.ctx.txn_shards < 2:
            reason = "one_txn_shard"
        elif self.ctx.cand_shards != 1:
            reason = "cand_mesh"
        elif not quorum.stage_allowed("count_reduce", "sparse"):
            # A peer already walked the reduction: start at the agreed
            # position, so this rank never issues the sparse collectives.
            reason = "quorum"
        if reason is not None:
            if req == "sparse":
                ledger.record("count_reduce_fallback", once_key=reason,
                              reason=reason)
                watchdog.downgrade("count_reduce", "sparse", "dense",
                                   reason=reason)
            return "dense", req
        ledger.record("count_reduce_engine", once_key="sparse",
                      engine="sparse")
        return "sparse", req

    def _sparse_cap(self, n_valid: int, hint_key=None) -> int:
        """Union-compaction slots of one sparse reduction (ops/count.py
        ``sparse_union_cap``) with the ``FA_COUNT_SPARSE_CAP`` /
        ``count_sparse_cap`` override and, under ``hint_key``, the grown
        budget an earlier overflow of this profile recorded."""
        override = (env_int("FA_COUNT_SPARSE_CAP", 0, minimum=0)
                    or self.config.count_sparse_cap)
        cap = sparse_union_cap(n_valid, override)
        if hint_key is not None:
            hint = self.ctx.pair_cap_hint(hint_key)
            if hint:
                cap = min(max(cap, hint), next_pow2(max(n_valid, 8)))
        return cap

    def _sparse_thresholds(self, data: CompressedData, t_pad: int,
                           heavy: bool) -> List[int]:
        """Each transaction shard's local-prune threshold, the weighted
        pigeonhole ``max(1, ceil(min_count · W_s / W))`` over the shards'
        weight totals W_s: a candidate below every shard's threshold sums
        below min_count.  ``heavy``: the weight split is on (the kernels
        count ``w % 128`` and shard 0 adds the heavy remainder), so shard
        0's total carries the remainder.  In a multi-process world the
        totals of every shard come from :meth:`_shard_weight_totals` and
        this process's shards' thresholds are returned."""
        s = self.ctx.txn_shards
        if self._multi(data):
            per = self._shard_weight_totals(data, t_pad)
            total = int(per.sum())
            thr = (np.maximum(1, -(-(int(data.min_count) * per) // total))
                   if total > 0 else np.ones(s, np.int64))
            loc = self.ctx.local_txn_shards
            r = self.ctx.mesh.rank
            return [int(x) for x in thr[r * loc : (r + 1) * loc]]
        w = np.zeros(t_pad, dtype=np.int64)
        w[: data.total_count] = data.weights
        per = w.reshape(s, -1).sum(axis=1)
        # Full replicas in a file domain: the totals shape the sparse
        # collectives, so ranks that ingested differently must meet a
        # classified error here, not silently divergent counts.
        self._verify_wstotals([int(v) for v in per])
        if heavy:
            low = w % 128
            per = low.reshape(s, -1).sum(axis=1)
            per[0] += int((w - low).sum())
        total = int(per.sum())
        if total <= 0:
            return [1] * s
        thr = -(-(int(data.min_count) * per) // total)
        return [int(x) for x in np.maximum(1, thr)]

    @staticmethod
    def _multi(data: CompressedData) -> bool:
        """The data is one process's shard of a multi-process ingest."""
        return data.shard is not None and data.shard.num_processes > 1

    def _wstotals_available(self, data: CompressedData) -> bool:
        """Whether the per-shard weight totals the sparse thresholds need
        can be had (the JAX package's gate): always in one process, and
        for a sharded ingest whenever the world spans its processes (the
        one exchange of :meth:`_shard_weight_totals`)."""
        shard = data.shard
        if shard is None or shard.num_processes == 1:
            return True
        return self.ctx.world == shard.num_processes

    def _local_pad(self, data: CompressedData, multiple: int) -> int:
        """A sharded ingest's rows per process: the most any process
        holds, in whole ``multiple``s, the same on every process."""
        return max(pad_axis(c, multiple) for c in data.shard.local_counts)

    def _shard_weight_totals(self, data: CompressedData,
                             t_pad: int) -> np.ndarray:
        """Every global shard's weight total W_s (counterpart: the JAX
        package's ``_shard_weight_totals``): each process sums its own
        shards' rows and one ``allgather_bytes`` exchange concatenates
        them in process order, which is shard order (the mesh is
        process-major).  Once per mine and padding."""
        shard = data.shard
        n_proc = shard.num_processes
        key = (t_pad, n_proc)
        if key in self._wstotals_cache:
            return self._wstotals_cache[key]
        if not self._wstotals_available(data):
            raise InputError(
                f"a {n_proc}-process sharded ingest needs a world of "
                f"{n_proc} processes for its weight totals; this one has "
                f"{self.ctx.world}")
        local_pad = t_pad // n_proc
        w = np.zeros(local_pad, dtype=np.int64)
        w[: data.total_count] = data.weights
        per_local = w.reshape(self.ctx.local_txn_shards, -1).sum(axis=1)
        # Over the quorum domain's transport when one spans the ingest's
        # processes, else the sharded ingest's own channel.
        gathered = quorum.exchange("mine.wstotals", per_local.tolist())
        if gathered is not None and len(gathered) == n_proc:
            per = np.concatenate([np.asarray(gathered[r], dtype=np.int64)
                                  for r in range(n_proc)])
        else:
            blobs = mesh.allgather_bytes(per_local.astype("<i8").tobytes())
            per = np.concatenate([np.frombuffer(b, dtype="<i8")
                                  for b in blobs])
        if per.size != self.ctx.txn_shards:
            raise InputError(
                f"the weight-total exchange returned {per.size} shard "
                f"totals for a {self.ctx.txn_shards}-shard mesh "
                f"({n_proc} ingest processes)")
        ledger.record("wstotals_exchange", once_key="mine", procs=n_proc,
                      shards=int(per.size))
        self._wstotals_cache[key] = per
        return per

    def _verify_wstotals(self, mine: List[int]) -> None:
        """The one-shot cross-check of a file domain's full replicas
        (every rank mines the whole corpus): the ranks exchange their raw
        per-shard weight totals ``mine`` at ``mine.wstotals`` and a
        mismatch is a ``MeshDivergence`` naming both ranks, since prune
        thresholds from divergent ingests never issue matching
        collectives.  The payload is the raw totals (never the heavy
        split), so every engine path posts the same one.  No-op without
        a file domain of more than one rank (a torch transport's
        collective count admits no optional exchange)."""
        dom = quorum.active()
        if (self._wstotals_verified or dom is None or dom.nprocs == 1
                or not isinstance(dom.transport, quorum.FileTransport)):
            return
        self._wstotals_verified = True
        gathered = dom.exchange("mine.wstotals", mine)
        for rank in sorted(gathered):
            if rank != dom.rank and gathered[rank] != mine:
                raise quorum.MeshDivergence(
                    "ABORTED: mesh divergence at 'mine.wstotals': rank "
                    f"{dom.rank} derived shard weight totals {mine} while "
                    f"rank {rank} derived {gathered[rank]} — sparse prune "
                    "thresholds from divergent ingests can never issue "
                    "matching collectives")
        ledger.record("wstotals_exchange", once_key="verify",
                      procs=dom.nprocs, verified=True)

    def _exchange_spec(self):
        """The two-level topology of this mine's sparse reductions
        (parallel/hier.py ``resolve_active_spec``: ``FA_EXCHANGE_GROUPS``
        over ``config.exchange_groups``), named on the ledger
        (``exchange_engine``); the quorum domain's ``exchange`` floor
        clamps it to flat (an ``exchange_fallback`` event when the
        topology would have been two-level)."""
        spec = hier.resolve_active_spec(self.ctx.txn_shards, self.config,
                                        n_procs=self.ctx.world,
                                        unclamped=True)
        if spec is not None and not quorum.stage_allowed("exchange", "hier"):
            ledger.record("exchange_fallback", once_key="quorum",
                          reason="quorum")
            spec = None
        ledger.record(
            "exchange_engine", once_key=f"spec:{spec}",
            engine="hier" if spec is not None else "flat",
            groups=spec[0] if spec is not None else 1,
            per_group=spec[1] if spec is not None else self.ctx.txn_shards,
        )
        return spec

    def _reduce_setup(self, data: CompressedData, t_pad: int,
                      heavy: bool) -> dict:
        """The level loop's count reduction, resolved once per mine before
        level 2: ``{"engine", "thr"}`` (a dict the loop updates when a
        cascade walk changes it), the exchange topology installed on the
        context, and one ``count_reduce`` metrics event."""
        count_reduce, requested = self._count_reduce_engine()
        self.ctx.exchange_spec = (
            self._exchange_spec() if count_reduce == "sparse" else None)
        self.metrics.emit("count_reduce", engine=count_reduce,
                          requested=requested)
        return {"engine": count_reduce,
                "thr": (self._sparse_thresholds(data, t_pad, heavy)
                        if count_reduce == "sparse" else None)}

    def _reduce_info(self, n_valid: int, sp_cap: Optional[int]) -> dict:
        """The payload fields of one reduction over ``n_valid`` candidate
        slots (the JAX package's ``_reduce_info``): dense, the 4·n psum;
        sparse, ops/count.py's models, with the exchange's tiers."""
        if sp_cap is None:
            return {"reduce": "dense", "psum_bytes": 4 * n_valid,
                    "gather_bytes": 0}
        spec = self.ctx.exchange_spec
        s = self.ctx.txn_shards
        gather_b, psum_b = sparse_psum_bytes(n_valid, sp_cap, s, spec)
        intra_b, inter_b = sparse_stage_bytes(n_valid, sp_cap, s, spec)
        info = {"reduce": "sparse", "psum_bytes": psum_b,
                "gather_bytes": gather_b,
                "exchange": "hier" if spec is not None else "flat",
                "intra_bytes": intra_b, "inter_bytes": inter_b}
        if spec is not None:
            info["exchange_groups"] = spec[0]
        return info

    def _sparse_walk(self, exc: Exception, site: str, red: dict,
                     **fields) -> None:
        """A transient that outlasted a sparse reduction's audited fetch:
        walk ``exchange`` hier -> flat (when two-level) and
        ``count_reduce`` sparse -> dense.  The caller recounts dense."""
        if self.ctx.exchange_spec is not None:
            watchdog.downgrade("exchange", "hier", "flat",
                               reason="transient_exhausted", site=site,
                               **fields)
            self.ctx.exchange_spec = None
        watchdog.downgrade("count_reduce", "sparse", "dense",
                           reason="transient_exhausted", site=site,
                           error=f"{type(exc).__name__}: {exc}"[:200],
                           **fields)

    def _vertical_chunk(self, c_cap: int) -> int:
        """Candidates per step of K3's plain version: ``FA_VERTICAL_CHUNK``
        (strict; unset or 0 = ``config.vertical_cand_chunk``) in a
        power-of-two bucket, at most next_pow2(c_cap), then halved until
        it divides the launch's candidate budget ``c_cap`` (the JAX
        package's scan reshape needs an exact divisor)."""
        chunk = (env_int("FA_VERTICAL_CHUNK", 0, minimum=0)
                 or self.config.vertical_cand_chunk)
        chunk = min(next_pow2(max(int(chunk), 8)), next_pow2(c_cap))
        while chunk > 1 and c_cap % chunk:
            chunk //= 2
        return max(chunk, 1)

    def _vertical_lane_tile(self) -> int:
        """Lanes per slab of K3's plain version:
        ``FA_VERTICAL_LANE_TILE`` (strict; unset or 0 =
        ``config.vertical_lane_tile``) in a power-of-two bucket, at
        least 128."""
        tile = (env_int("FA_VERTICAL_LANE_TILE", 0, minimum=0)
                or self.config.vertical_lane_tile)
        return next_pow2(max(int(tile), 128))

    def _requested_mine_engine(self) -> str:
        """The strictly parsed layout request: ``FA_MINE_ENGINE`` over
        ``config.mine_engine``; a value outside ``MINE_ENGINES`` in either
        raises InputError."""
        req = env_choice("FA_MINE_ENGINE", MINE_ENGINES)
        if req is None:
            req = self.config.mine_engine
            if req not in MINE_ENGINES:
                raise InputError(
                    f"unrecognized MinerConfig.mine_engine value {req!r}: "
                    f"use one of {'/'.join(MINE_ENGINES)}"
                )
        return req

    @staticmethod
    def _quorum_left_vertical(req: str) -> bool:
        """True when the quorum domain's ``mine_engine`` floor is past
        vertical (a peer left the layout: its lane collectives would
        never match); a forced vertical then records the fallback and
        the walk."""
        if quorum.stage_allowed("mine_engine", "vertical"):
            return False
        if req == "vertical":
            ledger.record("mine_engine_fallback", once_key="quorum",
                          reason="quorum")
            watchdog.downgrade("mine_engine", "vertical", "bitmap",
                               reason="quorum")
        return True

    def _mine_engine(self, data: CompressedData) -> Tuple[str, str, float]:
        """Resolve the layout for this mine: returns ``(engine,
        requested, density)`` with engine "bitmap" or "vertical".  Auto
        picks vertical on sparse wide-item corpora: at least
        ``vertical_min_items`` frequent items and a density (see
        :func:`density_from_tables`) of at most ``vertical_density_max``.
        Data without the basket CSR stays bitmap under auto; a forced
        vertical then raises InputError.  A cand mesh stays bitmap too (the
        vertical engine shards lanes over a 1-D mesh only): quietly under
        auto, with a ``mine_engine_fallback`` event and a cascade walk
        when forced, as in the JAX package."""
        req = self._requested_mine_engine()
        cfg = self.config
        density = density_from_tables(
            data.n_raw, data.num_items, float(np.sum(data.item_counts))
        )
        if req == "bitmap":
            return "bitmap", req, density
        if self.ctx.cand_shards != 1:
            if req == "vertical":
                ledger.record("mine_engine_fallback", once_key="cand_mesh",
                              reason="cand_mesh")
                watchdog.downgrade("mine_engine", "vertical", "bitmap",
                                   reason="cand_mesh")
            return "bitmap", req, density
        if not has_csr(data):
            if req == "vertical":
                raise InputError(
                    "mine_engine 'vertical' needs the baskets as CSR "
                    "(basket_offsets of length total_count + 1); this "
                    "CompressedData has none"
                )
            return "bitmap", req, density
        if self._quorum_left_vertical(req):
            return "bitmap", req, density
        if req == "vertical" or (
            data.num_items >= cfg.vertical_min_items
            and density <= cfg.vertical_density_max
        ):
            return "vertical", req, density
        return "bitmap", req, density

    def _pair_level(self, counts, min_count: int, f: int, cap_key: tuple,
                    site: str, census: Optional[torch.Tensor] = None,
                    census_cap: int = 0):
        """Level 2 from a resident [f_pad, f_pad] pair count matrix
        without the pair program: the first ``pair_cap`` survivors in one
        fetch under ``fetch.<site>``; more survivors re-extract at the
        next power of two (``fetch.pair_regather``), and the grown budget
        is remembered.  Returns host ``(flat_idx, counts, n2,
        dispatches)``; with ``census`` (the sparse reduction's union
        count, riding the same fetch) a fifth value, its host int, and
        nothing is re-extracted when it passes ``census_cap`` (the
        counts are unusable then)."""
        ctx = self.ctx
        cap = max(self.config.pair_cap, ctx.pair_cap_hint(cap_key) or 0)
        idx, cnt, n2, extra = ctx.pair_regather(counts, min_count, f, cap,
                                                site, extra=census)
        dispatches = 1
        if census is not None and extra > census_cap:
            return idx, cnt, n2, dispatches, extra
        if n2 > cap:
            self._degraded("pair_cap_overflow", n2=n2, cap=cap)
            cap = next_pow2(n2)
            idx, cnt, _, _ = ctx.pair_regather(counts, min_count, f, cap)
            ctx.record_pair_cap(cap_key, cap)
            dispatches = 2
        if census is None:
            return idx, cnt, n2, dispatches
        return idx, cnt, n2, dispatches, extra

    def _pair_level_mesh(self, parts, min_count: int, f: int, f_pad: int,
                         t_pad: int, red: dict, vertical: bool):
        """Level 2 over the transaction shards' partial pair counts: the
        count reduction (sparse over the upper triangle of real items
        above ``count_sparse_min`` slots under a sparse mine, else the
        dense psum), then :meth:`_pair_level`.  A union past its budget
        redoes the level dense (``count_sparse_overflow``, the grown
        budget remembered); a transient that outlasted the sparse fetch's
        retries walks the exchange and the reduction for the rest of the
        mine and redoes it dense.  Returns ``(flat_idx, counts, n2,
        dispatches, reduce info)``."""
        cfg = self.config
        site = "vpair" if vertical else "pair"  # the ledger's site name
        cap_key = ("vpair_cap" if vertical else "pair_cap", t_pad, f,
                   min_count)
        n_cand = f_pad * f_pad
        wasted = None
        if red["engine"] == "sparse" and n_cand >= cfg.count_sparse_min:
            spk = ("sparse_" + site, t_pad, f, min_count)
            sp_cap = self._sparse_cap(n_cand, hint_key=spk)
            iu = torch.arange(f_pad, device=parts[0].device)
            valid = (iu[None, :] > iu[:, None]) & (iu[None, :] < f)
            try:
                counts, nu = local_sparse_psum(parts, red["thr"], sp_cap,
                                               valid, self.ctx.exchange_spec)
                idx, cnt, n2, disp, nu_h = self._pair_level(
                    counts, min_count, f, cap_key,
                    "vpair_sparse" if vertical else "pair_sparse",
                    census=nu, census_cap=sp_cap)
            except Exception as exc:
                if not retry.exhausted(exc):
                    raise
                self._sparse_walk(exc, site, red)
                red.update(engine="dense", thr=None)
            else:
                info = self._reduce_info(n_cand, sp_cap)
                info["n_union"] = nu_h
                if nu_h <= sp_cap:
                    return idx, cnt, n2, disp, info
                # The compaction truncated: the counts are a subset of
                # the union's.  Redo dense; the sparse bytes were spent.
                ledger.record("count_sparse_overflow", site=site,
                              n_union=nu_h, cap=sp_cap)
                self.ctx.record_pair_cap(spk, next_pow2(nu_h))
                wasted = info
        idx, cnt, n2, disp = self._pair_level(
            dense_psum(parts), min_count, f, cap_key,
            "vpair" if vertical else "pair")
        info = self._reduce_info(n_cand, None)
        if wasted is not None:
            info.update(fallback="sparse_overflow",
                        n_union=wasted["n_union"],
                        psum_bytes=info["psum_bytes"]
                        + wasted["psum_bytes"],
                        gather_bytes=wasted["gather_bytes"])
            disp += 1
        return idx, cnt, n2, disp, info

    @staticmethod
    def _pair_fetch(pair_pre: dict):
        """Host values of the ingest-overlapped pair program, fetched
        once (level 2 and level 3 share the fetch): ``(flat_idx, counts,
        n2, tri)``, and ``pair_pre["l3_host"] = (flat3, counts3, n3, p3,
        cap3)`` when the program counted level 3."""
        if "host" not in pair_pre:
            out = pair_pre.pop("fetch").result()
            cap = pair_pre["cap"]
            pair_pre["host"] = (
                out[:cap],
                out[cap : 2 * cap],
                int(out[2 * cap]),
                int(out[2 * cap + 1]),
            )
            if pair_pre["l3"] is not None:
                p3, cap3, _ = pair_pre["l3"]
                base = 2 * cap + 2
                pair_pre["l3_host"] = (
                    out[base : base + cap3],
                    out[base + cap3 : base + 2 * cap3],
                    int(out[base + 2 * cap3]),
                    p3,
                    cap3,
                )
        return pair_pre["host"]

    def _degraded(self, kind: str, **fields) -> None:
        """A degradation: its metrics event and its ledger event."""
        self.metrics.emit(kind, **fields)
        ledger.record(kind, **fields)

    def _fused_fallback(self, partial: Optional[Levels],
                        reason: str = "row_budget_or_bound") -> None:
        """One ``fused_fallback`` event per fused -> level handover, with
        the salvaged complete levels it resumes from.  A degradation (a
        forced fused engine, a salvage, a transient) is also a ledger
        event and a cascade walk; the auto choice of the level engine is
        a choice, not a degradation."""
        n = len(partial) if partial else 0
        self.metrics.emit("fused_fallback", resume_levels=n)
        if (self.engine == "fused" or partial
                or reason == "transient_exhausted"):
            ledger.record("fused_fallback", resume_levels=n, reason=reason)
            watchdog.downgrade("engine", "fused", "level", reason=reason,
                               resume_levels=n)

    def _fused_resident_safe(self, *args, **kw):
        """:meth:`_fused_resident` with the cascade's transient arm: a
        fused fetch that outlasted its retries walks to the level engine
        instead of ending the mine."""
        try:
            return self._fused_resident(*args, **kw)
        except Exception as exc:
            if not retry.exhausted(exc):
                raise
            watchdog.downgrade("engine", "fused", "level",
                               reason="transient_exhausted",
                               error=f"{type(exc).__name__}: {exc}"[:200])
            return None, None, False

    def _mine_vertical_safe(self, data: CompressedData) -> Levels:
        """:meth:`_mine_vertical` with the cascade's transient arm: a
        vertical fetch that outlasted its retries walks mine_engine
        vertical -> bitmap and the bitmap level engine mines (the same
        levels), seeded from the resume levels the vertical attempt had
        taken.  Any other error, K3's launch included, propagates.  A
        ``mine_engine`` clamp adopted from a peer at a level boundary
        (:class:`_MineEngineClamp`) hands the bitmap loop the complete
        levels instead."""
        resume_state = (self._resume_levels, self._resume_meta,
                        self._resume_label)
        try:
            return self._mine_vertical(data)
        except _MineEngineClamp as exc:
            # A peer's walk, adopted at a level boundary (the adoption
            # recorded the cascade walk): the bitmap loop goes on from
            # the complete levels.
            self.set_resume_levels(exc.levels, None, "engine_clamp")
            ledger.record("mine_engine_fallback", once_key="quorum",
                          reason="quorum", k=exc.k)
            return self._mine_levels(data)
        except Exception as exc:
            if not retry.exhausted(exc):
                raise
            (self._resume_levels, self._resume_meta,
             self._resume_label) = resume_state
            watchdog.downgrade("mine_engine", "vertical", "bitmap",
                               reason="transient_exhausted",
                               error=f"{type(exc).__name__}: {exc}"[:200])
            ledger.record("mine_engine_fallback",
                          once_key="transient_exhausted",
                          reason="transient_exhausted")
            return self._mine_levels(data)

    def _device_peak(self, m) -> None:
        if self.ctx.device.type == "cuda":
            m.update(device_peak_bytes=torch.cuda.max_memory_allocated(
                self.ctx.device))

    def _mine_fused(self, data: CompressedData, auto: bool = False):
        """The fused engine over a packed upload of the data's CSR (the
        one-call ingest path): ``(levels, None)`` on success, ``(None,
        complete levels or None)`` when the row-budget ceiling or the
        level bound stopped it, or when ``auto`` chose the level engine
        (the pre-pass's survivor count and census, before any fused
        work)."""
        cfg = self.config
        ctx = self.ctx
        f = data.num_items
        t0 = data.total_count
        multi = self._multi(data)
        local = ctx.local_txn_shards
        # Each transaction shard's rows split into n_chunks equal chunks;
        # a sharded ingest's processes pad to the same local rows, and
        # the digits are the global largest weight's.
        per_dev = -(-(max(data.shard.local_counts) if multi else t0)
                    // local)
        n_chunks = max(1, -(-per_dev // cfg.fused_txn_chunk))
        multiple = max(cfg.txn_tile, 32) * n_chunks * local
        local_pad = (self._local_pad(data, multiple) if multi
                     else pad_axis(t0, multiple))
        t_pad = local_pad * ctx.world
        n_digits = weight_digit_count(
            data.shard.max_weight if multi
            else int(data.weights.max()) if t0 else 1)
        # float32 products on the CPU while every partial sum < 2^24.
        fast_f32 = ctx.platform == "cpu" and 127 * t_pad < 2**24
        # min_count is part of the profile: the choice depends on it.
        profile = (t_pad, f, cfg.fused_l_max, n_digits, n_chunks, fast_f32,
                   data.min_count)
        if ctx.fused_failed(profile):
            self.metrics.emit("fused_skip", reason="known_overflow")
            return None, None
        if auto and ctx.auto_level(profile):
            self.metrics.emit("engine_auto", choice="level", memo=True)
            return None, None
        f_pad = pad_axis(f + 1, cfg.item_tile)
        m_cap_max = min(cfg.fused_m_cap_max, fused_m_cap_memory_limit(
            cfg, ctx, t_pad, f_pad, n_chunks))
        if m_cap_max < cfg.fused_m_cap_max:
            self.metrics.emit("fused_m_cap_clamp", memory_limit=m_cap_max,
                              configured=cfg.fused_m_cap_max)
        if m_cap_max < next_pow2(cfg.fused_l_max + 2):
            self.metrics.emit("fused_skip", reason="memory")
            return None, None
        with self.metrics.timed("bitmap_pack") as m:
            packed_np, f_pad = build_packed_bitmap_csr(
                data.basket_indices, data.basket_offsets, f, local_pad,
                cfg.item_tile)
            w_np = np.zeros(local_pad, dtype=np.int32)
            w_np[:t0] = data.weights
            # Rows over the transaction shards (a cand mesh's blocks
            # would repeat the same program: candidate block 0 runs).
            packed = ctx.shard_rows(packed_np, txn_only=True)
            w = ctx.shard_rows(w_np, txn_only=True)
            m.update(shape=[t_pad, f_pad], digits=n_digits,
                     upload_bytes=packed_np.nbytes + w_np.nbytes)
        m_cap = ctx.fused_m_cap_hint(profile)
        if m_cap is not None and m_cap > m_cap_max:
            m_cap = None
        if m_cap is None:
            with self.metrics.timed("pair_prepass") as met:
                n2, tri = (int(x) for x in ctx.fetch(torch.stack(
                    make_pair_counter(n_digits, n_chunks, fast_f32)(
                        packed, w, data.min_count,
                        num_items=data.num_items)), "pair"))
                met.update(n2=n2, cand3=tri)
            m_cap = self._size_fused_budget(profile, n2, tri, m_cap_max, auto)
            if m_cap is None:  # auto chose the level engine
                return None, None
        m_cap = max(m_cap, next_pow2(cfg.fused_l_max + 2))
        return self._fused_attempt_loop(
            profile, data, packed, w, m_cap, m_cap_max, t_pad, f_pad,
            n_digits, n_chunks, fast_f32, packed_input=True,
            model=fused_card_bytes(cfg, ctx, t_pad, f_pad, n_chunks))

    def _size_fused_budget(self, profile, n2: int, tri: int, m_cap_max: int,
                           auto: bool) -> Optional[int]:
        """The row budget from the level-2 survivor count, one definition
        for both input forms; None when the auto choice picks the level
        engine."""
        cfg = self.config
        want = max(next_pow2(2 * max(n2, 1)), cfg.fused_m_cap,
                   cfg.min_prefix_bucket)
        if auto and not self._auto_fused_ok(profile, n2, tri, want,
                                            m_cap_max):
            return None
        return min(want, m_cap_max)

    def _auto_fused_ok(self, profile, n2: int, tri: int, want: int,
                       m_cap_max: int) -> bool:
        """The auto go/no-go: fused when the survivor budget and the
        level-3 candidate census both fit the ceiling (the census sees a
        mid-lattice blow-up that n2 alone cannot; -1, not computed, does
        not object).  A level choice is remembered for the profile."""
        ok = want <= m_cap_max and (tri < 0 or tri <= m_cap_max)
        self.metrics.emit("engine_auto", choice="fused" if ok else "level",
                          n2=n2, cand3=tri, m_cap_max=m_cap_max)
        if not ok:
            self.ctx.record_auto_level(profile)
        return ok

    def _fused_reduce_setup(self, data: CompressedData, t_pad: int,
                            f_pad: int):
        """The fused attempt's count reduction (the JAX package's
        ``_fused_count_reduce_setup``): the engine, dense below
        ``count_sparse_min`` level-2 slots (a ``count_reduce_fallback``
        event), the exchange topology, the per-shard thresholds and the
        union budgets' hint key."""
        count_reduce, _ = self._count_reduce_engine()
        if (count_reduce == "sparse"
                and f_pad * f_pad < self.config.count_sparse_min):
            ledger.record("count_reduce_fallback", once_key="tiny_fused",
                          reason="tiny_candidate_set", site="fused")
            count_reduce = "dense"
        self.ctx.exchange_spec = (
            self._exchange_spec() if count_reduce == "sparse" else None)
        thr = (self._sparse_thresholds(data, t_pad, heavy=False)
               if count_reduce == "sparse" else None)
        return count_reduce, thr, ("sparse_fused", t_pad, f_pad,
                                   int(data.min_count))

    def _fused_attempt_loop(self, profile, data: CompressedData, bitmap, w,
                            m_cap: int, m_cap_max: int, t_pad: int,
                            f_pad: int, n_digits: int, n_chunks: int,
                            fast_f32: bool, packed_input: bool, model):
        """The fused engine's attempts, shared by both input forms: an
        overflowing row budget jumps to the overflowing level's true
        need (at least twice the budget) until the ceiling; the l_max
        bound stops at once; a sparse union past its budget reruns the
        same budget dense (a ``count_sparse_overflow`` event, a cascade
        walk and the grown budget remembered).  ``bitmap`` / ``w``: a
        tensor or the per-shard lists.  Returns ``(levels, None)`` or
        ``(None, salvaged complete levels or None)``."""
        cfg = self.config
        ctx = self.ctx
        l_max = cfg.fused_l_max
        min_count = data.min_count
        reduce, thr, hint_key = self._fused_reduce_setup(data, t_pad, f_pad)
        fixed, at = model
        rows = None
        m_cap_run = 0
        while m_cap <= m_cap_max:
            caps = ((self._sparse_cap(f_pad * f_pad, hint_key),
                     self._sparse_cap(m_cap * f_pad, hint_key))
                    if reduce == "sparse" else None)
            with self.metrics.timed("fused_mine", m_cap=m_cap,
                                    reduce=reduce) as met:
                fn = make_fused_miner(
                    m_cap, l_max, n_digits, n_chunks, fast_f32,
                    packed_input=packed_input, sparse_caps=caps,
                    groups=ctx.exchange_spec if caps else None)
                out = ctx.fetch(fn(bitmap, w, min_count, sparse_thr=thr,
                                   region=ctx.sync_free,
                                   num_items=data.num_items), "fused")
                (a_rows, a_cols, a_counts, n_lvl, incomplete, overflow,
                 sparse_ovf, sparse_nu) = unpack_fused_result(out, l_max)
                if sparse_ovf:
                    met.update(sparse_overflow=True, n_union=sparse_nu)
                else:
                    rows, cols, counts = a_rows, a_cols, a_counts
                    m_cap_run = m_cap
                    # Level 2's Gram product, then per loop iteration the
                    # two candidate products and the membership + count
                    # products; the reductions' payloads likewise.
                    n_iters = max(int(np.count_nonzero(n_lvl)), 1)
                    i2 = self._reduce_info(f_pad * f_pad,
                                           caps[0] if caps else None)
                    il = self._reduce_info(m_cap * f_pad,
                                           caps[1] if caps else None)
                    met.update(
                        incomplete=incomplete, overflow=overflow,
                        levels=int(np.count_nonzero(n_lvl)),
                        packed_input=packed_input, n_chunks=n_chunks,
                        macs=n_digits * t_pad * f_pad * f_pad
                        + (n_iters - 1) * (
                            2 * m_cap * m_cap * f_pad
                            + (1 + n_digits) * t_pad * m_cap * f_pad),
                        model_bytes=fixed + at(m_cap),
                    )
                    if ctx.txn_shards > 1:
                        met.update(
                            psum_bytes=i2["psum_bytes"]
                            + (n_iters - 1) * il["psum_bytes"],
                            gather_bytes=i2["gather_bytes"]
                            + (n_iters - 1) * il["gather_bytes"])
                        if caps:
                            met.update(n_union=sparse_nu,
                                       exchange=i2["exchange"])
                self._device_peak(met)
            if sparse_ovf:
                ledger.record("count_sparse_overflow", site="fused",
                              m_cap=m_cap, caps=list(caps),
                              n_union=sparse_nu)
                watchdog.downgrade("count_reduce", "sparse", "dense",
                                   reason="union_overflow", site="fused")
                if sparse_nu > 0:
                    ctx.record_pair_cap(hint_key, next_pow2(sparse_nu))
                reduce = "dense"
                continue  # the same budget, dense
            if not incomplete:
                ctx.record_fused_m_cap(profile, m_cap)
                return decode_level_matrices(rows, cols, counts, n_lvl), None
            if not overflow:
                break  # the l_max bound: more rows cannot help
            # The meta row holds the true survivor counts: jump to a
            # budget that holds the overflowing level.
            needed = int(max(np.max(n_lvl), m_cap + 1))
            m_cap = max(2 * m_cap, next_pow2(needed))
        ctx.record_fused_fail(profile)
        if rows is None:
            return None, None
        return None, decode_level_matrices(rows, cols, counts, n_lvl,
                                           max_rows=m_cap_run)

    def _fused_resident(self, data: CompressedData, bitmap: torch.Tensor,
                        n_chunks: int, t_pad: int, n2: Optional[int] = None,
                        tri: int = -1):
        """The fused engine over the level engine's resident unpacked
        bitmap (the pipelined ingest).  Returns ``(levels, salvaged,
        need_n2)``: ``need_n2`` asks the caller for the level-2 survivor
        count and census (the pair program's, or the pair level's) to
        size the budget and make the auto choice, and to call again."""
        cfg = self.config
        ctx = self.ctx
        f_pad = bitmap.shape[1]
        n_digits = weight_digit_count(
            int(data.weights.max()) if data.total_count else 1)
        fast_f32 = ctx.platform == "cpu" and 127 * t_pad < 2**24
        profile = ("resident", t_pad, data.num_items, cfg.fused_l_max,
                   n_digits, n_chunks, fast_f32, data.min_count)
        auto = self.engine == "auto"
        if ctx.fused_failed(profile):
            self.metrics.emit("fused_skip", reason="known_overflow")
            return None, None, False
        if auto and ctx.auto_level(profile):
            self.metrics.emit("engine_auto", choice="level", memo=True)
            return None, None, False
        m_cap_max = min(cfg.fused_m_cap_max, fused_m_cap_memory_limit(
            cfg, ctx, t_pad, f_pad, n_chunks, unpacked_resident=True))
        if m_cap_max < next_pow2(cfg.fused_l_max + 2):
            self.metrics.emit("fused_skip", reason="memory")
            return None, None, False
        m_cap = ctx.fused_m_cap_hint(profile)
        if m_cap is not None and m_cap > m_cap_max:
            m_cap = None
        if m_cap is None:
            if n2 is None:
                return None, None, True
            m_cap = self._size_fused_budget(profile, n2, tri, m_cap_max, auto)
            if m_cap is None:  # auto chose the level engine
                return None, None, False
        m_cap = max(m_cap, next_pow2(cfg.fused_l_max + 2))
        # The fused loop counts with the raw weights (4·T bytes), not the
        # level engine's digits.
        w_np = np.zeros(t_pad, dtype=np.int32)
        w_np[: data.total_count] = data.weights
        lv, partial = self._fused_attempt_loop(
            profile, data, bitmap, ctx.upload(w_np), m_cap, m_cap_max,
            t_pad, f_pad, n_digits, n_chunks, fast_f32, packed_input=False,
            model=fused_card_bytes(cfg, ctx, t_pad, f_pad, n_chunks,
                                   unpacked_resident=True))
        return lv, partial, False

    def _mine_levels(
        self,
        data: CompressedData,
        resume: Optional[Levels] = None,
        preupload: Optional[tuple] = None,
        try_fused: bool = False,
        pair_pre: Optional[dict] = None,
    ) -> Levels:
        """The bitmap layout's levels.  ``resume``: complete levels
        salvaged from a fused attempt; the loop goes on from the deepest.
        ``preupload``: ``(bitmap, w_digits, scales, n_chunks, t_pad,
        f_pad, heavy)`` already on the device from the pipelined ingest
        (the bitmap build below is skipped).  ``try_fused`` (the pipelined
        ingest): offer the whole lattice to the fused engine over the
        same resident bitmap first, sized by the pair program's survivor
        count and census (or by the pair level's).  ``pair_pre``: the
        ingest-overlapped pair program in flight; level 2, and level 3
        when it fits the program's budgets, are then reads of its one
        fetch instead of launches.  Without ``resume``, the levels of
        :meth:`set_resume_levels` (a checkpoint) seed the loop."""
        cfg = self.config
        ctx = self.ctx
        f = data.num_items
        min_count = data.min_count
        # The domain's positions first: every resolution below starts at
        # the agreed floor.
        quorum.sync("mine.start")
        if resume is None:
            resume = self._take_resume(data)
        if preupload is not None:
            bitmap, w_digits, scales, n_chunks, t_pad, f_pad, heavy = preupload
            table, weights = [bitmap], [w_digits]
        else:
            with self.metrics.timed("bitmap_build") as m:
                # Each transaction shard's rows in whole chunks, as the
                # pipelined ingest pads (the tail fold counts chunk by
                # chunk).
                multi = self._multi(data)
                local = ctx.local_txn_shards
                rows = (max(data.shard.local_counts) if multi
                        else data.total_count)
                per_dev = -(-rows // local)
                n_chunks = max(1, -(-per_dev // cfg.level_txn_chunk))
                multiple = txn_multiple(cfg, n_chunks, local)
                if multi:
                    # Every process pads its own rows to the same count;
                    # the global bitmap is the processes' in rank order.
                    multiple = self._local_pad(data, multiple)
                bitmap_np = build_bitmap_csr(
                    data.basket_indices, data.basket_offsets, f, multiple,
                    cfg.item_tile,
                )
                t_pad, f_pad = bitmap_np.shape
                if multi:
                    # The JAX package's multi-process digits: the global
                    # largest weight's, no heavy split.
                    t_pad *= ctx.world
                    w_digits_np, scales = weight_digits(
                        data.weights, bitmap_np.shape[0],
                        min_digits=weight_digit_count(
                            data.shard.max_weight))
                    heavy_b = heavy_w = None
                else:
                    w_digits_np, scales, heavy_b, heavy_w = split_weights(
                        data.weights, t_pad, data.basket_indices,
                        data.basket_offsets, f, cfg.item_tile,
                    )
                # Rows and their weight digits over the transaction
                # shards; the heavy remainder stays whole on shard 0, the
                # only shard that adds it.
                table = ctx.shard_rows(bitmap_np)
                weights = ctx.shard_rows(w_digits_np, axis=-1)
                bitmap, w_digits = table[0], weights[0]
                if ctx.n_devices > 1:
                    m.update(shards=ctx.txn_shards,
                             cand_shards=ctx.cand_shards)
                heavy = self._upload_heavy(heavy_b, heavy_w)
                m.update(shape=[t_pad, f_pad], digits=len(scales),
                         heavy_rows=self._heavy_stats(heavy_b, heavy_w)[0])
        red = self._reduce_setup(data, t_pad, heavy is not None)

        need_n2 = False
        if (not resume and try_fused and self.engine in ("fused", "auto")
                and not cfg.checkpoint_prefix
                and quorum.stage_allowed("engine", "fused")):
            # A remembered budget or choice decides without level 2.
            lv, partial, need_n2 = self._fused_resident_safe(
                data, bitmap, n_chunks, t_pad)
            if lv is None and need_n2 and pair_pre is not None:
                # The pair program's count and census size the budget.
                _, _, n2, tri = self._pair_fetch(pair_pre)
                lv, partial, _ = self._fused_resident_safe(
                    data, bitmap, n_chunks, t_pad, n2=n2, tri=tri)
                need_n2 = False
            if lv is not None:
                return lv
            if partial:
                self._fused_fallback(partial)
                resume = partial

        if resume:
            levels: Levels = list(resume)
            cur = levels[-1][0]
            self.metrics.emit("level_resume", from_k=int(cur.shape[1]) + 1)
            return self._level_loop(data, levels, table, weights, scales,
                                    heavy, n_chunks=n_chunks, red=red)

        with self.metrics.timed("level", k=2) as m:
            if pair_pre is not None:
                idx, cnt, n2, tri = self._pair_fetch(pair_pre)
                cap = pair_pre["cap"]
                dispatches = 0  # the pair program rode the ingest
                if n2 > cap:
                    self._degraded("pair_cap_overflow", n2=n2, cap=cap)
                    cap = next_pow2(n2)
                    idx, cnt, _, _ = ctx.pair_regather(
                        pair_pre["counts_dev"], min_count, f, cap
                    )
                    ctx.record_pair_cap(pair_pre["cap_key"], cap)
                    dispatches = 1
                pair_pre["counts_dev"] = None  # free the [F, F] matrix
                start, end = pair_pre["events"]
                if start is not None:
                    # The pair program's device time, from the uploads'
                    # arrival to its packed output; the fetch has passed.
                    m.update(pair_device_ms=round(
                        start.elapsed_time(end), 3))
            elif ctx.n_devices > 1:
                # Each transaction shard's Gram product, shard 0 adding
                # the heavy remainder, then the count reduction.
                parts = [
                    local_pair_counts(b, wd, scales,
                                      fast_f32=data.n_raw < 2**24)
                    for b, wd in zip(ctx.txn_parts(table),
                                     ctx.txn_parts(weights))]
                if heavy is not None:
                    parts[0] = parts[0] + heavy_pair_correction(*heavy)
                idx, cnt, n2, dispatches, rinfo = self._pair_level_mesh(
                    parts, min_count, f, f_pad, t_pad, red, vertical=False)
                del parts
                m.update(**rinfo)
                tri = None
            else:
                # Exact in float32 while every count < 2^24; counts are
                # bounded by the raw transaction total.
                counts = local_pair_counts(
                    bitmap, w_digits, scales, fast_f32=data.n_raw < 2**24
                )
                if heavy is not None:
                    counts = counts + heavy_pair_correction(*heavy)
                idx, cnt, n2, dispatches = self._pair_level(
                    counts, min_count, f, ("pair_cap", t_pad, f, min_count),
                    "pair")
                tri = None
                if need_n2:
                    # The fused engine's auto choice reads the census.
                    tri = (int(ctx.fetch(_pair_triangles(frequent_pair_mask(
                        counts, min_count, f)), "pair")) if f_pad <= TRI_F_CAP
                        else -1)
                del counts
            idx, cnt = idx[:n2], cnt[:n2]
            # Row-major upper triangle: already lex-sorted.
            cur = np.stack([idx // f_pad, idx % f_pad], axis=1).astype(
                np.int32)
            levels = [(cur, cnt.astype(np.int64))]
            m.update(candidates=f * (f - 1) // 2, frequent=n2,
                     overlapped=pair_pre is not None,
                     dispatches=dispatches)
            if tri is not None:
                m.update(cand3=tri)
            self._device_peak(m)
        if need_n2:
            # The pair level doubles as the fused engine's sizing pre-pass.
            lv, partial, _ = self._fused_resident_safe(
                data, bitmap, n_chunks, t_pad, n2=n2, tri=tri)
            if lv is not None:
                return lv
            if partial:
                # The salvage holds level 2 too, equal to the one above.
                self._fused_fallback(partial)
                levels[:] = partial
                cur = levels[-1][0]
        self._checkpoint_levels(levels, data)

        l3h = pair_pre.get("l3_host") if pair_pre is not None else None
        if (l3h is not None and len(levels) == 1 and cur.shape[1] == 2
                and cur.shape[0] >= 3):
            idx3, cnt3, n3, p3, cap3 = l3h
            n2_now = cur.shape[0]
            if n2_now <= p3 and n3 <= cap3:
                with self.metrics.timed("level", k=3) as m:
                    idx3, cnt3 = idx3[:n3], cnt3[:n3]
                    # Row-major (pair slot, z) over a lex-sorted pair
                    # level: already lex-sorted.
                    nxt3 = np.concatenate(
                        [cur[idx3 // f_pad], (idx3 % f_pad)[:, None]],
                        axis=1,
                    ).astype(np.int32)
                    levels.append((nxt3, cnt3.astype(np.int64)))
                    m.update(candidates=tri, frequent=n3, launches=0,
                             overlapped=True, dispatches=0, n2=n2_now,
                             p3=p3, n3=n3, cap3=cap3)
                self._checkpoint_levels(levels, data)
            else:
                l3p_key, l3c_key = pair_pre["l3_keys"]
                if n2_now > p3:
                    ctx.record_pair_cap(l3p_key, next_pow2(n2_now))
                if n3 > cap3:
                    ctx.record_pair_cap(l3c_key, next_pow2(n3))
                self._degraded("pair_l3_overflow", n2=n2_now, p3=p3, n3=n3,
                               cap3=cap3)
        return self._level_loop(data, levels, table, weights, scales,
                                heavy, n_chunks=n_chunks, red=red)

    def _mine_vertical(self, data: CompressedData) -> Levels:
        """Vertical (Eclat-style) mining: the tid-lane arena and weight
        bit-planes on the device, the pair phase as a Gram product over
        unpacked lane chunks, then the level loop the bitmap engine uses,
        counting with K3.  Resume levels (:meth:`set_resume_levels`) skip
        the pair phase."""
        cfg = self.config
        ctx = self.ctx
        f = data.num_items
        quorum.sync("mine.start")
        resume = self._take_resume(data)
        n_threads = ingest_thread_count(cfg.ingest_threads)
        multi = self._multi(data)
        with self.metrics.timed("arena_build") as m:
            # Lanes split evenly over the transaction shards: lane block s
            # holds the transactions of bitmap row shard s.  A sharded
            # ingest's process builds its own rows' lanes, padded to the
            # same count on every process (lane sharding across
            # processes), with the global largest weight's planes.
            multiple = 32 * ctx.local_txn_shards
            if multi:
                multiple = self._local_pad(data, multiple)
            arena_np, f_pad, t_pad = build_tid_arena_csr(
                data.basket_indices, data.basket_offsets, f,
                multiple, cfg.item_tile, n_threads=n_threads,
            )
            planes_np, scales = weight_bit_planes(
                np.asarray(data.weights, dtype=np.int64), t_pad,
                min_planes=(data.shard.max_weight.bit_length() if multi
                            else 1),
            )
            t_pad *= ctx.world
            # Census first; the bucket fill and the device scatter only
            # when the compressed upload is at most half the dense one
            # (the dense arena across processes, as in the JAX package).
            _, payload, seg_stats = compress_arena(arena_np, f_pad,
                                                   build=False)
            use_compressed = not multi and payload * 2 <= arena_np.nbytes
            buckets = (
                compress_arena(arena_np, f_pad)[0] if use_compressed else None
            )
            arena, upload_bytes = ctx.upload_tid_arena(arena_np, buckets)
            w_planes = ctx.upload_lane_planes(planes_np)
            # Each shard's lane block on its device (the arena itself on
            # one shard); K3's lane plane mask per block.
            arenas = ctx.shard_lanes(arena)
            planes = ctx.shard_lanes(w_planes)
            if ctx.n_devices > 1:
                del arena, w_planes
                for p in planes:
                    lane_plane_mask(p)
                m.update(shards=ctx.txn_shards)
            m.update(
                shape=[f_pad + 1, t_pad // 32],
                planes=len(scales),
                compressed=use_compressed,
                occupancy=seg_stats["occupancy"],
                upload_bytes=upload_bytes + planes_np.nbytes,
                threads=n_threads,
            )
        red = self._reduce_setup(data, t_pad, heavy=False)
        if resume:
            self.metrics.emit("level_resume",
                              from_k=int(resume[-1][0].shape[1]) + 1)
            return self._level_loop(data, resume, arenas, planes, scales,
                                    vertical=True, red=red)

        with self.metrics.timed("level", k=2) as m:
            n_chunks = max(1, -(-(t_pad // ctx.txn_shards)
                                // PAIR_TXN_CHUNK))
            # Exact in float32 while every count < 2^24 (the bitmap
            # engine's gate); k >= 3 counts are integer popcounts.
            parts = [
                vertical_pair_local(a, p, scales, n_chunks,
                                    fast_f32=data.n_raw < 2**24)
                for a, p in zip(ctx.txn_parts(arenas), ctx.txn_parts(planes))]
            idx, cnt, n2, dispatches, rinfo = self._pair_level_mesh(
                parts, data.min_count, f, f_pad, t_pad, red, vertical=True)
            if ctx.txn_shards > 1:
                m.update(**rinfo)
            del parts
            idx, cnt = idx[:n2], cnt[:n2]
            cur = np.stack([idx // f_pad, idx % f_pad], axis=1).astype(
                np.int32)
            m.update(candidates=f * (f - 1) // 2, frequent=n2,
                     overlapped=False, dispatches=dispatches,
                     engine="vertical", chunks=n_chunks)
        levels = [(cur, cnt.astype(np.int64))]
        self._checkpoint_levels(levels, data)
        return self._level_loop(data, levels, arenas, planes, scales,
                                vertical=True, red=red)

    def _level_loop(
        self,
        data: CompressedData,
        levels: Levels,
        table,
        weights,
        scales,
        heavy: Optional[tuple] = None,
        vertical: bool = False,
        n_chunks: int = 1,
        red: Optional[dict] = None,
    ) -> Levels:
        """The levels after the last one in ``levels`` (the pair level,
        level 3 when the pair program counted it, the last salvaged one
        or the deepest resumed one), with the reference's termination
        rule (FastApriori.scala:111).

        Counts: without a checkpoint prefix each level's counts stay on
        the device (``pending_map``) and resolve after the loop in one
        gather and one fetch (:meth:`_resolve_pending_counts`); past
        ``pending_fetch_budget_bytes`` they drain early
        (:meth:`_drain_pending`).  A checkpoint prefix fetches each
        level's counts eagerly: a durable level carries its counts.

        On the bitmap layout a seed level k - 1 with k > 3 and at most the
        fold threshold's rows hands the rest to :meth:`_mine_tail`, at
        most twice, each seed smaller than the last; an incomplete fold
        resumes here from its last complete level.  With
        ``engine="fused"`` and a checkpoint prefix every step is a
        segment of ``checkpoint_every_levels`` levels (the tail program
        with 2x row headroom and flat slot caps), checkpointed after
        each; a segment that overflows at its first level, or that the
        memory model refuses, walks the cascade to per-level counting
        until the lattice shrinks under the failed seed.

        ``table`` and ``weights`` are the mesh's per-position lists (one
        tensor each on one device); ``red`` is the mine's count reduction
        (:meth:`_reduce_setup`), shared with the levels and folds."""
        cfg = self.config
        pending_map: Dict[int, list] = {}
        drained: list = []  # [(per-level segment sizes, PendingCounts)]
        pending_bytes = [0]
        # The JAX package's gate: a multi-process world reads each
        # level's counts at once, and so does an elastic domain (a level
        # whose counts are still on the device is no boundary the
        # survivors can re-seed from).
        defer = (not cfg.checkpoint_prefix and self.ctx.world == 1
                 and not quorum.elastic_enabled())

        def note_pending(entries) -> None:
            pending_bytes[0] += sum(c.numel() * 4 for c, _ in entries)
            if pending_bytes[0] > cfg.pending_fetch_budget_bytes:
                self._drain_pending(pending_map, drained, data.n_raw)
                pending_bytes[0] = 0

        def finish(lvls: Levels) -> Levels:
            return self._resolve_pending_counts(lvls, pending_map, drained,
                                                data.n_raw)

        auto_tail = cfg.tail_fuse_rows is None
        tail_rows = cfg.tail_fuse_rows
        if tail_rows is None:
            # The fold saves per-level launches and host round trips,
            # which the CPU does not pay.
            tail_rows = 0 if self.ctx.platform == "cpu" else 65536
        # The folds run over the transaction shards of a 1-D mesh.
        one_d = self.ctx.cand_shards == 1
        tail_ok = tail_rows > 0 and not vertical and one_d
        fused_ckpt = (self.engine == "fused" and bool(cfg.checkpoint_prefix)
                      and not vertical and one_d)
        cur = levels[-1][0]
        k = cur.shape[1] + 1
        prev_rows = None  # the previous level's rows (shrink evidence)
        fold_attempts = 2
        last_fold_seed = None
        while cur.shape[0] >= k:
            # The boundary sync may have adopted a peer's walk since the
            # last level: clamp this rank's choices before the level's
            # dispatch, so its next collective matches the domain's.
            if vertical and not quorum.stage_allowed("mine_engine",
                                                     "vertical"):
                # The arena cannot turn into a bitmap in place: the
                # complete levels go up to _mine_vertical_safe.
                raise _MineEngineClamp(finish(levels), int(k))
            if red is not None and red["engine"] == "sparse" and (
                    not quorum.stage_allowed("count_reduce", "sparse")):
                ledger.record("count_reduce_fallback", once_key="quorum",
                              reason="quorum", k=int(k))
                red["engine"], red["thr"] = "dense", None
            if self.ctx.exchange_spec is not None and (
                    not quorum.stage_allowed("exchange", "hier")):
                ledger.record("exchange_fallback", once_key="quorum",
                              reason="quorum", k=int(k))
                self.ctx.exchange_spec = None
            if fused_ckpt and not quorum.stage_allowed("engine", "fused"):
                fused_ckpt = False  # per level, still checkpointed
            if tail_ok and not quorum.stage_allowed("engine", "tail"):
                tail_ok = False
            if fused_ckpt:
                # The engine was forced: a segment whenever the seed fits
                # memory and no segment failed at this size.
                want_fold = (last_fold_seed is None
                             or cur.shape[0] < last_fold_seed)
            else:
                # Never fold off the pair level: a lattice that fits one
                # loop from level 2 is the fused engine's.
                want_fold = (
                    tail_ok and fold_attempts > 0 and k > 3
                    and cur.shape[0] <= tail_rows
                    and self._tail_entry_ok(auto_tail, cur.shape[0],
                                            prev_rows)
                    and (last_fold_seed is None
                         or cur.shape[0] < last_fold_seed))
            if want_fold:
                fold_err = False
                try:
                    tail, complete, ran = self._mine_tail(
                        data, table, weights, scales, cur, n_chunks, heavy,
                        pending_state=((pending_map, drained, pending_bytes)
                                       if defer else None),
                        l_max=cfg.checkpoint_every_levels if fused_ckpt
                        else None,
                        segment=fused_ckpt, red=red)
                except Exception as exc:
                    # A transient at the fold's fetch that outlasted its
                    # retries: per-level counting, with its own budgets.
                    if not retry.exhausted(exc):
                        raise
                    watchdog.downgrade(
                        "engine", "tail", "level",
                        reason="transient_exhausted",
                        error=f"{type(exc).__name__}: {exc}"[:200])
                    tail, complete, ran = [], False, True
                    fold_err = True
                if ran:
                    if not fused_ckpt:
                        fold_attempts -= 1
                    last_fold_seed = cur.shape[0]
                    if tail:
                        levels.extend(tail)
                        cur = tail[-1][0]
                        k = cur.shape[1] + 1
                        self._checkpoint_levels(levels, data)
                        if fused_ckpt:
                            last_fold_seed = None  # progress: fold again
                    if complete:
                        return finish(levels)
                    if fused_ckpt and not tail and not fold_err:
                        watchdog.downgrade(
                            "engine", "fused", "level",
                            reason="segment_overflow", k=int(k),
                            seed_rows=int(cur.shape[0]))
                    continue  # per level from the last complete level
                if fused_ckpt:
                    watchdog.downgrade("engine", "fused", "level",
                                       reason="segment_memory",
                                       seed_rows=int(cur.shape[0]))
                    last_fold_seed = cur.shape[0]
                # The memory model refused this seed: count it per level;
                # a smaller seed may fit.
            with self.metrics.timed("level", k=k) as m:
                nxt, nxt_counts, stats = self._count_level(
                    table, weights, scales, cur, data.min_count, heavy,
                    vertical=vertical, defer=defer, red=red,
                )
                m.update(frequent=int(nxt.shape[0]), **stats)
                if k == 3:
                    m.update(overlapped=False, dispatches=stats["launches"])
            if isinstance(nxt_counts, list):  # deferred
                pending_map[len(levels)] = nxt_counts
                note_pending(nxt_counts)
                nxt_counts = None
            levels.append((nxt, nxt_counts))
            if nxt.shape[0]:
                self._checkpoint_levels(levels, data)
            prev_rows = cur.shape[0]
            cur = nxt
            k += 1
        return finish(levels)

    @staticmethod
    def _tail_entry_ok(auto_tail: bool, n0: int,
                       prev_rows: Optional[int]) -> bool:
        """The fold's entry test under the automatic threshold (an
        explicit ``tail_fuse_rows`` always enters): a seed above 16,384
        rows needs evidence that the fold will not overflow its
        ``next_pow2(n0)`` budget at once: rows shrinking, or grown at
        most 20 % over the previous level (near the lattice's peak)."""
        if not auto_tail or n0 <= 16384:
            return True
        if prev_rows is None:
            return False
        return n0 < prev_rows or n0 * 5 <= prev_rows * 6

    def _drain_pending(self, pending_map, drained, n_raw: int) -> None:
        """The mid-loop drain of the deferred counts: one gather compacts
        every pending level's survivor counts, the per-candidate tensors
        are released (``pending_map`` is cleared) and the fetch of the
        compact result starts now and is read after the loop (the
        ``drain.counts`` failpoint fires first)."""
        flat = [(idx, c, p) for idx in sorted(pending_map)
                for c, p in pending_map[idx] if p.size]
        pending_map.clear()
        if not flat:
            return
        failpoints.fire("drain.counts")
        u24 = n_raw < 2**24
        n_out = sum(p.size for _, _, p in flat)
        with self.metrics.timed("counts_drain") as m:
            handle = self.ctx.gather_level_counts_start(
                [(c, p) for _, c, p in flat], u24=u24, site="counts_drain")
            m.update(levels=len({i for i, _, _ in flat}), dispatches=1,
                     fetch_bytes=(3 if u24 else 4) * n_out)
        drained.append(([(i, p.size) for i, _, p in flat], handle))

    def _resolve_pending_counts(self, levels: Levels, pending_map, drained,
                                n_raw: int) -> Levels:
        """Every still-deferred level's survivor counts in one gather and
        one fetch (``counts_resolve``), after the drains' fetches (read
        first, in launch order, so each level's segments concatenate in
        row order).  ``pending_map``: level index -> ``[(counts_dev,
        survivor positions)]``."""
        if not pending_map and not drained:
            return levels
        per_level: Dict[int, list] = {}
        for seg_sizes, handle in drained:
            out = self.ctx.finish_level_counts(handle)
            off = 0
            for idx, size in seg_sizes:
                per_level.setdefault(idx, []).append(out[off : off + size])
                off += size
        flat = [(idx, c, p) for idx in sorted(pending_map)
                for c, p in pending_map[idx] if p.size]
        with self.metrics.timed("counts_resolve") as m:
            # Counts < 2^24 (bounded by n_raw) cross as 3 bytes each.
            u24 = n_raw < 2**24
            out = np.empty(0, np.int64)
            t0 = time.perf_counter()
            if flat:
                handle = self.ctx.gather_level_counts_start(
                    [(c, p) for _, c, p in flat], u24=u24)
                t1 = time.perf_counter()
                out = self.ctx.finish_level_counts(handle)
                # The host's issue time, then the wait for the fetch.
                m.update(issue_ms=round((t1 - t0) * 1e3, 3),
                         wait_ms=round((time.perf_counter() - t1) * 1e3, 3))
            m.update(levels=len(pending_map), drains=len(drained),
                     dispatches=1 if flat else 0,
                     fetch_bytes=(3 if u24 else 4) * int(out.size))
        off = 0
        for idx, _, p in flat:
            per_level.setdefault(idx, []).append(out[off : off + p.size])
            off += p.size
        resolved = []
        for i, (mat, cnts) in enumerate(levels):
            if cnts is None:
                parts = per_level.get(i, [])
                cnts = (np.concatenate(parts) if parts
                        else np.empty(0, np.int64))
                assert cnts.size == mat.shape[0], (cnts.size, mat.shape)
            resolved.append((mat, cnts))
        return resolved

    def _mine_tail(self, data: CompressedData, bitmap, w_digits, scales,
                   cur: np.ndarray, n_chunks: int, heavy: Optional[tuple],
                   pending_state: Optional[tuple] = None,
                   l_max: Optional[int] = None, segment: bool = False,
                   red: Optional[dict] = None):
        """The shallow-tail fold: every remaining level from the seed
        level ``cur`` in one device loop (ops/fused.py ``tail_mine``).
        Returns ``(complete tail levels, finished, ran)``; ``ran`` False
        means the memory model refused the seed before any device work.

        ``pending_state = (pending_map, drained, pending_bytes)``: the
        level loop's deferred counts are gathered inside the fold's own
        program (its fetch is read after the loop), so a fold that ends
        the mine leaves no resolve dispatch.  ``segment`` (with ``l_max``
        the checkpoint cadence): the fused engine's checkpoint segment,
        seeded mid-lattice where levels may grow: 2x row headroom, flat
        slot caps, an uncompacted prefix budget.

        ``bitmap`` / ``w_digits``: the level loop's per-position lists
        (a 1-D mesh: one per transaction shard).  Under a sparse mine
        (``red``) the fold's per-iteration reduction runs sparse above
        ``count_sparse_min`` slots; a union past its budget ends the fold
        at that level (the level engine resumes), records
        ``count_sparse_overflow`` and remembers the grown budget."""
        cfg = self.config
        ctx = self.ctx
        n0, k0 = cur.shape
        t_pad, f_pad = bitmap[0].shape[0] * ctx.txn_shards, bitmap[0].shape[1]
        if l_max is None:
            l_max = cfg.tail_fuse_l_max
        # No 2x headroom outside a segment: in a shrinking tail the seed
        # is the largest level, and the [m, m] candidate products are the
        # memory wall.
        m_cap = max(next_pow2(2 * n0 if segment else n0),
                    cfg.min_prefix_bucket, next_pow2(l_max + 2))
        if m_cap > fused_m_cap_memory_limit(
                cfg, ctx, t_pad, f_pad, n_chunks, unpacked_resident=True,
                cap=m_cap, tail_chunked=True):
            return [], False, False
        if segment:
            # Every row of a mid-lattice seed may extend.
            p_cap = m_cap
        else:
            # The prefix budget grows with large seeds; at or below
            # 16,384 rows the knob keeps its configured value.
            p_cap = cfg.tail_fuse_p_cap
            if m_cap > 16384:
                p_cap = max(p_cap, m_cap // 8)
            p_cap = min(p_cap, m_cap)
        # The [t_c, p_cap] membership is narrower than the level
        # engine's: fewer, larger chunks while it stays <= 768 MiB.
        tail_chunks = n_chunks
        per_dev = t_pad // ctx.txn_shards
        while (tail_chunks % 2 == 0
               and (per_dev // (tail_chunks // 2)) * p_cap * 4
               <= (768 << 20)):
            tail_chunks //= 2
        sp_cap = None
        sp_key = ("sparse_tail", t_pad, f_pad, int(data.min_count))
        if red is not None and red["engine"] == "sparse":
            if p_cap * f_pad >= cfg.count_sparse_min:
                sp_cap = self._sparse_cap(p_cap * f_pad, hint_key=sp_key)
            else:
                ledger.record("count_reduce_fallback", once_key="tiny_tail",
                              reason="tiny_candidate_set", site="tail",
                              p_cap=p_cap)
        seed = np.zeros((m_cap, k0), np.int32)
        seed[:n0] = cur
        resolve_flat = []
        if pending_state is not None:
            pending_map, drained, pending_bytes = pending_state
            resolve_flat = [(idx, c, p) for idx in sorted(pending_map)
                            for c, p in pending_map[idx] if p.size]
        # Segments run only under a checkpoint prefix, which fetches
        # counts eagerly: nothing is ever pending there.
        assert not (segment and resolve_flat)
        with self.metrics.timed("tail_fuse", k0=k0, m_cap=m_cap, p_cap=p_cap,
                                n_chunks=tail_chunks, l_max=l_max,
                                checkpoint_segment=segment) as met:
            fn = make_tail_miner(scales, k0, m_cap, p_cap, l_max,
                                 tail_chunks, heavy is not None,
                                 flat_caps=segment, sparse_cap=sp_cap,
                                 groups=ctx.exchange_spec if sp_cap else None)
            args = (ctx.txn_parts(bitmap), ctx.txn_parts(w_digits),
                    ctx.upload(seed), n0, data.min_count, *(heavy or ()))
            thr = red["thr"] if sp_cap is not None else None
            if resolve_flat:
                out_dev, handle = fn(*args, sparse_thr=thr,
                                     region=ctx.sync_free,
                                     num_items=data.num_items, resolve=(
                    [(c, p) for _, c, p in resolve_flat],
                    data.n_raw < 2**24))
                drained.append(
                    ([(i, p.size) for i, _, p in resolve_flat], handle))
                pending_map.clear()
                pending_bytes[0] = 0
                met.update(resolve_levels=len({i for i, _, _ in
                                               resolve_flat}),
                           resolve_folded=True)
            else:
                out_dev = fn(*args, sparse_thr=thr, region=ctx.sync_free,
                             num_items=data.num_items)
            out = ctx.fetch(out_dev, "tail")
            rows, cols, counts, n_lvl, incomplete, snu = unpack_tail_result(
                out, m_cap, l_max, flat=segment)
            if sp_cap is not None and snu > sp_cap:
                # The union overflowed at some level: that level carries
                # the sentinel, so the level engine resumes before it.
                ledger.record("count_sparse_overflow", site="tail",
                              n_union=int(snu), cap=sp_cap)
                watchdog.downgrade("count_reduce", "sparse", "dense",
                                   reason="union_overflow", site="tail")
                ctx.record_pair_cap(sp_key, next_pow2(int(snu)))
            n_iters = max(int(np.count_nonzero(n_lvl)), 1)
            info = self._reduce_info(p_cap * f_pad, sp_cap)
            met.update(
                levels=int(np.count_nonzero(n_lvl)),
                incomplete=incomplete, reduce=info["reduce"],
                macs=n_iters * (2 * m_cap * m_cap * f_pad
                                + (1 + len(scales)) * t_pad * p_cap * f_pad),
                upload_bytes=seed.nbytes,
            )
            if ctx.txn_shards > 1:
                met.update(**{k: n_iters * v if k.endswith("_bytes") else v
                              for k, v in info.items() if k != "reduce"})
                if sp_cap is not None:
                    met.update(n_union=int(snu))
            self._device_peak(met)
            lvls = decode_level_matrices(
                rows, cols, counts, n_lvl,
                max_rows=tail_slot_caps(m_cap, l_max, flat=segment),
                prev=cur)
            met.update(complete_levels=len(lvls))
        return lvls, not incomplete, True

    def _count_level(
        self,
        table,
        weights,
        scales,
        level: np.ndarray,
        min_count: int,
        heavy: Optional[tuple],
        vertical: bool = False,
        defer: bool = False,
        red: Optional[dict] = None,
    ) -> Tuple[np.ndarray, object, dict]:
        """C7 + C8 for one level: candidates on the host, counts through
        K1 (``table`` the bitmap, ``weights`` its weight digits) or,
        with ``vertical``, through K3 (``table`` the tid-lane arena,
        ``weights`` its weight bit-planes), survivors at ``min_count``.
        ``table`` and ``weights`` are the mesh's per-position lists.

        Every chunk is issued (pinned uploads, no host wait) before the
        level's one host read: the survivor bitmask, packed on the
        device (``fetch.level_bits`` / ``fetch.vlevel_bits``).  The
        per-candidate counts stay on the device: with ``defer`` the
        second return is ``[(counts_dev, survivor positions)]`` for the
        loop's resolve, else the host int64 counts of the survivors
        (``fetch.level_counts``).  Returns the next level's lex-sorted
        matrix, its counts and per-level stats.

        On a mesh of more than one device each chunk runs K1 or K3 once
        per shard (:meth:`_count_chunk`) and the counts cross the
        shards through the mine's reduction (``red``); a sparse level's
        union censuses ride the bitmask fetch (``fetch.level_bits_sparse``
        / ``fetch.vlevel_bits_sparse``).  A union past its budget, or a
        transient that outlasted that fetch's retries (after walking the
        exchange and the reduction), recounts the level dense; the
        level's stats add the wasted launches and bytes.

        ``FA_NO_PALLAS`` on CUDA (device.py ``plain_kernels``) counts
        with K1's or K3's plain version on the card instead, and the
        level's stats say ``plain_kernels``.  A vertical level's stats
        add ``vops`` and ``member_bytes_saved`` (ops/vertical.py) summed
        over its launches at their shapes (one block; real candidates,
        which is what K3 and its plain version count)."""
        ctx = self.ctx
        s = level.shape[1]
        f_pad = table[0].shape[0] - 1 if vertical else table[0].shape[1]
        plain = ctx.plain_kernels()
        x_idx, ys = concat_blocks(gen_candidates_stream(level))
        stats = {"candidates": int(x_idx.size), "launches": 0, "p_cap": 0}
        if plain:
            stats["plain_kernels"] = True
        if vertical:
            stats.update(engine="vertical", vops=0, member_bytes_saved=0)
            if not quorum.stage_allowed("vertical_kernel", "cuda"):
                # A peer walked its vertical kernel tier.  The port's
                # collectives are the same shape either way and K3 stays
                # on the card: the floor is recorded, not followed.
                ledger.record("vertical_kernel_floor", once_key="quorum",
                              floor=quorum.floor_stage("vertical_kernel"),
                              kept="cuda")
        empty = (np.empty((0, s + 1), dtype=np.int32),
                 np.empty(0, dtype=np.int64), stats)
        if x_idx.size == 0:
            return empty
        parts = []
        nus: list = []  # (union census tensor, cap) per sparse reduction
        for prefix_cols, cand_idx, _ in level_chunks(
            level, x_idx, ys, f_pad, self.config
        ):
            got = self._count_chunk(
                table, weights, scales, prefix_cols, cand_idx, f_pad,
                min_count, heavy, vertical, plain, red, stats, nus)
            parts.append(got)
            stats["p_cap"] = max(stats["p_cap"], prefix_cols.shape[0])
        counts_dev = torch.cat(parts) if len(parts) > 1 else parts[0]
        payload = survivor_bits(counts_dev, min_count)
        t0 = time.perf_counter()
        recount = None
        try:
            if nus:
                # The union censuses ride the bitmask: 4 little-endian
                # bytes per sparse reduction.
                payload = torch.cat([payload, torch.stack(
                    [nu for nu, _ in nus]).to(torch.int32).view(torch.uint8)])
                bits = ctx.fetch_async(
                    payload,
                    "vlevel_bits_sparse" if vertical else "level_bits_sparse")
            else:
                bits = ctx.fetch_async(
                    payload, "vlevel_bits" if vertical else "level_bits")
            got_bits = bits.result()
        except Exception as exc:
            if not nus or not retry.exhausted(exc):
                raise
            self._sparse_walk(exc, "vlevel" if vertical else "level", red,
                              k=s + 1)
            recount = "transient_exhausted"
        else:
            if nus:
                census = np.frombuffer(
                    got_bits[-4 * len(nus):].tobytes(), dtype="<i4")
                got_bits = got_bits[: -4 * len(nus)]
                stats["n_union"] = int(census.max())
                over = [int(v) for v, (_, cap) in zip(census, nus)
                        if v > cap]
                if over:
                    recount = "union_overflow"
                    max_nu = max(over)
                    ledger.record("count_sparse_overflow",
                                  site="vlevel" if vertical else "level",
                                  k=s + 1, n_union=max_nu)
                    watchdog.downgrade(
                        "count_reduce", "sparse", "dense",
                        reason="union_overflow",
                        site="vlevel" if vertical else "level", k=s + 1)
                    ctx.record_pair_cap(self._sparse_level_key(
                        table, f_pad, min_count, vertical), next_pow2(max_nu))
        if recount is not None:
            del counts_dev, parts
            nxt_d, cnts_d, stats_d = self._count_level(
                table, weights, scales, level, min_count, heavy,
                vertical=vertical, defer=defer,
                red={"engine": "dense", "thr": None})
            # The sparse attempt's launches and bytes were spent too.
            for key in ("launches", "vops", "member_bytes_saved",
                        "psum_bytes", "gather_bytes"):
                if key in stats:
                    stats_d[key] = stats_d.get(key, 0) + stats[key]
            if recount == "union_overflow":
                stats_d["sparse_overflow"] = stats["n_union"]
            stats_d["recount"] = recount
            return nxt_d, cnts_d, stats_d
        keep = np.unpackbits(got_bits, count=x_idx.size).astype(bool)
        stats["fetch_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
        if not keep.any():
            return empty
        nxt = np.concatenate(
            [level[x_idx[keep]], ys[keep, None]], axis=1
        ).astype(np.int32)
        # Candidates arrive in (x_idx, y) order over a lex-sorted level,
        # so nxt is lex-sorted — the invariant the next join needs — and
        # the survivor positions follow its rows.
        if defer:
            return nxt, [(counts_dev, np.flatnonzero(keep))], stats
        counts = ctx.fetch(counts_dev, "level_counts")[keep]
        return nxt, counts.astype(np.int64), stats

    def _sparse_level_key(self, table, f_pad: int, min_count: int,
                          vertical: bool) -> tuple:
        """The grown-budget hint key of a level's sparse reductions."""
        t_pad = (table[0].shape[1] * 32 if vertical
                 else table[0].shape[0]) * self.ctx.txn_shards
        return ("sparse_vlevel" if vertical else "sparse_level", t_pad,
                f_pad, int(min_count))

    def _count_chunk(self, table, weights, scales,
                     prefix_cols: np.ndarray, cand_idx: np.ndarray,
                     f_pad: int, min_count: int, heavy: Optional[tuple],
                     vertical: bool, plain: bool, red: Optional[dict],
                     stats: dict, nus: list) -> torch.Tensor:
        """One :func:`level_chunks` launch over the mesh: the prefix rows
        split into ``cand_shards`` contiguous blocks (candidate block c
        takes rows ``[c·p_sh, (c+1)·p_sh)`` and their candidates, at
        local flat positions); for each block K1 (or K3) runs once per
        transaction shard over that shard's rows (lanes), shard 0 adding
        the heavy remainder; each block's per-shard counts, padded with
        zeros to ``c_cap / C`` slots (``c_cap`` the JAX package's
        candidate budget of the launch; more when a block holds more
        candidates), cross the shards through the
        dense psum or, above ``count_sparse_min`` slots of a sparse mine,
        the threshold-sparse exchange (its union census appended to
        ``nus``); the blocks' counts concatenate in cand order on shard
        0's device.  ``stats`` gains the launches and the reduction's
        payload fields.  On one device: one launch, nothing padded, the
        counts as they come."""
        ctx = self.ctx
        cfg = self.config
        s = prefix_cols.shape[1]
        n_c = int(cand_idx.size)
        c_shards = ctx.cand_shards
        c_cap = min(max(next_pow2(n_c), f_pad),
                    max(cfg.level_cand_cap, f_pad))
        sp_cap = None
        if red is not None and red["engine"] == "sparse":
            if c_cap >= cfg.count_sparse_min:
                sp_cap = self._sparse_cap(c_cap, hint_key=self._sparse_level_key(
                    table, f_pad, min_count, vertical))
            else:
                ledger.record("count_reduce_fallback", once_key="tiny_level",
                              reason="tiny_candidate_set",
                              site="vlevel" if vertical else "level",
                              k=s + 1, c_cap=c_cap)
        p_cap = prefix_cols.shape[0]
        p_sh = -(-p_cap // c_shards)
        zcol = f_pad - 1
        rows = cand_idx // f_pad
        ys = cand_idx % f_pad
        bounds = np.searchsorted(rows, np.arange(c_shards + 1) * p_sh)
        one = ctx.n_devices == 1
        c_blk = n_c if one else pad_axis(
            max(-(-c_cap // c_shards), int(np.diff(bounds).max())), 8)
        info = self._reduce_info(c_blk, sp_cap)
        if vertical:
            count = vertical_counts_plain if plain else vertical_level_local
            lane_tile = self._vertical_lane_tile()
            chunk = self._vertical_chunk(c_cap)
        else:
            count = level_counts_plain if plain else level_counts
        outs = []
        for c in range(c_shards):
            lo = c * p_sh
            pc = np.full((p_sh, s), zcol, dtype=np.int32)
            real = prefix_cols[lo : lo + p_sh]
            pc[: real.shape[0]] = real
            a, b = int(bounds[c]), int(bounds[c + 1])
            ci = (rows[a:b] - lo) * f_pad + ys[a:b]
            devs = ctx.mesh.txn_devices(c)
            pcs = ctx.place(pc, devs, non_blocking=True)
            cis = ctx.place(ci.astype(np.int32) if vertical else ci, devs,
                            non_blocking=True)
            local = []
            for t in range(ctx.local_txn_shards):
                i = t * c_shards + c
                if vertical:
                    got = count(table[i], weights[i], scales, pcs[t], cis[t],
                                chunk, lane_tile)
                    nl = table[i].shape[1]
                    stats["launches"] += 1
                    stats["vops"] += vertical_level_word_ops(
                        1, p_sh, s, b - a, len(scales), nl)
                    stats["member_bytes_saved"] += vertical_member_bytes(
                        1, p_sh, nl)
                else:
                    hb = hw = None
                    if heavy is not None and t == 0:
                        hb, hw = (mesh.broadcast(x, devs[:1])[0]
                                  for x in heavy)
                    got = local_level_gather(
                        table[i], weights[i], scales, pcs[t], s, cis[t],
                        heavy_b=hb, heavy_w=hw, count_fn=count)
                    stats["launches"] += len(scales)
                local.append(got if one else torch.cat(
                    [got, got.new_zeros(c_blk - (b - a))]))
            if sp_cap is not None:
                summed, nu = local_sparse_psum(local, red["thr"], sp_cap,
                                               groups=ctx.exchange_spec)
                nus.append((nu, sp_cap))
            else:
                summed = dense_psum(local)
            outs.append(summed[: b - a])
        if not one:
            for key, val in info.items():
                if key.endswith("_bytes"):
                    stats[key] = stats.get(key, 0) + c_shards * val
                else:
                    stats[key] = val
        # The candidate blocks of this process's mesh, in cand order.
        return mesh.flat_tiled_all_gather(outs)
