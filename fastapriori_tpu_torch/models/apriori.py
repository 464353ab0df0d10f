"""Mining engine (counterpart: fastapriori_tpu/models/apriori.py
``FastApriori.run_file_raw`` on the level engine — ``_mine_levels``,
``_split_weights``, ``_mine_engine``, ``_mine_vertical``,
``_level_loop_impl`` and ``_count_level`` without the elastic, quorum,
checkpoint, fused, tail, sparse, lane-tiled and pipelined-ingest
branches; reference C6-C9, FastApriori.scala:31-160).

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

``engine="auto"`` resolves to ``"level"`` and says so in the metrics
line: the fused whole-loop engine of the reference package has no Pallas
kernel and waits for a later slice of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Tuple

import numpy as np

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
    next_pow2,
    pad_axis,
    weight_digits,
)
from fastapriori_tpu_torch.ops.count import (
    frequent_pair_mask,
    heavy_pair_correction,
    local_level_gather,
    local_pair_counts,
)
from fastapriori_tpu_torch.ops.vertical import (
    PAIR_TXN_CHUNK,
    build_tid_arena_csr,
    compress_arena,
    vertical_level_local,
    vertical_pair_local,
    weight_bit_planes,
)
from fastapriori_tpu_torch.preprocess import (
    CompressedData,
    ingest_thread_count,
    native_choice,
    preprocess_file,
)
from fastapriori_tpu_torch.utils.env import env_choice
from fastapriori_tpu_torch.utils.logging import MetricsLogger

Levels = List[Tuple[np.ndarray, np.ndarray]]

# Heavy-row remainder bounds: above either, the engine runs every weight
# digit through K1 instead (the remainder arrays would no longer be tiny).
HEAVY_SPLIT_CAP = 4096
HEAVY_SPLIT_BYTES = 16 << 20


def resolve_engine(engine: str) -> str:
    if engine == "fused":
        raise InputError(
            "engine 'fused' is not ported yet: the JAX package's fused "
            "whole-loop engine (its ops/fused.py) comes in a later slice of "
            "the PyTorch port; use 'level' or 'auto'"
        )
    if engine not in ENGINES:
        raise InputError(
            f"unrecognized engine {engine!r}: use one of {'/'.join(ENGINES)}"
        )
    return "level"


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
):
    """Single-low-digit weight split (reference ``_split_weights``):
    every row runs the kernels with ``w % 128`` and the exact remainder
    ``w - w % 128`` of the rows with multiplicity >= 128 rides a small
    heavy-row bitmap.  Returns ``(w_digits int8[D, T_pad], scales,
    heavy_b | None, heavy_w | None)``; heavy None = every digit goes
    through the kernels (no heavy rows, or too many)."""
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
    baskets = [indices[offsets[i] : offsets[i + 1]] for i in heavy_idx]
    heavy_b = build_bitmap(baskets, num_items, 8, item_tile)
    heavy_w = np.zeros(heavy_b.shape[0], dtype=np.int32)
    heavy_w[: heavy_idx.size] = weights[heavy_idx] - (weights[heavy_idx] % 128)
    return w_digits, scales, heavy_b, heavy_w


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
    """Mining engine; API mirrors the reference class
    (``FastApriori(min_support).run_file_raw(path)``).  ``device``:
    ``None``/``"cuda"`` (the default: InputError without a GPU) or
    ``"cpu"`` (every kernel wrapper runs its plain version)."""

    def __init__(
        self,
        min_support: Optional[float] = None,
        config: Optional[MinerConfig] = None,
        device=None,
    ):
        self.config = (
            dataclasses.replace(config) if config is not None else MinerConfig()
        )
        if min_support is not None:
            self.config.min_support = min_support
        self.engine = resolve_engine(self.config.engine)
        self.ctx = DeviceContext(device)
        self.metrics = MetricsLogger(enabled=self.config.log_metrics)

    def run_file_raw(self, d_path: str) -> Tuple[Levels, CompressedData]:
        """Mine ``D.dat``: returns the level matrices (k >= 2) and the
        preprocessed data (item tables, 1-itemset counts)."""
        # Parsed before the ingest, so a bad FA_INGEST_THREADS fails every
        # run and not only a vertical one (the arena build reads it).
        ingest_thread_count(self.config.ingest_threads)
        with self.metrics.timed("preprocess", path=d_path) as m:
            # A file always passes the native size gate.  The one-call
            # scan runs on one thread: the threaded block ingest dedups
            # each block apart, so its arrays are not these.
            native, reason = native_choice(None, 1 << 62)
            data = preprocess_file(d_path, self.config.min_support,
                                   native=native)
            m.update(
                n_raw=data.n_raw,
                min_count=data.min_count,
                num_items=data.num_items,
                total_count=data.total_count,
                native=native,
                threads=1,
            )
            if not native:
                m.update(native_reason=reason)
        return self.mine_levels_raw(data), data

    def mine_levels_raw(self, data: CompressedData) -> Levels:
        """Levels >= 2 as lex-sorted member matrices with counts."""
        if data.num_items < 2 or data.total_count == 0:
            return []
        layout, requested, density = self._mine_engine(data)
        self.metrics.emit(
            "mine_engine",
            engine=layout,
            requested=requested,
            density=round(density, 6),
            level_engine=self.engine,
            level_engine_requested=self.config.engine,
            device=str(self.ctx.device),
            note="auto resolves to level: the fused engine is not ported yet",
        )
        if layout == "vertical":
            return self._mine_vertical(data)
        return self._mine_levels(data)

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

    def _mine_engine(self, data: CompressedData) -> Tuple[str, str, float]:
        """Resolve the layout for this mine: returns ``(engine,
        requested, density)`` with engine "bitmap" or "vertical".  Auto
        picks vertical on sparse wide-item corpora: at least
        ``vertical_min_items`` frequent items and a density (see
        :func:`density_from_tables`) of at most ``vertical_density_max``.
        Data without the basket CSR stays bitmap under auto; a forced
        vertical then raises InputError."""
        req = self._requested_mine_engine()
        cfg = self.config
        density = density_from_tables(
            data.n_raw, data.num_items, float(np.sum(data.item_counts))
        )
        if req == "bitmap":
            return "bitmap", req, density
        if not has_csr(data):
            if req == "vertical":
                raise InputError(
                    "mine_engine 'vertical' needs the baskets as CSR "
                    "(basket_offsets of length total_count + 1); this "
                    "CompressedData has none"
                )
            return "bitmap", req, density
        if req == "vertical" or (
            data.num_items >= cfg.vertical_min_items
            and density <= cfg.vertical_density_max
        ):
            return "vertical", req, density
        return "bitmap", req, density

    def _pair_level(self, counts, min_count: int, f: int, f_pad: int):
        """Frequent pairs from the [f_pad, f_pad] pair count matrix:
        ``(int32[N, 2] lex-sorted, int64[N] counts)``."""
        ctx = self.ctx
        mask = frequent_pair_mask(counts, min_count, f)
        idx = mask.reshape(-1).nonzero().reshape(-1)
        cnt = ctx.fetch(counts.reshape(-1)[idx]).astype(np.int64)
        idx = ctx.fetch(idx)
        # Row-major upper triangle: already lex-sorted.
        cur = np.stack([idx // f_pad, idx % f_pad], axis=1).astype(np.int32)
        return cur, cnt

    def _mine_levels(self, data: CompressedData) -> Levels:
        cfg = self.config
        ctx = self.ctx
        f = data.num_items
        with self.metrics.timed("bitmap_build") as m:
            bitmap_np = build_bitmap_csr(
                data.basket_indices, data.basket_offsets, f, cfg.txn_tile,
                cfg.item_tile,
            )
            t_pad, f_pad = bitmap_np.shape
            w_digits_np, scales, heavy_b, heavy_w = split_weights(
                data.weights, t_pad, data.basket_indices,
                data.basket_offsets, f, cfg.item_tile,
            )
            bitmap = ctx.upload(bitmap_np)
            w_digits = ctx.upload(w_digits_np)
            heavy = (
                (ctx.upload(heavy_b), ctx.upload(heavy_w))
                if heavy_b is not None
                else None
            )
            m.update(shape=[t_pad, f_pad], digits=len(scales),
                     heavy_rows=0 if heavy_w is None
                     else int(np.count_nonzero(heavy_w)))

        with self.metrics.timed("level", k=2) as m:
            # Exact in float32 while every count < 2^24; counts are bounded
            # by the raw transaction total.
            counts = local_pair_counts(
                bitmap, w_digits, scales, fast_f32=data.n_raw < 2**24
            )
            if heavy is not None:
                counts = counts + heavy_pair_correction(*heavy)
            cur, cnt = self._pair_level(counts, data.min_count, f, f_pad)
            m.update(candidates=f * (f - 1) // 2, frequent=int(cur.shape[0]))
        return self._level_loop(
            [(cur, cnt)], bitmap, w_digits, scales, data.min_count, heavy
        )

    def _mine_vertical(self, data: CompressedData) -> Levels:
        """Vertical (Eclat-style) mining: the tid-lane arena and weight
        bit-planes on the device, the pair phase as a Gram product over
        unpacked lane chunks, then the level loop the bitmap engine uses,
        counting with K3."""
        cfg = self.config
        ctx = self.ctx
        f = data.num_items
        n_threads = ingest_thread_count(cfg.ingest_threads)
        with self.metrics.timed("arena_build") as m:
            arena_np, f_pad, t_pad = build_tid_arena_csr(
                data.basket_indices, data.basket_offsets, f, 32,
                cfg.item_tile, n_threads=n_threads,
            )
            planes_np, scales = weight_bit_planes(
                np.asarray(data.weights, dtype=np.int64), t_pad
            )
            # Census first; the bucket fill and the device scatter only
            # when the compressed upload is at most half the dense one.
            _, payload, seg_stats = compress_arena(arena_np, f_pad,
                                                   build=False)
            use_compressed = payload * 2 <= arena_np.nbytes
            buckets = (
                compress_arena(arena_np, f_pad)[0] if use_compressed else None
            )
            arena, upload_bytes = ctx.upload_tid_arena(arena_np, buckets)
            w_planes = ctx.upload_lane_planes(planes_np)
            m.update(
                shape=[f_pad + 1, t_pad // 32],
                planes=len(scales),
                compressed=use_compressed,
                occupancy=seg_stats["occupancy"],
                upload_bytes=upload_bytes + planes_np.nbytes,
                threads=n_threads,
            )

        with self.metrics.timed("level", k=2) as m:
            n_chunks = max(1, -(-t_pad // PAIR_TXN_CHUNK))
            # Exact in float32 while every count < 2^24 (the bitmap
            # engine's gate); k >= 3 counts are integer popcounts.
            counts = vertical_pair_local(
                arena, w_planes, scales, n_chunks,
                fast_f32=data.n_raw < 2**24,
            )
            cur, cnt = self._pair_level(counts, data.min_count, f, f_pad)
            m.update(candidates=f * (f - 1) // 2, frequent=int(cur.shape[0]),
                     engine="vertical", chunks=n_chunks)
        return self._level_loop(
            [(cur, cnt)], arena, w_planes, scales, data.min_count,
            vertical=True,
        )

    def _level_loop(
        self,
        levels: Levels,
        table,
        weights,
        scales,
        min_count: int,
        heavy: Optional[tuple] = None,
        vertical: bool = False,
    ) -> Levels:
        """Levels >= 3 after the pair level, with the reference's
        termination rule (FastApriori.scala:111)."""
        cur = levels[-1][0]
        k = 3
        while cur.shape[0] >= k:
            with self.metrics.timed("level", k=k) as m:
                nxt, nxt_counts, stats = self._count_level(
                    table, weights, scales, cur, min_count, heavy,
                    vertical=vertical,
                )
                m.update(frequent=int(nxt.shape[0]), **stats)
            levels.append((nxt, nxt_counts))
            cur = nxt
            k += 1
        return levels

    def _count_level(
        self,
        table,
        weights,
        scales,
        level: np.ndarray,
        min_count: int,
        heavy: Optional[tuple],
        vertical: bool = False,
    ) -> Tuple[np.ndarray, np.ndarray, dict]:
        """C7 + C8 for one level: candidates on the host, counts through
        K1 (``table`` the bitmap, ``weights`` its weight digits) or,
        with ``vertical``, through K3 (``table`` the tid-lane arena,
        ``weights`` its weight bit-planes), survivors at ``min_count``.
        Returns the next level's lex-sorted matrix, its int64 counts and
        per-level stats."""
        ctx = self.ctx
        s = level.shape[1]
        f_pad = table.shape[0] - 1 if vertical else table.shape[1]
        x_idx, ys = concat_blocks(gen_candidates_stream(level))
        stats = {"candidates": int(x_idx.size), "launches": 0, "p_cap": 0}
        counts = np.zeros(x_idx.size, dtype=np.int64)
        hb, hw = heavy if heavy is not None else (None, None)
        for prefix_cols, cand_idx, sl in level_chunks(
            level, x_idx, ys, f_pad, self.config
        ):
            if vertical:
                got = vertical_level_local(
                    table, weights, scales, ctx.upload(prefix_cols),
                    ctx.upload(cand_idx.astype(np.int32)),
                    self.config.vertical_cand_chunk,
                )
                stats["launches"] += 1
            else:
                got = local_level_gather(
                    table, weights, scales, ctx.upload(prefix_cols),
                    s, ctx.upload(cand_idx), heavy_b=hb, heavy_w=hw,
                )
                stats["launches"] += len(scales)
            counts[sl] = ctx.fetch(got)
            stats["p_cap"] = max(stats["p_cap"], prefix_cols.shape[0])
        keep = counts >= min_count
        nxt = np.concatenate(
            [level[x_idx[keep]], ys[keep, None]], axis=1
        ).astype(np.int32)
        # Candidates arrive in (x_idx, y) order over a lex-sorted level,
        # so nxt is lex-sorted — the invariant the next join needs.
        return nxt, counts[keep], stats
