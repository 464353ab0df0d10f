"""Miner and recommender knobs (counterpart: fastapriori_tpu/config.py).

Only the ``MinerConfig`` fields the batch mine + recommend path reads are
carried over, with the reference package's defaults.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# Reference default: Main.scala:23.
DEFAULT_MIN_SUPPORT = 0.092

ENGINES = ("auto", "level")

# Mining layouts (models/apriori.py ``FastApriori._mine_engine``).
MINE_ENGINES = ("auto", "bitmap", "vertical")


@dataclasses.dataclass
class MinerConfig:
    """Knobs for the mining engine and its device kernels."""

    min_support: float = DEFAULT_MIN_SUPPORT
    # Prefix rows of one level-count launch are padded to a power of two
    # no smaller than this.
    min_prefix_bucket: int = 128
    # The transaction axis is padded to a multiple of this.
    txn_tile: int = 8
    # The item axis is padded to a multiple of this, with at least one
    # all-zero column beyond the real items (ops/bitmap.py).
    item_tile: int = 128
    # Candidates and prefix rows per level-count launch.
    level_cand_cap: int = 1 << 18
    level_prefix_cap: int = 1 << 14
    # Recommender: rules per chunk of the padded rule table, and basket
    # rows per first-match micro-batch (pow2-bucketed, floor 32).
    rule_chunk: int = 1 << 13
    rec_batch_rows: int = 1 << 12
    # "auto" resolves to "level" in this port (the fused whole-loop
    # engine is not ported yet); "level" runs one K1 launch per prefix
    # chunk of each level.
    engine: str = "auto"
    # Mining layout: "bitmap" counts with the transaction x item bitmap
    # (K1); "vertical" with per-item packed tid lanes (the Eclat-style
    # engine, K3); "auto" picks vertical when at least
    # `vertical_min_items` items are frequent and the density
    # Σ item_counts / (n_raw · F) is at most `vertical_density_max`.
    # FA_MINE_ENGINE overrides, strictly parsed.
    mine_engine: str = "auto"
    vertical_density_max: float = 0.01
    vertical_min_items: int = 512
    # Candidates per step of K3's plain version (bounds its [chunk, NL]
    # intermediate; the CUDA kernel does not read it).
    vertical_cand_chunk: int = 1 << 12
    # Host threads for the native ingest and the arena build's reduce
    # pass.  None = one thread per core; FA_INGEST_THREADS overrides,
    # strictly parsed.
    ingest_threads: Optional[int] = None
    # Emit per-phase structured metrics as JSON lines on stderr.
    log_metrics: bool = False
