"""Miner, recommender and serving knobs (counterpart:
fastapriori_tpu/config.py).

Only the ``MinerConfig`` fields the batch mine + recommend path, the
one-process device mesh and the one-process serving tier read are
carried over, with the reference package's defaults.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# Reference default: Main.scala:23.
DEFAULT_MIN_SUPPORT = 0.092

ENGINES = ("auto", "fused", "level")

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
    # Transaction-axis chunk of the bitmap layout's folds: the bitmap's
    # transaction axis is padded to whole chunks of about this many raw
    # transactions, which the tail fold and the fused engine over the
    # resident bitmap count chunk by chunk, bounding their [chunk, rows]
    # membership intermediates.  The pair program's level 3 counts with
    # K1 (ops/count.py ``l3_threshold_pack``) and does not chunk.
    level_txn_chunk: int = 1 << 14
    # Survivor budget of the on-device pair threshold (ops/count.py
    # ``pair_threshold_pack``): the packed fetch holds 2 * pair_cap + 2
    # int32.  More frequent pairs than this re-extract once at the next
    # power of two over the resident count matrix, and the grown budget
    # is remembered for repeat runs on the same DeviceContext.
    pair_cap: int = 1 << 14
    # Level 3 inside the ingest-overlapped pair program (ops/count.py
    # ``l3_threshold_pack``): pair_l3_rows frequent pairs are counted as
    # K1's prefix rows (the rows past the true pair count are padding K1
    # skips on the device), pair_l3_cap level-3 survivors are extracted.
    # More pairs or more survivors fall back to the level loop for level
    # 3 and remember the grown budgets; 0 rows turns the fold off.
    pair_l3_rows: int = 1 << 13
    pair_l3_cap: int = 1 << 14
    # Deferred survivor counts (models/apriori.py ``_level_loop``): each
    # level's per-candidate count tensors stay on the device for the one
    # gather after the loop; once their bytes exceed this budget the loop
    # drains them early (one gather compacts the survivors and frees the
    # tensors, its fetch is read after the loop).
    pending_fetch_budget_bytes: int = 256 << 20
    # Recommender: rules per chunk of the padded rule table, and basket
    # rows per first-match micro-batch (pow2-bucketed, floor 32).
    rule_chunk: int = 1 << 13
    rec_batch_rows: int = 1 << 12
    # Serving tier (serve/server.py): the most milliseconds a partial
    # micro-batch waits to fill before it is dispatched anyway (0: at
    # once), and the admission queue's bound in requests, past which a
    # submit is shed ("0", counted, recorded); 0 = 4x the micro-batch
    # rows.
    serve_linger_ms: float = 2.0
    serve_queue_depth: int = 0
    # Mining engine: "auto" runs the fused whole-loop engine
    # (ops/fused.py) when the level-2 survivor budget (2x headroom) and
    # the level-3 candidate census both fit the memory-derived row-budget
    # ceiling, else the level engine; "fused" forces the fused attempt
    # (complete levels salvaged into the level engine when the row
    # budget or the level bound is hit); "level" runs one K1 launch per
    # prefix chunk of each level, with the shallow-tail fold below.
    engine: str = "auto"
    # Fused engine: floor of the starting row budget (sized from the
    # level-2 survivor count); on overflow the budget jumps to the
    # overflowing level's true need, up to the ceiling min(fused_m_cap_max,
    # what fits the memory budget: models/apriori.py
    # ``fused_m_cap_memory_limit``), then the level engine takes over.
    fused_m_cap: int = 512
    fused_m_cap_max: int = 32768
    # Memory budget for that ceiling.  None = fused_hbm_fraction of the
    # device's memory (16 GiB assumed on the CPU); tests set a tiny
    # budget to drive the memory skip.
    fused_hbm_budget_bytes: Optional[int] = None
    fused_hbm_fraction: float = 0.5
    # Fused engine: levels held in the output (the l_max bound).
    fused_l_max: int = 24
    # Shallow-tail fold of the level engine: once a level k >= 4 seed has
    # at most this many rows, the remaining levels run as one seeded
    # device loop (ops/fused.py ``tail_mine``).  None = 65,536 on CUDA
    # and off on the CPU; 0 turns it off; an explicit value forces it on
    # any device.
    tail_fuse_rows: Optional[int] = None
    # Tail fold: compacted prefix rows per iteration and the levels one
    # fold may mine; overflowing either resumes the level engine from the
    # last complete level.
    tail_fuse_p_cap: int = 2048
    tail_fuse_l_max: int = 8
    # Fused engine (packed upload): transactions per chunk of its
    # membership and count products.
    fused_txn_chunk: int = 1 << 17
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
    # intermediate; the CUDA kernel does not read it): pow2-bucketed,
    # then halved until it divides the launch's candidate budget
    # (models/apriori.py ``_vertical_chunk``).  FA_VERTICAL_CHUNK
    # overrides, strictly parsed.
    vertical_cand_chunk: int = 1 << 12
    # Lanes (32-bit words of the tid axis) per streamed slab of K3's
    # plain version (bounds its [P, lane_tile] prefix intermediate;
    # pow2-bucketed, floor 128).  K3 itself streams 512-lane chunks and
    # does not read it.  FA_VERTICAL_LANE_TILE overrides, strictly
    # parsed.
    vertical_lane_tile: int = 1 << 13
    # The device mesh (parallel/mesh.py): transaction shards times
    # candidate blocks.  num_devices None = every visible CUDA card (one
    # shard on the CPU); cand_devices splits them into a (txn, cand)
    # grid whose cand axis shares out each level's prefix rows.
    num_devices: Optional[int] = None
    cand_devices: int = 1
    # Count reduction across transaction shards: "auto" (the
    # threshold-sparse exchange on two or more transaction shards of a
    # 1-D mesh, else the dense psum), "dense", or "sparse" (forced; on
    # one shard or a cand mesh it falls back to dense with a
    # `count_reduce_fallback` event and a `count_reduce` cascade walk,
    # as the JAX package does).  FA_COUNT_REDUCE overrides, strictly
    # parsed.
    count_reduce: str = "auto"
    # Sparse exchange: union-compaction slots per reduction (ops/count.py
    # ``sparse_union_cap``); None = n_candidates / 16 in a pow2 bucket,
    # floor 1,024.  A union past it redoes that reduction dense and
    # remembers the grown budget.  FA_COUNT_SPARSE_CAP overrides,
    # strictly parsed.
    count_sparse_cap: Optional[int] = None
    # Below this many candidate slots a reduction stays dense even when
    # the mine runs sparse.
    count_sparse_min: int = 4096
    # Two-level exchange (parallel/hier.py): 0 = auto (the divisor of S
    # nearest below its square root from S = 8, else flat), 1 = flat,
    # any other value must divide the transaction shards.
    # FA_EXCHANGE_GROUPS overrides, strictly parsed.
    exchange_groups: int = 0
    # Shards of the device rule join (rules/gen.py
    # ``resolve_rule_shards``): 0 = auto, 1 = shard 0's device.  The
    # port has the one-shard join only; a value above 1 (or
    # FA_RULE_SHARDS above 1) is an InputError.
    rule_shards: int = 0
    # Host threads for the native ingest.  None = one thread per core;
    # FA_INGEST_THREADS overrides, strictly parsed.
    ingest_threads: Optional[int] = None
    # Pipelined capture ingest (models/apriori.py
    # ``_run_file_pipelined_capture``): one native call cuts D.dat into
    # this many line-aligned blocks, and each block's packed bitmap goes
    # up to the device while the next block is compressed.  <= 1 turns
    # the pipeline off (one-call scan, then the bitmap build).
    ingest_pipeline_blocks: int = 8
    # Keep the whole basket CSR in the CompressedData the pipelined
    # ingest returns.  Mining does not read it there (the bitmap is
    # packed block by block, heavy rows are pulled out in the block
    # callback), so the CLI sets False; the library keeps the
    # documented CompressedData contract by default.
    retain_csr: bool = True
    # Rule generation engine (rules/gen.py ``_pick_rule_engine``):
    # "auto" runs the device join + dominance prune (one join per level,
    # ops/contain.py ``rule_level_kernel``) when a device context is
    # given, the raw rule count reaches `rule_device_min_rules`, every
    # itemset count is < 2^24 (the exact-compare gate) and the device is
    # not the CPU; "host" forces the numpy engine; "device" forces the
    # device engine on any device (still the host engine, with a
    # `rule_gen_fallback` metrics event, without a context or past the
    # count gate).  FA_RULE_ENGINE overrides, strictly parsed.
    rule_engine: str = "auto"
    # Raw rules (Σ k·N_k over the levels) from which auto takes the
    # device engine: the JAX package's floor, kept until H100 runs set
    # the port's own (PERF.md, "rule crossover").
    rule_device_min_rules: int = 1 << 21
    # Per-level checkpoints (io/checkpoint.py): after every completed
    # level, atomically rewrite <checkpoint_prefix>checkpoint.npz and its
    # manifest entry, so an interrupted mine resumes from the deepest
    # completed level (FastApriori.set_resume_levels, the CLI's
    # --resume-from).  A durable level carries its counts, so the level
    # loop fetches them eagerly.  engine "auto"/"level" skip the fused
    # whole-loop engine (it has no mid-points); engine "fused" mines in
    # segments instead (below).  None disables (the default).
    checkpoint_prefix: Optional[str] = None
    # With engine="fused" and a checkpoint prefix: levels per device
    # segment (the tail program with 2x row headroom and flat slot caps),
    # a durable checkpoint after each.
    checkpoint_every_levels: int = 1
    # Emit per-phase structured metrics as JSON lines on stderr.
    log_metrics: bool = False
