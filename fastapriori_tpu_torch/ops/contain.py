"""First-match rule scan around K2 (counterpart: fastapriori_tpu/ops/
contain.py ``local_strided_match_scan`` and ``_strided_merge`` at one
shard, plus the table layout of fastapriori_tpu/models/recommender.py
``_rule_table_device``; reference C12, AssociationRules.scala:88-102).

At one shard the rank-strided table is the host's priority order itself:
local row i holds global rank i.  The kernel returns each basket's best
rank; the consequent is selected outside it, as ``_strided_merge`` does.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from fastapriori_tpu_torch.ops.bitmap import next_pow2, pad_axis
from fastapriori_tpu_torch.ops.match_kernel import NO_MATCH, first_match


def rule_table(
    ant0: np.ndarray,  # [R, k_max] int32, 0-padded (read lens)
    lens: np.ndarray,  # [R] antecedent sizes
    cons: np.ndarray,  # [R] consequent ranks
    num_items: int,
    f_pad: int,
    rule_chunk: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Padded device layout of the priority-sorted rules: ``(ant int32
    [R_pad, k_max], size int32 [R_pad], consequent int32 [R_pad])``.
    Antecedent padding positions point at the all-zero basket column
    ``f_pad - 1``; padding rules have size ``num_items + 1`` (> any basket
    length) and consequent 0.  R_pad is a power-of-two number of
    ``chunk``-row chunks, the chunk scaled so a full table walk is about
    256 chunks (the reference package's bucketing)."""
    r = len(cons)
    chunk = min(next_pow2(max(1, rule_chunk, -(-r // 256))), 1 << 16)
    chunk = pad_axis(chunk, 128)
    r_pad = chunk * next_pow2(max(-(-r // chunk), 1))
    k_max = ant0.shape[1] if r else 1
    ant = np.full((r_pad, k_max), f_pad - 1, dtype=np.int32)
    if r > 0:
        mask = np.arange(k_max)[None, :] < lens[:, None]
        ant[:r][mask] = ant0[mask]
    size = np.full(r_pad, num_items + 1, dtype=np.int32)
    size[:r] = lens
    consequent = np.zeros(r_pad, dtype=np.int32)
    consequent[:r] = cons
    return ant, size, consequent


def strided_match_scan(
    baskets: torch.Tensor,  # [mb, F] int8 micro-batch
    basket_len: torch.Tensor,  # [mb] int32 (0 on padding rows)
    ant: torch.Tensor,  # [R, K] int32
    size: torch.Tensor,  # [R] int32
    consequent: torch.Tensor,  # [R] int32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-shard first-match: ``(best rank [mb], consequent or -1 [mb])``
    — K2 for the rank, then the owner-row consequent select of
    ``_strided_merge`` at S=1 (rank == row)."""
    best = first_match(baskets, basket_len, ant, size, consequent)
    row = best.clamp(0, ant.shape[0] - 1).long()
    found = best < NO_MATCH
    cons = torch.where(found, consequent[row], torch.full_like(best, -1))
    return best, cons
