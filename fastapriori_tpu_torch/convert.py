"""Phase-1 state carried between the JAX package and this port.

The system has no weights: its state is the mining result —
``FastApriori.run_file_raw`` returns level matrices ``[(int32[N, k]
lex-sorted member matrix, int64[N] counts), ...]`` plus the item tables
(``freq_items``, ``item_to_rank``, per-rank ``item_counts``).  Both
packages use that same numpy layout, so conversion is validation and
normalization: :func:`from_jax_levels` turns the JAX miner's output into
this port's recommender, and :func:`to_jax_levels` gives this port's
miner output in the form the JAX package's ``AssociationRules(levels=...,
item_counts=...)`` takes.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from fastapriori_tpu_torch.config import MinerConfig
from fastapriori_tpu_torch.errors import InputError
from fastapriori_tpu_torch.models.recommender import AssociationRules

Levels = List[Tuple[np.ndarray, np.ndarray]]


def normalize_levels(levels, num_items: int) -> Levels:
    """int32 C-contiguous member matrices and int64 counts; raises
    InputError unless each level is ``[N, k]`` with ``k`` one more than
    the previous level's, rows strictly ascending with ranks in
    ``[0, num_items)``, and one count per row."""
    out: Levels = []
    for i, (mat, cnts) in enumerate(levels):
        mat = np.ascontiguousarray(np.asarray(mat), dtype=np.int32)
        cnts = np.ascontiguousarray(np.asarray(cnts), dtype=np.int64)
        k = i + 2
        if mat.ndim != 2 or mat.shape[1] != k or cnts.shape != (mat.shape[0],):
            raise InputError(
                f"level {i}: expected a [N, {k}] member matrix and [N] "
                f"counts, got {mat.shape} and {cnts.shape}"
            )
        if mat.size and (
            mat.min() < 0
            or mat.max() >= num_items
            or not (np.diff(mat, axis=1) > 0).all()
        ):
            raise InputError(
                f"level {i}: member ranks must be strictly ascending within "
                f"[0, {num_items})"
            )
        out.append((mat, cnts))
    return out


def from_jax_levels(
    levels,
    item_counts,
    freq_items: Sequence[str],
    item_to_rank: Dict[str, int],
    device=None,
    config: Optional[MinerConfig] = None,
) -> AssociationRules:
    """This port's recommender over a phase-1 result of the JAX package
    (``levels, data = FastApriori(...).run_file_raw(path)``, with
    ``data.item_counts``, ``data.freq_items``, ``data.item_to_rank``)."""
    counts = np.asarray(item_counts, dtype=np.int64)
    if counts.shape != (len(freq_items),):
        raise InputError(
            f"item_counts has shape {counts.shape}; expected one count per "
            f"frequent item ({len(freq_items)})"
        )
    return AssociationRules(
        [], freq_items, item_to_rank,
        levels=normalize_levels(levels, len(freq_items)),
        item_counts=counts, config=config, device=device,
    )


def to_jax_levels(levels, item_counts) -> Tuple[Levels, np.ndarray]:
    """This port's phase-1 result as the JAX package's recommender takes
    it: ``(levels, item_counts)``."""
    counts = np.asarray(item_counts, dtype=np.int64)
    return normalize_levels(levels, len(counts)), counts
