"""Support counting (counterpart: fastapriori_tpu/ops/count.py
``local_pair_counts``, ``heavy_pair_correction``,
``heavy_level_correction``, ``frequent_pair_mask`` and
``local_level_gather`` at ``axis_name=None``; reference C6/C8).

- Pair counts (C6): ``C2[f, g] = Σ_t w_t B[t, f] B[t, g]``, the Gram
  matrix Bᵀ(w ⊙ B).  The reference package leaves it to XLA outside any
  Pallas kernel; here it is one ``torch.matmul`` in float32 when the
  caller proves every count < 2^24 (``fast_f32``: counts are bounded by
  the raw transaction total, the reference's ``_fast_f32`` gate), else in
  float64 (exact below 2^53).  Every term and partial sum is a
  non-negative integer under that bound, so any summation order is exact
  (TF32 is kept off — device.py).
- Level-k counts (C8): per prefix row, the one-hot row S, then K1
  (ops/level_kernel.py) for ``counts[p, f] = Σ_t w_t [t ⊇ prefix p]
  B[t, f]`` for every extension f at once, then the gather at the
  candidates' flat indexes.

Weights enter the int8 kernel as base-128 digits (ops/bitmap.py).  The
engine runs the single low digit ``w % 128`` for every row and adds the
exact remainder of the few rows with multiplicity >= 128 through the
heavy-row corrections (float64 matmuls over those rows only).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from fastapriori_tpu_torch.ops.level_kernel import level_counts


def _weights(w_digits: torch.Tensor, scales: Sequence[int], dtype):
    """Per-transaction weights reassembled from their base-128 digits."""
    w = None
    for d, scale in enumerate(scales):
        part = w_digits[d].to(dtype) * scale
        w = part if w is None else w + part
    return w


def local_pair_counts(
    bitmap: torch.Tensor,  # [T, F] int8
    w_digits: torch.Tensor,  # [D, T] int8
    scales: Sequence[int],
    fast_f32: bool = False,
) -> torch.Tensor:
    """C6: weighted co-occurrence counts of all item pairs, int32 [F, F]
    (diagonal = weighted item support over size>=2 baskets; callers read
    the upper triangle)."""
    dtype = torch.float32 if fast_f32 else torch.float64
    b = bitmap.to(dtype)
    w = _weights(w_digits, scales, dtype)
    return (b.T @ (b * w[:, None])).to(torch.int32)


def heavy_pair_correction(
    heavy_b: torch.Tensor,  # [Th, F] int8 (zero rows when unused)
    heavy_w: torch.Tensor,  # [Th] int32 = w - (w % 128) (0 on padding)
) -> torch.Tensor:
    """The heavy rows' remainder contribution to the pair Gram matrix."""
    hb = heavy_b.to(torch.float64)
    return (hb.T @ (hb * heavy_w.to(torch.float64)[:, None])).to(torch.int32)


def heavy_level_correction(
    onehot: torch.Tensor,  # [P, F] prefix one-hot int8
    k1: int,
    heavy_b: torch.Tensor,  # [Th, F] int8
    heavy_w: torch.Tensor,  # [Th] int32
) -> torch.Tensor:
    """The heavy rows' remainder contribution to one level's [P, F]
    count matrix: membership + weighted counting over just those rows."""
    hb = heavy_b.to(torch.float64)
    member = hb @ onehot.to(torch.float64).T  # [Th, P]
    common = (member == k1).to(torch.float64) * heavy_w.to(torch.float64)[
        :, None
    ]
    return (common.T @ hb).to(torch.int32)


def frequent_pair_mask(
    counts: torch.Tensor,  # [F, F] int32
    min_count: int,
    num_items: int,
) -> torch.Tensor:
    """Frequent-pair mask: upper triangle, real-item columns, count
    threshold."""
    iu = torch.arange(counts.shape[0], device=counts.device)
    upper = (iu[None, :] > iu[:, None]) & (iu[None, :] < num_items)
    return upper & (counts >= min_count)


def prefix_onehot(prefix_cols: torch.Tensor, f_pad: int) -> torch.Tensor:
    """[P, K] column indexes -> [P, F_pad] int8 one-hot rows (padding
    positions point at the all-zero column, which then holds a 1 that
    never overlaps a bitmap row)."""
    p = prefix_cols.shape[0]
    onehot = torch.zeros((p, f_pad), dtype=torch.int8,
                         device=prefix_cols.device)
    onehot.scatter_(1, prefix_cols.long(), 1)
    return onehot


def local_level_gather(
    bitmap: torch.Tensor,  # [T, F] int8
    w_digits: torch.Tensor,  # [D, T] int8
    scales: Sequence[int],
    prefix_cols: torch.Tensor,  # [P, K] int; padding -> zero column
    k1: int,  # real prefix width
    cand_idx: torch.Tensor,  # [C] flat indexes row * F + y
    heavy_b: Optional[torch.Tensor] = None,  # [Th, F] int8
    heavy_w: Optional[torch.Tensor] = None,  # [Th] int32
) -> torch.Tensor:
    """C8 for one prefix chunk: returns the candidates' int32 counts [C].

    One K1 launch per weight digit (a single digit on every real corpus
    after the weight split), each digit's counts scaled by 128^d; then
    the heavy-row remainder; then the gather.  Padded prefix rows point
    at the all-zero column, so their overlap is 0 and they never match a
    k1 >= 1."""
    onehot = prefix_onehot(prefix_cols, bitmap.shape[1])
    counts = None
    for d, scale in enumerate(scales):
        wb = bitmap * w_digits[d][:, None]  # int8 in [0, 127]
        part = level_counts(bitmap, wb, onehot, k1)
        part = part if scale == 1 else part * scale
        counts = part if counts is None else counts + part
    if heavy_b is not None:
        counts = counts + heavy_level_correction(onehot, k1, heavy_b, heavy_w)
    return counts.reshape(-1)[cand_idx.long()]
