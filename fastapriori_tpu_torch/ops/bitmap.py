"""Transaction x item bitmap and padding discipline (counterpart:
fastapriori_tpu/ops/bitmap.py; reference C5, FastApriori.scala:195-210).

The bitmap ``B ∈ {0,1}^{T'×F}`` is built in one host pass as int8.  The
item axis is padded so that at least one all-zero column lies beyond the
real items (``f_pad >= num_items + 1``): padded prefix positions,
padded candidate slots and padded rule antecedents point at it and count
exactly 0.  Multiplicity weights enter the int8 counting kernels as
base-128 digits, ``w = Σ_d 128^d · w_d`` with ``w_d ∈ [0, 128)``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def pad_axis(n: int, multiple: int) -> int:
    """Smallest multiple of ``multiple`` that is >= max(n, 1)."""
    n = max(n, 1)
    return ((n + multiple - 1) // multiple) * multiple


def next_pow2(n: int) -> int:
    """Smallest power of two >= max(n, 1)."""
    p = 1
    while p < n:
        p *= 2
    return p


def build_bitmap(
    baskets: Sequence[np.ndarray],
    num_items: int,
    txn_multiple: int = 8,
    item_multiple: int = 128,
) -> np.ndarray:
    """Dense int8 bitmap of ragged baskets, padded to
    ``[pad_axis(T, txn_multiple), pad_axis(num_items + 1, item_multiple)]``
    with all-zero padding rows and columns."""
    t = len(baskets)
    t_pad = pad_axis(t, txn_multiple)
    f_pad = pad_axis(num_items + 1, item_multiple)
    b = np.zeros((t_pad, f_pad), dtype=np.int8)
    if t == 0:
        return b
    lens = np.fromiter((len(x) for x in baskets), dtype=np.int64, count=t)
    rows = np.repeat(np.arange(t, dtype=np.int64), lens)
    cols = np.concatenate(baskets)
    b[rows, cols] = 1
    return b


def build_bitmap_csr(
    indices: np.ndarray,
    offsets: np.ndarray,
    num_items: int,
    txn_multiple: int = 8,
    item_multiple: int = 128,
) -> np.ndarray:
    """CSR variant of :func:`build_bitmap` (basket ``i`` =
    ``indices[offsets[i]:offsets[i+1]]``)."""
    t = len(offsets) - 1
    t_pad = pad_axis(t, txn_multiple)
    f_pad = pad_axis(num_items + 1, item_multiple)
    b = np.zeros((t_pad, f_pad), dtype=np.int8)
    if t > 0 and len(indices) > 0:
        rows = np.repeat(
            np.arange(t, dtype=np.int64), np.diff(offsets).astype(np.int64)
        )
        b[rows, indices] = 1
    return b


def weight_digits(
    weights: np.ndarray, txn_pad: int
) -> Tuple[np.ndarray, List[int]]:
    """Base-128 int8 digits of the zero-padded weights: returns
    ``(digits int8[D, T_pad], scales)`` with
    ``weights == Σ_d scales[d] * digits[d]`` and ``scales[d] = 128**d``
    (D = 1 unless some basket repeats >= 128 times)."""
    w = np.zeros(txn_pad, dtype=np.int64)
    w[: len(weights)] = weights
    digits: List[np.ndarray] = []
    scales: List[int] = []
    scale = 1
    while True:
        digits.append((w % 128).astype(np.int8))
        scales.append(scale)
        w //= 128
        scale *= 128
        if not (w > 0).any():
            break
    return np.stack(digits, axis=0), scales
