"""Transaction x item bitmap and padding discipline (counterpart:
fastapriori_tpu/ops/bitmap.py, and ``pack_bitmap`` / ``_unpack`` of
fastapriori_tpu/ops/fused.py; reference C5, FastApriori.scala:195-210).

The bitmap ``B ∈ {0,1}^{T'×F}`` is built in one host pass as int8, or
bit-packed on the host (MSB first, as ``numpy.packbits``) and unpacked
on the device (:func:`unpack_bitmap`), which moves an eighth of the
bytes to the card.  The
item axis is padded so that at least one all-zero column lies beyond the
real items (``f_pad >= num_items + 1``): padded prefix positions,
padded candidate slots and padded rule antecedents point at it and count
exactly 0.  Multiplicity weights enter the int8 counting kernels as
base-128 digits, ``w = Σ_d 128^d · w_d`` with ``w_d ∈ [0, 128)``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch


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


def build_packed_bitmap_csr(
    indices: np.ndarray,
    offsets: np.ndarray,
    num_items: int,
    txn_multiple: int = 8,
    item_multiple: int = 128,
) -> Tuple[np.ndarray, int]:
    """Bit-packed variant of :func:`build_bitmap_csr`: returns ``(packed
    uint8[t_pad, f_pad // 8], f_pad)``, MSB first in each byte like
    ``numpy.packbits``.  The native filler sets the bits straight from
    the CSR when its library is available; else the dense bitmap is
    built and packed."""
    t = len(offsets) - 1
    t_pad = pad_axis(t, txn_multiple)
    f_pad = pad_axis(num_items + 1, item_multiple)
    packed = np.zeros((t_pad, f_pad // 8), dtype=np.uint8)
    if t > 0 and len(indices) > 0:
        from fastapriori_tpu_torch.native.loader import fill_packed_bitmap

        if not fill_packed_bitmap(indices, offsets, packed):
            dense = build_bitmap_csr(
                indices, offsets, num_items, txn_multiple, item_multiple
            )
            packed = np.packbits(dense.astype(bool), axis=1)
    return packed, f_pad


def unpack_bitmap(packed: torch.Tensor) -> torch.Tensor:
    """``[T, F // 8]`` uint8 -> ``[T, F]`` int8 0/1, MSB first in each
    byte (the inverse of :func:`build_packed_bitmap_csr`), on the
    tensor's device."""
    # One bit mask per position, MSB first, made by fills: in a fresh
    # process the first launch of a PyTorch kernel loads its module (tens
    # of ms on the H100), and fills, AND and compare are loaded anyway
    # where a power or a shift would load one more.
    masks = torch.stack([
        torch.full((), 128 >> j, dtype=torch.uint8, device=packed.device)
        for j in range(8)
    ])
    bits = (packed[:, :, None] & masks) > 0
    return bits.reshape(packed.shape[0], packed.shape[1] * 8).to(torch.int8)


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
