"""K1: fused prefix containment + weighted extension counting.

Replaces the Pallas TPU kernel ``_kernel`` of
fastapriori_tpu/ops/pallas_level.py (launched through
``level_counts_pallas``); the CUDA source is
``fastapriori_tpu_torch/csrc/level_counts.cu``, whose header says what
bounds the kernel on an H100 and what its design does about it.

    counts[m, f] = Σ_t WB[t, f] · [Σ_j S[m, j]·B[t, j] == k1]

``bitmap`` B [T, F] and ``s_mat`` S [M, F] are 0/1 int8 (the bitmap and
the one-hot prefix rows), ``wb`` = (w mod 128) ⊙ B [T, F] int8 is one
unscaled weight digit, ``k1`` = k-1.  Returns int32 [M, F].  No row of S
may hold more than k1 items (ops/count.py ``prefix_onehot`` builds rows
of exactly k1 items, and padding rows of one): the kernel tests a row of
exactly k1 items as a subset of the transaction, and a row with fewer
never matches.  :func:`level_counts` raises ValueError for a wider row
on the CPU; on the card the kernel's device-side assert fails the launch
(a CUDA error at the next synchronisation).
Unlike the TPU wrapper, any T, M and F are accepted (ragged edges are
masked in the kernel; T and M below 2^31) and the overlap is int32, so k1
may exceed 127.

:func:`level_counts` launches the kernel for CUDA tensors and runs
:func:`level_counts_plain` only for CPU tensors; its ``launches``
attribute counts kernel launches, ``launches_by_form`` each form's.
Everything the kernel derives from its inputs (B packed or sliced by
transaction, the prefix rows' word or item lists, the packed WB rows or
WB transposed, the tile work list) is derived on the device inside that
launch.  The counting runs in one of two forms (:data:`FORMS`), the
level loop choosing per launch by :func:`pick_form`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from fastapriori_tpu_torch.ops import build

# The counting kernel's two forms (csrc/level_counts.cu `Form`, in this
# order): "packed" adds each contained (prefix, transaction) pair's WB
# row on CUDA cores; "dense" runs common · WB on the int8 tensor cores.
FORMS = ("packed", "dense")

# Columns of one F slice of each form (csrc/level_counts.cu kFS, kDFS):
# each form redoes its work per slice.
PACKED_SLICE_COLS, DENSE_SLICE_COLS = 384, 256

# The crossover.  chip_smoke.py's "K1 crossover" sweeps (an H100 80GB
# HBM3; PERF.md §6), which set the contained-pair share of synthetic
# launches, put the forms equal near 0.25 % at F = 256, 1.05 % at 384,
# under 0.1 % at 512 and 0.6 % at 768: about SLOPE · r - OFFSET, with r
# the dense form's F slices over the packed form's.
DENSE_SHARE_SLOPE, DENSE_SHARE_OFFSET = 0.008, 0.0055


def pick_form(min_support: float, f: int) -> str:
    """K1's form for a mine at ``min_support`` (min count over the
    transaction count) on a bitmap ``f`` columns wide, both known on the
    host without a sync: dense from the crossover share at ``f``, else
    packed.  The packed form's work grows with the contained (prefix,
    transaction) pairs, the dense form's does not.  The rule reads min
    support for the share: every real prefix has at least that weighted
    support, though the share the kernel sees is over the distinct
    bitmap rows, which repeated baskets can put far below it."""
    r = -(-max(f, 1) // DENSE_SLICE_COLS) / -(-max(f, 1) // PACKED_SLICE_COLS)
    cross = DENSE_SHARE_SLOPE * r - DENSE_SHARE_OFFSET
    return "dense" if min_support >= cross else "packed"


def level_counts_plain(
    bitmap: torch.Tensor,
    wb: torch.Tensor,
    s_mat: torch.Tensor,
    k1: int,
    t_chunk: int = 8192,
) -> torch.Tensor:
    """The same function in plain PyTorch, in float64 (every partial sum
    is an integer below 2^53, so the result is exact), over transaction
    chunks that bound the [M, t_chunk] membership intermediate."""
    m, f = s_mat.shape
    s = s_mat.to(torch.float64)
    out = torch.zeros((m, f), dtype=torch.float64, device=s_mat.device)
    for t0 in range(0, bitmap.shape[0], t_chunk):
        b = bitmap[t0 : t0 + t_chunk].to(torch.float64)
        common = (s @ b.T == k1).to(torch.float64)  # [M, tc]
        out += common @ wb[t0 : t0 + t_chunk].to(torch.float64)
    return out.to(torch.int32)


def _check(bitmap, wb, s_mat) -> None:
    for name, x in (("bitmap", bitmap), ("wb", wb), ("s_mat", s_mat)):
        if x.dtype != torch.int8 or x.dim() != 2:
            raise ValueError(f"{name} must be a 2-D int8 tensor, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if x.device != bitmap.device:
            raise ValueError(f"{name} is on {x.device}, bitmap on "
                             f"{bitmap.device}")
    if wb.shape != bitmap.shape or s_mat.shape[1] != bitmap.shape[1]:
        raise ValueError(
            f"shape mismatch: bitmap {tuple(bitmap.shape)}, wb "
            f"{tuple(wb.shape)}, s_mat {tuple(s_mat.shape)}"
        )


def check_limits(t: int, f: int, m: int) -> None:
    """The kernel's size limits, checked on the host before a launch: T,
    F and M below 2^31 (any F: csrc/level_counts.cu sizes its scratch
    from F and reads B from device memory past F = 12,288)."""
    if max(t, f, m) >= 2**31:
        raise ValueError(f"K1 takes T, F, M < 2^31; got T={t} F={f} M={m}")


def _check_widths(s_mat, k1) -> None:
    """The row-width contract on the host (the kernel asserts it on the
    device, so a CUDA launch pays no host round trip for it)."""
    if s_mat.numel():
        widest = int(torch.count_nonzero(s_mat, dim=1).max())
        if widest > k1:
            raise ValueError(f"a row of s_mat holds {widest} items; K1 "
                             f"takes rows of at most k1={k1} items")


def _lib():
    lib = build.load("level_counts")
    if lib.fa_level_counts.argtypes is None:
        lib.fa_level_counts_scratch.argtypes = [ctypes.c_int] * 5
        lib.fa_level_counts_scratch.restype = ctypes.c_longlong
        lib.fa_level_counts.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int
        ] * 5 + [ctypes.c_void_p]
        lib.fa_level_counts.restype = ctypes.c_int
    return lib


def level_counts(
    bitmap: torch.Tensor,
    wb: torch.Tensor,
    s_mat: torch.Tensor,
    k1: int,
    form: Optional[str] = None,
) -> torch.Tensor:
    """K1 on the tensors' device: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors.  ``form`` (private: the level loop
    passes :func:`pick_form`'s choice, chip_smoke.py forces each form) is
    one of :data:`FORMS`; a CUDA launch without one raises, and CPU
    tensors run the plain version whatever it is."""
    _check(bitmap, wb, s_mat)
    if form is not None and form not in FORMS:
        raise ValueError(f"K1 form {form!r} is not one of {FORMS}")
    if bitmap.device.type == "cpu":
        _check_widths(s_mat, k1)
        return level_counts_plain(bitmap, wb, s_mat, k1)
    if bitmap.device.type != "cuda":
        raise ValueError(f"K1 runs on cuda or cpu, not {bitmap.device}")
    # The library reads the current card (its SM count, its attributes)
    # and launches there: make that the tensors' card, which a mesh
    # shard need not share with the caller.
    with torch.cuda.device(bitmap.device):
        if form is None:
            raise ValueError("K1 on the card needs its form: pick_form's "
                             "choice")
        t, f = bitmap.shape
        m = s_mat.shape[0]
        check_limits(t, f, m)
        bitmap, wb, s_mat = (x.contiguous() for x in (bitmap, wb, s_mat))
        out = torch.zeros((m, f), dtype=torch.int32, device=bitmap.device)
        if t == 0 or f == 0 or m == 0:
            return out
        code = FORMS.index(form)
        lib = _lib()
        # The form's scratch (csrc/level_counts.cu `Scratch`): B packed
        # by words or sliced by transaction, the rows' word or item
        # lists, the packed WB rows or WB transposed, the tile work list
        # and the work counter.
        scratch = torch.empty(
            lib.fa_level_counts_scratch(t, f, m, int(k1), code),
            dtype=torch.uint8, device=bitmap.device)
        stream = torch.cuda.current_stream(bitmap.device).cuda_stream
        err = lib.fa_level_counts(
            bitmap.data_ptr(), wb.data_ptr(), s_mat.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), t, f, m, int(k1), code,
            stream,
        )
    if err != 0:
        raise RuntimeError(f"level_counts kernel launch failed ({form} "
                           f"form): CUDA error {err}")
    level_counts.launches += 1
    level_counts.launches_by_form[form] += 1
    return out


level_counts.launches = 0
level_counts.launches_by_form = dict.fromkeys(FORMS, 0)
