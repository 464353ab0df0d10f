"""ctypes bindings for the native preprocessing library (counterpart: the
JAX package's ``native/loader.py``, with the same names and results).

The library is the port's own ``csrc/preprocess.cc``, built at first use
by ops/build.py with the host compiler into the git-ignored ``_build/``.
When it cannot be built or loaded, :func:`get_lib` returns None and
:func:`load_error` says why (the compiler's first error line): callers
that may fall back to the Python path (preprocess.py ``_use_native``)
put that reason on their metrics line and the degradation ledger gets a
``native_unavailable`` event; the entry points below raise, but for
``fill_packed_bitmap`` and ``format_lines`` (io/writer.py's layout),
which return False / None for their callers' Python path.  A failure
inside the library is never turned into a fallback: it raises.  The
failpoint sites ``native.load`` (before the library is loaded) and
``native.blocks`` (the block ingest's entry) inject faults here
(reliability/failpoints.py); an injected load failure is not
remembered, so the next call loads again.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from fastapriori_tpu_torch.ops import build
from fastapriori_tpu_torch.reliability import failpoints, ledger

LIB = "fa_native"

# library path -> the loaded library, or the reason it is not there.  The
# path names the source, the compiler and the host, so a changed compiler
# or build directory is a new attempt.
_LIBS: Dict[str, ctypes.CDLL] = {}
_ERRORS: Dict[str, str] = {}
# The last injected load failure per path (not remembered as an error).
_INJECTED: Dict[str, str] = {}


class _FaResult(ctypes.Structure):
    _fields_ = [
        ("n_raw", ctypes.c_int64),
        ("min_count", ctypes.c_int64),
        ("n_items", ctypes.c_int32),
        # void* (not c_char_p): the buffer is length-delimited, not
        # NUL-terminated, and c_char_p field access would scan for NUL.
        ("items_buf", ctypes.c_void_p),
        ("items_buf_len", ctypes.c_int64),
        ("item_counts", ctypes.POINTER(ctypes.c_int64)),
        ("n_baskets", ctypes.c_int64),
        ("basket_offsets", ctypes.POINTER(ctypes.c_int64)),
        ("basket_items", ctypes.POINTER(ctypes.c_int32)),
        ("weights", ctypes.POINTER(ctypes.c_int32)),
    ]


class _FaCandidates(ctypes.Structure):
    _fields_ = [
        ("n", ctypes.c_int64),
        ("x_idx", ctypes.POINTER(ctypes.c_int64)),
        ("y", ctypes.POINTER(ctypes.c_int32)),
    ]


class _FaCounts(ctypes.Structure):
    _fields_ = [
        ("n_lines", ctypes.c_int64),
        ("n_tokens", ctypes.c_int64),
        ("tokens_buf", ctypes.c_void_p),
        ("tokens_buf_len", ctypes.c_int64),
        ("counts", ctypes.POINTER(ctypes.c_int64)),
    ]


# void cb(ctx, f, n_baskets, offsets*, items*, weights*)
_FA_BLOCK_CB = ctypes.CFUNCTYPE(
    None,
    ctypes.c_void_p,
    ctypes.c_int32,
    ctypes.c_int64,
    ctypes.POINTER(ctypes.c_int64),
    ctypes.POINTER(ctypes.c_int32),
    ctypes.POINTER(ctypes.c_int32),
)

# void pass1_cb(ctx, n_raw, min_count, f, counts*): fires once after
# pass 1 / rank assignment, before any block replays.
_FA_PASS1_CB = ctypes.CFUNCTYPE(
    None,
    ctypes.c_void_p,
    ctypes.c_int64,
    ctypes.c_int64,
    ctypes.c_int32,
    ctypes.POINTER(ctypes.c_int64),
)


def _first_error_line(text: str) -> str:
    lines = [line.strip() for line in text.splitlines() if line.strip()]
    for line in lines:
        if "error" in line.lower():
            return line[:200]
    return lines[0][:200] if lines else "no compiler output"


def _bind(lib: ctypes.CDLL) -> None:
    lib.fa_preprocess_buffer.restype = ctypes.POINTER(_FaResult)
    lib.fa_preprocess_buffer.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.c_double,
    ]
    lib.fa_free_result.argtypes = [ctypes.POINTER(_FaResult)]
    lib.fa_free_result.restype = None
    lib.fa_fill_packed_bitmap.argtypes = [
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.fa_fill_packed_bitmap.restype = None
    lib.fa_count_buffer.restype = ctypes.POINTER(_FaCounts)
    lib.fa_count_buffer.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.fa_free_counts.argtypes = [ctypes.POINTER(_FaCounts)]
    lib.fa_free_counts.restype = None
    lib.fa_compress_with_ranks.restype = ctypes.POINTER(_FaResult)
    lib.fa_compress_with_ranks.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.c_int32,
    ]
    lib.fa_preprocess_buffer_blocks.restype = ctypes.POINTER(_FaResult)
    lib.fa_preprocess_buffer_blocks.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.c_double,
        ctypes.c_int32,
        ctypes.c_int32,
        _FA_BLOCK_CB,
        ctypes.c_void_p,
    ]
    lib.fa_preprocess_buffer_blocks2.restype = ctypes.POINTER(_FaResult)
    lib.fa_preprocess_buffer_blocks2.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.c_double,
        ctypes.c_int32,
        ctypes.c_int32,
        _FA_PASS1_CB,
        _FA_BLOCK_CB,
        ctypes.c_void_p,
    ]
    lib.fa_gen_candidates.restype = ctypes.POINTER(_FaCandidates)
    lib.fa_gen_candidates.argtypes = [
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
        ctypes.c_int32,
    ]
    lib.fa_free_candidates.argtypes = [ctypes.POINTER(_FaCandidates)]
    lib.fa_free_candidates.restype = None
    lib.fa_format_lines.restype = ctypes.c_int64
    lib.fa_format_lines.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int32,
        ctypes.c_void_p,
        ctypes.c_int64,
    ]


def get_lib() -> Optional[ctypes.CDLL]:
    """The native library, built first if needed; None when it cannot be
    built or loaded (:func:`load_error` says why, and the ledger has a
    ``native_unavailable`` event)."""
    key = str(build.library_path(LIB))
    lib = _LIBS.get(key)
    if lib is not None or key in _ERRORS:
        return lib
    try:
        build.build([LIB])
    except RuntimeError as e:  # the compiler failed or is missing
        _ERRORS[key] = f"library build failed: {_first_error_line(str(e))}"
        ledger.record("native_unavailable", once_key="build", stage="build",
                      error=_ERRORS[key])
        return None
    try:
        failpoints.fire("native.load")
    except OSError as e:
        _INJECTED[key] = f"library load failed: {str(e)[:200]}"
        ledger.record("native_unavailable", once_key="load", stage="load",
                      error=_INJECTED[key])
        return None
    try:
        lib = ctypes.CDLL(key)
    except OSError as e:  # built, but the loader refused it
        _ERRORS[key] = f"library load failed: {str(e)[:200]}"
        ledger.record("native_unavailable", once_key="load", stage="load",
                      error=_ERRORS[key])
        return None
    _INJECTED.pop(key, None)
    _bind(lib)
    _LIBS[key] = lib
    return lib


def load_error() -> Optional[str]:
    """Why the last :func:`get_lib` for the current build returned None."""
    key = str(build.library_path(LIB))
    if key in _LIBS:
        return None
    return _ERRORS.get(key, _INJECTED.get(key))


def _require_lib() -> ctypes.CDLL:
    lib = get_lib()
    if lib is None:
        raise RuntimeError(
            f"the native preprocessing library is unavailable "
            f"({load_error()}); it builds from "
            f"fastapriori_tpu_torch/csrc/preprocess.cc with $CXX or g++"
        )
    return lib


NativeResult = Tuple[
    int,  # n_raw
    int,  # min_count
    List[str],  # freq_items
    np.ndarray,  # item_counts int64[F]
    np.ndarray,  # basket_indices int32 (CSR data)
    np.ndarray,  # basket_offsets int64[T'+1]
    np.ndarray,  # weights int32[T']
]


def _items_view(lib, res_ptr, res, nnz: int) -> np.ndarray:
    """Zero-copy, read-only view of a result's basket items; the native
    result is freed when the last view of it dies (slices hold the parent
    through ``.base``, and the finalizer hangs off the parent)."""
    base = np.ctypeslib.as_array(res.basket_items, shape=(nnz,))
    base.flags.writeable = False
    weakref.finalize(base, lib.fa_free_result, res_ptr)
    return base[:nnz]


def _freq_items(res) -> List[str]:
    f = int(res.n_items)
    items_raw = ctypes.string_at(res.items_buf, res.items_buf_len)
    # Keyed on f, not the byte length: a frequent EMPTY token (a dataset
    # with >= min_count blank lines) makes the items string legitimately
    # empty while f == 1, and split still yields [""].
    freq_items = [] if f == 0 else items_raw.decode("utf-8").split("\n")
    if len(freq_items) != f:
        raise RuntimeError(f"native result names {len(freq_items)} items, "
                           f"expected {f}")
    return freq_items


def count_buffer(data: bytes) -> Tuple[int, List[str], np.ndarray]:
    """Sharded-ingest phase 1: (line count, distinct tokens, occurrence
    counts) for one byte range."""
    lib = _require_lib()
    res_ptr = lib.fa_count_buffer(data, len(data))
    if not res_ptr:
        raise MemoryError("fa_count_buffer failed")
    try:
        res = res_ptr.contents
        n = int(res.n_tokens)
        raw = ctypes.string_at(res.tokens_buf, res.tokens_buf_len)
        tokens = raw.decode("utf-8").split("\n") if n else []
        if len(tokens) != n:
            raise RuntimeError(f"native count result names {len(tokens)} "
                               f"tokens, expected {n}")
        counts = np.ctypeslib.as_array(res.counts, shape=(max(n, 1),))[
            :n
        ].copy()
        return int(res.n_lines), tokens, counts
    finally:
        lib.fa_free_counts(res_ptr)


def compress_with_ranks(
    data: bytes, freq_items: List[str]
) -> Tuple[int, np.ndarray, np.ndarray, np.ndarray]:
    """Sharded-ingest phase 2: compress one byte range against the GLOBAL
    rank table.  Returns (local line count, basket_indices,
    basket_offsets, weights): CSR over this range's distinct baskets."""
    lib = _require_lib()
    ranks_blob = "\n".join(freq_items).encode("utf-8")
    res_ptr = lib.fa_compress_with_ranks(
        data, len(data), ranks_blob, len(ranks_blob), len(freq_items)
    )
    if not res_ptr:
        raise MemoryError("fa_compress_with_ranks failed")
    free_now = True
    try:
        res = res_ptr.contents
        t = int(res.n_baskets)
        offsets = np.ctypeslib.as_array(
            res.basket_offsets, shape=(t + 1,)
        ).copy()
        nnz = int(offsets[-1]) if t else 0
        if nnz:
            indices = _items_view(lib, res_ptr, res, nnz)
            free_now = False
        else:
            indices = np.empty(0, dtype=np.int32)
        weights = np.ctypeslib.as_array(res.weights, shape=(max(t, 1),))[
            :t
        ].copy()
        return int(res.n_raw), indices, offsets, weights
    finally:
        if free_now:
            lib.fa_free_result(res_ptr)


def preprocess_buffer(data: bytes, min_support: float) -> NativeResult:
    """The one-pass native preprocessing over raw file bytes.  The basket
    items are a read-only view of the native CSR arena (no copy)."""
    lib = _require_lib()
    res_ptr = lib.fa_preprocess_buffer(
        data, len(data), ctypes.c_double(min_support)
    )
    if not res_ptr:
        raise MemoryError("fa_preprocess_buffer failed")
    free_now = True
    try:
        res = res_ptr.contents
        f = int(res.n_items)
        t = int(res.n_baskets)
        freq_items = _freq_items(res)
        item_counts = np.ctypeslib.as_array(
            res.item_counts, shape=(max(f, 1),)
        )[:f].copy()
        offsets = np.ctypeslib.as_array(
            res.basket_offsets, shape=(t + 1,)
        ).copy()
        nnz = int(offsets[-1]) if t else 0
        if nnz:
            indices = _items_view(lib, res_ptr, res, nnz)
            free_now = False
        else:
            indices = np.empty(0, dtype=np.int32)
        weights = np.ctypeslib.as_array(res.weights, shape=(max(t, 1),))[
            :t
        ].copy()
        return (
            int(res.n_raw),
            int(res.min_count),
            freq_items,
            item_counts,
            indices,
            offsets,
            weights,
        )
    finally:
        if free_now:
            lib.fa_free_result(res_ptr)


def fill_packed_bitmap(
    indices: np.ndarray, offsets: np.ndarray, out: np.ndarray
) -> bool:
    """Set CSR basket bits into a zeroed bit-packed bitmap ``out``
    (uint8[t_pad, f_pad // 8], MSB first like numpy packbits).  Returns
    False when the native library is unavailable (the caller falls
    back)."""
    lib = get_lib()
    if lib is None:
        return False
    if out.dtype != np.uint8 or not out.flags["C_CONTIGUOUS"]:
        raise ValueError("out must be a C-contiguous uint8 array")
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    n_baskets = len(offsets) - 1
    if out.shape[0] < n_baskets:
        raise ValueError(f"out has {out.shape[0]} rows for {n_baskets} "
                         f"baskets")
    if len(indices):
        # The C filler does no bounds checks; fence inconsistent CSR input
        # here (out-of-range indices would corrupt the heap).
        lo, hi = int(indices.min()), int(indices.max())
        if lo < 0 or hi >= out.shape[1] * 8:
            raise ValueError(
                f"CSR item index out of range for the packed bitmap: "
                f"min={lo}, max={hi}, columns={out.shape[1] * 8}"
            )
    lib.fa_fill_packed_bitmap(
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(n_baskets),
        ctypes.c_int64(out.shape[1]),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return True


def preprocess_file(path: str, min_support: float) -> NativeResult:
    with open(path, "rb") as fh:
        return preprocess_buffer(fh.read(), min_support)


def has_preprocess_buffer_blocks() -> bool:
    return get_lib() is not None


def has_pass1_probe() -> bool:
    """True when the pass-1-callback flavor of the block ingest
    (``fa_preprocess_buffer_blocks2``) can run."""
    return get_lib() is not None


def _data_arg(data):
    """``(pointer argument, length)`` for bytes or any 1-D contiguous
    uint8 buffer (an mmap'd file through a numpy view, so a large file is
    not copied into a bytes object)."""
    if isinstance(data, bytes):
        return data, len(data)
    arr = (
        data if isinstance(data, np.ndarray)
        else np.frombuffer(data, dtype=np.uint8)
    )
    if arr.dtype != np.uint8 or arr.ndim != 1:
        raise TypeError(
            "buffer input must be 1-D uint8 (or bytes); got "
            f"{arr.dtype} ndim={arr.ndim}"
        )
    # ctypes.data ignores strides: a strided view would scan the wrong
    # bytes.
    if not arr.flags["C_CONTIGUOUS"]:
        raise ValueError("buffer input must be C-contiguous")
    return arr.ctypes.data_as(ctypes.c_char_p), arr.size


def preprocess_buffer_blocks(
    data, min_support: float, n_blocks: int, on_block,
    n_threads: int = 1, copy_items: bool = True, on_pass1=None,
):
    """Capture-replay preprocessing: pass 1 + rank assignment + per-block
    pass-2 replay in ONE native call (the raw bytes are tokenized once).
    ``n_threads > 1`` replays blocks on threads; ``on_block(f, offsets
    int64[t+1], items int32[nnz], weights int32[t])`` fires per block
    during the call, always from the calling thread and in block order,
    with copies the callee owns, EXCEPT ``items`` when
    ``copy_items=False``: then it is a read-only view into the native
    block arena, valid ONLY while the callback runs (the arena is reused
    for the next block); a caller that keeps it must copy it.  Returns
    the global tables ``(n_raw, min_count, freq_items, item_counts)``.

    ``on_pass1(n_raw, min_count, f, item_counts int64[f])`` fires once,
    after pass 1 / rank assignment and before any block replays.

    An exception in a callback stops the remaining callbacks and is
    raised after the native call returns."""
    failpoints.fire("native.blocks")
    lib = _require_lib()
    data_arg, data_len = _data_arg(data)
    errs: list = []

    @_FA_BLOCK_CB
    def cb(_ctx, f, t, offs_p, items_p, w_p):
        # Once a consumer has failed, produce no more side effects; the
        # native call runs on (the C ABI has no abort channel) and the
        # first error is raised after it returns.
        if errs:
            return
        try:
            t = int(t)
            offsets = np.ctypeslib.as_array(offs_p, shape=(t + 1,)).copy()
            nnz = int(offsets[-1])
            items = np.ctypeslib.as_array(items_p, shape=(max(nnz, 1),))[
                :nnz
            ]
            if copy_items:
                items = items.copy()
            else:
                # A consumer that mutates a kept dangling view fails
                # loudly instead of writing to recycled memory.
                items.flags.writeable = False
            weights = np.ctypeslib.as_array(w_p, shape=(max(t, 1),))[
                :t
            ].copy()
            on_block(int(f), offsets, items, weights)
        except BaseException as e:  # never unwind through the C frame
            errs.append(e)

    if on_pass1 is not None:

        @_FA_PASS1_CB
        def p1cb(_ctx, n_raw, min_count, f, counts_p):
            if errs:
                return
            try:
                f = int(f)
                counts = (
                    np.ctypeslib.as_array(counts_p, shape=(f,)).copy()
                    if f > 0
                    else np.empty(0, dtype=np.int64)
                )
                on_pass1(int(n_raw), int(min_count), f, counts)
            except BaseException as e:  # never unwind through the C frame
                errs.append(e)

        res_ptr = lib.fa_preprocess_buffer_blocks2(
            data_arg, data_len, ctypes.c_double(min_support), n_blocks,
            max(n_threads, 1), p1cb, cb, None
        )
    else:
        res_ptr = lib.fa_preprocess_buffer_blocks(
            data_arg, data_len, ctypes.c_double(min_support), n_blocks,
            max(n_threads, 1), cb, None
        )
    if not res_ptr:
        if errs:
            raise errs[0]
        raise MemoryError("fa_preprocess_buffer_blocks failed")
    try:
        if errs:
            raise errs[0]
        res = res_ptr.contents
        f = int(res.n_items)
        freq_items = _freq_items(res)
        item_counts = np.ctypeslib.as_array(
            res.item_counts, shape=(max(f, 1),)
        )[:f].copy()
        return int(res.n_raw), int(res.min_count), freq_items, item_counts
    finally:
        lib.fa_free_result(res_ptr)


def gen_candidates_native(level: np.ndarray):
    """Prefix join + Apriori subset prune over a lex-sorted int32 [M, s]
    level matrix (reference C7).  Returns ``(x_idx int64[C], y
    int32[C])`` in global (x_idx, y) order, identical to
    models/candidates.py ``gen_candidates_arrays``."""
    lib = _require_lib()
    level = np.ascontiguousarray(level, dtype=np.int32)
    m, s = level.shape
    res_ptr = lib.fa_gen_candidates(
        level.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), m, s
    )
    if not res_ptr:
        raise MemoryError("fa_gen_candidates failed")
    try:
        res = res_ptr.contents
        n = int(res.n)
        x_idx = np.ctypeslib.as_array(res.x_idx, shape=(max(n, 1),))[
            :n
        ].copy()
        y = np.ctypeslib.as_array(res.y, shape=(max(n, 1),))[:n].copy()
        return x_idx, y
    finally:
        lib.fa_free_candidates(res_ptr)


def format_lines(
    tokens: Sequence[str],
    mats: Sequence[np.ndarray],
    counts: Optional[Sequence[np.ndarray]] = None,
    sort: bool = False,
) -> Optional[np.ndarray]:
    """Rows of token ids laid out as text lines in one uint8 buffer
    (``fa_format_lines``): each row of ``mats`` (int [N, k], k >= 1)
    printed from its last column to its first, the tokens one space
    apart, ``[count]`` after it when ``counts`` (one int [N] per matrix)
    is given, every line ended by a newline; ``sort`` orders the lines
    as Python's ``list.sort`` orders their strings.  None when the
    library is unavailable (the caller formats in Python); ValueError
    for a token id out of range.  No ``tokens`` entry may hold a
    newline."""
    lib = get_lib()
    if lib is None:
        return None
    mats = [np.ascontiguousarray(m, dtype=np.int32) for m in mats]
    if any(m.ndim != 2 or m.shape[1] < 1 for m in mats):
        raise ValueError("each matrix must be 2-D with at least one column")
    n = len(mats)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    mat_ptrs = (i32p * max(n, 1))(*(m.ctypes.data_as(i32p) for m in mats))
    rows = np.array([m.shape[0] for m in mats] or [0], dtype=np.int64)
    ks = np.array([m.shape[1] for m in mats] or [1], dtype=np.int32)
    cnt_ptrs = None
    if counts is not None:
        counts = [np.ascontiguousarray(c, dtype=np.int64) for c in counts]
        if [c.shape for c in counts] != [(m.shape[0],) for m in mats]:
            raise ValueError("counts must hold one int [N] per matrix")
        cnt_ptrs = (i64p * max(n, 1))(*(c.ctypes.data_as(i64p)
                                         for c in counts))
    pool = "\n".join(tokens).encode("utf-8")
    args = (pool, len(pool), len(tokens), n, mat_ptrs,
            rows.ctypes.data_as(i64p), ks.ctypes.data_as(i32p), cnt_ptrs,
            int(sort))
    size = lib.fa_format_lines(*args, None, 0)
    if size == -3:
        raise MemoryError("fa_format_lines failed")
    if size < 0:
        raise ValueError("fa_format_lines: a token id out of range, or a "
                         "token that holds a newline")
    out = np.empty(size, dtype=np.uint8)
    if size:
        got = lib.fa_format_lines(*args, out.ctypes.data, size)
        if got != size:
            raise MemoryError(f"fa_format_lines failed ({got})")
    return out


def join_transactions(transactions: Sequence[Sequence[str]]) -> bytes:
    """Re-serialize token lists so the buffer path can run on in-memory
    data (tokens hold no whitespace, so this round-trips exactly).

    The trailing newline matters: without it a final [""] line (the
    empty-line form) would serialize to a buffer ending in "\\n" with
    nothing after it and be dropped by the scanner, shifting n_raw and
    therefore minCount."""
    if not transactions:
        return b""
    return ("\n".join(" ".join(t) for t in transactions) + "\n").encode(
        "utf-8"
    )
