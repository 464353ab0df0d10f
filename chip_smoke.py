#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (fastapriori_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. Build the three CUDA kernels from ``fastapriori_tpu_torch/csrc/`` with
   nvcc for sm_90a (one nvcc per source, started together).
2. A quick check of each kernel against its plain PyTorch version at
   ragged shapes, before anything depends on them.
3. The main path: generate the T10I4D100K-shape corpus with the port's
   datagen (100,000 transactions over 1,000 items, seed 2017; 10,000 user
   baskets, seed 2018), run the port's CLI in-process at
   ``--min-support 0.0025`` and compare the SHA-256 of ``freqItemset`` and
   ``recommends`` with the digests the JAX package's CLI writes for the
   same files (``--platform cpu --engine level --num-devices 1``;
   tests/test_torch_e2e.py recomputes them).  Auto picks the bitmap
   layout there: K1 and K2 must have launched, K3 not.
4. The vertical path: the kosarak-shape corpus (990,000 transactions over
   41,000 items, length 8, seed 2017; 10,000 user baskets, seed 2018),
   the CLI at ``--min-support 0.002`` with ``FA_MINE_ENGINE=vertical``
   set for that call only, both digests against the JAX CLI's
   (tests/test_torch_vertical.py recomputes them).  K3 and K2 must have
   launched, K1 not.
   In phases 3 and 4 the launch counts are set to 0 just before the CLI
   call and read just after, and the CLI's ``--metrics`` stderr lines
   are printed again on stdout: one line of phase walls, one of the
   phases' other fields (shapes, counts, launches).
5. Each kernel against its plain version at the shapes of each path
   that runs it (K1 on the main path, K2 on both, K3 on the vertical
   path; exact equality: every output is an integer count or rank).
   Every launch of each path is replayed at its own shapes and timed
   (``per_launch_ms``, ``ms_all_launches``); the replay must make as many
   launches as phases 3 and 4 counted.  At the heaviest launch, the
   kernel's, the plain version's and, for K1, a library formulation's
   times from CUDA events, and the least time the card could take for
   the same work (K3's counted two ways).  On each path's baskets, the
   recommender's host scan against its device path near its switch
   point (``DEVICE_MIN_CHECKS``).

Prints the card's name and power limit, one ``{"kernels": [...]}`` line,
and as its last line ``{"ok": true, "device": {...}}``.  Exits non-zero
without a result when there is no CUDA device.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import subprocess
import sys
import time

# freqItemset / recommends written by `python -m fastapriori_tpu <in>/
# <out>/ --min-support 0.0025 --platform cpu --engine level
# --num-devices 1` on the corpus of phase 3.
FREQ_SHA256 = "c3bdd20e19b8b42fc922ba854fc51efe81bf9803fb1bc62ae3eecff32ab4a707"
REC_SHA256 = "731e69db1ad76336588bfd65aefc2cdceca2895a396fe2cdf3a6d8e3e51f513a"
MIN_SUPPORT = "0.0025"

# Phase 4: the kosarak shape (bench.py:90) and the digests written by
# `FA_MINE_ENGINE=vertical python -m fastapriori_tpu <in>/ <out>/
# --min-support 0.002 --platform cpu --engine level --num-devices 1`.
KOSARAK = {
    "n_txns": 990_000, "n_items": 41_000, "avg_txn_len": 8, "seed": 2017,
    "n_users": 10_000, "user_seed": 2018, "min_support": "0.002",
    "freq_sha256":
        "9b510238756f3acba31addfac72f3c07255e57f1c88065fc4658129854799167",
    "rec_sha256":
        "b5a59dffec02a2fe3563f321739f211b889a4dea93807b682efa1d0b470f850b",
}

# Published H100 SXM peaks (dense; NVIDIA data sheet, at 700 W).
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15
# Per-SM results per clock for compute capability 9.0 (CUDA C++
# Programming Guide, arithmetic instruction throughput), and the SMs.
BITWISE32_PER_CLK_SM = 64
POPC_PER_CLK_SM = 16
H100_SMS = 132

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "_smoke")


def log(msg: str) -> None:
    print(msg, flush=True)


def sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def sm_clock_mhz() -> float:
    """The card's maximum SM clock, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return float(out.stdout.strip().splitlines()[0])


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call from CUDA events around ``iters``
    back-to-back calls, after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes: float, n_ops: float) -> tuple:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def require_equal(name: str, got, want) -> int:
    """Max abs difference of two integer tensors; exits unless they are
    equal (same shape, same values)."""
    import torch

    if got.shape != want.shape:
        raise SystemExit(f"{name}: shape {tuple(got.shape)} != "
                         f"{tuple(want.shape)}")
    err = int((got.long() - want.long()).abs().max().item())
    if err or not torch.equal(got, want):
        raise SystemExit(f"{name}: kernel disagrees with its plain version "
                         f"(max abs err {err})")
    return err


def quick_checks(device) -> None:
    """Phase 2: the three kernels at ragged shapes and at the edges of
    their designs (:func:`k1_quick_checks`, :func:`k3_quick_checks`; K2:
    MB and R not tile multiples) against their plain versions."""
    import numpy as np
    import torch

    from fastapriori_tpu_torch.ops.match_kernel import (
        first_match,
        first_match_plain,
    )

    rng = np.random.default_rng(7)
    k1_quick_checks(device, rng)
    mb, f2, r, k = 77, 200, 1000, 5
    bask = (rng.random((mb, f2)) < 0.1).astype(np.int8)
    bask[:, f2 - 1] = 0  # the all-zero padding column
    blen = bask.sum(axis=1).astype(np.int32)
    blen[-3:] = 0
    ant = rng.integers(0, f2 - 1, size=(r, k)).astype(np.int32)
    size = rng.integers(1, k + 1, size=r).astype(np.int32)
    ant[np.arange(k)[None, :] >= size[:, None]] = f2 - 1
    size[-10:] = f2 + 1  # padding rules
    cons = rng.integers(0, f2 - 1, size=r).astype(np.int32)
    args = [torch.from_numpy(x).to(device)
            for x in (bask, blen, ant, size, cons)]
    require_equal("first_match ragged", first_match(*args),
                  first_match_plain(*args))
    k3_quick_checks(device, rng)
    torch.cuda.synchronize()


def k1_quick_checks(device, rng) -> None:
    """K1: T not a multiple of the 512-transaction sub-tile, M not a
    multiple of the 32-row tile, F not a multiple of 32 and F from 33 to
    12,288 (F = 1,000, 2,500 and 6,000 select the 256-, 128- and
    64-transaction sub-tiles; 300 the 512, 12,288 the 32), k1 = 3 and 130,
    rows that cannot match (k1 - 1 items, empty), an S of padding rows
    only (one item in the zero column), and WB rows of more than one
    value (within a 32-column word and across words), which the kernel
    reads as bytes."""
    import numpy as np
    import torch

    from fastapriori_tpu_torch.ops.level_kernel import (
        level_counts,
        level_counts_plain,
    )

    def check(name, b, wb, s, k1):
        bt, wbt, st = (torch.from_numpy(x).to(device) for x in (b, wb, s))
        require_equal(f"level_counts {name}", level_counts(bt, wbt, st, k1),
                      level_counts_plain(bt, wbt, st, k1))

    def prefixes(m, f, k1, n_rows):
        # Rows hold exactly k1 items, except every fifth row (k1 - 1
        # items, never a match) and the rows from n_rows on (empty).
        s = np.zeros((m, f), dtype=np.int8)
        for i in range(n_rows):
            n_items = k1 - 1 if i % 5 == 4 else k1
            s[i, rng.choice(f, size=n_items, replace=False)] = 1
        return s

    for t, f, m, density in ((5003, 300, 77, 0.3), (1111, 33, 45, 0.5),
                             (1500, 1000, 70, 0.05), (900, 2500, 40, 0.03),
                             (700, 6000, 40, 0.02), (700, 12288, 41, 0.02)):
        b = (rng.random((t, f)) < density).astype(np.int8)
        b[rng.random(t) < 0.05] = 1  # dense rows, so wide prefixes match
        wb = b * rng.integers(1, 128, size=(t, 1)).astype(np.int8)
        for k1 in (3, 130):
            if k1 <= f:
                check(f"T={t} F={f} M={m} k1={k1}", b, wb,
                      prefixes(m, f, k1, m - 5), k1)
        pad = np.zeros((m, f), dtype=np.int8)
        pad[:, f - 1] = 1  # padding rows only: never k1 = 3 items
        check(f"T={t} F={f} padding rows only", b, wb, pad, 3)
        if f <= 1000:
            # A third of the rows keep one value, a third take one per
            # 32-column word, a third one per entry.
            mixed = wb.copy()
            rows = rng.permutation(t)
            per_word = (1 + np.arange(f) // 32 % 7).astype(np.int8)
            mixed[rows[: t // 3]] = b[rows[: t // 3]] * per_word
            per_entry = rng.integers(1, 128, size=(t, f)).astype(np.int8)
            rest = rows[t // 3 : 2 * t // 3]
            mixed[rest] = b[rest] * per_entry[rest]
            check(f"T={t} F={f} M={m} WB rows of mixed values", b, mixed,
                  prefixes(m, f, 3, m - 5), 3)


def k3_quick_checks(device, rng) -> None:
    """K3 at ragged shapes: NL, P and C multiples of nothing (the last
    512-lane chunk holds 17 lanes), prefix widths 1..8 with padded
    positions (the zero column f_pad - 1), 1, 11 and 31 planes (31 with
    the top two planes full; sums wrap alike mod 2^32 in the kernel and
    its plain version), rows without candidates and a row with 150, the
    zero column as an extension, a prefix whose AND is empty everywhere,
    and a lane chunk whose planes above 0 are all zero; and the compressed
    arena upload against the dense one."""
    import numpy as np
    import torch

    from fastapriori_tpu_torch.ops.vertical_kernel import (
        vertical_counts,
        vertical_counts_plain,
    )

    f_pad, nl, p = 200, 2 * 512 + 17, 77
    for n_planes in (1, 11, 31):
        arena = (rng.integers(0, 2**32, size=(f_pad + 1, nl), dtype=np.uint64)
                 | rng.integers(0, 2**32, size=(f_pad + 1, nl),
                                dtype=np.uint64)).astype(np.uint32)
        arena[f_pad - 1] = 0
        arena[f_pad] = 0xFFFFFFFF
        arena[0] = 0x0000FFFF  # items 0 and 1 never share a transaction
        arena[1] = 0xFFFF0000
        planes = rng.integers(0, 2**32, size=(n_planes, nl),
                              dtype=np.uint64).astype(np.uint32)
        planes[:, -1] = 0  # the ragged last lane of a corpus
        planes[1:, 512:1024] = 0  # a chunk of weight-1 transactions
        if n_planes == 31:
            planes[29:] = 0xFFFFFFFF
        for k in range(1, 9):
            prefix = rng.integers(2, f_pad - 1, size=(p, k)).astype(np.int32)
            prefix[rng.random((p, k)) < 0.2] = f_pad - 1
            prefix[-5:] = f_pad - 1
            prefix[3, :2] = [0, 1] if k >= 2 else [0]  # an empty AND
            cand = []
            for row in range(p - 5):
                if row % 7 == 3:
                    continue
                n_c = 150 if row == 10 else int(rng.integers(1, 40))
                ys = np.sort(rng.choice(f_pad, size=n_c, replace=False))
                cand += [row * f_pad + int(y) for y in ys]
            cand.append((p - 6) * f_pad + f_pad - 1)
            args = (
                torch.from_numpy(arena.view(np.int32)).to(device),
                torch.from_numpy(planes.view(np.int32)).to(device),
                [1 << b for b in range(n_planes)],
                torch.from_numpy(prefix).to(device),
                torch.tensor(cand, dtype=torch.int32, device=device),
            )
            require_equal(f"vertical_counts ragged B={n_planes} K={k}",
                          vertical_counts(*args), vertical_counts_plain(*args))
    # The compressed arena upload (sparse corpora) lands the same words
    # as the dense one, top bits included.
    from fastapriori_tpu_torch.device import DeviceContext
    from fastapriori_tpu_torch.ops.vertical import compress_arena

    sparse = arena * (rng.random(arena.shape) < 0.01)
    sparse[f_pad] = 0xFFFFFFFF
    ctx = DeviceContext(device)
    dense, _ = ctx.upload_tid_arena(sparse)
    packed, _ = ctx.upload_tid_arena(sparse, compress_arena(sparse, f_pad)[0])
    require_equal("compressed arena upload", packed, dense)


def phase_metrics(stderr_text: str) -> tuple:
    """The CLI's ``--metrics`` lines and its two "==== Total time" walls,
    from its stderr: ``({phase: wall ms}, {phase: other fields})``."""
    walls, fields = {}, {}
    for line in stderr_text.splitlines():
        if line.startswith("==== Total time for "):
            name, _, ms = line[len("==== Total time for "):].rpartition(" ")
            walls[name] = float(ms)
        elif line.startswith("{"):
            rec = json.loads(line)
            key = rec.pop("event") + (f" k={rec.pop('k')}" if "k" in rec
                                      else "")
            if "wall_ms" in rec:
                walls[key] = rec.pop("wall_ms")
            rec.pop("path", None)
            fields[key] = rec
    return walls, fields


def kernel_launches() -> dict:
    from fastapriori_tpu_torch.ops.level_kernel import level_counts
    from fastapriori_tpu_torch.ops.match_kernel import first_match
    from fastapriori_tpu_torch.ops.vertical_kernel import vertical_counts

    return {"level_counts": level_counts,
            "first_match": first_match,
            "vertical_counts": vertical_counts}


def write_corpus(in_dir: str, n_txns: int, n_items: int, avg_txn_len: int,
                 seed: int, n_users: int, user_seed: int) -> None:
    from fastapriori_tpu_torch.utils.datagen import (
        generate_transactions,
        generate_user_baskets,
    )

    os.makedirs(in_dir, exist_ok=True)
    t0 = time.perf_counter()
    with open(os.path.join(in_dir, "D.dat"), "w") as f:
        f.write("\n".join(generate_transactions(
            n_txns=n_txns, n_items=n_items, avg_txn_len=avg_txn_len,
            seed=seed)) + "\n")
    with open(os.path.join(in_dir, "U.dat"), "w") as f:
        f.write("\n".join(generate_user_baskets(
            n_users=n_users, n_items=n_items, seed=user_seed)) + "\n")
    log(f"datagen {in_dir}: {time.perf_counter() - t0:.3f} s")


def cli_path(name: str, in_dir: str, out_dir: str, min_support: str,
             digests: dict, mine_engine=None) -> dict:
    """Phases 3 and 4: the port's CLI in-process, with FA_MINE_ENGINE set
    to ``mine_engine`` (unset for None) for this call only; checks both
    output digests and returns the kernels' launch counts on this run."""
    from fastapriori_tpu_torch import cli

    os.makedirs(out_dir, exist_ok=True)
    kernels = kernel_launches()
    captured = io.StringIO()
    saved = os.environ.pop("FA_MINE_ENGINE", None)
    if mine_engine is not None:
        os.environ["FA_MINE_ENGINE"] = mine_engine
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stderr(captured):
            rc = cli.main([in_dir + "/", out_dir + "/", "--min-support",
                           min_support, "--metrics"])
    finally:
        wall = time.perf_counter() - t0
        launches = {n: fn.launches for n, fn in kernels.items()}
        if saved is None:
            os.environ.pop("FA_MINE_ENGINE", None)
        else:
            os.environ["FA_MINE_ENGINE"] = saved
        sys.stderr.write(captured.getvalue())
    if rc != 0:
        raise SystemExit(f"{name}: CLI exited {rc}")
    log(f"{name}: CLI wall {wall:.3f} s, launches {launches}")
    walls, fields = phase_metrics(captured.getvalue())
    log(f"{name} phases (wall ms): " + json.dumps(walls))
    log(f"{name} phase metrics: " + json.dumps(fields))
    for out_name, want in digests.items():
        got = sha256(os.path.join(out_dir, out_name))
        if got != want:
            raise SystemExit(f"{name}: {out_name} sha256 {got} != the JAX "
                             f"package's {want}")
        log(f"{name}: {out_name} sha256 matches the JAX package ({got})")
    return launches


def require_launches(name: str, launches: dict, ran, idle) -> None:
    for k in ran:
        if launches[k] <= 0:
            raise SystemExit(f"{name}: kernel {k} never launched")
    for k in idle:
        if launches[k] != 0:
            raise SystemExit(f"{name}: kernel {k} launched {launches[k]} "
                             f"times; this path must not run it")


def mine(in_dir: str, device, min_support: str, mine_engine: str = "auto"):
    """A path's phase 1 through the API (after its counted run): the
    inputs of the kernels' measurements."""
    from fastapriori_tpu_torch.config import MinerConfig
    from fastapriori_tpu_torch.models.apriori import FastApriori
    from fastapriori_tpu_torch.preprocess import preprocess_file

    cfg = MinerConfig(min_support=float(min_support), mine_engine=mine_engine)
    data = preprocess_file(os.path.join(in_dir, "D.dat"), cfg.min_support)
    levels = FastApriori(config=cfg, device=device).mine_levels_raw(data)
    return cfg, data, levels


def level_launches(cfg, levels, f_pad: int):
    """Every K1 or K3 launch of a path's level loop, in order, as
    models/apriori.py ``_level_loop`` makes them: ``(k, prefix_cols,
    cand_idx)`` per prefix chunk of each level k >= 3 that runs."""
    from fastapriori_tpu_torch.models.apriori import level_chunks
    from fastapriori_tpu_torch.models.candidates import gen_candidates_arrays

    for i, (mat, _) in enumerate(levels):
        k = i + 3
        if mat.shape[0] < k:  # the level loop stops here
            break
        x_idx, ys = gen_candidates_arrays(mat)
        for prefix_cols, cand_idx, _ in level_chunks(mat, x_idx, ys, f_pad,
                                                     cfg):
            yield k, prefix_cols, cand_idx


def k1_measure(cfg, data, levels, device) -> dict:
    """Phase 5, K1: every level-count launch of the main path replayed at
    its own shapes (held against the plain version, timed), then the
    heaviest (the first with the most prefix rows) in full: the plain
    version, the library formulation and the bound."""
    import numpy as np
    import torch

    from fastapriori_tpu_torch.ops.bitmap import build_bitmap_csr
    from fastapriori_tpu_torch.ops.count import prefix_onehot
    from fastapriori_tpu_torch.ops.level_kernel import (
        level_counts,
        level_counts_plain,
    )

    b_np = build_bitmap_csr(data.basket_indices, data.basket_offsets,
                            data.num_items, cfg.txn_tile, cfg.item_tile)
    f_pad = b_np.shape[1]
    if data.weights.max() >= 128:
        raise SystemExit("K1 measurement expects single-digit weights")
    bitmap = torch.from_numpy(b_np).to(device)
    w = np.zeros(b_np.shape[0], dtype=np.int8)
    w[: data.total_count] = data.weights
    wb = bitmap * torch.from_numpy(w).to(device)[:, None]
    per_launch, best = [], None
    for k, prefix_cols, _ in level_launches(cfg, levels, f_pad):
        k1 = prefix_cols.shape[1]
        s_mat = prefix_onehot(torch.from_numpy(prefix_cols).to(device), f_pad)
        require_equal(f"level_counts k={k} launch",
                      level_counts(bitmap, wb, s_mat, k1),
                      level_counts_plain(bitmap, wb, s_mat, k1))
        per_launch.append(time_ms(
            lambda: level_counts(bitmap, wb, s_mat, k1), iters=10))
        if best is None or s_mat.shape[0] > best[0].shape[0]:
            best = (s_mat, k1)
    log(f"K1 per launch (ms): {json.dumps(per_launch)}, all launches "
        f"{sum(per_launch):.4f} ms")
    s_mat, k1 = best
    t, f = bitmap.shape
    m = s_mat.shape[0]
    # Real prefixes hold k1 items; the pow2 padding rows hold one item
    # and the kernel gives tiles of only those no work.
    m_real = int((torch.count_nonzero(s_mat, dim=1) == k1).sum().item())
    log(f"K1 shapes: T={t} F={f} M={m} ({m_real} real prefixes) k1={k1}")

    got = level_counts(bitmap, wb, s_mat, k1)
    want = level_counts_plain(bitmap, wb, s_mat, k1)
    err = require_equal("level_counts main shape", got, want)
    b_t = bitmap.t().contiguous()

    def library():
        overlap = torch._int_mm(s_mat, b_t)  # [M, T] materialised
        return torch._int_mm((overlap == k1).to(torch.int8), wb)

    require_equal("level_counts vs torch._int_mm", got, library())
    # Contained (prefix, transaction) pairs: the counting product's real
    # work (overlaps <= F are exact in float32).
    pairs = 0
    s_f = s_mat.float()
    for t0 in range(0, t, 8192):
        ov = s_f @ bitmap[t0 : t0 + 8192].float().T
        pairs += int((ov == k1).sum().item())
    ms = time_ms(lambda: level_counts(bitmap, wb, s_mat, k1), iters=20)
    plain_ms = time_ms(lambda: level_counts_plain(bitmap, wb, s_mat, k1),
                       iters=3, warmup=1)
    library_ms = time_ms(library, iters=5, warmup=1)
    n_bytes = 2 * t * f + m * f + 4 * m * f
    n_ops = 2 * m_real * t * f + 2 * pairs * f
    bound_ms, bound_by = bound(n_bytes, n_ops)
    log(f"K1: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
        f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
        f"contained pairs {pairs}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "ms_all_launches": sum(per_launch),
            "per_launch_ms": per_launch}


def scan_crossover(path: str, rec, baskets) -> None:
    """The recommender's host scan against its whole device path (rule
    table build and upload, K2 launches, fetch) on the path's first n
    distinct baskets, for n near 10^5 .. 3·10^7 basket x rule checks:
    wall clock on the host, the median of 3 runs each.  These are the
    numbers ``models/recommender.py`` ``DEVICE_MIN_CHECKS`` rests on."""
    import statistics

    from fastapriori_tpu_torch.models.recommender import DEVICE_MIN_CHECKS

    def wall_ms(fn) -> float:
        runs = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            runs.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(runs)

    def device(sub):
        rec._table_dev = None  # the table upload is part of the path
        return rec._device_first_match(sub, {})

    n_rules = rec.n_rules
    sizes = sorted({min(max(round(c / n_rules), 1), len(baskets))
                    for c in (1e5, 3e5, 1e6, 3e6, 1e7, 3e7)})
    for n in sizes:
        sub = baskets[:n]
        if device(sub) != rec._host_first_match(sub):
            raise SystemExit(f"{path}: device scan disagrees with the host "
                             f"scan on {n} baskets")
        host_ms = wall_ms(lambda: rec._host_first_match(sub))
        dev_ms = wall_ms(lambda: device(sub))
        log(f"scan crossover {path}: {n} baskets x {n_rules} rules = "
            f"{n * n_rules} checks: host {host_ms:.3f} ms, device path "
            f"{dev_ms:.3f} ms (DEVICE_MIN_CHECKS {DEVICE_MIN_CHECKS} picks "
            f"{'device' if n * n_rules >= DEVICE_MIN_CHECKS else 'host'})")


def k2_measure(path: str, in_dir: str, data, levels, device) -> dict:
    """Phase 5, K2: the path's first scan micro-batch (each path's
    recommend runs one, its only launch), then :func:`scan_crossover` on its baskets."""
    import torch

    from fastapriori_tpu_torch.io.reader import read_dat
    from fastapriori_tpu_torch.models.recommender import AssociationRules
    from fastapriori_tpu_torch.ops.match_kernel import (
        NO_MATCH,
        first_match,
        first_match_plain,
    )
    from fastapriori_tpu_torch.preprocess import dedup_user_baskets

    rec = AssociationRules(data.freq_items, data.item_to_rank, levels,
                           data.item_counts, device=device)
    baskets, _, _ = dedup_user_baskets(
        read_dat(os.path.join(in_dir, "U.dat")), data.item_to_rank)
    _, _, bm, blen = next(rec.micro_batches(baskets))
    ant, size, cons = rec.table()
    args = (torch.from_numpy(bm).to(device), torch.from_numpy(blen).to(device),
            ant, size, cons)
    mb, f = bm.shape
    r, k = ant.shape
    log(f"K2 shapes ({path}): MB={mb} ({len(baskets)} distinct baskets) "
        f"F={f} R={r} K={k} (rules {rec.n_rules})")
    got = first_match(*args)
    want = first_match_plain(*args)
    err = require_equal(f"first_match {path} shape", got, want)
    ms = time_ms(lambda: first_match(*args), iters=20)
    plain_ms = time_ms(lambda: first_match_plain(*args), iters=2, warmup=1)
    # Each real basket (length > 0; padding rows match nothing) needs the
    # rules up to its first match, or all real rules.
    scanned = torch.where(got < NO_MATCH, got.long() + 1,
                          torch.full_like(got, rec.n_rules, dtype=torch.long))
    scanned = torch.where(args[1] > 0, scanned, torch.zeros_like(scanned))
    n_ops = 2 * f * int(scanned.sum().item())
    n_bytes = mb * f + 4 * mb + 4 * r * k + 8 * r + 4 * mb
    bound_ms, bound_by = bound(n_bytes, n_ops)
    log(f"K2 ({path}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}); matched "
        f"{int((got < NO_MATCH).sum().item())} of {len(baskets)} baskets")
    scan_crossover(path, rec, baskets)
    # Each path's recommend launches K2 once: this micro-batch.
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "ms_all_launches": ms, "per_launch_ms": [ms]}


def k3_measure(cfg, data, levels, device, clock_mhz: float) -> dict:
    """Phase 5, K3: every launch of the vertical path replayed at its own
    shapes (held against the plain version, timed), then the heaviest
    (the prefix chunk with the most candidates; every launch has the same
    lanes and planes) in full: the plain version and the bound, counted
    two ways."""
    import numpy as np
    import torch

    from fastapriori_tpu_torch.ops.vertical import (
        build_tid_arena_csr,
        weight_bit_planes,
    )
    from fastapriori_tpu_torch.ops.vertical_kernel import (
        _popcount32,
        _prefix_and,
        lane_plane_mask,
        vertical_counts,
        vertical_counts_plain,
    )

    arena_np, f_pad, t_pad = build_tid_arena_csr(
        data.basket_indices, data.basket_offsets, data.num_items, 32,
        cfg.item_tile)
    planes_np, scales = weight_bit_planes(
        np.asarray(data.weights, dtype=np.int64), t_pad)
    arena = torch.from_numpy(arena_np.view(np.int32)).to(device)
    planes = torch.from_numpy(planes_np.view(np.int32)).to(device)
    per_launch, best = [], None
    for k, prefix_cols, cand_np in level_launches(cfg, levels, f_pad):
        args = (arena, planes, scales,
                torch.from_numpy(prefix_cols).to(device),
                torch.from_numpy(cand_np.astype(np.int32)).to(device))
        require_equal(f"vertical_counts k={k} launch", vertical_counts(*args),
                      vertical_counts_plain(
                          *args, cand_chunk=cfg.vertical_cand_chunk))
        per_launch.append(time_ms(lambda: vertical_counts(*args), iters=10))
        if best is None or cand_np.size > best[1].size:
            best = (prefix_cols, cand_np, k, args)
    log(f"K3 per launch (ms): {json.dumps(per_launch)}, all launches "
        f"{sum(per_launch):.4f} ms")
    prefix_cols, cand_np, k, args = best
    nl, n_planes = arena_np.shape[1], len(scales)
    p, width = prefix_cols.shape
    got = vertical_counts(*args)
    want = vertical_counts_plain(*args, cand_chunk=cfg.vertical_cand_chunk)
    err = require_equal("vertical_counts path shape", got, want)
    ms = time_ms(lambda: vertical_counts(*args), iters=20)
    plain_ms = time_ms(lambda: vertical_counts_plain(
        *args, cand_chunk=cfg.vertical_cand_chunk), iters=3, warmup=1)

    # Real work only: prefix rows that have candidates, their positions
    # that name an item, candidates whose extension is an item, lanes
    # that hold a transaction; an AND with a zero plane word, and its
    # popcount, add nothing.  Counted two ways: the first count charges
    # a plane word wherever the plane is non-zero; the recount only where
    # the intersection word is non-zero too.
    rows = np.unique(cand_np // f_pad)
    pos = prefix_cols[rows] != f_pad - 1
    real = cand_np[cand_np % f_pad != f_pad - 1]
    lanes = -(-data.total_count // 32)
    plane_words = np.count_nonzero(planes_np[:, :lanes], axis=1)
    items_read = np.union1d(prefix_cols[rows][pos], real % f_pad).size
    n_bytes = (4 * nl * (items_read + n_planes) + 4 * int(pos.sum())
               + 4 * 2 * cand_np.size)
    pref = _prefix_and(arena, args[3])
    planes_here = _popcount32(lane_plane_mask(planes)[:lanes]).float()
    real_t = torch.from_numpy(real).to(device)
    inter_words = 0  # non-zero (intersection, plane) word pairs
    nonzero_inter = 0  # non-zero intersection words
    for c0 in range(0, real.size, 2048):
        ix = real_t[c0 : c0 + 2048]
        nz = ((pref[ix // f_pad, :lanes] & arena[ix % f_pad, :lanes]) != 0)
        nonzero_inter += int(nz.sum().item())
        # Sums below 2^24 (lanes x planes): exact in float32.
        inter_words += int((nz.float() @ planes_here).sum().item())
    clk = clock_mhz * 1e6 * H100_SMS
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3

    def ops_bound(n_and, n_popc):
        t_and = n_and / (BITWISE32_PER_CLK_SM * clk) * 1e3
        t_popc = n_popc / (POPC_PER_CLK_SM * clk) * 1e3
        # AND and population count issue to different units, so the
        # least time for the operations is the slower of the two.
        t_ops = max(t_and, t_popc)
        log(f"  ANDs {n_and} ({t_and:.4f} ms), popcounts {n_popc} "
            f"({t_popc:.4f} ms), bytes {n_bytes} ({t_bytes:.4f} ms)")
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                             "operations")

    log(f"K3 shapes: level k={k} arena [{f_pad + 1}, {nl}] B={n_planes} "
        f"P={p} ({rows.size} with candidates) K={width} C={cand_np.size} "
        f"({real.size} real); non-zero words per plane "
        f"{plane_words.tolist()} of {lanes} real lanes; non-zero "
        f"intersection words {nonzero_inter} of {real.size * lanes}; at "
        f"{clock_mhz:.0f} MHz:")
    log(" counted over every non-zero plane word of every candidate:")
    old_bound_ms, _ = ops_bound(
        int(pos.sum()) * lanes + real.size * (lanes + int(plane_words.sum())),
        real.size * int(plane_words.sum()))
    log(" recount (plane words only where the intersection is non-zero):")
    bound_ms, bound_by = ops_bound(
        int(pos.sum()) * lanes + real.size * lanes + inter_words, inter_words)
    log(f"K3: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}; counted over every non-zero plane "
        f"word {old_bound_ms:.4f} ms)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "bound_ms_every_plane_word": old_bound_ms,
            "ms_all_launches": sum(per_launch), "per_launch_ms": per_launch}


def require_replayed(name: str, measured: dict, counted: int) -> None:
    """Phase 5's replay of a path must launch a kernel as often as the
    counted CLI run did, or its per-launch times are not the path's."""
    n = len(measured["per_launch_ms"])
    if n != counted:
        raise SystemExit(f"{name}: the replay made {n} launches, the "
                         f"counted run {counted}")


def main() -> int:
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    from fastapriori_tpu_torch.ops import build

    device = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}")
    clock = sm_clock_mhz()
    log(f"max SM clock: {clock:.0f} MHz")
    t0 = time.perf_counter()
    report = build.build()
    log(f"build: {time.perf_counter() - t0:.3f} s {json.dumps(report)}")
    quick_checks(device)
    log("quick checks: the three kernels equal their plain versions")

    in_dir, out_dir = os.path.join(WORK, "in"), os.path.join(WORK, "out")
    write_corpus(in_dir, n_txns=100_000, n_items=1000, avg_txn_len=10,
                 seed=2017, n_users=10_000, user_seed=2018)
    main_launches = cli_path(
        "main path", in_dir, out_dir, MIN_SUPPORT,
        {"freqItemset": FREQ_SHA256, "recommends": REC_SHA256})
    require_launches("main path", main_launches,
                     ran=("level_counts", "first_match"),
                     idle=("vertical_counts",))

    k_in, k_out = os.path.join(WORK, "kin"), os.path.join(WORK, "kout")
    write_corpus(k_in, **{key: KOSARAK[key] for key in (
        "n_txns", "n_items", "avg_txn_len", "seed", "n_users", "user_seed")})
    vert_launches = cli_path(
        "vertical path", k_in, k_out, KOSARAK["min_support"],
        {"freqItemset": KOSARAK["freq_sha256"],
         "recommends": KOSARAK["rec_sha256"]}, mine_engine="vertical")
    require_launches("vertical path", vert_launches,
                     ran=("vertical_counts", "first_match"),
                     idle=("level_counts",))

    cfg, data, levels = mine(in_dir, device, MIN_SUPPORT)
    k1 = k1_measure(cfg, data, levels, device)
    require_replayed("K1 main path", k1, main_launches["level_counts"])
    k2 = k2_measure("t10i4d100k", in_dir, data, levels, device)
    require_replayed("K2 main path", k2, main_launches["first_match"])
    del cfg, data, levels
    kcfg, kdata, klevels = mine(k_in, device, KOSARAK["min_support"],
                                "vertical")
    k2v = k2_measure("kosarak_vertical", k_in, kdata, klevels, device)
    require_replayed("K2 vertical path", k2v, vert_launches["first_match"])
    k3 = k3_measure(kcfg, kdata, klevels, device, clock)
    require_replayed("K3 vertical path", k3, vert_launches["vertical_counts"])

    def by_path(name):
        return {"t10i4d100k": main_launches[name],
                "kosarak_vertical": vert_launches[name]}

    # Top-level numbers: the first path in "measured_by_path".
    kernels = [
        {"name": "level_counts", "route": "cuda",
         "source": "fastapriori_tpu_torch/csrc/level_counts.cu",
         "replaces": "fastapriori_tpu/ops/pallas_level.py:57",
         "launches": main_launches["level_counts"], "path": "t10i4d100k",
         "launches_by_path": by_path("level_counts"), **k1,
         "measured_by_path": {"t10i4d100k": k1}},
        {"name": "first_match", "route": "cuda",
         "source": "fastapriori_tpu_torch/csrc/first_match.cu",
         "replaces": "fastapriori_tpu/ops/pallas_vertical.py:210",
         "launches": main_launches["first_match"], "path": "t10i4d100k",
         "launches_by_path": by_path("first_match"), **k2,
         "measured_by_path": {"t10i4d100k": k2, "kosarak_vertical": k2v}},
        {"name": "vertical_counts", "route": "cuda",
         "source": "fastapriori_tpu_torch/csrc/vertical_counts.cu",
         "replaces": "fastapriori_tpu/ops/pallas_vertical.py:88",
         "launches": vert_launches["vertical_counts"],
         "path": "kosarak_vertical",
         "launches_by_path": by_path("vertical_counts"), **k3,
         "measured_by_path": {"kosarak_vertical": k3}},
    ]
    log(f"chip_smoke wall: {time.perf_counter() - t_start:.3f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
