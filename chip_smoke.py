#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (fastapriori_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. Build both CUDA kernels from ``fastapriori_tpu_torch/csrc/`` with nvcc
   for sm_90a (one nvcc per source, started together).
2. A quick check of each kernel against its plain PyTorch version at
   ragged shapes, before anything depends on them.
3. The main path: generate the T10I4D100K-shape corpus with the port's
   datagen (100,000 transactions over 1,000 items, seed 2017; 10,000 user
   baskets, seed 2018), run the port's CLI in-process at
   ``--min-support 0.0025`` and compare the SHA-256 of ``freqItemset`` and
   ``recommends`` with the digests the JAX package's CLI writes for the
   same files (``--platform cpu --engine level --num-devices 1``;
   tests/test_torch_e2e.py recomputes them).  Kernel launch counts are
   set to 0 just before and read just after; both kernels must have
   launched.  The CLI's phase walls (its ``--metrics`` stderr lines) are
   printed again as one stdout line.
4. Each kernel against its plain version at the main path's shapes
   (exact equality: every output is an integer count or rank), with the
   kernel's, the plain version's and, for K1, a library formulation's
   times from CUDA events, and the least time the card could take for
   the same work.

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

# Published H100 SXM peaks (dense; NVIDIA data sheet, at 700 W).
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15

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
    """Phase 2: both kernels at ragged shapes (T, M, F, MB, R not tile
    multiples; k1 >= 128) against their plain versions."""
    import numpy as np
    import torch

    from fastapriori_tpu_torch.ops.level_kernel import (
        level_counts,
        level_counts_plain,
    )
    from fastapriori_tpu_torch.ops.match_kernel import (
        first_match,
        first_match_plain,
    )

    rng = np.random.default_rng(7)
    t, f, m = 5003, 300, 77
    b = (rng.random((t, f)) < 0.3).astype(np.int8)
    b[rng.random(t) < 0.05] = 1  # dense rows, so wide prefixes match too
    w = rng.integers(1, 128, size=t).astype(np.int8)
    for k1 in (3, 130):
        # Rows hold exactly k1 items, except every fifth row (k1 - 1
        # items, never a match) and the last 5 rows (empty).
        s = np.zeros((m, f), dtype=np.int8)
        for i in range(m - 5):
            n_items = k1 - 1 if i % 5 == 4 else k1
            s[i, rng.choice(f, size=n_items, replace=False)] = 1
        bt, st = torch.from_numpy(b).to(device), torch.from_numpy(s).to(device)
        wbt = bt * torch.from_numpy(w).to(device)[:, None]
        require_equal(f"level_counts ragged k1={k1}",
                      level_counts(bt, wbt, st, k1),
                      level_counts_plain(bt, wbt, st, k1))
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
    torch.cuda.synchronize()


def phase_walls(stderr_text: str) -> dict:
    """The CLI's ``--metrics`` phase walls and its two "==== Total time"
    walls, from its stderr, as ``{phase: wall ms}``."""
    walls = {}
    for line in stderr_text.splitlines():
        if line.startswith("==== Total time for "):
            name, _, ms = line[len("==== Total time for "):].rpartition(" ")
            walls[name] = float(ms)
        elif line.startswith("{"):
            rec = json.loads(line)
            if "wall_ms" in rec:
                key = rec["event"] + (f" k={rec['k']}" if "k" in rec else "")
                walls[key] = rec["wall_ms"]
    return walls


def main_path(in_dir: str, out_dir: str) -> dict:
    """Phase 3: the port's CLI in-process on the T10I4D100K-shape corpus;
    returns the kernels' launch counts on this run."""
    from fastapriori_tpu_torch import cli
    from fastapriori_tpu_torch.ops.level_kernel import level_counts
    from fastapriori_tpu_torch.ops.match_kernel import first_match
    from fastapriori_tpu_torch.utils.datagen import (
        generate_transactions,
        generate_user_baskets,
    )

    os.makedirs(in_dir, exist_ok=True)
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    with open(os.path.join(in_dir, "D.dat"), "w") as f:
        f.write("\n".join(generate_transactions(
            n_txns=100_000, n_items=1000, seed=2017)) + "\n")
    with open(os.path.join(in_dir, "U.dat"), "w") as f:
        f.write("\n".join(generate_user_baskets(
            n_users=10_000, n_items=1000, seed=2018)) + "\n")
    log(f"datagen: {time.perf_counter() - t0:.3f} s")

    captured = io.StringIO()
    level_counts.launches = 0
    first_match.launches = 0
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stderr(captured):
            rc = cli.main([in_dir + "/", out_dir + "/", "--min-support",
                           MIN_SUPPORT, "--metrics"])
    finally:
        wall = time.perf_counter() - t0
        launches = {"level_counts": level_counts.launches,
                    "first_match": first_match.launches}
        sys.stderr.write(captured.getvalue())
    if rc != 0:
        raise SystemExit(f"main path: CLI exited {rc}")
    log(f"main path: CLI wall {wall:.3f} s, launches {launches}")
    log("main path phases (wall ms): "
        + json.dumps(phase_walls(captured.getvalue())))
    for name, want in (("freqItemset", FREQ_SHA256),
                       ("recommends", REC_SHA256)):
        got = sha256(os.path.join(out_dir, name))
        if got != want:
            raise SystemExit(f"main path: {name} sha256 {got} != the JAX "
                             f"package's {want}")
        log(f"main path: {name} sha256 matches the JAX package ({got})")
    for name, n in launches.items():
        if n <= 0:
            raise SystemExit(f"main path: kernel {name} never launched")
    return launches


def mine(in_dir: str, device):
    """The main path's phase 1 through the API (after the counted run):
    the inputs of the kernels' measurements."""
    from fastapriori_tpu_torch.config import MinerConfig
    from fastapriori_tpu_torch.models.apriori import FastApriori
    from fastapriori_tpu_torch.preprocess import preprocess_file

    cfg = MinerConfig(min_support=float(MIN_SUPPORT))
    data = preprocess_file(os.path.join(in_dir, "D.dat"), cfg.min_support)
    levels = FastApriori(config=cfg, device=device).mine_levels_raw(data)
    return cfg, data, levels


def k1_measure(cfg, data, levels, device) -> dict:
    """Phase 4, K1: the heaviest level-count launch of the main path (the
    level whose prefix chunk is largest)."""
    import numpy as np
    import torch

    from fastapriori_tpu_torch.models.apriori import level_chunks
    from fastapriori_tpu_torch.models.candidates import gen_candidates_arrays
    from fastapriori_tpu_torch.ops.bitmap import build_bitmap_csr
    from fastapriori_tpu_torch.ops.count import prefix_onehot
    from fastapriori_tpu_torch.ops.level_kernel import (
        level_counts,
        level_counts_plain,
    )

    b_np = build_bitmap_csr(data.basket_indices, data.basket_offsets,
                            data.num_items, cfg.txn_tile, cfg.item_tile)
    f_pad = b_np.shape[1]
    best = None
    for mat, _ in levels:
        x_idx, ys = gen_candidates_arrays(mat)
        for prefix_cols, _, _ in level_chunks(mat, x_idx, ys, f_pad, cfg):
            if best is None or prefix_cols.shape[0] > best.shape[0]:
                best = prefix_cols
            break
    if data.weights.max() >= 128:
        raise SystemExit("K1 measurement expects single-digit weights")
    bitmap = torch.from_numpy(b_np).to(device)
    w = np.zeros(b_np.shape[0], dtype=np.int8)
    w[: data.total_count] = data.weights
    wb = bitmap * torch.from_numpy(w).to(device)[:, None]
    k1 = best.shape[1]
    s_mat = prefix_onehot(torch.from_numpy(best).to(device), f_pad)
    t, f = bitmap.shape
    m = s_mat.shape[0]
    # Real prefixes hold k1 items; the pow2 padding rows hold one item
    # and the kernel skips tiles of them.
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
            "library_ms": library_ms}


def k2_measure(in_dir: str, data, levels, device) -> dict:
    """Phase 4, K2: the first scan micro-batch of the main path."""
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
    log(f"K2 shapes: MB={mb} F={f} R={r} K={k} (rules {rec.n_rules})")
    got = first_match(*args)
    want = first_match_plain(*args)
    err = require_equal("first_match main shape", got, want)
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
    log(f"K2: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}); matched "
        f"{int((got < NO_MATCH).sum().item())} of {len(baskets)} baskets")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    from fastapriori_tpu_torch.ops import build

    device = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}")
    t0 = time.perf_counter()
    report = build.build()
    log(f"build: {time.perf_counter() - t0:.3f} s {json.dumps(report)}")
    quick_checks(device)
    log("quick checks: both kernels equal their plain versions")

    in_dir, out_dir = os.path.join(WORK, "in"), os.path.join(WORK, "out")
    launches = main_path(in_dir, out_dir)
    cfg, data, levels = mine(in_dir, device)
    k1 = k1_measure(cfg, data, levels, device)
    k2 = k2_measure(in_dir, data, levels, device)
    kernels = [
        {"name": "level_counts", "route": "cuda",
         "source": "fastapriori_tpu_torch/csrc/level_counts.cu",
         "replaces": "fastapriori_tpu/ops/pallas_level.py:57",
         "launches": launches["level_counts"], **k1},
        {"name": "first_match", "route": "cuda",
         "source": "fastapriori_tpu_torch/csrc/first_match.cu",
         "replaces": "fastapriori_tpu/ops/pallas_vertical.py:210",
         "launches": launches["first_match"], **k2},
    ]
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
