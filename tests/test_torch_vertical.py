"""The port's vertical (Eclat) engine against the JAX package's, on the
reference paths that run on this JAX version (one device, the XLA
vertical engine, and the Pallas kernel called directly in interpret
mode), with exact equality: every output is an integer count or a byte.

- the arena built on a CPU context and the weight bit-planes word for
  word against fastapriori_tpu/ops/vertical.py;
- K3's plain version (ops/vertical_kernel.py) against
  ``vertical_counts_pallas(..., interpret=True)`` and the XLA
  ``vertical_level_local``;
- the pair phase, both branches, against ``vertical_pair_local`` at
  ``axis_name=None``;
- the engine with ``mine_engine="vertical"`` against the JAX engine at
  ``num_devices=1`` and the port's own bitmap engine; the auto rule; the
  strict ``FA_MINE_ENGINE`` parse; the CLI's bytes; and the digests of
  chip_smoke.py's vertical path, recomputed with the JAX CLI;
- the arena built from the CSR on the device (ops/vertical_kernel.py
  ``build_arena``, its plain version here) against the JAX package's
  host builder bit for bit; the engine's one build on a CPU and on a
  CUDA context; the bitmap path never reaching it; and the benchmark's
  ``arena_build_device_ms`` reader.
"""

import hashlib
import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastapriori_tpu.cli import main as jax_main
from fastapriori_tpu.config import MinerConfig as JaxConfig
from fastapriori_tpu.models.apriori import FastApriori as JaxApriori
from fastapriori_tpu.ops import vertical as jv
from fastapriori_tpu.ops.pallas_vertical import vertical_counts_pallas
from fastapriori_tpu_torch import InputError
from fastapriori_tpu_torch.cli import main as torch_main
from fastapriori_tpu_torch.config import MinerConfig
from fastapriori_tpu_torch import device as torch_device
from fastapriori_tpu_torch.device import DeviceContext
from fastapriori_tpu_torch.models import apriori as tv_apriori
from fastapriori_tpu_torch.models.apriori import FastApriori
from fastapriori_tpu_torch.ops import vertical as tv
from fastapriori_tpu_torch.ops import vertical_kernel
from fastapriori_tpu_torch.ops import build as kernel_build
from fastapriori_tpu_torch.ops.vertical_kernel import (
    build_arena,
    lane_plane_mask,
    vertical_counts,
    vertical_counts_plain,
)
from fastapriori_tpu_torch.preprocess import CompressedData, preprocess
from fastapriori_tpu_torch.utils.datagen import (
    generate_transactions,
    generate_user_baskets,
)
from portbench import gen
from portbench.tests import records
from test_torch_e2e import JAX_FLAGS, _cli_three_ways, _write_inputs
from test_vertical import (
    _deep_lattice,
    _no_survivor_level,
    _sparse_corpus,
    _t10i4_shaped,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _csr(seed, t, n_items, max_len):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, max_len + 1, size=t)
    indices = np.concatenate(
        [np.sort(rng.choice(n_items, size=s, replace=False)) for s in sizes]
    ).astype(np.int32)
    offsets = np.zeros(t + 1, dtype=np.int64)
    offsets[1:] = np.cumsum(sizes)
    return indices, offsets


# ---------------------------------------------------------------------------
# host layer: shape, planes; the arena built on a CPU context


@pytest.mark.parametrize(
    "t, n_items, max_len",
    [(100, 10, 5), (4000, 600, 11), (777, 200, 3)],
    ids=["dense-small", "wide", "sparse"],
)
def test_arena_planes_and_upload_match_jax(t, n_items, max_len):
    indices, offsets = _csr(t, t, n_items, max_len)
    want, f_pad, t_pad = jv.build_tid_arena_csr(indices, offsets, n_items)
    assert tv.arena_shape(t, n_items) == (f_pad, t_pad)
    ctx = DeviceContext("cpu")
    arena, csr_bytes = ctx.build_tid_arena_on_device(
        indices, offsets, n_items, f_pad, t_pad // 32)
    assert arena.dtype == torch.int32
    assert arena.numpy().tobytes() == want.tobytes()
    assert csr_bytes == indices.size * 4 + offsets.size * 8
    # Words with the top bit set (tid 31 of a lane) are the ones an int32
    # view reads as negative.
    assert (want[:f_pad] >= np.uint32(1 << 31)).any()

    weights = np.random.default_rng(t).integers(1, 700, size=t)
    planes, scales = tv.weight_bit_planes(weights, t_pad)
    jplanes, jscales = jv.weight_bit_planes(weights, t_pad)
    assert scales == jscales and planes.tobytes() == jplanes.tobytes()
    assert ctx.upload_lane_planes(planes).numpy().tobytes() == \
        jplanes.tobytes()


# ---------------------------------------------------------------------------
# K3's plain version


def _k3_case(seed, n_planes, nl=37, f_pad=128, p=24, k=3, c_mult=128):
    """Random arena and planes (top bits set), prefix rows with padded
    positions (f_pad - 1), rows without candidates, candidates in whole
    runs per row including the zero column as an extension, padded up to
    a multiple of ``c_mult`` with zero-column slots of the last row."""
    rng = np.random.default_rng(seed)
    arena = rng.integers(0, 2**32, size=(f_pad + 1, nl), dtype=np.uint64)
    arena = (arena & rng.integers(0, 2**32, size=arena.shape,
                                  dtype=np.uint64)).astype(np.uint32)
    arena[f_pad - 1] = 0
    arena[f_pad] = 0xFFFFFFFF
    planes = rng.integers(0, 2**32, size=(n_planes, nl),
                          dtype=np.uint64).astype(np.uint32)
    prefix = rng.integers(0, f_pad - 1, size=(p, k)).astype(np.int32)
    prefix[rng.random((p, k)) < 0.25] = f_pad - 1
    prefix[-3:] = f_pad - 1  # padded rows
    cand = []
    for row in range(p - 3):
        if row % 5 == 2:
            continue  # a prefix without candidates
        ys = np.sort(rng.choice(f_pad, size=rng.integers(1, 9),
                                replace=False))
        cand += [row * f_pad + y for y in ys]
    cand += [(p - 4) * f_pad + f_pad - 1]
    cand += [(p - 1) * f_pad + f_pad - 1] * (-len(cand) % c_mult)
    return arena, planes, prefix, np.asarray(cand, dtype=np.int32)


@pytest.mark.parametrize("n_planes", [1, 3])
def test_vertical_counts_plain_matches_pallas_and_xla(n_planes):
    arena, planes, prefix, cand = _k3_case(n_planes, n_planes)
    scales = tuple(1 << b for b in range(n_planes))
    want = np.asarray(vertical_counts_pallas(
        jnp.asarray(arena), jnp.asarray(planes), jnp.asarray(prefix),
        jnp.asarray(cand), scales, cand_tile=128, lane_tile=128,
        interpret=True,
    ))
    xla = np.asarray(jv.vertical_level_local(
        jnp.asarray(arena), jnp.asarray(planes), scales,
        jnp.asarray(prefix), jnp.asarray(cand), 64,
    ))
    args = (_t(arena.view(np.int32)), _t(planes.view(np.int32)), scales,
            _t(prefix), _t(cand))
    got = vertical_counts_plain(*args, cand_chunk=50).numpy()
    assert got.dtype == np.int32
    assert (got == want).all() and (got == xla).all()
    assert (got > 0).sum() > len(cand) // 4
    assert (got[cand % 128 == 127] == 0).all()  # the zero column
    vertical_counts.launches = 0
    assert (vertical_counts(*args).numpy() == want).all()
    assert (tv.vertical_level_local(*args, 7).numpy() == want).all()
    assert vertical_counts.launches == 0


@pytest.mark.parametrize("k", [1, 8])
def test_vertical_counts_prefix_widths(k):
    arena, planes, prefix, cand = _k3_case(10 + k, 11, nl=301, k=k,
                                           c_mult=1)
    scales = [1 << b for b in range(11)]
    xla = np.asarray(jv.vertical_level_local(
        jnp.asarray(arena), jnp.asarray(planes), tuple(scales),
        jnp.asarray(prefix), jnp.asarray(cand), 1,
    ))
    got = vertical_counts(_t(arena.view(np.int32)), _t(planes.view(np.int32)),
                          scales, _t(prefix), _t(cand)).numpy()
    assert (got == xla).all()


def test_level_chunks_keep_p_times_f_pad_below_2_31():
    """At f_pad = 131,072 a level with more than 8,192 distinct prefixes
    must be cut into launches of P_cap * f_pad < 2^31 (K3's int32
    candidate indexes; the default level_prefix_cap alone would give
    16,384 * 131,072 = 2^31)."""
    rng = np.random.default_rng(17)
    f_pad = 131_072
    firsts = np.sort(rng.choice(f_pad // 2, size=20_000, replace=False))
    level = np.stack([firsts, firsts + 1], axis=1).astype(np.int32)
    per_row = rng.integers(1, 4, size=level.shape[0])
    x_idx = np.repeat(np.arange(level.shape[0], dtype=np.int64), per_row)
    ys = np.concatenate([
        np.sort(rng.choice(np.arange(row[1] + 1, f_pad - 1), size=n,
                           replace=False))
        for row, n in zip(level, per_row)
    ]).astype(np.int32)
    cfg = MinerConfig()
    assert cfg.level_prefix_cap * f_pad >= 2**31
    arena = torch.zeros((f_pad + 1, 1), dtype=torch.int32)
    planes = torch.ones((1, 1), dtype=torch.int32)
    covered, n_chunks = 0, 0
    for prefix_cols, cand_idx, sl in tv_apriori.level_chunks(
            level, x_idx, ys, f_pad, cfg):
        p = prefix_cols.shape[0]
        assert p * f_pad < 2**31
        assert sl.start == covered  # in order, none skipped or repeated
        covered = sl.stop
        n_chunks += 1
        rows = cand_idx // f_pad
        assert np.array_equal(cand_idx % f_pad, ys[sl])
        assert np.array_equal(prefix_cols[rows], level[x_idx[sl]])
        args = (arena, planes, [1], torch.from_numpy(prefix_cols),
                torch.from_numpy(cand_idx.astype(np.int32)))
        vertical_kernel._check(*args)
        vertical_kernel._check_contract(args[0], args[3], args[4])
    assert covered == x_idx.size
    assert n_chunks >= 3  # 20,000 prefixes at 8,192 a launch


def test_vertical_counts_refuses_what_breaks_the_contract():
    arena, planes, prefix, cand = _k3_case(5, 2)
    args = [_t(arena.view(np.int32)), _t(planes.view(np.int32)), [1, 2],
            _t(prefix), _t(cand)]
    unsorted = cand.copy()
    unsorted[[0, -1]] = unsorted[[-1, 0]]
    wide = prefix.copy()
    wide[0, 0] = 129
    for i, bad, msg in ((4, unsorted, "whole runs"),
                        (4, cand + 24 * 128, r"\[0, P \* f_pad\)"),
                        (3, wide, r"\[0, 128\]"),
                        (2, [1, 3], "powers of two")):
        case = list(args)
        case[i] = _t(np.asarray(bad, dtype=np.int32)) if i > 2 else bad
        with pytest.raises(ValueError, match=msg):
            vertical_counts(*case)


@pytest.mark.parametrize("max_weight", [1, 700, 2**31 - 1])
def test_lane_plane_mask_encodes_the_jax_planes(max_weight):
    # Bit b of lane l is set iff plane b of the JAX package's bit-planes is
    # non-zero there: the planes K3 reads for a non-zero intersection word.
    rng = np.random.default_rng(max_weight % 1000)
    t = 2000
    weights = rng.integers(1, max_weight + 1, size=t)
    weights[:200] = 1  # lanes of weight-1 transactions: plane 0 only
    t_pad = -(-t // 32) * 32 + 64  # two all-padding lanes
    jplanes, _ = jv.weight_bit_planes(weights, t_pad)
    jplanes = np.asarray(jplanes)
    ctx = DeviceContext("cpu")
    planes = ctx.upload_lane_planes(jplanes)
    mask = lane_plane_mask(planes)
    assert mask.dtype == torch.int32 and mask.shape == (jplanes.shape[1],)
    want = ((jplanes != 0).astype(np.int64)
            << np.arange(jplanes.shape[0])[:, None]).sum(axis=0)
    assert (mask.numpy().astype(np.int64) & 0xFFFFFFFF == want).all()
    assert (mask.numpy()[:6] == 1).all() and (mask.numpy()[-2:] == 0).all()
    # Derived once per upload: the same tensor gives the cached mask ...
    assert lane_plane_mask(planes) is mask
    # ... until it is changed in place, or another tensor comes.
    planes[:, 0] = 0
    assert lane_plane_mask(planes)[0] == 0
    other = planes.clone()
    assert lane_plane_mask(other) is not lane_plane_mask(planes)


def _k3_by_listed_lanes(arena, planes, prefix, cand):
    """K3's decomposition in numpy: per prefix row only its non-zero AND
    words, and per intersection word only the planes its lane mask names."""
    f_pad = arena.shape[0] - 1
    mask = ((planes != 0).astype(np.int64)
            << np.arange(planes.shape[0])[:, None]).sum(axis=0)
    popc = np.vectorize(lambda v: bin(int(v)).count("1"))
    out = np.zeros(cand.shape[0], dtype=np.int64)
    for c, ix in enumerate(cand):
        row, y = divmod(int(ix), f_pad)
        cols = np.where(prefix[row] == f_pad - 1, f_pad, prefix[row])
        pref = np.bitwise_and.reduce(arena[cols], axis=0)
        listed = np.nonzero(pref)[0]
        x = pref[listed] & arena[y, listed]
        for lane, word in zip(listed[x != 0], x[x != 0]):
            for b in range(planes.shape[0]):
                if (mask[lane] >> b) & 1:
                    out[c] += int(popc(word & planes[b, lane])) << b
    return out.astype(np.int32)


@pytest.mark.parametrize("n_planes", [2, 5])
def test_k3_listed_lane_decomposition_matches_pallas(n_planes):
    arena, planes, prefix, cand = _k3_case(20 + n_planes, n_planes, nl=45)
    planes[1:, 10:30] = 0  # lanes whose planes above 0 are zero
    arena[3] = 0  # an item in no transaction: empty intersections
    scales = tuple(1 << b for b in range(n_planes))
    want = np.asarray(vertical_counts_pallas(
        jnp.asarray(arena), jnp.asarray(planes), jnp.asarray(prefix),
        jnp.asarray(cand), scales, cand_tile=128, lane_tile=128,
        interpret=True,
    ))
    assert (_k3_by_listed_lanes(arena, planes, prefix, cand) == want).all()
    assert (want > 0).sum() > len(cand) // 4


# ---------------------------------------------------------------------------
# the pair phase


@pytest.mark.parametrize("fast_f32", [True, False])
@pytest.mark.parametrize("n_chunks", [1, 4])
def test_vertical_pair_local_matches_jax(fast_f32, n_chunks):
    indices, offsets = _csr(3, 1200, 90, 8)
    arena, f_pad, t_pad = jv.build_tid_arena_csr(indices, offsets, 90)
    weights = np.random.default_rng(4).integers(1, 300, size=1200)
    planes, scales = tv.weight_bit_planes(weights, t_pad)
    _, want = jv.vertical_pair_local(
        jnp.asarray(arena), jnp.asarray(planes), tuple(scales),
        jnp.int32(1), jnp.int32(90), 64, n_chunks, fast_f32=fast_f32,
    )
    got = tv.vertical_pair_local(
        _t(arena.view(np.int32)), _t(planes.view(np.int32)), scales,
        n_chunks, fast_f32=fast_f32,
    ).numpy()
    assert got.dtype == np.int32
    assert (got == np.asarray(want)).all()
    assert got[:90, :90].sum() > 0


# ---------------------------------------------------------------------------
# the engine


def _heavy_t10i4():
    # Repeated baskets: weights up to 300, so 9 bit-planes.
    return _t10i4_shaped() + [["1", "2", "3"]] * 300


def _levels_equal(got, want):
    assert len(got) == len(want)
    for (gm, gc), (wm, wc) in zip(got, want):
        assert gm.shape == wm.shape
        assert (gm == wm).all() and (gc == wc).all()


@pytest.mark.parametrize(
    "lines_fn, min_support",
    [
        (_t10i4_shaped, 0.03),
        (_heavy_t10i4, 0.03),
        (_deep_lattice, 0.05),
        (_no_survivor_level, 0.4),
    ],
    ids=["t10i4", "t10i4-heavy", "deep-lattice", "no-survivor"],
)
def test_vertical_engine_matches_jax_and_bitmap(tmp_path, lines_fn,
                                                min_support):
    lines = lines_fn()
    path = tmp_path / "D.dat"
    path.write_text("".join(" ".join(x) + "\n" for x in lines))
    j_levels, _ = JaxApriori(min_support, config=JaxConfig(
        engine="level", num_devices=1, mine_engine="vertical",
    )).run_file_raw(str(path))
    got, data = FastApriori(min_support, config=MinerConfig(
        mine_engine="vertical"), device="cpu").run_file_raw(str(path))
    # The bitmap layout's level engine, as on the JAX side (auto takes the
    # fused engine there, whose levels stop before an empty one).
    bitmap, _ = FastApriori(min_support, config=MinerConfig(
        mine_engine="bitmap", engine="level"),
        device="cpu").run_file_raw(str(path))
    _levels_equal(got, j_levels)
    _levels_equal(got, bitmap)
    assert len(got) >= 1


def test_vertical_engine_metrics(capsys, monkeypatch):
    def no_bitmap(*args, **kwargs):
        raise AssertionError("the vertical engine counted with K1")

    monkeypatch.setattr(tv_apriori, "local_level_gather", no_bitmap)
    monkeypatch.setattr(tv_apriori, "local_pair_counts", no_bitmap)
    miner = FastApriori(0.03, config=MinerConfig(
        mine_engine="vertical", log_metrics=True), device="cpu")
    miner.mine_levels_raw(preprocess(_heavy_t10i4(), 0.03))
    events = [json.loads(x) for x in capsys.readouterr().err.splitlines()]
    by = {e["event"]: e for e in events}
    assert by["mine_engine"]["engine"] == "vertical"
    assert by["mine_engine"]["requested"] == "vertical"
    assert 0 < by["mine_engine"]["density"] < 1
    arena = by["arena_build"]
    assert arena["planes"] == 9 and arena["shape"][0] == 129
    assert {"csr_bytes", "upload_bytes", "wall_ms"} <= set(arena)
    assert not {"built", "compressed", "occupancy", "threads"} & set(arena)
    assert arena["upload_bytes"] == arena["csr_bytes"] + 9 * (
        arena["shape"][1] * 4) and arena["csr_bytes"] > 0
    levels = [e for e in events if e["event"] == "level"]
    assert levels[0]["engine"] == "vertical" and len(levels) >= 3
    assert all(e["launches"] >= 1 for e in levels[1:])


def _jax_choice(lines, min_support, mine_engine="auto"):
    miner = JaxApriori(config=JaxConfig(
        min_support=min_support, engine="level", num_devices=1,
        mine_engine=mine_engine,
    ))
    miner.run(lines)
    (rec,) = [r for r in miner.metrics.records
              if r.get("event") == "mine_engine"]
    return rec["engine"]


@pytest.mark.parametrize(
    "lines_fn, min_support, want",
    [(_sparse_corpus, 0.001, "vertical"), (_t10i4_shaped, 0.03, "bitmap")],
    ids=["sparse", "t10i4"],
)
def test_auto_rule_matches_jax(lines_fn, min_support, want):
    lines = lines_fn()
    data = preprocess(lines, min_support)
    miner = FastApriori(min_support, device="cpu")
    engine, requested, density = miner._mine_engine(data)
    assert (engine, requested) == (want, "auto")
    assert engine == _jax_choice(lines, min_support)
    assert density == tv_apriori.density_from_tables(
        data.n_raw, data.num_items, float(data.item_counts.sum()))


def test_forced_vertical_without_csr_raises():
    data = preprocess(_deep_lattice(), 0.05)
    gutted = CompressedData(
        n_raw=data.n_raw, min_count=data.min_count,
        freq_items=data.freq_items, item_to_rank=data.item_to_rank,
        item_counts=data.item_counts,
        basket_indices=np.empty(0, np.int32),
        basket_offsets=np.zeros(1, np.int64), weights=data.weights,
    )
    auto = FastApriori(0.05, device="cpu")
    assert auto._mine_engine(gutted)[0] == "bitmap"
    forced = FastApriori(0.05, config=MinerConfig(mine_engine="vertical"),
                         device="cpu")
    with pytest.raises(InputError, match="CSR"):
        forced.mine_levels_raw(gutted)


def test_mine_engine_parsed_strictly(monkeypatch, tmp_path, capsys):
    data = preprocess(_deep_lattice(), 0.05)
    with pytest.raises(InputError, match="mine_engine"):
        FastApriori(0.05, config=MinerConfig(mine_engine="eclat"),
                    device="cpu").mine_levels_raw(data)
    monkeypatch.setenv("FA_MINE_ENGINE", "verticl")
    with pytest.raises(InputError, match="FA_MINE_ENGINE"):
        FastApriori(0.05, device="cpu").mine_levels_raw(data)
    inp = _write_inputs(tmp_path, ["1 2 3", "2 3"], ["1"])
    rc = torch_main([inp, str(tmp_path / "out_torch") + "/",
                     "--platform", "cpu"])
    assert rc == 2
    assert "FA_MINE_ENGINE" in capsys.readouterr().err
    # The environment wins over the config, case-insensitively.
    monkeypatch.setenv("FA_MINE_ENGINE", " Bitmap ")
    miner = FastApriori(0.05, config=MinerConfig(mine_engine="vertical"),
                        device="cpu")
    assert miner._mine_engine(data)[:2] == ("bitmap", "bitmap")


@pytest.mark.parametrize("seed", [0, 7])
def test_cli_vertical_matches_jax_cli_and_oracle(tmp_path, monkeypatch,
                                                 seed):
    calls = []
    real = tv_apriori.vertical_level_local

    def spy(*args):
        calls.append(args[4].shape[0])
        return real(*args)

    monkeypatch.setattr(tv_apriori, "vertical_level_local", spy)
    monkeypatch.setenv("FA_MINE_ENGINE", "vertical")
    _cli_three_ways(
        tmp_path,
        generate_transactions(n_txns=2500, n_items=300, avg_txn_len=6,
                              seed=seed),
        generate_user_baskets(n_users=400, n_items=300, seed=seed + 1),
        0.005,
    )
    assert calls and sum(calls) > 100


def test_chip_smoke_vertical_digests_are_the_jax_packages(tmp_path,
                                                          monkeypatch):
    """The kosarak-shape vertical path of chip_smoke.py: the JAX CLI with
    FA_MINE_ENGINE=vertical on the port's datagen corpus writes the
    digests the GPU run must match."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py")
    )
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    corpus = smoke.KOSARAK
    inp = _write_inputs(
        tmp_path,
        generate_transactions(n_txns=corpus["n_txns"],
                              n_items=corpus["n_items"],
                              avg_txn_len=corpus["avg_txn_len"],
                              seed=corpus["seed"]),
        generate_user_baskets(n_users=corpus["n_users"],
                              n_items=corpus["n_items"],
                              seed=corpus["user_seed"]),
    )
    monkeypatch.setenv("FA_MINE_ENGINE", "vertical")
    out = str(tmp_path / "out_jax") + "/"
    assert jax_main([inp, out, "--min-support", corpus["min_support"],
                     *JAX_FLAGS]) == 0
    for name, want in (("freqItemset", corpus["freq_sha256"]),
                       ("recommends", corpus["rec_sha256"])):
        got = hashlib.sha256((tmp_path / "out_jax" / name).read_bytes())
        assert got.hexdigest() == want


# ---------------------------------------------------------------------------
# the arena built from the CSR on the device


def _t20_config(**cut):
    """The T20 cell's configuration (Quest T20.I6 over 10,000 ids) with
    ``cut`` laid over it."""
    with open(os.path.join(ROOT, "portbench", "configs",
                           "t20i6d100k-n10k.json")) as f:
        cfg = json.load(f)
    cfg.update(cut)
    return cfg


def _t20_inputs(tmp_path):
    """The T20 cell's inputs at a small size, written under ``in/``, and
    the cell's min support."""
    cfg = _t20_config(n_txns=1500, n_users=200)
    made = gen.make_inputs(cfg, 4300002227)
    d = tmp_path / "in"
    d.mkdir()
    for name in ("D.dat", "U.dat"):
        (d / name).write_bytes(made[name])
    return str(d) + "/", float(cfg["min_support"])


def _arena_case(name):
    """``(indices, offsets, num_items, txn_multiple)`` of one case."""
    if name == "t20":
        cfg = _t20_config(n_txns=700, n_users=1)
        rows = gen.make_inputs(cfg, 11)["D.dat"].decode().splitlines()
        data = preprocess([r.split() for r in rows],
                          float(cfg["min_support"]))
        return (data.basket_indices, data.basket_offsets, data.num_items,
                32)
    if name == "empty":
        return np.empty(0, np.int32), np.zeros(1, np.int64), 7, 32
    if name == "60k":
        rng = np.random.default_rng(2)
        sizes = rng.integers(2, 12, size=60_000)
        indices = np.concatenate([np.sort(rng.choice(400, size=s,
                                                     replace=False))
                                  for s in sizes])
        offsets = np.concatenate([[0], np.cumsum(sizes)])
        return indices.astype(np.int32), offsets.astype(np.int64), 400, 32
    t, n_items, max_len, mult = {
        "ragged": (45, 20, 6, 32), "mult64": (130, 50, 9, 64),
        "mult96": (200, 300, 4, 96), "unused": (300, 400, 3, 32),
        "every-basket": (77, 12, 5, 32)}[name]
    indices, offsets = _csr(t, t, n_items // 3 if name == "unused"
                            else n_items, max_len)
    if name == "unused":
        indices = indices * 3  # two ids in three never occur
    if name == "every-basket":
        # Item 4 joins every basket that lacks it.
        rows = [sorted(set(indices[a:b].tolist()) | {4})
                for a, b in zip(offsets[:-1], offsets[1:])]
        indices = np.concatenate(rows)
        offsets = np.concatenate([[0], np.cumsum([len(r) for r in rows])])
    return indices.astype(np.int32), offsets.astype(np.int64), n_items, mult


@pytest.mark.parametrize("case", ["empty", "ragged", "mult64", "mult96",
                                  "unused", "every-basket", "t20", "60k"])
def test_build_arena_plain_matches_the_host_builder(case):
    """The port's shape rule and the plain device build give the JAX
    package's host-built arena, bit for bit."""
    indices, offsets, n_items, mult = _arena_case(case)
    want, f_pad, t_pad = jv.build_tid_arena_csr(indices, offsets, n_items,
                                                mult)
    assert tv.arena_shape(len(offsets) - 1, n_items, mult) == (f_pad, t_pad)
    got = build_arena(_t(indices), _t(offsets), n_items, f_pad, t_pad // 32)
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert got.numpy().tobytes() == want.tobytes()
    if case == "every-basket":
        assert (want[4, : (len(offsets) - 1) // 32] == 0xFFFFFFFF).all()
    if case == "t20":
        assert len(offsets) - 1 > 32 and (want[:f_pad] >> 31).any()
    ctx = DeviceContext("cpu")
    arena, csr_bytes = ctx.build_tid_arena_on_device(
        indices, offsets, n_items, f_pad, t_pad // 32)
    assert arena.numpy().tobytes() == want.tobytes()
    assert csr_bytes == indices.size * 4 + offsets.size * 8


def test_build_arena_refuses_what_breaks_its_contract():
    indices, offsets = _csr(5, 40, 10, 4)
    ok = (_t(indices), _t(offsets), 10, 128, 2)
    build_arena(*ok)
    with pytest.raises(ValueError, match="indices must lie"):
        build_arena(_t(indices), _t(offsets), 5, 128, 2)
    with pytest.raises(ValueError, match="do not fit"):
        build_arena(_t(indices), _t(offsets), 10, 128, 1)  # 40 > 32 lanes
    with pytest.raises(ValueError, match="do not fit"):
        build_arena(_t(indices), _t(offsets), 128, 128, 2)  # no zero row
    with pytest.raises(ValueError, match="int64"):
        build_arena(_t(indices), _t(offsets.astype(np.int32)), 10, 128, 2)


def _arena_events(err):
    return [json.loads(x) for x in err.splitlines()
            if x.startswith("{") and '"arena_build"' in x]


def _run_cli(in_dir, out_dir, min_support):
    return torch_main([in_dir, out_dir, "--min-support", repr(min_support),
                       "--platform", "cpu", "--metrics"])


def test_mine_vertical_builds_on_the_host_on_a_cpu_context(
        tmp_path, monkeypatch, capsys):
    """A CPU context, whose device is the host, builds its arena the
    card's way: one call of the context's device build (the plain
    version here), and the event's fields are the card path's."""
    calls = []
    real_build = DeviceContext.build_tid_arena_on_device

    def counted(self, *args, **kwargs):
        calls.append((args[2:], kwargs))
        return real_build(self, *args, **kwargs)

    monkeypatch.setattr(DeviceContext, "build_tid_arena_on_device", counted)
    monkeypatch.setenv("FA_MINE_ENGINE", "vertical")
    in_dir, ms = _t20_inputs(tmp_path)
    assert _run_cli(in_dir, str(tmp_path / "out") + "/", ms) == 0
    (ev,) = _arena_events(capsys.readouterr().err)
    ((n_items, f_pad, nl), kwargs), = calls
    assert kwargs == {"plain": False}
    assert ev["shape"] == [f_pad + 1, nl] and ev["csr_bytes"] > 0
    assert ev["upload_bytes"] == ev["csr_bytes"] + ev["planes"] * nl * 4
    assert not {"built", "compressed", "occupancy", "threads",
                "plain_kernels", "shards"} & set(ev)


class _CardView(DeviceContext):
    """A CPU context that reads as a CUDA one: it shares the real
    context's state, and its arena build runs the plain version on the
    CPU tensors."""

    platform = property(lambda self: "cuda")


def test_mine_vertical_builds_on_the_card_on_a_cuda_context(
        tmp_path, monkeypatch, capsys):
    """The vertical engine over a CUDA context takes the device build
    once, with the kernel (not ``plain``), and writes the JAX CLI's
    bytes on the same inputs."""
    monkeypatch.setenv("FA_MINE_ENGINE", "vertical")
    in_dir, ms = _t20_inputs(tmp_path)
    jax_out = str(tmp_path / "jax") + "/"
    assert jax_main([in_dir, jax_out, "--min-support", repr(ms),
                     *JAX_FLAGS]) == 0

    built = []
    real_build = DeviceContext.build_tid_arena_on_device
    real_mine = FastApriori._mine_vertical

    def on_card_build(self, *args, **kwargs):
        built.append((args[2:], kwargs))
        return real_build(self, *args, **kwargs)

    def on_card_mine(self, data):
        ctx = self.ctx
        view = object.__new__(_CardView)
        view.__dict__ = ctx.__dict__
        self.ctx = view
        try:
            return real_mine(self, data)
        finally:
            self.ctx = ctx

    monkeypatch.setattr(DeviceContext, "build_tid_arena_on_device",
                        on_card_build)
    monkeypatch.setattr(FastApriori, "_mine_vertical", on_card_mine)
    card_out = str(tmp_path / "card") + "/"
    capsys.readouterr()
    assert _run_cli(in_dir, card_out, ms) == 0
    (ev,) = _arena_events(capsys.readouterr().err)
    assert "plain_kernels" not in ev and len(built) == 1
    (n_items, f_pad, nl), kwargs = built[0]
    assert kwargs == {"plain": False}
    assert [f_pad + 1, nl] == ev["shape"]
    assert ev["csr_bytes"] > 0
    assert ev["upload_bytes"] == ev["csr_bytes"] + ev["planes"] * nl * 4
    for name in ("freqItemset", "recommends"):
        with open(jax_out + name, "rb") as a, open(card_out + name,
                                                   "rb") as b:
            want = a.read()
            assert want and b.read() == want


def test_bitmap_path_never_reaches_the_device_arena_build(
        tmp_path, monkeypatch, capsys):
    """A T10-shaped job takes the bitmap layout: no device arena build
    and no ``arena_build`` event.  The ``build.load`` half of the guard
    bites only where kernel libraries load, on the card; chip_smoke.py
    holds the arena kernel's launch count to the vertical runs' events
    there."""
    calls = []

    def record(name):
        return lambda *a, **k: calls.append(name)

    monkeypatch.delenv("FA_MINE_ENGINE", raising=False)
    monkeypatch.setattr(vertical_kernel, "build_arena", record("kernel"))
    monkeypatch.setattr(torch_device, "build_arena", record("kernel"))
    monkeypatch.setattr(DeviceContext, "build_tid_arena_on_device",
                        record("context"))
    monkeypatch.setattr(kernel_build, "load", record("load"))
    inp = _write_inputs(tmp_path, [" ".join(x) for x in _t10i4_shaped()],
                        ["1 2", "3"])
    assert _run_cli(inp, str(tmp_path / "out_torch") + "/", 0.03) == 0
    err = capsys.readouterr().err
    assert '"bitmap_build"' in err and not _arena_events(err)
    assert calls == []


class _ReaderRun:
    def __init__(self, spans, jobs, trace_):
        self.records = {"jobs": jobs, "spans": spans, "trace": trace_}


def test_arena_build_device_ms_reads_the_kernels_under_arena_build():
    read = records.reader("arena_build_device_ms").read
    jobs = [(0.0, 10.0), (10.0, 20.0)]
    rows = [("arena_build", 1.0, 2.0), ("level", 2.0, 4.0),
            ("arena_build", 11.0, 12.0), ("level", 12.0, 14.0)]
    ops = [("kernel", 1.2, 0.010), ("kernel", 1.4, 0.020),
           ("gpu_memcpy", 1.1, 0.300),   # the CSR's copy, not a kernel
           ("kernel", 3.0, 0.500),       # level 2
           ("kernel", 11.5, 0.030)]
    got = read(_ReaderRun(records.spans(rows), jobs,
                          records.device_trace(ops)))
    assert got == pytest.approx((0.010 + 0.020 + 0.030) * 1e3 / 2)
    # None without a kernel under arena_build, or without the span.
    assert read(_ReaderRun(records.spans(rows), jobs, records.device_trace(
        [op for op in ops if op[0] != "kernel" or op[1] == 3.0]))) is None
    assert read(_ReaderRun(records.spans(rows[1::2]), jobs,
                           records.device_trace(ops))) is None
