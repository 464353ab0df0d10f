"""The port's vertical (Eclat) engine against the JAX package's, on the
reference paths that run on this JAX version (one device, the XLA
vertical engine, and the Pallas kernel called directly in interpret
mode), with exact equality: every output is an integer count or a byte.

- the host arena build, weight bit-planes and compressed upload word for
  word against fastapriori_tpu/ops/vertical.py;
- K3's plain version (ops/vertical_kernel.py) against
  ``vertical_counts_pallas(..., interpret=True)`` and the XLA
  ``vertical_level_local``;
- the pair phase, both branches, against ``vertical_pair_local`` at
  ``axis_name=None``;
- the engine with ``mine_engine="vertical"`` against the JAX engine at
  ``num_devices=1`` and the port's own bitmap engine; the auto rule; the
  strict ``FA_MINE_ENGINE`` parse; the CLI's bytes; and the digests of
  chip_smoke.py's vertical path, recomputed with the JAX CLI.
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
from fastapriori_tpu_torch.device import DeviceContext
from fastapriori_tpu_torch.models import apriori as tv_apriori
from fastapriori_tpu_torch.models.apriori import FastApriori
from fastapriori_tpu_torch.ops import vertical as tv
from fastapriori_tpu_torch.ops.vertical_kernel import (
    lane_plane_mask,
    vertical_counts,
    vertical_counts_plain,
)
from fastapriori_tpu_torch.preprocess import CompressedData, preprocess
from fastapriori_tpu_torch.utils.datagen import (
    generate_transactions,
    generate_user_baskets,
)
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
# host layer: arena, planes, compressed upload


@pytest.mark.parametrize(
    "t, n_items, max_len",
    [(100, 10, 5), (4000, 600, 11), (777, 200, 3)],
    ids=["dense-small", "wide", "sparse"],
)
def test_arena_planes_and_upload_match_jax(t, n_items, max_len):
    indices, offsets = _csr(t, t, n_items, max_len)
    arena, f_pad, t_pad = tv.build_tid_arena_csr(indices, offsets, n_items)
    want, jf, jt = jv.build_tid_arena_csr(indices, offsets, n_items)
    assert (f_pad, t_pad) == (jf, jt)
    assert arena.dtype == np.uint32 and arena.tobytes() == want.tobytes()
    # Words with the top bit set (tid 31 of a lane) are the ones an int32
    # view reads as negative.
    assert (arena[:f_pad] >= np.uint32(1 << 31)).any()

    weights = np.random.default_rng(t).integers(1, 700, size=t)
    planes, scales = tv.weight_bit_planes(weights, t_pad)
    jplanes, jscales = jv.weight_bit_planes(weights, t_pad)
    assert scales == jscales and planes.tobytes() == jplanes.tobytes()

    buckets, payload, stats = tv.compress_arena(arena, f_pad)
    jbuckets, jpayload, jstats = jv.compress_arena(want, f_pad)
    assert (payload, stats) == (jpayload, jstats)
    assert len(buckets) == len(jbuckets)
    for got_b, want_b in zip(buckets, jbuckets):
        for x, y in zip(got_b, want_b):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
    assert tv.compress_arena(arena, f_pad, build=False)[1:] == (payload,
                                                                stats)

    ctx = DeviceContext("cpu")
    for bk in (buckets, None):
        dev, nbytes = ctx.upload_tid_arena(arena, bk)
        assert dev.dtype == torch.int32
        assert dev.numpy().tobytes() == want.tobytes()
        assert nbytes == (payload if bk is not None else arena.nbytes)
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
    arena, f_pad, t_pad = tv.build_tid_arena_csr(indices, offsets, 90)
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
    bitmap, _ = FastApriori(min_support, config=MinerConfig(
        mine_engine="bitmap"), device="cpu").run_file_raw(str(path))
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
    assert {"compressed", "occupancy", "upload_bytes", "wall_ms"} <= set(arena)
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
