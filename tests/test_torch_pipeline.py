"""The port's pipelined capture ingest and its ingest-overlapped pair +
level-3 program against the JAX package's, on the CPU: the same
CompressedData array for array at equal block and thread counts (with
and without the basket CSR), the same levels, the packed pair and
level-3 outputs element for element, the overflow fallbacks with their
remembered budgets, the layout probe, and the CLI's bytes against the
JAX CLI's and the oracle's.

The JAX side runs on one CPU device (``DeviceContext(num_devices=1)``,
``engine="level"``), where its capture ingest runs as on one chip.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_dataset
from fastapriori_tpu import oracle
from fastapriori_tpu.cli import main as jax_main
from fastapriori_tpu.config import MinerConfig as JaxConfig
from fastapriori_tpu.models.apriori import FastApriori as JaxApriori
from fastapriori_tpu.ops import bitmap as jbitmap
from fastapriori_tpu.ops import count as jcount
from fastapriori_tpu.ops.fused import _unpack as jax_unpack
from fastapriori_tpu.parallel.mesh import DeviceContext as JaxContext
from fastapriori_tpu_torch import native as port_native
from fastapriori_tpu_torch.cli import main as torch_main
from fastapriori_tpu_torch.config import MinerConfig
from fastapriori_tpu_torch import device as device_mod
from fastapriori_tpu_torch.device import DeviceContext
from fastapriori_tpu_torch.io.reader import tokenize_line
from fastapriori_tpu_torch.models.apriori import (
    FastApriori,
    weight_digit_count,
)
from fastapriori_tpu_torch.ops import bitmap as tbitmap
from fastapriori_tpu_torch.ops import count as tcount
from fastapriori_tpu_torch.ops.level_kernel import FORMS, level_counts
from test_torch_e2e import JAX_FLAGS, _write_inputs
from test_vertical import _sparse_corpus, _t10i4_shaped

FIELDS = ("n_raw", "min_count", "freq_items", "item_to_rank")
ARRAYS = ("item_counts", "basket_indices", "basket_offsets", "weights")


@pytest.fixture(scope="module", autouse=True)
def _library_builds():
    assert port_native.native_available(), port_native.unavailable_reason()


def _heavy_lines():
    """One basket repeated 1,500 times, spread over the whole file (so
    every block holds it, more than 128 times at 8 blocks), a second
    heavy basket in one stretch that a block boundary cuts, random lines
    and empty or blank ones."""
    rand = random_dataset(37, n_txns=1500, n_items=20, max_len=9)
    lines = []
    for i, line in enumerate(rand):
        lines += [line, "4 7 9 11"]
        if i == 700:
            lines += ["2 3 5"] * 400
    return lines + ["", "  "] * 10


def _write(tmp_path, lines):
    path = tmp_path / "D.dat"
    path.write_text("".join(x + "\n" for x in lines))
    return str(path)


def _jax_run(path, min_support, **cfg):
    miner = JaxApriori(
        config=JaxConfig(min_support=min_support, engine="level", **cfg),
        context=JaxContext(num_devices=1),
    )
    return miner.run_file_raw(path) + (miner,)


def _port_run(path, min_support, context=None, **cfg):
    # The level engine, as on the JAX side (auto takes the fused engine
    # on such small corpora: tests/test_torch_fused.py).
    cfg.setdefault("engine", "level")
    miner = FastApriori(
        config=MinerConfig(min_support=min_support, **cfg),
        device="cpu", context=context,
    )
    return miner.run_file_raw(path) + (miner,)


def _levels_equal(got, want):
    assert len(got) == len(want)
    for (gm, gc), (wm, wc) in zip(got, want):
        assert gm.dtype == wm.dtype == np.int32
        assert gm.shape == wm.shape and (gm == wm).all()
        assert (gc == wc).all()


def _data_equal(got, want):
    for name in FIELDS:
        assert getattr(got, name) == getattr(want, name)
    for name in ARRAYS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name


def _events(miner, event, **match):
    return [r for r in miner.metrics.records if r["event"] == event
            and all(r.get(k) == v for k, v in match.items())]


@pytest.mark.parametrize("retain_csr", [True, False])
@pytest.mark.parametrize("blocks, threads", [(2, 1), (4, 3), (8, 2)])
def test_capture_ingest_matches_jax(tmp_path, blocks, threads, retain_csr):
    path = _write(tmp_path, _heavy_lines())
    knobs = dict(ingest_pipeline_blocks=blocks, ingest_threads=threads,
                 retain_csr=retain_csr)
    want_levels, want_data, jminer = _jax_run(path, 0.01, **knobs)
    got_levels, got_data, miner = _port_run(path, 0.01, **knobs)
    _data_equal(got_data, want_data)
    _levels_equal(got_levels, want_levels)
    assert len(got_levels) >= 4
    if not retain_csr:
        assert got_data.basket_indices.size == 0
        assert got_data.basket_offsets.tolist() == [0]
    (pre,) = _events(miner, "preprocess")
    assert pre["pipelined"] and pre["capture"] and pre["native"]
    assert pre["threads"] == threads and pre["engine"] == "bitmap"
    assert {"pass1_s", "pass2_s", "pack_s"} <= set(pre)
    (bb,) = _events(miner, "bitmap_build")
    (jbb,) = _events(jminer, "bitmap_build")
    for key in ("shape", "digits", "blocks", "heavy_rows",
                "pair_overlapped", "upload_bytes"):
        assert bb[key] == jbb[key], key
    assert bb["heavy_rows"] > 0 and bb["pair_overlapped"]
    # The pair program's level 3: K1 once per digit of the raw weights
    # (the level engine's one digit and heavy rows apart).
    assert bb["l3_digits"] == 2 and bb["digits"] == 1
    assert bb["l3_form"] in FORMS and bb["l3_rows"] == 1 << 13
    for k in (2, 3):
        (lv,) = _events(miner, "level", k=k)
        assert lv["overlapped"] and lv["dispatches"] == 0
    # Level 4 counted by K1's plain version.
    (lv4,) = _events(miner, "level", k=4)
    assert lv4["launches"] >= 1 and "overlapped" not in lv4


def test_pipeline_off_runs_the_one_call_scan(tmp_path):
    path = _write(tmp_path, _heavy_lines())
    want, _, _ = _jax_run(path, 0.01, ingest_pipeline_blocks=2,
                          ingest_threads=2)
    got, data, miner = _port_run(path, 0.01, ingest_pipeline_blocks=1)
    _levels_equal(got, want)
    (pre,) = _events(miner, "preprocess")
    assert pre["pipelined"] is False and pre["native"] is True
    (lv2,) = _events(miner, "level", k=2)
    (lv3,) = _events(miner, "level", k=3)
    assert not lv2["overlapped"] and lv2["dispatches"] == 1
    assert not lv3["overlapped"] and lv3["dispatches"] == lv3["launches"]
    _, one_call, _ = _jax_run(path, 0.01, ingest_pipeline_blocks=1)
    _data_equal(data, one_call)


def _counts_case(seed, f=128, n_items=100, t=300, w_hi=40):
    rng = np.random.default_rng(seed)
    b = (rng.random((t, f)) < 0.3).astype(np.int8)
    b[:, n_items:] = 0
    w = rng.integers(1, w_hi, size=t).astype(np.int32)
    counts = (b.T.astype(np.int64) @ (b * w[:, None]).astype(np.int64))
    return b, w, counts.astype(np.int32)


@pytest.mark.parametrize("census", [True, False])
@pytest.mark.parametrize("cap", [16, 4096])
def test_pair_threshold_pack_matches_jax(cap, census):
    _, _, counts = _counts_case(1)
    min_count = int(np.quantile(counts, 0.8))
    want = np.asarray(jcount.pair_threshold_pack(
        jnp.asarray(counts), jnp.int32(min_count), jnp.int32(100), cap,
        census))
    got = tcount.pair_threshold_pack(torch.from_numpy(counts), min_count,
                                     100, cap, census).numpy()
    assert got.dtype == np.int32 and np.array_equal(got, want)
    assert want[2 * cap] > 16  # more survivors than the small budget
    # The regather at a larger budget, from the same mask.
    w_idx, w_cnt, w_n2 = jcount.local_pair_regather(
        jnp.asarray(counts), jnp.int32(min_count), jnp.int32(100), 2 * cap)
    g_idx, g_cnt, g_n2 = tcount.local_pair_regather(
        torch.from_numpy(counts), min_count, 100, 2 * cap)
    assert np.array_equal(g_idx.numpy(), np.asarray(w_idx))
    assert np.array_equal(g_cnt.numpy(), np.asarray(w_cnt))
    assert int(g_n2) == int(w_n2)


@pytest.mark.parametrize("density", [0.05, 0.5, 1.0])
def test_pair_triangles_match_jax(density):
    rng = np.random.default_rng(int(density * 100))
    mask = np.triu(rng.random((96, 96)) < density, k=1)
    want = int(jcount._pair_triangles(jnp.asarray(mask)))
    got = tcount._pair_triangles(torch.from_numpy(mask))
    assert got.dtype == torch.int32 and int(got) == want > 0


@pytest.mark.parametrize("p3, cap3, w_hi, n_items, digits", [
    pytest.param(64, 8, 40, 100, 1, id="64-8"),
    pytest.param(4096, 4096, 40, 100, 1, id="4096-4096"),
    pytest.param(16, 4096, 40, 100, 1, id="16-4096"),
    # Weights of two and three base-128 digits: one K1 launch each.
    pytest.param(4096, 4096, 2000, 100, 2, id="two-digits"),
    pytest.param(4096, 4096, 40000, 100, 3, id="three-digits"),
    # At most 780 frequent pairs in 8,192 slots: mostly padding rows.
    pytest.param(8192, 4096, 40, 40, 1, id="mostly-padding"),
    # n2 > p3 and n3 > cap3 with weights of two digits.
    pytest.param(64, 8, 2000, 100, 2, id="both-overflow-two-digits"),
])
def test_l3_threshold_pack_matches_jax(p3, cap3, w_hi, n_items, digits):
    b, w, counts = _counts_case(2, t=384, n_items=n_items, w_hi=w_hi)
    # About the mean support of a triple: most pairs are frequent.
    min_count = 230 * w_hi // 40
    cap = max(4096, p3)
    pair = jcount.pair_threshold_pack(
        jnp.asarray(counts), jnp.int32(min_count), jnp.int32(n_items), cap,
        True)
    mask = jcount.frequent_pair_mask(
        jnp.asarray(counts), jnp.int32(min_count), jnp.int32(n_items))
    want = np.asarray(jcount.l3_threshold_pack(
        jnp.asarray(b), jnp.asarray(w, dtype=jnp.float32), mask,
        pair[:cap], pair[2 * cap], jnp.int32(min_count),
        jnp.int32(n_items), p3, cap3, 3))
    t_counts = torch.from_numpy(counts)
    t_pair = tcount.pair_threshold_pack(t_counts, min_count, n_items, cap,
                                        True)
    assert weight_digit_count(int(w.max())) == digits
    got = tcount.l3_threshold_pack(
        torch.from_numpy(b), torch.from_numpy(w),
        tcount.frequent_pair_mask(t_counts, min_count, n_items),
        t_pair[2 * cap], min_count, n_items, p3, cap3, digits, level_counts,
    ).numpy()
    assert got.dtype == np.int32 and np.array_equal(got, want)
    assert want[-1] > 8  # level-3 survivors, past the smallest budget
    if p3 == 8192:
        assert 10 * int(t_pair[2 * cap]) < p3


@pytest.mark.parametrize("w_hi, digits", [(40, 1), (2000, 2), (40000, 3)])
def test_pair_program_level3_runs_k1_once_per_digit(monkeypatch, w_hi,
                                                     digits):
    """The pair program's level 3 (device.py ``ingest_pair_miner``) from
    two uploaded packed blocks with tail padding: K1 once per base-128
    digit of the raw weights, and the level-3 section equal to the
    weighted supports computed in float64."""
    b, w, counts = _counts_case(5, t=384, w_hi=w_hi)
    min_count = 230 * w_hi // 40
    cap, p3, cap3, t_pad = 8192, 8192, 1 << 16, 416
    calls = []

    def counting(*args, **kw):
        calls.append(kw["form"])
        return level_counts(*args, **kw)

    monkeypatch.setattr(device_mod, "level_counts", counting)
    pk = np.packbits(b, axis=1)
    bitmap, packed, dev_counts = DeviceContext("cpu").ingest_pair_miner(
        [torch.from_numpy(pk[:200]), torch.from_numpy(pk[200:])],
        [torch.from_numpy(w[:200]), torch.from_numpy(w[200:])],
        t_pad, min_count, 100, cap, True,
        (p3, cap3, weight_digit_count(int(w.max())), "dense"),
    )
    assert calls == ["dense"] * digits
    assert bitmap.shape == (t_pad, 128) and not bitmap[384:].any()
    assert np.array_equal(dev_counts.numpy(), counts)
    out = packed.numpy()
    n2 = int(out[2 * cap])
    assert 0 < n2 <= p3
    # The float64 formula: Σ_t w_t B[t, x] B[t, y] B[t, z] over the
    # frequent pairs in row-major order, then the prune and threshold.
    pairs = np.argwhere(np.triu(counts >= min_count, k=1)
                        & (np.arange(128) < 100))
    bw = b.astype(np.float64) * w[:, None]
    want = np.stack([(bw[:, x] * b[:, y]) @ b for x, y in pairs])
    mask = np.zeros((128, 128), bool)
    mask[pairs[:, 0], pairs[:, 1]] = True
    cand = (mask[pairs[:, 0]] & mask[pairs[:, 1]]
            & (np.arange(128)[None, :] > pairs[:, 1:2]))
    surv = np.argwhere(cand & (want >= min_count))
    l3 = out[2 * cap + 2:]
    n3 = int(l3[2 * cap3])
    assert n3 == len(surv) > 8
    assert np.array_equal(l3[:n3], surv[:, 0] * 128 + surv[:, 1])
    assert np.array_equal(l3[cap3 : cap3 + n3], want[surv[:, 0], surv[:, 1]])


@pytest.mark.parametrize("t, f", [(1, 8), (37, 128), (300, 384)])
def test_packed_bitmap_and_unpack_match_jax(t, f):
    rng = np.random.default_rng(t)
    sizes = rng.integers(0, 9, size=t)
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    indices = np.concatenate(
        [np.sort(rng.choice(f - 1, size=s, replace=False)) for s in sizes]
    ).astype(np.int32)
    got, f_pad = tbitmap.build_packed_bitmap_csr(indices, offsets, f - 1,
                                                 1, 128)
    want, w_f_pad = jbitmap.build_packed_bitmap_csr(indices, offsets, f - 1,
                                                    1, 128)
    assert f_pad == w_f_pad and np.array_equal(got, want)
    unpacked = tbitmap.unpack_bitmap(torch.from_numpy(got)).numpy()
    assert unpacked.dtype == np.int8
    assert np.array_equal(unpacked, np.asarray(jax_unpack(jnp.asarray(got))))
    assert np.array_equal(unpacked, jbitmap.build_bitmap_csr(
        indices, offsets, f - 1, 1, 128))


@pytest.mark.parametrize("knob", ["pair_cap", "pair_l3_cap", "pair_l3_rows"])
def test_overflow_falls_back_and_records_budget(tmp_path, knob):
    """A budget below the survivor count falls back with exact results,
    records the grown budget, and a repeat run on the same context
    folds (the port's test_pair_l3_overflow_falls_back_and_records_budget
    of tests/test_miner.py)."""
    path = _write(tmp_path, random_dataset(23, n_txns=400, n_items=16,
                                           max_len=10))
    want, _, _ = _jax_run(path, 0.03, ingest_pipeline_blocks=1)
    ctx = DeviceContext("cpu")
    knobs = dict(ingest_pipeline_blocks=2, ingest_threads=1, **{knob: 4})
    got, _, miner = _port_run(path, 0.03, context=ctx, **knobs)
    _levels_equal(got, want)
    (lv2,) = _events(miner, "level", k=2)
    (lv3,) = _events(miner, "level", k=3)
    if knob == "pair_cap":
        (ev,) = _events(miner, "pair_cap_overflow")
        assert ev["cap"] == 4 and ev["n2"] == lv2["frequent"] > 4
        assert lv2["dispatches"] == 1
    else:
        (ev,) = _events(miner, "pair_l3_overflow")
        assert ev["n2"] == lv2["frequent"] and lv2["dispatches"] == 0
        if knob == "pair_l3_cap":
            assert ev["n3"] == lv3["frequent"] > ev["cap3"] == 4
        else:  # level 3 counted over the first p3 pairs only
            assert ev["n2"] > ev["p3"] == 4
    # Too small a pair budget or row budget: level 3 ran through K1.
    assert not lv3["overlapped"] and lv3["launches"] >= 1
    again, _, miner2 = _port_run(path, 0.03, context=ctx, **knobs)
    _levels_equal(again, want)
    (lv2b,) = _events(miner2, "level", k=2)
    (lv3b,) = _events(miner2, "level", k=3)
    assert lv2b["dispatches"] == 0 and lv3b["overlapped"]
    assert not _events(miner2, "pair_cap_overflow")
    assert not _events(miner2, "pair_l3_overflow")


@pytest.mark.parametrize(
    "lines_fn, min_support, requested, want",
    [(_sparse_corpus, 0.001, "auto", "vertical"),
     (_t10i4_shaped, 0.03, "vertical", "vertical"),
     (_t10i4_shaped, 0.03, "auto", "bitmap")],
    ids=["sparse-auto", "forced-vertical", "dense-auto"],
)
def test_layout_probe_keeps_the_pipeline(tmp_path, lines_fn, min_support,
                                         requested, want):
    path = _write(tmp_path, [" ".join(x) for x in lines_fn()])
    knobs = dict(ingest_pipeline_blocks=4, ingest_threads=2,
                 mine_engine=requested)
    j_levels, j_data, _ = _jax_run(path, min_support, **knobs)
    got, data, miner = _port_run(path, min_support, **knobs)
    _levels_equal(got, j_levels)
    _data_equal(data, j_data)
    (pre,) = _events(miner, "preprocess")
    assert pre["pipelined"] and pre["engine"] == want
    (me,) = _events(miner, "mine_engine")
    assert me["engine"] == want and me["requested"] == requested
    assert me["probe"] == "pass1"
    assert bool(_events(miner, "arena_build")) == (want == "vertical")
    assert bool(_events(miner, "bitmap_build")) == (want == "bitmap")


@pytest.mark.parametrize("corpus", ["heavy", "random"])
def test_cli_bytes_match_jax_cli_and_oracle(tmp_path, capsys, corpus):
    d_raw = (_heavy_lines() if corpus == "heavy"
             else random_dataset(5, n_txns=600, n_items=30, max_len=8))
    u_raw = random_dataset(15, n_txns=60, n_items=30)
    inp = _write_inputs(tmp_path, d_raw, u_raw)
    level_counts.launches = 0
    assert torch_main([inp, str(tmp_path / "out_torch") + "/", "--min-support",
                       "0.03", "--platform", "cpu", "--metrics"]) == 0
    assert level_counts.launches == 0  # plain versions on the CPU
    events = [json.loads(x) for x in capsys.readouterr().err.splitlines()
              if x.startswith("{")]
    (pre,) = [e for e in events if e["event"] == "preprocess"]
    assert pre["pipelined"] and pre["capture"]
    assert jax_main([inp, str(tmp_path / "out_jax") + "/", "--min-support",
                     "0.03", *JAX_FLAGS]) == 0
    exp_freq, exp_rec = oracle.run_pipeline(
        [tokenize_line(x) for x in d_raw], [tokenize_line(x) for x in u_raw],
        0.03)
    for name, exp in (("freqItemset", exp_freq), ("recommends", exp_rec)):
        got = (tmp_path / "out_torch" / name).read_bytes()
        assert got == (tmp_path / "out_jax" / name).read_bytes()
        assert got == exp.encode("utf-8")


def test_uploader_and_async_fetch_on_the_cpu():
    ctx = DeviceContext("cpu")
    up = ctx.block_uploader()
    arrays = [np.arange(5, dtype=np.uint8) + i for i in range(3)]
    futures = [up.submit(a) for a in arrays]
    got = up.gather(futures)
    up.close()
    assert all(np.array_equal(g.numpy(), a) for g, a in zip(got, arrays))
    x = torch.arange(7, dtype=torch.int32)
    assert np.array_equal(ctx.fetch_async(x, "pair_pre").result(),
                          np.arange(7))
    assert ctx.upload_async(np.ones(3, np.int8)).dtype == torch.int8
    with ctx.sync_free():  # a no-op off CUDA
        pass
