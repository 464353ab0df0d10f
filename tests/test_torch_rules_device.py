"""The port's device rule engine (fastapriori_tpu_torch/rules/gen.py
``_rule_arrays_device`` over ops/contain.py ``rule_level_kernel``) and
the recommender's device-built scan table (ops/contain.py
``rule_scan_build``), on the CPU, against the JAX package's device
engine at one device and against the port's host engine: the same join
helpers' results, the same level outputs, the same rule arrays with
bitwise-equal confidences, the same table; plus the engine-choice
contract of tests/test_rules_device.py and the CLI's bytes with
``FA_RULE_ENGINE=device``."""

import contextlib
import functools
import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from conftest import random_dataset, tokenized
from fastapriori_tpu.cli import main as jax_main
from fastapriori_tpu.models.recommender import AssociationRules as JaxRules
from fastapriori_tpu.ops import contain as jcontain
from fastapriori_tpu.parallel.mesh import DeviceContext as JaxContext
from fastapriori_tpu.rules import gen as jgen
from fastapriori_tpu_torch import InputError
from fastapriori_tpu_torch.cli import main as torch_main
from fastapriori_tpu_torch.config import MinerConfig
from fastapriori_tpu_torch.device import DeviceContext
from fastapriori_tpu_torch.models.apriori import FastApriori
from fastapriori_tpu_torch.models.recommender import AssociationRules
from fastapriori_tpu_torch.ops import contain as tcontain
from fastapriori_tpu_torch.ops.bitmap import next_pow2, pad_axis
from fastapriori_tpu_torch.preprocess import preprocess
from fastapriori_tpu_torch.rules import gen as tgen
from fastapriori_tpu_torch.utils.datagen import (
    generate_transactions,
    generate_user_baskets,
)
from fastapriori_tpu_torch.utils.logging import MetricsLogger

DEVICE = MinerConfig(rule_engine="device")


@pytest.fixture(scope="module")
def ctx():
    return DeviceContext("cpu")


@functools.lru_cache(maxsize=None)
def _jctx():
    """One JAX one-device context for the file: its jitted joins compile
    once per level shape, for the chains below and its own engine."""
    return JaxContext(num_devices=1)


@functools.lru_cache(maxsize=None)
def _mined(seed, min_support, deep=False):
    """``(mats, data)`` mined by the port on the CPU."""
    lines = random_dataset(seed, n_txns=250, max_len=8)
    if deep:
        # Dense enough to reach k >= 5, with an empty top rule level.
        lines = (["1 2 3 4 5 6"] * 50 + ["1 2 3 4 5"] * 30
                 + ["2 3 4 5 6"] * 20
                 + random_dataset(5, n_txns=60, max_len=6))
    data = preprocess(tokenized(lines), min_support)
    levels = FastApriori(config=MinerConfig(engine="level"),
                         device="cpu").mine_levels_raw(data)
    return tgen._level_tables(levels, data.item_counts), data


def _remap(mats, mult, off, f_big):
    """The same lattice over a wider item space (rank -> rank*mult+off):
    16- and 32-bit rank keys."""
    out = {}
    for k, (mat, cnts) in mats.items():
        if k == 1:
            c = np.ones(f_big, dtype=np.int64)
            c[mats[1][0][:, 0] * mult + off] = mats[1][1]
            out[1] = (np.arange(f_big, dtype=np.int32)[:, None], c)
        else:
            out[k] = ((mat * mult + off).astype(np.int32), cnts)
    return out


CASES = {
    "s0": lambda: _mined(0, 0.05)[0],
    "s3": lambda: _mined(3, 0.08)[0],
    "s6": lambda: _mined(6, 0.05)[0],
    "deep": lambda: _mined(0, 0.05, deep=True)[0],
    "bits16": lambda: _remap(_mined(2, 0.05)[0], 600, 3, 600 * 20 + 10),
    "bits32": lambda: _remap(_mined(2, 0.05)[0], 9000, 7, 9000 * 20 + 10),
}


def _same_arrays(a, b):
    assert len(a) == len(b)
    for (aa, ac, af), (ba, bc, bf) in zip(a, b):
        assert aa.shape == ba.shape and np.array_equal(aa, ba)
        assert np.array_equal(ac, bc)
        assert af.dtype == bf.dtype == np.float64
        assert af.tobytes() == bf.tobytes()


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# the join helpers, bit for bit


def _sorted_rows(rng, n, w, f):
    rows = {tuple(sorted(rng.choice(f, size=w, replace=False)))
            for _ in range(n)}
    return np.array(sorted(rows), dtype=np.int32).reshape(-1, w)


@pytest.mark.parametrize("f", [200, 5000, 100_000])
@pytest.mark.parametrize("w", [1, 3, 8])
def test_pack_and_search_match_jax(f, w):
    rng = np.random.default_rng(f + w)
    bits = tcontain.rule_key_bits(f)
    assert bits == jcontain.rule_key_bits(f)
    table = _sorted_rows(rng, 300, w, f)
    n = table.shape[0]
    np_pad = next_pow2(n + 5)  # padding rows past the real ones
    padded = np.zeros((np_pad, w), np.int32)
    padded[:n] = table
    # Queries: every real row, rows absent from the table, zero rows.
    queries = np.concatenate([table, _sorted_rows(rng, 200, w, f),
                              np.zeros((7, w), np.int32)])
    valid = np.arange(np_pad) < n
    jcols = [jnp.where(jnp.asarray(valid), c, jnp.uint32(0xFFFFFFFF))
             for c in jcontain.pack_rank_keys(jnp.asarray(padded), bits)]
    want = jcontain.lex_searchsorted(
        jcols, jnp.int32(n), jcontain.pack_rank_keys(jnp.asarray(queries),
                                                     bits),
        np_pad.bit_length() + 1)
    tcols = [torch.where(_t(valid), c, tcontain.KEY_PAD)
             for c in tcontain.pack_rank_keys(_t(padded), bits)]
    assert all(c.dtype == torch.int64 and (c >= 0).all() for c in tcols)
    got = tcontain.lex_searchsorted(
        tcols, n, tcontain.pack_rank_keys(_t(queries), bits),
        np_pad.bit_length() + 1)
    assert np.array_equal(got.numpy(), np.asarray(want))
    # The sort of a shuffled table with a row-index tie-break: the JAX
    # package's multi-key lax.sort with a trailing iota.
    perm = rng.permutation(np_pad)
    shuf = padded[perm]
    jv = valid[perm]
    jk = [jnp.where(jnp.asarray(jv), c, jnp.uint32(0xFFFFFFFF))
          for c in jcontain.pack_rank_keys(jnp.asarray(shuf), bits)]
    jorder = lax.sort(tuple(jk) + (jnp.arange(np_pad, dtype=jnp.int32),),
                      num_keys=len(jk))[-1]
    tk = [torch.where(_t(jv), c, tcontain.KEY_PAD)
          for c in tcontain.pack_rank_keys(_t(shuf), bits)]
    assert np.array_equal(tcontain.lex_argsort(tk).numpy(),
                          np.asarray(jorder))


def _fractions(rng, size):
    top = (1 << 24) - 1
    den = rng.integers(1, top + 1, size=size, dtype=np.int64)
    num = np.minimum(rng.integers(1, top + 1, size=size, dtype=np.int64),
                     den)
    num[:64] = den[:64]  # num == den
    den[64:128] = top  # the largest denominator
    num[64:128] = rng.integers(1, top + 1, size=64)
    num[128:192], den[128:192] = 3, 9  # equal ratios
    num[192:256], den[192:256] = 1, 3
    num[256:260], den[256:260] = [1, 1, top, top - 1], [1, top, top, top]
    return num, den


def test_frac_less24_matches_jax():
    rng = np.random.default_rng(7)
    pn, pd = _fractions(rng, 5000)
    cn, cd = _fractions(rng, 5000)
    cn[:300], cd[:300] = pn[:300], pd[:300]  # ties
    want = np.asarray(jcontain.frac_less24(*(jnp.asarray(x.astype(np.int32))
                                             for x in (pn, pd, cn, cd))))
    got = tcontain.frac_less24(*(_t(x.astype(np.int32))
                                 for x in (pn, pd, cn, cd))).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got, pn / pd < cn / cd)


def test_conf_sort_keys_match_jax():
    num, den = _fractions(np.random.default_rng(8), 6000)
    hi, lo = jcontain.conf_sort_keys(jnp.asarray(num.astype(np.int32)),
                                     jnp.asarray(den.astype(np.int32)))
    want = (np.asarray(hi).astype(np.int64) << 24) | np.asarray(lo)
    got = tcontain.conf_sort_keys(_t(num.astype(np.int32)),
                                  _t(den.astype(np.int32))).numpy()
    assert np.array_equal(got, want)
    assert got[0] == 1 << 48  # num == den
    # Key order is the float64 order, ties included.
    conf = num / den
    i, j = np.random.default_rng(9).integers(0, len(num), (2, 20000))
    assert np.array_equal(got[i] < got[j], conf[i] < conf[j])
    assert np.array_equal(got[i] == got[j], conf[i] == conf[j])


def _padded_levels(mats):
    """``(k, n, n_pad, mat_p, cnts_p)`` per level, as the engine pads."""
    out = []
    for k in sorted(k for k in mats if k >= 2):
        mat, cnts = mats[k]
        n = mat.shape[0]
        n_pad = next_pow2(max(n, 8))
        mat_p = np.zeros((n_pad, k), np.int32)
        mat_p[:n] = mat
        cnts_p = np.ones(n_pad, np.int32)
        cnts_p[:n] = cnts
        out.append((k, n, n_pad, mat_p, cnts_p))
    return out


def _bits(mats):
    return tcontain.rule_key_bits(
        1 + max(int(m.max()) for m, _ in mats.values() if m.size))


@functools.lru_cache(maxsize=None)
def _jax_chain(case):
    """The JAX package's ``rule_level_kernel`` level by level (jitted as
    its one-device engine jits it), each level fed the previous one's
    outputs, on ``CASES[case]``."""
    mats = CASES[case]()
    bits = _bits(mats)
    put = _jctx().device0_put
    prev = ((jnp.zeros(1, jnp.uint32),), jnp.zeros(1, jnp.int32),
            put(np.asarray(mats[1][1], np.int32)), 0,
            jnp.zeros(1, bool), jnp.zeros(1, jnp.int32))
    outs = []
    for k, n, _, mat_p, cnts_p in _padded_levels(mats):
        fn = _jctx().rule_level_join(k, bits, k == 2)
        ps, po, pc, np_real, surv, d = prev
        mat_d, cnts_d = put(mat_p), put(cnts_p)
        out = fn(mat_d, cnts_d, jnp.int32(n), ps, po, pc, jnp.int32(np_real),
                 surv, d)
        outs.append((out, mat_d, cnts_d))
        prev = (out[1], out[2], cnts_d, n, out[4], out[3])
    return outs


@pytest.mark.parametrize("case", ["s0", "deep", "bits16", "bits32"])
def test_rule_level_kernel_matches_jax(case):
    """Every level's outputs, both chains fed their own previous
    outputs: the packed mask and miss count, the sort order, the
    denominators and the survival flags, padding rows included."""
    mats = CASES[case]()
    bits = _bits(mats)
    levels = _padded_levels(mats)
    assert levels[0][0] == 2 and len(levels) >= 2
    prev = (None, None, _t(np.asarray(mats[1][1], np.int32)), 0, None, None)
    for (k, n, _, mat_p, cnts_p), (jout, _, _) in zip(levels,
                                                        _jax_chain(case)):
        ps, po, pc, np_real, surv, d = prev
        tout = tcontain.rule_level_kernel(
            _t(mat_p), _t(cnts_p), n, ps, po, pc, np_real, surv, d,
            k=k, bits=bits, first=k == 2)
        assert tout[0].dtype == torch.uint8
        # packed mask + miss count, order, d_flat, surv_flat
        for i in (0, 2, 3, 4):
            assert np.array_equal(tout[i].numpy(), np.asarray(jout[i])), (k, i)
        prev = (tout[1], tout[2], _t(cnts_p), n, tout[4], tout[3])


# ---------------------------------------------------------------------------
# the engine


@pytest.mark.parametrize("case", ["s0", "s6", "deep", "bits16", "bits32"])
def test_device_engine_matches_jax_and_host(ctx, case):
    mats = CASES[case]()
    host = tgen._rule_arrays_host(mats)
    dev = tgen.rule_arrays_from_tables(mats, context=ctx, config=DEVICE)
    _same_arrays(host, dev)
    _same_arrays(jgen._rule_arrays_device(mats, _jctx()), dev)
    assert sum(len(c) for _, c, _ in dev) > 0


def test_device_engine_no_rules(ctx):
    assert tgen._rule_arrays_device({}, ctx) == []
    singles = {1: (np.arange(3, dtype=np.int32)[:, None],
                   np.array([5, 4, 3], dtype=np.int64))}
    assert tgen._rule_arrays_device(singles, ctx) == []
    mats = _mined(9, 0.9)[0]
    assert max(mats) == 1
    assert tgen._rule_arrays_device(mats, ctx) == []


def test_one_device_upload_fires_the_rules_upload_site(ctx):
    """The JAX package's ``test_upload_failpoint_fires``: the one-device
    join's uploads are the ``rules.upload`` site too."""
    from fastapriori_tpu_torch.reliability import failpoints

    failpoints.arm("rules.upload", "io*1")
    try:
        with pytest.raises(OSError, match="injected"):
            tgen._rule_arrays_device(CASES["s0"](), ctx)
    finally:
        failpoints.disarm_all()


def test_device_engine_downward_closure_errors(ctx):
    mats = _mined(0, 0.05)[0]
    assert max(mats) >= 3
    missing = dict(mats)
    missing.pop(2)
    with pytest.raises(InputError, match="downward-closed"):
        tgen.rule_arrays_from_tables(missing, context=ctx, config=DEVICE)
    # One 2-itemset row that 3-itemsets reference is dropped: the join's
    # miss count raises the host engine's error class.
    torn = dict(mats)
    torn[2] = (mats[2][0][1:], mats[2][1][1:])
    for engine in ("host", "device"):
        with pytest.raises(InputError, match="downward-closed"):
            tgen.rule_arrays_from_tables(
                torn, context=ctx, config=MinerConfig(rule_engine=engine))
    # A rank without a 1-itemset (the k = 2 join reads ranks as rows).
    short = dict(mats)
    short[1] = (mats[1][0][:-1], mats[1][1][:-1])
    with pytest.raises(InputError, match="downward-closed"):
        tgen.rule_arrays_from_tables(short, context=ctx, config=DEVICE)


def test_device_state_and_counts_gather(ctx):
    """The state left for the scan table, and the survivor-count gather
    (u24 planes and plain int32) against a direct numpy gather."""
    mats = CASES["deep"]()
    state = tgen.DeviceRuleState()
    dev = tgen.rule_arrays_from_tables(mats, context=ctx, config=DEVICE,
                                       scan_state=state)
    assert state.ready and state.ks == sorted(k for k in mats if k >= 2)
    assert state.total == sum(len(c) for _, c, _ in dev)
    assert state.offsets[0] == 0
    d_flats = [a[2] for a in state.arrays]
    rng = np.random.default_rng(3)
    pending = [(d, rng.integers(0, d.numel(), size=s))
               for d, s in zip(d_flats, (5, 0, 17, 1, 3))]
    want = np.concatenate([d.numpy()[p] for d, p in pending])
    for u24 in (True, False):
        got = ctx.finish_level_counts(
            ctx.gather_level_counts_start(pending, u24=u24))
        assert got.dtype == np.int64 and np.array_equal(got, want)
    state.release()
    assert not state.ready and state.arrays == []


# ---------------------------------------------------------------------------
# the scan table


def _jax_scan_table(case, freq_items, f_pad, r_pad, k_max):
    """The JAX package's ``rule_scan_build`` at one shard over its own
    join chain's state (its one-shard sharded join returns the single
    join's outputs plus the padded tables it was given)."""
    levels = _padded_levels(CASES[case]())
    arrays, offsets, total = [], [], 0
    for out, mat_d, cnts_d in _jax_chain(case):
        arrays.append((mat_d, cnts_d, out[3], out[4]))
        offsets.append(total)
        total += int(np.asarray(out[4]).sum())
    pr = jnp.asarray(jgen._consequent_priority(freq_items).astype(np.int32))
    build = _jctx().rule_scan_build([lv[0] for lv in levels],
                                    [lv[2] for lv in levels], r_pad, k_max,
                                    f_pad - 1)
    out = build(tuple(arrays), jnp.asarray(offsets, dtype=jnp.int32), pr)
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("case", ["s0", "s6", "deep"])
def test_scan_table_matches_jax_and_host(case):
    mats = CASES[case]()
    data = {"s0": _mined(0, 0.05), "s6": _mined(6, 0.05),
            "deep": _mined(0, 0.05, deep=True)}[case][1]
    levels = [(m, c) for k, (m, c) in sorted(mats.items()) if k >= 2]
    rec = AssociationRules([], data.freq_items, data.item_to_rank,
                           levels=levels, item_counts=data.item_counts,
                           config=DEVICE, device="cpu")
    rec.rule_arrays()
    assert rec._scan_state is not None
    (ant, size, cons), = rec.scan_table()[0]
    assert rec._scan_state is None  # released once the table is built
    r_pad, k_max = ant.shape
    f_pad = pad_axis(len(data.freq_items) + 1, 128)
    want = _jax_scan_table(case, data.freq_items, f_pad, r_pad, k_max)
    for got, w in zip((ant, size, cons), want):
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), w)
    # The real rows are the host-built table's (sort_rule_arrays order).
    ant0, lens, cons0, _ = rec.rule_arrays()
    h_ant, h_size, h_cons = tcontain.rule_table(
        ant0, lens, cons0, len(data.freq_items), f_pad, 1 << 13)
    r = len(cons0)
    assert r > 0 and r_pad >= r
    width = max(k_max, h_ant.shape[1])
    pad = np.full((r, width), f_pad - 1, np.int32)
    a, b = pad.copy(), pad.copy()
    a[:, :k_max] = ant.numpy()[:r]
    b[:, : h_ant.shape[1]] = h_ant[:r]
    assert np.array_equal(a, b)
    assert np.array_equal(size.numpy()[:r], h_size[:r])
    assert np.array_equal(cons.numpy()[:r], h_cons[:r])
    assert (size.numpy()[r:] > f_pad).all()


def test_recommender_resident_scan_matches_host_engine():
    mats, data = _mined(6, 0.05)
    levels = [(m, c) for k, (m, c) in sorted(mats.items()) if k >= 2]
    users = tokenized(random_dataset(60, n_txns=200))
    host = AssociationRules([], data.freq_items, data.item_to_rank,
                            levels=levels,
                            item_counts=data.item_counts, device="cpu")
    want = host.run(users, use_device=False)
    assert want == host.run(users, use_device=True)
    assert want == JaxRules([], data.freq_items, data.item_to_rank,
                            levels=levels, item_counts=data.item_counts).run(
        users, use_device=False)
    fm = [r for r in host.metrics.records if r["event"] == "first_match"]
    assert fm[-1]["resident_table"] is False

    rec = AssociationRules([], data.freq_items, data.item_to_rank,
                           levels=levels,
                           item_counts=data.item_counts, config=DEVICE,
                           device="cpu")
    assert rec.run(users, use_device=True) == want
    events = {r["event"]: r for r in rec.metrics.records}
    assert events["rule_gen_engine"]["engine"] == "device"
    dev_ev = events["rule_gen_device"]
    assert dev_ev["survivors"] == rec.n_rules
    assert dev_ev["dispatches"] == dev_ev["levels"] + 1
    fm = events["first_match"]
    assert fm["device"] and fm["resident_table"] is True
    assert fm["launches"] >= 1 and "table_build_ms" in fm
    table = rec._scan_table
    # A second run scans the same table; the host scan stays equal.
    assert rec.run(users, use_device=True) == want
    assert rec._scan_table is table
    fm = [r for r in rec.metrics.records if r["event"] == "first_match"][-1]
    assert fm["resident_table"] is True and "table_build_ms" not in fm
    assert rec.run(users, use_device=False) == want


def test_host_scan_releases_the_state():
    mats, data = _mined(6, 0.05)
    levels = [(m, c) for k, (m, c) in sorted(mats.items()) if k >= 2]
    users = tokenized(random_dataset(61, n_txns=40))
    rec = AssociationRules([], data.freq_items, data.item_to_rank,
                           levels=levels,
                           item_counts=data.item_counts, config=DEVICE,
                           device="cpu")
    host = rec.run(users, use_device=False)
    assert rec._scan_state is None and rec._scan_table is None
    # A later device scan uploads the host-built table.
    assert rec.run(users, use_device=True) == host
    fm = [r for r in rec.metrics.records if r["event"] == "first_match"][-1]
    assert fm["resident_table"] is False


# ---------------------------------------------------------------------------
# engine choice (tests/test_rules_device.py's contract)


def _events(metrics, name):
    return [r for r in metrics.records if r["event"] == name]


class _CudaContext(DeviceContext):
    """A CPU context that reports a CUDA platform: what auto sees on the
    card (only the choice is asked of it)."""

    platform = "cuda"


def test_auto_stays_on_host_below_floor_and_on_cpu(ctx):
    mats = CASES["s3"]()
    raw = tgen._raw_rule_count(mats)
    m = MetricsLogger()
    _same_arrays(tgen._rule_arrays_host(mats), tgen.rule_arrays_from_tables(
        mats, context=ctx, config=MinerConfig(), metrics=m))
    # The host engine's own event; the choice itself records nothing.
    assert [r["event"] for r in m.records] == ["rule_gen_host"]
    m = MetricsLogger()
    # On the CPU auto keeps the host engine whatever the floor.
    assert tgen._pick_rule_engine(
        mats, ctx, MinerConfig(rule_device_min_rules=1), m) == "host"
    assert not m.records
    cuda = _CudaContext("cpu")
    assert tgen._pick_rule_engine(mats, cuda, MinerConfig(), m) == "host"
    assert tgen._pick_rule_engine(
        mats, cuda, MinerConfig(rule_device_min_rules=raw + 1), m) == "host"
    assert not m.records
    assert tgen._pick_rule_engine(
        mats, cuda, MinerConfig(rule_device_min_rules=raw), m) == "device"
    assert _events(m, "rule_gen_engine") == [
        {"event": "rule_gen_engine", "engine": "device", "requested": "auto",
         "raw_rules": raw}]
    assert MinerConfig().rule_device_min_rules == 1 << 21


def test_host_engine_records_one_event(ctx):
    """A host-chosen table: one ``rule_gen_host`` event with the host
    engine's counts."""
    mats = CASES["s3"]()
    m = MetricsLogger()
    out = tgen.rule_arrays_from_tables(mats, context=ctx,
                                       config=MinerConfig(), metrics=m)
    (ev,) = _events(m, "rule_gen_host")
    assert set(ev) == {"event", "levels", "raw_rules", "survivors",
                       "key_searches", "wall_ms"}
    assert ev["raw_rules"] == tgen._raw_rule_count(mats)
    assert ev["levels"] == sum(1 for k in mats if k >= 2)
    assert ev["survivors"] == sum(len(c) for _, c, _ in out)
    # Per k-itemset, k - 1 searches down its prefix chain and one for
    # each other antecedent.
    assert ev["key_searches"] == sum(
        2 * (k - 1) * mat.shape[0] for k, (mat, _) in mats.items())
    assert ev["wall_ms"] >= 0
    assert not _events(m, "rule_gen_engine")


def test_forced_device_records_its_choice(ctx):
    mats = CASES["s3"]()
    m = MetricsLogger()
    _same_arrays(tgen._rule_arrays_host(mats), tgen.rule_arrays_from_tables(
        mats, context=ctx, config=DEVICE, metrics=m))
    ev = _events(m, "rule_gen_engine")
    assert len(ev) == 1 and ev[0]["engine"] == "device"
    assert ev[0]["requested"] == "device"
    dev = _events(m, "rule_gen_device")[0]
    assert dev["raw_rules"] == tgen._raw_rule_count(mats)
    assert set(dev) == {"event", "levels", "dispatches", "raw_rules",
                        "survivors", "dispatch_ms", "wall_ms"}


def test_count_gate_falls_back_to_host_with_an_event(ctx):
    mats = {k: (m.copy(), c.copy()) for k, (m, c) in CASES["s3"]().items()}
    mats[1][1][0] = 1 << 24
    m = MetricsLogger()
    out = tgen.rule_arrays_from_tables(mats, context=ctx, config=DEVICE,
                                       metrics=m)
    _same_arrays(tgen._rule_arrays_host(mats), out)
    ev = _events(m, "rule_gen_fallback")
    assert ev and ev[0]["reason"] == "counts_exceed_2^24"
    assert not _events(m, "rule_gen_device")


def test_forced_device_without_context_falls_back():
    mats = CASES["s3"]()
    m = MetricsLogger()
    out = tgen.rule_arrays_from_tables(mats, context=None, config=DEVICE,
                                       metrics=m)
    _same_arrays(tgen._rule_arrays_host(mats), out)
    ev = _events(m, "rule_gen_fallback")
    assert ev and ev[0]["reason"] == "no_device_context"


def test_rule_engine_config_strictly_parsed(ctx):
    with pytest.raises(InputError, match="rule_engine"):
        tgen.rule_arrays_from_tables(CASES["s3"](), context=ctx,
                                     config=MinerConfig(rule_engine="devcie"))


def test_rule_engine_env_strictly_parsed(monkeypatch):
    monkeypatch.setenv("FA_RULE_ENGINE", "device")
    assert tgen.rule_engine_from_env() == "device"
    monkeypatch.setenv("FA_RULE_ENGINE", "  HOST ")
    assert tgen.rule_engine_from_env() == "host"
    monkeypatch.delenv("FA_RULE_ENGINE")
    assert tgen.rule_engine_from_env() is None
    monkeypatch.setenv("FA_RULE_ENGINE", "devcie")
    with pytest.raises(InputError, match="FA_RULE_ENGINE"):
        tgen.rule_engine_from_env()


def test_env_overrides_config(ctx, monkeypatch):
    monkeypatch.setenv("FA_RULE_ENGINE", "device")
    m = MetricsLogger()
    tgen.rule_arrays_from_tables(CASES["s3"](), context=ctx,
                                 config=MinerConfig(rule_engine="host"),
                                 metrics=m)
    assert _events(m, "rule_gen_engine") and _events(m, "rule_gen_device")
    monkeypatch.setenv("FA_RULE_ENGINE", "host")
    m = MetricsLogger()
    tgen.rule_arrays_from_tables(CASES["s3"](), context=ctx, config=DEVICE,
                                 metrics=m)
    assert [r["event"] for r in m.records] == ["rule_gen_host"]


# ---------------------------------------------------------------------------
# the CLI


def _write(tmp_path, d_raw, u_raw):
    for sub in ("in", "out_torch", "out_jax"):
        (tmp_path / sub).mkdir()
    (tmp_path / "in" / "D.dat").write_text("".join(x + "\n" for x in d_raw))
    (tmp_path / "in" / "U.dat").write_text("".join(x + "\n" for x in u_raw))
    return str(tmp_path / "in") + "/"


@pytest.mark.parametrize("corpus", ["conftest", "datagen"])
def test_cli_forced_device_rule_engine_writes_the_jax_clis_bytes(
        tmp_path, monkeypatch, corpus):
    if corpus == "conftest":
        d_raw, u_raw, ms = random_dataset(3), random_dataset(13, n_txns=25), 0.08
    else:
        d_raw = generate_transactions(n_txns=2000, n_items=80, seed=21)
        u_raw = generate_user_baskets(n_users=400, n_items=80, seed=22)
        ms = 0.02
    inp = _write(tmp_path, d_raw, u_raw)
    assert jax_main([inp, str(tmp_path / "out_jax") + "/", "--min-support",
                     str(ms), "--platform", "cpu", "--engine", "level",
                     "--num-devices", "1"]) == 0
    monkeypatch.setenv("FA_RULE_ENGINE", "device")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert torch_main([inp, str(tmp_path / "out_torch") + "/",
                           "--min-support", str(ms), "--platform", "cpu",
                           "--metrics"]) == 0
    for name in ("freqItemset", "recommends"):
        assert (tmp_path / "out_torch" / name).read_bytes() == (
            tmp_path / "out_jax" / name).read_bytes()
    events = {}
    for line in err.getvalue().splitlines():
        if line.startswith("{"):
            rec = json.loads(line)
            events[rec["event"]] = rec
    assert events["rule_gen_engine"]["engine"] == "device"
    assert events["rule_gen_device"]["survivors"] == events["gen_rules"][
        "rules"]
    if corpus == "datagen":
        # Enough baskets x rules for the device scan: K2's plain version
        # over the table built from the engine's state.
        assert events["first_match"]["device"] is True
        assert events["first_match"]["resident_table"] is True


def test_cli_rule_engine_typo_exits_2(tmp_path, monkeypatch, capsys):
    inp = _write(tmp_path, random_dataset(3), random_dataset(13, n_txns=5))
    monkeypatch.setenv("FA_RULE_ENGINE", "devcie")
    assert torch_main([inp, str(tmp_path / "out_torch") + "/",
                       "--min-support", "0.08", "--platform", "cpu"]) == 2
    assert "FA_RULE_ENGINE" in capsys.readouterr().err
    assert not (tmp_path / "out_torch" / "recommends").exists()
