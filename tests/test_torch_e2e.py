"""End to end: the port's CLI (``--platform cpu``) writes the same
``freqItemset`` and ``recommends`` bytes as the JAX package's CLI
(``--platform cpu --engine level --num-devices 1``) and the numpy
oracle; the device recommend path (table layout + K2's plain version)
agrees with the host scan; phase 1 of one package feeds phase 2 of the other through
``fastapriori_tpu_torch.convert``; and the digests chip_smoke.py checks
on the GPU are the JAX package's."""

import hashlib
import importlib.util
import os

import pytest

from conftest import random_dataset
from fastapriori_tpu import oracle
from fastapriori_tpu.cli import main as jax_main
from fastapriori_tpu.config import MinerConfig as JaxConfig
from fastapriori_tpu.models.apriori import FastApriori as JaxApriori
from fastapriori_tpu.models.recommender import (
    AssociationRules as JaxRules,
)
from fastapriori_tpu_torch import convert
from fastapriori_tpu_torch.cli import main as torch_main
from fastapriori_tpu_torch.config import MinerConfig
from fastapriori_tpu_torch.io.reader import read_dat, tokenize_line
from fastapriori_tpu_torch.models.apriori import FastApriori
from fastapriori_tpu_torch.models.recommender import (
    DEVICE_MIN_CHECKS,
    AssociationRules,
    device_scan_wanted,
)
from fastapriori_tpu_torch.ops.level_kernel import level_counts
from fastapriori_tpu_torch.ops.match_kernel import first_match
from fastapriori_tpu_torch.preprocess import dedup_user_baskets
from fastapriori_tpu_torch.utils.datagen import (
    generate_transactions,
    generate_user_baskets,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The reference run: the JAX level engine on one CPU device (the port is
# a one-device system; the test harness provides eight virtual devices).
JAX_FLAGS = ("--platform", "cpu", "--engine", "level", "--num-devices", "1")


def _write_inputs(tmp_path, d_raw, u_raw):
    for sub in ("in", "out_torch", "out_jax"):
        (tmp_path / sub).mkdir()
    (tmp_path / "in" / "D.dat").write_text("".join(x + "\n" for x in d_raw))
    (tmp_path / "in" / "U.dat").write_text("".join(x + "\n" for x in u_raw))
    return str(tmp_path / "in") + "/"


def _cli_three_ways(tmp_path, d_raw, u_raw, min_support):
    inp = _write_inputs(tmp_path, d_raw, u_raw)
    ms = str(min_support)
    assert torch_main([inp, str(tmp_path / "out_torch") + "/", "tmp",
                       "--min-support", ms, "--platform", "cpu"]) == 0
    assert jax_main([inp, str(tmp_path / "out_jax") + "/", "--min-support",
                     ms, *JAX_FLAGS]) == 0
    exp_freq, exp_rec = oracle.run_pipeline(
        [tokenize_line(x) for x in d_raw], [tokenize_line(x) for x in u_raw],
        min_support,
    )
    for name, exp in (("freqItemset", exp_freq), ("recommends", exp_rec)):
        got = (tmp_path / "out_torch" / name).read_bytes()
        assert got == (tmp_path / "out_jax" / name).read_bytes()
        assert got == exp.encode("utf-8")
    return inp


@pytest.mark.parametrize("seed", [0, 3])
def test_cli_matches_jax_cli_and_oracle(tmp_path, seed):
    _cli_three_ways(tmp_path, random_dataset(seed),
                    random_dataset(seed + 10, n_txns=25), 0.08)


def test_cli_python_ingest_matches_jax_cli_and_oracle(tmp_path,
                                                     monkeypatch):
    # The CLI ingests natively whenever the library builds; this case
    # forces the Python ingest, so both engines stay held to the bytes.
    from fastapriori_tpu_torch.models import apriori
    from fastapriori_tpu_torch.native import loader

    real = apriori.native_choice
    monkeypatch.setattr(apriori, "native_choice",
                        lambda native, hint: real(False, hint))

    def no_native(*_):
        raise AssertionError("the native ingest ran")

    monkeypatch.setattr(loader, "preprocess_file", no_native)
    monkeypatch.setattr(loader, "preprocess_buffer", no_native)
    _cli_three_ways(tmp_path, random_dataset(5),
                    random_dataset(15, n_txns=25), 0.08)


def test_cli_datagen_corpus_matches(tmp_path):
    d_raw = generate_transactions(n_txns=3000, n_items=100, seed=5)
    u_raw = generate_user_baskets(n_users=500, n_items=100, seed=6)
    _cli_three_ways(tmp_path, d_raw, u_raw, 0.02)


def _small_phase1(tmp_path):
    inp = _write_inputs(
        tmp_path,
        generate_transactions(n_txns=2000, n_items=80, seed=21),
        generate_user_baskets(n_users=400, n_items=80, seed=22),
    )
    return inp + "D.dat", read_dat(inp + "U.dat")


def test_device_recommend_path_matches_host(tmp_path):
    d_path, users = _small_phase1(tmp_path)
    levels, data = FastApriori(0.02, device="cpu").run_file_raw(d_path)
    rec = AssociationRules([], data.freq_items, data.item_to_rank,
                           levels=levels,
                           item_counts=data.item_counts, device="cpu")
    host = rec.run(users, use_device=False)
    dev = rec.run(users, use_device=True)
    assert dev == host
    assert sum(item != "0" for _, item in dev) > 100
    want = JaxRules([], data.freq_items, data.item_to_rank, levels=levels,
                    item_counts=data.item_counts).run(users, use_device=False)
    assert dev == want


def test_phase2_on_the_other_packages_phase1(tmp_path):
    d_path, users = _small_phase1(tmp_path)
    j_levels, j_data = JaxApriori(
        0.02, config=JaxConfig(engine="level", num_devices=1)
    ).run_file_raw(d_path)
    want = JaxRules([], j_data.freq_items, j_data.item_to_rank,
                    levels=j_levels, item_counts=j_data.item_counts).run(
        users, use_device=False)
    rec = convert.from_jax_levels(j_levels, j_data.item_counts,
                                  j_data.freq_items, j_data.item_to_rank,
                                  device="cpu")
    assert rec.run(users, use_device=True) == want

    t_levels, t_data = FastApriori(
        0.02, config=MinerConfig(engine="level"), device="cpu"
    ).run_file_raw(d_path)
    assert len(t_levels) == len(j_levels)
    for (tm, tc), (jm, jc) in zip(t_levels, j_levels):
        assert (tm == jm).all() and (tc == jc).all()
    levels, counts = convert.to_jax_levels(t_levels, t_data.item_counts)
    back = JaxRules([], t_data.freq_items, t_data.item_to_rank,
                    levels=levels, item_counts=counts).run(
        users, use_device=False)
    assert back == want


def test_cpu_run_launches_no_kernel(tmp_path):
    level_counts.launches = 0
    first_match.launches = 0
    d_path, users = _small_phase1(tmp_path)
    levels, data = FastApriori(0.02, device="cpu").run_file_raw(d_path)
    AssociationRules([], data.freq_items, data.item_to_rank, levels=levels,
                     item_counts=data.item_counts, device="cpu").run(users,
                                                         use_device=True)
    assert level_counts.launches == 0
    assert first_match.launches == 0


def test_scan_side_at_the_smoke_paths_sizes():
    """Both recommend problems of chip_smoke.py (distinct baskets x
    rules) take the device scan, and so K2 launches on both paths;
    below DEVICE_MIN_CHECKS the host scan stays."""
    assert device_scan_wanted(232, 46_098)  # kosarak shape, vertical
    assert device_scan_wanted(3_321, 123_377)  # T10I4D100K shape
    assert device_scan_wanted(1, DEVICE_MIN_CHECKS)
    assert not device_scan_wanted(1, DEVICE_MIN_CHECKS - 1)
    assert not device_scan_wanted(2, 46_098)


@pytest.mark.parametrize("n_users", [3, 400])
def test_run_takes_the_side_the_threshold_names(tmp_path, monkeypatch,
                                                n_users):
    d_path, users = _small_phase1(tmp_path)
    levels, data = FastApriori(0.02, device="cpu").run_file_raw(d_path)
    rec = AssociationRules([], data.freq_items, data.item_to_rank,
                           levels=levels,
                           item_counts=data.item_counts, device="cpu")
    users = users[:n_users]
    host = rec.run(users, use_device=False)
    sides = []
    for name in ("_host_first_match", "_device_first_match"):
        real = getattr(rec, name)

        def spy(*args, _real=real, _name=name):
            sides.append(_name)
            return _real(*args)

        monkeypatch.setattr(rec, name, spy)
    assert rec.run(users) == host
    baskets, _, _ = dedup_user_baskets(users, data.item_to_rank)
    want = ("_device_first_match"
            if device_scan_wanted(len(baskets), rec.n_rules)
            else "_host_first_match")
    assert sides == [want]
    assert want == ("_device_first_match" if n_users == 400
                    else "_host_first_match")


def test_chip_smoke_digests_are_the_jax_packages(tmp_path):
    """The T10I4D100K-shape main path of chip_smoke.py: the JAX CLI on
    the port's datagen corpus writes the digests the GPU run must
    match."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py")
    )
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    inp = _write_inputs(
        tmp_path,
        generate_transactions(n_txns=100_000, n_items=1000, seed=2017),
        generate_user_baskets(n_users=10_000, n_items=1000, seed=2018),
    )
    out = str(tmp_path / "out_jax") + "/"
    assert jax_main([inp, out, "--min-support", smoke.MIN_SUPPORT,
                     *JAX_FLAGS]) == 0
    for name, want in (("freqItemset", smoke.FREQ_SHA256),
                       ("recommends", smoke.REC_SHA256)):
        got = hashlib.sha256((tmp_path / "out_jax" / name).read_bytes())
        assert got.hexdigest() == want
