"""The port's native ingest (fastapriori_tpu_torch/csrc/preprocess.cc
through native/loader.py), its Python ingest and the JAX package's native
loader give the same arrays, array for array and in the same order; the
native candidate join equals the JAX package's; the library is built by ops/build.py under a tag that names
the host; and the engine choice fails loudly.

The port's library builds with g++ on this machine (tier-1); so does the
JAX package's, through its own Makefile.
"""

import os
import random

import numpy as np
import pytest

from conftest import random_dataset, tokenized
from fastapriori_tpu.models.candidates import (
    gen_candidates_arrays as jax_gen_candidates_arrays,
)
from fastapriori_tpu.native import loader as jax_loader
from fastapriori_tpu.native import native_available as jax_native_available
from fastapriori_tpu_torch import native as port_native
from fastapriori_tpu_torch.config import MinerConfig
from fastapriori_tpu_torch.errors import InputError
from fastapriori_tpu_torch.models.apriori import FastApriori
from fastapriori_tpu_torch.models.candidates import (
    concat_blocks,
    gen_candidates_blocks,
    gen_candidates_stream,
)
from fastapriori_tpu_torch.native import loader
from fastapriori_tpu_torch.ops import build
from fastapriori_tpu_torch.preprocess import (
    NATIVE_MIN_LINES,
    ingest_thread_count,
    native_choice,
    preprocess,
    preprocess_file,
)
from fastapriori_tpu_torch.utils.datagen import generate_transactions

ARRAYS = ("item_counts", "basket_indices", "basket_offsets", "weights")


@pytest.fixture(scope="module", autouse=True)
def _both_libraries_build():
    assert port_native.native_available(), port_native.unavailable_reason()
    assert jax_native_available()


def _assert_same(a, b):
    """Two CompressedData equal field for field, arrays with their dtypes
    and in the same order."""
    assert a.n_raw == b.n_raw
    assert a.min_count == b.min_count
    assert a.freq_items == b.freq_items
    assert a.item_to_rank == b.item_to_rank
    for name in ARRAYS:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        assert np.array_equal(x, y), name


def _assert_same_result(data, result):
    """A port CompressedData against a NativeResult tuple (the JAX
    loader's)."""
    n_raw, min_count, items, counts, indices, offsets, weights = result
    assert (data.n_raw, data.min_count, data.freq_items) == (
        n_raw, min_count, items)
    for name, y in zip(ARRAYS, (counts, indices, offsets, weights)):
        x = getattr(data, name)
        assert x.dtype == y.dtype, name
        assert np.array_equal(x, y), name


def _three_ways(path, min_support):
    nat = preprocess_file(str(path), min_support, native=True)
    py = preprocess_file(str(path), min_support, native=False)
    _assert_same(nat, py)
    _assert_same_result(nat, jax_loader.preprocess_file(str(path),
                                                        min_support))
    return nat


def _write(tmp_path, raw):
    p = tmp_path / "D.dat"
    if isinstance(raw, bytes):
        p.write_bytes(raw)
    else:
        p.write_text(raw)
    return p


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("min_support", [0.03, 0.1, 0.25])
def test_random_corpora_three_ways(tmp_path, seed, min_support):
    lines = random_dataset(seed)
    p = _write(tmp_path, "\n".join(lines) + "\n")
    _three_ways(p, min_support)
    # In-memory token lists, through the re-serializing buffer path.
    toks = tokenized(lines)
    _assert_same(preprocess(toks, min_support, native=True),
                 preprocess(toks, min_support, native=False))


def test_tiny_corpus_in_memory(tiny_d_lines):
    from fastapriori_tpu.preprocess import preprocess as jax_preprocess

    for ms in (0.2, 0.3, 0.5):
        nat = preprocess(tiny_d_lines, ms, native=True)
        _assert_same(nat, preprocess(tiny_d_lines, ms, native=False))
        ref = jax_preprocess(tiny_d_lines, ms, native=True)
        _assert_same_result(nat, (ref.n_raw, ref.min_count, ref.freq_items,
                                  ref.item_counts, ref.basket_indices,
                                  ref.basket_offsets, ref.weights))


@pytest.mark.parametrize("n_items, avg_len, min_support", [
    (1000, 10, 0.0025),  # the T10I4D100K shape
    (41_000, 8, 0.002),  # the kosarak shape
])
def test_datagen_corpora_of_the_driven_shapes(tmp_path, n_items, avg_len,
                                              min_support):
    lines = generate_transactions(n_txns=20_000, n_items=n_items,
                                  avg_txn_len=avg_len, seed=2017)
    nat = _three_ways(_write(tmp_path, "\n".join(lines) + "\n"), min_support)
    assert nat.num_items > 50 and nat.total_count > 5000


@pytest.mark.parametrize("raw, min_support", [
    # numeric ties with distinct tokens, an empty line, tabs, signed
    # integers, a token past int64 (lexical order), no trailing newline
    ("007 7 7 007\n\n\t  x\t y  \n-3 +4 -3\nx 007 7\n"
     "99999999999999999999999 1\n99999999999999999999999 1", 0.2),
    ("1 2\n1 2\n1 3", 0.3),  # no trailing newline
    (b"1 2\r\n1 2\r\n2 3\r\n", 0.3),  # CRLF
    ("", 0.5),  # an empty file
    # Java trim of control bytes at line edges, a control byte as its own
    # token, \x0b splitting tokens, \x1c inside a token, a line that trims
    # to empty, unicode that is not whitespace
    ("\x01 7 8\n7 8 \x02\n7 \x01 8\n7\x0b8 9\n7\x1c8 9\n\x03\x04\n"
     "a\xa0b 7\n7 8\n7 8".encode("utf-8"), 0.2),
], ids=["edge-tokens", "no-trailing-newline", "crlf", "empty",
        "java-trim-unicode"])
def test_edge_inputs_three_ways(tmp_path, raw, min_support):
    nat = _three_ways(_write(tmp_path, raw), min_support)
    if raw == "":
        assert nat.n_raw == 0 and nat.num_items == 0 and nat.total_count == 0


def test_large_weights_and_large_f(tmp_path):
    # More than 128 duplicate baskets, more than 2^15 rows.
    big = ["1 2 3"] * 300 + ["4 5"] * 2 + ["1 2"] * 40_000
    nat = _three_ways(_write(tmp_path, "\n".join(big) + "\n"), 0.001)
    assert int(nat.weights.max()) == 40_000
    # More than 4,096 frequent items: the scanner's sort fallback.
    rng = random.Random(3)
    wide = [" ".join(str(rng.randint(1, 5000))
                     for _ in range(rng.randint(2, 8)))
            for _ in range(4000)]
    nat = _three_ways(_write(tmp_path, "\n".join(wide) + "\n"), 0.0001)
    assert nat.num_items > 4096


def test_in_memory_tokens_that_cannot_round_trip_take_python():
    lines = [["\x01a", "b"], ["\x01a", "b"], ["a", "b"], ["b", "\x01a"],
             ["a b", "c"]]
    _assert_same(preprocess(lines, 0.3, native=True),
                 preprocess(lines, 0.3, native=False))


def _simd_corpus() -> bytes:
    rng = np.random.default_rng(31)
    lines = []
    for _ in range(4000):
        toks = rng.integers(0, 900, size=rng.integers(0, 9)).astype(str)
        lines.append(rng.choice([" ", "  ", "\t", " \t", "\x0b"]).join(toks))
    lines += ["", "   ", "\t\t", "007 7 07", "12345678901 5", "9" * 100]
    return ("\n".join(lines) + " 3 5").encode()


def test_simd_scan_matches_scalar_scan(monkeypatch):
    buf = _simd_corpus()

    def run():
        blocks = []
        tables = loader.preprocess_buffer_blocks(
            buf, 0.01, 4, lambda *b: blocks.append(b))
        return tables, blocks, loader.preprocess_buffer(buf, 0.01)

    monkeypatch.delenv("FA_NO_SIMD", raising=False)
    fast = run()
    monkeypatch.setenv("FA_NO_SIMD", "1")
    scalar = run()
    assert fast[0][:3] == scalar[0][:3]
    assert np.array_equal(fast[0][3], scalar[0][3])
    assert len(fast[1]) == len(scalar[1])
    for a, b in zip(fast[1], scalar[1]):
        assert a[0] == b[0]
        for x, y in zip(a[1:], b[1:]):
            assert np.array_equal(x, y)
    for x, y in zip(fast[2], scalar[2]):
        assert (x == y) if not isinstance(x, np.ndarray) else \
            np.array_equal(x, y)


def test_count_and_compress_match_jax():
    lines = generate_transactions(n_txns=3000, n_items=200, seed=9)
    data = ("\n".join(lines) + "\n").encode()
    half = data.index(b"\n", len(data) // 2) + 1
    for part in (data[:half], data[half:]):
        n, toks, counts = loader.count_buffer(part)
        jn, jtoks, jcounts = jax_loader.count_buffer(part)
        assert (n, toks) == (jn, jtoks)
        assert counts.dtype == jcounts.dtype
        assert np.array_equal(counts, jcounts)
        freq = [t for t, c in sorted(zip(toks, counts),
                                     key=lambda tc: (-tc[1], tc[0]))[:60]]
        got = loader.compress_with_ranks(part, freq)
        want = jax_loader.compress_with_ranks(part, freq)
        assert got[0] == want[0]
        for x, y in zip(got[1:], want[1:]):
            assert x.dtype == y.dtype and np.array_equal(x, y)


def _blocks_run(ld, buf, n_threads, with_pass1, copy_items=True):
    blocks, pass1 = [], []
    tables = ld.preprocess_buffer_blocks(
        buf, 0.002, 6,
        lambda f, o, i, w: blocks.append((f, o, i.copy(), w)),
        n_threads=n_threads, copy_items=copy_items,
        on_pass1=(lambda *a: pass1.append(a)) if with_pass1 else None,
    )
    return tables, blocks, pass1


@pytest.mark.parametrize("n_threads", [1, 4])
@pytest.mark.parametrize("with_pass1", [False, True])
def test_block_ingest_matches_jax(n_threads, with_pass1):
    lines = generate_transactions(n_txns=12_000, n_items=500,
                                  avg_txn_len=8, seed=4)
    buf = ("\n".join(lines) + "\n").encode()
    got = _blocks_run(loader, buf, n_threads, with_pass1)
    want = _blocks_run(jax_loader, buf, n_threads, with_pass1)
    assert got[0][:3] == want[0][:3]
    assert np.array_equal(got[0][3], want[0][3])
    assert len(got[1]) == len(want[1]) > 1

    def concat(blocks):
        idx = np.concatenate([b[2] for b in blocks])
        sizes = np.concatenate([np.diff(b[1]) for b in blocks])
        weights = np.concatenate([b[3] for b in blocks])
        return idx, sizes, weights

    for x, y in zip(concat(got[1]), concat(want[1])):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    if with_pass1:
        assert len(got[2]) == len(want[2]) == 1
        assert got[2][0][:3] == want[2][0][:3]
        assert np.array_equal(got[2][0][3], want[2][0][3])
    # Every block's weights add up to the baskets of size >= 2.
    single = _blocks_run(loader, buf, 1, False)
    assert sum(int(b[3].sum()) for b in single[1]) == sum(
        int(b[3].sum()) for b in got[1])


def test_block_items_view_is_read_only_and_callback_errors_raise():
    buf = ("\n".join(generate_transactions(n_txns=2000, n_items=100,
                                           seed=1)) + "\n").encode()
    kept, copies = [], []

    def keep(f, offsets, items, weights):
        kept.append(items)
        copies.append(items.copy())

    loader.preprocess_buffer_blocks(buf, 0.01, 3, keep, copy_items=False)
    assert kept and all(not v.flags.writeable for v in kept)
    with pytest.raises(ValueError):
        kept[0][0] = 1
    assert all(c.flags.writeable for c in copies)

    def fail(*_):
        raise KeyError("consumer failed")

    with pytest.raises(KeyError, match="consumer failed"):
        loader.preprocess_buffer_blocks(buf, 0.01, 3, fail)


def test_packed_bitmap_matches_jax_and_numpy():
    from fastapriori_tpu_torch.ops.bitmap import build_bitmap_csr

    rng = np.random.default_rng(5)
    baskets = [np.unique(rng.integers(0, 300, size=rng.integers(2, 20)))
               for _ in range(57)]
    indices = np.concatenate(baskets).astype(np.int32)
    offsets = np.concatenate(
        [[0], np.cumsum([len(b) for b in baskets])]).astype(np.int64)
    dense = build_bitmap_csr(indices, offsets, 300, 32, 128)
    got = np.zeros((dense.shape[0], dense.shape[1] // 8), dtype=np.uint8)
    want = np.zeros_like(got)
    assert loader.fill_packed_bitmap(indices, offsets, got)
    assert jax_loader.fill_packed_bitmap(indices, offsets, want)
    assert np.array_equal(got, want)
    assert np.array_equal(got, np.packbits(dense.astype(bool), axis=1))
    with pytest.raises(ValueError, match="out of range"):
        loader.fill_packed_bitmap(indices + 1000, offsets, got)


def _levels():
    rng = np.random.default_rng(11)
    yield np.arange(120, dtype=np.int32)[:, None]  # level 1 -> pairs
    pairs = np.array([(i, j) for i in range(60) for j in range(i + 1, 60)
                      if rng.random() < 0.4], dtype=np.int32)
    yield pairs
    x, y = jax_gen_candidates_arrays(pairs)
    triples = np.concatenate([pairs[x], y[:, None]], axis=1)
    yield triples[rng.random(len(triples)) < 0.5]
    yield np.zeros((1, 3), dtype=np.int32)  # one row: no candidate
    yield np.array([[0, 1], [2, 3]], dtype=np.int32)  # no join group


@pytest.mark.parametrize("which", range(5))
def test_candidate_stream_matches_jax_native_and_numpy(which):
    level = list(_levels())[which]
    got = concat_blocks(gen_candidates_stream(level))
    numpy_blocks = concat_blocks(gen_candidates_blocks(level, pair_budget=97))
    want = (jax_loader.gen_candidates_native(level) if level.shape[0] >= 2
            else jax_gen_candidates_arrays(level))
    for g, n, w in zip(got, numpy_blocks, want):
        assert g.dtype == n.dtype == w.dtype
        assert np.array_equal(g, w) and np.array_equal(n, w)
    if which == 0:
        assert got[0].size == 120 * 119 // 2


def test_ingest_thread_count_is_strict(monkeypatch):
    monkeypatch.delenv("FA_INGEST_THREADS", raising=False)
    assert ingest_thread_count(None) == (os.cpu_count() or 1)
    assert ingest_thread_count(3) == 3
    monkeypatch.setenv("FA_INGEST_THREADS", "5")
    assert ingest_thread_count(3) == 5
    for bad in ("abc", "0", "-2", "1.5"):
        monkeypatch.setenv("FA_INGEST_THREADS", bad)
        with pytest.raises(InputError, match="FA_INGEST_THREADS"):
            ingest_thread_count(None)
    with pytest.raises(InputError, match="FA_INGEST_THREADS"):
        FastApriori(0.1, device="cpu").run_file_raw("no-such-D.dat")


def test_native_choice_and_its_reasons():
    assert native_choice(None, 1 << 62) == (True, None)
    assert native_choice(True, 0) == (True, None)
    assert native_choice(False, 1 << 62) == (False, "forced off")
    use, reason = native_choice(None, NATIVE_MIN_LINES - 1)
    assert not use and "below the gate" in reason


def test_unbuildable_library_raises_when_required(tmp_path, monkeypatch,
                                                  capsys):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setenv("CXX", "/bin/false")
    assert not port_native.native_available()
    reason = port_native.unavailable_reason()
    assert reason.startswith("library build failed")
    assert list((tmp_path / "_build").iterdir()) == []
    d = tmp_path / "D.dat"
    d.write_text("1 2\n1 2 3\n2 3\n")
    with pytest.raises(InputError, match="library build failed"):
        preprocess_file(str(d), 0.3, native=True)
    with pytest.raises(RuntimeError, match="unavailable"):
        loader.preprocess_file(str(d), 0.3)
    assert native_choice(None, 1 << 62) == (False, reason)
    # Left to choose, the ingest and the candidate stream take Python, and
    # the metrics line says so.
    levels, data = FastApriori(
        config=MinerConfig(min_support=0.3, log_metrics=True),
        device="cpu").run_file_raw(str(d))
    _assert_same(data, preprocess_file(str(d), 0.3, native=False))
    err = capsys.readouterr().err
    assert '"native": false' in err and "library build failed" in err
    pairs = np.array([[0, 1], [0, 2], [1, 2]], dtype=np.int32)
    assert np.array_equal(concat_blocks(gen_candidates_stream(pairs))[1],
                          [2])


def test_build_tag_names_source_flags_and_host(monkeypatch):
    host = build.library_path(loader.LIB)
    kernel = build.library_path("level_counts")
    assert host.parent == build.BUILD_DIR and host.name.startswith(
        "libfa_native-")
    monkeypatch.setattr(build, "host_identity", lambda: "x86_64\nother cpu")
    assert build.library_path(loader.LIB) != host
    # The CUDA kernels are built for sm_90a, whatever the host.
    assert build.library_path("level_counts") == kernel
    monkeypatch.undo()
    monkeypatch.setattr(build, "CXX_FLAGS", build.CXX_FLAGS[:-2])
    assert build.library_path(loader.LIB) != host
    monkeypatch.undo()
    monkeypatch.setenv("CXX", "clang++")
    assert build.library_path(loader.LIB) != host
    ident = build.host_identity()
    if os.path.exists("/proc/cpuinfo"):
        assert "model name" in ident and "flags" in ident
