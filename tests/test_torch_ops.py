"""The port's counting ops (fastapriori_tpu_torch/ops/count.py,
ops/bitmap.py and the weight split of models/apriori.py) against the JAX
package's (fastapriori_tpu/ops/count.py on its XLA path: no Pallas tiles,
no mesh axis), on the same numpy inputs.  Exact equality throughout."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from fastapriori_tpu.config import MinerConfig as JaxConfig
from fastapriori_tpu.models.apriori import FastApriori as JaxApriori
from fastapriori_tpu.ops import bitmap as jbitmap
from fastapriori_tpu.ops import count as jcount
from fastapriori_tpu_torch.models.apriori import split_weights
from fastapriori_tpu_torch.ops import bitmap as tbitmap
from fastapriori_tpu_torch.ops import count as tcount


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _corpus(seed, n=300, f=90, heavy=(300, 1000, 128)):
    """CSR baskets over f items, weights 1..5 plus a few heavy rows."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(2, 9, size=n)
    baskets = [np.sort(rng.choice(f, size=s, replace=False)).astype(np.int32)
               for s in sizes]
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    indices = np.concatenate(baskets).astype(np.int32)
    weights = rng.integers(1, 6, size=n).astype(np.int32)
    weights[: len(heavy)] = heavy
    return indices, offsets, weights, f


def test_bitmap_helpers_match():
    indices, offsets, weights, f = _corpus(0)
    assert (tbitmap.build_bitmap_csr(indices, offsets, f, 8, 128)
            == jbitmap.build_bitmap_csr(indices, offsets, f, 8, 128)).all()
    td, ts = tbitmap.weight_digits(weights, 304)
    jd, js = jbitmap.weight_digits(weights, 304)
    assert ts == js and (td == jd).all()
    for n in (0, 1, 5, 128, 129):
        assert tbitmap.next_pow2(n) == jbitmap.next_pow2(n)
        assert tbitmap.pad_axis(n, 8) == jbitmap.pad_axis(n, 8)


@pytest.mark.parametrize("heavy", [(300, 1000, 128), ()])
def test_split_weights_matches(heavy):
    indices, offsets, weights, f = _corpus(1, heavy=heavy)
    t_pad = 304
    want = JaxApriori(config=JaxConfig())._split_weights(
        weights, t_pad, indices, offsets, f
    )
    got = split_weights(weights, t_pad, indices, offsets, f, 128)
    assert got[1] == want[1]
    assert (got[0] == want[0]).all()
    if want[2] is None:
        assert got[2] is None and got[3] is None
    else:
        assert (got[2] == want[2]).all() and (got[3] == want[3]).all()


def _weights_in(seed, heavy_split):
    indices, offsets, weights, f = _corpus(seed)
    bitmap = tbitmap.build_bitmap_csr(indices, offsets, f, 8, 128)
    t_pad = bitmap.shape[0]
    if heavy_split:
        digits, scales, hb, hw = split_weights(
            weights, t_pad, indices, offsets, f, 128
        )
    else:  # every digit through the kernels, no remainder rows
        digits, scales = tbitmap.weight_digits(weights, t_pad)
        hb = hw = None
    assert (len(scales) == 1) == heavy_split
    return bitmap, digits, scales, hb, hw, f


@pytest.mark.parametrize("heavy_split", [True, False])
@pytest.mark.parametrize("fast_f32", [True, False])
def test_pair_counts_match(heavy_split, fast_f32):
    bitmap, digits, scales, hb, hw, f = _weights_in(2, heavy_split)
    want = jcount.local_pair_counts(
        jnp.asarray(bitmap), jnp.asarray(digits), scales
    )
    got = tcount.local_pair_counts(_t(bitmap), _t(digits), scales,
                                   fast_f32=fast_f32)
    if hb is not None:
        want = want + jcount.heavy_pair_correction(jnp.asarray(hb),
                                                   jnp.asarray(hw))
        got = got + tcount.heavy_pair_correction(_t(hb), _t(hw))
    assert got.dtype == torch.int32
    assert (got.numpy() == np.asarray(want)).all()
    min_count = int(np.median(np.asarray(want)[np.triu_indices(f, 1)])) + 1
    assert (
        tcount.frequent_pair_mask(got, min_count, f).numpy()
        == np.asarray(jcount.frequent_pair_mask(want, min_count, f))
    ).all()


def _prefix_case(seed, bitmap, k1, p=64, n_real=40):
    """Prefix rows taken from real baskets (so they occur), padded rows
    at the zero column; candidates extend a prefix by an item of the
    basket it came from, or by a random item."""
    rng = np.random.default_rng(seed)
    f_pad = bitmap.shape[1]
    prefix_cols = np.full((p, k1), f_pad - 1, dtype=np.int32)
    extra = []
    rows = [r for r in range(bitmap.shape[0]) if bitmap[r].sum() > k1]
    for i, r in enumerate(rng.choice(rows, size=n_real, replace=False)):
        items = np.flatnonzero(bitmap[r])
        prefix_cols[i] = items[:k1]
        extra.append(i * f_pad + items[k1])
    cand = rng.integers(0, p, size=200) * f_pad + rng.integers(0, f_pad - 1,
                                                                 size=200)
    return prefix_cols, np.concatenate([extra, cand]).astype(np.int32)


@pytest.mark.parametrize("heavy_split", [True, False])
@pytest.mark.parametrize("k1", [1, 2, 3])
def test_level_gather_matches(heavy_split, k1):
    bitmap, digits, scales, hb, hw, _ = _weights_in(3, heavy_split)
    prefix_cols, cand_idx = _prefix_case(k1, bitmap, k1)
    want = jcount.local_level_gather(
        jnp.asarray(bitmap), jnp.asarray(digits), scales,
        jnp.asarray(prefix_cols), jnp.int32(k1), jnp.asarray(cand_idx), 1,
        heavy_b=None if hb is None else jnp.asarray(hb),
        heavy_w=None if hw is None else jnp.asarray(hw),
    )
    got = tcount.local_level_gather(
        _t(bitmap), _t(digits), scales, _t(prefix_cols), k1, _t(cand_idx),
        heavy_b=None if hb is None else _t(hb),
        heavy_w=None if hw is None else _t(hw),
    )
    assert (got.numpy() == np.asarray(want)).all()
    assert got.numpy().sum() > 0


def test_heavy_level_correction_matches():
    bitmap, _, _, hb, hw, _ = _weights_in(4, True)
    prefix_cols, _ = _prefix_case(5, bitmap, 2)
    onehot = tcount.prefix_onehot(_t(prefix_cols), bitmap.shape[1])
    want = jcount.heavy_level_correction(
        jnp.asarray(onehot.numpy()), jnp.int32(2), jnp.asarray(hb),
        jnp.asarray(hw),
    )
    got = tcount.heavy_level_correction(onehot, 2, _t(hb), _t(hw))
    assert (got.numpy() == np.asarray(want)).all()
