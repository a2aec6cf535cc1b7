"""Batched Huffman table stage vs the host coder's tables.

code_lengths_batch (sort + Moffat phases) and canonical_codes_batch must
agree exactly with coders/huffman.py (HuffmanTable.from_counts) for every
alphabet shape; degenerate alphabets (sigma <= 1) yield all-zero lengths.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from tudocomp_tpu.coders.huffman import HuffmanTable
from tudocomp_tpu.ops import huffman_jax as H

def _cases():
    rng = np.random.default_rng(0)
    dense = rng.integers(0, 5000, (16, 256)).astype(np.int32)
    sparse = np.zeros((8, 256), np.int32)
    sparse[np.arange(8)[:, None], rng.integers(0, 256, (8, 7))] = rng.integers(
        1, 100, (8, 7)
    )
    deg = np.zeros((4, 256), np.int32)
    deg[0, 65] = 10
    deg[2, 0] = 1
    deg[3, [1, 2]] = [5, 5]
    skew = np.ones((4, 256), np.int32)
    skew[:, 0] = 1 << 20
    return {"dense": dense, "sparse": sparse, "degenerate": deg, "skew": skew}


@pytest.mark.parametrize("name", ["dense", "sparse", "degenerate", "skew"])
def test_tables_kernel_parity(name):
    hists = _cases()[name]
    lengths = np.asarray(H.code_lengths_batch(jnp.asarray(hists)))
    cw, numl, osym, sigma, longest = (
        np.asarray(x) for x in H.canonical_codes_batch(jnp.asarray(lengths))
    )
    for b, h in enumerate(hists):
        if np.count_nonzero(h) <= 1:
            assert not lengths[b].any()
            continue
        t = HuffmanTable.from_counts(h.astype(np.int64))
        want_len = np.zeros(256, np.int64)
        want_len[t.ordered_map_from_effective] = t.ordered_codelengths
        np.testing.assert_array_equal(lengths[b], want_len, err_msg=f"row {b}")
        assert sigma[b] == t.alphabet_size and longest[b] == t.longest
        np.testing.assert_array_equal(numl[b, : t.longest], t.numl)
        assert not numl[b, t.longest :].any()
        np.testing.assert_array_equal(
            osym[b, : t.alphabet_size], t.ordered_map_from_effective
        )
        want_cw = np.zeros(256, np.uint64)
        want_cw[t.ordered_map_from_effective] = t.codewords
        np.testing.assert_array_equal(cw[b].astype(np.uint64), want_cw)


@pytest.mark.parametrize("scale", [1, 1 << 9, 1 << 19])
def test_shared_lengths_of_large_totals(scale):
    """A histogram summed over many blocks (counts past 2^22, total past
    MAX_BLOCK) still gets a valid code of at most 31 bits: the one the host
    builds from the right-shifted counts. Small totals are not rescaled."""
    rng = np.random.default_rng(4)
    h = np.zeros(256, np.int64)
    h[rng.choice(256, 40, replace=False)] = rng.integers(1, 4000, 40)
    h[7] = 1  # a rare symbol: the deepest code
    h = np.minimum(h * scale, (1 << 31) - 1)
    got = np.asarray(H.shared_code_lengths(jnp.asarray(h.astype(np.int32))))
    k = 0
    while np.where(h > 0, np.maximum(h >> k, 1), 0).sum() > H.MAX_BLOCK:
        k += 1
    assert (k == 0) == (h.sum() <= H.MAX_BLOCK)
    scaled = np.where(h > 0, np.maximum(h >> k, 1), 0)
    t = HuffmanTable.from_counts(scaled)
    want = np.zeros(256, np.int64)
    want[t.ordered_map_from_effective] = t.ordered_codelengths
    np.testing.assert_array_equal(got, want)
    assert got.max() <= 31
    assert (2.0 ** -got[got > 0]).sum() == 1.0  # complete prefix code
