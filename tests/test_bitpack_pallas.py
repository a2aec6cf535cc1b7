"""Batched pack_tokens vs a bit-by-bit numpy reference packer."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tudocomp_tpu.ops.bitpack import pack_tokens


def np_pack(values, nbits, n_words):
    """MSB-first reference: token bits land one at a time in the arena;
    bits past n_words are dropped (ops/bitpack.py bit order)."""
    B = values.shape[0]
    W = np.zeros((B, n_words), np.uint32)
    TB = np.zeros(B, np.int64)
    for b in range(B):
        bitpos = 0
        for v, nb in zip(values[b], nbits[b]):
            nb = int(nb)
            if nb <= 0:
                continue
            v = int(v) & ((1 << nb) - 1)
            for k in range(nb):
                if (v >> (nb - 1 - k)) & 1:
                    p = bitpos + k
                    if (p >> 5) < n_words:
                        W[b, p >> 5] |= np.uint32(1 << (31 - (p & 31)))
            bitpos += nb
        TB[b] = bitpos
    return W, TB


def run_case(values, nbits, n_words):
    got_w, got_b = jax.vmap(lambda v, n: pack_tokens(v, n, n_words))(
        jnp.asarray(values), jnp.asarray(nbits)
    )
    want_w, want_b = np_pack(values, nbits, n_words)
    np.testing.assert_array_equal(np.asarray(got_b), want_b.astype(np.int32))
    np.testing.assert_array_equal(np.asarray(got_w), want_w)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("maxw", [5, 13, 33])
def test_random_tokens(seed, maxw):
    rng = np.random.default_rng(seed)
    B, NT = 3, 2500
    nbits = rng.integers(0, maxw, (B, NT)).astype(np.int32)
    nbits = np.minimum(nbits, 32)
    values = rng.integers(0, 1 << 31, (B, NT)).astype(np.uint32)
    n_words = int(nbits.sum(1).max()) // 32 + 3
    run_case(values, nbits, n_words)


def test_full_width_tokens():
    B, NT = 2, 1024
    nbits = np.full((B, NT), 32, np.int32)
    rng = np.random.default_rng(3)
    values = rng.integers(0, 1 << 62, (B, NT)).astype(np.uint64).astype(np.uint32)
    run_case(values, nbits, NT + 2)


def test_zero_width_runs():
    B, NT = 2, 2048
    rng = np.random.default_rng(4)
    nbits = rng.integers(1, 9, (B, NT)).astype(np.int32)
    nbits[:, 100:900] = 0
    nbits[1, :] = 0
    values = rng.integers(0, 256, (B, NT)).astype(np.uint32)
    run_case(values, nbits, 600)


def test_single_bit_stream():
    B, NT = 1, 1024
    nbits = np.ones((B, NT), np.int32)
    values = (np.arange(NT) % 2).astype(np.uint32)[None]
    run_case(values, nbits, 40)


def test_overflow_drops_bits_like_pack_tokens():
    # stream exceeds the arena: words near the n_words boundary must match
    # pack_tokens' clean per-word drop
    rng = np.random.default_rng(6)
    B, NT = 2, 2048
    nbits = rng.integers(8, 33, (B, NT)).astype(np.int32)
    values = rng.integers(0, 1 << 31, (B, NT)).astype(np.uint32)
    run_case(values, nbits, 200)


def test_empty_token_stream():
    # NT == 0 must return zeroed arenas, not uninitialized memory
    run_case(np.zeros((3, 0), np.uint32), np.zeros((3, 0), np.int32), 8)


def test_tail_padding_multiple_tiles():
    rng = np.random.default_rng(5)
    B, NT = 2, 3000  # pads to 3072, crosses tile boundaries mid-stream
    nbits = rng.integers(0, 33, (B, NT)).astype(np.int32)
    values = rng.integers(0, 1 << 31, (B, NT)).astype(np.uint32)
    n_words = int(nbits.sum(1).max()) // 32 + 3
    run_case(values, nbits, n_words)


def test_packed_kernels_bit_identical():
    """The encode path's byte tokens (per-block code table lookup, codes of
    at most 4/8/16 bits) pack exactly like the reference."""
    rng = np.random.default_rng(0)
    B, bs = 2, 1024
    blocks = rng.integers(0, 256, (B, bs)).astype(np.uint8)
    for maxl in (4, 8, 16):
        tl = rng.integers(1, maxl + 1, (B, 256)).astype(np.int32)
        tv = rng.integers(0, 1 << 16, (B, 256)).astype(np.uint32)
        values = np.take_along_axis(tv, blocks.astype(np.int64), axis=1)
        nbits = np.take_along_axis(tl, blocks.astype(np.int64), axis=1)
        nbits[1, 29:] = 0  # a short block: dead tail tokens
        run_case(values, nbits, (maxl * bs + 31) // 32 + 1)
