"""Device-side canonical Huffman: the flagship block encode pipeline.

Jittable end-to-end block encoder producing byte streams identical to the
host HuffmanCoder literal path (coders/huffman.py, format of
include/tudocomp/coders/HuffmanCoder.hpp): per block
  flag bit | table (compressed_int longest, numl[], alphabet, symbols) | codes

Pipeline stages, all vmapped over blocks [B, bs] u8:
  1. histogram           scatter-add into [B, 256]
  2. code lengths        Moffat/Katajainen in-place minimum-redundancy
                         algorithm (3 passes) under lax.fori_loop; pass 3
                         (leaf depths) is vectorized via depth histograms.
                         Tie-breaking matches the host heap builder
                         (prefer leaves, FIFO internals), so lengths agree
                         bit-exactly with coders/huffman.py:gen_codelengths.
  3. canonical codes     firstcode reverse scan + (length, symbol) sort
  4. tokenization        per-symbol code lookup (gather) into fixed
                         [521 + bs] (value, nbits<=32) token slots
  5. bit packing         ops.bitpack scatter-add arena

Block size is capped at 2 MiB: a depth-d code requires a block of at least
Fibonacci(d+1) symbols, so bs <= 2^21 keeps code lengths <= 31 bits and
every token within the 32-bit pack limit.

Shared-table mode (for the multi-chip DP runtime): histograms are psum'd
over the mesh axis so every block encodes with one global table.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .bitpack import pack_tokens

MAX_BLOCK = 1 << 21  # keeps max code length <= 31 (Fibonacci bound)
MAX_LEN = 32  # code length slots 1..MAX_LEN
_BIG = jnp.int32(0x3FFFFFFF)

__all__ = [
    "block_histogram",
    "code_lengths",
    "canonical_codes",
    "encode_blocks",
    "huffman_table_tokens",
    "MAX_BLOCK",
]


def block_histogram(block: jnp.ndarray) -> jnp.ndarray:
    """[bs] u8 -> [256] i32 histogram."""
    return jnp.zeros(256, jnp.int32).at[block.astype(jnp.int32)].add(1)


def _iota256():
    return jax.lax.iota(jnp.int32, 256)


def _rd(A, idx):
    """One-hot read A[idx]: a select+reduce over the 256 lanes, which
    stays a fused elementwise op inside the vmapped fori_loop body."""
    return jnp.sum(jnp.where(_iota256() == idx, A, 0))


def _wr(A, idx, val):
    """One-hot write A[idx] = val (masked select, not a scatter)."""
    return jnp.where(_iota256() == idx, val, A)


def _sort_hist(hist: jnp.ndarray):
    """Sort effective symbols ascending by (count, symbol); absent -> +inf.

    Sort-free: counts are < 2^22 (MAX_BLOCK), so (count << 9) | symbol is a
    unique i32 key and each symbol's sorted position is the number of
    smaller keys — a [256, 256] comparison matrix in place of a vmapped
    256-element sort per block."""
    hist = hist.astype(jnp.int32)
    present = hist > 0
    sigma = jnp.sum(present.astype(jnp.int32))
    sym = jnp.arange(256, dtype=jnp.int32)
    key = jnp.where(present, (hist << 9) | sym, _BIG | sym)
    rank = jnp.sum((key[None, :] < key[:, None]).astype(jnp.int32), axis=1)
    # permutation inverse via comparison sums (vmapped scatters serialize)
    eq = rank[None, :] == sym[:, None]  # [pos, symbol]
    sorted_sym = jnp.sum(jnp.where(eq, sym[None, :], 0), axis=1)
    kv = jnp.where(present, hist, _BIG)
    sorted_key = jnp.sum(jnp.where(eq, kv[None, :], 0), axis=1)
    return sorted_key, sorted_sym, sigma, rank


def _phase12_xla(sorted_key: jnp.ndarray, m):
    """Moffat phases 1+2 as XLA loops with one-hot reads/writes."""
    A_init = _wr(sorted_key, 0, sorted_key[0] + sorted_key[1])

    def p1_body(t, state):
        A, root, leaf = state
        active = t < m - 1

        def pick(A, root, leaf, allow_root_lt_t):
            a_root = _rd(A, root)
            a_leaf = _rd(A, leaf)
            root_ok = jnp.where(allow_root_lt_t, root < t, True)
            use_root = (leaf >= m) | (root_ok & (a_root < a_leaf))
            val = jnp.where(use_root, a_root, a_leaf)
            A = jnp.where(use_root, _wr(A, root, t), A)
            root = jnp.where(use_root, root + 1, root)
            leaf = jnp.where(use_root, leaf, leaf + 1)
            return val, A, root, leaf

        v1, A1, root1, leaf1 = pick(A, root, leaf, False)
        A1 = _wr(A1, t, v1)
        v2, A2, root2, leaf2 = pick(A1, root1, leaf1, True)
        A2 = _wr(A2, t, _rd(A2, t) + v2)

        A = jnp.where(active, A2, A)
        root = jnp.where(active, root2, root)
        leaf = jnp.where(active, leaf2, leaf)
        return A, root, leaf

    A, _, _ = jax.lax.fori_loop(
        1, 255, p1_body, (A_init, jnp.int32(0), jnp.int32(2))
    )

    A = _wr(A, jnp.maximum(m - 2, 0), 0)

    def p2_body(j, A):
        nxt = m - 3 - j
        active = nxt >= 0
        nxt_c = jnp.maximum(nxt, 0)
        parent = _rd(A, _rd(A, nxt_c))
        return jnp.where(active, _wr(A, nxt_c, parent + 1), A)

    return jax.lax.fori_loop(0, 254, p2_body, A)


def _phase3(A, sym_rank, sigma):
    """Internal depths -> per-symbol code lengths (vectorized).

    sym_rank[s] = sorted position of symbol s (from _sort_hist); the final
    per-symbol assignment is a gather depth[sym_rank] — comparison sums and
    gathers only, no scatters."""
    m = sigma
    pos = jnp.arange(256, dtype=jnp.int32)
    internal = pos < m - 1
    idepth = jnp.where(internal, jnp.minimum(A, MAX_LEN + 1), MAX_LEN + 1)
    # internal nodes per depth 0..MAX_LEN via comparison sums
    drange = jnp.arange(MAX_LEN + 1, dtype=jnp.int32)
    nd = jnp.sum(
        (idepth[None, :] == drange[:, None]).astype(jnp.int32), axis=1
    )
    # leaves at depth d = 2 * internal(d-1) - internal(d)
    leaves = 2 * jnp.concatenate([jnp.zeros(1, jnp.int32), nd[:-1]]) - nd
    leaves = leaves.at[0].set(0)
    cum = jnp.cumsum(leaves)
    # sorted position j (ascending freq) has rank-from-most-frequent m-1-j;
    # searchsorted(cum, rank, 'right') == #{d : cum[d] <= rank}
    rank = m - 1 - pos
    depth = jnp.sum(
        (cum[None, :] <= rank[:, None]).astype(jnp.int32), axis=1
    )
    depth = jnp.where(pos < m, depth, 0)

    lengths = depth[sym_rank]
    return jnp.where(sigma >= 2, lengths, jnp.zeros(256, jnp.int32))


def code_lengths(hist: jnp.ndarray) -> jnp.ndarray:
    """Per-symbol Huffman code lengths from a [256] histogram.

    Returns [256] i32; 0 for absent symbols. Degenerate alphabets
    (sigma <= 1) return all zeros — callers emit the flag-0 raw format.
    """
    sorted_key, sorted_sym, sigma, rank = _sort_hist(hist)
    A = _phase12_xla(sorted_key, sigma)
    return _phase3(A, rank, sigma)


def shared_code_lengths(hist: jnp.ndarray) -> jnp.ndarray:
    """[256] histogram summed over many blocks -> [256] code lengths.

    A summed histogram can exceed what one block holds, which would break
    both the i32 sort keys of _sort_hist (counts < 2^22) and the 31-bit code
    bound. The counts are shifted right by the least k that brings their
    total (each present symbol kept >= 1) within MAX_BLOCK, which restores
    both bounds; totals within MAX_BLOCK keep their exact counts. Totals
    are summed in u32, so the input must stay below 4 GiB (and each count,
    summed in i32 by the caller, below 2^31).
    """
    hist = hist.astype(jnp.uint32)
    present = hist > 0
    shifts = jnp.arange(32, dtype=jnp.uint32)
    scaled = jnp.where(
        present[None, :], jnp.maximum(hist[None, :] >> shifts[:, None], 1), 0
    )  # [32 shifts, 256]
    k = jnp.sum(jnp.sum(scaled, axis=1) > MAX_BLOCK)
    return code_lengths_batch(scaled[k][None, :].astype(jnp.int32))[0]


def code_lengths_batch(hists: jnp.ndarray) -> jnp.ndarray:
    """[B, 256] histograms -> [B, 256] code lengths."""
    # barrier: without it XLA fuses the histogram scatter into the [256,256]
    # comparison broadcast and recomputes it per element
    hists = jax.lax.optimization_barrier(hists)
    keys, syms, sigmas, ranks = jax.vmap(_sort_hist)(hists)
    keys, sigmas, ranks = jax.lax.optimization_barrier((keys, sigmas, ranks))
    A = jax.vmap(_phase12_xla)(keys, sigmas)
    return jax.vmap(_phase3)(A, ranks, sigmas)


def canonical_codes_batch(lengths: jnp.ndarray):
    """Batched scatter-free canonical codes: [B, 256] lengths ->
    (cw [B,256] u32, numl [B,MAX_LEN], ordered_sym [B,256], sigma [B],
    longest [B]).

    Same semantics as canonical_codes (HuffmanCoder.hpp:192-218), but every
    per-block scatter/gather is replaced by comparison-matrix sums and
    one-hot reductions over the 256-lane dimension.
    """
    B = lengths.shape[0]
    lengths = lengths.astype(jnp.int32)
    present = lengths > 0
    sigma = jnp.sum(present.astype(jnp.int32), axis=1)  # [B]
    longest = jnp.max(lengths, axis=1)  # [B]

    lrange = jnp.arange(1, MAX_LEN + 1, dtype=jnp.int32)  # [32]
    numl = jnp.sum(
        (lengths[:, None, :] == lrange[None, :, None]).astype(jnp.int32),
        axis=2,
    )  # [B, MAX_LEN]; absent symbols have length 0 and never match

    # firstcode[l-1] = (firstcode[l] + numl[l]) / 2 descending (31-step
    # scan with a [B] carry; slot i corresponds to code length i+1)
    def fc_step(carry, i):
        nxt = jnp.where(i < longest, (carry + numl[:, i]) >> 1, 0)
        return nxt, nxt

    _, fcs = jax.lax.scan(
        fc_step,
        jnp.zeros((B,), jnp.int32),
        jnp.arange(MAX_LEN - 1, 0, -1, dtype=jnp.int32),
    )  # fcs[k] = firstcode[MAX_LEN-2-k]
    firstcode = jnp.concatenate(
        [jnp.flip(fcs.T, axis=1), jnp.zeros((B, 1), jnp.int32)], axis=1
    )  # [B, MAX_LEN]

    # order by (length, symbol); absent sort last — comparison-matrix ranks
    sym = jnp.arange(256, dtype=jnp.int32)
    key = jnp.where(present, (lengths << 9) | sym, 0x7FFF0000 + sym)
    rank = jnp.sum(
        (key[:, None, :] < key[:, :, None]).astype(jnp.int32), axis=2
    )  # [B, 256]; rank[b, s] = sorted position of symbol s
    eq = rank[:, None, :] == sym[None, :, None]  # [B, pos, symbol]
    ordered_sym = jnp.sum(jnp.where(eq, sym[None, None, :], 0), axis=2)
    len_or_big = jnp.where(present, lengths, _BIG)
    ordered_len = jnp.sum(jnp.where(eq, len_or_big[:, None, :], 0), axis=2)

    # first position of each length group + firstcode, via one-hot over the
    # MAX_LEN slots (no [B,·] gathers)
    num_shorter = jnp.concatenate(
        [jnp.zeros((B, 1), jnp.int32), jnp.cumsum(numl, axis=1)], axis=1
    )  # [B, MAX_LEN+1]
    slot = jnp.clip(ordered_len - 1, 0, MAX_LEN)  # [B, 256]
    sl_oh = slot[:, :, None] == jnp.arange(MAX_LEN + 1, dtype=jnp.int32)
    first_of_len = jnp.sum(
        jnp.where(sl_oh, num_shorter[:, None, :], 0), axis=2
    )
    fc_of_len = jnp.sum(
        jnp.where(sl_oh[:, :, :MAX_LEN], firstcode[:, None, :], 0), axis=2
    )
    pos = jnp.arange(256, dtype=jnp.int32)
    ordered_cw = fc_of_len + (pos[None, :] - first_of_len)
    live = pos[None, :] < sigma[:, None]
    ordered_cw = jnp.where(live, ordered_cw, 0)
    ordered_sym = jnp.where(live, ordered_sym, 0)
    # invert the ordering back to per-symbol codewords (comparison sum)
    cw = jnp.sum(jnp.where(eq, ordered_cw[:, :, None], 0), axis=1).astype(
        jnp.uint32
    )
    return cw, numl, ordered_sym, sigma, longest


def canonical_codes(lengths: jnp.ndarray):
    """Canonical codeword assignment (HuffmanCoder.hpp:192-218 semantics).

    Args: lengths [256] i32 (0 = absent).
    Returns (cw [256] u32, numl [MAX_LEN] i32, ordered_sym [256] i32,
             sigma i32, longest i32); ordered_sym lists effective symbols
    sorted by (length, symbol), padded with 0 beyond sigma.
    """
    present = lengths > 0
    sigma = jnp.sum(present.astype(jnp.int32))
    longest = jnp.max(lengths)
    numl = jnp.zeros(MAX_LEN + 1, jnp.int32).at[lengths].add(present.astype(jnp.int32))
    numl = numl[1:]  # counts for lengths 1..MAX_LEN

    # firstcode[l-1] = (firstcode[l] + numl[l]) / 2, firstcode[longest-1] = 0
    lpos = jnp.arange(MAX_LEN, dtype=jnp.int32)

    def fc_body(j, fc):
        i = MAX_LEN - 1 - j  # i from MAX_LEN-1 down to 1; set fc[i-1]
        val = jnp.where(
            i < longest, (jnp.sum(jnp.where(lpos == i, fc + numl, 0))) >> 1, 0
        )
        return jnp.where(lpos == i - 1, val, fc)

    firstcode = jax.lax.fori_loop(
        0, MAX_LEN - 1, fc_body, jnp.zeros(MAX_LEN, jnp.int32)
    )

    # order by (length, symbol); absent symbols sort last. Sort-free: unique
    # i32 keys + comparison-matrix ranks (see _sort_hist).
    sym = jnp.arange(256, dtype=jnp.int32)
    key = jnp.where(present, (lengths << 9) | sym, 0x7FFF0000 + sym)
    rank = jnp.sum((key[None, :] < key[:, None]).astype(jnp.int32), axis=1)
    eq = rank[None, :] == sym[:, None]  # [pos, symbol]
    ordered_len = jnp.sum(
        jnp.where(eq, jnp.where(present, lengths, _BIG)[None, :], 0), axis=1
    )
    ordered_sym = jnp.sum(jnp.where(eq, sym[None, :], 0), axis=1)
    # first position of each length group: #symbols with a shorter length
    num_shorter = jnp.concatenate([jnp.zeros(1, jnp.int32), jnp.cumsum(numl)])
    first_of_len = num_shorter[jnp.clip(ordered_len - 1, 0, MAX_LEN)]
    pos = jnp.arange(256, dtype=jnp.int32)
    ordered_cw = firstcode[jnp.clip(ordered_len - 1, 0, MAX_LEN - 1)] + (
        pos - first_of_len
    )
    cw = jnp.zeros(256, jnp.uint32).at[ordered_sym].set(
        jnp.where(pos < sigma, ordered_cw, 0).astype(jnp.uint32)
    )
    ordered_sym = jnp.where(pos < sigma, ordered_sym, 0)
    return cw, numl, ordered_sym, sigma, longest


def _compressed_int_tokens(v):
    """4 token slots for write_compressed_int(v), v < 2^14 (io/bitio.py)."""
    more = v >= 128
    vals = jnp.stack(
        [
            more.astype(jnp.int32),
            v & 127,
            jnp.zeros_like(v),
            v >> 7,
        ]
    )
    bits = jnp.stack(
        [
            jnp.ones_like(v),
            jnp.full_like(v, 7),
            more.astype(jnp.int32),
            jnp.where(more, 7, 0),
        ]
    )
    return vals, bits


N_TABLE_TOKENS = 1 + 4 + 4 * MAX_LEN + 4 + 256


def huffman_table_tokens(numl, ordered_sym, sigma, longest):
    """Token slots for the serialized table incl. leading flag bit.

    Mirrors write_table (coders/huffman.py:109-114 / HuffmanCoder.hpp:264).
    Degenerate alphabets (sigma <= 1) emit only the flag-0 bit.
    """
    normal = sigma >= 2
    flag_v = normal.astype(jnp.int32)
    vals = [flag_v[None]]
    bits = [jnp.ones(1, jnp.int32)]

    def ci(v):
        cv, cb = _compressed_int_tokens(v)
        vals.append(cv)
        bits.append(jnp.where(normal, cb, 0))

    ci(longest)
    # numl[l] for l = 1..longest (width-0 beyond longest)
    lidx = jnp.arange(MAX_LEN, dtype=jnp.int32)
    cv, cb = jax.vmap(_compressed_int_tokens)(numl)  # [MAX_LEN, 4]
    live = (lidx < longest) & normal
    vals.append(cv.reshape(-1))
    bits.append(jnp.where(live[:, None], cb, 0).reshape(-1))
    ci(sigma)
    pos = jnp.arange(256, dtype=jnp.int32)
    vals.append(ordered_sym)
    bits.append(jnp.where((pos < sigma) & normal, 8, 0))

    return jnp.concatenate(vals), jnp.concatenate(bits)


def _encode_one_block(block, n_valid, lengths, n_words, emit_table):
    """Token stream + packed words for one block given its code lengths."""
    return jax.tree_util.tree_map(
        lambda x: x[0],
        encode_blocks_from_lengths(
            block[None], n_valid[None], lengths[None], n_words, emit_table
        ),
    )


def encode_blocks_from_lengths(blocks, n_valid, lengths, n_words, emit_table=True):
    """[B, bs] blocks + [B, 256] code lengths -> ([B, n_words] u32, [B] bits).

    The batched core of the encode pipeline: canonical codes (scatter-free),
    per-symbol lookup (gather), table token serialization, bit-pack.
    """
    cw, numl, ordered_sym, sigma, longest = canonical_codes_batch(lengths)
    cw, numl, ordered_sym, sigma, longest, lengths = jax.lax.optimization_barrier(
        (cw, numl, ordered_sym, sigma, longest, lengths)
    )
    return _encode_with_tables(
        blocks, n_valid, lengths, cw, numl, ordered_sym, sigma, longest,
        n_words, emit_table,
    )


def _encode_with_tables(
    blocks, n_valid, lengths, cw, numl, ordered_sym, sigma, longest,
    n_words, emit_table=True,
):
    bs = blocks.shape[1]
    normal = (sigma >= 2)[:, None]
    c = blocks.astype(jnp.int32)
    pos = jnp.arange(bs, dtype=jnp.int32)
    live = pos[None, :] < n_valid[:, None]
    code = jnp.take_along_axis(cw, c, axis=1).astype(jnp.int32)
    nb = jnp.take_along_axis(lengths, c, axis=1)
    # normal: canonical code; degenerate: raw 8-bit literal
    sym_vals = jnp.where(normal, code, c)
    sym_bits = jnp.where(live, jnp.where(normal, nb, 8), 0)

    if emit_table:
        tv, tb = jax.vmap(huffman_table_tokens)(numl, ordered_sym, sigma, longest)
        values = jnp.concatenate([tv, sym_vals], axis=1)
        nbits = jnp.concatenate([tb, sym_bits], axis=1)
    else:
        values, nbits = sym_vals, sym_bits
    return jax.vmap(lambda v, n: pack_tokens(v, n, n_words))(values, nbits)


def block_histograms(blocks, n_valid):
    """[B, bs] u8 + [B] valid counts -> [B, 256] i32 histograms.

    Scatter-add per block; the valid-prefix mask rides the increments.
    """
    pos = jnp.arange(blocks.shape[1], dtype=jnp.int32)

    def hist_of(block, nv):
        contrib = jnp.where(pos < nv, jnp.int32(1), jnp.int32(0))
        return jnp.zeros(256, jnp.int32).at[block.astype(jnp.int32)].add(contrib)

    return jax.vmap(hist_of)(blocks, n_valid)


def encode_blocks_with_hists(blocks, n_valid, hists, n_words, emit_table=True):
    """Encode blocks against given per-block histograms (tables derive from
    them; pass a broadcast psum'd histogram for the shared-table mode)."""
    assert blocks.shape[1] <= MAX_BLOCK, "block too large for 32-bit code tokens"
    lengths = code_lengths_batch(hists)
    return encode_blocks_from_lengths(blocks, n_valid, lengths, n_words, emit_table)


@partial(jax.jit, static_argnums=(2, 3, 4))
def encode_blocks(blocks, n_valid, n_words, shared_table=False, emit_table=True):
    """Encode [B, bs] u8 blocks -> ([B, n_words] u32, [B] total_bits).

    n_valid [B] gives per-block byte counts (padding beyond is skipped —
    the histogram is restricted to the valid prefix). With
    shared_table=True one table from the summed histogram is used for every
    block (multi-chip mode: psum the histogram over the mesh instead).
    """
    hists = block_histograms(blocks, n_valid)
    if shared_table:
        # one table from the global histogram: build it once and broadcast
        # the lengths (B identical Moffat solves would be pure waste)
        lengths = shared_code_lengths(jnp.sum(hists, axis=0))
        lengths = jnp.broadcast_to(lengths, (blocks.shape[0], 256))
        return encode_blocks_from_lengths(
            blocks, n_valid, lengths, n_words, emit_table
        )
    return encode_blocks_with_hists(blocks, n_valid, hists, n_words, emit_table)
