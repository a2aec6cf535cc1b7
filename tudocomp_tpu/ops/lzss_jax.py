"""Device-side lzss_lcp factorization: parallel ANSV + greedy parse.

The reference factorizer (compressors/LZSSLCPCompressor.hpp:60-115) walks
the text left to right and, per position, scans the suffix array for the
previous/next smaller value (PSV/NSV) while folding the minimum LCP along
the way — O(n^2) worst case. The host rebuild replaces the scans with O(n)
monotone stacks (native tdc_lzss_lcp_factorize). This module is the
data-parallel device formulation (SURVEY.md §7 step 6):

  1. ANSV with min-LCP: pointer doubling over the "previous/next smaller"
     candidate chain — O(log n) rounds of two gathers, carrying the range
     minimum of LCP alongside the candidate pointer, so psv_lcp/nsv_lcp
     arrive with the positions (the stack algorithm's min bookkeeping,
     vectorized).
  2. Greedy left-to-right factor selection: the walk i += max(len_i, 1) is
     an orbit of a jump function f; the visited set is computed by orbit
     doubling (v |= v∘f^(2^k); f^(2^(k+1)) = f^(2^k)∘f^(2^k)), again
     O(log n) rounds of one gather + one scatter.

Outputs match tdc_lzss_lcp_factorize exactly (ties prefer PSV; factors
require len >= threshold; position n-1 never starts a factor).
"""

from __future__ import annotations

import numpy as np


def ansv_minlcp(sa, lcp):
    """PSV/NSV over the SA with folded min-LCP, by compacted chain jumps.

    Args: sa [n] i32, lcp [n] i32 (lcp[0] = 0).
    Returns (psv_src, psv_lcp, nsv_src, nsv_lcp), each [n] i32;
    src = sa[psv/nsv position] or -1 where none exists, lcp = min LCP over
    the skipped SA range (0 where none).

    Round 1 resolves the ~half of all positions whose smaller neighbour is
    adjacent with pure rolls; survivors drain through progressively
    smaller compact work arrays (n/2, n/8, n/32) whose rounds pay gathers
    only on live elements — same staged pattern as suffix_array_device.
    Chain shortcuts through resolved elements jump whole monotone runs, so
    live counts fall geometrically on permutation-like SAs (gathers are
    the dominant term).
    """
    import jax
    import jax.numpy as jnp

    sa = jnp.asarray(sa, jnp.int32)
    lcp = jnp.asarray(lcp, jnp.int32)
    n = sa.shape[0]
    if n == 0:
        z = jnp.zeros(0, jnp.int32)
        return z, z, z, z
    idx = jnp.arange(n, dtype=jnp.int32)
    caps = [m for m in (n // 2, n // 8, n // 32) if m >= 2048]
    targets = caps + [0]

    def side(p0, m0, found_fn):
        # p_full/m_full are SA-index-order carries; found_fn(p, sa_own)
        # decides whether candidate p terminates the chain for an element
        # whose own sa value is sa_own.
        def live_of(p, sa_own):
            return ~found_fn(p, sa[jnp.clip(p, 0, n - 1)], sa_own)

        def full_round(state):
            p, m, _na = state
            live = live_of(p, sa)
            c = jnp.clip(p, 0, n - 1)
            p2 = jnp.where(live, p[c], p)
            m2 = jnp.where(live, jnp.minimum(m, m[c]), m)
            na = jnp.sum(live_of(p2, sa).astype(jnp.int32))
            return p2, m2, na

        def run_full(state, target):
            return jax.lax.while_loop(
                lambda s: s[2] > target, full_round, state
            )

        na0 = jnp.sum(live_of(p0, sa).astype(jnp.int32))
        p, m, na = run_full((p0, m0, na0), targets[0])

        if caps:
            live = live_of(p, sa)

            def extract(sortkey, src_ids, cap):
                _, ids = jax.lax.sort((sortkey, src_ids), num_keys=1)
                return ids[:cap]

            ids = extract(jnp.where(live, idx, n), idx, caps[0])

            def compact_round(state):
                ids, pc, mc, livec, na, p_full, m_full = state
                c = jnp.clip(pc, 0, n - 1)
                upd = livec
                p2 = jnp.where(upd, p_full[c], pc)
                m2 = jnp.where(upd, jnp.minimum(mc, m_full[c]), mc)
                sa_ids = sa[jnp.clip(ids, 0, n - 1)]
                livec = upd & ~found_fn(
                    p2, sa[jnp.clip(p2, 0, n - 1)], sa_ids
                )
                drop = jnp.where(ids < n, ids, n)
                p_full = p_full.at[drop].set(p2, mode="drop")
                m_full = m_full.at[drop].set(m2, mode="drop")
                na = jnp.sum(livec.astype(jnp.int32))
                return ids, p2, m2, livec, na, p_full, m_full

            for i, cap in enumerate(caps):
                if i > 0:
                    ids = extract(
                        jnp.where(livec, ids, n), ids, cap
                    )
                pc = p[jnp.clip(ids, 0, n - 1)]
                mc = m[jnp.clip(ids, 0, n - 1)]
                sa_ids = sa[jnp.clip(ids, 0, n - 1)]
                livec = (ids < n) & ~found_fn(
                    pc, sa[jnp.clip(pc, 0, n - 1)], sa_ids
                )
                state = (ids, pc, mc, livec,
                         jnp.sum(livec.astype(jnp.int32)), p, m)
                state = jax.lax.while_loop(
                    lambda s: s[4] > targets[i + 1], compact_round, state
                )
                ids, pc, mc, livec, _na, p, m = state
        return p, m

    # PSV: candidate left neighbour; m covers lcp over (p, j]
    def psv_found(p, sa_p, sa_own):
        return (p < 0) | (sa_p < sa_own)

    sa_prev = jnp.roll(sa, 1)
    found1 = (idx == 0) | (sa_prev < sa)
    p0 = jnp.where(found1, idx - 1, idx - 2)
    m0 = jnp.where(
        found1, lcp, jnp.minimum(lcp, jnp.roll(lcp, 1))
    ).astype(jnp.int32)
    p, m = side(p0, m0, psv_found)
    psv_ok = p >= 0
    psv_src = jnp.where(psv_ok, sa[jnp.clip(p, 0, n - 1)], -1)
    psv_lcp = jnp.where(psv_ok, m, 0)

    # NSV: candidate right neighbour; m covers lcp over (j, p]
    def nsv_found(p, sa_p, sa_own):
        return (p >= n) | (sa_p < sa_own)

    sa_next = jnp.roll(sa, -1)
    lcp_next = jnp.where(idx + 1 < n, jnp.roll(lcp, -1), 0).astype(jnp.int32)
    foundn = (idx == n - 1) | (sa_next < sa)
    p0 = jnp.where(foundn, idx + 1, idx + 2)
    m0 = jnp.where(
        foundn,
        lcp_next,
        jnp.minimum(lcp_next, jnp.where(idx + 2 < n, jnp.roll(lcp, -2), 0)),
    ).astype(jnp.int32)
    p, m = side(p0, m0, nsv_found)
    nsv_ok = p < n
    nsv_src = jnp.where(nsv_ok, sa[jnp.clip(p, 0, n - 1)], -1)
    nsv_lcp = jnp.where(nsv_ok, m, 0)
    return psv_src, psv_lcp, nsv_src, nsv_lcp


def greedy_visited(step):
    """Visited set of the walk i_{k+1} = i_k + step[i_k] from 0.

    step [n] i32 (>= 1). Returns visited [n] bool, by orbit doubling.
    """
    import jax
    import jax.numpy as jnp

    n = step.shape[0]
    if n == 0:
        return jnp.zeros(0, bool)
    rounds = max(1, (n - 1).bit_length()) + 1
    idx = jnp.arange(n, dtype=jnp.int32)
    f = jnp.clip(idx + jnp.maximum(step, 1), 0, n)  # n = sink

    def body(_, state):
        v, g = state
        # v' = v | image of v under g (scatter-or); g' = g o g
        img = jnp.zeros(n, jnp.int32).at[jnp.clip(g, 0, n - 1)].max(
            v.astype(jnp.int32) * (g < n)
        )
        v = v | (img > 0)
        gext = jnp.concatenate([g, jnp.array([n], jnp.int32)])  # gext[n] = n
        g = gext[g]
        return v, g

    v0 = idx == 0
    v, _ = jax.lax.fori_loop(0, rounds, body, (v0, f))
    return v


def lzss_lcp_candidates(sa, isa, lcp, threshold):
    """Per text position: greedy-walk step, factor length and source.

    Returns (step [n] i32, flen [n] i32, fsrc [n] i32) in TEXT order:
    flen[i] >= threshold means position i would emit factor (i, fsrc, flen)
    if visited; step[i] = flen[i] or 1. Position n-1 never factors.
    """
    import jax.numpy as jnp

    n = sa.shape[0]
    psv_src, psv_lcp, nsv_src, nsv_lcp = ansv_minlcp(sa, lcp)
    use_psv = psv_lcp >= nsv_lcp  # ties prefer PSV (reference)
    maxl = jnp.where(use_psv, psv_lcp, nsv_lcp)
    msrc = jnp.where(use_psv, psv_src, nsv_src)
    # to text order
    maxl_t = maxl[isa]
    msrc_t = msrc[isa]
    idx = jnp.arange(n, dtype=jnp.int32)
    is_factor = (maxl_t >= threshold) & (idx + 1 < n)
    step = jnp.where(is_factor, maxl_t, 1)
    flen = jnp.where(is_factor, maxl_t, 0)
    return step, flen, msrc_t


def lzss_lcp_factorize_device(sa, isa, lcp, threshold):
    """Full device factorization; returns host arrays (pos, src, len).

    Mirrors tdc_lzss_lcp_factorize output exactly.
    """
    import jax
    import jax.numpy as jnp

    n = int(sa.shape[0])
    if n == 0:
        e = np.zeros(0, np.int64)
        return e, e, e

    @jax.jit
    def run(sa, isa, lcp):
        step, flen, fsrc = lzss_lcp_candidates(sa, isa, lcp, threshold)
        visited = greedy_visited(step)
        sel = visited & (flen > 0)
        return sel, flen, fsrc

    sel, flen, fsrc = run(
        jnp.asarray(sa, jnp.int32),
        jnp.asarray(isa, jnp.int32),
        jnp.asarray(lcp, jnp.int32),
    )
    sel = np.asarray(sel)
    pos = np.flatnonzero(sel)
    return (
        pos.astype(np.int64),
        np.asarray(fsrc)[pos].astype(np.int64),
        np.asarray(flen)[pos].astype(np.int64),
    )
