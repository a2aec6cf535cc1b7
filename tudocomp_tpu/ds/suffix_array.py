"""Suffix array construction: prefix doubling, host (numpy) and device (JAX).

Replaces the reference's vendored divsufsort (util/divsufsort.hpp:46-286,
ds/SADivSufSort.hpp:13-64) with the sort-based prefix-doubling formulation —
the parallel "sequence-parallel workhorse" of SURVEY.md §7 step 5. Same
output contract: SA[i] = start of the i-th lexicographically smallest
suffix, over the escaped text with its unique 0 sentinel appended.

The device version uses jax.lax.sort two-key sorts inside a while_loop with
early exit once all ranks are distinct; shapes stay static. The host
version is the numpy twin (np.lexsort); a faster native SA-IS lives in the
C++ runtime (native/tdc_native.cpp) and is preferred by TextDS when built.
"""

from __future__ import annotations

import numpy as np


def suffix_array_numpy(text: np.ndarray) -> np.ndarray:
    """Prefix-doubling SA on host. O(n log^2 n)."""
    text = np.asarray(text, dtype=np.uint8)
    n = len(text)
    if n == 0:
        return np.zeros(0, dtype=np.int32)
    rank = text.astype(np.int64)
    idx = np.arange(n, dtype=np.int64)
    k = 1
    while True:
        key2 = np.full(n, -1, dtype=np.int64)
        key2[: n - k] = rank[k:]
        order = np.lexsort((key2, rank))
        r_ord = rank[order]
        k2_ord = key2[order]
        new_group = np.ones(n, dtype=np.int64)
        new_group[0] = 0
        new_group[1:] = (r_ord[1:] != r_ord[:-1]) | (k2_ord[1:] != k2_ord[:-1])
        ranks_sorted = np.cumsum(new_group)
        rank = np.empty(n, dtype=np.int64)
        rank[order] = ranks_sorted
        if ranks_sorted[-1] == n - 1:
            return order.astype(np.int32)
        k *= 2


def suffix_array_jax(text, n_iters: int = None):
    """Prefix-doubling SA on device. [n] u8 -> [n] i32.

    n_iters defaults to ceil(log2 n); the loop early-exits (while_loop)
    once ranks are distinct.
    """
    import jax
    import jax.numpy as jnp

    n = text.shape[0]
    if n == 0:
        return jnp.zeros(0, jnp.int32)
    max_iters = n_iters or max(1, (n - 1).bit_length())
    idx = jnp.arange(n, dtype=jnp.int32)

    def round_body(state):
        rank, k, _done = state
        key2 = jnp.where(idx + k < n, jnp.roll(rank, -k), -1)
        r_ord, k2_ord, order = jax.lax.sort((rank, key2, idx), num_keys=2)
        new_group = jnp.concatenate(
            [
                jnp.zeros(1, jnp.int32),
                (
                    (r_ord[1:] != r_ord[:-1]) | (k2_ord[1:] != k2_ord[:-1])
                ).astype(jnp.int32),
            ]
        )
        ranks_sorted = jnp.cumsum(new_group)
        rank = jnp.zeros(n, jnp.int32).at[order].set(ranks_sorted)
        done = ranks_sorted[-1] == n - 1
        return rank, k * 2, done

    def cond(state):
        _, k, done = state
        return (~done) & (k < 2 * n)

    rank0 = text.astype(jnp.int32)
    rank, _, _ = jax.lax.while_loop(cond, round_body, (rank0, jnp.int32(1), False))
    # final SA = argsort of ranks (ranks distinct, or text degenerate with
    # all-equal suffix prefixes resolved by the loop cap)
    _, sa = jax.lax.sort((rank, idx), num_keys=1)
    return sa


def suffix_array_device(text, return_isa: bool = False, q: int = 4):
    """Staged Larsson-Sadakane prefix doubling. [n] u8 -> [n] i32.

    Replaces the two-key doubling of `suffix_array_jax` with a design that
    trades gathers for extra sort operands (multi-key variadic sorts; how
    that trade falls on the GPU's sort is not measured yet):

      * the initial round sorts FOUR packed words (3 chars @ 10 bits each,
        char+1 so a 0 pad byte orders shorter suffixes first) -> the loop
        starts at k=12 instead of k=1;
      * each round sorts `q` keys (rank[i], rank[i+k], .., rank[i+(q-1)k])
        so k multiplies by q per round (log_q rounds, not log_2);
      * ranks use the head-rank convention (rank = SA index of the group
        head), so a finished element's rank IS its final SA position and
        the final rank array IS the ISA — ISAFromSA costs nothing here;
      * groups that become singletons are retired: the active set drains
        through a cascade of progressively smaller work arrays (n, n/4,
        n/16, n/64), each stage a while_loop that refines until its
        actives fit the next stage. All stages trace into ONE jit — no
        host round-trips — and compact-stage rounds pay gathers only on
        the surviving actives.

    Cites: reference divsufsort (util/divsufsort.hpp:254) is what this
    replaces; SURVEY.md §7 step 5.
    """
    import jax
    import jax.numpy as jnp

    n = int(text.shape[0])
    if n == 0:
        out = jnp.zeros(0, jnp.int32)
        return (out, out) if return_isa else out
    if n == 1:
        out = jnp.zeros(1, jnp.int32)
        return (out, out) if return_isa else out

    I32 = jnp.int32
    idx = jnp.arange(n, dtype=I32)
    cp1 = text.astype(I32) + 1  # 1..256; out-of-range pads are 0

    def chshift(j):
        return jnp.where(idx < n - j, jnp.roll(cp1, -j), 0)

    def group_ranks(diff):
        """head-rank per sorted slot + finished flag (singleton group)."""
        head = jax.lax.cummax(jnp.where(diff, idx[: diff.shape[0]], 0))
        nxt = jnp.concatenate([diff[1:], jnp.ones(1, bool)])
        return head, diff & nxt

    # ---- initial order: 4 words = 12-char prefixes --------------------
    words = []
    for m in range(4):
        w = (chshift(3 * m) << 20) | (chshift(3 * m + 1) << 10) | chshift(3 * m + 2)
        words.append(w)
    *w_ord, order = jax.lax.sort((*words, idx), num_keys=4)
    diff = jnp.ones(n, bool).at[1:].set(
        (w_ord[0][1:] != w_ord[0][:-1])
        | (w_ord[1][1:] != w_ord[1][:-1])
        | (w_ord[2][1:] != w_ord[2][:-1])
        | (w_ord[3][1:] != w_ord[3][:-1])
    )
    head, fin_ord = group_ranks(diff)
    _, rank_full, fin_full = jax.lax.sort(
        (order, head, fin_ord.astype(I32)), num_keys=1
    )
    k0 = 12

    def sorted_diff(g_ord, key_ords):
        d = jnp.ones(g_ord.shape[0], bool).at[1:].set(
            g_ord[1:] != g_ord[:-1]
        )
        for ko in key_ords:
            d = d.at[1:].set(d[1:] | (ko[1:] != ko[:-1]))
        return d

    # ---- stage 1: full-size rounds (keys by roll, cheap) --------------
    def full_round(state):
        rank_full, _fin, k, _na = state
        keys = [rank_full]
        for m in range(1, q):
            keys.append(
                jnp.where(idx < n - m * k, jnp.roll(rank_full, -(m * k)), -1)
            )
        *k_ord, order = jax.lax.sort((*keys, idx), num_keys=q)
        d = sorted_diff(k_ord[0], k_ord[1:])
        head, fin_ord = group_ranks(d)
        _, rank_full, fin_i = jax.lax.sort(
            (order, head, fin_ord.astype(I32)), num_keys=1
        )
        na = jnp.sum((fin_i == 0).astype(I32))
        return rank_full, fin_i, k * q, na

    def run_full_stage(state, target):
        def cond(state):
            return state[3] > target

        return jax.lax.while_loop(cond, full_round, state)

    # ---- compact stages: actives only, keys by gather -----------------
    def compact_round(state):
        g, pos, _fin, k, _na, rank_full = state
        keys = [g]
        for m in range(1, q):
            off = pos + m * k
            keys.append(
                jnp.where(
                    off < n, rank_full[jnp.clip(off, 0, n - 1)], -1
                )
            )
        *k_ord, pos = jax.lax.sort((*keys, pos), num_keys=q)
        g_ord = k_ord[0]
        gchg = jnp.ones(g_ord.shape[0], bool).at[1:].set(
            g_ord[1:] != g_ord[:-1]
        )
        d = sorted_diff(g_ord, k_ord[1:])
        j = idx[: g_ord.shape[0]]
        gh = jax.lax.cummax(jnp.where(gchg, j, 0))
        sgh = jax.lax.cummax(jnp.where(d, j, 0))
        g_new = g_ord + (sgh - gh)
        nxt = jnp.concatenate([d[1:], jnp.ones(1, bool)])
        fin = (d & nxt).astype(I32)
        live = g_new < n  # dummies carry g >= n and never scatter back
        rank_full = rank_full.at[jnp.where(live, pos, n)].set(
            g_new, mode="drop"
        )
        na = jnp.sum((live & (fin == 0)).astype(I32))
        return g_new, pos, fin, k * q, na, rank_full

    def extract(sortkey, pos_src, m):
        """actives (sortkey < n) first, in rank order; pad with dummies."""
        g_s, pos_s = jax.lax.sort((sortkey, pos_src), num_keys=1)
        return g_s[:m], pos_s[:m]

    def run_compact_stage(g, pos, fin, k, na, rank_full, target):
        def cond(state):
            return state[4] > target

        return jax.lax.while_loop(
            cond, compact_round, (g, pos, fin, k, na, rank_full)
        )

    na0 = jnp.sum((fin_full == 0).astype(I32))
    caps = [m for m in (n // 4, n // 16, n // 64) if m >= 2048]
    targets = caps + [0]
    state = run_full_stage((rank_full, fin_full, jnp.asarray(k0, I32), na0),
                           targets[0])
    rank_full, fin_full, k, na = state
    if caps:
        sortkey = jnp.where(fin_full != 0, n, rank_full)
        g, pos = extract(sortkey, idx, caps[0])
        fin = (g >= n).astype(I32)
        for i, m in enumerate(caps):
            if i > 0:
                sortkey = jnp.where(fin != 0, n, g)
                g, pos = extract(sortkey, pos, m)
                fin = (g >= n).astype(I32)
            g, pos, fin, k, na, rank_full = run_compact_stage(
                g, pos, fin, k, na, rank_full, targets[i + 1]
            )
    _, sa = jax.lax.sort((rank_full, idx), num_keys=1)
    if return_isa:
        return sa, rank_full
    return sa


def _lib_with(fn_name: str):
    from .. import native

    lib = native.get_lib()
    return lib if lib is not None and hasattr(lib, fn_name) else None


def inverse_permutation(sa: np.ndarray) -> np.ndarray:
    """ISA[sa[i]] = i (ds/ISAFromSA.hpp:12-61); prefetched native scatter."""
    n = len(sa)
    isa = np.empty(n, dtype=np.int32)
    lib = _lib_with("tdc_inverse_perm") if n else None
    if lib is not None:
        lib.tdc_inverse_perm(np.ascontiguousarray(sa, np.int32), n, isa)
        return isa
    isa[sa] = np.arange(n, dtype=np.int32)
    return isa


def phi_from_sa(sa: np.ndarray) -> np.ndarray:
    """phi[sa[i]] = sa[i-1]; phi[sa[0]] = sa[n-1] (ds/PhiFromSA.hpp:37-45)."""
    n = len(sa)
    phi = np.empty(n, dtype=np.int32)
    if n == 0:
        return phi
    lib = _lib_with("tdc_phi_from_sa")
    if lib is not None:
        lib.tdc_phi_from_sa(np.ascontiguousarray(sa, np.int32), n, phi)
        return phi
    phi[sa[1:]] = sa[:-1]
    phi[sa[0]] = sa[n - 1]
    return phi


def plcp_from_phi_numpy(text: np.ndarray, phi: np.ndarray) -> np.ndarray:
    """Kärkkäinen phi-algorithm (ds/PLCPFromPhi.hpp:38-44), vectorized.

    Chunked compare-and-extend with a max-plus scan propagating the
    plcp[i] >= plcp[i-1]-1 bound between rounds; total compare work stays
    O(n) amortized like the sequential original.
    """
    text = np.asarray(text, dtype=np.uint8)
    n = len(text)
    plcp = np.zeros(n, dtype=np.int64)
    if n <= 1:
        return plcp.astype(np.int32)
    idx = np.arange(n, dtype=np.int64)
    l = np.zeros(n, dtype=np.int64)
    # positions to solve: 0..n-2 (reference loop bound i < n-1)
    active = np.ones(n, dtype=bool)
    active[n - 1] = False
    phi = phi.astype(np.int64)
    chunk = 64
    while active.any():
        # propagate lower bounds: l[i] >= max_j<=i (l[j] + j) - i
        l = np.maximum(l, np.maximum.accumulate(l + idx) - idx)
        ai = np.flatnonzero(active)
        # compare a chunk of characters at i+l vs phi[i]+l
        for _ in range(1):
            a = ai[:, None]
            off = l[ai][:, None] + np.arange(chunk)[None, :]
            p1 = a + off
            p2 = phi[ai][:, None] + off
            ok = (p1 < n) & (p2 < n)
            c1 = text[np.minimum(p1, n - 1)]
            c2 = text[np.minimum(p2, n - 1)]
            eq = ok & (c1 == c2)
            # first mismatch within the chunk (chunk if none)
            adv = np.argmin(eq, axis=1)
            full = eq.all(axis=1)
            adv[full] = chunk
            l[ai] += adv
            still = full
        active[ai] = still
        chunk = min(chunk * 2, 1 << 20)
    plcp[: n - 1] = l[: n - 1]
    return plcp.astype(np.int32)


def lcp_from_plcp(plcp: np.ndarray, sa: np.ndarray) -> np.ndarray:
    """LCP[i] = PLCP[sa[i]], LCP[0] = 0 (ds/LCPFromPLCP.hpp:38-49)."""
    n = len(sa)
    lib = _lib_with("tdc_gather_i32") if n else None
    if lib is not None:
        lcp = np.empty(n, dtype=np.int32)
        lib.tdc_gather_i32(
            np.ascontiguousarray(plcp, np.int32),
            np.ascontiguousarray(sa, np.int32),
            n,
            lcp,
        )
        lcp[0] = 0
        return lcp
    lcp = plcp[sa].astype(np.int32)
    if len(lcp):
        lcp[0] = 0
    return lcp


def naive_suffix_array(text: bytes) -> np.ndarray:
    """O(n^2 log n) reference for tests."""
    n = len(text)
    return np.array(
        sorted(range(n), key=lambda i: text[i:]), dtype=np.int32
    )


def naive_lcp(text: bytes, sa: np.ndarray) -> np.ndarray:
    out = np.zeros(len(sa), dtype=np.int32)
    for i in range(1, len(sa)):
        a, b = text[sa[i - 1] :], text[sa[i] :]
        l = 0
        while l < len(a) and l < len(b) and a[l] == b[l]:
            l += 1
        out[i] = l
    return out
