"""Device PLCP via lane-parallel segment scans.

Kärkkäinen's phi-algorithm (reference ds/PLCPFromPhi.hpp:38-44) is
sequential: plcp[i] starts at plcp[i-1]-1, so the total number of character
comparisons telescopes to O(n + max_lcp). A naive parallel version loses
that amortization (every member of a repeat run grinds its own full lcp:
O(n * avg_lcp) work, seconds of gathers at text sizes).

This formulation keeps the amortization: the text is cut into S segments;
each segment is processed SEQUENTIALLY by one lane (preserving the
l >= l_prev - 1 bound within the segment, so per-segment work is
O(seg + lcp(first position))), and the S lanes run in lockstep under one
while_loop. Each step does one 4-byte word compare per lane (two gathers),
computes the exact byte advance from the XOR (big-endian packing), and
either extends l or finalizes the position and moves on. Only segment
leaders re-grind; total work ~ 2n/4 word compares + S leader lcps.

Exactness requires the TextDS contract: the text's last byte is its unique
0 sentinel (escaped input), so 0-padded out-of-range words can never
compare equal to an in-range window and word equality == 4 matching bytes.
"""

from __future__ import annotations

import numpy as np


def plcp_device(text, sa, seg: int = 4096):
    """[n] u8 text (unique 0 sentinel last) + [n] i32 SA -> [n] i32 PLCP.

    Bit-exact twin of plcp_from_phi_numpy / native tdc_plcp.
    """
    import jax
    import jax.numpy as jnp

    n = int(text.shape[0])
    if n <= 1:
        return jnp.zeros(n, jnp.int32)
    seg = max(64, min(seg, n))
    S = (n + seg - 1) // seg
    I32 = jnp.int32
    idx = jnp.arange(n, dtype=I32)

    # phi[sa[i]] = sa[i-1]; phi[sa[0]] = sa[n-1] (PhiFromSA.hpp:37-45).
    # sa is a permutation: sorting (sa, prev) by sa lands prev in text order.
    prev = jnp.roll(jnp.asarray(sa, I32), 1)
    _, phi = jax.lax.sort((jnp.asarray(sa, I32), prev), num_keys=1)

    t32 = text.astype(jnp.uint32)

    def sh(j):
        return jnp.where(idx < n - j, jnp.roll(t32, -j), 0)

    w4 = (sh(0) << 24) | (sh(1) << 16) | (sh(2) << 8) | sh(3)

    base = jnp.arange(S, dtype=I32) * seg

    def phi_at(i):
        return phi[jnp.clip(i, 0, n - 1)]

    def lane_done(p):
        return (p >= seg) | (base + p >= n)

    def cond(st):
        p = st[0]
        return jnp.any(~lane_done(p))

    def body(st):
        p, l, ph, plcp = st
        i = base + p
        # i == n-1 keeps plcp 0 (reference loop bound i < n-1)
        active = (~lane_done(p)) & (i < n - 1)
        a = jnp.clip(i + l, 0, n - 1)
        b = jnp.clip(ph + l, 0, n - 1)
        x = w4[a] ^ w4[b]
        adv = jnp.where(
            x == 0,
            4,
            jnp.where(
                x < (1 << 8),
                3,
                jnp.where(x < (1 << 16), 2, jnp.where(x < (1 << 24), 1, 0)),
            ),
        ).astype(I32)
        l = jnp.where(active, l + adv, l)
        fin = active & (adv < 4)
        plcp = plcp.at[jnp.where(fin, i, n)].set(
            jnp.where(fin, l, 0), mode="drop"
        )
        skip = (~lane_done(p)) & (i >= n - 1)
        stepping = fin | skip
        p = jnp.where(stepping, p + 1, p)
        ph = jnp.where(stepping, phi_at(base + p), ph)
        l = jnp.where(stepping & fin, jnp.maximum(l - 1, 0), l)
        l = jnp.where(skip, 0, l)
        return p, l, ph, plcp

    p0 = jnp.zeros(S, I32)
    st = (p0, jnp.zeros(S, I32), phi_at(base), jnp.zeros(n, I32))
    _, _, _, plcp = jax.lax.while_loop(cond, body, st)
    return plcp


def lcp_device(text, sa, seg: int = 4096):
    """LCP[i] = PLCP[sa[i]], LCP[0] = 0 (LCPFromPLCP.hpp:38-49), device."""
    import jax.numpy as jnp

    n = int(text.shape[0])
    if n == 0:
        return jnp.zeros(0, jnp.int32)
    plcp = plcp_device(text, sa, seg=seg)
    lcp = plcp[jnp.asarray(sa, jnp.int32)]
    return lcp.at[0].set(0)
