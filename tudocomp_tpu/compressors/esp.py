"""ESP grammar compressor (id "esp").

Mirror of compressors/EspCompressor.hpp:20-92 and the esp/ subsystem:
rounds of edit-sensitive parsing (EspContextImpl.hpp:14-165) split the
current symbol string into metablocks — type 2 (non-repeating, alphabet
reduction + landmark spanning, meta_blocks.hpp:65-180) and type 1/3
(repeating runs / short prefixes, :33-63) — adjust block sizes to 2/3
(BlockAdjust.hpp), then name each block with a grammar rule deduplicated in
first-appearance order (GrammarRules.hpp; 3-blocks become two 2-rules).
Rounds recurse on the rule-id string until length <= 1; the accumulated SLP
(rule pairs offset by 256, esp/SLP.hpp:12-55) is serialized by the
slp_coder:
  plain   PlainSLPCoder.hpp: 6-bit width | root | rule pairs, fixed width.
The per-round hot loop runs in the C++ runtime (tdc_esp_round) with a
Python fallback implementing identical semantics.
"""

from __future__ import annotations

import numpy as np

from ..base import Compressor
from ..io.bitio import BitReader, BitWriter, bits_for
from ..io.inout import Input, Output
from ..meta import Algorithm, Meta
from ..stats.phase import StatPhase
from .. import native

# ---------------------------------------------------------------------------
# python fallback of one ESP round (exact mirror of native tdc_esp_round)


def _iter_log(n: int) -> int:
    if n < 7:
        return 0
    if n < 9:
        return 1
    if n < 17:
        return 2
    if n < 257:
        return 3
    return 4


def _label(left: int, right: int) -> int:
    diff = left ^ right
    l = (diff & -diff).bit_length() - 1
    return 2 * l + ((right >> l) & 1)


def _eager_mb13(blocks, length, t):
    remaining = length
    while remaining:
        if remaining == 4:
            blocks.append([2, t])
            blocks.append([2, t])
            return
        if remaining <= 3:
            blocks.append([remaining, t])
            return
        blocks.append([3, t])
        remaining -= 3


def _eager_mb2(blocks, A, alphabet):
    L = len(A)
    t3 = min(_iter_log(alphabet), L)
    _eager_mb13(blocks, t3, 3)
    if t3 == L:
        return
    buf = [int(x) for x in A]
    for _ in range(t3):
        for i in range(1, len(buf)):
            buf[i - 1] = _label(buf[i - 1], buf[i])
        buf.pop()
    B = len(buf)
    for to_replace in range(3, 6):
        for i in range(B):
            if buf[i] != to_replace:
                continue
            nb = []
            if i > 0:
                nb.append(buf[i - 1])
            if i + 1 < B:
                nb.append(buf[i + 1])
            e = 0
            for v in nb:
                if v == e:
                    e += 1
            for v in nb:
                if v == e:
                    e += 1
            buf[i] = e
    lm = [0] * B
    for i in range(B):
        high = True
        if i > 0 and buf[i - 1] > buf[i]:
            high = False
        if i + 1 < B and buf[i + 1] > buf[i]:
            high = False
        if high:
            lm[i] = 1
    for i in range(B):
        low = True
        if i > 0 and buf[i - 1] < buf[i]:
            low = False
        if i + 1 < B and buf[i + 1] < buf[i]:
            low = False
        if low and (i == 0 or lm[i - 1] == 0) and (i + 1 >= B or lm[i + 1] == 0):
            lm[i] = 1
    b0 = [0, 0]
    bi = 0
    for i in range(B):
        if not lm[i]:
            continue
        b1 = [i - 1 if i else 0, i + 1 if i + 1 < B else i]
        if bi > 0 and b1[0] == b0[1]:
            b0[1] -= 1  # tie to right
        if bi == 0:
            bi = 1
        else:
            blocks.append([b0[1] - b0[0] + 1, 2])
        b0 = b1
    if bi == 1:
        blocks.append([b0[1] - b0[0] + 1, 2])


def _adjust_blocks(blocks):
    if len(blocks) < 2:
        return blocks

    def needs(a, b):
        return a[0] == 1 or b[0] == 1

    def merge(a, b, t):
        s = a[0] + b[0]
        if s in (2, 3):
            a[0] = b[0] = s
            a[1] = b[1] = t
            return 1
        a[0] = b[0] = 2
        a[1] = b[1] = t
        return 2

    out = []
    q = []
    read = 0

    def fill():
        nonlocal read
        while len(q) < 3 and read < len(blocks):
            q.append(blocks[read])
            read += 1

    def step():
        if not any(e[0] == 1 for e in q):
            return False
        if len(q) == 3:
            a, b = q[1], q[2]
            if needs(a, b) and a[1] == 2 and b[1] == 2:
                if merge(a, b, 2) == 1:
                    q.pop()
                return True
        if len(q) >= 2:
            a, b = q[0], q[1]
            if needs(a, b) and a[1] == 2 and b[1] == 2:
                if merge(a, b, 2) == 1:
                    q.pop(0)
                return True
            if needs(a, b) and a[1] == 3:
                if merge(a, b, 3) == 1:
                    q.pop(0)
                return True
            if needs(a, b) and (a[1] == 1 or b[1] == 1):
                if merge(a, b, 1) == 1:
                    q.pop(0)
                return True
        return False

    fill()
    while q:
        while True:
            fill()
            if not step():
                break
        out.append(q.pop(0))
    return out


def esp_round_python(src, alphabet):
    n = len(src)
    blocks: list[list[int]] = []
    i = 0
    while i < n:
        j = n
        for k in range(i, n - 1):
            if src[k] == src[k + 1]:
                j = k
                break
        if j != i:
            _eager_mb2(blocks, src[i:j], alphabet)
            i = j
        if i >= n:
            break
        j = n
        for k in range(i, n - 1):
            if src[k] != src[k + 1]:
                j = k + 1
                break
        if j != i:
            _eager_mb13(blocks, j - i, 1)
            i = j
    blocks = _adjust_blocks(blocks)
    rules: dict[tuple[int, int], int] = {}
    rl, rr = [], []

    def add2(a, b):
        key = (a, b)
        r = rules.get(key)
        if r is None:
            r = len(rl)
            rules[key] = r
            rl.append(a)
            rr.append(b)
        return r

    nxt = []
    pos = 0
    for ln, _t in blocks:
        if ln == 2:
            name = add2(int(src[pos]), int(src[pos + 1]))
        else:
            x = add2(int(src[pos]), int(src[pos + 1]))
            name = add2(alphabet + x, int(src[pos + 2]))
        nxt.append(name)
        pos += ln
    assert pos == n, (pos, n)
    return (
        np.array(nxt, np.uint32),
        np.array(rl, np.uint32),
        np.array(rr, np.uint32),
    )


def esp_round(src: np.ndarray, alphabet: int):
    n = len(src)
    lib = native.get_lib()
    if lib is not None and n:
        src_c = np.ascontiguousarray(src, np.uint32)
        out_next = np.empty(n // 2 + 2, np.uint32)
        rl = np.empty(n + 2, np.uint32)
        rr = np.empty(n + 2, np.uint32)
        rc = np.zeros(1, np.int64)
        m = lib.tdc_esp_round(src_c, n, alphabet, out_next, rl, rr, rc)
        assert m >= 0, "esp round block coverage mismatch"
        k = int(rc[0])
        return out_next[:m].copy(), rl[:k].copy(), rr[:k].copy()
    return esp_round_python(src, alphabet)


def generate_grammar(data: np.ndarray):
    """EspContextImpl.hpp:14-165. Returns (rules [R,2] global ids, root,
    empty)."""
    string = np.asarray(data, np.uint32)
    alphabet = 256
    slp_counter = 256
    prev_slp_counter = 0
    all_rules = []
    while True:
        if len(string) == 0:
            return np.zeros((0, 2), np.int64), 0, True
        if len(string) == 1:
            root = int(string[0]) + prev_slp_counter
            break
        nxt, rl, rr = esp_round(string, alphabet)
        # globalize child ids: local symbol space maps by + prev_slp_counter
        pairs = np.stack([rl, rr], axis=1).astype(np.int64) + prev_slp_counter
        all_rules.append(pairs)
        rules_count = len(rl)
        prev_slp_counter = slp_counter
        slp_counter += rules_count
        string = nxt
        alphabet = rules_count
    rules = (
        np.concatenate(all_rules)
        if all_rules
        else np.zeros((0, 2), np.int64)
    )
    return rules, root, False


def derive_text(rules: np.ndarray, root: int) -> bytes:
    """SLP::derive_text (esp/SLP.hpp:25-38), iterative (native stack walk
    when the lib is built; identical python mirror otherwise)."""
    from .. import native

    lib = native.get_lib()
    if lib is not None and hasattr(lib, "tdc_esp_derive"):
        rl = np.ascontiguousarray(rules[:, 0], np.int32) if len(rules) else np.zeros(1, np.int32)
        rr = np.ascontiguousarray(rules[:, 1], np.int32) if len(rules) else np.zeros(1, np.int32)
        # expansion length: each of the R rules adds one extra symbol
        # beyond its left child's expansion, so |text| <= R + 1; pad for
        # degenerate roots
        cap = max(16, 2 * (len(rules) + 1))
        while True:
            out = np.empty(cap, np.uint8)
            n = lib.tdc_esp_derive(rl, rr, len(rules), int(root), out, cap)
            if n == -2:
                raise ValueError("corrupt esp container: rule id out of range")
            if n == -3:
                raise ValueError("corrupt esp container: cyclic rule graph")
            if n >= 0:
                return out[:n].tobytes()
            cap *= 2
    out = bytearray()
    stack = [int(root)]
    # cycle bound mirroring the native walk: with T terminals emitted so
    # far, a valid acyclic derivation has popped at most 2T + n_rules + 1
    # nodes (T leaves, <T expanded internals, one left spine <= n_rules)
    pops = 0
    while stack:
        pops += 1
        if pops > 2 * len(out) + len(rules) + 2:
            raise ValueError("corrupt esp container: cyclic rule graph")
        x = stack.pop()
        if x < 256:
            out.append(x)
        else:
            l, r = rules[x - 256]
            stack.append(int(r))
            stack.append(int(l))
    return bytes(out)


# ---------------------------------------------------------------------------
# SLP coders (type "slp_coder")


class PlainSLPCoder(Algorithm):
    @classmethod
    def meta(cls) -> Meta:
        return Meta("slp_coder", "plain", "Plain SLP encoding")

    @staticmethod
    def encode(w: BitWriter, rules: np.ndarray, root: int, empty: bool) -> None:
        max_val = len(rules) + 256 - 1
        bit_width = 0 if empty else bits_for(max_val)
        w.write_int(bit_width, 6)
        w.write_int(root, bit_width)
        if len(rules):
            w.write_ints(rules.astype(np.uint64).reshape(-1), bit_width)

    @staticmethod
    def decode(r: BitReader):
        bit_width = r.read_int(6)
        empty = bit_width == 0
        root = r.read_int(bit_width)
        n_pairs = (r._valid - r.pos) // (2 * bit_width) if bit_width else 0
        vals = r.read_ints(2 * n_pairs, bit_width) if bit_width else np.zeros(0)
        rules = vals.reshape(-1, 2).astype(np.int64)
        return rules, root, empty


def slp_dep_sort_python(rules: np.ndarray, root: int):
    """BFS dependency sort over the left-child DAG (esp/SLPDepSort.hpp):
    renames rules so left-hand sides are monotone non-decreasing.
    Reference-shaped queue walk; kept as the tested specification for the
    vectorized version below."""
    from collections import deque

    R = len(rules)
    total = R + 256
    # children buckets keyed by left child, in ascending rule order
    buckets: dict[int, list[int]] = {}
    for j in range(R):
        buckets.setdefault(int(rules[j][0]), []).append(j + 256)

    rename = np.zeros(R, dtype=np.int64)
    q = deque(range(256))
    counter = 0
    while q:
        elem = q.popleft()
        for child in buckets.get(elem, ()):
            q.append(child)
        if elem >= 256:
            rename[elem - 256] = counter - 256
        counter += 1
    assert counter == total
    renamed = np.zeros_like(rules)
    for i in range(R):
        pair = rules[i].copy()
        for k in range(2):
            if pair[k] > 255:
                pair[k] = rename[pair[k] - 256] + 256
        renamed[rename[i]] = pair
    if root > 255:
        root = int(rename[root - 256]) + 256
    return renamed, root


def slp_dep_sort(rules: np.ndarray, root: int):
    """Vectorized BFS dependency sort (identical output to
    slp_dep_sort_python).

    The left-child edges form a forest on the rules (every rule sits in
    exactly one bucket), so BFS order is strict level order; within a
    level the queue order is (parent's dequeue order, rule id) — a
    lexsort per level. Dequeue orders: terminal t -> t, rule j -> 256 +
    bfs_rank(j). Levels are materialized via a CSR adjacency built from
    one argsort of the left-child column."""
    R = len(rules)
    if R == 0:
        return rules.copy(), root
    left = rules[:, 0].astype(np.int64)
    order_by_left = np.argsort(left, kind="stable")
    left_sorted = left[order_by_left]

    rank = np.full(R, -1, np.int64)
    cur = np.flatnonzero(left < 256)
    parent_order = left[cur]
    assigned = 0
    while len(cur):
        sel = cur[np.lexsort((cur, parent_order))]
        rank[sel] = assigned + np.arange(len(sel))
        assigned += len(sel)
        # next frontier: children (in the left-child forest) of `sel`
        starts = np.searchsorted(left_sorted, sel + 256, "left")
        ends = np.searchsorted(left_sorted, sel + 256, "right")
        counts = ends - starts
        total = int(counts.sum())
        if total == 0:
            break
        # flatten the CSR ranges [starts, ends)
        rep = np.repeat(np.arange(len(sel)), counts)
        offs = np.arange(total) - np.repeat(
            np.concatenate([[0], np.cumsum(counts)[:-1]]), counts
        )
        cur = order_by_left[starts[rep] + offs]
        parent_order = 256 + rank[left[cur] - 256]
    assert assigned == R
    rename = rank
    renamed = np.empty_like(rules)
    pairs = rules.astype(np.int64, copy=True)
    for k in range(2):
        col = pairs[:, k]
        hi = col > 255
        col[hi] = rename[col[hi] - 256] + 256
    renamed[rename] = pairs.astype(rules.dtype)
    if root > 255:
        root = int(rename[root - 256]) + 256
    return renamed, root


class SortedSLPCoder(Algorithm):
    """SortedSLPCoder.hpp:10-176: dependency-sorts the SLP so rule
    left-hand sides are monotone; header (6-bit width, max_val, root),
    unary-delta LHS chain, then the RHS ("D") array via d_coding (default
    succinct = DMonotonSubseq, SortedSLPCoder.hpp:15)."""

    @classmethod
    def meta(cls) -> Meta:
        m = Meta("slp_coder", "sorted", "Sorted SLP encoding")
        m.option("d_coding").templated("d_coding", "succinct")
        return m

    def encode(self, w: BitWriter, rules, root, empty) -> None:
        max_val = len(rules) + 256 - 1
        bit_width = 0 if empty else bits_for(max_val)
        if not empty and root >= 256:
            rules, root = slp_dep_sort(rules, root)
        w.write_int(bit_width, 6)
        w.write_int(max_val if not empty else 0, bit_width)
        w.write_int(root, bit_width)
        if empty or root < 256:
            return
        lhs = rules[:, 0].astype(np.int64)
        w.write_unaries(np.diff(np.concatenate([[0], lhs])))
        d_coding = self.env.instantiate("d_coding")
        d_coding.encode(w, rules[:, 1], bit_width, max_val)

    def decode(self, r: BitReader):
        bit_width = r.read_int(6)
        empty = bit_width == 0
        max_val = r.read_int(bit_width)
        root = r.read_int(bit_width)
        if empty or root < 256:
            return np.zeros((0, 2), np.int64), root, empty
        slp_size = (max_val + 1) - 256
        lhs = np.cumsum(r.read_unaries(slp_size))
        d_coding = self.env.instantiate("d_coding")
        rhs = d_coding.decode(r, slp_size, bit_width, max_val)
        return np.stack([lhs, rhs], axis=1), root, empty


class _IPD(Algorithm):
    """ipd axis (internal pair dictionary); selection only — the native
    runtime always uses its open-addressing hash map."""


def _make_ipd(ident, doc):
    class I(_IPD):
        @classmethod
        def meta(cls) -> Meta:
            return Meta("ipd", ident, doc)

    I.__name__ = f"IPD_{ident}"
    return I


IPDS = [
    _make_ipd("std_unordered_map", "std::unordered_map pair dictionary"),
    _make_ipd("hash_map", "custom hash map pair dictionary"),
    _make_ipd("dynamic_size", "dynamically sized pair dictionary"),
]


class EspCompressor(Compressor):
    @classmethod
    def meta(cls) -> Meta:
        m = Meta("compressor", "esp", "ESP based grammar compression")
        m.option("slp_coder").templated("slp_coder", "plain")
        m.option("ipd").templated("ipd", "std_unordered_map")
        return m

    @staticmethod
    def _generate(data: np.ndarray):
        """Grammar construction with the device-policy gate.

        The staged device parse (ops/esp_jax.py) runs every ESP round as
        sorts + elementwise passes on the accelerator and is bit-identical
        to the host rounds (it re-runs the host path on its rare
        adjust-window fallback, and counts that in its StatPhase). On by
        default on an accelerator from 2 MiB; the crossover on the GPU is
        not measured yet."""
        from ..device import use_device

        n = len(data)
        if n and use_device("TDC_DEVICE_ESP", min_n=1 << 21, n=n):
            from ..ops.esp_jax import esp_grammar_device

            with StatPhase("device ESP rounds"):
                return esp_grammar_device(data)
        return generate_grammar(data)

    def compress(self, inp: Input, out: Output) -> None:
        data = inp.as_array()
        with StatPhase("ESP Algorithm") as ph:
            rules, root, empty = self._generate(data)
            ph.log("SLP size", len(rules))
        with StatPhase("Encode SLP"):
            w = BitWriter()
            coder = self.env.instantiate("slp_coder")
            coder.encode(w, rules, root, empty)
            out.write(w.getvalue())

    def decompress(self, inp: Input, out: Output) -> None:
        r = BitReader(inp.as_bytes())
        coder = self.env.instantiate("slp_coder")
        rules, root, empty = coder.decode(r)
        if not empty:
            out.write(derive_text(rules, root))


def register(registry):
    from . import esp_dcoding

    registry.register(EspCompressor)
    registry.register(PlainSLPCoder)
    registry.register(SortedSLPCoder)
    esp_dcoding.register(registry)
    for i in IPDS:
        registry.register(i)
