"""lcpcomp compressor (id "lcpcomp") — the SEA'17 research centerpiece.

Mirror of compressors/LCPCompressor.hpp:80-151: repeatedly factorize the
maximal-LCP suffix-array position (lcp[i] chars at sa[i] <- sa[i-1],
*forward* references allowed), using the "arrays" bucket strategy
(lcpcomp/compress/ArraysComp.hpp) in the C++ runtime; factors are sorted
by position and optionally flattened (LZSSFactors.hpp:79-132); the stream
is the shared lzss format. Decompression is the scan decoder
(lcpcomp/decompress/ScanDec.hpp): parse-time immediate copies, `scans`
lazy passes, then eager chain resolution over forward-reference buckets.

Strategy axes: comp in {arrays (default, bucket arrays), heap (max-heap
with decrease-key, MaxHeapStrategy.hpp), max_lcp/maxlcp (bucket list with
most-recent-first tie order, MaxLCPStrategy.hpp + MaxLCPSuffixList.hpp),
plcppeaks (single pass over PLCP local peaks, PLCPPeaksStrategy.hpp)};
dec in {scan (default, lazy scans + eager pass, ScanDec.hpp), compact
(fully eager forward buckets, CompactDec.hpp)}. Tie order among equal-LCP
candidates is strategy-implementation specific, here as in the reference.
"""

from __future__ import annotations

import os

import numpy as np

from ..base import Compressor
from ..ds import flags
from ..ds.textds import TextDS
from ..io.bitio import BitReader, BitWriter
from ..io.inout import Input, Output
from ..meta import Algorithm, Meta
from ..ranges import LEN_MAX, MinDistributedRange, Range, bit_r, len_r, literal_r
from ..stats.phase import StatPhase
from .. import native
from . import lzss_common


def arrays_factorize(sa, isa, lcp, threshold: int) -> lzss_common.Factors:
    """ArraysComp.hpp:36-119 (native); mutates a copy of lcp."""
    n = len(sa)
    lcp_mut = np.ascontiguousarray(lcp, np.int32).copy()
    lib = native.get_lib()
    if lib is not None and n:
        fpos = np.empty(n, np.uint32)
        fsrc = np.empty(n, np.uint32)
        flen = np.empty(n, np.uint32)
        nf = lib.tdc_lcpcomp_arrays_factorize(
            np.ascontiguousarray(sa, np.int32),
            np.ascontiguousarray(isa, np.int32),
            lcp_mut,
            n,
            threshold,
            fpos,
            fsrc,
            flen,
        )
        return lzss_common.Factors(fpos[:nf].copy(), fsrc[:nf].copy(), flen[:nf].copy())
    # python mirror
    max_lcp = int(lcp_mut.max()) if n else 0
    if max_lcp + 1 <= threshold:
        return lzss_common.Factors([], [], [])
    cand: list[list[int]] = [[] for _ in range(max_lcp + 1 - threshold)]
    for i in range(1, n):
        if lcp_mut[i] >= threshold:
            cand[lcp_mut[i] - threshold].append(i)
    fpos_l, fsrc_l, flen_l = [], [], []
    for maxlcp in range(max_lcp, threshold - 1, -1):
        col = cand[maxlcp - threshold]
        for index in col:
            lv = int(lcp_mut[index])
            if lv < maxlcp:
                if lv >= threshold:
                    cand[lv - threshold].append(index)
                continue
            pos_target = int(sa[index])
            fpos_l.append(pos_target)
            fsrc_l.append(int(sa[index - 1]))
            flen_l.append(lv)
            for k in range(lv):
                lcp_mut[isa[pos_target + k]] = 0
            for k in range(min(lv, pos_target)):
                ind = isa[pos_target - k - 1]
                lcp_mut[ind] = min(k + 1, int(lcp_mut[ind]))
        col.clear()
    return lzss_common.Factors(fpos_l, fsrc_l, flen_l)


def heap_factorize(sa, isa, lcp, threshold: int) -> lzss_common.Factors:
    """MaxHeapStrategy.hpp:22-103 (native); python mirror for fallback."""
    n = len(sa)
    lib = native.get_lib()
    if lib is not None and n:
        fpos = np.empty(n, np.uint32)
        fsrc = np.empty(n, np.uint32)
        flen = np.empty(n, np.uint32)
        nf = lib.tdc_lcpcomp_heap_factorize(
            np.ascontiguousarray(sa, np.int32),
            np.ascontiguousarray(isa, np.int32),
            np.ascontiguousarray(lcp, np.int32),
            n,
            threshold,
            fpos,
            fsrc,
            flen,
        )
        return lzss_common.Factors(fpos[:nf].copy(), fsrc[:nf].copy(), flen[:nf].copy())
    import heapq

    key = [int(x) for x in lcp]
    alive = [False] * n
    h = []
    for i in range(1, n):
        if key[i] >= threshold:
            alive[i] = True
            heapq.heappush(h, (-key[i], i))
    fpos_l, fsrc_l, flen_l = [], [], []
    while h:
        negk, m = heapq.heappop(h)
        if not alive[m] or -negk != key[m]:
            continue
        p, src, ln = int(sa[m]), int(sa[m - 1]), key[m]
        fpos_l.append(p)
        fsrc_l.append(src)
        flen_l.append(ln)
        for k in range(ln):
            alive[int(isa[p + k])] = False
        for k in range(min(ln, p)):
            s2 = p - k - 1
            i = int(isa[s2])
            if alive[i] and s2 + key[i] > p:
                l2 = p - s2
                if l2 >= threshold:
                    key[i] = l2
                    heapq.heappush(h, (-l2, i))
                else:
                    alive[i] = False
    return lzss_common.Factors(fpos_l, fsrc_l, flen_l)


def bheap_factorize(sa, isa, lcp, threshold: int) -> lzss_common.Factors:
    """BoostHeap.hpp:24-119 ("bheap", Boost-gated in the reference): the
    heap strategy with the reference's total order — LCP ties break toward
    the smaller text position. Native; python heapq mirror for fallback."""
    n = len(sa)
    lib = native.get_lib()
    if lib is not None and n:
        fpos = np.empty(n, np.uint32)
        fsrc = np.empty(n, np.uint32)
        flen = np.empty(n, np.uint32)
        nf = lib.tdc_lcpcomp_bheap_factorize(
            np.ascontiguousarray(sa, np.int32),
            np.ascontiguousarray(isa, np.int32),
            np.ascontiguousarray(lcp, np.int32),
            n,
            threshold,
            fpos,
            fsrc,
            flen,
        )
        return lzss_common.Factors(fpos[:nf].copy(), fsrc[:nf].copy(), flen[:nf].copy())
    import heapq

    key = [int(x) for x in lcp]
    alive = [False] * n
    h = []
    for i in range(1, n):
        if key[i] >= threshold:
            alive[i] = True
            heapq.heappush(h, (-key[i], int(sa[i]), i))
    fpos_l, fsrc_l, flen_l = [], [], []
    while h:
        negk, _, m = heapq.heappop(h)
        if not alive[m] or -negk != key[m]:
            continue
        p, src, ln = int(sa[m]), int(sa[m - 1]), key[m]
        fpos_l.append(p)
        fsrc_l.append(src)
        flen_l.append(ln)
        for k in range(ln):
            alive[int(isa[p + k])] = False
        for k in range(min(ln, p)):
            s2 = p - k - 1
            i = int(isa[s2])
            if alive[i] and s2 + key[i] > p:
                l2 = p - s2
                if l2 >= threshold:
                    key[i] = l2
                    heapq.heappush(h, (-l2, s2, i))
                else:
                    alive[i] = False
    return lzss_common.Factors(fpos_l, fsrc_l, flen_l)


def plcp_factorize_strategy(sa, isa, plcp, threshold: int) -> lzss_common.Factors:
    """PLCPStrategy.hpp:20-170 ("plcp", Boost-gated in the reference):
    stream PLCP, collect ascent peaks in a max-(lcp, smaller-pos) heap,
    factorize each peak group with right-peak substitution and
    left-overlap trimming. Native; python mirror for fallback."""
    n = len(sa)
    lib = native.get_lib()
    if lib is not None and n:
        fpos = np.empty(n, np.uint32)
        fsrc = np.empty(n, np.uint32)
        flen = np.empty(n, np.uint32)
        nf = lib.tdc_lcpcomp_plcp_factorize(
            np.ascontiguousarray(sa, np.int32),
            np.ascontiguousarray(isa, np.int32),
            np.ascontiguousarray(plcp, np.int32),
            n,
            threshold,
            fpos,
            fsrc,
            flen,
        )
        return lzss_common.Factors(fpos[:nf].copy(), fsrc[:nf].copy(), flen[:nf].copy())
    import heapq

    fpos_l, fsrc_l, flen_l = [], [], []
    pois: list[list[int]] = []  # no -> [pos, lcp]; lcp < 0 = dead
    h: list[tuple[int, int, int]] = []  # (-lcp, pos, no) with lazy deletion

    def alive_top():
        while h:
            negl, pos, no = h[0]
            if no < len(pois) and pois[no][1] == -negl and pois[no][0] == pos:
                return no
            heapq.heappop(h)
        return None

    def emplace(pos, lcp, no):
        while len(pois) <= no:
            pois.append([0, -1])
        pois[no] = [pos, lcp]
        heapq.heappush(h, (-lcp, pos, no))

    lastpos = 0
    lastpos_lcp = 0
    i = 0
    while i + 1 < n:
        plcp_i = int(plcp[i])
        if alive_top() is None:
            if plcp_i >= threshold:
                emplace(i, plcp_i, len(pois))
                lastpos, lastpos_lcp = i, plcp_i
            i += 1
            continue
        if i - lastpos >= lastpos_lcp or i + 1 == n:
            while (top_no := alive_top()) is not None:
                top_pos, top_lcp = pois[top_no]
                fpos_l.append(top_pos)
                fsrc_l.append(int(sa[int(isa[top_pos]) - 1]))
                flen_l.append(top_lcp)
                newlcp_peak = 0
                peak_exists = False
                if top_pos + top_lcp < i:
                    for j in range(top_no + 1, len(pois)):
                        if pois[j][1] < 0:
                            continue
                        pj, lj = pois[j]
                        if pj < top_pos + top_lcp:
                            pois[j][1] = -1
                            if lj + pj > top_pos + top_lcp:
                                newlcp_peak = max(
                                    newlcp_peak, lj + pj - (top_pos + top_lcp)
                                )
                        elif pj == top_pos + top_lcp:
                            peak_exists = True
                        else:
                            break
                if not peak_exists and newlcp_peak >= threshold:
                    emplace(top_pos + top_lcp, newlcp_peak, top_no + 1)
                pois[top_no][1] = -1
                for j in range(len(pois) - 1, -1, -1):
                    if pois[j][1] < 0:
                        continue
                    pj, lj = pois[j]
                    if pj > top_pos:
                        continue
                    newlcp = top_pos - pj
                    if newlcp < lj:
                        if newlcp < threshold:
                            pois[j][1] = -1
                        else:
                            pois[j][1] = newlcp
                            heapq.heappush(h, (-newlcp, pj, j))
                    else:
                        break
            pois.clear()
            h.clear()
            continue  # reprocess i with an empty heap
        if plcp_i > lastpos_lcp:
            emplace(i, plcp_i, len(pois))
            lastpos, lastpos_lcp = i, plcp_i
        i += 1
    return lzss_common.Factors(fpos_l, fsrc_l, flen_l)


def maxlcp_factorize(sa, isa, lcp, threshold: int) -> lzss_common.Factors:
    """MaxLCPStrategy.hpp:22-99 over MaxLCPSuffixList.hpp (native); the tie
    order among equal-LCP entries is most-recent-first (bucket-front
    insertion). Python mirror uses the same lazy-deletion LIFO buckets."""
    n = len(sa)
    lib = native.get_lib()
    if lib is not None and n:
        fpos = np.empty(n, np.uint32)
        fsrc = np.empty(n, np.uint32)
        flen = np.empty(n, np.uint32)
        nf = lib.tdc_lcpcomp_maxlcp_factorize(
            np.ascontiguousarray(sa, np.int32),
            np.ascontiguousarray(isa, np.int32),
            np.ascontiguousarray(lcp, np.int32),
            n,
            threshold,
            fpos,
            fsrc,
            flen,
        )
        return lzss_common.Factors(fpos[:nf].copy(), fsrc[:nf].copy(), flen[:nf].copy())
    key = [int(x) for x in lcp]
    max_lcp = max(key[1:], default=0)
    if max_lcp < threshold:
        return lzss_common.Factors([], [], [])
    alive = [False] * n
    bucket: list[list[int]] = [[] for _ in range(max_lcp + 1)]
    for i in range(1, n):
        if key[i] >= threshold:
            bucket[key[i]].append(i)
            alive[i] = True
    fpos_l, fsrc_l, flen_l = [], [], []
    cur = max_lcp
    while cur >= threshold:
        b = bucket[cur]
        if not b:
            cur -= 1
            continue
        m = b.pop()
        if not alive[m] or key[m] != cur:
            continue  # stale
        p, ln = int(sa[m]), key[m]
        fpos_l.append(p)
        fsrc_l.append(int(sa[m - 1]))
        flen_l.append(ln)
        for k in range(ln):
            alive[int(isa[p + k])] = False
        for k in range(min(ln, p)):
            s = p - k - 1
            i = int(isa[s])
            if alive[i] and s + key[i] > p:
                l2 = p - s
                if l2 >= threshold:
                    key[i] = l2
                    bucket[l2].append(i)
                else:
                    alive[i] = False
    return lzss_common.Factors(fpos_l, fsrc_l, flen_l)


def plcppeaks_factorize(sa, isa, plcp, threshold: int) -> lzss_common.Factors:
    """PLCPPeaksStrategy.hpp:33-80 (native): single left-to-right pass
    taking every PLCP local peak >= threshold, skipping its length."""
    n = len(sa)
    lib = native.get_lib()
    if lib is not None and n:
        fpos = np.empty(n, np.uint32)
        fsrc = np.empty(n, np.uint32)
        flen = np.empty(n, np.uint32)
        nf = lib.tdc_lcpcomp_plcppeaks_factorize(
            np.ascontiguousarray(sa, np.int32),
            np.ascontiguousarray(isa, np.int32),
            np.ascontiguousarray(plcp, np.int32),
            n,
            threshold,
            fpos,
            fsrc,
            flen,
        )
        return lzss_common.Factors(fpos[:nf].copy(), fsrc[:nf].copy(), flen[:nf].copy())
    fpos_l, fsrc_l, flen_l = [], [], []
    last_replacement_pos = 0
    i = 0
    while i + 1 < n:
        if (
            (i == last_replacement_pos or plcp[i] > plcp[i - 1])
            and plcp[i] > plcp[i + 1]
            and plcp[i] >= threshold
        ):
            fpos_l.append(i)
            fsrc_l.append(int(sa[int(isa[i]) - 1]))
            flen_l.append(int(plcp[i]))
            i += int(plcp[i])
            last_replacement_pos = i - 1
        else:
            i += 1
    return lzss_common.Factors(fpos_l, fsrc_l, flen_l)


def sort_and_flatten(factors: lzss_common.Factors, flatten: bool) -> lzss_common.Factors:
    order = np.argsort(factors.pos, kind="stable")
    fpos = factors.pos[order].astype(np.uint32)
    fsrc = factors.src[order].astype(np.uint32)
    flen = factors.len[order].astype(np.uint32)
    if flatten and len(fpos):
        lib = native.get_lib()
        if lib is not None:
            fpos = np.ascontiguousarray(fpos)
            fsrc = np.ascontiguousarray(fsrc)
            flen = np.ascontiguousarray(flen)
            lib.tdc_lcpcomp_flatten(fpos, fsrc, flen, len(fpos))
        else:
            map_size = int(fpos[-1] + flen[-1])
            fmap = np.zeros(map_size, np.int64)
            for i in range(len(fpos)):
                fmap[fpos[i] : fpos[i] + flen[i]] = i + 1
            for i in range(len(fpos)):
                src = int(fsrc[i])
                depth = 0
                while src < map_size and fmap[src]:
                    s = fmap[src] - 1
                    d = src - int(fpos[s])
                    if d + int(flen[i]) <= int(flen[s]):
                        src = int(fsrc[s]) + d
                        depth += 1
                    else:
                        break
                if depth:
                    fsrc[i] = src
    return lzss_common.Factors(fpos, fsrc, flen)


class _StrategyBase(Algorithm):
    pass


def _make_axis(algo_type, ident, doc, options=()):
    class A(_StrategyBase):
        @classmethod
        def meta(cls) -> Meta:
            m = Meta(algo_type, ident, doc)
            for name, default in options:
                m.option(name).dynamic(default)
            return m

    A.__name__ = f"{algo_type}_{ident}"
    return A


COMP_STRATEGIES = [
    _make_axis("lcpcomp_comp", "arrays", "Bucket arrays by LCP value"),
    _make_axis("lcpcomp_comp", "heap", "Max-LCP heap strategy"),
    _make_axis("lcpcomp_comp", "max_lcp", "Max-LCP suffix list strategy"),
    _make_axis("lcpcomp_comp", "plcppeaks", "PLCP peaks strategy"),
    _make_axis("lcpcomp_comp", "bheap", "Heap strategy, smaller-pos tie order (BoostHeap)"),
    _make_axis("lcpcomp_comp", "plcp", "Streaming PLCP peak-group strategy"),
]
DEC_STRATEGIES = [
    _make_axis("lcpcomp_dec", "scan", "Lazy scans + eager decoding", (("scans", 6),)),
    _make_axis("lcpcomp_dec", "compact", "Eager forward-bucket decoding"),
    # QueueListBuffer (DecodeQueueListBuffer.hpp:12-86): stream replay with
    # per-position forward lists. MultimapListBuffer (MultiMapBuffer.hpp:
    # 12-160): eager copies + stored remainders, `lazy` copy rounds, then a
    # multimap-propagated eager pass. Both native; identical output.
    _make_axis("lcpcomp_dec", "QueueListBuffer", "Stream-replay queue-list decoding"),
    _make_axis(
        "lcpcomp_dec",
        "MultimapListBuffer",
        "Lazy-rounds + multimap decoding",
        (("lazy", 0),),
    ),
]


class LCPCompressor(Compressor):
    @classmethod
    def meta(cls) -> Meta:
        m = Meta("compressor", "lcpcomp", "LCP-based compressor (SEA'17)")
        m.option("coder").templated("coder")
        m.option("comp").templated("lcpcomp_comp", "arrays")
        m.option("dec").templated("lcpcomp_dec", "scan")
        m.option("threshold").dynamic(5)
        m.option("flatten").dynamic(1)
        m.option("textds").templated("textds", "textds")
        m.uses_textds(flags.SA | flags.ISA | flags.LCP)
        return m

    def compress(self, inp: Input, out: Output) -> None:
        from ..ds.textds_algo import make_textds

        text = inp.as_array()
        comp_name = self.env.option("comp").as_algorithm().name
        with StatPhase("Construct Text DS"):
            ds = make_textds(self, text)
            sa = ds.require_sa()
            isa = ds.require_isa()
            if comp_name in ("plcppeaks", "plcp"):
                plcp = ds.require_plcp()
            else:
                lcp = ds.require_lcp()
        threshold = self.env.option("threshold").as_integer()
        from ..device import use_device

        with StatPhase("Factorize") as ph:
            if comp_name == "heap":
                factors = heap_factorize(sa, isa, lcp, threshold)
            elif comp_name == "bheap":
                factors = bheap_factorize(sa, isa, lcp, threshold)
            elif comp_name == "plcp":
                factors = plcp_factorize_strategy(sa, isa, plcp, threshold)
            elif comp_name == "max_lcp":
                factors = maxlcp_factorize(sa, isa, lcp, threshold)
            elif comp_name == "plcppeaks":
                if len(sa) and os.environ.get(
                    "TDC_DEVICE_LCPCOMP"
                ) == "1" and use_device("TDC_DEVICE_LCPCOMP", n=len(sa)):
                    # device orbit-doubling walk, bit-identical factors;
                    # OPT-IN (TDC_DEVICE_LCPCOMP=1) until its GPU time is
                    # measured against the host pass. The PQ strategies
                    # (arrays/heap/max_lcp) mutate LCP after every pick and
                    # stay host-side by design
                    from ..ops.lcpcomp_jax import plcppeaks_factorize_device

                    with StatPhase("device lcpcomp factorize"):
                        p, s, l = plcppeaks_factorize_device(
                            sa, isa, plcp, threshold
                        )
                    factors = lzss_common.Factors(p, s, l)
                else:
                    factors = plcppeaks_factorize(sa, isa, plcp, threshold)
            else:
                factors = arrays_factorize(sa, isa, lcp, threshold)
            ph.log("threshold", threshold)
            ph.log("factors", len(factors))
        with StatPhase("Sort Factors"):
            factors = sort_and_flatten(
                factors, bool(self.env.option("flatten").as_integer())
            )
        with StatPhase("Encode Factors"):
            coder_cls, coder_env = self.env.algorithm_for_option("coder")
            w = BitWriter()
            enc = coder_cls.Encoder(
                coder_env, w, lzss_common.literal_feed(text, factors)
            )
            lzss_common.encode_text(enc, w, text, factors)
            enc.finalize()
            out.write(w.getvalue())

    def decompress(self, inp: Input, out: Output) -> None:
        coder_cls, coder_env = self.env.algorithm_for_option("coder")
        r = BitReader(inp.as_bytes())
        dec = coder_cls.Decoder(coder_env, r)
        dec_name = self.env.option("dec").as_algorithm().name
        try:
            scans = int(
                self.env.env_for_option("dec").option("scans").as_integer()
            )
        except KeyError:
            scans = 6

        # stream parse (lcpcomp/decode_text_internal, LCPCompressor.hpp:24-76)
        n = dec.decode(len_r)
        if getattr(getattr(dec, "r", None), "overran", False):
            raise ValueError("truncated lcpcomp stream: header cut off")
        text_r = Range(n)
        flen_min = dec.decode(text_r)
        flen_max = dec.decode(text_r)
        flen_r = MinDistributedRange(flen_min, flen_max)
        fdist_max = dec.decode(text_r)
        fdist_r = Range(fdist_max)

        parsed = lzss_common.native_stream_parse(
            dec, n, flen_min, flen_max, fdist_max
        )
        if parsed is not None:
            buffer, cursor, tgt, srcs, lens = parsed
            tgt = np.ascontiguousarray(tgt)
            srcs = np.ascontiguousarray(srcs)
            lens = np.ascontiguousarray(lens)
        else:
            buffer = np.zeros(n, dtype=np.uint8)
            cursor = 0
            tgt_l, src_l, len_l = [], [], []
            while not dec.eof():
                num = dec.decode(fdist_r) if dec.decode(bit_r) else 0
                if num:
                    buffer[cursor : cursor + num] = dec.decode_array(
                        num, literal_r
                    )
                    cursor += num
                if not dec.eof():
                    src = dec.decode(text_r)
                    ln = dec.decode(flen_r)
                    tgt_l.append(cursor)
                    src_l.append(src)
                    len_l.append(ln)
                    cursor += ln
            tgt = np.array(tgt_l, np.uint32)
            srcs = np.array(src_l, np.uint32)
            lens = np.array(len_l, np.uint32)
        if cursor != n:
            # a valid stream covers exactly n positions (lzss shared
            # format); anything short is a truncated container
            raise ValueError(
                f"truncated lcpcomp stream: decoded {cursor} of {n}"
            )

        with StatPhase("Decode Factors"):
            from ..device import use_device

            lib = native.get_lib()
            if n and os.environ.get("TDC_DEVICE_LCPCOMP") == "1" and use_device(
                "TDC_DEVICE_LCPCOMP", min_n=1 << 22, n=n
            ):
                # device chain resolution: every decoder strategy yields
                # the same bytes (the dec axis is a pointer-machine
                # time/space trade); pointer doubling collapses all
                # reference chains in ceil(log2 n)+1 gather rounds.
                # Opt-in (TDC_DEVICE_LCPCOMP=1) until its GPU time is
                # measured against the native decoders.
                from ..ops.lcpcomp_jax import resolve_factors_device

                with StatPhase("device lcpcomp decode"):
                    buffer = resolve_factors_device(buffer, tgt, srcs, lens)
                undec = np.flatnonzero(buffer[:cursor] == 0)
                assert (
                    len(undec) == 0 or (len(undec) == 1 and undec[0] + 1 == n)
                ), "undecodable lcpcomp stream"
                out.write(buffer[:cursor])
                return
            if dec_name == "scan":
                if lib is not None:
                    rc = lib.tdc_lcpcomp_scan_decode(
                        buffer, n, tgt, srcs, lens, len(tgt), scans
                    )
                    assert rc == 0, "undecodable lcpcomp stream"
                else:
                    self._python_scan_decode(buffer, tgt, srcs, lens, scans)
            elif dec_name == "QueueListBuffer" and lib is not None:
                rc = lib.tdc_lcpcomp_queuelist_decode(
                    buffer, n, tgt, srcs, lens, len(tgt)
                )
                assert rc == 0, "undecodable lcpcomp stream"
            elif dec_name == "MultimapListBuffer" and lib is not None:
                lazy = int(
                    self.env.env_for_option("dec").option("lazy").as_integer()
                )
                rc = lib.tdc_lcpcomp_multimap_decode(
                    buffer, n, tgt, srcs, lens, len(tgt), lazy
                )
                assert rc == 0, "undecodable lcpcomp stream"
            else:  # compact (and python fallback for the eager variants)
                if lib is not None:
                    rc = lib.tdc_lcpcomp_compact_decode(
                        buffer, n, tgt, srcs, lens, len(tgt)
                    )
                    assert rc == 0, "undecodable lcpcomp stream"
                else:
                    self._python_compact_decode(buffer, tgt, srcs, lens)
        out.write(buffer[:cursor])

    @staticmethod
    def _python_compact_decode(buffer, tgt, srcs, lens):
        """CompactDec.hpp:39-117: fully eager forward buckets."""
        fwd: dict[int, list[int]] = {}

        def decode_literal_at(pos, c):
            stack = [pos]
            while stack:
                p = stack.pop()
                buffer[p] = c
                q = fwd.pop(p, None)
                if q:
                    stack.extend(q)

        for j in range(len(tgt)):
            for i in range(int(lens[j])):
                sp = int(srcs[j]) + i
                if buffer[sp]:
                    decode_literal_at(int(tgt[j]) + i, buffer[sp])
                else:
                    fwd.setdefault(sp, []).append(int(tgt[j]) + i)

    @staticmethod
    def _python_scan_decode(buffer, tgt0, src0, len0, scans):
        tgt, srcs, lens = [], [], []
        for j in range(len(tgt0)):
            stored = False
            for i in range(int(len0[j])):
                sp = int(src0[j]) + i
                if buffer[sp]:
                    buffer[int(tgt0[j]) + i] = buffer[sp]
                elif not stored:
                    stored = True
                    tgt.append(int(tgt0[j]) + i)
                    srcs.append(sp)
                    lens.append(int(len0[j]) - i)
        for _ in range(scans):
            for j in range(len(tgt)):
                for i in range(lens[j]):
                    buffer[tgt[j] + i] = buffer[srcs[j] + i]
        n = len(buffer)
        rank = np.full(n, -1, np.int64)
        e = 0
        for i in range(n):
            if not buffer[i]:
                rank[i] = e
                e += 1
        fwd: list[list[int]] = [[] for _ in range(e)]

        def decode_literal_at(pos, c):
            stack = [pos]
            while stack:
                p = stack.pop()
                buffer[p] = c
                r = rank[p]
                if r >= 0 and fwd[r]:
                    stack.extend(fwd[r])
                    fwd[r] = []

        for j in range(len(tgt)):
            for i in range(lens[j]):
                sp = srcs[j] + i
                if buffer[sp]:
                    decode_literal_at(tgt[j] + i, buffer[sp])
                else:
                    fwd[rank[sp]].append(tgt[j] + i)


def register(registry):
    registry.register(LCPCompressor)
    for s in COMP_STRATEGIES + DEC_STRATEGIES:
        registry.register(s)
