"""LZSS factorization via LCP (id "lzss_lcp").

Mirror of compressors/LZSSLCPCompressor.hpp:24-132: greedy left-to-right
factorization choosing, per text position, the longer of the PSV/NSV
matches in suffix-array order (ties prefer PSV); factors >= threshold
(default 3). The reference's naive per-position SA scans
(LZSSLCPCompressor.hpp:68-96) are replaced by O(n) monotone-stack ANSV
passes (native tdc_lzss_lcp_factorize; SURVEY.md §7 step 6). Encoding uses
the shared lzss stream format (lzss_common.py) with the factor-uncovered
literal feed, so entropy coders see exactly the reference's TextLiterals.
"""

from __future__ import annotations

import numpy as np

from ..base import Compressor
from ..ds import flags
from ..ds.textds import TextDS
from ..io.bitio import BitReader, BitWriter
from ..io.inout import Input, Output
from ..meta import Meta
from ..stats.phase import StatPhase
from .. import native
from . import lzss_common


def lcp_factorize(sa, isa, lcp, threshold: int) -> lzss_common.Factors:
    n = len(sa)
    from ..device import use_device

    import os

    if (
        n
        and os.environ.get("TDC_DEVICE_LZSS") == "1"
        and use_device("TDC_DEVICE_LZSS", n=n)
    ):
        # device factorization: parallel ANSV + orbit-doubling greedy parse
        # (ops/lzss_jax.py); bit-identical factors to the native path.
        # OPT-IN (TDC_DEVICE_LZSS=1) until its GPU time is measured against
        # the O(n) native ANSV pass.
        from ..ops.lzss_jax import lzss_lcp_factorize_device

        with StatPhase("device lzss factorize"):
            pos, src, ln = lzss_lcp_factorize_device(sa, isa, lcp, threshold)
        return lzss_common.Factors(pos, src, ln)
    lib = native.get_lib()
    if lib is not None and n:
        fpos = np.empty(n, np.uint32)
        fsrc = np.empty(n, np.uint32)
        flen = np.empty(n, np.uint32)
        nf = lib.tdc_lzss_lcp_factorize(
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
    # Python mirror of the reference's naive scans (small inputs / no g++)
    fpos_l, fsrc_l, flen_l = [], [], []
    i = 0
    while i + 1 < n:
        cur = isa[i]
        psv_lcp = int(lcp[cur])
        psv_pos = cur - 1
        if psv_lcp > 0:
            while psv_pos >= 0 and sa[psv_pos] > sa[cur]:
                psv_lcp = min(psv_lcp, int(lcp[psv_pos]))
                psv_pos -= 1
        nsv_lcp = 0
        nsv_pos = cur + 1
        if nsv_pos < n:
            nsv_lcp = 1 << 62
            while True:
                nsv_lcp = min(nsv_lcp, int(lcp[nsv_pos]))
                if sa[nsv_pos] < sa[cur]:
                    break
                nsv_pos += 1
                if nsv_pos >= n:
                    nsv_lcp = 0
                    break
        max_lcp = max(psv_lcp, nsv_lcp)
        if max_lcp >= threshold:
            max_pos = psv_pos if max_lcp == psv_lcp else nsv_pos
            fpos_l.append(i)
            fsrc_l.append(int(sa[max_pos]))
            flen_l.append(max_lcp)
            i += max_lcp
        else:
            i += 1
    return lzss_common.Factors(fpos_l, fsrc_l, flen_l)


class LZSSLCPCompressor(Compressor):
    @classmethod
    def meta(cls) -> Meta:
        m = Meta("compressor", "lzss_lcp", "LZSS Factorization using LCP")
        m.option("coder").templated("coder")
        m.option("threshold").dynamic(3)
        m.option("textds").templated("textds", "textds")
        m.uses_textds(flags.SA | flags.ISA | flags.LCP)
        return m

    def compress(self, inp: Input, out: Output) -> None:
        from ..ds.textds_algo import make_textds

        text = inp.as_array()
        with StatPhase("Construct Text DS"):
            ds = make_textds(self, text)
            sa = ds.require_sa()
            isa = ds.require_isa()
            lcp = ds.require_lcp()
        threshold = self.env.option("threshold").as_integer()
        with StatPhase("Factorize") as ph:
            factors = lcp_factorize(sa, isa, lcp, threshold)
            ph.log("threshold", threshold)
            ph.log("factors", len(factors))
        with StatPhase("Encode"):
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
        out.write(lzss_common.decode_text(dec))


def register(registry):
    registry.register(LZSSLCPCompressor)
