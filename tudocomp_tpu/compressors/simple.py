"""Streaming transform compressors: noop, rle, mtf, encode.

Formats mirror the reference byte-for-byte:
  - NoopCompressor (compressors/NoopCompressor.hpp): copy-through.
  - RunLengthEncoder (compressors/RunLengthEncoder.hpp:16-50): each run of
    the same character of length >= 2 is emitted as the character twice
    followed by vbyte(run_length - 2 + offset).
  - MTFCompressor (compressors/MTFCompressor.hpp:17-68): move-to-front over
    a 256-entry table initialized to identity.
  - LiteralEncoder (compressors/LiteralEncoder.hpp:12-42): per-byte
    coder.encode(c, literal_r); decode until eof.

All are implemented vectorized (numpy) on the host with JAX device twins in
tudocomp_tpu.ops for the block-parallel runtime.
"""

from __future__ import annotations

import numpy as np

from ..base import Compressor
from ..io.bitio import BitReader, BitWriter
from ..io.inout import Input, Output
from ..io.vbyte import vbyte_decode_stream, vbyte_encode_array
from ..literals import ViewLiterals
from ..meta import Meta
from ..ranges import literal_r
from ..stats.phase import StatPhase


class NoopCompressor(Compressor):
    @classmethod
    def meta(cls) -> Meta:
        m = Meta("compressor", "noop")
        m.option("mode").dynamic("stream")
        m.option("debug").dynamic(False)
        return m

    def compress(self, inp: Input, out: Output) -> None:
        out.write(inp.as_array())

    def decompress(self, inp: Input, out: Output) -> None:
        out.write(inp.as_array())


def rle_encode(data: np.ndarray, offset: int = 0) -> np.ndarray:
    """Vectorized RLE matching rle_encode (RunLengthEncoder.hpp:16-32).

    The run decomposition runs on device on an accelerator from 16 MiB
    (ops/transforms.rle_runs_device; the gate's GPU crossover is not
    measured yet); vbyte serialization stays host-side.
    """
    n = len(data)
    if n == 0:
        return data
    from ..device import use_device

    if use_device("TDC_DEVICE_RLE", min_n=1 << 24, n=n):
        import jax.numpy as jnp

        from ..ops.transforms import rle_runs_device

        with StatPhase("device RLE"):
            dchars, dlens, n_runs = rle_runs_device(jnp.asarray(data))
            n_runs = int(n_runs)
            chars = np.asarray(dchars)[:n_runs]
            run_lens = np.asarray(dlens)[:n_runs].astype(np.int64)
        run_starts = np.cumsum(run_lens) - run_lens
    else:
        change = np.empty(n, dtype=bool)
        change[0] = True
        np.not_equal(data[1:], data[:-1], out=change[1:])
        run_starts = np.flatnonzero(change)
        run_lens = np.diff(np.append(run_starts, n))
        chars = data[run_starts]
    # runs of length 1 -> char; runs >= 2 -> char char vbyte(len-2+offset)
    is_run = run_lens >= 2
    vbytes = vbyte_encode_array(run_lens[is_run] - 2 + offset)
    # assemble: per run, 1 or 2 chars + optional vbyte
    out_lens = np.where(is_run, 2, 1).astype(np.int64)
    vb_lens = np.zeros(len(run_starts), dtype=np.int64)
    vb_lens[is_run] = vbytes.lengths
    total = int(out_lens.sum() + vb_lens.sum())
    out = np.empty(total, dtype=np.uint8)
    piece_lens = out_lens + vb_lens
    starts = np.cumsum(piece_lens) - piece_lens
    out[starts] = chars
    second = starts[is_run] + 1
    out[second] = chars[is_run]
    # scatter vbyte payloads
    vb_starts_out = starts[is_run] + 2
    if len(vb_starts_out):
        idx = np.repeat(vb_starts_out, vbytes.lengths) + vbytes.intra_offsets
        out[idx] = vbytes.bytes
    return out


def rle_decode(data: np.ndarray, offset: int = 0) -> np.ndarray:
    """Vectorized RLE decode matching rle_decode (RunLengthEncoder.hpp:37-50)."""
    n = len(data)
    if n == 0:
        return data
    from .. import native

    lib = native.get_lib()
    if lib is not None:
        data_c = np.ascontiguousarray(data, np.uint8)
        cap = max(64, 4 * n)
        while True:
            out = np.empty(cap, np.uint8)
            got = lib.tdc_rle_decode(data_c, n, offset, out, cap)
            if got >= 0:
                return out[:got]
            cap *= 4
    # Parse sequentially-structured stream vectorized: a double character
    # marks a run header followed by a vbyte. We walk the stream in passes:
    # find all positions where data[i] == data[i-1] — but only those not
    # inside a vbyte payload and not the second char of a previous pair.
    # Since vbyte payloads can contain arbitrary bytes, do a scan in chunks
    # using python over run headers only (count of headers ~ number of runs).
    out_parts = []
    # all adjacent-equal positions once; walk with binary search (skipping
    # pairs inside vbyte payloads by advancing i past them)
    pairs = np.flatnonzero(data[:-1] == data[1:])
    i = 0
    while i < n:
        k = int(np.searchsorted(pairs, i))
        if k == len(pairs):
            out_parts.append(data[i:])
            break
        j = int(pairs[k])  # data[j] == data[j+1]
        out_parts.append(data[i : j + 2])
        c = data[j]
        # vbyte follows at j+2
        run, consumed = vbyte_decode_stream(data, j + 2)
        run -= offset
        if run > 0:
            out_parts.append(np.full(run, c, dtype=np.uint8))
        i = j + 2 + consumed
    return np.concatenate(out_parts) if out_parts else np.zeros(0, np.uint8)


class RunLengthEncoder(Compressor):
    @classmethod
    def meta(cls) -> Meta:
        m = Meta("compressor", "rle", "Run Length Encoding Compressor")
        m.option("offset").dynamic(0)
        return m

    def __init__(self, env):
        super().__init__(env)
        self.offset = env.option("offset").as_integer()

    def compress(self, inp: Input, out: Output) -> None:
        with StatPhase("rle_encode"):
            out.write(rle_encode(inp.as_array(), self.offset))

    def decompress(self, inp: Input, out: Output) -> None:
        out.write(rle_decode(inp.as_array(), self.offset))


def mtf_encode(data: np.ndarray) -> np.ndarray:
    """MTF encode: native table simulation (tdc_mtf_encode); numpy-chunked
    fallback; see tudocomp_tpu.ops.mtf for the O(n*sigma) data-parallel
    device formulation (rank = #distinct chars since previous occurrence)."""
    from .. import native
    from ..device import use_device

    data = np.ascontiguousarray(data, np.uint8)
    n = len(data)
    if use_device("TDC_DEVICE_MTF", min_n=1 << 22, n=n):
        import jax.numpy as jnp

        from ..ops.transforms import mtf_encode_device

        chunk = 4096
        pad = (-n) % chunk
        padded = np.pad(data, (0, pad)) if pad else data
        with StatPhase("device MTF"):
            out = np.asarray(mtf_encode_device(jnp.asarray(padded), chunk))
        return out[:n]
    lib = native.get_lib()
    if lib is not None and n:
        out = np.empty(n, np.uint8)
        lib.tdc_mtf_encode(data, n, out)
        return out
    from ..ops.mtf import mtf_encode_host

    return mtf_encode_host(data)


def mtf_decode(data: np.ndarray) -> np.ndarray:
    from .. import native

    data = np.ascontiguousarray(data, np.uint8)
    lib = native.get_lib()
    if lib is not None and len(data):
        out = np.empty(len(data), np.uint8)
        lib.tdc_mtf_decode(data, len(data), out)
        return out
    from ..ops.mtf import mtf_decode_host

    return mtf_decode_host(data)


class MTFCompressor(Compressor):
    @classmethod
    def meta(cls) -> Meta:
        return Meta("compressor", "mtf", "Move To Front Compressor")

    def compress(self, inp: Input, out: Output) -> None:
        with StatPhase("mtf_encode"):
            out.write(mtf_encode(inp.as_array()))

    def decompress(self, inp: Input, out: Output) -> None:
        out.write(mtf_decode(inp.as_array()))


class LiteralEncoder(Compressor):
    @classmethod
    def meta(cls) -> Meta:
        m = Meta(
            "compressor", "encode", "Simply encodes the input's individual characters."
        )
        m.option("coder").templated("coder", None)
        return m

    def compress(self, inp: Input, out: Output) -> None:
        data = inp.as_array()
        coder_cls, coder_env = self.env.algorithm_for_option("coder")
        w = BitWriter()
        enc = coder_cls.Encoder(coder_env, w, ViewLiterals(data))
        with StatPhase("encode"):
            enc.encode_array(data, literal_r)
            enc.finalize()
        out.write(w.getvalue())

    def decompress(self, inp: Input, out: Output) -> None:
        coder_cls, coder_env = self.env.algorithm_for_option("coder")
        r = BitReader(inp.as_bytes())
        dec = coder_cls.Decoder(coder_env, r)
        if hasattr(dec, "decode_literals_until_eof"):
            out.write(dec.decode_literals_until_eof())
            return
        width = dec.literal_fixed_width()
        if width:
            count = max(0, (r._valid - r.pos)) // width
            out.write(dec.decode_array(count, literal_r).astype(np.uint8))
            return
        chunks = []
        while not dec.eof():
            chunks.append(dec.decode(literal_r) & 0xFF)
        out.write(np.array(chunks, dtype=np.uint8))
