"""Device canonical-Huffman decode of a blockwise container (Pallas/Triton).

Entropy decode is sequential within a stream, so the parallel axis is the
BLOCK: one GPU thread ("lane") decodes one block payload from start to end.
Every lane walks its own bit position through the container, so each step
is a handful of per-lane gathers (the 32-bit peek window and the lane's
canonical tables), which the GPU serves from L1/L2.

Per symbol, per lane (the first-match rule of coders/huffman.py:246-254 /
HuffmanCoder.hpp:584-613, restated on a 32-bit left-justified peek):

    l    = min{ l >= minlen : peek >= lj[l] }    5-step binary search
    rank = (peek >> (32 - l)) + adj[l]           u32 wraparound
    sym  = syms[rank]

lj[l] = firstcode[l] << (32 - l) is non-increasing in l for a complete
prefix code (every Huffman code is), so the predicate is monotone and a
binary search finds the first match. adj[l] = psl[l] - firstcode[l].
Degenerate (flag-0) blocks are raw 8-bit literals: minlen = 8, lj = 0,
identity symbol map.

Four symbols fold into one u32 output word per lane and step; the output
is laid out [step, lane] so a warp's stores are contiguous. The kernel
writes the decoded bytes directly: no token stream, no second pack pass.

The per-block table headers (a few hundred bits each) are parsed on the
host; the container's bytes go to the device once, as big-endian words.
Code lengths <= 32 are required: blocks <= 2 MiB guarantee <= 31 for any
Huffman code (ops/huffman_jax.py MAX_BLOCK, the Fibonacci bound).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..io.bitio import BitReader, valid_bit_count

__all__ = ["container_lanes", "decode_container", "decode_lanes", "lane_tables"]

LANES = 32  # lanes (blocks) per program: one warp
_HDR_BYTES = 512  # a serialized table is at most ~390 bytes


def _parse_header(payload: bytes, byte_off: int):
    """One payload's table -> (start, end, minlen, lj[32], adj[32], syms[256]).

    start/end are bit positions relative to the payload's enclosing word
    (byte_off & 3 bytes of lead-in)."""
    from ..coders.huffman import gen_first_codes

    r = BitReader(payload[:_HDR_BYTES])
    lj = np.zeros(32, np.uint32)
    adj = np.zeros(32, np.uint32)
    if r.read_bit():
        longest = r.read_compressed_int()
        if longest > 32:
            raise ValueError("device decode supports code lengths <= 32")
        numl = np.array([r.read_compressed_int() for _ in range(longest)], np.int64)
        sigma = r.read_compressed_int()
        syms = np.zeros(256, np.uint8)
        syms[:sigma] = r.read_ints(sigma, 8).astype(np.uint8)
        fc = gen_first_codes(numl, longest).astype(np.int64)
        psl = np.concatenate([[0], np.cumsum(numl)[:-1]])
        ls = np.arange(1, longest + 1, dtype=np.int64)
        lj[:longest] = (fc << (32 - ls)).astype(np.uint32)
        adj[:longest] = ((psl - fc) & 0xFFFFFFFF).astype(np.uint32)
        minlen = int(np.flatnonzero(numl)[0]) + 1
    else:
        syms = np.arange(256, dtype=np.uint8)
        minlen = 8
    lead = 8 * (byte_off & 3)
    return lead + r.pos, lead + valid_bit_count(payload), minlen, lj, adj, syms


def lane_tables(payloads, offsets):
    """Per-lane decode tables for payloads at the given container offsets,
    padded to a multiple of LANES (padding lanes decode nothing)."""
    n = len(payloads)
    n_pad = max(LANES, -(-n // LANES) * LANES)
    base = np.zeros(n_pad, np.int32)
    start = np.zeros(n_pad, np.int32)
    end = np.zeros(n_pad, np.int32)
    minlen = np.full(n_pad, 32, np.int32)
    lj = np.zeros((n_pad, 32), np.uint32)
    adj = np.zeros((n_pad, 32), np.uint32)
    syms = np.zeros((n_pad, 256), np.uint8)
    for i, (p, off) in enumerate(zip(payloads, offsets)):
        base[i] = off >> 2
        start[i], end[i], minlen[i], lj[i], adj[i], syms[i] = _parse_header(p, off)
    return base, start, end, minlen, lj, adj, syms


def _decode_kernel(
    words_ref, base_ref, start_ref, end_ref, minlen_ref, lj_ref, adj_ref,
    syms_ref, out_ref, cnt_ref, pos_ref, *, n_words, n_steps
):
    lane = pl.program_id(0) * LANES + jax.lax.iota(jnp.int32, LANES)
    base = base_ref[...]
    end = end_ref[...]
    minlen = minlen_ref[...]
    row32 = lane * 32
    row256 = lane * 256
    last_word = jnp.int32(n_words - 2)

    def symbol(pos):
        live = pos < end
        wi = jnp.minimum(base + (pos >> 5), last_word)
        sh = (pos & 31).astype(jnp.uint32)
        hi = words_ref[wi]
        lo = words_ref[wi + 1]
        peek = (hi << sh) | jnp.where(
            sh == 0, jnp.uint32(0), lo >> ((jnp.uint32(32) - sh) & 31)
        )
        # bits past the stream's end read as 0 (BitIStream.hpp:107)
        rem = end - pos
        peek = jnp.where(
            rem < 32,
            peek & ~(jnp.uint32(0xFFFFFFFF) >> jnp.clip(rem, 0, 31).astype(jnp.uint32)),
            peek,
        )
        lo_l = minlen
        hi_l = jnp.full_like(minlen, 32)
        for _ in range(5):
            mid = (lo_l + hi_l) >> 1
            ok = peek >= lj_ref[row32 + mid - 1]
            hi_l = jnp.where(ok, mid, hi_l)
            lo_l = jnp.where(ok, lo_l, mid + 1)
        ln = lo_l
        v = peek >> (32 - ln).astype(jnp.uint32)
        rank = jnp.minimum(v + adj_ref[row32 + ln - 1], jnp.uint32(255))
        sym = syms_ref[row256 + rank.astype(jnp.int32)].astype(jnp.uint32)
        return live, sym, jnp.where(live, pos + ln, pos)

    def body(j, carry):
        pos, cnt = carry
        word = jnp.zeros((LANES,), jnp.uint32)
        for k in range(4):
            live, sym, pos = symbol(pos)
            word = word | jnp.where(live, sym << (8 * k), jnp.uint32(0))
            cnt = cnt + live.astype(jnp.int32)
        out_ref[j, :] = word
        return pos, cnt

    pos, cnt = jax.lax.fori_loop(
        0, n_steps, body, (start_ref[...], jnp.zeros((LANES,), jnp.int32))
    )
    cnt_ref[...] = cnt
    pos_ref[...] = pos


def _bswap32(w):
    return (
        (w << 24)
        | ((w & 0xFF00) << 8)
        | ((w >> 8) & 0xFF00)
        | (w >> 24)
    )


@partial(jax.jit, static_argnames=("n_steps", "interpret"))
def decode_lanes(words, base, start, end, minlen, lj, adj, syms, *, n_steps, interpret=False):
    """Decode every lane's stream -> ([n_lanes, 4*n_steps] u8 symbols,
    [n_lanes] i32 symbol counts, [n_lanes] i32 final bit positions).

    words is the container's bytes viewed as native (little-endian) u32;
    the byte swap to the MSB-first bit order runs here, on the device.
    Tables come from lane_tables; n_steps*4 bounds the symbols per lane."""
    words = _bswap32(words)
    n_lanes = base.shape[0]
    n_words = words.shape[0]
    lane_spec = pl.BlockSpec((LANES,), lambda i: (i,))
    whole = pl.no_block_spec  # gathered by per-lane index
    out, cnt, pos = pl.pallas_call(
        partial(_decode_kernel, n_words=n_words, n_steps=n_steps),
        grid=(n_lanes // LANES,),
        in_specs=[whole, lane_spec, lane_spec, lane_spec, lane_spec, whole, whole, whole],
        out_specs=(
            pl.BlockSpec((n_steps, LANES), lambda i: (0, i)),
            lane_spec,
            lane_spec,
        ),
        out_shape=(
            jax.ShapeDtypeStruct((n_steps, n_lanes), jnp.uint32),
            jax.ShapeDtypeStruct((n_lanes,), jnp.int32),
            jax.ShapeDtypeStruct((n_lanes,), jnp.int32),
        ),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name="huffman_decode_lanes",
    )(words, base, start, end, minlen, lj.reshape(-1), adj.reshape(-1), syms.reshape(-1))
    out = jax.lax.bitcast_convert_type(out.T, jnp.uint8).reshape(n_lanes, 4 * n_steps)
    return out, cnt, pos


def container_lanes(data: bytes):
    """Host half of the decode: a TBK1 container -> (block_size, n_blocks,
    decode_lanes arguments): the container as two-word-padded u32 words,
    then the lane tables."""
    from ..parallel.blocks import frame_offsets

    block_size, offsets, lengths = frame_offsets(data)
    mv = memoryview(data)
    tables = lane_tables([mv[o : o + ln] for o, ln in zip(offsets, lengths)], offsets)
    buf = np.zeros(-(-len(data) // 4) + 2, np.uint32)
    buf.view(np.uint8)[: len(data)] = np.frombuffer(data, np.uint8)
    return block_size, len(offsets), (buf, *tables)


def decode_container(data: bytes, interpret: bool = False) -> bytes:
    """Decode a blockwise(encode(huff)) TBK1 container on the device."""
    block_size, n, args = container_lanes(data)
    out, cnt, pos = decode_lanes(
        *args, n_steps=-(-block_size // 4), interpret=interpret
    )
    cnt = np.asarray(cnt)[:n]
    end = args[3]
    if (np.asarray(pos)[:n] < end[:n]).any():
        raise ValueError("a block decodes to more than the container's block size")
    out = np.asarray(out)[:n]
    width = out.shape[1]
    if n and (cnt[:-1] == width).all():
        return out.reshape(-1)[: (n - 1) * width + int(cnt[-1])].tobytes()
    return out[np.arange(width)[None, :] < cnt[:, None]].tobytes()
