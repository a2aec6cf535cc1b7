"""The one-lane-per-block Huffman decode kernel, in interpret mode.

Covers what the kernel's wrapper decides (lane tables, padding to whole
programs, the output compaction) and the decode arithmetic at its limits:
several programs of LANES blocks, degenerate and single-symbol blocks,
block sizes that are not multiples of 4, and 31-bit codes.
"""

import numpy as np
import pytest

from tudocomp_tpu.coders.huffman import HuffmanTable, write_table
from tudocomp_tpu.driver import compress, decompress
from tudocomp_tpu.io.bitio import BitWriter
from tudocomp_tpu.ops import huffman_decode_pallas as hdp
from tudocomp_tpu.parallel.blocks import frame_offsets, frame_streams


def _container(blocks, bs):
    return frame_streams([compress("encode(huff)", b, raw=True) for b in blocks], bs)


def test_several_programs_with_padding_lanes():
    rng = np.random.default_rng(11)
    bs = 203  # not a multiple of 4: rows carry padding past the block
    data = bytes(rng.zipf(1.3, 70 * bs - 57).clip(0, 255).astype(np.uint8))
    blocks = [data[i : i + bs] for i in range(0, len(data), bs)]
    blocks[3] = b"\x07" * bs  # single-symbol block: flag-0 raw literals
    blocks[5] = bytes(rng.integers(0, 256, bs).astype(np.uint8))
    blocks[9] = b"ab" * (bs // 2) + b"a"
    c = _container(blocks, bs)
    assert len(blocks) > 2 * hdp.LANES
    assert hdp.decode_container(c, interpret=True) == b"".join(blocks)


def test_lane_tables_pad_to_whole_programs():
    blocks = [b"hello world", b"zzzz", b"", b"abcabcab"]
    c = _container(blocks, 16)
    _, offsets, lengths = frame_offsets(c)
    payloads = [c[o : o + n] for o, n in zip(offsets, lengths)]
    base, start, end, minlen, lj, adj, syms = hdp.lane_tables(payloads, offsets)
    assert len(base) == hdp.LANES and lj.shape == (hdp.LANES, 32)
    assert (end[len(blocks) :] == 0).all()  # padding lanes decode nothing
    assert minlen[1] == 8 and (syms[1] == np.arange(256)).all()  # degenerate
    assert (base[: len(blocks)] == np.asarray(offsets) >> 2).all()
    assert (start[: len(blocks)] >= 8 * (np.asarray(offsets) & 3)).all()


def _deep_code_payload(message):
    """encode(huff) payload over a 32-symbol code with lengths 1..30, 31, 31
    (a complete code whose two longest words are 31 bits)."""
    ordered_lengths = np.array(list(range(1, 31)) + [31, 31], np.uint8)
    numl = np.array([1] * 30 + [2], np.int64)
    alphabet = np.arange(100, 132, dtype=np.uint8)
    t = HuffmanTable(alphabet, ordered_lengths, numl, 31)
    code = dict(zip(alphabet.tolist(), zip(t.codewords.tolist(), ordered_lengths.tolist())))
    w = BitWriter()
    w.write_bit(1)
    write_table(w, t)
    for s in message:
        cw, ln = code[s]
        w.write_int(int(cw), int(ln))
    return w.getvalue()


def test_31_bit_codes():
    rng = np.random.default_rng(3)
    message = bytes(rng.integers(100, 132, 400).astype(np.uint8)) + bytes([130, 131] * 20)
    payload = _deep_code_payload(message)
    assert decompress(payload, id_string="encode(huff)", raw=True) == message
    c = frame_streams([payload, payload], len(message))
    assert hdp.decode_container(c, interpret=True) == message * 2


def test_block_longer_than_block_size_raises():
    # a 64-byte block's payload in a container that claims 16-byte blocks
    bad = frame_streams([compress("encode(huff)", b"abcdefgh" * 8, raw=True)], 16)
    with pytest.raises(ValueError):
        hdp.decode_container(bad, interpret=True)


def test_blockwise_decode_picks_device_kernel(monkeypatch):
    calls = []
    real = hdp.decode_container

    def fake(container):
        calls.append(len(container))
        return real(container, interpret=True)

    monkeypatch.setattr(hdp, "decode_container", fake)
    data = b"mississippi river banks " * 40
    c = compress("blockwise(encode(huff), bs=256)", data)
    assert decompress(c) == data
    assert calls == []  # CPU backend: the host decoder
    monkeypatch.setenv("TDC_DEVICE_HUFF", "1")
    assert decompress(c) == data
    assert len(calls) == 1
