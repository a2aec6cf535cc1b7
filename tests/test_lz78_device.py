"""Blockwise LZ78/LZW: per-block host parse, framed container, roundtrip.

The container must equal the per-block driver.compress(raw=True) payloads
framed in block order, across block sizes from tiny to the 8 KiB class.
"""

import numpy as np
import pytest

from tudocomp_tpu.driver import compress, decompress
from tudocomp_tpu.parallel.blocks import frame_streams


def _corpus(bs):
    rng = np.random.default_rng(1)
    blocks = np.zeros((6, bs), np.uint8)
    blocks[0] = rng.integers(0, 256, bs)
    blocks[1] = rng.integers(97, 100, bs)  # tiny alphabet -> deep trie
    blocks[2] = 65  # single run
    pat = (b"abracadabra " * (bs // 12 + 1))[:bs]
    blocks[3] = np.frombuffer(pat, np.uint8)
    blocks[4, : bs // 2] = rng.integers(0, 4, bs // 2)
    n_valid = np.array([bs, bs, bs, bs, bs // 2, 0], np.int32)
    return b"".join(bytes(blocks[b, : n_valid[b]]) for b in range(len(blocks)))


@pytest.mark.parametrize("algo", ["lz78(coder=bit)", "lzw(coder=bit)"])
@pytest.mark.parametrize("bs", [128, 512, 8192])
def test_blockwise_roundtrip(algo, bs):
    data = _corpus(bs)
    c = compress(f"blockwise({algo}, bs={bs})", data)
    header = f"blockwise({algo}, bs={bs})%".encode()
    assert c.startswith(header)
    want = frame_streams(
        [
            compress(algo, data[i : i + bs], raw=True)
            for i in range(0, len(data), bs)
        ],
        bs,
    )
    assert c[len(header) :] == want
    assert decompress(c) == data


def test_blockwise_lz78_device_roundtrip():
    rng = np.random.default_rng(2)
    data = (b"the quick brown fox " * 200) + bytes(rng.integers(0, 256, 999))
    c = compress("blockwise(lz78(coder=bit), bs=1024)", data)
    assert decompress(c) == data


def test_blockwise_lzw_device_roundtrip():
    rng = np.random.default_rng(5)
    data = (b"wesawseashellsbytheseashore " * 150) + bytes(
        rng.integers(0, 256, 777)
    )
    c = compress("blockwise(lzw(coder=bit), bs=1024)", data)
    assert decompress(c) == data
