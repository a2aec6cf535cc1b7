"""Device (JAX) op tests: bitpack, device Huffman, block-parallel runtime.

These run on the virtual 8-device CPU mesh (tests/conftest.py). The key
property is byte-equality between the device pipeline and the host coder
path for identical inputs.
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tudocomp_tpu.driver import compress, decompress  # noqa: E402
from tudocomp_tpu.io.bitio import BitWriter  # noqa: E402
from tudocomp_tpu.ops.bitpack import finalize_stream, pack_tokens  # noqa: E402
from tudocomp_tpu.ops.huffman_jax import encode_blocks  # noqa: E402


def ref_pack(values, nbits):
    w = BitWriter()
    w.write_ints(np.asarray(values, np.uint64), np.asarray(nbits, np.int64))
    return w.getvalue()


class TestDeviceBitpack:
    def test_simple(self):
        values = [0b101, 0b1, 0xFFFF, 0, 7]
        nbits = [3, 1, 16, 5, 3]
        words, total = pack_tokens(
            jnp.asarray(values, jnp.uint32), jnp.asarray(nbits, jnp.int32), 4
        )
        assert int(total) == sum(nbits)
        assert finalize_stream(np.asarray(words), int(total)) == ref_pack(
            values, nbits
        )

    def test_random_streams(self):
        rng = np.random.default_rng(0)
        for trial in range(10):
            n = int(rng.integers(1, 2000))
            nbits = rng.integers(0, 33, n)
            values = rng.integers(0, 1 << 32, n, dtype=np.uint64)
            masked = values & ((1 << nbits.astype(np.uint64)) - 1)
            n_words = (int(nbits.sum()) + 31) // 32 + 1
            words, total = pack_tokens(
                jnp.asarray(values.astype(np.uint32)),
                jnp.asarray(nbits, jnp.int32),
                n_words,
            )
            assert int(total) == nbits.sum()
            got = finalize_stream(np.asarray(words), int(total))
            want = ref_pack(masked, nbits)
            assert got == want, trial

    def test_zero_width_tokens_vanish(self):
        words, total = pack_tokens(
            jnp.asarray([5, 3, 7], jnp.uint32), jnp.asarray([3, 0, 3], jnp.int32), 2
        )
        assert int(total) == 6
        assert finalize_stream(np.asarray(words), 6) == ref_pack([5, 7], [3, 3])


def _device_encode(payloads: list[bytes], bs: int, **kw):
    n_words = (9 * bs + 4096 + 31) // 32
    B = len(payloads)
    blocks = np.zeros((B, bs), np.uint8)
    nv = np.zeros(B, np.int32)
    for i, c in enumerate(payloads):
        a = np.frombuffer(c, np.uint8)
        blocks[i, : len(a)] = a
        nv[i] = len(a)
    words, bits = encode_blocks(jnp.asarray(blocks), jnp.asarray(nv), n_words, **kw)
    return [
        finalize_stream(np.asarray(words)[i], int(np.asarray(bits)[i]))
        for i in range(B)
    ]


class TestDeviceHuffman:
    def test_matches_host_bytes(self):
        rng = np.random.default_rng(0)
        cases = [
            b"abracadabra banana mississippi " * 10,
            bytes(rng.integers(0, 256, 5000).astype(np.uint8)),
            bytes(rng.zipf(1.5, 3000).clip(0, 255).astype(np.uint8)),
            b"",
            b"x",
            b"x" * 500,
            b"ab",
            bytes(range(256)) * 4,
            "Unicode ไทย中文 русский".encode() * 7,
        ]
        streams = _device_encode(cases, 8192)
        for c, dev in zip(cases, streams):
            host = compress("encode(huff)", c, raw=True)
            assert dev == host, c[:40]

    def test_shared_table_roundtrips(self):
        rng = np.random.default_rng(1)
        cases = [
            bytes(rng.integers(97, 123, 2000).astype(np.uint8)) for _ in range(4)
        ]
        streams = _device_encode(cases, 4096, shared_table=True)
        for c, dev in zip(cases, streams):
            assert decompress(dev, id_string="encode(huff)", raw=True) == c


class TestParallelRuntime:
    def test_blockwise_roundtrip(self):
        from tudocomp_tpu.parallel.runtime import (
            blockwise_huffman_compress,
            blockwise_huffman_decompress,
        )

        rng = np.random.default_rng(2)
        data = bytes(rng.zipf(1.4, 100000).clip(0, 255).astype(np.uint8))
        for shared in (False, True):
            c = blockwise_huffman_compress(data, block_size=1 << 14, shared_table=shared)
            assert blockwise_huffman_decompress(c) == data
            assert len(c) < len(data)

    def test_blockwise_edges(self):
        from tudocomp_tpu.parallel.runtime import (
            blockwise_huffman_compress,
            blockwise_huffman_decompress,
        )

        for payload in (b"", b"x", b"ab" * 10):
            c = blockwise_huffman_compress(payload, block_size=1 << 14)
            assert blockwise_huffman_decompress(c) == payload

    def test_container_format(self):
        from tudocomp_tpu.parallel.blocks import (
            frame_streams,
            split_blocks,
            unframe_streams,
        )

        blocks, nv = split_blocks(b"abcdefghij", 4)
        assert blocks.shape == (3, 4)
        assert list(nv) == [4, 4, 2]
        cont = frame_streams([b"xx", b"", b"abc"], 4)
        bs, payloads = unframe_streams(cont)
        assert bs == 4
        assert payloads == [b"xx", b"", b"abc"]

    def test_graft_entry(self):
        import __graft_entry__ as ge

        fn, args = ge.entry()
        jax.jit(fn).lower(*args)  # compiles
        ge.dryrun_multichip(4)


class TestDeviceTransforms:
    def test_mtf_device_matches_host(self):
        from tudocomp_tpu.compressors.simple import mtf_encode
        from tudocomp_tpu.ops.transforms import mtf_encode_device

        rng = np.random.default_rng(0)
        for sigma in (2, 26, 256):
            data = rng.integers(0, sigma, 8192).astype(np.uint8)
            dev = np.asarray(mtf_encode_device(jnp.asarray(data)))
            assert (dev == mtf_encode(data)).all()

    def test_rle_runs_device(self):
        from tudocomp_tpu.ops.transforms import rle_runs_device

        rng = np.random.default_rng(1)
        for _ in range(5):
            data = rng.integers(0, 4, int(rng.integers(1, 2000))).astype(np.uint8)
            ch, ln, nr = rle_runs_device(jnp.asarray(data))
            nr = int(nr)
            assert (
                np.repeat(np.asarray(ch)[:nr], np.asarray(ln)[:nr]) == data
            ).all()


def _device_decode(payloads, block_size):
    """Per-payload decode through the device kernel (interpret mode)."""
    from tudocomp_tpu.ops.huffman_decode_pallas import decode_container
    from tudocomp_tpu.parallel.blocks import frame_streams

    out = []
    for p in payloads:  # one container per payload: keeps lengths apart
        out.append(decode_container(frame_streams([p], block_size), interpret=True))
    return out


class TestDeviceHuffmanDecode:
    """Device-side decode: one lane per block (ops/huffman_decode_pallas)."""

    def test_matches_host_roundtrip(self):
        rng = np.random.default_rng(7)
        cases = [
            b"abracadabra banana mississippi " * 10,
            bytes(rng.integers(0, 256, 5000).astype(np.uint8)),
            bytes(rng.zipf(1.5, 3000).clip(0, 255).astype(np.uint8)),
            b"",
            b"x",  # degenerate sigma=1 -> flag-0 raw literals
            b"x" * 500,
            b"ab",
            bytes(range(256)) * 4,
            "Unicode ไทย中文 русский".encode() * 7,
        ]
        payloads = [compress("encode(huff)", c, raw=True) for c in cases]
        outs = _device_decode(payloads, 8192)
        for c, o in zip(cases, outs):
            assert o == c, c[:40]

    def test_blockwise_container_device_decode(self):
        from tudocomp_tpu.parallel.runtime import (
            blockwise_huffman_compress,
            blockwise_huffman_decompress,
        )
        from tudocomp_tpu.ops.huffman_decode_pallas import decode_container

        rng = np.random.default_rng(8)
        data = bytes(rng.zipf(1.4, 12000).clip(0, 255).astype(np.uint8))
        for shared in (False, True):
            c = blockwise_huffman_compress(data, block_size=1 << 12, shared_table=shared)
            assert decode_container(c, interpret=True) == data
            assert blockwise_huffman_decompress(c) == data

    def test_skewed_deep_codes(self):
        # exponential-ish histogram drives long codewords
        parts = [bytes([i]) * (1 << min(i, 14)) for i in range(20)]
        data = b"".join(parts)
        payload = compress("encode(huff)", data, raw=True)
        (out,) = _device_decode([payload], len(data) + 1)
        assert out == data


class TestBitserialDecode:
    def test_payload_parity_including_degenerates(self):
        rng = np.random.default_rng(5)
        cases = [
            b"bit serial lockstep decode " * 30,
            bytes(rng.integers(0, 256, 2000).astype(np.uint8)),
            b"",
            b"q",
            b"zzzzzzzzzzzz",  # degenerate single-symbol alphabet
            bytes(rng.choice(np.frombuffer(b"AC", np.uint8), 3000).tobytes()),
        ]
        payloads = [compress("encode(huff)", c, raw=True) for c in cases]
        outs = _device_decode(payloads, 4096)
        for c, o in zip(cases, outs):
            assert o == c, c[:40]
