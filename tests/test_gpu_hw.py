"""GPU tests: the device paths compiled for the card, never interpreted.

Marked `gpu`; they skip (in the gpu_device fixture) when JAX's backend is
not a GPU. Run them on the card with `python -m pytest tests/ -m gpu`.
"""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def test_huffman_encode_blocks_on_gpu(gpu_device):
    """Device Huffman encode on the card is byte-identical to the host coder."""
    import jax
    import jax.numpy as jnp

    from tudocomp_tpu.io.inout import Input, Output
    from tudocomp_tpu.ops.bitpack import finalize_stream
    from tudocomp_tpu.ops.huffman_jax import encode_blocks
    from tudocomp_tpu.registry import create_algo

    rng = np.random.default_rng(1)
    bs = 4096
    payload = rng.zipf(1.3, 3 * bs).clip(0, 255).astype(np.uint8)
    payload[2 * bs :] = 42  # a degenerate block
    blocks = jnp.asarray(payload.reshape(3, bs))
    n_valid = jnp.full((3,), bs, jnp.int32)
    n_words = (9 * bs + 4096 + 31) // 32
    words, bits = jax.block_until_ready(encode_blocks(blocks, n_valid, n_words))
    words, bits = np.asarray(words), np.asarray(bits)
    for i in range(3):
        comp = create_algo("encode(huff)")
        o = Output()
        comp.compress(Input(payload.reshape(3, bs)[i]), o)
        assert finalize_stream(words[i], int(bits[i])) == bytes(o.raw_value()), i


@pytest.mark.parametrize("bs", [1 << 12, 1 << 14])
def test_decode_kernel_on_gpu(gpu_device, bs):
    """The compiled decode kernel reproduces the input, degenerate blocks
    and a ragged last block included."""
    from tudocomp_tpu.ops.huffman_decode_pallas import decode_container
    from tudocomp_tpu.parallel.runtime import blockwise_huffman_compress

    rng = np.random.default_rng(2)
    data = rng.zipf(1.3, 40 * bs + 123).clip(0, 255).astype(np.uint8)
    data[bs : 2 * bs] = 7
    data = data.tobytes()
    c = blockwise_huffman_compress(data, block_size=bs)
    assert decode_container(c) == data


def test_blockwise_roundtrip_on_gpu(gpu_device):
    """driver.compress/decompress of blockwise(encode(huff)) runs both
    device stages on the card."""
    from tudocomp_tpu.driver import compress, decompress
    from tudocomp_tpu.stats.phase import StatPhase

    rng = np.random.default_rng(3)
    data = rng.zipf(1.4, 300000).clip(0, 255).astype(np.uint8).tobytes()
    with StatPhase("root") as root:
        c = compress("blockwise(encode(huff), bs=16384)", data)
        assert decompress(c) == data
    titles = [p.title for p in root.children]
    assert "device blockwise encode" in str(root.to_dict())
    assert "device blockwise decode" in str(root.to_dict()), titles
