"""Device lcpcomp: plcppeaks orbit-doubling parity + chain-resolve decode.

The PQ strategies stay host-side (their per-pick LCP
mutation is inherently sequential), but plcppeaks is bit-identical on
device and the decode phase resolves chains with pointer doubling for
every dec strategy.
"""

import os

import numpy as np
import pytest

from tests.util import CORPUS
from tudocomp_tpu.compressors.lcpcomp import plcppeaks_factorize
from tudocomp_tpu.ds.textds import TextDS
from tudocomp_tpu.ops.lcpcomp_jax import (
    plcppeaks_factorize_device,
    resolve_factors_device,
)


def _ds(text: bytes):
    t = np.frombuffer(text + b"\0", np.uint8)
    ds = TextDS(t)
    ds.require_sa()
    ds.require_isa()
    ds.require_plcp()
    return ds


@pytest.mark.parametrize("threshold", [1, 5])
def test_plcppeaks_device_parity(threshold):
    texts = [t for t in CORPUS if 0 < len(t) < 4000][:12]
    texts += [b"abcabcabcabcabc" * 20, bytes(np.random.default_rng(0).integers(0, 4, 3000).astype(np.uint8))]
    for text in texts:
        if b"\0" in text:
            continue
        ds = _ds(text)
        want = plcppeaks_factorize(ds.sa(), ds.isa(), ds.plcp(), threshold)
        pos, src, ln = plcppeaks_factorize_device(
            ds.sa(), ds.isa(), ds.plcp(), threshold
        )
        np.testing.assert_array_equal(pos, np.asarray(want.pos, np.int64))
        np.testing.assert_array_equal(src, np.asarray(want.src, np.int64))
        np.testing.assert_array_equal(ln, np.asarray(want.len, np.int64))


def test_resolve_factors_device_chains():
    # forward refs + overlapping self-referential copies
    n = 32
    buf = np.zeros(n, np.uint8)
    buf[0] = ord("a")
    buf[1] = ord("b")
    # factor 1: [2,6) <- [0,4): needs its own output (chain)
    # factor 2: [6,12) <- [8,14): forward reference into factor 3's range
    # factor 3: [12,20) <- [0,8)
    buf[20:31] = np.frombuffer(b"xyzxyzxyzxy", np.uint8)
    tgt = np.array([2, 6, 12], np.uint32)
    src = np.array([0, 8, 0], np.uint32)
    lens = np.array([4, 6, 8], np.uint32)
    out = resolve_factors_device(buf.copy(), tgt, src, lens)
    # host reference: iterate byte-wise until fixpoint
    ref = buf.copy()
    for _ in range(n):
        for j in range(3):
            for i in range(int(lens[j])):
                if ref[src[j] + i]:
                    ref[tgt[j] + i] = ref[src[j] + i]
    np.testing.assert_array_equal(out, ref)
    assert out[:31].all()


def test_lcpcomp_device_roundtrip():
    from tudocomp_tpu.driver import compress, decompress

    rng = np.random.default_rng(3)
    data = (b"tobeornottobe " * 2000) + bytes(rng.integers(1, 200, 5000).astype(np.uint8))
    os.environ["TDC_DEVICE_LCPCOMP"] = "1"
    try:
        c_dev = compress("lcpcomp(coder=huff, comp=plcppeaks)", data)
        assert decompress(c_dev) == data
    finally:
        del os.environ["TDC_DEVICE_LCPCOMP"]
    c_host = compress("lcpcomp(coder=huff, comp=plcppeaks)", data)
    assert c_dev == c_host
    # device decode of a host-compressed arrays-strategy stream
    c2 = compress("lcpcomp(coder=huff, comp=arrays)", data)
    os.environ["TDC_DEVICE_LCPCOMP"] = "1"
    try:
        assert decompress(c2) == data
    finally:
        del os.environ["TDC_DEVICE_LCPCOMP"]
