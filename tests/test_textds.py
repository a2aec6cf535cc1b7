"""SA/ISA/Phi/PLCP/LCP provider tests (mirror of test/ds_tests.cpp)."""

from __future__ import annotations

import numpy as np
import pytest

from tudocomp_tpu.ds.suffix_array import (
    inverse_permutation,
    lcp_from_plcp,
    naive_lcp,
    naive_suffix_array,
    phi_from_sa,
    plcp_from_phi_numpy,
    suffix_array_numpy,
)
from tudocomp_tpu.ds.textds import TextDS, bwt_from_sa, decode_bwt
from tudocomp_tpu import native

CASES = [
    b"\0",
    b"a\0",
    b"banana\0",
    b"abracadabra\0",
    b"mississippi\0",
    b"aaaaaaaaaa\0",
    b"abcabcabcabc\0",
    bytes(range(1, 256)) + b"\0",
]


def rand_cases():
    rng = np.random.default_rng(7)
    out = []
    for n in (10, 100, 1000, 5000):
        for sigma in (2, 4, 26, 255):
            a = rng.integers(1, 1 + sigma, n).astype(np.uint8)
            out.append(a.tobytes() + b"\0")
    return out


@pytest.mark.parametrize("case_set", ["fixed", "random"])
def test_sa_matches_naive(case_set):
    for text in CASES if case_set == "fixed" else rand_cases():
        arr = np.frombuffer(text, np.uint8)
        want = naive_suffix_array(text)
        got = suffix_array_numpy(arr)
        assert (got == want).all(), text[:40]


def test_native_sais_matches_naive():
    lib = native.get_lib()
    if lib is None:
        pytest.skip("native lib unavailable")
    for text in CASES + rand_cases():
        arr = np.frombuffer(text, np.uint8)
        sa = np.empty(len(arr), np.int32)
        assert lib.tdc_sais(arr, len(arr), sa) == 0
        want = naive_suffix_array(text)
        assert (sa == want).all(), text[:40]


def test_native_sais_no_sentinel():
    # works for texts NOT ending in a sentinel too (end-of-string semantics)
    lib = native.get_lib()
    if lib is None:
        pytest.skip("native lib unavailable")
    for text in (b"banana", b"aaa", b"ba", b"abab", bytes([255, 0, 255, 1])):
        arr = np.frombuffer(text, np.uint8)
        sa = np.empty(len(arr), np.int32)
        lib.tdc_sais(arr, len(arr), sa)
        assert (sa == naive_suffix_array(text)).all(), text


def test_lcp_phi_plcp():
    for text in CASES + rand_cases():
        arr = np.frombuffer(text, np.uint8)
        sa = suffix_array_numpy(arr)
        phi = phi_from_sa(sa)
        plcp = plcp_from_phi_numpy(arr, phi)
        lcp = lcp_from_plcp(plcp, sa)
        want = naive_lcp(text, sa)
        assert (lcp == want).all(), text[:40]
        isa = inverse_permutation(sa)
        assert (sa[isa] == np.arange(len(arr))).all()


def test_textds_facade():
    from tudocomp_tpu.ds import flags

    ds = TextDS(np.frombuffer(b"banana\0", np.uint8))
    ds.require(flags.SA | flags.ISA | flags.LCP | flags.PHI | flags.PLCP)
    assert (ds.sa() == naive_suffix_array(b"banana\0")).all()
    assert (ds.lcp() == naive_lcp(b"banana\0", ds.sa())).all()


def test_bwt_roundtrip_raw():
    for text in CASES + rand_cases():
        arr = np.frombuffer(text, np.uint8)
        sa = suffix_array_numpy(arr)
        bwt = bwt_from_sa(arr, sa)
        dec = decode_bwt(bwt)
        assert dec.tobytes() == text[:-1], text[:40]


def test_bwt_known_value():
    # classic example: BWT of "banana\0" (sentinel as 0)
    arr = np.frombuffer(b"banana\0", np.uint8)
    sa = suffix_array_numpy(arr)
    bwt = bwt_from_sa(arr, sa).tobytes()
    assert bwt == b"annb\0aa"


def test_bwt_compressor_roundtrip():
    from tests.util import CORPUS, roundtrip

    for text in CORPUS:
        roundtrip("bwt", text)
    # chained bzip-like pipeline
    roundtrip("bwt:rle:mtf:encode(huff)", b"how much wood would a woodchuck chuck" * 20)


def test_sa_jax_matches():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from tudocomp_tpu.ds.suffix_array import suffix_array_jax

    for text in CASES + rand_cases()[:6]:
        arr = np.frombuffer(text, np.uint8)
        got = np.asarray(suffix_array_jax(jnp.asarray(arr)))
        assert (got == naive_suffix_array(text)).all(), text[:40]


def test_sa_staged_device_matches():
    """suffix_array_device (staged Larsson-Sadakane, the device default) must
    match the naive SA on corner cases and randoms, return a consistent
    ISA, and survive the compact-stage cascade (sizes > 8192 engage it)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from tudocomp_tpu.ds.suffix_array import suffix_array_device

    for text in CASES + rand_cases()[:6]:
        arr = np.frombuffer(text, np.uint8)
        got = np.asarray(suffix_array_device(jnp.asarray(arr)))
        assert (got == naive_suffix_array(text)).all(), text[:40]

    rng = np.random.default_rng(3)
    big = rng.integers(97, 101, 40000).astype(np.uint8)
    big[-1] = 0
    sa, isa = suffix_array_device(jnp.asarray(big), return_isa=True)
    sa, isa = np.asarray(sa), np.asarray(isa)
    from tudocomp_tpu.ds.suffix_array import suffix_array_numpy

    assert (sa == suffix_array_numpy(big)).all()
    assert (isa[sa] == np.arange(len(big))).all()
    # repetitive input exercises deep doubling through every stage
    rep = np.tile(np.frombuffer(b"abcabd", np.uint8), 5000).copy()
    rep[-1] = 0
    assert (
        np.asarray(suffix_array_device(jnp.asarray(rep)))
        == suffix_array_numpy(rep)
    ).all()


def test_device_sa_flag(monkeypatch):
    """TDC_DEVICE_SA=1 routes SA construction through the JAX
    prefix-doubling path; result must equal the native SA-IS."""
    import numpy as np

    from tudocomp_tpu.ds.textds import TextDS

    rng = np.random.default_rng(11)
    text = np.concatenate(
        [rng.integers(97, 105, 500).astype(np.uint8), [0]]
    ).astype(np.uint8)
    base = TextDS(text).require_sa()
    monkeypatch.setenv("TDC_DEVICE_SA", "1")
    dev = TextDS(text).require_sa()
    assert (base == dev).all()


def test_compress_mode_packing():
    """CompressMode axis (ds/CompressMode.hpp, TextDS.hpp:247-292): the
    resident DS arrays are bit-packed to bits_for(n) in compressed/delayed
    modes, getters hand back full-width equivalents, and the compressed
    output stays byte-identical across every mode."""
    import numpy as np

    from tudocomp_tpu.driver import compress, decompress
    from tudocomp_tpu.ds.int_vector import IntVector
    from tudocomp_tpu.ds.textds import TextDS

    rng = np.random.default_rng(5)
    text = np.concatenate(
        [rng.integers(97, 105, 3000).astype(np.uint8), [0]]
    ).astype(np.uint8)

    base = TextDS(text)
    plain_sa = base.require_sa()
    plain_lcp = base.require_lcp()

    ds = TextDS(text, compress_mode="compressed")
    sa = ds.require_sa()
    assert (sa == plain_sa).all()
    assert isinstance(ds._sa, IntVector)  # resident form is packed
    assert ds._sa.width == 12  # bits_for(3001)
    assert (ds.require_lcp() == plain_lcp).all()
    assert isinstance(ds._lcp, IntVector)

    from tudocomp_tpu.ds import flags

    ds2 = TextDS(text, compress_mode="delayed")
    ds2.require(flags.SA | flags.ISA | flags.LCP)
    for nm in ("_sa", "_isa", "_lcp"):
        assert isinstance(getattr(ds2, nm), IntVector), nm
    assert (ds2.sa() == plain_sa).all()

    # end-to-end byte parity across the DSL axis (raw: the container
    # header embeds the id string, so only payloads are comparable)
    data = b"the quick brown fox jumps over the lazy dog " * 40
    ref = compress("lzss_lcp(coder=huff)", data, raw=True)
    for cm in ("delayed", "compressed", "coherent_delayed"):
        algo = f"lzss_lcp(coder=huff, textds=textds(cm={cm}))"
        c = compress(algo, data, raw=True)
        assert c == ref
        assert decompress(c, id_string=algo, raw=True) == data
