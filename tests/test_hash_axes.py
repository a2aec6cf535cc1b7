"""Hash-strategy axes (hasher x prober x size-manager) are real behavior.

Mirror of util/Hash.hpp:13-305: every combination
parses to identical factors (the axes are the reference's speed axes, and
test/lz78_trie_tests.cpp relies on trie-independence of the output) while
probe counts measurably differ between configurations.
"""

import numpy as np
import pytest

from tudocomp_tpu import native
from tudocomp_tpu.compressors.lz78 import (
    HASH_FUNCTIONS,
    HASH_MANAGERS,
    HASH_PROBERS,
)
from tudocomp_tpu.driver import compress, decompress

pytestmark = pytest.mark.skipif(
    native.get_lib() is None, reason="native runtime unavailable"
)


def test_all_axis_combos_identical_factors_distinct_probes():
    lib = native.get_lib()
    data = np.frombuffer(b"the quick brown fox jumps " * 200, np.uint8).copy()
    n = len(data)
    ref_p = np.empty(n, np.uint32)
    ref_c = np.empty(n, np.uint8)
    nf0 = lib.tdc_lz78_parse(data, n, ref_p, ref_c)
    probe_counts = {}
    for h in HASH_FUNCTIONS.values():
        for p in HASH_PROBERS.values():
            for m in HASH_MANAGERS.values():
                pp = np.empty(n, np.uint32)
                cc = np.empty(n, np.uint8)
                probes = np.zeros(1, np.uint64)
                nf = lib.tdc_lz78_parse_hash(data, n, pp, cc, h, p, m, probes)
                assert nf == nf0
                np.testing.assert_array_equal(pp[:nf], ref_p[:nf0])
                np.testing.assert_array_equal(cc[:nf], ref_c[:nf0])
                probe_counts[(h, p, m)] = int(probes[0])
    # the axes must be observable: different table disciplines take
    # different probe paths
    assert len(set(probe_counts.values())) >= 4, probe_counts


def test_axis_id_strings_roundtrip_and_match_payload():
    data = b"abracadabra " * 400
    ids = [
        "lz78(coder=bit, lz78trie=hash)",
        "lz78(coder=bit, lz78trie=hash(hash_function=vigna))",
        "lz78(coder=bit, lz78trie=hash(hash_function=noop, hash_prober=double, hash_manager=prime))",
        "lz78(coder=bit, lz78trie=rolling(hash_prober=gauss))",
    ]
    payloads = set()
    for id_s in ids:
        c = compress(id_s, data)
        assert decompress(c) == data, id_s
        payloads.add(bytes(c[c.index(b"%") + 1 :]))
    # identical bitstream payload for every axis combination
    assert len(payloads) == 1
