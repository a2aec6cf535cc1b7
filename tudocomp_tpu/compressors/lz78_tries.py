"""LZ78 trie algorithm axis (type "lz78trie").

The reference exposes many trie backends for the LZ78/LZW dictionary
(reference lz78/TernaryTrie.hpp:16-141, BinaryTrie.hpp, BinarySortedTrie.hpp,
CedarTrie.hpp, HashTrie.hpp:14, HashTriePlus, ExtHashTrie, RollingTrie(Plus),
CompactSparseHashTrie.hpp:14; matrix in etc/registry_config.py:109-120). The
trie choice never affects the bitstream, only parse speed — a fact the
reference documents and its trie tests rely on (test/lz78_trie_tests.cpp
runs every trie against identical expected factor lists).

In this rebuild the parse runs in the C++ host runtime
(native/tdc_native.cpp), which uses a single open-addressed (parent,char)->id hash trie — the analogue of
HashTrie+squeeze_node (lz78/squeeze_node.hpp packed u40 keys). The registry
still exposes the full axis for id-string compatibility: every trie id the
reference accepts parses and selects here, all mapping to the same parse
kernel.
"""

from __future__ import annotations

from ..meta import Algorithm, Meta


class _TrieBase(Algorithm):
    """Marker algorithm for the lz78trie axis; selection only."""


def _make_trie(ident: str, doc: str, options=(), templated=()):
    class Trie(_TrieBase):
        @classmethod
        def meta(cls) -> Meta:
            m = Meta("lz78trie", ident, doc)
            for name, default in options:
                m.option(name).dynamic(default)
            for name, algo_type, default in templated:
                m.option(name).templated(algo_type, default)
            return m

    Trie.__name__ = f"LZ78Trie_{ident}"
    Trie.__qualname__ = Trie.__name__
    return Trie


_HASH_OPTS = (("load_factor", 30),)
# sub-algorithm axes of the hash-trie family (registry_config.py:109-120)
_HASH_SUBS = (
    ("hash_function", "hash_function", "mixer"),
    ("hash_prober", "hash_prober", "linear"),
    ("hash_manager", "hash_manager", "pow2"),
)
_HASH_SUBS_PLUS = _HASH_SUBS[:1] + _HASH_SUBS[2:]
_ROLL_SUBS = (("hash_roll", "hash_roll", "zbackup"),) + _HASH_SUBS

TRIES = [
    _make_trie("ternary", "Lempel-Ziv 78 Ternary Trie"),
    _make_trie("binary", "Lempel-Ziv 78 Binary Trie"),
    _make_trie("binarysorted", "Lempel-Ziv 78 Sorted Binary Trie"),
    _make_trie("cedar", "Lempel-Ziv 78 Cedar Trie"),
    _make_trie("hash", "Hash Trie", _HASH_OPTS, _HASH_SUBS),
    _make_trie("hash_plus", "Hash Trie+", _HASH_OPTS, _HASH_SUBS_PLUS),
    _make_trie("exthash", "External Hash Trie", _HASH_OPTS, _HASH_SUBS),
    _make_trie("rolling", "Rolling Hash Trie", _HASH_OPTS, _ROLL_SUBS),
    _make_trie("rolling_plus", "Rolling Hash Trie+", _HASH_OPTS, _ROLL_SUBS[:1] + _HASH_SUBS_PLUS),
    _make_trie("compact_sparse_hash", "Compact Sparse Hash Trie", _HASH_OPTS),
]


def register(registry):
    for t in TRIES:
        registry.register(t)
