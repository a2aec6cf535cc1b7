"""Registry self-description: --list docs + Meta-driven static enumeration.

Cross-checks that the Meta-driven machinery
(Registry.generate_doc_string / all_algorithms_with_static, mirroring
include/tudocomp/Registry.hpp:40-75 and generate_doc_string) covers the
curated conformance matrix (registry_config.compressor_matrix), so the two
views of the algorithm space cannot drift apart silently.
"""

import subprocess
import sys

import tudocomp_tpu  # noqa: F401  (registers all algorithms)
from tudocomp_tpu.registry import REGISTRY
from tudocomp_tpu.registry_config import compressor_matrix


def _base_name(id_string: str) -> str:
    return id_string.split("(")[0].strip()


def test_doc_string_covers_matrix():
    doc = REGISTRY.generate_doc_string("compressor")
    for id_s in compressor_matrix():
        assert f"  {_base_name(id_s)}" in doc, id_s


def test_doc_string_has_all_types():
    for t in REGISTRY.types():
        doc = REGISTRY.generate_doc_string(t)
        assert doc.startswith(f"[{t}]")
        for name in REGISTRY.names(t):
            assert f"  {name}" in doc


def test_static_enumeration_covers_matrix_names():
    enum = REGISTRY.all_algorithms_with_static("compressor")
    enum_names = {_base_name(e) for e in enum}
    # algorithms requiring a runtime compressor argument (chain/blockwise)
    # are not statically instantiable and excluded from the enumeration
    dyn = {
        name
        for name in REGISTRY.names("compressor")
        if any(
            d.kind == "dynamic_compressor" and d.default is None
            for d in REGISTRY.get_class("compressor", name).meta().options.values()
        )
    }
    matrix_names = {_base_name(i) for i in compressor_matrix()} - dyn
    missing = matrix_names - enum_names
    assert not missing, f"matrix names absent from Meta enumeration: {missing}"


def test_static_enumeration_parses():
    # every Meta-enumerated id must parse and evaluate against the registry
    enum = REGISTRY.all_algorithms_with_static("compressor")
    assert len(enum) >= len(REGISTRY.names("compressor"))
    for id_s in enum[:200]:
        av = REGISTRY.parse_algorithm_id(id_s, "compressor")
        assert av.name == _base_name(id_s)


def test_cli_list_runs():
    proc = subprocess.run(
        [sys.executable, "-m", "tudocomp_tpu", "--list"],
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "[compressor]" in proc.stdout
    assert "lzss_lcp" in proc.stdout
