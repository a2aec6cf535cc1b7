"""tudocomp-tpu: an accelerator-native lossless compression framework.

A from-scratch rebuild of the capabilities of tudocomp (the TU Dortmund
Compression Framework) designed for an accelerator first:
compressors are array programs (factorize on device, entropy bit-pack via
parallel prefix-sum kernels) with block-parallel data-parallel scaling over
JAX device meshes, while the modular compressor/coder pipeline, the
algorithm-string DSL and the bitstream formats match the reference.
"""

__version__ = "0.1.0"

from .base import Compressor, Generator
from .io.bitio import BitReader, BitWriter, bits_for
from .io.inout import Input, Output
from .io.restrict import InputRestrictions
from .meta import Algorithm, Env, Meta
from .ranges import BitRange, LiteralRange, MinDistributedRange, Range, bit_r, len_r, literal_r, size_r
from .registry import REGISTRY, Registry, create_algo
from .stats.phase import StatPhase

_registered = False


def register_all(registry: Registry = REGISTRY) -> Registry:
    """Register the full algorithm matrix (mirror of etc/registry_config.py)."""
    global _registered
    if _registered and registry is REGISTRY:
        return registry

    from .coders.universal import (
        ASCIICoder,
        BitCoder,
        EliasDeltaCoder,
        EliasGammaCoder,
        TernaryCoder,
        VbyteCoder,
    )
    from .compressors.chain import ChainCompressor
    from .compressors.simple import (
        LiteralEncoder,
        MTFCompressor,
        NoopCompressor,
        RunLengthEncoder,
    )

    for cls in (
        ASCIICoder,
        BitCoder,
        EliasGammaCoder,
        EliasDeltaCoder,
        TernaryCoder,
        VbyteCoder,
        NoopCompressor,
        RunLengthEncoder,
        MTFCompressor,
        LiteralEncoder,
        ChainCompressor,
    ):
        registry.register(cls)

    # optional/heavier families registered lazily below; each module extends
    # the matrix when imported successfully
    for modname in (
        "ds.textds_algo",
        "coders.huffman",
        "coders.arithmetic",
        "coders.sle",
        "compressors.bwt",
        "compressors.lz78",
        "compressors.lzw",
        "compressors.blockwise",
        "compressors.hash_axes",
        "compressors.lzss",
        "compressors.lzss_lcp",
        "compressors.lcpcomp",
        "compressors.repair",
        "compressors.esp",
        "compressors.lz78u",
        "compressors.lfs",
        "compressors.lfs2",
        "generators.generators",
    ):
        import importlib

        try:
            mod = importlib.import_module(f".{modname}", __package__)
        except ModuleNotFoundError as e:
            # only tolerate the module itself not existing yet (families are
            # built incrementally); a broken import inside a module that does
            # exist must surface, not half-register
            if e.name != f"{__package__}.{modname}":
                raise
            continue
        if hasattr(mod, "register"):
            mod.register(registry)

    if registry is REGISTRY:
        _registered = True
    return registry


register_all()
