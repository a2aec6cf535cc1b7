"""Library-level driver: header handling + restriction wrapping.

Mirror of the tdc driver flow (src/tudocomp_driver/tudocomp_driver.cpp:
252-345): on compress, write the id string + '%' header, wrap the input with
the compressor's declared restrictions, run compress. On decompress, read
the header up to '%' (sanity cap 1023 bytes), re-instantiate the pipeline,
wrap the *output* with the same restrictions and run decompress.
"""

from __future__ import annotations

import logging
from typing import Optional

from .device import ensure_compile_cache
from .io.inout import Input, Output
from .registry import REGISTRY, Registry

_LOG = logging.getLogger("tudocomp_tpu.driver")


def compress(
    id_string: str,
    data,
    registry: Optional[Registry] = None,
    raw: bool = False,
) -> bytes:
    ensure_compile_cache()
    reg = registry or REGISTRY
    av = reg.parse_algorithm_id(id_string, "compressor")
    comp = reg.select_algorithm(av, "compressor")
    rest = comp.meta().input_restrictions
    _LOG.info("compress: algorithm %s", av.id_string())
    _LOG.debug(
        "compress: %d input bytes, restrictions=%s, raw=%s", len(data), rest, raw
    )

    out = Output()
    if not raw:
        assert "%" not in id_string
        out.write(id_string.encode())
        out.write(b"%")
    inp = Input(data)
    if rest.has_restrictions:
        inp = inp.with_restrictions(rest)
    comp.compress(inp, out)
    return out.raw_value()


def decompress(
    data,
    registry: Optional[Registry] = None,
    id_string: Optional[str] = None,
    raw: bool = False,
) -> bytes:
    ensure_compile_cache()
    reg = registry or REGISTRY
    inp = Input(data)
    if not raw:
        arr = inp.raw_array()
        header = bytearray()
        for i in range(min(len(arr), 1024)):
            if arr[i] == ord("%"):
                break
            header.append(arr[i])
        else:
            raise ValueError("Input did not have an algorithm header!")
        inp = Input(arr[len(header) + 1 :])
        if id_string is None:
            id_string = header.decode()
    assert id_string is not None
    comp = reg.select(id_string, "compressor")
    rest = comp.meta().input_restrictions
    _LOG.info("decompress: algorithm %s", id_string)

    out = Output()
    wrapped = out.with_restrictions(rest) if rest.has_restrictions else out
    comp.decompress(inp, wrapped)
    return wrapped.getvalue()
