"""Blockwise (data-parallel) compressor wrapper (id "blockwise").

The CLI/DSL surface of the block-parallel runtime (SURVEY.md §2.11, the
new distributed dimension): the input is split into fixed-size blocks and
each block is compressed independently — on the device mesh for the
device-native inner pipelines (encode(huff) runs the jitted block-parallel
Huffman encoder over all local devices, with optional psum'd shared
tables), and on the host for any other inner compressor. Per-block streams
are framed in the deterministic TBK1 container (parallel/blocks.py), so
output bytes are identical for any device count.

    blockwise(inner, bs=262144, shared=false)
"""

from __future__ import annotations

import os

import numpy as np

from ..base import Compressor
from ..io.inout import Input, Output
from ..meta import Meta
from ..stats.phase import StatPhase
from ..parallel.blocks import frame_offsets, frame_streams, split_blocks


def _compress_one(args):
    inner_id, block = args
    from ..driver import compress

    return compress(inner_id, block, raw=True)


def _host_compress_blocks(inner_id: str, blocks, n_valid) -> list:
    """Per-block host compression; blocks are independent, so they fan out
    over a process pool (the host analogue of the DP runtime; disable with
    TDC_BLOCKWISE_PROCS=0 or force a count with =N)."""
    from ..driver import compress

    nb = len(blocks)
    procs_env = os.environ.get("TDC_BLOCKWISE_PROCS", "")
    if procs_env == "0" or nb < 8:
        return [
            compress(inner_id, bytes(blocks[i, : n_valid[i]]), raw=True)
            for i in range(nb)
        ]
    import concurrent.futures as cf
    import multiprocessing as mp
    import sys

    # spawn re-imports __main__; interactive/stdin parents cannot be
    # re-imported, so the pool would only produce noisy child failures
    main_file = getattr(sys.modules.get("__main__"), "__file__", None)
    if main_file is None or not os.path.exists(main_file):
        return [
            compress(inner_id, bytes(blocks[i, : n_valid[i]]), raw=True)
            for i in range(nb)
        ]

    try:
        workers = int(procs_env) if procs_env else min(8, os.cpu_count() or 1)
    except ValueError:
        workers = min(8, os.cpu_count() or 1)
    payload = [(inner_id, bytes(blocks[i, : n_valid[i]])) for i in range(nb)]
    # spawn, not fork: JAX may already be initialized in this process and
    # forking a multithreaded runtime can deadlock the children. The
    # workers are host-only: this process holds the accelerator, so they
    # start with JAX_PLATFORMS=cpu (read by JAX at import) and never open
    # it. submit() spawns the workers, so they all start inside map().
    saved = os.environ.get("JAX_PLATFORMS")
    os.environ["JAX_PLATFORMS"] = "cpu"
    try:
        ex = cf.ProcessPoolExecutor(
            max_workers=workers, mp_context=mp.get_context("spawn")
        )
        results = ex.map(_compress_one, payload, chunksize=4)
    finally:
        if saved is None:
            del os.environ["JAX_PLATFORMS"]
        else:
            os.environ["JAX_PLATFORMS"] = saved
    with ex:
        return list(results)


class BlockwiseCompressor(Compressor):
    @classmethod
    def meta(cls) -> Meta:
        m = Meta("compressor", "blockwise", "Block-parallel compression wrapper")
        m.option("inner").dynamic_compressor()
        m.option("bs").dynamic(1 << 18)
        m.option("shared").dynamic(0)
        return m

    def _inner(self):
        av = self.env.option("inner").as_algorithm()
        comp = self.env.registry.select_algorithm(av, "compressor")
        return comp, av

    def compress(self, inp: Input, out: Output) -> None:
        bs = self.env.option("bs").as_integer()
        shared = bool(self.env.option("shared").as_integer())
        comp, av = self._inner()
        data = inp.as_array()
        if av.id_string() in ("encode(coder=huff)", "encode(huff)"):
            with StatPhase("device blockwise encode") as ph:
                from ..parallel.runtime import blockwise_huffman_compress

                ph.log("bs", bs)
                out.write(blockwise_huffman_compress(bytes(data), bs, shared_table=shared))
                return
        if av.name == "lzss_lcp" and av.options.get("coder") is not None:
            coder_av = av.options["coder"]
            multiproc = False
            try:
                import jax

                multiproc = jax.process_count() > 1
            except Exception:
                pass
            if coder_av.name == "huff" and (shared or multiproc):
                # the DP mesh path: per-process SA/factorize, optionally a
                # globally shared psum'd Huffman table, ordered TBK1 gather
                with StatPhase("mesh blockwise lzss") as ph:
                    from ..parallel.runtime import blockwise_lzss_compress

                    ph.log("bs", bs)
                    out.write(
                        blockwise_lzss_compress(
                            bytes(data),
                            bs,
                            threshold=int(av.options.get("threshold", "3")),
                            shared_table=shared,
                        )
                    )
                    return
        blocks, n_valid = split_blocks(data, bs)
        with StatPhase("host blockwise encode") as ph:
            payloads = _host_compress_blocks(av.id_string(), blocks, n_valid)
            ph.log("blocks", len(blocks))
            out.write(frame_streams(payloads, bs))

    def decompress(self, inp: Input, out: Output) -> None:
        comp, av = self._inner()
        container = inp.as_bytes()
        block_size, offsets, lengths = frame_offsets(container)
        from ..device import use_device
        from ..ops.huffman_jax import MAX_BLOCK

        # one GPU thread decodes one block (ops/huffman_decode_pallas.py);
        # blocks <= MAX_BLOCK bound every code length to <= 31 bits
        if (
            av.id_string() in ("encode(coder=huff)", "encode(huff)")
            and block_size <= MAX_BLOCK
            and use_device("TDC_DEVICE_HUFF")
        ):
            with StatPhase("device blockwise decode"):
                from ..ops.huffman_decode_pallas import decode_container

                out.write(np.frombuffer(decode_container(container), np.uint8))
                return
        payloads = [container[o : o + n] for o, n in zip(offsets, lengths)]
        with StatPhase("blockwise decode"):
            # symmetric with the per-block driver.compress(raw=True) on the
            # encode side: inner restriction wrapping (escaping/sentinel)
            # is applied per block; blocks are independent, so decode runs
            # thread-parallel (the native decoders release the GIL)
            from ..driver import decompress as driver_decompress

            inner_id = av.id_string()
            # TDC_BLOCKWISE_PROCS=0 disables block parallelism on both
            # sides of the pipeline (the encode pool honors it too)
            par_ok = os.environ.get("TDC_BLOCKWISE_PROCS", "") != "0"
            if par_ok and len(payloads) > 1 and (os.cpu_count() or 1) > 1:
                import concurrent.futures as cf

                with cf.ThreadPoolExecutor(
                    max_workers=min(8, os.cpu_count() or 1)
                ) as ex:
                    parts = list(
                        ex.map(
                            lambda p: driver_decompress(
                                p, id_string=inner_id, raw=True
                            ),
                            payloads,
                        )
                    )
            else:
                parts = [
                    driver_decompress(p, id_string=inner_id, raw=True)
                    for p in payloads
                ]
            for part in parts:
                out.write(np.frombuffer(part, np.uint8))


def register(registry):
    registry.register(BlockwiseCompressor)
