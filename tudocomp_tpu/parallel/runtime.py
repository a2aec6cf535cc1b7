"""Data-parallel block compression runtime over a JAX device mesh.

The distributed layer of the framework (SURVEY.md §2.11, BASELINE.json):
blocks are sharded over the mesh's "dp" axis; shared entropy tables are
formed by psum'ing per-device histograms over the interconnect; compressed
word arenas
and bit counts are gathered back in deterministic block order so the framed
container is bit-exact regardless of device count.

Single-host multi-card uses one process; multi-host runs initialize
jax.distributed and shard the global block array the same way (the dp axis
spans hosts x cards; blocks stay host-local, only 256-entry histograms and
per-block bit counts cross hosts).
"""

from __future__ import annotations

import os

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..ops import huffman_jax
from ..ops.bitpack import finalize_stream
from .blocks import frame_streams, pad_block_count, split_blocks

__all__ = [
    "dp_mesh",
    "make_block_encoder",
    "blockwise_huffman_compress",
    "blockwise_lzss_compress",
]


def dp_mesh(devices=None) -> Mesh:
    """A 1-D data-parallel mesh over all (or the given) devices."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devices.reshape(-1), ("dp",))


def make_block_encoder(mesh: Mesh, n_words: int, shared_table: bool = False):
    """Build the jitted DP block-encode step for a mesh.

    Returns step(blocks [B, bs] u8, n_valid [B]) -> (words [B, n_words] u32,
    bits [B] i32), with B divisible by the dp axis size. shared_table=True
    psums histograms over dp so every block uses one global Huffman table
    (emitted per block for self-containedness).
    """

    def local_encode(blocks, n_valid):
        hists = huffman_jax.block_histograms(blocks, n_valid)
        if shared_table:
            # global histogram: sum local blocks, then psum across the mesh;
            # solve the table once per device, broadcast lengths to blocks
            local = jnp.sum(hists, axis=0)
            glob = jax.lax.psum(local, "dp")
            lengths = huffman_jax.shared_code_lengths(glob)
            lengths = jnp.broadcast_to(lengths, (blocks.shape[0], 256))
            return huffman_jax.encode_blocks_from_lengths(
                blocks, n_valid, lengths, n_words, True
            )
        return huffman_jax.encode_blocks_with_hists(
            blocks, n_valid, hists, n_words
        )

    step = shard_map(
        local_encode,
        mesh=mesh,
        in_specs=(P("dp", None), P("dp")),
        out_specs=(P("dp", None), P("dp")),
        # fori_loop carries start as unvarying literals; skip the
        # varying-manual-axes consistency analysis (jax>=0.8 check_vma)
        check_vma=False,
    )
    return jax.jit(step)


def blockwise_huffman_compress(
    data,
    block_size: int = 1 << 18,
    mesh: Mesh = None,
    shared_table: bool = False,
) -> bytes:
    """End-to-end block-parallel Huffman encode -> framed container bytes."""
    mesh = mesh or dp_mesh()
    ndev = mesh.devices.size
    blocks, n_valid = split_blocks(data, block_size)
    blocks, n_valid, n_real = pad_block_count(blocks, n_valid, ndev)
    n_words = (9 * block_size + 4096 + 31) // 32

    step = make_block_encoder(mesh, n_words, shared_table)
    sharding = NamedSharding(mesh, P("dp"))
    dblocks = jax.device_put(blocks, NamedSharding(mesh, P("dp", None)))
    dvalid = jax.device_put(n_valid, sharding)
    words, bits = jax.block_until_ready(step(dblocks, dvalid))

    if jax.process_count() > 1:
        # multi-host: the output arrays are globally sharded; gather the
        # ordered streams to every host (deterministic block
        # order keeps the container bit-exact for any process count)
        from jax.experimental import multihost_utils

        words = np.asarray(multihost_utils.process_allgather(words, tiled=True))
        bits = np.asarray(multihost_utils.process_allgather(bits, tiled=True))
    else:
        words = np.asarray(words)
        bits = np.asarray(bits)
    payloads = [
        finalize_stream(words[i], int(bits[i])) for i in range(n_real)
    ]
    return frame_streams(payloads, block_size)


def blockwise_lzss_compress(
    data,
    block_size: int = 1 << 18,
    threshold: int = 3,
    shared_table: bool = False,
    coder: str = "huff",
) -> bytes:
    """Block-parallel lzss_lcp(coder=huff) over the process mesh.

    The DP flagship beyond plain entropy coding (BASELINE config 5): blocks
    are partitioned contiguously over processes; each process runs the full
    per-block pipeline (restriction wrap -> SA/ISA/LCP -> ANSV factorize ->
    lzss encode) with the device stages engaged by the standard use_device
    gates; with shared_table=True the literal histograms are summed across
    every process (all-gather) and one global Huffman table encodes
    all blocks (serialized per block, so streams stay standard-decodable);
    payloads are gathered in deterministic block order into the TBK1
    container — output bytes are identical for any process count.

    Without shared_table the per-block payloads are byte-identical to
    driver.compress("lzss_lcp(coder=huff)", block, raw=True).
    """
    from ..coders.huffman import HuffmanCoder
    from ..compressors.lzss_common import encode_text, literal_feed
    from ..compressors.lzss_lcp import lcp_factorize
    from ..ds.textds import TextDS
    from ..io.bitio import BitWriter
    from ..io.inout import Input
    from ..io.restrict import InputRestrictions
    from ..meta import AlgorithmValue, Env
    from ..registry import REGISTRY
    from ..stats.phase import StatPhase

    assert coder == "huff", "mesh path currently requires the huff coder"
    blocks, n_valid = split_blocks(data, block_size)
    nb = len(blocks)
    pc, pi = jax.process_count(), jax.process_index()
    chunk = -(-nb // pc) if nb else 0
    lo, hi = pi * chunk, min(nb, (pi + 1) * chunk)

    # lzss_lcp textds restrictions: escape \0, append sentinel (applied
    # per block, mirroring the per-block driver.compress on the host path)
    rest = InputRestrictions((0,), True)

    def _one(i):
        inp = Input(bytes(blocks[i, : n_valid[i]])).with_restrictions(rest)
        text = inp.as_array()
        ds = TextDS(text)
        f = lcp_factorize(
            ds.require_sa(), ds.require_isa(), ds.require_lcp(), threshold
        )
        h = (
            np.bincount(literal_feed(text, f).chars(), minlength=256)
            if shared_table
            else None
        )
        return text, f, h

    with StatPhase("blockwise lzss factorize") as ph:
        ph.log("blocks_local", hi - lo)
        # thread pool: the heavy stages (native SA-IS/PLCP/ANSV, numpy)
        # release the GIL, so blocks factorize core-parallel per process
        import concurrent.futures as cf

        workers = min(os.cpu_count() or 1, max(1, hi - lo))
        if workers > 1:
            with cf.ThreadPoolExecutor(max_workers=workers) as ex:
                results = list(ex.map(_one, range(lo, hi)))
        else:
            results = [_one(i) for i in range(lo, hi)]
    texts = [r[0] for r in results]
    factor_sets = [r[1] for r in results]
    hists = [r[2] for r in results if r[2] is not None]

    counts = None
    if shared_table:
        local = (
            np.sum(hists, axis=0).astype(np.int64)
            if hists
            else np.zeros(256, np.int64)
        )
        if pc > 1:
            from jax.experimental import multihost_utils

            allh = np.asarray(
                multihost_utils.process_allgather(local[None, :], tiled=True)
            )
            counts = allh.sum(axis=0)
        else:
            counts = local

    env = Env(REGISTRY, AlgorithmValue("huff", {}, type="coder"))
    payloads = []
    with StatPhase("blockwise lzss encode"):
        for text, f in zip(texts, factor_sets):
            w = BitWriter()
            enc = HuffmanCoder.Encoder(env, w, literal_feed(text, f), counts=counts)
            encode_text(enc, w, text, f)
            enc.finalize()
            payloads.append(w.getvalue())

    if pc > 1:
        from jax.experimental import multihost_utils

        # ordered variable-length gather: agree on the max payload size,
        # pad every process to `chunk` rows, concatenate, slice real rows
        local_max = np.array(
            [max((len(p) for p in payloads), default=0)], np.int64
        )
        gmax = int(
            np.asarray(
                multihost_utils.process_allgather(local_max, tiled=True)
            ).max()
        )
        arr = np.zeros((chunk, gmax), np.uint8)
        lens = np.zeros(chunk, np.int64)
        for j, p in enumerate(payloads):
            arr[j, : len(p)] = np.frombuffer(p, np.uint8)
            lens[j] = len(p)
        garr = np.asarray(multihost_utils.process_allgather(arr, tiled=True))
        glens = np.asarray(multihost_utils.process_allgather(lens, tiled=True))
        payloads = [bytes(garr[i, : glens[i]]) for i in range(nb)]

    return frame_streams(payloads, block_size)


def blockwise_huffman_decompress(container: bytes, device: bool = False) -> bytes:
    """Decode the framed container (per-block huff decode).

    device=True decodes one block per GPU thread (ops/huffman_decode_pallas.py);
    the host parses only the per-block table headers.
    """
    from .blocks import unframe_streams

    if device:
        from ..ops.huffman_decode_pallas import decode_container

        return decode_container(container)
    block_size, payloads = unframe_streams(container)
    from ..driver import decompress

    out = bytearray()
    for p in payloads:
        out += decompress(p, id_string="encode(huff)", raw=True)
    return bytes(out)
