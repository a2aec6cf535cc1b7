"""Multi-host initialization and the multi-host compression entry point.

Each host runs the same program; `init_distributed()` wires
jax.distributed from an explicit coordinator address, process count and
id (arguments, or TDC_NUM_PROCESSES / TDC_PROCESS_ID / TDC_COORDINATOR),
after which `jax.devices()` spans every host's cards and the
block-parallel runtime in runtime.py shards over hosts x cards
automatically — blocks stay host-local, only 256-entry histograms (psum)
and per-block bit counts (gather) cross the interconnect, and host 0
assembles the deterministic TBK1 container.

Single-process runs skip initialization, so the same code path serves one
card, one host and N hosts. Validated without hardware by
__graft_entry__.dryrun_multichip (virtual device mesh).
"""

from __future__ import annotations

import os


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> bool:
    """Initialize jax.distributed when running multi-process; no-op
    otherwise. Returns True if distributed mode is active."""
    import jax

    env_procs = os.environ.get("TDC_NUM_PROCESSES")
    if num_processes is None and env_procs:
        num_processes = int(env_procs)
        process_id = int(os.environ.get("TDC_PROCESS_ID", "0"))
        coordinator_address = coordinator_address or os.environ.get(
            "TDC_COORDINATOR", "127.0.0.1:8476"
        )
    if num_processes is None or num_processes <= 1:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def pod_compress(data: bytes, block_size: int = 1 << 18,
                 shared_table: bool = False, inner: str = "huff") -> bytes | None:
    """Compress across every process's devices; returns the container on process 0
    and None elsewhere (every process must call this collectively with the
    same data). inner selects the block pipeline: "huff" = encode(huff)
    over the device mesh, "lzss" = lzss_lcp(coder=huff) with per-process
    SA/factorize and (optionally) a globally shared Huffman table."""
    import jax

    from .runtime import blockwise_huffman_compress, blockwise_lzss_compress

    if inner == "lzss":
        out = blockwise_lzss_compress(
            data, block_size=block_size, shared_table=shared_table
        )
    else:
        out = blockwise_huffman_compress(
            data, block_size=block_size, shared_table=shared_table
        )
    return out if jax.process_index() == 0 else None
