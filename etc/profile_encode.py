"""Stage-by-stage profiling of the device Huffman encode pipeline.

Times each stage in isolation (with optimization_barrier'd inputs) and the
whole pipeline, so fusion pathologies show up as whole >> sum(stages).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tudocomp_tpu.device import ensure_compile_cache

ensure_compile_cache()

import jax
import jax.numpy as jnp

from tudocomp_tpu.ops import huffman_jax as hj


def timeit(fn, *args, iters=5):
    out = jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def main():
    B = int(os.environ.get("PROF_B", "64"))
    bs = int(os.environ.get("PROF_BS", str(1 << 18)))
    n_words = (9 * bs + 4096 + 31) // 32
    nbytes = B * bs

    rng = np.random.default_rng(0)
    payload = rng.zipf(1.3, nbytes).clip(0, 255).astype(np.uint8)
    blocks = jnp.asarray(payload.reshape(B, bs))
    n_valid = jnp.full((B,), bs, jnp.int32)
    dev = jax.devices()[0]
    print(f"B={B} bs={bs} total={nbytes/1e6:.1f} MB device={dev.platform}/{dev.device_kind}")

    # stage 1: histogram
    f_hist = jax.jit(hj.block_histograms)
    dt = timeit(f_hist, blocks, n_valid)
    print(f"hist            {dt*1e3:8.2f} ms  {nbytes/dt/1e9:8.2f} GB/s")
    hists = jax.block_until_ready(f_hist(blocks, n_valid))

    # stage 2: table build (code lengths)
    f_len = jax.jit(hj.code_lengths_batch)
    dt = timeit(f_len, hists)
    print(f"code_lengths    {dt*1e3:8.2f} ms  {nbytes/dt/1e9:8.2f} GB/s")
    lengths = jax.block_until_ready(f_len(hists))

    # stage 3: canonical codes
    f_can = jax.jit(hj.canonical_codes_batch)
    dt = timeit(f_can, lengths)
    print(f"canonical       {dt*1e3:8.2f} ms  {nbytes/dt/1e9:8.2f} GB/s")

    # stage 4+5: tokenize+pack given lengths
    def tok_pack(blocks, n_valid, lengths):
        return jax.vmap(
            lambda b, nv, ln: hj._encode_one_block(b, nv, ln, n_words, True)
        )(blocks, n_valid, lengths)

    f_tp = jax.jit(tok_pack)
    dt = timeit(f_tp, blocks, n_valid, lengths)
    print(f"tok+pack        {dt*1e3:8.2f} ms  {nbytes/dt/1e9:8.2f} GB/s")

    # whole pipeline
    f_all = jax.jit(lambda b, v: hj.encode_blocks(b, v, n_words))
    dt = timeit(f_all, blocks, n_valid)
    print(f"WHOLE           {dt*1e3:8.2f} ms  {nbytes/dt/1e9:8.2f} GB/s")

    # shared-table mode
    f_sh = jax.jit(lambda b, v: hj.encode_blocks(b, v, n_words, True))
    dt = timeit(f_sh, blocks, n_valid)
    print(f"WHOLE shared    {dt*1e3:8.2f} ms  {nbytes/dt/1e9:8.2f} GB/s")


if __name__ == "__main__":
    main()
