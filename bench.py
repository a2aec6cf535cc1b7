"""Benchmark: BASELINE.json configs, flagship = device Huffman block encode.

Prints one JSON line per config {"metric", "value", "unit", "vs_baseline"};
the FLAGSHIP metric is the LAST line (the driver records the tail line).

Baseline context (BASELINE.md): the reference publishes no first-party
numbers; BASELINE.json's target is >= 1 GB/s aggregate encode over 8
devices, i.e. 0.125 GB/s per device. vs_baseline is measured GB/s divided
by that per-device share.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np


def measure(result: dict) -> None:
    from tudocomp_tpu.device import ensure_compile_cache

    ensure_compile_cache()
    import jax
    import jax.numpy as jnp

    from tudocomp_tpu.ops.huffman_jax import encode_blocks

    B, bs = 64, 1 << 18  # 16 MiB per step
    n_words = (9 * bs + 4096 + 31) // 32

    # three distinct inputs rule out any cross-call caching; zipf bytes are
    # a realistic text-like skewed histogram
    ins = []
    for seed in range(3):
        payload = (
            np.random.default_rng(seed).zipf(1.3, B * bs).clip(0, 255).astype(np.uint8)
        )
        ins.append(jnp.asarray(payload.reshape(B, bs)))
    n_valid = jnp.full((B,), bs, jnp.int32)

    fn = jax.jit(lambda b, v: encode_blocks(b, v, n_words))
    jax.block_until_ready(fn(ins[0], n_valid))  # compile + warm

    # pipelined throughput: enqueue a stream of batches, sync at the end —
    # matches production use (continuous block stream per chip)
    iters = 6
    t0 = time.perf_counter()
    outs = [fn(ins[i % 3], n_valid) for i in range(iters)]
    jax.block_until_ready(outs)
    dt = (time.perf_counter() - t0) / iters
    result["gbps"] = (B * bs) / dt / 1e9

    # secondary BASELINE.json configs: end-to-end container bytes through
    # the public driver (host+device mix), wall-clock per config
    if os.environ.get("TDC_BENCH_CONFIGS", "1") != "0":
        try:
            result.setdefault("extra", []).extend(_config_metrics())
        except Exception as e:  # surface the breakage instead of hiding it
            result.setdefault("extra", []).append(
                {
                    "metric": "config_metrics_error",
                    "value": 0,
                    "unit": "error",
                    "vs_baseline": 0,
                    "error": f"{type(e).__name__}: {e}"[:300],
                }
            )


    # device decode throughput: one-lane-per-block kernel
    # (ops/huffman_decode_pallas.py), data-resident: tables parsed and the
    # container uploaded once, untimed; correctness is asserted by the
    # full decode_container roundtrip first.
    try:
        from tudocomp_tpu.parallel.runtime import blockwise_huffman_compress
        from tudocomp_tpu.ops import huffman_decode_pallas as hdp

        dec_bs = 1 << 14
        raw = np.asarray(ins[0]).reshape(-1)[: 1 << 24].tobytes()  # 16 MiB
        container = blockwise_huffman_compress(raw, block_size=dec_bs)
        assert hdp.decode_container(container) == raw

        _, _, host_args = hdp.container_lanes(container)
        args = [jnp.asarray(a) for a in host_args]
        dec = lambda: hdp.decode_lanes(*args, n_steps=dec_bs // 4)  # noqa: E731
        jax.block_until_ready(dec())
        t0 = time.perf_counter()
        for _ in range(4):
            out = dec()
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / 4
        result.setdefault("extra", []).append(
            {
                "metric": "huffman_block_decode_throughput",
                "value": round(len(raw) / dt / 1e9, 4),
                "unit": "GB/s",
                "vs_baseline": round(len(raw) / dt / 1e9 / 0.125, 4),
            }
        )
    except Exception as e:
        result.setdefault("extra", []).append(
            {
                "metric": "huffman_block_decode_error",
                "value": 0,
                "unit": "error",
                "vs_baseline": 0,
                "error": f"{type(e).__name__}: {e}"[:200],
            }
        )

    # round-5 headline kernel: the staged device suffix array vs the
    # tuned native SA-IS (data-resident, exact-match asserted)
    try:
        import sys as _sys

        _sys.path.insert(0, os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "etc"))
        from datasets import synth_english

        from tudocomp_tpu import native as _native
        from tudocomp_tpu.ds.suffix_array import suffix_array_device

        _n = 16 << 20
        _arr = np.frombuffer(
            synth_english(np.random.default_rng(7), _n), np.uint8
        ).copy()
        _arr[-1] = 0
        _d = jnp.asarray(_arr)
        _f = jax.jit(suffix_array_device)
        jax.block_until_ready(_f(_d))
        t0 = time.perf_counter()
        for _ in range(3):
            _r = _f(_d)
        jax.block_until_ready(_r)  # the 64 MB result fetch is validated
        t_dev = (time.perf_counter() - t0) / 3  # untimed below
        _sa_dev = np.asarray(_r)
        _lib = _native.get_lib()
        _sa_host = np.zeros(_n, np.int32)
        t0 = time.perf_counter()
        _lib.tdc_sais(_arr, _n, _sa_host)
        t_host = time.perf_counter() - t0
        assert (_sa_dev == _sa_host).all()
        result.setdefault("extra", []).append(
            {
                "metric": "device_sa_16MiB_throughput",
                "value": round(_n / t_dev / 1e9, 4),
                "unit": "GB/s",
                "vs_baseline": round(t_host / t_dev, 2),
                "note": "vs_baseline = speedup over tuned native SA-IS; exact match asserted",
            }
        )
    except Exception as e:
        result.setdefault("extra", []).append(
            {
                "metric": "device_sa_error",
                "value": 0,
                "unit": "error",
                "vs_baseline": 0,
                "error": f"{type(e).__name__}: {e}"[:200],
            }
        )

    # round-5 kernel: staged device ESP parsing rounds vs the native host
    # rounds (data-resident chain, one counts sync; exactness validated
    # untimed through esp_grammar_device == generate_grammar)
    try:
        import sys as _sys

        _sys.path.insert(0, os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "etc"))
        from datasets import synth_english

        from tudocomp_tpu.compressors.esp import generate_grammar
        from tudocomp_tpu.ops import esp_jax

        _n = 16 << 20
        _data = np.frombuffer(
            synth_english(np.random.default_rng(7), _n), np.uint8
        )
        _size = 1
        while _size < _n:
            _size *= 2
        _pad = np.zeros(_size, np.int32)
        _pad[:_n] = _data
        _src0 = jnp.asarray(_pad)

        def _esp_chain():
            src, m, alphabet = _src0, jnp.int32(_n), jnp.int32(256)
            s = _size
            ks = []
            while s // 2 >= (1 << 15):
                nxt, nb, rl, rr, K, fb = esp_jax._round_jit(
                    s, max(8, s // 8)
                )(src, m, alphabet)
                ks.append(K)
                src, m, alphabet = nxt, nb, K
                s //= 2
            return jnp.stack(ks)

        _ = np.asarray(_esp_chain())  # compile/warm
        t0 = time.perf_counter()
        for _ in range(3):
            _r = _esp_chain()
        _ = np.asarray(_r)
        t_dev = (time.perf_counter() - t0) / 3
        t0 = time.perf_counter()
        _ref = generate_grammar(_data)
        t_host = time.perf_counter() - t0
        _got = esp_jax.esp_grammar_device(_data)
        assert np.array_equal(_ref[0], _got[0]) and _ref[1:] == _got[1:]
        result.setdefault("extra", []).append(
            {
                "metric": "device_esp_16MiB_throughput",
                "value": round(_n / t_dev / 1e9, 4),
                "unit": "GB/s",
                "vs_baseline": round(t_host / t_dev, 2),
                "note": "vs_baseline = speedup over native host rounds; grammar exact-match asserted",
            }
        )
    except Exception as e:
        result.setdefault("extra", []).append(
            {
                "metric": "device_esp_error",
                "value": 0,
                "unit": "error",
                "vs_baseline": 0,
                "error": f"{type(e).__name__}: {e}"[:200],
            }
        )



def _synth_text(n: int, kind: str) -> bytes:
    """BASELINE corpus stand-ins from etc/datasets.py (P&C downloads are
    unreachable in this airgapped environment; these are its documented
    --synthesize fallbacks). Real corpus files in etc/data/ take priority."""
    import sys

    etc = os.path.join(os.path.dirname(os.path.abspath(__file__)), "etc")
    corpus = {
        "english": "pc-english", "dna": "pc-dna", "sources": "pc-sources",
    }.get(kind)
    if corpus:
        path = os.path.join(etc, "data", f"{corpus}.{n >> 20}MB")
        if os.path.exists(path):
            with open(path, "rb") as f:
                return f.read(n)
    sys.path.insert(0, etc)
    from datasets import synth_dna, synth_english, synth_sources

    rng = np.random.default_rng(7)
    if kind == "english":
        return synth_english(rng, n)
    if kind == "dna":
        return synth_dna(rng, n)
    if kind == "sources":
        return synth_sources(rng, n)
    return bytes(rng.integers(0, 256, n).astype(np.uint8).tobytes())


def _config_metrics() -> list:
    """BASELINE.json configs 1-5 at BASELINE-named sizes. Device-stage
    policy follows the measured crossovers in PERF.md (suffix pipelines
    engage device stages where they win; host natives keep the stages the
    device loses). Each metric reports compress AND decompress throughput
    (the BASELINE metric is encode/decode GB/s)."""
    from tudocomp_tpu.driver import compress, decompress

    big = os.environ.get("TDC_BENCH_BIG", "1") != "0"
    mb50 = 50 << 20 if big else 4 << 20
    mb16 = 16 << 20 if big else 2 << 20
    metrics = []
    cases = [
        # config 1: pure streaming transforms on 1 MB english
        ("rle_mtf_vbyte_1MB_english", "rle:mtf:encode(vbyte)", "english", 1 << 20),
        # config 2: lz78 trie parse with bit coder on english.50MB
        ("lz78_bit_english_50MB", "lz78(coder=bit)", "english", mb50),
        # config 3: SA/LCP factorization + huff on P&C dna and sources
        ("lzss_lcp_huff_dna_16MB", "lzss_lcp(coder=huff)", "dna", mb16),
        ("lzss_lcp_huff_sources_16MB", "lzss_lcp(coder=huff)", "sources", mb16),
        # config 4: ESP grammar (no arithmetic stage -- the d_coding axis
        # has plain/huffman/wt/subseq). esp's default slp_coder is plain
        # (reference EspCompressor.hpp:25), so the metric is named for
        # what it runs; the sorted coder (vectorized dep-sort) is a
        # second data point. Rounds r1-r4 reported "esp_sorted_1MB" but
        # ran the plain default — esp_plain_1MB is that series continued
        # under its correct name.
        ("esp_plain_1MB", "esp", "english", 1 << 20),
        ("esp_sorted_1MB", "esp(slp_coder=sorted)", "english", 1 << 20),
        # config 5 single-device slice: block-parallel lzss(huff), 4 MiB
        # blocks (device SA per block)
        ("blockwise_lzss_huff_16MB",
         "blockwise(lzss_lcp(coder=huff), bs=4194304, shared=1)", "dna", mb16),
    ]
    for name, algo, kind, n in cases:
        data = _synth_text(n, kind)
        # sub-second configs are jitter-dominated on the shared host:
        # take best of 2
        reps = 2 if n <= (2 << 20) else 1
        dt = ddt = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            c = compress(algo, data)
            dt = min(dt, time.perf_counter() - t0)
            t0 = time.perf_counter()
            d = decompress(c)
            ddt = min(ddt, time.perf_counter() - t0)
        ok = d == data
        gbps = n / dt / 1e9
        metrics.append(
            {
                "metric": f"{name}_compress_throughput",
                "value": round(gbps, 4),
                "unit": "GB/s",
                "vs_baseline": round(gbps / 0.125, 4),
                "decompress_gbps": round(n / ddt / 1e9, 4),
                "ratio_pct": round(100.0 * len(c) / n, 2),
                "roundtrip_ok": bool(ok),
            }
        )
    return metrics


def main():
    result: dict = {}
    measure(result)
    for extra in result.get("extra", []):
        print(json.dumps(extra))
    gbps = result["gbps"]
    print(
        json.dumps(
            {
                "metric": "huffman_block_encode_throughput",
                "value": round(gbps, 4),
                "unit": "GB/s",
                "vs_baseline": round(gbps / 0.125, 4),
            }
        )
    )


if __name__ == "__main__":
    main()
