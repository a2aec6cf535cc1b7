"""Smoke run of the device path on one GPU, through the public entry points.

    python chip_smoke.py          # the one-card phases below
    python chip_smoke.py --four   # only the 4-card data-parallel mesh path

Every phase compresses and decompresses through driver.compress /
driver.decompress (or, for the mesh, parallel.runtime), checks that the
roundtrip is byte-exact, compares the device stage with its host
reference, and asserts from the StatPhase tree that its device stages
ran. Any failed check raises: the script exits non-zero and prints no
result. Data comes from etc/datasets.py with fixed seeds.

Phases (one card):
  huff   blockwise(encode(huff)) on 256 MiB of english at bs=256 KiB and
         16 KiB; device encode, device decode, container equal to the host
         coder's on sampled blocks; device and host decoders timed.
  lzss   lzss_lcp(coder=huff) on 16 MiB of dna; device SA == native SA-IS.
  esp    esp on 16 MiB of english; device rounds, no host fallback,
         grammar == the host rounds.
  bwt    bwt:rle:mtf:encode(huff) on 32 MiB; device SA, RLE and MTF.
  optin  TDC_DEVICE_LZSS=1 and TDC_DEVICE_LCPCOMP=1 at 4 MiB.

The last line of standard output is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
MiB = 1 << 20


def _flat(phase: dict, depth: int = 0):
    """(depth, title, self ms, stats) for every node of a StatPhase dict."""
    total = phase["timeEnd"] - phase["timeStart"]
    kids = sum(c["timeEnd"] - c["timeStart"] for c in phase["sub"])
    stats = {s["key"]: s["value"] for s in phase["stats"]}
    yield depth, phase["title"], total - kids, stats
    for c in phase["sub"]:
        yield from _flat(c, depth + 1)


def _titles(phase: dict) -> set:
    return {t for _, t, _, _ in _flat(phase)}


def _print_tree(phase: dict) -> None:
    for depth, title, self_ms, stats in _flat(phase):
        extra = f" {stats}" if stats else ""
        print(f"    {'  ' * depth}{title}: self {self_ms:.1f} ms{extra}")


class Phase:
    """One timed end-to-end step with its StatPhase tree."""

    def __init__(self, name: str, n_bytes: int):
        self.name, self.n_bytes = name, n_bytes

    def __enter__(self):
        from tudocomp_tpu.stats.phase import StatPhase

        self.root = StatPhase(self.name)
        self.root.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.t0
        self.root.__exit__(*exc)
        self.tree = self.root.to_dict()
        if exc[0] is None:
            print(
                f"  [{self.name}] {self.seconds:.3f} s, "
                f"{self.n_bytes / self.seconds / 1e9:.4f} GB/s",
                flush=True,
            )
            _print_tree(self.tree)
        return False

    def expect(self, *stages: str, absent: tuple = ()) -> None:
        titles = _titles(self.tree)
        missing = [s for s in stages if s not in titles]
        if missing:
            raise AssertionError(f"{self.name}: device stages did not run: {missing}")
        fired = [s for s in absent if s in titles]
        if fired:
            raise AssertionError(f"{self.name}: unexpected stages ran: {fired}")
        if stages:
            print(f"  [{self.name}] device stages ran: {', '.join(stages)}", flush=True)


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)
    print(f"  ok: {what}", flush=True)


def _gen(kind: str, n: int, seed: int) -> bytes:
    sys.path.insert(0, os.path.join(REPO, "etc"))
    import numpy as np
    from datasets import synth_dna, synth_english

    fn = {"english": synth_english, "dna": synth_dna}[kind]
    return fn(np.random.default_rng(seed), n)


def _roundtrip(name: str, algo: str, data: bytes, stages=(), absent=()):
    from tudocomp_tpu.driver import compress, decompress

    with Phase(f"{name} compress", len(data)) as pc:
        c = compress(algo, data)
    with Phase(f"{name} decompress", len(data)) as pd:
        d = decompress(c)
    _check(d == data, f"{name}: {algo} roundtrip exact ({len(data)} -> {len(c)} bytes)")
    titles = _titles(pc.tree) | _titles(pd.tree)
    missing = [s for s in stages if s not in titles]
    _check(not missing, f"{name}: device stages ran {list(stages)} (missing {missing})")
    fired = [s for s in absent if s in titles]
    _check(not fired, f"{name}: no host fallback {list(absent)} (fired {fired})")
    return c, pc, pd


class _env:
    """Set one environment variable for a block; restore it after."""

    def __init__(self, name: str, value: str):
        self.name, self.value = name, value

    def __enter__(self):
        self.saved = os.environ.get(self.name)
        os.environ[self.name] = self.value

    def __exit__(self, *exc):
        if self.saved is None:
            del os.environ[self.name]
        else:
            os.environ[self.name] = self.saved
        return False


def _timed(fn, reps: int = 2):
    """Best wall time of fn() over reps calls, after one warm-up call."""
    out = fn()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        best = min(best, time.perf_counter() - t0)
    return best, out


def phase_huff(data: bytes) -> None:
    import jax
    import numpy as np

    from tudocomp_tpu.driver import decompress
    from tudocomp_tpu.io.inout import Input, Output
    from tudocomp_tpu.ops import huffman_decode_pallas as hdp
    from tudocomp_tpu.parallel.blocks import split_blocks, unframe_streams
    from tudocomp_tpu.parallel.runtime import dp_mesh, make_block_encoder
    from tudocomp_tpu.registry import create_algo

    for bs in (256 << 10, 16 << 10):
        name = f"huff bs={bs >> 10}KiB"
        algo = f"blockwise(encode(huff), bs={bs})"
        c, pc, pd = _roundtrip(
            name, algo, data,
            stages=("device blockwise encode", "device blockwise decode"),
        )
        body = c[c.index(b"%") + 1 :]
        _, payloads = unframe_streams(body)
        sample = sorted({0, 1, len(payloads) // 2, len(payloads) - 1})
        for i in sample:
            o = Output()
            create_algo("encode(huff)").compress(
                Input(data[i * bs : (i + 1) * bs]), o
            )
            if bytes(o.raw_value()) != payloads[i]:
                raise AssertionError(f"{name}: block {i} differs from the host coder")
        _check(True, f"{name}: blocks {sample} byte-identical to the host coder")

        # decoders, end to end from container bytes to output bytes
        t_kernel, out = _timed(lambda: hdp.decode_container(body))
        _check(out == data, f"{name}: device kernel decode exact")
        with _env("TDC_DEVICE_HUFF", "0"):
            t_host, out = _timed(lambda: decompress(c), reps=1)
        _check(out == data, f"{name}: host native decode exact")
        print(
            f"  [{name}] decode GB/s: kernel {len(data) / t_kernel / 1e9:.4f} "
            f"({t_kernel:.3f} s), host native {len(data) / t_host / 1e9:.4f} "
            f"({t_host:.3f} s)",
            flush=True,
        )

        # the encode step's compiled memory footprint at this shape
        blocks, n_valid = split_blocks(data, bs)
        step = make_block_encoder(dp_mesh(jax.devices()[:1]), (9 * bs + 4096 + 31) // 32)
        compiled = step.lower(
            jax.ShapeDtypeStruct(blocks.shape, np.uint8),
            jax.ShapeDtypeStruct(n_valid.shape, np.int32),
        ).compile()
        print(f"  [{name}] encode step memory_analysis: {compiled.memory_analysis()}", flush=True)


def phase_lzss(data: bytes) -> None:
    import numpy as np

    from tudocomp_tpu import native
    from tudocomp_tpu.ds.textds import TextDS
    from tudocomp_tpu.io.inout import Input
    from tudocomp_tpu.io.restrict import InputRestrictions

    _roundtrip("lzss", "lzss_lcp(coder=huff)", data, stages=("device SA",))
    text = Input(data).with_restrictions(InputRestrictions((0,), True)).as_array()
    with Phase("lzss device SA", len(text)) as p:
        sa = TextDS(text).require_sa()
    p.expect("device SA")
    ref = np.empty(len(text), np.int32)
    if native.get_lib().tdc_sais(text, len(text), ref) != 0:
        raise AssertionError("native SA-IS failed")
    _check(np.array_equal(sa, ref), "lzss: device SA == native tdc_sais")


def phase_esp(data: bytes) -> None:
    import numpy as np

    from tudocomp_tpu.compressors.esp import generate_grammar
    from tudocomp_tpu.ops.esp_jax import esp_grammar_device

    _roundtrip(
        "esp", "esp", data,
        stages=("device ESP rounds",), absent=("esp host fallback",),
    )
    arr = np.frombuffer(data, np.uint8)
    with Phase("esp device grammar", len(data)) as p:
        got = esp_grammar_device(arr)
    p.expect(absent=("esp host fallback",))
    want = generate_grammar(arr)
    _check(
        np.array_equal(got[0], want[0]) and got[1:] == want[1:],
        "esp: device grammar == generate_grammar",
    )


def phase_bwt(data: bytes) -> None:
    _roundtrip(
        "bwt chain", "bwt:rle:mtf:encode(huff)", data,
        stages=("device SA", "device RLE", "device MTF"),
    )


def phase_optin(data: bytes) -> None:
    from tudocomp_tpu.driver import compress

    for var, algo, stages in (
        ("TDC_DEVICE_LZSS", "lzss_lcp(coder=huff)", ("device lzss factorize",)),
        (
            "TDC_DEVICE_LCPCOMP",
            "lcpcomp(coder=huff, comp=plcppeaks)",
            ("device lcpcomp factorize", "device lcpcomp decode"),
        ),
    ):
        with _env(var, "0"):
            host = compress(algo, data)
        with _env(var, "1"):
            c, _, _ = _roundtrip(f"optin {var}", algo, data, stages=stages)
        _check(c == host, f"optin {var}: container == host path's")


def phase_four() -> None:
    import jax

    from tudocomp_tpu.ops.huffman_decode_pallas import decode_container
    from tudocomp_tpu.parallel.runtime import blockwise_huffman_compress, dp_mesh

    devices = jax.devices()
    if len(devices) != 4:
        raise AssertionError(f"--four needs 4 devices, JAX sees {len(devices)}")
    data = b"".join(_gen("english", 256 * MiB, seed) for seed in range(4))
    bs = 256 << 10
    for shared in (False, True):
        name = f"mesh shared={int(shared)}"
        runs = {}
        for n_dev in (4, 1):
            mesh = dp_mesh(devices[:n_dev])
            blockwise_huffman_compress(data, bs, mesh=mesh, shared_table=shared)  # compile
            with Phase(f"{name} {n_dev} device(s)", len(data)):
                runs[n_dev] = blockwise_huffman_compress(
                    data, bs, mesh=mesh, shared_table=shared
                )
        _check(runs[4] == runs[1], f"{name}: 4-device container == 1-device container ({len(runs[4])} bytes)")
        _check(decode_container(runs[4]) == data, f"{name}: roundtrip exact")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true", help="run only the 4-card mesh path")
    args = ap.parse_args()

    sys.path.insert(0, REPO)
    from tudocomp_tpu.device import ensure_compile_cache

    cache = ensure_compile_cache()
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX backend: {devices[0].platform})", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"nvidia-smi: {smi}")
    print(f"device_kind: {devices[0].device_kind} x{len(devices)}")
    print(f"compile cache: {cache}")
    from tudocomp_tpu import native

    built = native.get_lib() is not None
    print(f"native library built: {built}", flush=True)
    if not built:
        raise AssertionError("the native C++ library did not build")

    if args.four:
        phase_four()
    else:
        for name, fn, kind, n in (
            ("huff", phase_huff, "english", 256 * MiB),
            ("lzss", phase_lzss, "dna", 16 * MiB),
            ("esp", phase_esp, "english", 16 * MiB),
            ("bwt", phase_bwt, "english", 32 * MiB),
            ("optin", phase_optin, "english", 4 * MiB),
        ):
            t0 = time.perf_counter()
            data = _gen(kind, n, seed=7)
            print(f"== {name}: {n >> 20} MiB {kind} (made in {time.perf_counter() - t0:.1f} s)", flush=True)
            fn(data)
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": devices[0].platform,
                    "kind": devices[0].device_kind,
                    "count": len(devices),
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
