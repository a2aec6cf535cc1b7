"""CLI driver tests (subprocess), mirror of test/tudocomp_driver_tests.cpp."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tdc(*args, data=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-m", "tudocomp_tpu", *args],
        input=data,
        capture_output=True,
        env=env,
        timeout=120,
    )


def test_roundtrip_file(tmp_path):
    f = tmp_path / "in.txt"
    f.write_bytes(b"abcabcabcabc hello hello")
    r = tdc("-a", "lz78", str(f))
    assert r.returncode == 0, r.stderr
    assert (tmp_path / "in.txt.tdc").exists()
    r = tdc("-d", str(f) + ".tdc", "--usestdout")
    assert r.returncode == 0, r.stderr
    assert r.stdout == b"abcabcabcabc hello hello"


def test_header_emission(tmp_path):
    # header is `<id-string>%` (tudocomp_driver_tests.cpp:28-49)
    f = tmp_path / "x.txt"
    f.write_bytes(b"abc")
    r = tdc("-a", "lz78(coder=ascii)", str(f), "--usestdout")
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith(b"lz78(coder=ascii)%")


def test_stdin_stdout():
    r = tdc("-a", "encode(huff)", "--usestdin", "--usestdout", data=b"tobeornottobe")
    assert r.returncode == 0, r.stderr
    r2 = tdc("-d", "--usestdin", "--usestdout", data=r.stdout)
    assert r2.stdout == b"tobeornottobe"


def test_raw_mode():
    r = tdc("-a", "rle", "--raw", "--usestdin", "--usestdout", data=b"aaaabbbb")
    assert r.returncode == 0, r.stderr
    assert not r.stdout.startswith(b"rle%")
    r2 = tdc("-d", "-a", "rle", "--raw", "--usestdin", "--usestdout", data=r.stdout)
    assert r2.stdout == b"aaaabbbb"


def test_generator_input():
    r = tdc("-g", "fib(n=5)", "-a", "noop", "--raw", "--usestdout")
    assert r.returncode == 0, r.stderr
    assert r.stdout == b"abaab"


def test_list():
    r = tdc("-l")
    assert r.returncode == 0
    out = r.stdout.decode()
    for name in ("lz78", "huff", "rle", "mtf", "chain", "fib"):
        assert name in out, name


def test_stats_json(tmp_path):
    f = tmp_path / "s.txt"
    f.write_bytes(b"x" * 1000)
    r = tdc("-a", "rle", str(f), "-s", "mytitle")
    assert r.returncode == 0, r.stderr
    doc = json.loads(r.stdout)
    assert doc["meta"]["title"] == "mytitle"
    assert doc["meta"]["inputSize"] == 1000
    assert doc["meta"]["outputSize"] == os.path.getsize(str(f) + ".tdc")
    assert doc["meta"]["rate"] == doc["meta"]["outputSize"] / 1000
    assert doc["data"]["title"] == "root"


def test_error_cases(tmp_path):
    assert tdc().returncode == 1
    assert tdc("-a", "nonexistent", "--usestdin", "--usestdout", data=b"x").returncode == 1
    f = tmp_path / "e.txt"
    f.write_bytes(b"abc")
    # existing output without -f
    (tmp_path / "e.txt.tdc").write_bytes(b"old")
    r = tdc("-a", "noop", str(f))
    assert r.returncode == 1
    assert b"already exists" in r.stderr
    # -f overwrites
    assert tdc("-a", "noop", str(f), "-f").returncode == 0
    # multiple inputs
    assert tdc("-a", "noop", "--usestdin", str(f), data=b"").returncode == 1
    # decompressing a generated string
    assert tdc("-d", "-g", "fib(n=3)", "--usestdout").returncode == 1


def test_generators_library():
    from tudocomp_tpu.generators.generators import (
        fibonacci_word,
        random_uniform,
        run_rich,
        thue_morse_word,
    )

    assert fibonacci_word(1) == b"b"
    assert fibonacci_word(2) == b"a"
    assert fibonacci_word(3) == b"ab"
    assert fibonacci_word(4) == b"aba"
    assert fibonacci_word(5) == b"abaab"
    assert fibonacci_word(6) == b"abaababa"

    assert thue_morse_word(0) == b"0"
    assert thue_morse_word(1) == b"0"
    assert thue_morse_word(2) == b"01"
    assert thue_morse_word(3) == b"0110"
    assert thue_morse_word(4) == b"01101001"
    with pytest.raises(ValueError):
        thue_morse_word(64)

    assert run_rich(0) == b"0110101101001011010"
    assert run_rich(1) == b"0110101101001"
    assert run_rich(2) == b"01101011010010110101101"
    assert run_rich(3) == b"01101011010010110101101" + b"0110101101001"
    # recurrence: t3(n) built from (t3+t2) or (t3+t0)
    assert run_rich(5).startswith(run_rich(4))

    s = random_uniform(100, seed=42)
    assert s == random_uniform(100, seed=42)
    assert all(ord("0") <= c <= ord("9") for c in s)
    s2 = random_uniform(50, seed=1, lo=ord("a"), hi=ord("c"))
    assert all(ord("a") <= c <= ord("c") for c in s2)


def test_stats_include_memory_columns(tmp_path):
    """--stats runs carry the malloc-override parity columns (per-phase
    memOff/memPeak on by default for stats output)."""
    import json
    import subprocess
    import sys

    src = tmp_path / "in.bin"
    src.write_bytes(b"memory column check " * 500)
    proc = subprocess.run(
        [sys.executable, "-m", "tudocomp_tpu", "-a", "encode(huff)",
         str(src), "-o", str(tmp_path / "out.tdc"), "-f", "--stats"],
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    doc = json.loads(
        [l for l in proc.stdout.splitlines() if l.startswith("{")][-1]
    )
    root = doc["data"]
    assert {"memOff", "memPeak", "memFinal"} <= set(root)
    assert root["memPeak"] > 0


def test_truncated_container_raises():
    """A container cut off mid-stream must exit non-zero / raise, not
    silently produce empty output (the bit reader's overran flag marks
    reads past the valid end; headers can never legitimately do that)."""
    import pytest

    from tudocomp_tpu.driver import compress, decompress

    data = b"the quick brown fox jumps over the lazy dog" * 4
    for algo in ("lcpcomp(coder=huff)", "lzss_lcp(coder=huff)"):
        c = compress(algo, data)
        for cut in (len(c) // 3, len(c) // 2):
            with pytest.raises((ValueError, AssertionError, IndexError)):
                out = decompress(c[:cut])
                # if no exception, at least the output must not silently
                # be a short prefix claiming success
                assert out == data
