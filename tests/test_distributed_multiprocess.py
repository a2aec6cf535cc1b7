"""Real 2-process jax.distributed test.

Spawns two OS processes that initialize jax.distributed over localhost
(CPU backend, 4 virtual devices each -> an 8-device global dp mesh), run
pod_compress collectively, and checks the container process 0 produced is
byte-identical to a single-process run — the device-count/process-count
invariance the TBK1 framing promises.
"""

import os
import socket
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = """
import os, sys
import numpy as np
from tudocomp_tpu.parallel.distributed import init_distributed, pod_compress

active = init_distributed()
assert active, "distributed init did not activate"
data = open(sys.argv[1], "rb").read()
out = pod_compress(data, block_size=4096)
import jax
assert jax.process_count() == 2, jax.process_count()
if jax.process_index() == 0:
    open(sys.argv[2], "wb").write(out)
else:
    assert out is None
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_container_matches_single_process(tmp_path):
    rng = np.random.default_rng(0)
    data = (b"distributed block parallel " * 800) + bytes(
        rng.integers(0, 256, 5000).astype(np.uint8)
    )
    data_file = tmp_path / "input.bin"
    data_file.write_bytes(data)
    out_file = tmp_path / "container.bin"
    port = _free_port()

    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.update(
            {
                "JAX_PLATFORMS": "cpu",
                "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
                "TDC_NUM_PROCESSES": "2",
                "TDC_PROCESS_ID": str(pid),
                "TDC_COORDINATOR": f"127.0.0.1:{port}",
                "PYTHONPATH": REPO,
            }
        )
        procs.append(
            subprocess.Popen(
                [sys.executable, "-c", WORKER, str(data_file), str(out_file)],
                env=env,
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
                text=True,
            )
        )
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{so[-2000:]}\n{se[-2000:]}"

    container = out_file.read_bytes()
    # single-process reference (8 virtual devices, same global device count)
    env = dict(os.environ)
    env.update(
        {
            "JAX_PLATFORMS": "cpu",
            "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
            "PYTHONPATH": REPO,
        }
    )
    ref_file = tmp_path / "ref.bin"
    code = (
        "import sys\n"
        "from tudocomp_tpu.parallel.runtime import blockwise_huffman_compress\n"
        "data = open(sys.argv[1], 'rb').read()\n"
        "open(sys.argv[2], 'wb').write(blockwise_huffman_compress(data, 4096))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code, str(data_file), str(ref_file)],
        env=env,
        capture_output=True,
        text=True,
        timeout=240,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert container == ref_file.read_bytes()

    # and it decodes back to the input
    from tudocomp_tpu.parallel.blocks import unframe_streams
    from tudocomp_tpu.driver import decompress

    _, payloads = unframe_streams(container)
    decoded = b"".join(
        decompress(p, id_string="encode(huff)", raw=True) for p in payloads
    )
    assert decoded == data


WORKER_LZSS = """
import os, sys
import numpy as np
from tudocomp_tpu.parallel.distributed import init_distributed, pod_compress

active = init_distributed()
assert active, "distributed init did not activate"
data = open(sys.argv[1], "rb").read()
out = pod_compress(data, block_size=4096, inner="lzss", shared_table=(sys.argv[3] == "1"))
import jax
assert jax.process_count() == 2, jax.process_count()
if jax.process_index() == 0:
    open(sys.argv[2], "wb").write(out)
else:
    assert out is None
"""


def _run_two_process(worker, data_file, out_file, extra_args=()):
    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.update(
            {
                "JAX_PLATFORMS": "cpu",
                "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
                "TDC_NUM_PROCESSES": "2",
                "TDC_PROCESS_ID": str(pid),
                "TDC_COORDINATOR": f"127.0.0.1:{port}",
                "PYTHONPATH": REPO,
            }
        )
        procs.append(
            subprocess.Popen(
                [sys.executable, "-c", worker, str(data_file), str(out_file)]
                + list(extra_args),
                env=env,
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
                text=True,
            )
        )
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{so[-2000:]}\n{se[-2000:]}"


def test_two_process_lzss_matches_single_process(tmp_path):
    """blockwise lzss_lcp(huff) across 2 processes (BASELINE config 5):
    container byte-identical to the 1-process runtime path, for both the
    independent and the shared-psum'd-table variants, and decodable."""
    rng = np.random.default_rng(3)
    data = (b"mesh lzss block parallel " * 900) + bytes(
        rng.integers(0, 256, 6000).astype(np.uint8)
    )
    data_file = tmp_path / "input.bin"
    data_file.write_bytes(data)

    from tudocomp_tpu.driver import decompress
    from tudocomp_tpu.parallel.blocks import unframe_streams
    from tudocomp_tpu.parallel.runtime import blockwise_lzss_compress

    for shared in ("0", "1"):
        out_file = tmp_path / f"container{shared}.bin"
        _run_two_process(WORKER_LZSS, data_file, out_file, (shared,))
        container = out_file.read_bytes()
        ref = blockwise_lzss_compress(
            data, 4096, shared_table=(shared == "1")
        )
        assert container == ref, f"shared={shared}"
        _, payloads = unframe_streams(container)
        decoded = b"".join(
            decompress(p, id_string="lzss_lcp(coder=huff)", raw=True)
            for p in payloads
        )
        assert decoded == data, f"shared={shared}"
