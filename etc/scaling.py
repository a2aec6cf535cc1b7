#!/usr/bin/env python3
"""Block-parallel scaling report (SURVEY.md §2.11 item 4).

Measures the DP block-encode pipeline at 1, 2, 4, ... devices and reports
throughput + scaling efficiency. On a multi-GPU host this runs over the
actual mesh (multi-host after jax.distributed.initialize); without an
accelerator pass --cpu N to simulate N virtual devices
(xla_force_host_platform_device_count), which validates the sharding and
collective structure (efficiency numbers are then only indicative —
virtual CPU devices share cores).

Usage:
    python etc/scaling.py [--cpu 8] [--mb 64] [--bs 262144] [--shared]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", type=int, default=0, help="simulate N CPU devices")
    ap.add_argument("--mb", type=float, default=64)
    ap.add_argument("--bs", type=int, default=1 << 18)
    ap.add_argument("--shared", action="store_true")
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args()

    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
        flags = os.environ.get("XLA_FLAGS", "")
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={args.cpu}"
        ).strip()

    from tudocomp_tpu.device import ensure_compile_cache

    ensure_compile_cache()
    import jax
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from tudocomp_tpu.parallel.blocks import pad_block_count, split_blocks
    from tudocomp_tpu.parallel.runtime import dp_mesh, make_block_encoder

    devices = jax.devices()
    rng = np.random.default_rng(0)
    n = int(args.mb * (1 << 20))
    data = rng.zipf(1.3, n).clip(0, 255).astype(np.uint8).tobytes()
    n_words = (9 * args.bs + 4096 + 31) // 32

    results = []
    d = 1
    while d <= len(devices):
        mesh = dp_mesh(devices[:d])
        blocks, n_valid = split_blocks(data, args.bs)
        blocks, n_valid, _ = pad_block_count(blocks, n_valid, d)
        step = make_block_encoder(mesh, n_words, shared_table=args.shared)
        db = jax.device_put(blocks, NamedSharding(mesh, P("dp", None)))
        dv = jax.device_put(n_valid, NamedSharding(mesh, P("dp")))
        jax.block_until_ready(step(db, dv))  # compile + warm
        t0 = time.perf_counter()
        outs = [step(db, dv) for _ in range(args.iters)]
        jax.block_until_ready(outs)
        dt = (time.perf_counter() - t0) / args.iters
        gbps = n / dt / 1e9
        results.append({"devices": d, "gbps": round(gbps, 4)})
        base = results[0]["gbps"]
        eff = gbps / (base * d) if base else 0.0
        print(
            f"devices={d:3d}  {gbps:8.3f} GB/s  scaling efficiency "
            f"{eff*100:6.1f}%",
            flush=True,
        )
        d *= 2

    print(json.dumps({
        "metric": "blockwise_huffman_encode_scaling",
        "block_size": args.bs,
        "shared_table": args.shared,
        "results": results,
    }))


def lzss_scaling(args):
    """Multi-process scaling of the blockwise lzss_lcp(huff) mesh path:
    spawns 1 and N jax.distributed processes over localhost and times the
    collective blockwise_lzss_compress run (CPU simulation; on a pod the
    same code path rides the real slice)."""
    import socket
    import subprocess
    import tempfile

    import numpy as np

    rng = np.random.default_rng(0)
    n = int(args.mb * (1 << 20))
    data = rng.zipf(1.3, n).clip(0, 255).astype(np.uint8).tobytes()
    with tempfile.TemporaryDirectory() as td:
        data_file = os.path.join(td, "in.bin")
        with open(data_file, "wb") as f:
            f.write(data)
        worker = (
            "import os, sys, time\n"
            "import numpy as np\n"
            "from tudocomp_tpu.parallel.distributed import init_distributed\n"
            "init_distributed()\n"
            # runtime imports must follow init (backend-initializing)
            "from tudocomp_tpu.parallel.runtime import blockwise_lzss_compress\n"
            "data = open(sys.argv[1], 'rb').read()\n"
            "bs, shared = int(sys.argv[2]), sys.argv[3] == '1'\n"
            "blockwise_lzss_compress(data, bs, shared_table=shared)\n"
            "t0 = time.perf_counter()\n"
            "blockwise_lzss_compress(data, bs, shared_table=shared)\n"
            "print('ELAPSED', time.perf_counter() - t0)\n"
        )
        results = []
        for procs in (1, args.procs):
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
            s.close()
            ps = []
            for pid in range(procs):
                env = dict(os.environ)
                env.update({
                    "JAX_PLATFORMS": "cpu",
                    "TDC_NUM_PROCESSES": str(procs),
                    "TDC_PROCESS_ID": str(pid),
                    "TDC_COORDINATOR": f"127.0.0.1:{port}",
                    "PYTHONPATH": REPO,
                })
                if procs == 1:
                    env.pop("TDC_NUM_PROCESSES")
                ps.append(subprocess.Popen(
                    [sys.executable, "-c", worker, data_file, str(args.bs),
                     "1" if args.shared else "0"],
                    env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True,
                ))
            dt = None
            for p in ps:
                out, err = p.communicate(timeout=600)
                if p.returncode != 0:
                    raise RuntimeError(f"worker failed:\n{err[-2000:]}")
                for line in out.splitlines():
                    if line.startswith("ELAPSED"):
                        dt = max(dt or 0.0, float(line.split()[1]))
            gbps = n / dt / 1e9
            results.append({"processes": procs, "gbps": round(gbps, 4)})
            base = results[0]["gbps"]
            eff = gbps / (base * procs) if base else 0.0
            print(f"processes={procs:3d}  {gbps:8.3f} GB/s  scaling "
                  f"efficiency {eff*100:6.1f}%", flush=True)
        print(json.dumps({
            "metric": "blockwise_lzss_huff_scaling",
            "block_size": args.bs,
            "shared_table": args.shared,
            "results": results,
        }))


if __name__ == "__main__":
    if "--lzss" in sys.argv:
        sys.argv.remove("--lzss")
        ap = argparse.ArgumentParser()
        ap.add_argument("--mb", type=float, default=16)
        ap.add_argument("--bs", type=int, default=1 << 18)
        ap.add_argument("--shared", action="store_true")
        ap.add_argument("--procs", type=int, default=2)
        lzss_scaling(ap.parse_args())
    else:
        main()
