"""Backend-conditional execution policy: device paths are the default on a GPU.

When an accelerator backend is present, compute-heavy stages (SA
construction, MTF/RLE transforms, ESP grammar rounds, Huffman block
encode/decode) run on the device by default, each above its size gate.
Host (native C++/numpy) paths remain the default on CPU-only installs,
where XLA:CPU loses to the tuned native code.

Per-stage env overrides (1 = force device, 0 = force host):
  TDC_DEVICE_SA, TDC_DEVICE_MTF, TDC_DEVICE_RLE, TDC_DEVICE_ESP,
  TDC_DEVICE_HUFF, TDC_DEVICE_LZSS, TDC_DEVICE_LCPCOMP

OPT-IN stages (=1 required), off by default until measured on the GPU:
  TDC_DEVICE_LZSS     compacted-chain ANSV factorize (ops/lzss_jax.py)
  TDC_DEVICE_LCPCOMP  lcpcomp device factorize / decode chain resolve
                      (ops/lcpcomp_jax.py)

TDC_NO_DEVICE=1 treats the backend as host-only.
"""

from __future__ import annotations

import os
import pathlib
import sys
from functools import lru_cache

__all__ = [
    "accelerator_backend",
    "ensure_compile_cache",
    "use_device",
]

_CHECKOUT_CACHE = pathlib.Path(__file__).resolve().parent.parent / ".jax_cache"


def ensure_compile_cache() -> str:
    """Point JAX's persistent compile cache at one fixed directory.

    JAX_COMPILATION_CACHE_DIR, when set, wins and is left alone (so does a
    directory already given to jax.config); otherwise the cache is
    <checkout>/.jax_cache. The sort-heavy staged kernels (SA, ESP) compile
    for tens of seconds, so caching is part of the device policy. Does not
    import JAX: before its import the default goes through the variable
    JAX reads at import time. Returns the directory in use."""
    explicit = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if explicit:
        return explicit
    jax = sys.modules.get("jax")
    if jax is None:
        os.environ["JAX_COMPILATION_CACHE_DIR"] = str(_CHECKOUT_CACHE)
        return str(_CHECKOUT_CACHE)
    if not jax.config.jax_compilation_cache_dir:
        jax.config.update("jax_compilation_cache_dir", str(_CHECKOUT_CACHE))
    return jax.config.jax_compilation_cache_dir


@lru_cache(maxsize=1)
def accelerator_backend() -> str | None:
    """The default JAX backend if it is an accelerator, else None.

    A backend that fails to initialise raises here: the device is never
    silently swapped for a host run. Cached: it cannot change within a
    process.
    """
    if os.environ.get("TDC_NO_DEVICE") == "1":
        return None
    import jax

    backend = jax.default_backend()
    return None if backend == "cpu" else backend


def use_device(env_var: str, min_n: int = 0, n: int | None = None) -> bool:
    """Should this stage run on device?

    Explicit env overrides win; otherwise device iff an accelerator is the
    default backend and the problem size reaches min_n (tiny inputs are
    dominated by dispatch latency).
    """
    v = os.environ.get(env_var)
    if v == "1":
        return True
    if v == "0":
        return False
    if accelerator_backend() is None:
        return False
    if n is not None and n < min_n:
        return False
    return True
