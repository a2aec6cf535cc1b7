"""StatPhase: nested RAII-style phases with wall time + memory stats.

Mirror of include/tudocomp_stat/StatPhase.hpp:44-322 and PhaseData.hpp: a
tree of phases, each measuring wall-clock ms and heap deltas, with custom
key/value stats and JSON export in the exact schema consumed by tudocomp's
Charter web app (www/charter/).

Memory parity (src/tudocomp_stat/malloc.cpp:24-84 gives the reference
per-phase heap off/current/peak via a malloc override): the rebuild tracks
host heap with tracemalloc — numpy routes its buffer allocations through
PyTraceMalloc, so array workloads are fully visible. The CLI enables it
for every --stats run (so the stats JSON always carries the memory
columns); plain runs skip it because tracemalloc, unlike the reference's
near-free C override, taxes every allocation. Nested phases propagate their
absolute peak to ancestors so a parent's memPeak covers its children even
though tracemalloc has a single global peak counter. Device memory
(jax device.memory_stats(), a device query per phase) is opt-in via
StatPhase.track_device_memory / TDC_DEVICE_MEMSTATS=1 and reported as
extra stats keys.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import tracemalloc
from typing import Any, Optional

_LOG = logging.getLogger("tudocomp_tpu.stats")

# the open-phase cursor is thread-local: worker threads (e.g. the
# blockwise thread pools) each get an independent phase stack, so
# concurrent phases never corrupt the main tree; per-thread phases simply
# form detached trees that are not aggregated into the main --stats output
_tls = threading.local()


def _get_current() -> Optional["StatPhase"]:
    return getattr(_tls, "current", None)


def _set_current(phase: Optional["StatPhase"]) -> None:
    _tls.current = phase
_started_tracing = False


def _now_ms() -> float:
    return time.monotonic() * 1000.0


def _device_mem() -> int:
    try:
        import jax

        stats = jax.devices()[0].memory_stats()
        if stats:
            return int(stats.get("bytes_in_use", 0))
    except Exception:
        pass
    return 0


def _ensure_tracing() -> bool:
    """Activate a heap-accounting backend; returns whether one is active.

    Preferred backend: the LD_PRELOAD malloc interposer
    (native/tdc_memhook.c — byte-accurate like the reference's link-time
    override, covers numpy/JAX/native allocations from any thread; the
    CLI re-execs with it when TDC_MALLOC_HOOK=1). Fallback: tracemalloc
    (Python-level allocations only, including numpy buffers via
    PyTraceMalloc).
    """
    global _started_tracing
    if _memhook() is not None:
        return True
    if tracemalloc.is_tracing():
        return True
    try:
        tracemalloc.start()
        _started_tracing = True
        return True
    except Exception:
        return False


_memhook_cache = None


def _memhook():
    global _memhook_cache
    if _memhook_cache is None:
        from .. import native

        _memhook_cache = native.memhook_counters() or False
    return _memhook_cache or None


def _mem_read():
    """(current_bytes, peak_bytes) from the active backend."""
    h = _memhook()
    if h is not None:
        return int(h[0]()), int(h[1]())
    return tracemalloc.get_traced_memory()


def _mem_reset_peak():
    h = _memhook()
    if h is not None:
        h[2]()
    else:
        tracemalloc.reset_peak()


def _mem_active() -> bool:
    return _memhook() is not None or tracemalloc.is_tracing()


class StatPhase:
    """Nested timing phase. Use as context manager or via StatPhase.wrap."""

    # host-heap tracking: enabled whenever stats are actually consumed
    # (the CLI turns it on for --stats runs; force with TDC_TRACK_MEM=1,
    # forbid with =0). Unlike the reference's near-free C malloc override,
    # tracemalloc taxes every allocation, so library use without stats
    # stays untracked by default.
    track_memory = os.environ.get("TDC_TRACK_MEM", "0") == "1"
    track_device_memory = os.environ.get("TDC_DEVICE_MEMSTATS") == "1"

    def __init__(self, title: str):
        self.title = title
        self.children: list[StatPhase] = []
        self.stats: dict[str, Any] = {}
        self.time_start = 0.0
        self.time_end = 0.0
        self.mem_off = 0
        self.mem_current = 0
        self.mem_peak = 0
        self._parent: Optional[StatPhase] = None
        self._abs_peak = 0
        self._tracing = False
        self._paused = 0.0

    # -- lifecycle ------------------------------------------------------------

    def __enter__(self) -> "StatPhase":
        self._parent = _get_current()
        if self._parent is not None:
            self._parent.children.append(self)
        _set_current(self)
        if StatPhase.track_memory and _ensure_tracing():
            self._tracing = True
            cur, peak = _mem_read()
            # the open peak window belongs to the parent; hand it over
            # before resetting for this phase
            if self._parent is not None and self._parent._tracing:
                self._parent._abs_peak = max(self._parent._abs_peak, peak)
            _mem_reset_peak()
            self.mem_off = cur
            self._abs_peak = cur
        if StatPhase.track_device_memory:
            self.stats["devMemOff"] = _device_mem()
        self.time_start = _now_ms()
        return self

    def __exit__(self, *exc) -> bool:
        self.time_end = _now_ms()
        if self._tracing and _mem_active():
            cur, peak = _mem_read()
            self._abs_peak = max(self._abs_peak, peak, cur)
            self.mem_current = cur - self.mem_off
            self.mem_peak = max(0, self._abs_peak - self.mem_off)
            if self._parent is not None and self._parent._tracing:
                self._parent._abs_peak = max(
                    self._parent._abs_peak, self._abs_peak
                )
            # fresh window for whatever the parent does next
            _mem_reset_peak()
        if StatPhase.track_device_memory:
            self.stats["devMemFinal"] = _device_mem()
        _set_current(self._parent)
        # DVLOG analogue: per-phase timing at DEBUG (wired to --logverbosity)
        _LOG.debug("phase %r: %.3f ms", self.title, self.time_end - self.time_start)
        return False

    @staticmethod
    def wrap(title: str, fn, *args, **kwargs):
        with StatPhase(title):
            return fn(*args, **kwargs)

    @staticmethod
    def current() -> Optional["StatPhase"]:
        return _get_current()

    def split(self, title: str) -> "StatPhase":
        """End-and-begin a sibling phase (StatPhase.hpp 'split')."""
        self.__exit__()
        nxt = StatPhase(title)
        nxt.__enter__()
        return nxt

    # -- custom stats ----------------------------------------------------------

    def log(self, key: str, value: Any) -> None:
        self.stats[str(key)[:64]] = value

    @staticmethod
    def log_current(key: str, value: Any) -> None:
        cur = _get_current()
        if cur is not None:
            cur.log(key, value)

    # -- export -----------------------------------------------------------------

    def to_dict(self) -> dict:
        """PhaseData JSON schema (PhaseData.hpp:66-111), Charter-compatible."""
        return {
            "title": self.title,
            "timeStart": self.time_start,
            "timeEnd": self.time_end,
            "memOff": self.mem_off,
            "memPeak": self.mem_peak,
            "memFinal": self.mem_current,
            "stats": [
                {"key": k, "value": str(v)} for k, v in self.stats.items()
            ],
            "sub": [c.to_dict() for c in self.children],
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict())
