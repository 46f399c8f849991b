"""Logging, timing and lightweight observability.

Behavioral equivalent of the reference's console layer
(include/common/common.hpp:92-205: message/submessage/error, verbose-only
log/status pairs, Timer) rebuilt on Python logging, plus JAX memory stats in
place of malloc_count's mem_peak (include/common/common.hpp:118-120).
"""

from __future__ import annotations

import contextlib
import logging
import os
import sys
import time
from pathlib import Path

_FMT = "[%(levelname)s] %(name)s: %(message)s"


def get_logger(name: str = "colbwt", verbose: bool | None = None) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(_FMT))
        logger.addHandler(h)
        logger.setLevel(logging.INFO)
    if verbose is not None:
        logger.setLevel(logging.DEBUG if verbose else logging.INFO)
    return logger


class Timer:
    """Wall-clock stage timer (reference Timer, include/common/common.hpp:129-174)."""

    def __init__(self) -> None:
        self._start = 0.0
        self._mid = 0.0
        self._end = 0.0

    def start(self) -> "Timer":
        self._start = time.perf_counter()
        return self

    def mid(self) -> None:
        self._mid = time.perf_counter()

    def end(self) -> None:
        self._end = time.perf_counter()

    @property
    def start_duration(self) -> float:
        return self._end - self._start

    @property
    def mid_duration(self) -> float:
        return self._end - self._mid


@contextlib.contextmanager
def status(msg: str, logger: logging.Logger | None = None):
    """Phase timing context: logs "<msg>... DONE (Xs)" at DEBUG level.

    Equivalent of the status()/status() bracket pair at
    include/common/common.hpp:193-205.
    """
    logger = logger or get_logger()
    logger.debug("%s...", msg)
    t0 = time.perf_counter()
    yield
    logger.debug("%s DONE (%.3fs)", msg, time.perf_counter() - t0)


# the compile cache's home when JAX_COMPILATION_CACHE_DIR is unset: one fixed
# path inside the checkout (the path is part of the cache key, so a moving
# directory would never hit); listed in .gitignore
DEFAULT_COMPILE_CACHE = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compilation_cache() -> None:
    """Persistent XLA compilation cache: later processes (CLI runs, the
    MUM-scan workers) reuse compiled query and scan programs instead of
    compiling them again.  JAX reads JAX_COMPILATION_CACHE_DIR itself, so a
    directory is set here only when that variable is absent."""
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        DEFAULT_COMPILE_CACHE.mkdir(exist_ok=True)
        jax.config.update("jax_compilation_cache_dir",
                          str(DEFAULT_COMPILE_CACHE))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


def device_mem_peak() -> dict:
    """Per-device memory stats, the device-side stand-in for malloc_count's
    peak RSS."""
    import jax

    out = {}
    for d in jax.devices():
        try:
            stats = d.memory_stats() or {}
        except Exception:
            stats = {}
        out[str(d)] = {
            k: stats[k]
            for k in ("bytes_in_use", "peak_bytes_in_use", "bytes_limit")
            if k in stats
        }
    return out
