"""Device memory budget discovery.

The positional-automaton tables are sized against a device byte budget
(utils/config.pos_hbm_budget).  A fixed constant wastes most of a large
card and overcommits a small one, so the default (pos_hbm_budget == 0)
derives the budget from the device itself: the allocator's `bytes_limit`
from `memory_stats()`.  On a GPU that limit already reflects JAX's
preallocation fraction (XLA_PYTHON_CLIENT_MEM_FRACTION, 75% by default).
An accelerator that reports no limit is an error, never a guess.  The CPU
backend has no device memory to discover and gets the named CPU_POS_BUDGET.
"""

from __future__ import annotations

# budget for CPU runs (tests, host-only debugging); host RAM is not probed
CPU_POS_BUDGET = 10 << 30
_RESERVE_FRACTION = 0.75  # leave room for batches, outputs, XLA temps


def device_memory_bytes(device=None) -> int | None:
    """Allocator limit of `device` (default: first device) in bytes, or
    None on the CPU backend.  Raises when an accelerator reports none."""
    import jax

    d = device if device is not None else jax.devices()[0]
    if d.platform == "cpu":
        return None
    limit = (d.memory_stats() or {}).get("bytes_limit")
    if not limit:
        raise RuntimeError(
            f"device {d} ({d.platform}, {d.device_kind!r}) reports no "
            "memory_stats()['bytes_limit']; set pos_hbm_budget explicitly")
    return int(limit)


def resolve_pos_budget(configured: int, device=None) -> int:
    """Effective pos-table budget: the configured value when positive, else
    _RESERVE_FRACTION of the device's allocator limit, else (CPU backend)
    CPU_POS_BUDGET."""
    if configured > 0:
        return configured
    total = device_memory_bytes(device)
    if total is None:
        return CPU_POS_BUDGET
    return int(total * _RESERVE_FRACTION)


def require_no_device_held(what: str) -> None:
    """Fail loudly before starting a child process (`what`) that opens the
    accelerator while this process already holds it: a JAX process reserves
    most of a GPU's memory when it first uses it, so the child would fail
    for want of memory.  A process on the CPU backend holds no card."""
    import jax
    # JAX has no public query for "is a backend up" that does not start one
    from jax._src import xla_bridge

    if xla_bridge.backends_are_initialized() and jax.default_backend() != "cpu":
        raise RuntimeError(
            f"{what}: this process already holds the {jax.default_backend()} "
            "device; start the child before any device work, or run it with "
            "JAX_PLATFORMS=cpu")


def host_ram_bytes() -> int | None:
    """Total host RAM from /proc/meminfo (None when unreadable)."""
    try:
        for line in open("/proc/meminfo"):
            if line.startswith("MemTotal:"):
                return int(line.split()[1]) * 1024
    except OSError:
        pass
    return None


# monolithic SA-IS + Kasai working set, measured at n = 2.3e9 (~90 GB)
_SA_BYTES_PER_CHAR = 40


def resolve_sa_budget_chars(configured: int) -> int:
    """Character budget for monolithic host suffix-array construction: the
    configured value when positive, else 60% of host RAM / 40 B per char
    (conservative: leaves room for the merged arrays and the OS)."""
    if configured > 0:
        return configured
    total = host_ram_bytes()
    if total is None:
        return 1 << 30
    return int(total * 0.6) // _SA_BYTES_PER_CHAR
