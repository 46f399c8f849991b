"""Device-layout table persistence: save built query-engine tables
(pos/mega/mega-wide) next to the index and reload them on later launches,
skipping the multi-GB on-device rebuild that every new process would
otherwise pay.

Artifacts live in `<index_prefix>.tables/<kind>/`: one raw `.npy` per array
plus `meta.json` carrying a format version, an index fingerprint (content
CRC over the run arrays — a stale cache next to a rebuilt index is
rejected), per-key placement (device / host / scalar), and the build wall
time the artifact replaces, so the load path can report an honest
saved-vs-spent comparison.

Whether loading beats rebuilding depends on the host link and the device:
a multi-GB read + upload competes with ~1e9 chained device gathers.  So the
policy is MEASURED, not assumed: h2d_bandwidth() times one ~32 MB chunked
upload per process, and QueryEngines loads/saves only when the projected
transfer time beats the recorded build time (events logged either way).
cfg.table_cache="off" disables the whole mechanism.
"""

from __future__ import annotations

import json
import zlib
from pathlib import Path

import numpy as np

TABLES_FORMAT = 2  # 2: wide mega rows went 17 -> 16 columns (match in _MC)


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).view(np.uint8))


def index_fingerprint(index) -> str:
    """Content fingerprint of the run arrays the tables are built from.
    Full CRC of the r-sized char array plus a strided sample of idx keeps
    this O(r) cheap (< 1 s at r = 38M) while catching any rebuild."""
    step = max(1, index.r // 65536)
    parts = (
        index.n, index.r, index.bwt_r, index.ff_bound, index.sigma,
        int(index.wide),
        _crc(index.char), _crc(index.idx[::step]),
        _crc(index.threshold[::step]), _crc(index.col_id[::step]),
    )
    return "-".join(str(p) for p in parts)


_BW_CACHE: float | None = None


def h2d_bandwidth(sample_bytes: int = 32 << 20) -> float:
    """Host->device bandwidth in bytes/s, measured ONCE per process with a
    chunked upload of random int32s (random so a compressing transport
    can't flatter the number).

    Adaptive two-stage probe: a 2 MB canary first — if the link is slow
    (< 8 MB/s) its number already decides every load-vs-rebuild question
    by an order of magnitude, so the big sample is skipped and a degraded
    link costs the probe ~16x less time."""
    global _BW_CACHE
    if _BW_CACHE is None:
        import time

        from colbwt_tpu.utils.xfer import device_put_chunked

        def measure(nbytes: int) -> float:
            a = np.random.default_rng(0).integers(
                0, 2**31 - 1, nbytes // 4, dtype=np.int32)
            t0 = time.perf_counter()
            device_put_chunked(a).block_until_ready()
            return a.nbytes / max(time.perf_counter() - t0, 1e-9)

        measure(64 << 10)  # warmup: first-touch backend init must not be
        # billed to the canary (it would mimic a slow link on PCIe hosts)
        canary = measure(2 << 20)
        _BW_CACHE = (canary if canary < (8 << 20)
                     else measure(sample_bytes))
    return _BW_CACHE


def peek(dir_: str | Path, kind: str, index) -> dict | None:
    """Validate a cache entry WITHOUT uploading: returns its meta plus
    `dev_bytes` (total bytes destined for the device) so callers can make
    the bandwidth decision first, or None on any mismatch."""
    d = Path(dir_) / kind
    mf = d / "meta.json"
    if not mf.exists():
        return None
    try:
        meta = json.loads(mf.read_text())
    except (json.JSONDecodeError, OSError):
        return None
    if meta.get("format") != TABLES_FORMAT or meta.get("kind") != kind:
        return None
    if meta.get("fingerprint") != index_fingerprint(index):
        return None
    if not isinstance(meta.get("keys"), dict):
        return None  # truncated meta.json: treat as invalid cache
    dev_bytes = 0
    for key, spec in meta["keys"].items():
        if spec["place"] == "dev":
            f = d / f"{key}.npy"
            if not f.exists():
                return None
            dev_bytes += f.stat().st_size
    meta["dev_bytes"] = dev_bytes
    return meta


def _placement(v) -> str:
    import jax

    if isinstance(v, jax.Array) and v.ndim >= 1:
        return "dev"
    if isinstance(v, jax.Array):  # 0-d scalar
        return "jscalar"
    if isinstance(v, np.ndarray):
        return "host"
    return "py"


def save_tables(dir_: str | Path, kind: str, index, tables: dict,
                build_seconds: float | None = None) -> Path:
    """Persist one engine's table dict.  Device arrays are materialized to
    raw .npy (np.asarray downloads them); scalars and python values go in
    meta.json.  Writes are staged under a temp name and renamed so a killed
    process never leaves a half-written cache that load_tables accepts."""
    import jax.numpy as jnp  # noqa: F401  (placement needs jax imported)

    d = Path(dir_) / kind
    tmp = d.with_name(d.name + ".tmp")
    if tmp.exists():
        import shutil

        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    meta: dict = {
        "format": TABLES_FORMAT,
        "kind": kind,
        "fingerprint": index_fingerprint(index),
        "build_seconds": build_seconds,
        "keys": {},
    }
    for key, v in tables.items():
        place = _placement(v)
        if place in ("dev", "host"):
            np.save(tmp / f"{key}.npy", np.asarray(v))
            meta["keys"][key] = {"place": place}
        elif place == "jscalar":
            meta["keys"][key] = {"place": place, "value": int(np.asarray(v)),
                                 "dtype": str(v.dtype)}
        else:
            if isinstance(v, bytes):
                meta["keys"][key] = {"place": "bytes", "value": v.hex()}
            else:
                meta["keys"][key] = {"place": "py", "value": v}
    (tmp / "meta.json").write_text(json.dumps(meta))
    if d.exists():
        import shutil

        shutil.rmtree(d)
    tmp.rename(d)
    return d


def load_tables(dir_: str | Path, kind: str, index
                ) -> tuple[dict, dict] | None:
    """Reload a persisted table dict as (tables, info), or None on any
    mismatch (absent, version bump, fingerprint change).  Device arrays
    stream up via device_put_chunked from an mmap'd .npy — no full host
    copy.  `tables` carries EXACTLY the keys that were saved (the mega/wide
    dicts are passed wholesale into jit as pytrees — extra metadata leaves
    would change the tree structure); cache provenance goes in `info`."""
    import jax.numpy as jnp

    from colbwt_tpu.utils.xfer import device_put_chunked

    d = Path(dir_) / kind
    mf = d / "meta.json"
    if not mf.exists():
        return None
    try:
        meta = json.loads(mf.read_text())
    except (json.JSONDecodeError, OSError):
        return None
    if meta.get("format") != TABLES_FORMAT or meta.get("kind") != kind:
        return None
    if meta.get("fingerprint") != index_fingerprint(index):
        return None
    if not isinstance(meta.get("keys"), dict):
        return None  # truncated meta.json: treat as invalid cache
    out: dict = {}
    for key, spec in meta["keys"].items():
        place = spec["place"]
        if place == "dev":
            host = np.load(d / f"{key}.npy", mmap_mode="r")
            out[key] = device_put_chunked(host)
        elif place == "host":
            out[key] = np.load(d / f"{key}.npy")
        elif place == "jscalar":
            out[key] = jnp.asarray(spec["value"]).astype(spec["dtype"])
        elif place == "bytes":
            out[key] = bytes.fromhex(spec["value"])
        else:
            out[key] = spec["value"]
    return out, {"build_seconds": meta.get("build_seconds")}
