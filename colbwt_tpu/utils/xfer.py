"""Host→device transfer helpers.

device_put_chunked ships big host arrays (mega/fused tables, large read
batches, persisted table-cache loads, MUM-scan chunks) as 16 MB row slices,
so no single transfer stages the whole array at once and an mmap-backed
source is read one slice at a time.  Whether the slicing costs or saves
time against one plain device_put on a PCIe-attached GPU is not measured
yet.

Peak-memory contract: chunks are written into ONE preallocated device
buffer that is donated back to each update, so peak device memory is the
destination array plus a single chunk — NOT 2x the array, which a
parts-then-concatenate formulation would cost.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

_CHUNK_BYTES = 16 * 1024 * 1024


@functools.partial(jax.jit, donate_argnums=(0,))
def _write_rows(buf, part, row0):
    return jax.lax.dynamic_update_slice(
        buf, part, (row0,) + (jnp.int32(0),) * (buf.ndim - 1))


def device_put_chunked(arr: np.ndarray, chunk_bytes: int = _CHUNK_BYTES,
                       dtype=None) -> jnp.ndarray:
    """device_put a large array as row slices written incrementally into a
    donated device buffer.  Accepts mmap-backed arrays without forcing a
    full host copy (each row slice is materialized per transfer)."""
    a = np.asarray(arr)
    if dtype is not None:
        a = a.astype(dtype, copy=False)
    if a.nbytes <= chunk_bytes or a.ndim == 0 or a.shape[0] < 2:
        return jnp.asarray(a)
    rows_per = max(1, chunk_bytes // max(a.nbytes // a.shape[0], 1))
    buf = jnp.zeros(a.shape, dtype=a.dtype)
    for i in range(0, a.shape[0], rows_per):
        part = jax.device_put(np.asarray(a[i:i + rows_per]))
        buf = _write_rows(buf, part, jnp.int32(i))
        del part
    return buf
