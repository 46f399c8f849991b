"""Device-mesh construction and sharding layouts.

The reference is single-node and effectively single-threaded (SURVEY §2.3);
this layer is new design (SURVEY §5.8):

- axis "dp" — data parallel over reads: the batch dimension of every
  per-read state/output array is sharded; reads never communicate.
- axis "ip" — index parallel over runs: the structure-of-arrays move table is
  sharded into contiguous run blocks; each query-step gather is answered by
  the owning shard and combined with one psum over "ip" (collective row
  assembly).  Replicate instead (ip=1) whenever the index fits one
  device's memory — gathers are then local and free of collectives.

Multi-host: build the mesh over jax.devices() after jax.distributed
initialization; read batches stream per-host (dp outer = process axis) and
PML/CID outputs are written per-host then concatenated in read order.
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from colbwt_tpu.models.index import ColPmlIndex


def make_mesh(dp: int, ip: int = 1, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    if dp * ip > len(devices):
        raise ValueError(f"mesh {dp}x{ip} needs {dp * ip} devices, "
                         f"have {len(devices)}")
    arr = np.asarray(devices[: dp * ip]).reshape(dp, ip)
    return Mesh(arr, axis_names=("dp", "ip"))


def pad_rows(index: ColPmlIndex, ip: int) -> dict[str, np.ndarray]:
    """Index fields with the run axis padded to a multiple of ip.

    Padding rows are inert: char = sigma (matches no read char, so no match
    and no jump hit), length = 1, dest = self-loops at the last real run.
    """
    r = index.r
    pad = (-r) % ip
    rp = r + pad

    def pad1(a, fill):
        out = np.full((rp,), fill, dtype=np.int32)
        out[:r] = a
        return out

    fields = {
        "char": pad1(index.char, index.sigma),
        "idx": pad1(index.idx, index.n - 1),
        "length": pad1(index.length, 1),
        "dest_interval": pad1(index.dest_interval, r - 1),
        "dest_offset": pad1(index.dest_offset, 0),
        "col_id": pad1(index.col_id, 0),
        "threshold": pad1(index.threshold, 0),
    }
    sig = index.pred_jump.shape[0]
    pj = np.full((sig, rp), -1, dtype=np.int32)
    pj[:, :r] = index.pred_jump
    sj = np.full((sig, rp), r, dtype=np.int32)
    sj[:, :r] = index.succ_jump
    # padding rows: pred = last real pred, succ = none
    if pad:
        pj[:, r:] = index.pred_jump[:, r - 1][:, None]
    fields["pred_jump"] = pj
    fields["succ_jump"] = sj
    return fields


def shard_index(index: ColPmlIndex, mesh: Mesh) -> dict:
    """Place index fields on the mesh: run axis sharded over "ip",
    replicated over "dp"."""
    ip = mesh.shape["ip"]
    fields = pad_rows(index, ip)
    out = {}
    for k, v in fields.items():
        spec = P(None, "ip") if v.ndim == 2 else P("ip")
        out[k] = jax.device_put(v, NamedSharding(mesh, spec))
    out["n"] = index.n
    out["r"] = index.r
    out["r_padded"] = fields["char"].shape[0]
    return out


def shard_reads(patterns: np.ndarray, lengths: np.ndarray, mesh: Mesh):
    """Shard a (B, M) read batch over "dp" (B must divide by dp)."""
    dp = mesh.shape["dp"]
    if patterns.shape[0] % dp:
        raise ValueError(f"batch {patterns.shape[0]} not divisible by dp={dp}")
    ps = jax.device_put(patterns, NamedSharding(mesh, P("dp", None)))
    ls = jax.device_put(lengths, NamedSharding(mesh, P("dp")))
    return ps, ls
