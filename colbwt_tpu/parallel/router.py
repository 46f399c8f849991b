"""Sharded-engine routing: pick the right distributed engine for an index.

Mirrors the single-device ladder in pipeline.engines (pos > mega > per-field),
extended with the wide lane: a wide index (n >= 2**31) routes to the
interval-sharded two-limb engine instead of being rejected.  Per-shard HBM
budgets come from utils.hbm unless given.

| index | engine | module |
|---|---|---|
| narrow, pos tables fit per-shard | sharded-pos (k chars/psum) | query_sharded_pos |
| narrow, run-split (ff_bound>=2)  | sharded-mega (1 psum/step) | query_sharded_mega |
| narrow fallback                  | per-field sharded          | query_sharded |
| wide (n >= 2**31)                | sharded-mega-wide (limbs)  | query_sharded_mega_wide |
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh

from colbwt_tpu.models.index import ColPmlIndex
from colbwt_tpu.parallel.mesh import make_mesh


def choose_sharded_engine(index: ColPmlIndex, ip: int,
                          hbm_budget_bytes: int | None = None) -> str:
    from colbwt_tpu.parallel.query_sharded_pos import choose_k_sharded

    if hbm_budget_bytes is None:
        from colbwt_tpu.utils.hbm import resolve_pos_budget

        hbm_budget_bytes = resolve_pos_budget(0)
    if index.wide:
        if index.ff_bound < 2:
            raise ValueError("wide index lacks run splitting (ff_bound < 2);"
                             " rebuild with ColPmlIndex.build")
        return "sharded-mega-wide"
    if choose_k_sharded(index, ip, hbm_budget_bytes) >= 1:
        return "sharded-pos"
    if index.ff_bound >= 2:
        return "sharded-mega"
    return "sharded"


def query_batch_sharded_auto(index: ColPmlIndex, patterns: list[bytes],
                             mesh: Mesh | None = None, dp: int | None = None,
                             ip: int = 1, max_len: int | None = None,
                             hbm_budget_bytes: int | None = None,
                             engine: str | None = None):
    """Route a read batch to the best sharded engine for `index`.

    Returns (pmls, cids, engine_name)."""
    if mesh is None:
        dp = dp or len(jax.devices()) // ip
        mesh = make_mesh(dp, ip)
    name = engine or choose_sharded_engine(index, mesh.shape["ip"],
                                           hbm_budget_bytes)
    if name == "sharded-mega-wide":
        from colbwt_tpu.parallel.query_sharded_mega_wide import (
            query_batch_sharded_mega_wide)

        p, c = query_batch_sharded_mega_wide(index, patterns, mesh=mesh,
                                             max_len=max_len)
    elif name == "sharded-pos":
        from colbwt_tpu.parallel.query_sharded_pos import (
            query_batch_sharded_pos)

        p, c = query_batch_sharded_pos(index, patterns, mesh=mesh,
                                       max_len=max_len)
    elif name == "sharded-mega":
        from colbwt_tpu.parallel.query_sharded_mega import (
            query_batch_sharded_mega)

        p, c = query_batch_sharded_mega(index, patterns, mesh=mesh,
                                        max_len=max_len)
    elif name == "sharded":
        from colbwt_tpu.parallel.query_sharded import query_batch_sharded

        p, c = query_batch_sharded(index, patterns, mesh=mesh,
                                   max_len=max_len)
    else:
        raise ValueError(f"unknown sharded engine {name!r}")
    return p, c, name
