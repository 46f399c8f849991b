"""colbwt_tpu — a pangenomic matching engine in JAX.

A from-scratch JAX/XLA re-design of the capabilities of col-bwt
(drnatebrown/col-bwt): a run-length-compressed BWT full-text index over a
collection of genomes, augmented with multi-MUM co-linearity ("col") IDs,
answering per-base *pseudo matching length* (PML) and *chain statistic* (CID)
queries in O(m) steps per pattern — batched data-parallel over thousands of
reads per device.

Layout
------
- ``colbwt_tpu.io``       on-disk format codecs (5-byte ints, RLBWT, sdsl
                          bitvectors, FASTA, .col_mums, PML/CID writers)
- ``colbwt_tpu.ops``      the compute kernels: suffix array / LCP / multi-MUM
                          construction, col-split FL walking, and the batched
                          query engines (plain jnp/lax, compiled by XLA)
- ``colbwt_tpu.models``   index data structures (move tables, the queryable
                          ColPmlIndex) as structure-of-arrays device arrays
- ``colbwt_tpu.parallel`` device-mesh sharding: data-parallel reads and
                          interval-sharded index with collective row assembly
- ``colbwt_tpu.pipeline`` the staged build pipeline (artifact-checkpointed,
                          resumable — mirrors scripts/col-bwt.py:94-189 of the
                          reference in behavior, not implementation)
- ``colbwt_tpu.utils``    config, logging, timers

The reference's C++ headers (include/col_bwt.hpp, include/ds/LF_table.hpp,
include/col_split.hpp at the upstream repo) define the *semantics* targeted
here; the implementation is batch- and device-first and shares no code with
them.
"""

__version__ = "0.1.0"

from colbwt_tpu.utils.config import ColBwtConfig, SplitMode  # noqa: F401
