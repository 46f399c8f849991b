"""Test configuration: JAX on the CPU with 8 virtual devices, unless
JAX_PLATFORMS names another platform.

Must run before any jax import (SURVEY §4: multi-device tests via
xla_force_host_platform_device_count so N-way sharding runs on one host).
Tests that need a GPU are marked `gpu` and take the `gpu_device` fixture,
which skips without one; on a GPU host they run with
`JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0xC01B37)


@pytest.fixture
def gpu_device():
    """The first GPU, for tests marked `gpu`; skips where there is none.
    Decided here, at run time, never while test modules are imported."""
    import jax

    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs a GPU (JAX_PLATFORMS=cuda on a GPU host)")


def random_docs(rng, num_docs, lo=30, hi=120, alphabet=b"ACGT", mutate_from=None):
    """Random DNA-like documents; if mutate_from is set, documents are noisy
    copies of one ancestor (realistic pangenome shape: long shared MUMs)."""
    docs = []
    if mutate_from is not None:
        base = mutate_from
        for _ in range(num_docs):
            arr = bytearray(base)
            n_mut = max(1, len(arr) // 20)
            for _ in range(n_mut):
                p = int(rng.integers(0, len(arr)))
                arr[p] = alphabet[int(rng.integers(0, len(alphabet)))]
            docs.append(bytes(arr))
    else:
        for _ in range(num_docs):
            m = int(rng.integers(lo, hi))
            docs.append(bytes(alphabet[int(i)] for i in rng.integers(0, len(alphabet), m)))
    return docs
