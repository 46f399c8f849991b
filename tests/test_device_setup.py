"""Device discovery, compile-cache placement, the one-process-per-card
guard, and chip_smoke.py's phases at toy size on the CPU."""

import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
from colbwt_tpu.utils import hbm, log

REPO = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# compile cache
# ---------------------------------------------------------------------------


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch):
    """Without JAX_COMPILATION_CACHE_DIR the cache goes to one fixed path
    inside the checkout — never a temp, pid or time dependent one."""
    import jax

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    log.enable_compilation_cache()
    assert log.DEFAULT_COMPILE_CACHE == REPO / ".jax_cache"
    assert jax.config.jax_compilation_cache_dir == str(REPO / ".jax_cache")
    assert log.DEFAULT_COMPILE_CACHE.is_dir()
    assert not str(log.DEFAULT_COMPILE_CACHE).startswith(
        tempfile.gettempdir())
    assert str(os.getpid()) not in str(log.DEFAULT_COMPILE_CACHE)
    assert ".jax_cache/" in (REPO / ".gitignore").read_text()


def test_compile_cache_lands_in_env_dir(tmp_path):
    """A fresh process with JAX_COMPILATION_CACHE_DIR set writes its
    compiled programs there and sets no directory of its own."""
    cache = tmp_path / "cc"
    code = (
        "import jax\n"
        "from colbwt_tpu.utils.log import enable_compilation_cache\n"
        "enable_compilation_cache()\n"
        f"assert jax.config.jax_compilation_cache_dir == {str(cache)!r}\n"
        "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0)\n"
        "jax.jit(lambda x: x * 3 + 1)(jax.numpy.arange(7)).block_until_ready()\n")
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(cache),
               JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=tmp_path, timeout=120)
    assert any(cache.iterdir())


# ---------------------------------------------------------------------------
# one process per card
# ---------------------------------------------------------------------------


def test_worker_guard_allows_cpu_backend():
    import jax

    jax.devices()  # the CPU backend is initialized: holds no card
    hbm.require_no_device_held("test child")


def _pretend_gpu_held(monkeypatch):
    import jax
    from jax._src import xla_bridge

    monkeypatch.setattr(xla_bridge, "backends_are_initialized", lambda: True)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")


def test_worker_guard_refuses_held_gpu(monkeypatch):
    _pretend_gpu_held(monkeypatch)
    with pytest.raises(RuntimeError, match="already holds the gpu"):
        hbm.require_no_device_held("test child")


def test_mum_scan_workers_refuse_held_gpu(monkeypatch, tmp_path):
    """The streamed MUM scan checks before it spawns its first worker."""
    from colbwt_tpu.ops import mum_scan_stream as MS

    _pretend_gpu_held(monkeypatch)
    monkeypatch.setattr(subprocess, "run", lambda *a, **k: pytest.fail(
        "a worker was spawned"))
    with pytest.raises(RuntimeError, match="multi-MUM scan worker"):
        MS.find_multi_mums_streamed(tmp_path / "lcp.npy", tmp_path / "d.npy",
                                    tmp_path / "rc.npy", 2, 10)


# ---------------------------------------------------------------------------
# chip_smoke.py
# ---------------------------------------------------------------------------


def test_chip_smoke_refuses_cpu(capsys):
    assert chip_smoke.main(["--out", "unused"]) != 0
    out = capsys.readouterr()
    assert '"ok"' not in out.out
    assert "needs a GPU" in out.err


def test_chip_smoke_alone_fails(tmp_path):
    """Copied into a directory without the repo, the script exits non-zero
    and prints no ok line."""
    (tmp_path / "chip_smoke.py").write_bytes(
        (REPO / "chip_smoke.py").read_bytes())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def _seeded_data(seed):
    rng = np.random.default_rng(seed)
    docs = chip_smoke.make_genomes(rng, 3, 5000)
    return docs, chip_smoke.make_reads(rng, docs, 2000, 150)


def test_make_reads_shape_and_n_share():
    docs, reads = _seeded_data(3)
    assert [len(d) for d in docs] == [5000] * 3
    assert set(b"".join(docs)) <= set(b"ACGT")
    assert all(len(r) == 150 for r in reads)
    with_n = sum(b"N" in r for r in reads)
    assert 5 <= with_n <= 60  # ~1% of 2000
    assert _seeded_data(3) == (docs, reads)
    assert _seeded_data(4)[1] != reads


def test_check_counts_mismatches():
    ref = ([np.array([1, 2, 3])], [np.array([0, 5, 5])])
    chip_smoke.check("t", "same", ([np.array([1, 2, 3])],
                                   [np.array([0, 5, 5])]), {"ref": ref})
    with pytest.raises(AssertionError, match="mismatches"):
        chip_smoke.check("t", "off by one", ([np.array([1, 2, 4])],
                                             [np.array([0, 5, 5])]),
                         {"ref": ref})
    with pytest.raises(AssertionError, match="mismatches"):
        chip_smoke.check("t", "missing read", ([], []), {"ref": ref})


def test_chip_smoke_main_path_toy(tmp_path, capsys):
    res = chip_smoke.phase_main_path(tmp_path, 11, "cpu test", n_docs=3,
                                     doc_len=20_000, n_reads=400, sample=128)
    assert res["engine"].startswith("pos(")
    assert res["sampled"] >= 128
    out = capsys.readouterr().out
    assert "mismatches C++ 0" in out
    assert "build: multi-MUMs DONE" in out


def test_chip_smoke_engines_toy(capsys):
    chip_smoke.phase_engines(12, "cpu test", n_docs=2, doc_len=20_000,
                             batch=128, n_long=3, long_len=3000)
    out = capsys.readouterr().out
    for name in ("engine pos(k=", "engine mega ", "engine fused",
                 "engine xla", "engine mega-wide ", "general keys",
                 "mega long reads", "mega-wide long reads"):
        assert name in out, name
    assert "memory_analysis" in out


def test_chip_smoke_four_cards_toy(capsys):
    """The --four-cards phase on four of the virtual CPU devices."""
    chip_smoke.phase_four_cards(13, "cpu test", n_docs=2, doc_len=20_000,
                                batch=64)
    out = capsys.readouterr().out
    for mesh in ("dp=4 ip=1", "dp=2 ip=2", "dp=1 ip=4"):
        assert f"narrow sharded-pos {mesh}" in out
        assert f"wide sharded-mega-wide {mesh}" in out
    assert "table shards 0:" in out and " 3:" in out


@pytest.mark.gpu
def test_engines_on_gpu(gpu_device, capsys):
    """Every engine on the card against the references, at toy size."""
    assert gpu_device.platform == "gpu"
    chip_smoke.phase_engines(14, "gpu test", n_docs=2, doc_len=50_000,
                             batch=512, n_long=4, long_len=3000)
    assert "mismatches C++ 0, oracle 0" in capsys.readouterr().out
