"""chip_smoke.py on the CPU: its refusals, and each phase's comparison
run at a tiny size (the script itself only runs on a GPU)."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as cs
from umgap_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_script(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_device_check_fails_on_cpu():
    r = _run_script(REPO, os.path.join(REPO, "chip_smoke.py"))
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert '"ok"' not in r.stdout


def test_script_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run_script(tmp_path, str(tmp_path / "chip_smoke.py"))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.parametrize("got, want, expect", [
    ("a\nb\n", "a\nb\n", None),
    ("a\nc\n", "a\nb\n", "line 2: got 'c', want 'b'"),
    ("a\n", "a\nb\n", "got 1 lines, want 2"),
])
def test_first_difference(got, want, expect):
    assert cs.first_difference(got, want) == expect


def test_parity_phase(tmp_path):
    cs.run_parity(str(tmp_path))


def test_parity_phase_catches_a_changed_record(tmp_path, monkeypatch):
    real = cs._analyse

    def off_by_one(argv):
        out = real(argv)
        return out[:-2] + ("3" if out[-2] == "2" else "2") + "\n"

    monkeypatch.setattr(cs, "_analyse", off_by_one)
    with pytest.raises(cs.SmokeFailure, match="differs from the oracle"):
        cs.run_parity(str(tmp_path))


def test_keygen_is_a_bijection():
    gen = cs.KeyGen.from_seed(7, 1000)
    c = np.arange(1000, dtype=np.uint64)
    keys = gen.keys(c)
    assert len(np.unique(keys)) == 1000
    assert (keys < np.uint64(1 << 45)).all()
    assert (gen.counters(keys) == c).all()


@pytest.fixture(scope="module")
def tiny_world(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("smoke")
    return cs.build_world(str(workdir), 2_100_000, 0, n_pairs=128)


def test_table_entries_include_random_key_collisions(tiny_world):
    """A read k-mer that a random key happens to equal must be in the
    oracle's dict with the random key's value."""
    kmer = "MKVLAAGIT"
    key = cs._pack_kmer(kmer)
    assert key not in set(tiny_world.planted.tolist())
    world = tiny_world._replace(gen=cs.KeyGen(tiny_world.gen.a, key,
                                              tiny_world.gen.n))
    got = cs.table_entries(world, [kmer, "AAAAAAAA-"])
    assert got == {kmer: int(tiny_world.random_vals[0])}
    planted = tiny_world.planted[:3]
    kmers = ["".join("ABCDEFGHIJKLMNOPQRSTUVWXYZ*"[(int(k) >> (5 * (8 - j)))
                                                   & 31]
                     for j in range(9)) for k in planted]
    got = cs.table_entries(tiny_world, kmers)
    assert got == {k: int(v) for k, v in zip(kmers,
                                             tiny_world.planted_vals[:3])}


def test_serve_phase_matches_oracle(tiny_world, capsys):
    cs.run_serve(tiny_world, "cpu", check_pairs=32, batch=64)
    out = capsys.readouterr().out
    assert "first 32 pairs byte-equal to the oracle" in out
    assert out.count("[cpu] request") == 3


def test_multi_phase_on_virtual_devices(tiny_world):
    cs.run_multi(tiny_world, "cpu", n_mesh=4)


def test_compile_cache_dir_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.compile_cache_dir() == str(tmp_path)


def test_compile_cache_dir_defaults_to_checkout(monkeypatch):
    import jax

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compile_cache.compile_cache_dir() == os.path.join(REPO,
                                                             ".jax_cache")
    before = jax.config.jax_compilation_cache_dir
    try:
        jax.config.update("jax_compilation_cache_dir", None)
        assert compile_cache.enable_compile_cache() == os.path.join(
            REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == os.path.join(
            REPO, ".jax_cache")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_dir_of_an_installed_package(monkeypatch, tmp_path):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(compile_cache, "REPO", str(tmp_path / "site"))
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert compile_cache.compile_cache_dir() == str(
        tmp_path / "cache" / "umgap_tpu" / "jax")


def test_enable_compile_cache_keeps_a_configured_dir(tmp_path):
    import jax

    before = jax.config.jax_compilation_cache_dir
    try:
        jax.config.update("jax_compilation_cache_dir", str(tmp_path))
        assert compile_cache.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
