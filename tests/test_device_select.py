"""Device selection without guards: the sketch backend follows the platform
JAX reports, the compile cache follows JAX_COMPILATION_CACHE_DIR or stays
inside the checkout, grow workers never see the card, the native library is
keyed to its host, and chip_smoke.py refuses to run without a GPU."""

import os
import subprocess
import sys

import numpy as np
import pytest

import nanospring_tpu
from nanospring_tpu import native
from nanospring_tpu.config import CompressConfig
from nanospring_tpu.pipeline import contigs
from nanospring_tpu.utils import synth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _store(tmp_path, n=40, mean_len=700):
    from nanospring_tpu.io import read_store

    rng = np.random.default_rng(6)
    genome = synth.random_genome(8_000, rng)
    fq = str(tmp_path / "s.fastq")
    synth.write_fastq(fq, synth.make_reads(genome, n, mean_len, rng), gz=False)
    return read_store.load_fastq(fq)


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_sketch_backend_follows_platform(tmp_path, monkeypatch, platform):
    """cpu -> native host sketch, gpu -> device kernel (here it executes on
    XLA:CPU); both give the same bits, and the choice is recorded."""
    import jax

    store = _store(tmp_path)
    cfg = CompressConfig()
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    ref = contigs.compute_all_sketches(store, cfg)
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert contigs.sketch_backend() == ("device" if platform == "gpu"
                                        else "native")
    contigs.PIPE_STAGES.clear()
    got = contigs.compute_all_sketches(store, cfg)
    assert contigs.PIPE_STAGES["sketch_backend_device"] == float(
        platform == "gpu")
    np.testing.assert_array_equal(got, ref)


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_chip_smoke_refuses_cpu():
    r = _run_smoke(REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_needs_the_repo(tmp_path):
    import shutil

    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run_smoke(str(tmp_path))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "nanospring_tpu" in r.stderr


@pytest.fixture
def cache_config(monkeypatch):
    """Pretend to run on a GPU and restore the cache settings afterwards."""
    import jax

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    saved = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    yield jax.config
    jax.config.update("jax_compilation_cache_dir", saved[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", saved[1])


def test_cache_follows_env(cache_config, monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the program sets no cache."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    cache_config.update("jax_compilation_cache_dir", str(tmp_path))
    nanospring_tpu.enable_jax_compilation_cache()
    assert cache_config.jax_compilation_cache_dir == str(tmp_path)


def test_cache_default_inside_checkout(cache_config, monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    nanospring_tpu.enable_jax_compilation_cache()
    assert cache_config.jax_compilation_cache_dir == os.path.join(
        REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_grow_workers_launched_off_the_card(tmp_path, monkeypatch):
    """Every grow worker starts with the card hidden and JAX pinned to the
    CPU."""
    real_popen = subprocess.Popen
    envs = []

    def _spy(cmd, env=None, **kw):
        if "nanospring_tpu.pipeline.grow_worker" in cmd:
            envs.append(env)
        return real_popen(cmd, env=env, **kw)

    monkeypatch.setattr(subprocess, "Popen", _spy)
    from nanospring_tpu.compressor import compress_file
    from nanospring_tpu.decompressor import decompress_file

    rng = np.random.default_rng(12)
    # two genomes: at least two components to spread over two workers
    reads = [r for _ in range(2) for r in synth.make_reads(
        synth.random_genome(15_000, rng), 30, 1_500, rng)]
    fq = str(tmp_path / "in.fastq")
    synth.write_fastq(fq, reads, gz=False)
    arc = str(tmp_path / "o.nstpu")
    compress_file(fq, arc, CompressConfig(pipeline_workers=2), report=False)
    assert len(envs) == 2
    for env in envs:
        assert env["CUDA_VISIBLE_DEVICES"] == ""
        assert env["JAX_PLATFORMS"] == "cpu"
    decompress_file(arc, str(tmp_path / "o.reads"), report=False)
    with open(tmp_path / "o.reads", "rb") as f:
        assert f.read().split(b"\n")[:-1] == reads


def test_native_library_rebuilds_for_another_cpu(tmp_path, monkeypatch):
    """The library's name carries the CPU key: the same key reuses the
    build, another key (a copied checkout on another host) rebuilds."""
    import shutil

    for src in native._SOURCES:
        shutil.copy(os.path.join(native._DIR, src), tmp_path)
    monkeypatch.setattr(native, "_DIR", str(tmp_path))
    built = []

    def _fake_run(cmd, **kw):
        built.append(cmd)
        open(cmd[cmd.index("-o") + 1], "wb").close()

    monkeypatch.setattr(native.subprocess, "run", _fake_run)
    monkeypatch.setattr(native, "_cpu_key", lambda: "-march=cpu-a")
    a = native.build()
    assert native.build() == a and len(built) == 1
    monkeypatch.setattr(native, "_cpu_key", lambda: "-march=cpu-b")
    b = native.build()
    assert b != a and len(built) == 2
    assert os.path.exists(b) and not os.path.exists(a)
    assert os.path.dirname(b) == str(tmp_path)
