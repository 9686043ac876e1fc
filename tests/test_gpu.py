"""Tests that need the card: the lax DP, the sketch kernel and the engine's
device aligner, compiled for the GPU and checked against their host
references. Elsewhere they skip. On the card:

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX_PLATFORMS=cuda on the card)")


def test_lax_dp_on_card_matches_native(gpu):
    from test_align_device import _check_against_native, _mkbatch

    from nanospring_tpu.ops import align_device as ad

    rng = np.random.default_rng(31)
    args = _mkbatch(64, rng, tmin=4000, tmax=6000, minov=2500)
    dev = ad.banded_align_batch_device(*args, p_cap=64)
    _check_against_native(args, dev)
    assert (dev.cost >= 0).sum() >= 32


def test_sketch_on_card_matches_native(gpu, tmp_path):
    from test_device_select import _store

    from nanospring_tpu import native
    from nanospring_tpu.config import CompressConfig
    from nanospring_tpu.ops import sketch as sk
    from nanospring_tpu.pipeline import contigs

    cfg = CompressConfig()
    store = _store(tmp_path, n=300, mean_len=3000)
    assert contigs.sketch_backend() == "device"
    got = contigs.compute_all_sketches(store, cfg)
    ref = np.full_like(got, sk.EMPTY_SLOT)
    contigs._sketch_native_into(
        native.get_lib(), store, np.arange(store.num_reads),
        sk.make_seeds(cfg.num_hashes, cfg.sketch_seed), cfg.kmer_size,
        max(cfg.kmer_size, cfg.min_read_len_for_sketch), ref)
    np.testing.assert_array_equal(got, ref)


def test_engine_device_aligner_on_card(gpu, tmp_path):
    from nanospring_tpu.compressor import compress_file
    from nanospring_tpu.config import CompressConfig
    from nanospring_tpu.decompressor import decompress_file
    from nanospring_tpu.utils import synth

    fq = str(tmp_path / "in.fastq")
    reads = synth.make_dataset(fq, genome_len=100_000, num_reads=300,
                               mean_len=4_000, seed=3, realistic=True)
    arc = str(tmp_path / "o.nstpu")
    res = compress_file(fq, arc, CompressConfig(aligner="device"),
                        report=False)
    assert res["dp_info"]["device_batches"] > 0
    out = str(tmp_path / "o.reads")
    decompress_file(arc, out, report=False)
    with open(out, "rb") as f:
        assert f.read().splitlines() == reads
