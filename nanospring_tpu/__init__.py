"""nanospring: lossless compressor for nanopore DNA read sequences.

A from-scratch, JAX/XLA-first re-design of the capabilities of the
reference tool NanoSpring (qm2/NanoSpring): FASTQ in, `.nstpu` archive out,
byte-identical sequences back on decompression.

Architecture (see SURVEY.md for the reference analysis this is built against):

- ``io``        2-bit packed array read stores, FASTQ/gzip ingestion, the
                seven-stream edit-script serialization and the tar container.
- ``ops``       Device compute: batched MinHash sketching and the batched
                banded DP in plain jax/lax, rolling k-mer minimizers,
                edit-script utilities.
- ``pipeline``  The compression pipeline: candidate index (sort-join instead
                of the reference's MPHF tables), contig building (batched
                mosaic extension instead of the reference's per-thread
                pointer DAG), consensus polishing (column voting), final
                batched encode.
- ``parallel``  Device mesh, shardings, and the sharded sketch join for
                multi-host scale-out (collectives instead of OpenMP locks).
- ``codec``     Host-CPU entropy coding backends for the final streams
                (the bsc / fast-lzma2 role in the reference).
- ``utils``     Stage timers, funnel counters, logging.
"""

import os

__version__ = "0.1.0"


CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def enable_jax_compilation_cache() -> None:
    """Persist XLA compilations across runs (kernel shapes recur).

    ``JAX_COMPILATION_CACHE_DIR``, where set, is read by JAX itself and
    wins; otherwise the cache is the checkout's fixed ``.jax_cache``. The
    CPU backend is left uncached: its executables are specialised to the
    host's instruction set, and a checkout copied to another machine would
    load them there.
    """
    import jax

    if os.environ.get("JAX_COMPILATION_CACHE_DIR") \
            or jax.default_backend() == "cpu":
        return
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.3)
