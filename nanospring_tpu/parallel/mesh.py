"""Device mesh + shardings for multi-chip / multi-host scale-out.

The reference's only parallelism is shared-memory OpenMP with a lock-striped
claim table (reference: src/Consensus.cpp:256-277,444-468 and SURVEY.md §2.4).
The accelerator-side replacement (SURVEY.md §5.8):

- one mesh axis ``reads``: FASTQ batches are sharded over it (data
  parallelism over reads — the analog of OpenMP loops over reads),
- the sketch join becomes a sharded hash-join: minhash values are exchanged
  with all-to-all so each device owns a hash-value range (the analog of the
  shared hash tables),
- claims are owner-computes: a read is claimed by the shard that owns its
  seed's contig — deterministic, no locks,
- funnel stats and contig metadata merge with psum/all_gather.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

READS_AXIS = "reads"


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        if len(devs) < n_devices:
            # refuse to silently build a smaller mesh: a 1-device "8-way"
            # mesh makes every sharding test vacuously pass (observed
            # after the jax 0.9 upgrade dropped
            # --xla_force_host_platform_device_count support)
            raise RuntimeError(
                f"requested a {n_devices}-device mesh but only "
                f"{len(devs)} JAX device(s) are visible; for a virtual "
                f"CPU mesh set jax.config.update('jax_num_cpu_devices', "
                f"{n_devices}) before the first backend use")
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (READS_AXIS,))


def reads_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (reads) dimension."""
    return NamedSharding(mesh, P(READS_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
