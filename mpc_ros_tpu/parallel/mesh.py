"""Device-mesh helpers.

The reference has no parallelism at all (SURVEY.md §2.4); the mesh follows
the algorithm (every device reaches every other at the same rate):

* `data` — scenario-batch sharding (`shard_map` + `psum` for sweep
  reductions),
* `time` — horizon parallelism for the Riccati factorization (distributed
  associative scan), reserved in the 2-D mesh layout.

`psum`/`all_gather` run across the devices of one host (NVLink between
GPUs); multi-host Monte-Carlo sweeps span hosts over the network with the
same program (jax global devices).
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
TIME_AXIS = "time"


def make_mesh(n_data: int | None = None, n_time: int = 1,
              devices=None) -> Mesh:
    """Build a (data, time) mesh. Defaults to all visible devices on the
    data axis (pure scenario parallelism)."""
    if devices is None:
        devices = jax.devices()
    if n_data is None:
        n_data = len(devices) // n_time
    devs = np.asarray(devices[: n_data * n_time]).reshape(n_data, n_time)
    return Mesh(devs, (DATA_AXIS, TIME_AXIS))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Leading-axis sharding of a scenario batch over the data axis."""
    return NamedSharding(mesh, P(DATA_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
