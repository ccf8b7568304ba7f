"""Device mesh helpers.

The reference's only parallelism was a sequential ``cudaSetDevice`` loop
over contiguous row ranges (multi_gpu_utils.cpp:27-60).  The JAX
equivalent is a ``jax.sharding.Mesh``: tables are row-sharded across a
1-D ``"data"`` axis (contiguous ranges, like the reference split), XLA
inserts the collectives, and the device interconnect carries them (all
to all between the cards of a host, so the mesh follows the algorithm,
not a topology).
"""

from __future__ import annotations

from typing import Optional

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["data_mesh", "row_sharding", "replicated", "DATA_AXIS"]

DATA_AXIS = "data"


def data_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """A 1-D mesh over local devices (all of them by default)."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    import numpy as np

    return Mesh(np.asarray(devices), (DATA_AXIS,))


def row_sharding(mesh: Mesh) -> NamedSharding:
    """Shard axis 0 (rows) across the data axis."""
    return NamedSharding(mesh, P(DATA_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
