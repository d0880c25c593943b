"""Device mesh helpers.

Role parity: the reference's Task::start driver/thread topology
(velox/exec/Task.h:166-172) — here the execution resources are mesh axes,
not threads. One axis ``d`` carries split/data parallelism (the analogue of
N drivers each pulling splits); exchanges become collectives over it
(SURVEY.md §5.8 mapping).
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "d"


def make_mesh(n_devices: Optional[int] = None, axis: str = DATA_AXIS) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"requested {n} devices, have {len(devs)}")
    return Mesh(np.asarray(devs[:n]), (axis,))


def shard_leading(mesh: Mesh, axis: str = DATA_AXIS) -> NamedSharding:
    """Sharding that splits the leading (device-wave) dimension."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
