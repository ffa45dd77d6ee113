"""Device mesh helpers."""

from __future__ import annotations

import jax
from jax.sharding import Mesh

SHARD_AXIS = "shard"


def make_mesh(n_devices: int | None = None, axis: str = SHARD_AXIS) -> Mesh:
    """1-D mesh over the first ``n_devices`` devices (default: all).

    A vector database shards along one logical dimension — corpus slots —
    so a 1-D mesh suffices; on multi-host slices JAX lays the axis out over
    the interconnect automatically.
    """
    devices = jax.devices()
    n = n_devices or len(devices)
    if n > len(devices):
        raise ValueError(f"requested {n} devices, have {len(devices)}")
    # Auto axis type: we annotate shardings ourselves (device_put +
    # shard_map); Explicit mode (the 0.9 default) would force every eager op
    # on sharded arrays into a set_mesh context.
    return jax.make_mesh(
        (n,), (axis,), devices=devices[:n],
        axis_types=(jax.sharding.AxisType.Auto,),
    )
