"""Device-mesh runtime (L6).

The reference's only parallelism is OS-level on one machine (SURVEY.md
§2.15); its scale-out axes on accelerators are *initial-state scenarios*
(DP) and *Monte-Carlo particles* (MC). This module owns the mesh:

- axis ``"dp"``: independent MPC scenarios (batched initial states /
  targets) — embarrassingly parallel, sharded batch dimension;
- axis ``"mc"``: SDE sample paths within one solve — the per-particle cost
  is reduced by a mean that XLA lowers to ``psum`` over the device links.

Multi-host: ``jax.distributed.initialize()`` + the same mesh spanning all
processes (network between hosts, NVLink within one); nothing else changes —
GSPMD inserts the collectives.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "scenario_sharding", "replicated", "best_mesh_shape"]


def best_mesh_shape(n_devices: int, n_scenarios: int, num_particles: int) -> Tuple[int, int]:
    """Split devices between the dp and mc axes.

    Prefers filling dp (scenario throughput); gives mc only what dp cannot
    use, and only when the particle count splits evenly.
    """
    dp = int(np.gcd(n_devices, n_scenarios)) if n_scenarios > 0 else 1
    mc = n_devices // dp
    while mc > 1 and (num_particles % mc != 0):
        mc //= 2
    dp = n_devices // mc if mc >= 1 else n_devices
    if dp * mc != n_devices:
        dp, mc = n_devices, 1
    return dp, mc


def make_mesh(
    shape: Optional[Tuple[int, int]] = None,
    axis_names: Sequence[str] = ("dp", "mc"),
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a 2-D (scenario, particle) mesh over the available devices."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if shape is None:
        shape = (n, 1)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    dev_array = np.asarray(devices).reshape(shape)
    return Mesh(dev_array, tuple(axis_names))


def scenario_sharding(mesh: Mesh, rank: int = 1) -> NamedSharding:
    """Shard a leading scenario/batch dimension over the dp axis; the
    remaining ``rank-1`` dims are replicated."""
    return NamedSharding(mesh, P("dp", *([None] * (rank - 1))))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
