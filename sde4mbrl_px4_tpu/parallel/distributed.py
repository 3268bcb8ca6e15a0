"""Multi-host (DCN) execution wiring (L6).

The reference's multi-machine story is MAVLink fan-out over UDP/UART
(``scripts/router_hexa.conf``); the accelerator-native equivalent (SURVEY.md §2.15,
§5 "Distributed communication backend") is one ``jax.sharding.Mesh``
spanning every process of a multi-host slice: ``jax.distributed.
initialize()`` connects the processes, GSPMD inserts the collectives, and
the scenario (``dp``) / particle (``mc``) axes shard exactly as on a single
host — DCN carries only the cross-host collective edges.

Entry points:

- :func:`initialize_distributed` — env/flag-driven ``jax.distributed``
  bring-up (used by ``launch.py`` and ``tools/bench_scaling.py``);
- :func:`global_mesh` — the (dp, mc) mesh over ALL processes' devices;
- :func:`make_global_batch` — build a globally-sharded scenario batch from
  per-process host data (``jax.make_array_from_process_local_data``);
- :func:`gather_to_host` — allgather a sharded result for host-side use.

Proof without a pod: ``tests/test_distributed.py`` runs TWO separate
processes on localhost CPU (2 virtual devices each => a 4-device global
mesh) and asserts the sharded batched solve matches a single-process run —
the same way the reference validates "multi-node" behavior with SITL
instead of a vehicle (SURVEY.md §4).
"""
from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import jax
import numpy as np

__all__ = [
    "initialize_distributed",
    "global_mesh",
    "make_global_batch",
    "gather_to_host",
    "is_multiprocess",
]

_INITIALIZED = False


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
) -> bool:
    """Bring up ``jax.distributed`` when multi-process execution is requested.

    Resolution order per field: explicit argument > environment
    (``SDE4MBRL_COORDINATOR`` / ``SDE4MBRL_NUM_PROCESSES`` /
    ``SDE4MBRL_PROCESS_ID``) > JAX's own cluster auto-detection (SLURM,
    ...). Returns True when a multi-process runtime was
    initialized, False for the single-process fallback (no coordinator
    configured anywhere). Idempotent.
    """
    global _INITIALIZED
    if _INITIALIZED:
        return True
    coordinator_address = coordinator_address or os.environ.get("SDE4MBRL_COORDINATOR")
    if num_processes is None and "SDE4MBRL_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["SDE4MBRL_NUM_PROCESSES"])
    if process_id is None and "SDE4MBRL_PROCESS_ID" in os.environ:
        process_id = int(os.environ["SDE4MBRL_PROCESS_ID"])

    if coordinator_address is None and num_processes is None:
        # JAX's cluster auto-detection; only attempt when requested.
        if os.environ.get("SDE4MBRL_AUTO_DISTRIBUTED") in ("1", "true"):
            jax.distributed.initialize()
            _INITIALIZED = True
            return True
        return False

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )
    _INITIALIZED = True
    return True


def is_multiprocess() -> bool:
    return jax.process_count() > 1


def global_mesh(shape: Optional[Tuple[int, int]] = None,
                axis_names: Sequence[str] = ("dp", "mc")):
    """(dp, mc) mesh over every device of every process.

    Same contract as ``parallel.mesh.make_mesh`` but explicitly global:
    ``jax.devices()`` already enumerates all processes' devices after
    ``jax.distributed.initialize``.
    """
    from sde4mbrl_px4_tpu.parallel.mesh import make_mesh

    return make_mesh(shape=shape, axis_names=axis_names, devices=jax.devices())


def make_global_batch(mesh, xs_local: np.ndarray, rngs_local,
                      spec_names: Tuple = ("dp", None)):
    """Assemble a globally dp-sharded batch from per-process host arrays.

    Each process passes ITS shard of the scenario batch (the global batch
    is the concatenation in process order). Uses
    ``jax.make_array_from_process_local_data`` so no host ever materializes
    the full batch — the multi-host scale path for BASELINE config 5.
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    sh = NamedSharding(mesh, P(*spec_names))
    xs = jax.make_array_from_process_local_data(sh, np.asarray(xs_local))
    rngs = jax.make_array_from_process_local_data(sh, np.asarray(rngs_local))
    return xs, rngs


def global_batch_inputs(mesh, n_scenarios: int, seed: int = 0,
                        spread: float = 1.0):
    """Multi-process twin of ``parallel.batched.make_batch_inputs``: every
    process derives the identical deterministic global batch and feeds only
    its own slice. Returns (xs, rngs, ts) globally dp-sharded."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from sde4mbrl_px4_tpu.core.types import hover_state

    nproc = jax.process_count()
    pid = jax.process_index()
    assert n_scenarios % nproc == 0, (n_scenarios, nproc)
    Bl = n_scenarios // nproc

    rs = np.random.RandomState(seed)
    xs = np.tile(np.asarray(hover_state()), (n_scenarios, 1)).astype(np.float32)
    xs[:, 0:3] += spread * rs.randn(n_scenarios, 3).astype(np.float32)
    xs[:, 3:6] += 0.1 * spread * rs.randn(n_scenarios, 3).astype(np.float32)
    rngs = np.asarray(jax.random.split(jax.random.PRNGKey(seed), n_scenarios))
    sl = slice(pid * Bl, (pid + 1) * Bl)
    xs_g, rngs_g = make_global_batch(mesh, xs[sl], rngs[sl])
    ts = jax.make_array_from_process_local_data(
        NamedSharding(mesh, P("dp")), np.zeros((Bl,), np.float32)
    )
    return xs_g, rngs_g, ts


def gather_to_host(x) -> np.ndarray:
    """Allgather a (possibly multi-host-sharded) array to every host."""
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(x, tiled=True))
