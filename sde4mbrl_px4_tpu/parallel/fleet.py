"""Fleet serving engine (L6): many vehicles, one accelerator.

The reference controls ONE vehicle per process (`sde_control.py`); the
accelerator scale-out is a fleet: B vehicles' receding-horizon solves run as
one dp-sharded batched program per control tick (`parallel/batched.py`),
with warm starts, RNG streams and plan buffers device-resident across
ticks (donated, no HBM churn) and the same pipelined dispatch pattern as
the single-vehicle engine (`engine/controller.py`): dispatch tick k,
stream tick k-1's plans host-ward in the background, collect them without
a synchronous device round trip.

Throughput on the card: `bench.py`'s batched leg and `chip_smoke.py`'s
fleet phase (ms per tick at B=64) measure it.

Multi-host: pass a process-spanning mesh (``parallel.distributed``) and
per-process state slices via ``jax.make_array_from_process_local_data`` —
the dp axis shards across hosts with no steady-state communication.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sde4mbrl_px4_tpu.parallel.batched import make_batched_mpc

__all__ = ["FleetEngine"]


class FleetEngine:
    """Batched receding-horizon serving over a device mesh.

    ``step(states, targets, curr_ts)`` solves all B scenarios and returns
    the PREVIOUS tick's plans (pipelined; first tick returns its own —
    cold start). All inputs are host numpy in the solver's NED frame
    (``targets`` follow the config's ``convert_to_enu`` convention exactly
    like the single-vehicle ``mpc_fn``).
    """

    def __init__(self, cfg: Dict[str, Any], mesh: Mesh, batch: int,
                 seed: int = 0, convert_to_enu: bool = True,
                 pipeline: bool = True):
        if batch % mesh.shape["dp"] != 0:
            raise ValueError(
                f"batch {batch} must divide over the dp axis ({mesh.shape['dp']})"
            )
        self.mesh = mesh
        self.B = int(batch)
        self.pipeline = pipeline
        self.reset_b, self.mpc_b, self.bundle = make_batched_mpc(
            dict(cfg), mesh, convert_to_enu=convert_to_enu
        )
        self.H = int(self.bundle.time_steps.shape[0])
        self.n_u = self.bundle.model.n_u
        self.dt = float(self.bundle.time_steps[0])

        self._sh2 = NamedSharding(mesh, P("dp", None))
        self._sh1 = NamedSharding(mesh, P("dp"))
        # Multi-process (multi-host) meshes: every process passes its LOCAL
        # slice of the fleet (B_local = B / process_count rows, process
        # order = global order) and arrays assemble globally without any
        # host holding the full batch.
        self.multiprocess = jax.process_count() > 1
        rngs_np = np.asarray(jax.random.split(jax.random.PRNGKey(seed), self.B))
        self.rngs = self._put2(rngs_np if not self.multiprocess
                               else rngs_np[self._local_slice(self.B)])
        self._opt = None       # device-resident warm starts (donated)
        self._pending = None   # (sol, t_dispatch) awaiting collection

    def _local_slice(self, B: int) -> slice:
        Bl = B // jax.process_count()
        pid = jax.process_index()
        return slice(pid * Bl, (pid + 1) * Bl)

    def _put2(self, arr: np.ndarray):
        arr = np.asarray(arr)
        if self.multiprocess:
            return jax.make_array_from_process_local_data(self._sh2, arr)
        return jax.device_put(arr, self._sh2)

    def _put1(self, arr: np.ndarray):
        arr = np.asarray(arr)
        if self.multiprocess:
            return jax.make_array_from_process_local_data(self._sh1, arr)
        return jax.device_put(arr, self._sh1)

    # ------------------------------------------------------------------ api

    def reset(self, states: np.ndarray) -> None:
        """(Re)initialize all warm starts from the fleet states (local
        rows in multi-process meshes)."""
        xs = self._put2(np.asarray(states, np.float32))
        self._opt = self.reset_b(xs, self.rngs, xs)
        self._pending = None

    def step(self, states: np.ndarray, targets: np.ndarray,
             curr_ts: Optional[np.ndarray] = None,
             ) -> Tuple[np.ndarray, np.ndarray, float]:
        """One fleet control tick.

        Args:
            states: (B, 13) vehicle states (solver frame, NED).
            targets: (B, 13) per-vehicle target states.
            curr_ts: (B,) per-vehicle positions on the reference trajectory
                (trajectory configs; zeros otherwise).

        Returns ``(u_now (B, n_u), x_evol (B, H+1, 13), age_s)`` — the
        controls to apply NOW and the predicted trajectories of the newest
        COLLECTED plans, plus the plans' age. Like the single-vehicle
        engine's time-indexed pickup (``engine/controller.py``), ``u_now``
        is the plan row matching the plan age (``u[round(age/dt)]``), so a
        pipelined caller applying the previous tick's plan executes that
        plan's step-1 action, not a stale step-0 (this also makes the
        cold-start tick, whose plan is returned again one tick later,
        time-consistent).
        """
        if self._opt is None:
            self.reset(states)
        B_rows = (self.B if not self.multiprocess
                  else self.B // jax.process_count())
        xs = self._put2(np.asarray(states, np.float32))
        xdes = self._put2(np.asarray(targets, np.float32))
        ts = self._put1(
            np.zeros(B_rows, np.float32) if curr_ts is None
            else np.asarray(curr_ts, np.float32))

        sol = self.mpc_b(xs, self.rngs, self._opt, ts, xdes)
        self.rngs, self._opt = sol.rng, sol.opt_state
        try:
            sol.u_opt.copy_to_host_async()
            sol.x_evol.copy_to_host_async()
        except AttributeError:
            pass

        now = time.perf_counter()
        if self.pipeline and self._pending is not None:
            prev, t_prev = self._pending
            self._pending = (sol, now)
            sol, age = prev, now - t_prev
        else:
            self._pending = (sol, now) if self.pipeline else None
            age = 0.0
        if self.multiprocess:
            # Each host serves its own vehicles: fetch only the
            # process-local rows (a device_get of the global array would
            # require full addressability).
            def local_rows(a):
                shards = sorted(a.addressable_shards,
                                key=lambda s: s.index[0].start or 0)
                return np.concatenate([np.asarray(s.data) for s in shards], 0)

            u, x_evol = local_rows(sol.u_opt), local_rows(sol.x_evol)
        else:
            u, x_evol = jax.device_get((sol.u_opt, sol.x_evol))
        idx = min(int(round(age / self.dt)), self.H - 1)
        return np.asarray(u)[:, idx, :], np.asarray(x_evol), age
