"""Batched / sharded MPC solving over the device mesh (L6).

Maps the reference's single-scenario solve loop (one APG solve per state
tick, ``sde_control.py:365-450``) onto the device-mesh scale axes
(``BASELINE.json`` configs 4-5):

- **Scenario DP**: ``vmap`` the whole ``mpc_fn`` over a leading batch of
  (initial state, target, warm start, rng) and shard that batch over the
  mesh's ``dp`` axis. Each device runs its scenarios' full APG solves
  locally — zero cross-device traffic in steady state.
- **Particle MC**: build the solver with a ``particle_sharding`` constraint
  (``engine.mpc_loader.make_mpc_from_config``) so a single 1024-particle
  uncertainty-aware solve spreads its sample paths over the ``mc`` axis;
  the risk reduction (particle mean in the cost) becomes an on-mesh
  ``psum`` inserted by GSPMD.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sde4mbrl_px4_tpu.engine.mpc_loader import make_mpc_from_config
from sde4mbrl_px4_tpu.solver.apg import APGState
from sde4mbrl_px4_tpu.core.types import MPCSolution

__all__ = ["make_batched_mpc", "make_batch_inputs", "make_particle_sharded_mpc"]


def make_batched_mpc(
    cfg: Dict[str, Any],
    mesh: Mesh,
    convert_to_enu: bool = True,
    donate_state: bool = True,
    local_loop: bool = True,
) -> Tuple[Callable, Callable, Any]:
    """Build (batched_reset, batched_mpc, bundle) sharded over ``mesh``'s dp axis.

    ``batched_reset(xs, rngs, xdes) -> APGState[B]``
    ``batched_mpc(xs, rngs, opt_states, curr_ts, xdes) ->
        (uopt[B,H,n_u], APGState[B], rngs[B], x_evol[B,H+1,13])``

    The opt_state argument is donated (``donate_state``) so warm starts
    update in place on device across control steps — no HBM churn.

    ``local_loop`` (default ON; round-5 fix for the small-batch scaling
    floor): vmapping the solver's ``lax.while_loop`` turns its stop
    condition into "ANY batch element still active", and under plain
    GSPMD sharding that predicate is a cross-device ``pred[] all-reduce``
    executed EVERY APG iteration — on a multi-process (DCN) mesh, one
    cross-process rendezvous per iteration, which was the entire
    b_per_dev=32 weak-scaling loss (SCALING.json r4: 0.40 vs-solo at 4
    processes). The scenarios are independent, so the solve is wrapped in
    ``shard_map``: each device's loop now reduces its OWN shard only —
    zero collectives in the program — and a device stops as soon as ITS
    scenarios converge instead of iterating until the globally slowest
    one does.
    """
    _, (reset_fn, mpc_fn), _, bundle = make_mpc_from_config(
        dict(cfg), convert_to_enu=convert_to_enu
    )

    batch = NamedSharding(mesh, P("dp"))

    def shard_leading(rank: int) -> NamedSharding:
        return NamedSharding(mesh, P("dp", *([None] * (rank - 1))))

    v_reset = jax.vmap(reset_fn)
    v_mpc = jax.vmap(mpc_fn)

    st_shardings = APGState(
        yk=shard_leading(3),
        num_steps=batch, stepsize=batch, avg_stepsize=batch,
        avg_linesearch=batch, grad_sqr=batch, init_cost=batch, opt_cost=batch,
    )

    reset_sharded = jax.jit(
        v_reset,
        in_shardings=(shard_leading(2), shard_leading(2), shard_leading(2)),
        out_shardings=st_shardings,
    )
    if local_loop:
        try:
            from jax import shard_map as _sm  # jax >= 0.8 canonical home

            def shard_map(f, mesh, in_specs, out_specs):
                return _sm(f, mesh=mesh, in_specs=in_specs,
                           out_specs=out_specs, check_vma=False)
        except ImportError:  # pragma: no cover — older jax
            from jax.experimental.shard_map import shard_map as _sme

            def shard_map(f, mesh, in_specs, out_specs):
                return _sme(f, mesh=mesh, in_specs=in_specs,
                            out_specs=out_specs, check_rep=False)

        def spec_leading(rank: int) -> P:
            return P("dp", *([None] * (rank - 1)))

        st_specs = APGState(
            yk=spec_leading(3),
            num_steps=P("dp"), stepsize=P("dp"), avg_stepsize=P("dp"),
            avg_linesearch=P("dp"), grad_sqr=P("dp"), init_cost=P("dp"),
            opt_cost=P("dp"),
        )
        v_mpc = shard_map(
            v_mpc, mesh,
            (spec_leading(2), spec_leading(2), st_specs, P("dp"),
             spec_leading(2)),
            MPCSolution(
                u_opt=spec_leading(3), opt_state=st_specs,
                rng=spec_leading(2), x_evol=spec_leading(3)),
        )
    mpc_sharded = jax.jit(
        v_mpc,
        in_shardings=(
            shard_leading(2),   # xs (B, 13)
            shard_leading(2),   # rngs (B, 2)
            st_shardings,       # opt states
            batch,              # curr_ts (B,)
            shard_leading(2),   # xdes (B, 13)
        ),
        out_shardings=MPCSolution(
            u_opt=shard_leading(3),
            opt_state=st_shardings,
            rng=shard_leading(2),
            x_evol=shard_leading(3),
        ),
        donate_argnums=(2,) if donate_state else (),
    )
    return reset_sharded, mpc_sharded, bundle


def make_batch_inputs(mesh: Mesh, n_scenarios: int, seed: int = 0,
                      base_state=None, spread: float = 1.0):
    """Device-sharded batch of perturbed initial states + per-scenario rngs.

    Utility for benchmarks and the pod-scale sweep (BASELINE config 5).
    """
    import numpy as np
    from sde4mbrl_px4_tpu.core.types import hover_state

    base = np.asarray(hover_state() if base_state is None else base_state)
    rs = np.random.RandomState(seed)
    xs = np.tile(base, (n_scenarios, 1)).astype(np.float32)
    xs[:, 0:3] += spread * rs.randn(n_scenarios, 3).astype(np.float32)
    xs[:, 3:6] += 0.1 * spread * rs.randn(n_scenarios, 3).astype(np.float32)
    rngs = jax.random.split(jax.random.PRNGKey(seed), n_scenarios)

    sh2 = NamedSharding(mesh, P("dp", None))
    xs = jax.device_put(jnp.asarray(xs), sh2)
    rngs = jax.device_put(rngs, sh2)
    return xs, rngs


def make_particle_sharded_mpc(cfg: Dict[str, Any], mesh: Mesh,
                              convert_to_enu: bool = True):
    """Single-scenario solver whose Monte-Carlo particle axis is sharded
    over the mesh's ``mc`` axis (1024-particle uncertainty-aware MPC,
    BASELINE config 4)."""
    noise_sharding = NamedSharding(mesh, P(None, "mc", None))
    cfg2, fns, sft, bundle = make_mpc_from_config(
        dict(cfg), convert_to_enu=convert_to_enu, particle_sharding=noise_sharding
    )
    reset_fn, mpc_fn = fns
    return jax.jit(reset_fn), jax.jit(mpc_fn), bundle
