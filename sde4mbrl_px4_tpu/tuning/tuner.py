"""Batched on-chip hyper-parameter tuning for the sampling solver (L6).

The reference tunes its controller by hand: edit the YAML, re-launch the
node, fly SITL, read the plots (`/root/reference/README.md` workflow; the
solver hyper-parameters live in ``launch/*_mpc.yaml``). On a CPU that is
the only option — each candidate costs a full SITL session.

On an accelerator the candidate axis is just another batch axis: this module flies
an ENTIRE GRID of candidate controllers closed-loop inside one compiled
program — ``vmap`` over the continuous MPPI knobs (``sigma``,
``temperature``, ``noise_beta``; tracer-safe by design, ``solver/mppi.py``),
plant = the SDE model's own mean dynamics (the same surrogate the solver
plans with, and the same closed-loop harness as ``bench.py``'s chained
loop). A 48-candidate sweep over 40 control periods is ~2M rollouts in one
program — seconds on one chip, and the grid shards over a mesh's ``dp``
axis for multi-chip sweeps.

Scoring uses **common random numbers** by default: every candidate sees
the same exploration-noise stream, so score differences are attributable
to the knobs, not to sampling luck (the standard variance-reduction trick
for simulation optimization; disable with ``crn=False`` for independent
streams).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Sequence

import numpy as np

__all__ = ["TuneResult", "WeightTuneResult", "make_mppi_grid",
           "make_weight_grid", "tune_mppi", "tune_cost_weights"]


class TuneResult(NamedTuple):
    """One scored candidate (sorted best-first in ``tune_mppi``'s output)."""

    sigma: float
    temperature: float
    noise_beta: float
    mean_pos_err: float      # mean ||pos - ref|| over the closed loop [m]
    final_pos_err: float     # ||pos - ref|| at the last step [m]

    def yaml_block(self, samples: int, iters: int) -> str:
        """The ``mppi:`` YAML block reproducing this candidate."""
        return (
            "mppi:\n"
            f"  samples: {samples}\n"
            f"  sigma: {self.sigma:.6g}\n"
            f"  temperature: {self.temperature:.6g}\n"
            f"  iters: {iters}\n"
            f"  noise_beta: {self.noise_beta:.6g}\n"
        )


def make_mppi_grid(
    sigmas: Sequence[float],
    temperatures: Sequence[float],
    noise_betas: Sequence[float],
) -> np.ndarray:
    """Cartesian product -> (N, 3) float32 candidate rows."""
    g = np.meshgrid(np.asarray(sigmas, np.float32),
                    np.asarray(temperatures, np.float32),
                    np.asarray(noise_betas, np.float32), indexing="ij")
    return np.stack([a.reshape(-1) for a in g], axis=-1)


def tune_mppi(
    cfg: Dict[str, Any],
    grid: np.ndarray,
    steps: int = 40,
    seed: int = 0,
    crn: bool = True,
    mesh=None,
    convert_to_enu: bool = True,
) -> list:
    """Score every (sigma, temperature, noise_beta) row of ``grid`` by
    closed-loop tracking error; returns ``TuneResult`` rows sorted
    best-first.

    ``cfg`` is a parsed MPC config mapping (``io/config.py``); its
    ``solver`` key is forced to ``mppi`` and its ``mppi.samples``/``iters``
    stay as configured (static — they size the compiled loops). Trajectory
    configs are flown along their reference trajectory; setpoint configs
    fly a 1 m position step (the ``bench.py`` MPPI workload).

    ``mesh``: optional ``jax.sharding.Mesh`` with a ``dp`` axis — the
    candidate axis shards over it (grid padded to a multiple of the axis
    size; pad rows are discarded from the output).

    A candidate grid is throughput-shaped work: the vmapped rollouts
    become (batch, feature) matmuls.
    """
    import jax
    import jax.numpy as jnp

    from sde4mbrl_px4_tpu.core.frames import enu2ned
    from sde4mbrl_px4_tpu.core.types import hover_state
    from sde4mbrl_px4_tpu.engine.mpc_loader import make_mpc_from_config
    from sde4mbrl_px4_tpu.solver.mppi import MPPIConfig

    grid = np.asarray(grid, np.float32)
    if grid.ndim != 2 or grid.shape[1] != 3:
        raise ValueError(f"grid must be (N, 3) [sigma, temperature, "
                         f"noise_beta]; got {grid.shape}")
    N = int(grid.shape[0])

    base = dict(cfg)
    base["solver"] = "mppi"
    static = MPPIConfig.from_config(base)
    has_traj = bool(base.get("trajectory_path"))

    # Probe build (host-side, un-traced): dt for the closed-loop pacing and
    # the trajectory sampler / setpoint geometry. The traced builds inside
    # ``score`` reuse the same config dict semantics.
    cfg_probe, _, state_from_traj, _ = make_mpc_from_config(
        dict(base), convert_to_enu=convert_to_enu)
    dt = float(cfg_probe["_time_steps"][0])

    if has_traj:
        # Engage at the trajectory start — the tuning workload includes the
        # engagement transient the knobs must handle in flight.
        t0 = 0.0
        x0 = enu2ned(state_from_traj(t0)) if convert_to_enu \
            else state_from_traj(t0)
        x0 = jnp.asarray(x0, jnp.float32)
        xdes = x0                       # traj mode: xdes unused by the ref
    else:
        t0 = 0.0
        x0 = jnp.asarray(hover_state()).at[0].set(1.0)   # 1 m step (NED)
        xdes = jnp.asarray(hover_state())                # target, xdes frame
    # Reference position in the SOLVER frame (NED) for scoring.
    tgt_ned = (enu2ned(xdes) if (convert_to_enu and not has_traj) else xdes)

    def score(hp: jax.Array, rng: jax.Array) -> jax.Array:
        mp = MPPIConfig(samples=static.samples, sigma=hp[0],
                        temperature=hp[1], iters=static.iters,
                        noise_beta=hp[2])
        # Closure build happens at trace time; the host-side CSV table is
        # pre-parsed (probe build) and handed in as ``state_from_traj``.
        _, (reset_fn, mpc_fn), sft, _ = make_mpc_from_config(
            dict(base), convert_to_enu=convert_to_enu,
            mppi_params=mp, state_from_traj=state_from_traj)
        st = reset_fn(x0, rng, x0)

        def body(carry, k):
            x, rng, st = carry
            t = jnp.float32(t0) + k * dt
            u, st, rng, x_evol = mpc_fn(x, rng, st, t, xdes)
            x1 = x_evol[1]
            if has_traj:
                ref = sft(t + dt)
                ref = enu2ned(ref) if convert_to_enu else ref
            else:
                ref = tgt_ned
            err = jnp.linalg.norm(x1[:3] - ref[:3])
            return (x1, rng, st), err

        (_, _, _), errs = jax.lax.scan(
            body, (x0, rng, st), jnp.arange(steps, dtype=jnp.float32))
        return jnp.stack([jnp.mean(errs), errs[-1]])

    key = jax.random.PRNGKey(seed)
    if crn:
        rngs = jnp.broadcast_to(key, (N, 2))
    else:
        rngs = jax.random.split(key, N)

    hp = jnp.asarray(grid)
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        dp = int(mesh.shape["dp"])
        pad = (-N) % dp
        if pad:
            hp = jnp.concatenate([hp, jnp.broadcast_to(hp[:1], (pad, 3))], 0)
            rngs = jnp.concatenate(
                [rngs, jnp.broadcast_to(rngs[:1], (pad, 2))], 0)
        hp = jax.device_put(hp, NamedSharding(mesh, P("dp", None)))
        rngs = jax.device_put(rngs, NamedSharding(mesh, P("dp", None)))

    out = np.asarray(jax.jit(jax.vmap(score))(hp, rngs))[:N]

    results = [
        TuneResult(sigma=float(grid[i, 0]), temperature=float(grid[i, 1]),
                   noise_beta=float(grid[i, 2]),
                   mean_pos_err=float(out[i, 0]),
                   final_pos_err=float(out[i, 1]))
        for i in range(N)
    ]
    results.sort(key=lambda r: r.mean_pos_err)
    return results


class WeightTuneResult(NamedTuple):
    """One scored cost-weight candidate: scale factors on the config's
    ``perr``/``verr``/``qerr``/``werr`` tracking weights."""

    p_scale: float
    v_scale: float
    q_scale: float
    w_scale: float
    score: float             # mean pos err + effort_weight * control effort
    mean_pos_err: float      # [m] over the closed loop (stochastic plant)
    effort: float            # mean ||u - uref||^2 per step

    def yaml_block(self, base_cost_params: Dict[str, Any]) -> str:
        """The updated ``cost_params:`` tracking-weight lines."""
        def scaled(key, s):
            v = np.atleast_1d(np.asarray(
                base_cost_params.get(key, 0.0), np.float64)) * s
            return "[" + ", ".join(f"{x:.6g}" for x in v) + "]"

        return ("cost_params:\n"
                f"  perr: {scaled('perr', self.p_scale)}\n"
                f"  verr: {scaled('verr', self.v_scale)}\n"
                f"  qerr: {scaled('qerr', self.q_scale)}\n"
                f"  werr: {scaled('werr', self.w_scale)}\n")


def make_weight_grid(
    p_scales: Sequence[float],
    v_scales: Sequence[float],
    q_scales: Sequence[float],
    w_scales: Sequence[float],
) -> np.ndarray:
    """Cartesian product -> (N, 4) float32 candidate rows."""
    g = np.meshgrid(np.asarray(p_scales, np.float32),
                    np.asarray(v_scales, np.float32),
                    np.asarray(q_scales, np.float32),
                    np.asarray(w_scales, np.float32), indexing="ij")
    return np.stack([a.reshape(-1) for a in g], axis=-1)


def tune_cost_weights(
    cfg: Dict[str, Any],
    grid: np.ndarray,
    steps: int = 40,
    seed: int = 0,
    crn: bool = True,
    mesh=None,
    convert_to_enu: bool = True,
    noisy_plant: bool = True,
    effort_weight: float = 0.0,
) -> list:
    """Score a grid of tracking-weight candidates — (p, v, q, w) scale
    factors on the config's ``perr``/``verr``/``qerr``/``werr`` — by
    closed-loop performance with the CONFIGURED solver (APG by default;
    the reference's 6 YAML variants differ in exactly these hand-tuned
    weights, e.g. ``iris_sitl_traj_mpc.yaml:32-41`` vs the hexa pairs).

    The plant takes ONE stochastic Euler-Maruyama draw per control period
    (``noisy_plant=True``; ``ops/rollout.em_step``) while the solver plans
    on the mean dynamics — scoring against the solver's own deterministic
    prediction would reward arbitrarily aggressive weights, since the
    surrogate has no model mismatch to punish them. Common random numbers
    give every candidate the same disturbance realization.

    ``effort_weight`` adds ``mean ||u - uref||^2`` to the score: tracking
    alone is insensitive to over-actuation; a small effort term (e.g.
    0.1) surfaces candidates that track equally well with less control
    authority. Returns ``WeightTuneResult`` rows sorted by score.
    """
    import jax
    import jax.numpy as jnp

    from sde4mbrl_px4_tpu.core.frames import enu2ned
    from sde4mbrl_px4_tpu.core.types import hover_state
    from sde4mbrl_px4_tpu.engine.mpc_loader import make_mpc_from_config
    from sde4mbrl_px4_tpu.ops.rollout import em_step

    grid = np.asarray(grid, np.float32)
    if grid.ndim != 2 or grid.shape[1] != 4:
        raise ValueError(f"grid must be (N, 4) [p, v, q, w scale]; got "
                         f"{grid.shape}")
    N = int(grid.shape[0])

    base = dict(cfg)
    has_traj = bool(base.get("trajectory_path"))
    cfg_probe, _, state_from_traj, bundle = make_mpc_from_config(
        dict(base), convert_to_enu=convert_to_enu)
    dt = float(cfg_probe["_time_steps"][0])
    base_cp = bundle.cost_params
    model, params = bundle.model, bundle.params

    if has_traj:
        t0 = 0.0
        x0 = enu2ned(state_from_traj(t0)) if convert_to_enu \
            else state_from_traj(t0)
        x0 = jnp.asarray(x0, jnp.float32)
        xdes = x0
    else:
        t0 = 0.0
        x0 = jnp.asarray(hover_state()).at[0].set(1.0)
        xdes = jnp.asarray(hover_state())
    tgt_ned = (enu2ned(xdes) if (convert_to_enu and not has_traj) else xdes)

    def score(hp: jax.Array, rng: jax.Array) -> jax.Array:
        cp = base_cp._replace(
            perr=base_cp.perr * hp[0], verr=base_cp.verr * hp[1],
            qerr=base_cp.qerr * hp[2], werr=base_cp.werr * hp[3])
        _, (reset_fn, mpc_fn), sft, _ = make_mpc_from_config(
            dict(base), convert_to_enu=convert_to_enu,
            cost_params_override=cp, state_from_traj=state_from_traj)
        rng_solver, rng_plant = jax.random.split(rng)
        st = reset_fn(x0, rng_solver, x0)

        def body(carry, k):
            x, rng_s, st, rng_p = carry
            t = jnp.float32(t0) + k * dt
            u, st, rng_s, _ = mpc_fn(x, rng_s, st, t, xdes)
            rng_p, sub = jax.random.split(rng_p)
            noise = (jax.random.normal(sub, (13,)) if noisy_plant else None)
            x1 = em_step(model, params, x, u[0], jnp.float32(dt), noise)
            if has_traj:
                ref = sft(t + dt)
                ref = enu2ned(ref) if convert_to_enu else ref
            else:
                ref = tgt_ned
            err = jnp.linalg.norm(x1[:3] - ref[:3])
            eff = jnp.sum((u[0] - base_cp.uref) ** 2)
            return (x1, rng_s, st, rng_p), (err, eff)

        (_, _, _, _), (errs, effs) = jax.lax.scan(
            body, (x0, rng_solver, st, rng_plant),
            jnp.arange(steps, dtype=jnp.float32))
        mean_err, mean_eff = jnp.mean(errs), jnp.mean(effs)
        return jnp.stack(
            [mean_err + jnp.float32(effort_weight) * mean_eff,
             mean_err, mean_eff])

    key = jax.random.PRNGKey(seed)
    rngs = (jnp.broadcast_to(key, (N, 2)) if crn
            else jax.random.split(key, N))

    hp = jnp.asarray(grid)
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        dp = int(mesh.shape["dp"])
        pad = (-N) % dp
        if pad:
            hp = jnp.concatenate([hp, jnp.broadcast_to(hp[:1], (pad, 4))], 0)
            rngs = jnp.concatenate(
                [rngs, jnp.broadcast_to(rngs[:1], (pad, 2))], 0)
        hp = jax.device_put(hp, NamedSharding(mesh, P("dp", None)))
        rngs = jax.device_put(rngs, NamedSharding(mesh, P("dp", None)))

    out = np.asarray(jax.jit(jax.vmap(score))(hp, rngs))[:N]

    results = [
        WeightTuneResult(p_scale=float(grid[i, 0]), v_scale=float(grid[i, 1]),
                         q_scale=float(grid[i, 2]), w_scale=float(grid[i, 3]),
                         score=float(out[i, 0]), mean_pos_err=float(out[i, 1]),
                         effort=float(out[i, 2]))
        for i in range(N)
    ]
    results.sort(key=lambda r: r.score)
    return results
