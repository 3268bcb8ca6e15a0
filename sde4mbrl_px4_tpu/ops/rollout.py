"""Euler-Maruyama SDE rollout (L2).

The reference's horizon discretization is a first-class feature: a per-step
dt vector ``_time_steps`` built from ``horizon`` / ``num_short_dt`` /
``short_step_dt`` / ``long_step_dt`` (fine steps near t=0, coarse later;
``launch/iris_sitl_traj_mpc.yaml:44-48``, consumed at
``sde_control.py:167``), and Monte-Carlo sample paths via ``num_particles``
(``iris_sitl_traj_mpc.yaml:52``).

Accelerator mapping (SURVEY.md §2.15): the horizon is serially dependent,
so it stays a ``lax.scan`` per device; parallelism lives on the particle
axis, which is a *leading batch dimension through every model matmul* (not
an outer vmap), so each EM step is one batched matmul over all particles.
All Brownian increments are drawn in a single fused RNG call up front —
counter-based and mesh-independent, so resharding particles never changes
the sampled paths.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from sde4mbrl_px4_tpu.core import quaternion as quat
from sde4mbrl_px4_tpu.models.sde_model import NeuralSDE, drift_fn, diffusion_fn, drift_and_sigma

__all__ = ["make_time_steps", "em_step", "rollout_mean", "rollout_sde",
           "draw_brownian", "SCAN_UNROLL"]

# ``unroll`` of the horizon ``lax.scan``s below: how many EM steps XLA
# emits per loop trip. Read at trace time.
SCAN_UNROLL = 4


def draw_brownian(rng: jax.Array, H: int, P: int, dtype=jnp.float32,
                  antithetic: bool = False) -> jax.Array:
    """Brownian increments (H, P, 13), one fused counter-based draw.

    ``antithetic=True`` pairs each sample path with its mirror (z, -z) —
    classic antithetic variates: the particle-mean cost estimator stays
    unbiased (each increment is still N(0,1) marginally) while negatively
    correlated path pairs cancel the odd component of the cost's noise
    response, cutting estimator variance at ZERO extra rollout cost
    (measured ~2-4x on the flight configs; tests/test_rollout.py). Opt-in
    via the ``antithetic`` config key; requires an even particle count.
    """
    if not antithetic:
        return jax.random.normal(rng, (H, P, 13), dtype=dtype)
    if P % 2:
        raise ValueError(f"antithetic sampling needs an even particle count,"
                         f" got {P}")
    z = jax.random.normal(rng, (H, P // 2, 13), dtype=dtype)
    return jnp.concatenate([z, -z], axis=1)


def make_time_steps(
    horizon: int, num_short_dt: int, short_step_dt: float, long_step_dt: float
) -> np.ndarray:
    """Per-step dt vector: ``num_short_dt`` fine steps then coarse steps.

    Reproduces the reference's ``cfg['_time_steps']`` contract
    (``sde_control.py:167``; schema at ``iris_sitl_traj_mpc.yaml:44-48``).
    """
    n_short = min(int(num_short_dt), int(horizon))
    return np.asarray(
        [short_step_dt] * n_short + [long_step_dt] * (int(horizon) - n_short),
        dtype=np.float32,
    )


def _renorm_quat(x: jax.Array) -> jax.Array:
    q = quat.qnormalize(x[..., 6:10])
    return jnp.concatenate([x[..., 0:6], q, x[..., 10:13]], axis=-1)


def em_step(
    model: NeuralSDE,
    params: Dict[str, Any],
    x: jax.Array,
    u: jax.Array,
    dt: jax.Array,
    noise: jax.Array | None = None,
) -> jax.Array:
    """One Euler(-Maruyama) step; ``noise`` ~ N(0,1) (13,) or batched, or None
    for the deterministic mean-dynamics step. Quaternion re-projected to S³."""
    if noise is not None:
        f, sig = drift_and_sigma(model, params, x, u)
        x1 = x + dt * f + jnp.sqrt(dt) * sig * noise
    else:
        x1 = x + dt * drift_fn(model, params, x, u)
    return _renorm_quat(x1)


def rollout_mean(
    model: NeuralSDE,
    params: Dict[str, Any],
    x0: jax.Array,
    u_seq: jax.Array,
    time_steps: jax.Array,
) -> jax.Array:
    """Deterministic rollout. ``x0`` (...,13), ``u_seq`` (H, n_u) or
    (..., H, n_u); returns (..., H+1, 13) with ``x0`` as row 0."""

    def body(x, inp):
        u, dt = inp
        x1 = em_step(model, params, x, u, dt)
        return x1, x1

    u_scan = jnp.moveaxis(u_seq, -2, 0)
    _, xs = jax.lax.scan(body, x0, (u_scan, time_steps), unroll=SCAN_UNROLL)
    xs = jnp.moveaxis(xs, 0, -2)
    return jnp.concatenate([x0[..., None, :], xs], axis=-2)


def rollout_sde(
    model: NeuralSDE,
    params: Dict[str, Any],
    x0: jax.Array,
    u_seq: jax.Array,
    time_steps: jax.Array,
    rng: jax.Array,
    num_particles: int,
    deterministic: bool = False,
    particle_sharding=None,
    precision=jax.lax.Precision.HIGHEST,
    antithetic: bool = False,
    x0_spread: jax.Array | None = None,
) -> Tuple[jax.Array, jax.Array]:
    """Monte-Carlo EM rollout.

    Args:
        x0: (13,) initial state, broadcast to all particles.
        u_seq: (H, n_u) shared control sequence.
        rng: PRNG key; all H*P*13 Brownian increments are drawn in ONE
            counter-based call so the sample paths are independent of any
            particle sharding layout (SURVEY.md "PRNG parity").
        deterministic: zero the Brownian increments (mean dynamics) while
            still reporting sigma along the path for the uncertainty cost —
            the reference's ``num_particles: 1`` flight configuration.
        x0_spread: optional (13,) per-dimension std of INITIAL-state
            uncertainty (state-estimate noise): each particle starts from
            its own draw ``x0 + x0_spread * N(0,1)`` (quaternion
            re-normalized — small stds act as small-angle attitude
            perturbations), so the particle mean in the cost optimizes the
            EXPECTED cost over state-estimate scenarios (scenario-robust
            MPC; ``initial_state_std`` config key). Ignored when
            ``deterministic``.
        particle_sharding: optional ``NamedSharding`` with spec
            ``P(None, 'mc', None)`` constraining the (H, P, 13) noise block;
            GSPMD then propagates the particle sharding through the scan and
            lowers the cost's particle-mean to a ``psum`` over the mesh.

    Returns:
        (x_paths (P, H+1, 13), sigma_paths (P, H, 13)) — the diffusion
        magnitudes along the path feed the uncertainty-penalty cost.
    """
    H = u_seq.shape[0]
    P = int(num_particles)
    if deterministic:
        noise = jnp.zeros((H, P, 13), dtype=x0.dtype)
    else:
        noise = draw_brownian(rng, H, P, dtype=x0.dtype, antithetic=antithetic)
    if particle_sharding is not None:
        noise = jax.lax.with_sharding_constraint(noise, particle_sharding)
    x0_b = jnp.broadcast_to(x0, (P, 13))
    if x0_spread is not None and not deterministic:
        # Independent of the Brownian stream (fold_in), antithetic-paired
        # when the path noise is, so scenario pairs stay mirrored too.
        z0 = draw_brownian(jax.random.fold_in(rng, 0x5EED), 1, P,
                           dtype=x0.dtype, antithetic=antithetic)[0]
        x0_b = _renorm_quat(x0_b + jnp.asarray(x0_spread, x0.dtype) * z0)

    def body(x, inp):
        u, dt, z = inp
        f, sig = drift_and_sigma(model, params, x, u, precision=precision)
        x1 = _renorm_quat(x + dt * f + jnp.sqrt(dt) * sig * z)
        return x1, (x1, sig)

    _, (xs, sigs) = jax.lax.scan(body, x0_b, (u_seq, time_steps, noise),
                                 unroll=SCAN_UNROLL)
    x_paths = jnp.concatenate([x0_b[:, None, :], jnp.moveaxis(xs, 0, 1)], axis=1)
    sigma_paths = jnp.moveaxis(sigs, 0, 1)
    return x_paths, sigma_paths
