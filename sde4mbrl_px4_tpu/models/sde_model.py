"""Neural-SDE vehicle dynamics (L1).

The reference's learned model lives in the external ``sde4mbrl`` library and
is loaded from a pickle named in config (``learned_model_params``,
``launch/iris_sitl_traj_mpc.yaml:3``); only its call-site contract is
observable (SURVEY.md §2.9). This module defines the framework's own
physics-constrained neural SDE in the same spirit:

    dx = f(x, u) dt + Σ(x, u) dW

with drift ``f`` = rigid-body multirotor prior + neural residual
wrench, and diffusion ``Σ`` a learned state/control-dependent diagonal on
the velocity states (pos/quat rows are zero so sample paths stay consistent
with kinematics and the quaternion stays near S³ between projections).

Everything is a pure function of a parameter pytree — ``vmap`` over
particles, ``grad`` through rollouts, shardable with ``pjit``. MLP layers
are sized (64 hidden); a batched particle axis is the matmul's row dimension.

State: NED/FRD 13-vector (core.types). Control: per-motor thrust in [0,1].
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from sde4mbrl_px4_tpu.core import quaternion as quat
from sde4mbrl_px4_tpu.core.types import POS, VEL, QUAT, OMEGA
from sde4mbrl_px4_tpu.models.vehicles import VehicleConfig, vehicle_from_name

__all__ = ["NeuralSDE", "init_params", "drift_fn", "diffusion_fn", "mlp_apply",
           "resolve_precision"]

_G = 9.81


def resolve_precision(name) -> jax.lax.Precision:
    """Map a ``matmul_precision`` config string to a matmul precision.

    - ``highest`` / ``float32`` (and an absent key): full float32 products
      — the reference's f32-on-CPU numerics, used by the parity configs;
    - ``tf32`` / ``default``: XLA's default precision, which on an NVIDIA
      Hopper card runs float32 matmuls on the tensor cores with TF32
      inputs (10-bit mantissa) and float32 accumulation. ``engine/
      mpc_loader.py`` picks it for ``num_particles`` > 128, where the
      Brownian sampling noise of the cost estimate dominates the rounding.

    Any other name (``bf16`` included: nothing here casts dot inputs to
    bfloat16) is a configuration error.
    """
    if isinstance(name, jax.lax.Precision):
        return name
    table = {
        None: jax.lax.Precision.HIGHEST,
        "highest": jax.lax.Precision.HIGHEST,
        "float32": jax.lax.Precision.HIGHEST,
        "tf32": jax.lax.Precision.DEFAULT,
        "default": jax.lax.Precision.DEFAULT,
    }
    key = name if name is None else str(name).lower()
    if key not in table:
        raise ValueError(
            f"matmul_precision {name!r} not recognized; use highest/float32 "
            "(float32 products) or tf32/default (TF32 tensor-core inputs, "
            "float32 accumulation)"
        )
    return table[key]


# Diffusion acts on velocity-like states only: v (3) + omega (3).
_DIFF_DIM = 6
_FEAT_DIM_BASE = 10  # v(3) + omega(3) + R_z row(3) + 1 spare for padding alignment


def _feat(x: jax.Array, u: jax.Array) -> jax.Array:
    """Network input features: body-frame velocity, rates, gravity direction
    in body frame (attitude proxy that avoids quaternion double-cover), and
    the motor commands."""
    q = x[..., QUAT]
    v_body = quat.qrotate_inv(q, x[..., VEL])
    omega = x[..., OMEGA]
    # Third row of R(q)^T: gravity (world z) expressed in body frame.
    g_body = quat.qrotate_inv(q, jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0], x.dtype), x[..., 0:3].shape))
    u_b = jnp.broadcast_to(u, x.shape[:-1] + (u.shape[-1],))
    return jnp.concatenate([v_body, omega, g_body, u_b], axis=-1)


def mlp_apply(params: Dict[str, Any], h: jax.Array) -> jax.Array:
    """Tiny MLP: stacked dense layers with swish, linear head.

    ``params`` = {"w0","b0","w1","b1",...}; matmuls use
    ``preferred_element_type=float32`` so products accumulate in f32 even
    if weights are stored in a narrower type.
    """
    n_layers = sum(1 for k in params if k.startswith("w"))
    for i in range(n_layers):
        w, b = params[f"w{i}"], params[f"b{i}"]
        h = jax.lax.dot_general(
            h, w, (((h.ndim - 1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        ) + b
        if i < n_layers - 1:
            h = jax.nn.swish(h)
    return h


class NeuralSDE(NamedTuple):
    """Static model description. Parameters travel separately as a pytree."""

    vehicle: VehicleConfig

    @property
    def n_u(self) -> int:
        return self.vehicle.n_motors

    def drift(self, params: Dict[str, Any], x: jax.Array, u: jax.Array) -> jax.Array:
        return drift_fn(self, params, x, u)

    def diffusion(self, params: Dict[str, Any], x: jax.Array, u: jax.Array) -> jax.Array:
        return diffusion_fn(self, params, x, u)


def trunk_apply(params: Dict[str, Any], x: jax.Array, u: jax.Array,
                precision=jax.lax.Precision.HIGHEST):
    """Shared two-head network: one trunk, (wrench residual, raw sigma) heads.

    The residual force/torque and the diffusion magnitude share the trunk so
    each EM step costs 3 matmuls instead of 5 — at these widths each small
    matmul costs a fixed issue latency, so the count sets the per-step
    cost. ``precision``: see :func:`resolve_precision`.
    """
    h = _feat(x, u)
    net = params["net"]
    n_layers = sum(1 for k in net if k.startswith("w"))
    for i in range(n_layers):
        w, b = net[f"w{i}"], net[f"b{i}"]
        h = jax.lax.dot_general(
            h, w, (((h.ndim - 1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=precision,
        ) + b
        if i < n_layers - 1:
            h = jax.nn.swish(h)
    # Combined head output: [:6] residual wrench, [6:12] raw diffusion.
    res = h[..., 0:6]
    sig6 = jax.nn.softplus(h[..., 6:12]) * jnp.exp(params["diffusion_log_scale"])
    return res, sig6


def sigma13(x: jax.Array, sig6: jax.Array) -> jax.Array:
    """Expand the 6-dim velocity-state sigma to the full 13-dim diagonal."""
    zeros = jnp.zeros(x[..., 0:4].shape, x.dtype)
    return jnp.concatenate(
        [zeros[..., 0:3], sig6[..., 0:3], zeros[..., 0:4], sig6[..., 3:6]], axis=-1
    )


def drift_terms(model: NeuralSDE, params: Dict[str, Any], x: jax.Array,
                u: jax.Array, res: jax.Array) -> jax.Array:
    """Physics-prior drift given the residual head output (see drift_fn)."""
    veh = model.vehicle
    q = x[..., QUAT]
    v = x[..., VEL]
    omega = x[..., OMEGA]

    mix = jnp.asarray(veh.mixing, x.dtype) * jnp.exp(params["motor"]["log_gain"])[:, None]
    # HIGHEST precision is load-bearing here: this is the control-to-wrench
    # map — the entire gradient signal of the solve flows through it, and
    # reduced-precision dot inputs (bf16, or TF32 on tensor cores) quantize
    # motor commands at 1e-3..4e-3 relative, at or BELOW the per-iteration
    # control updates near convergence: a batched solver then stops early
    # on atol/rtol with decimetre-scale tracking error that the float32
    # solve does not have. tests/test_precision.py pins every solve dot.
    wrench = jnp.einsum(
        "ij,...j->...i", mix,
        jnp.broadcast_to(u, x.shape[:-1] + (veh.n_motors,)),
        precision=jax.lax.Precision.HIGHEST)
    thrust = wrench[..., 0]
    tau = wrench[..., 1:4]

    f_res = res[..., 0:3]
    tau_res = res[..., 3:6]

    e_z = jnp.zeros_like(v).at[..., 2].set(1.0)
    f_body = f_res - thrust[..., None] * e_z
    acc = _G * e_z + quat.qrotate(q, f_body) / veh.mass

    J = jnp.asarray(veh.inertia, x.dtype)
    domega = (tau + tau_res - jnp.cross(omega, J * omega)) / J

    omega_q = jnp.concatenate([jnp.zeros_like(omega[..., :1]), omega], axis=-1)
    dq = 0.5 * quat.qmul(q, omega_q)
    return jnp.concatenate([v, acc, dq, domega], axis=-1)


def drift_and_sigma(model: NeuralSDE, params: Dict[str, Any], x: jax.Array,
                    u: jax.Array, precision=jax.lax.Precision.HIGHEST):
    """Fused (drift, sigma13) evaluation — one trunk pass for both."""
    res, sig6 = trunk_apply(params, x, u, precision=precision)
    return drift_terms(model, params, x, u, res), sigma13(x, sig6)


def drift_fn(model: NeuralSDE, params: Dict[str, Any], x: jax.Array, u: jax.Array) -> jax.Array:
    """Drift ``f(x,u)``: rigid-body prior + learned residual wrench.

    Broadcasts over leading batch dims of ``x`` (u broadcasts alongside).
    Prefer :func:`drift_and_sigma` in rollouts — it shares the trunk pass.
    """
    res, _ = trunk_apply(params, x, u)
    return drift_terms(model, params, x, u, res)


def diffusion_fn(model: NeuralSDE, params: Dict[str, Any], x: jax.Array, u: jax.Array) -> jax.Array:
    """Diagonal diffusion on the 6 velocity states, zero elsewhere.

    Returns the full 13-dim diagonal ``sigma`` so callers can treat the SDE
    uniformly. ``softplus`` head keeps sigma >= 0; a learnable global
    ``log_scale`` sets the overall noise magnitude (0 => deterministic ODE
    limit, used for mean-dynamics flight configs, reference
    ``num_particles: 1`` at ``launch/iris_sitl_traj_mpc.yaml:52``).
    """
    _, sig6 = trunk_apply(params, x, u)
    return sigma13(x, sig6)


def _init_mlp(rng: jax.Array, sizes, scale_last: float = 1e-3) -> Dict[str, np.ndarray]:
    """He-init MLP; near-zero last layer so the physics prior dominates at init."""
    params = {}
    keys = jax.random.split(rng, len(sizes) - 1)
    for i, (fan_in, fan_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        s = scale_last if i == len(sizes) - 2 else float(np.sqrt(2.0 / fan_in))
        params[f"w{i}"] = np.asarray(jax.random.normal(keys[i], (fan_in, fan_out)) * s, np.float32)
        params[f"b{i}"] = np.zeros((fan_out,), np.float32)
    return params


def init_params(rng: jax.Array, model: NeuralSDE, hidden: int = 64) -> Dict[str, Any]:
    """Fresh parameter pytree for a model (checkpoint layout v2: single trunk
    + combined 12-dim head: wrench residual [0:6], raw diffusion [6:12])."""
    feat = 9 + model.n_u
    return {
        "motor": {"log_gain": np.zeros((4,), np.float32)},
        "net": _init_mlp(rng, (feat, hidden, hidden, 12)),
        "diffusion_log_scale": np.float32(np.log(0.1)),
    }
