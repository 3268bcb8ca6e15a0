"""Amortized MPC policy network (L1).

A small MLP that maps (current state, reference window) directly to the
full H-step control plan in ONE forward pass — the receding-horizon solve
the reference runs 200 APG iterations for (``launch/iris_sitl_traj_mpc.yaml:60``)
collapsed into three matmuls. Trained by distilling converged APG
solves (``learning/distill.py``); served as a config-selectable solver
family (``solver: policy``, ``engine/mpc_loader.py``) so it rides the same
engine, telemetry, mesh, and fleet machinery as the optimizing solvers.

This is a capability the reference does not have; its closest analogue is
the learned-dynamics checkpoint the reference consumes
(``learned_model_params``, ``launch/iris_sitl_traj_mpc.yaml:3``) — here the
*controller itself* is learned, amortizing the solve. Rationale:
one policy evaluation is pure (B, feat)×(feat, hidden) matmul work — the
wide-matmul regime the serial APG horizon never reaches — so per-call
latency drops below the rollout floor and fleet width scales with batch.

Feature design (translation-invariant, solver/NED frame):

- per reference knot k (H+1 of them): position error ``p_ref−p``,
  velocity error ``v_ref−v``, attitude error ``qerr_vec(q, q_ref)``
  (the same small-angle error the cost penalizes, ``cost/cost.py``);
- body-rate ``ω`` and gravity direction in body frame (attitude proxy that
  avoids quaternion double-cover — same trick as the dynamics net,
  ``models/sde_model.py``);
- previous first control ``u_prev`` (slew context).

The head is squashed into the input box with a sigmoid, so the policy can
never emit an infeasible motor command (``enforce_ubound: True`` semantics,
``launch/iris_sitl_traj_mpc.yaml:14``); the last-layer bias is initialized
to the hover point so an untrained policy hovers instead of thrashing.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from sde4mbrl_px4_tpu.core import quaternion as quat
from sde4mbrl_px4_tpu.models.sde_model import mlp_apply, _init_mlp

__all__ = [
    "policy_feat_dim",
    "featurize",
    "init_policy",
    "policy_apply",
    "POLICY_KIND",
]

POLICY_KIND = "mpc_policy_v1"  # checkpoint meta tag


def policy_feat_dim(H: int, n_u: int) -> int:
    """Input width for a horizon-``H`` policy: 9 error features per
    reference knot (H+1 knots) + ω(3) + g_body(3) + u_prev(n_u)."""
    return 9 * (H + 1) + 6 + n_u


def featurize(x: jax.Array, x_ref: jax.Array, u_prev: jax.Array) -> jax.Array:
    """(13,), (H+1, 13), (n_u,) → (feat,) policy input, solver frame (NED).

    Batch by ``vmap`` — all ops broadcast over leading axes.
    """
    x = jnp.asarray(x, jnp.float32)
    q = quat.qnormalize(x[6:10])
    # canonical double-cover representative (q and -q are the same attitude)
    q = q * jnp.sign(jnp.where(q[0] == 0, 1.0, q[0]))
    rel_p = x_ref[:, 0:3] - x[0:3]                    # (H+1, 3)
    rel_v = x_ref[:, 3:6] - x[3:6]                    # (H+1, 3)
    q_ref = x_ref[:, 6:10]
    e_q = jax.vmap(lambda qr: quat.qerr_vec(q, qr))(q_ref)   # (H+1, 3)
    g_body = quat.qrotate_inv(q, jnp.array([0.0, 0.0, 1.0], jnp.float32))
    return jnp.concatenate([
        rel_p.reshape(-1), rel_v.reshape(-1), e_q.reshape(-1),
        x[10:13], g_body, jnp.asarray(u_prev, jnp.float32),
    ])


def init_policy(
    rng: jax.Array,
    H: int,
    n_u: int,
    lb: np.ndarray,
    ub: np.ndarray,
    uref: np.ndarray,
    hidden: Sequence[int] = (256, 256),
) -> Dict[str, Any]:
    """Fresh policy pytree. The output head starts at the hover logit so the
    untrained policy commands ``uref`` everywhere (same spirit as the
    dynamics net's near-zero residual head, ``models/sde_model.py``)."""
    feat = policy_feat_dim(H, n_u)
    sizes = (feat, *[int(h) for h in hidden], H * n_u)
    net = _init_mlp(rng, sizes, scale_last=1e-3)
    lb = np.broadcast_to(np.asarray(lb, np.float32), (n_u,))
    ub = np.broadcast_to(np.asarray(ub, np.float32), (n_u,))
    frac = np.clip((np.asarray(uref, np.float32) - lb) / (ub - lb), 1e-4, 1 - 1e-4)
    hover_logit = np.log(frac / (1.0 - frac))                  # sigmoid^-1
    i_last = len(sizes) - 2
    net[f"b{i_last}"] = np.tile(hover_logit, H).astype(np.float32)
    return {"net": net, "meta_H": np.int32(H), "meta_n_u": np.int32(n_u)}


def policy_apply(
    params: Dict[str, Any],
    feats: jax.Array,
    lb: jax.Array,
    ub: jax.Array,
) -> jax.Array:
    """(…, feat) → (…, H, n_u) control plan inside the input box."""
    H = int(params["meta_H"])
    n_u = int(params["meta_n_u"])
    raw = mlp_apply(params["net"], feats)              # (…, H*n_u)
    raw = raw.reshape(raw.shape[:-1] + (H, n_u))
    return lb + (ub - lb) * jax.nn.sigmoid(raw)
