"""The solver's cost oracle — value, batched value and value-and-gradient
of the XLA rollout + cost (``solver/apg.CostOracle.from_fn``) — checked
against central finite differences at flagship width (H=20, the shipped
64-wide trunk), over the cost terms the configs exercise: trajectory
tracking, position hold with the slew constraint, penalty-form and
proximal-slack state constraints, Monte-Carlo particles and antithetic
particles."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sde4mbrl_px4_tpu.core.types import hover_state
from sde4mbrl_px4_tpu.cost.cost import make_cost_fn
from sde4mbrl_px4_tpu.engine.mpc_loader import make_mpc_from_config
from sde4mbrl_px4_tpu.io.config import load_yaml_config
from sde4mbrl_px4_tpu.ops.rollout import rollout_sde
from sde4mbrl_px4_tpu.solver.apg import CostOracle

_PENALTY = {
    "state_id": [3, 4, 5, 10, 11, 12],
    "state_penalty": [10.0, 10.0, 20.0, 10.0, 10.0, 10.0],
    "slack_scaling": [3.0] * 6,
    "state_bound": [[-0.1, 0.1], [-0.1, 0.1], [-0.1, 0.1],
                    [-0.2, 0.2], [-0.2, 0.2], [-0.2, 0.2]],
    "slack_proximal": False,
    "constr_pen": 0.5,
}

# name -> (config file, overrides)
CASES = {
    "traj": ("iris_traj_mpc.yaml", {}),
    "pos_slew": ("iris_posctrl_mpc.yaml", {}),
    "penalty_constr": ("iris_posctrl_mpc.yaml", {"state_constr": _PENALTY}),
    "prox_slack": ("iris_constr_posctrl_mpc.yaml", {}),
    "particles8": ("iris_traj_mpc.yaml", {"num_particles": 8}),
    "antithetic8": ("iris_traj_mpc.yaml", {"num_particles": 8,
                                           "antithetic": True}),
}


def _oracle(repo_root, name):
    base, over = CASES[name]
    cfg = load_yaml_config(os.path.join(repo_root, "configs", base))
    cfg.update(over)
    _, _, _, b = make_mpc_from_config(cfg)
    cp = b.cost_params
    H, n = int(b.time_steps.shape[0]), b.model.n_u
    m = 0 if cp.slack_sel is None else int(cp.slack_sel.shape[0])
    P = b.num_particles
    x0 = hover_state().at[0].set(0.3).at[3].set(0.4)   # violating velocity
    x_ref = jnp.broadcast_to(hover_state(), (H + 1, 13))
    cost_fn = make_cost_fn(cp, b.time_steps)
    rng = jax.random.PRNGKey(1)

    def seq_cost(z):
        u, s = (z[:, :n], z[:, n:]) if m else (z, None)
        xp, sg = rollout_sde(b.model, b.params, x0, u, b.time_steps, rng,
                             max(P, 1), deterministic=P <= 1,
                             precision=b.precision,
                             antithetic=bool(cfg.get("antithetic")))
        return cost_fn(xp, sg, u, x_ref, cp.uref, s_seq=s)

    o = CostOracle.from_fn(seq_cost)
    oracle = CostOracle(value=jax.jit(o.value),
                        value_batch=jax.jit(o.value_batch),
                        value_and_grad=jax.jit(o.value_and_grad))
    r = jax.random.uniform(jax.random.PRNGKey(3), (H, n + m),
                           minval=0.45, maxval=0.85)
    z = r.at[:, n:].set(0.2 * (r[:, n:] - 0.65))
    return oracle, z


@pytest.mark.parametrize("name", sorted(CASES))
def test_cost_gradient_matches_central_differences(repo_root, name):
    oracle, z = _oracle(repo_root, name)
    v, g = oracle.value_and_grad(z)
    assert np.isfinite(float(v)) and np.isfinite(np.asarray(g)).all()
    assert float(v) == pytest.approx(float(oracle.value(z)), rel=1e-6)
    # Directional derivatives along random unit directions: a float32
    # central difference resolves <g, d> to ~3e-4 relative at this step.
    eps = 1e-3
    dirs = jax.random.normal(jax.random.PRNGKey(7), (4,) + z.shape)
    dirs = dirs / jnp.linalg.norm(dirs.reshape(4, -1), axis=1)[:, None, None]
    fd_pts = jnp.concatenate([z[None] + eps * dirs, z[None] - eps * dirs])
    vals = np.asarray(oracle.value_batch(fd_pts), np.float64)
    fd = (vals[:4] - vals[4:]) / (2 * eps)
    an = np.asarray(jnp.sum(g[None] * dirs, axis=(1, 2)), np.float64)
    scale = max(np.abs(an).max(), 1.0)
    np.testing.assert_allclose(fd, an, rtol=5e-3, atol=5e-3 * scale)
    # the batched oracle agrees with single evaluations
    np.testing.assert_allclose(vals[:2], [float(oracle.value(p))
                                          for p in fd_pts[:2]], rtol=1e-5)
