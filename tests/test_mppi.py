"""MPPI solver (solver/mppi.py): toy-problem convergence, APGState
contract, and the `solver: mppi` config family end-to-end through the MPC
loader (receding-horizon closed loop)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sde4mbrl_px4_tpu.solver.mppi import MPPIConfig, mppi_solve


def test_mppi_converges_on_quadratic():
    """min ||u - u*||^2 over a box: the weighted mean walks to the optimum
    (interior) and pins to the box face when u* is outside."""
    H, n = 8, 3
    u_star = jnp.full((H, n), 0.4)
    cost = lambda u: jnp.sum((u - u_star) ** 2)
    lb, ub = jnp.zeros(n), jnp.ones(n)
    cfg = MPPIConfig(samples=256, sigma=0.08, temperature=0.05, iters=40,
                     noise_beta=0.0)
    st = mppi_solve(cost, jnp.full((H, n), 0.9), lb, ub, cfg,
                    jax.random.PRNGKey(0))
    np.testing.assert_allclose(np.asarray(st.yk), 0.4, atol=0.08)
    assert float(st.opt_cost) < float(st.init_cost)
    # observability contract
    assert float(st.num_steps) == 40
    assert float(st.avg_linesearch) == 256
    # boundary optimum: u* outside the box clips to the face
    st2 = mppi_solve(lambda u: jnp.sum((u - 1.5) ** 2),
                     jnp.full((H, n), 0.2), lb, ub, cfg,
                     jax.random.PRNGKey(1))
    np.testing.assert_allclose(np.asarray(st2.yk), 1.0, atol=0.08)


def test_mppi_deterministic_per_rng():
    cost = lambda u: jnp.sum(u ** 2)
    cfg = MPPIConfig(samples=64, iters=5)
    args = (cost, jnp.full((4, 2), 0.5), jnp.zeros(2), jnp.ones(2), cfg)
    a = mppi_solve(*args, jax.random.PRNGKey(7))
    b = mppi_solve(*args, jax.random.PRNGKey(7))
    np.testing.assert_array_equal(np.asarray(a.yk), np.asarray(b.yk))
    c = mppi_solve(*args, jax.random.PRNGKey(8))
    assert not np.array_equal(np.asarray(a.yk), np.asarray(c.yk))


def test_mppi_config_closed_loop(repo_root):
    """`solver: mppi` end-to-end: the receding-horizon loop tracks a
    position step with the sampling solver (same mpc_fn contract)."""
    from sde4mbrl_px4_tpu.core.frames import enu2ned, ned2enu
    from sde4mbrl_px4_tpu.core.types import hover_state
    from sde4mbrl_px4_tpu.engine.mpc_loader import make_mpc_from_config
    from sde4mbrl_px4_tpu.io.config import load_yaml_config

    cfg = load_yaml_config(os.path.join(repo_root,
                                        "configs/iris_posctrl_mpc.yaml"))
    cfg["solver"] = "mppi"
    cfg["mppi"] = {"samples": 256, "sigma": 0.02, "temperature": 0.1,
                   "iters": 8, "noise_beta": 0.7}
    cfg, (reset_fn, mpc_fn), _, _ = make_mpc_from_config(cfg)
    dt = float(cfg["_time_steps"][0])

    x = jnp.asarray(hover_state()).at[0].set(1.0)   # 1 m offset (NED)
    tgt = jnp.asarray(hover_state())                # hold the ENU origin-hover
    rng = jax.random.PRNGKey(0)
    st = reset_fn(x, rng, x)
    jm = jax.jit(mpc_fn)
    e0 = float(jnp.linalg.norm(x[:3]))
    for k in range(30):
        u, st, rng, x_evol = jm(x, rng, st, jnp.float32(0.0), tgt)
        x = x_evol[1]
    e1 = float(jnp.linalg.norm(np.asarray(x)[:3]))
    assert np.isfinite(np.asarray(u)).all()
    assert e1 < 0.35 * e0, (e0, e1)   # sampling MPC closes most of the gap
    assert st.num_steps == 8 and st.avg_linesearch == 256


def test_mppi_composes_with_batched_mesh(repo_root):
    """solver: mppi through make_batched_mpc: B sampling controllers as one
    dp-sharded program."""
    from sde4mbrl_px4_tpu.io.config import load_yaml_config
    from sde4mbrl_px4_tpu.parallel.batched import make_batched_mpc, make_batch_inputs
    from sde4mbrl_px4_tpu.parallel.mesh import make_mesh
    from jax.sharding import NamedSharding, PartitionSpec as P

    cfg = load_yaml_config(os.path.join(repo_root, "configs/iris_posctrl_mpc.yaml"))
    cfg["solver"] = "mppi"
    cfg["mppi"] = {"samples": 32, "iters": 3}
    cfg["horizon"] = 5
    cfg["num_short_dt"] = 5
    mesh = make_mesh((jax.device_count(), 1))
    reset_b, mpc_b, _ = make_batched_mpc(cfg, mesh)
    B = 2 * jax.device_count()
    xs, rngs = make_batch_inputs(mesh, B, spread=0.3)
    ts = jax.device_put(jnp.zeros((B,)), NamedSharding(mesh, P("dp")))
    st = reset_b(xs, rngs, xs)
    sol = mpc_b(xs, rngs, st, ts, xs)
    assert sol.u_opt.shape == (B, 5, 4)
    assert np.isfinite(np.asarray(sol.u_opt)).all()
    # per-row rng streams: different scenarios explore differently
    u = np.asarray(sol.u_opt)
    assert not np.allclose(u[0], u[1])


def test_mppi_with_proximal_slack_config(repo_root):
    """solver: mppi on a slack_proximal config: the sampled decision
    sequence includes the slack-target columns, candidates project into the
    joint box, and the solve stays finite."""
    from sde4mbrl_px4_tpu.core.types import hover_state
    from sde4mbrl_px4_tpu.engine.mpc_loader import make_mpc_from_config
    from sde4mbrl_px4_tpu.io.config import load_yaml_config

    cfg = load_yaml_config(
        os.path.join(repo_root, "configs/iris_constr_posctrl_mpc.yaml"))
    assert cfg["state_constr"].get("slack_proximal")
    cfg["solver"] = "mppi"
    cfg["mppi"] = {"samples": 48, "iters": 4}
    cfg["horizon"] = 5
    cfg["num_short_dt"] = 5
    cfg, (reset_fn, mpc_fn), _, _ = make_mpc_from_config(cfg)
    x0 = hover_state()
    rng = jax.random.PRNGKey(0)
    st = reset_fn(x0, rng, x0)
    sol = jax.jit(mpc_fn)(x0, rng, st, jnp.float32(0.0), x0)
    assert sol.u_opt.shape == (5, 4)          # slack columns split off
    assert np.isfinite(np.asarray(sol.u_opt)).all()
    assert np.isfinite(float(sol.opt_state.opt_cost))
