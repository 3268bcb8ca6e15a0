"""Mesh-sharding correctness (L6): sharded solves must equal unsharded ones.

SURVEY.md §7 "PRNG parity": Brownian increments must be reproducible across
sharding layouts — the counter-based single-draw design makes the sampled
paths independent of the mesh shape, so a particle-sharded solve equals the
single-device solve bit-for-tolerance, and a scenario-DP batch equals the
per-scenario loop."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from sde4mbrl_px4_tpu.core.types import hover_state
from sde4mbrl_px4_tpu.parallel.mesh import best_mesh_shape, make_mesh, scenario_sharding


@pytest.fixture(scope="module")
def small_cfg(repo_root):
    import yaml

    cfg = yaml.safe_load(open(os.path.join(repo_root, "configs/iris_posctrl_mpc.yaml")))
    cfg["horizon"] = 6
    cfg["num_short_dt"] = 6
    cfg["apg_mpc"]["max_iter"] = 12
    cfg["apg_mpc"]["max_no_improvement_iter"] = 12
    cfg["learned_model_params"] = os.path.join(repo_root, "configs/models/iris_sde.pkl")
    return cfg


def test_mesh_construction():
    mesh = make_mesh()
    assert mesh.devices.size == len(jax.devices())
    assert mesh.axis_names == ("dp", "mc")


def test_best_mesh_shape():
    assert best_mesh_shape(8, 64, 1) == (8, 1)
    dp, mc = best_mesh_shape(8, 4, 8)
    assert dp * mc == 8 and 8 % mc == 0


@pytest.mark.slow
def test_batched_dp_equals_individual_solves(small_cfg):
    """Each scenario's sharded solve == its standalone solve."""
    from sde4mbrl_px4_tpu.engine.mpc_loader import make_mpc_from_config
    from sde4mbrl_px4_tpu.parallel.batched import make_batched_mpc

    n_dev = len(jax.devices())
    mesh = make_mesh((n_dev, 1))
    reset_b, mpc_b, _ = make_batched_mpc(dict(small_cfg), mesh)

    B = n_dev
    rs = np.random.RandomState(0)
    xs_np = np.tile(np.asarray(hover_state()), (B, 1)).astype(np.float32)
    xs_np[:, 0:3] += 0.3 * rs.randn(B, 3).astype(np.float32)
    rngs = jax.random.split(jax.random.PRNGKey(7), B)

    sh = NamedSharding(mesh, P("dp", None))
    xs = jax.device_put(jnp.asarray(xs_np), sh)
    rngs_s = jax.device_put(rngs, sh)
    ts = jax.device_put(jnp.zeros((B,)), NamedSharding(mesh, P("dp")))
    st = reset_b(xs, rngs_s, xs)
    sol = mpc_b(xs, rngs_s, st, ts, xs)
    u_batched = np.asarray(sol.u_opt)

    # standalone solves, same inputs
    _, (reset_1, mpc_1), _, _ = make_mpc_from_config(dict(small_cfg))
    for i in range(B):
        x_i = jnp.asarray(xs_np[i])
        st_i = reset_1(x_i, rngs[i], x_i)
        sol_i = mpc_1(x_i, rngs[i], st_i, jnp.float32(0.0), x_i)
        np.testing.assert_allclose(u_batched[i], np.asarray(sol_i.u_opt),
                                   rtol=2e-4, atol=2e-5)


@pytest.mark.slow
def test_particle_sharded_equals_unsharded(small_cfg):
    """PRNG parity: sharding the MC particle axis over the mesh must not
    change the sampled Brownian paths, hence not the solve."""
    from sde4mbrl_px4_tpu.engine.mpc_loader import make_mpc_from_config
    from sde4mbrl_px4_tpu.parallel.batched import make_particle_sharded_mpc

    n_dev = len(jax.devices())
    mc = 2 if n_dev >= 2 else 1
    mesh = make_mesh((n_dev // mc, mc))
    cfg = dict(small_cfg)
    cfg["num_particles"] = 4 * mc

    reset_p, mpc_p, _ = make_particle_sharded_mpc(dict(cfg), mesh)
    _, (reset_u, mpc_u), _, _ = make_mpc_from_config(dict(cfg))

    x0 = hover_state().at[0].set(0.4)
    rng = jax.random.PRNGKey(3)
    st_p = reset_p(x0, rng, x0)
    st_u = reset_u(x0, rng, x0)
    sol_p = mpc_p(x0, rng, st_p, jnp.float32(0.0), x0)
    sol_u = mpc_u(x0, rng, st_u, jnp.float32(0.0), x0)
    np.testing.assert_allclose(np.asarray(sol_p.u_opt), np.asarray(sol_u.u_opt),
                               rtol=2e-4, atol=2e-5)
    assert float(sol_p.opt_state.opt_cost) == pytest.approx(
        float(sol_u.opt_state.opt_cost), rel=2e-4)


def test_scenario_sharding_layout():
    mesh = make_mesh()
    sh = scenario_sharding(mesh, rank=3)
    assert sh.spec == P("dp", None, None)


def test_batched_warm_start_donation(small_cfg):
    """Donated opt_state buffers: repeated steps run without growth/error and
    keep improving or holding cost."""
    from sde4mbrl_px4_tpu.parallel.batched import make_batch_inputs, make_batched_mpc

    n_dev = len(jax.devices())
    mesh = make_mesh((n_dev, 1))
    reset_b, mpc_b, _ = make_batched_mpc(dict(small_cfg), mesh)
    xs, rngs = make_batch_inputs(mesh, n_dev, spread=0.3)
    ts = jax.device_put(jnp.zeros((n_dev,)), NamedSharding(mesh, P("dp")))
    st = reset_b(xs, rngs, xs)
    sol = mpc_b(xs, rngs, st, ts, xs)
    c1 = np.asarray(sol.opt_state.opt_cost)
    for _ in range(3):
        sol = mpc_b(xs, sol.rng, sol.opt_state, ts, xs)
    c4 = np.asarray(sol.opt_state.opt_cost)
    assert np.all(np.isfinite(c4))
    assert np.median(c4) <= np.median(c1) * 1.05  # warm starts don't regress
