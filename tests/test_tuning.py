"""On-chip MPPI hyper-parameter tuner (tuning/tuner.py).

Covers: grid construction, the tracer-safe continuous knobs (the same
closed loop scored with a TRACED config must match the statically-baked
config bit-for-bit), ranking sanity on a grid with a known-bad candidate,
and the dp-sharded sweep (grid padding + identical scores).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from sde4mbrl_px4_tpu.io.config import load_yaml_config
from sde4mbrl_px4_tpu.tuning import make_mppi_grid, tune_mppi
from sde4mbrl_px4_tpu.tuning.tuner import TuneResult


def _small_cfg(repo_config, trajectory=False):
    cfg = load_yaml_config(
        repo_config("iris_traj_mpc.yaml" if trajectory
                    else "iris_posctrl_mpc.yaml"))
    cfg["solver"] = "mppi"
    # Tiny budgets: the tests exercise wiring, not control quality.
    cfg["horizon"] = 6
    cfg["num_short_dt"] = 6
    cfg["mppi"] = {"samples": 8, "sigma": 0.02, "temperature": 0.1,
                   "iters": 3, "noise_beta": 0.5}
    return cfg


@pytest.fixture(scope="module")
def repo_config():
    import os

    root = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs")

    def path(name):
        return os.path.join(root, name)

    return path


def test_make_mppi_grid_shape_and_order():
    g = make_mppi_grid([0.01, 0.02], [0.1], [0.0, 0.5, 0.9])
    assert g.shape == (6, 3)
    # Cartesian product, sigma-major.
    assert np.allclose(g[0], [0.01, 0.1, 0.0])
    assert np.allclose(g[-1], [0.02, 0.1, 0.9])


def test_grid_shape_validation(repo_config):
    cfg = _small_cfg(repo_config)
    with pytest.raises(ValueError, match="grid must be"):
        tune_mppi(cfg, np.zeros((4, 2)), steps=2)


def test_traced_config_matches_static(repo_config):
    """A 1-row sweep must reproduce the statically-configured solver's
    closed loop exactly: the traced (sigma, temperature, noise_beta) path
    is the same computation."""
    from sde4mbrl_px4_tpu.core.frames import enu2ned
    from sde4mbrl_px4_tpu.core.types import hover_state
    from sde4mbrl_px4_tpu.engine.mpc_loader import make_mpc_from_config

    cfg = _small_cfg(repo_config)
    row = np.asarray([[0.02, 0.1, 0.5]], np.float32)
    steps = 4
    res = tune_mppi(dict(cfg), row, steps=steps, seed=0)[0]

    # Hand-run the identical closed loop with the config-baked solver.
    _, (reset_fn, mpc_fn), _, _ = make_mpc_from_config(
        dict(cfg))
    x = jnp.asarray(hover_state()).at[0].set(1.0)
    xdes = jnp.asarray(hover_state())
    tgt = enu2ned(xdes)
    rng = jax.random.PRNGKey(0)
    st = reset_fn(x, rng, x)
    jm = jax.jit(mpc_fn)
    errs = []
    for k in range(steps):
        u, st, rng, x_evol = jm(x, rng, st, jnp.float32(k * 0.05), xdes)
        x = x_evol[1]
        errs.append(float(jnp.linalg.norm(x[:3] - tgt[:3])))
    assert res.mean_pos_err == pytest.approx(float(np.mean(errs)), rel=1e-5)
    assert res.final_pos_err == pytest.approx(errs[-1], rel=1e-5)


def test_ranking_flags_degenerate_candidate(repo_config):
    """A near-zero-exploration candidate (sigma ~ 0 cannot correct the 1 m
    offset) must rank behind a sane one; results arrive sorted. The loop
    must be long enough (1.5 s) for the vehicle to actually move —
    tracking error is insensitive to the knobs over a few control periods."""
    cfg = _small_cfg(repo_config)
    cfg["mppi"] = {"samples": 16, "sigma": 0.02, "temperature": 0.1,
                   "iters": 5, "noise_beta": 0.5}
    grid = np.asarray([
        [1e-6, 0.1, 0.5],     # no exploration: stuck near the warm start
        [0.03, 0.1, 0.5],
    ], np.float32)
    res = tune_mppi(cfg, grid, steps=30, seed=0)
    assert all(np.isfinite([r.mean_pos_err for r in res]))
    assert res[0].mean_pos_err <= res[1].mean_pos_err
    assert res[0].sigma == pytest.approx(0.03)


def test_mesh_sharded_sweep_matches_single_device(repo_config):
    """dp-sharded sweep (grid padded to the axis size) returns the same
    scores as the unsharded run — and exercises the multi-chip path on the
    virtual 8-device CPU mesh."""
    from sde4mbrl_px4_tpu.parallel.mesh import make_mesh

    cfg = _small_cfg(repo_config)
    grid = make_mppi_grid([0.01, 0.03], [0.1], [0.0, 0.7])  # N=4 -> pad to 8
    mesh = make_mesh((len(jax.devices()), 1))
    res_plain = tune_mppi(dict(cfg), grid, steps=3, seed=1)
    res_mesh = tune_mppi(dict(cfg), grid, steps=3, seed=1, mesh=mesh)
    assert len(res_mesh) == len(res_plain) == grid.shape[0]
    for a, b in zip(res_plain, res_mesh):
        assert a.mean_pos_err == pytest.approx(b.mean_pos_err, rel=1e-5)
        assert (a.sigma, a.temperature, a.noise_beta) == (
            b.sigma, b.temperature, b.noise_beta)


def test_trajectory_config_sweep(repo_config):
    """Trajectory configs tune along their reference trajectory."""
    cfg = _small_cfg(repo_config, trajectory=True)
    res = tune_mppi(cfg, np.asarray([[0.02, 0.1, 0.5]], np.float32), steps=3)
    assert len(res) == 1 and np.isfinite(res[0].mean_pos_err)


def test_weight_grid_shape():
    from sde4mbrl_px4_tpu.tuning import make_weight_grid

    g = make_weight_grid([0.5, 1.0], [1.0], [1.0, 2.0], [1.0])
    assert g.shape == (4, 4)
    assert np.allclose(g[0], [0.5, 1.0, 1.0, 1.0])
    assert np.allclose(g[-1], [1.0, 1.0, 2.0, 1.0])


def test_weight_tuner_grid_validation(repo_config):
    from sde4mbrl_px4_tpu.tuning import tune_cost_weights

    cfg = _small_cfg(repo_config)
    cfg.pop("solver")
    with pytest.raises(ValueError, match="grid must be"):
        tune_cost_weights(cfg, np.zeros((2, 3)), steps=2)


def test_weight_tuner_ranks_position_weight(repo_config):
    """On a 1 m position step, scaling the position weight up must track
    better than scaling it down (common random numbers make the comparison
    deterministic); the effort term is reported."""
    from sde4mbrl_px4_tpu.tuning import make_weight_grid, tune_cost_weights

    cfg = load_yaml_config(repo_config("iris_posctrl_mpc.yaml"))
    cfg["horizon"] = 6
    cfg["num_short_dt"] = 6
    cfg["apg_mpc"]["max_iter"] = 15
    grid = make_weight_grid([0.2, 5.0], [1.0], [1.0], [1.0])
    res = tune_cost_weights(cfg, grid, steps=20, seed=0, effort_weight=0.05)
    assert res[0].p_scale == pytest.approx(5.0)
    assert res[0].mean_pos_err < res[1].mean_pos_err
    assert all(np.isfinite([r.score for r in res]))
    assert all(r.effort >= 0.0 for r in res)


def test_weight_tuner_deterministic_plant(repo_config):
    """noisy_plant=False scores against the mean dynamics (and two runs of
    it agree exactly)."""
    from sde4mbrl_px4_tpu.tuning import tune_cost_weights

    cfg = load_yaml_config(repo_config("iris_posctrl_mpc.yaml"))
    cfg["horizon"] = 6
    cfg["num_short_dt"] = 6
    cfg["apg_mpc"]["max_iter"] = 10
    grid = np.asarray([[1.0, 1.0, 1.0, 1.0]], np.float32)
    a = tune_cost_weights(dict(cfg), grid, steps=4, noisy_plant=False)[0]
    b = tune_cost_weights(dict(cfg), grid, steps=4, noisy_plant=False)[0]
    assert a.mean_pos_err == b.mean_pos_err


def test_weight_yaml_block():
    from sde4mbrl_px4_tpu.tuning import WeightTuneResult

    r = WeightTuneResult(p_scale=2.0, v_scale=1.0, q_scale=0.5, w_scale=1.0,
                         score=0.1, mean_pos_err=0.1, effort=0.01)
    import yaml

    block = yaml.safe_load(r.yaml_block(
        {"perr": [10, 10, 20], "verr": 1.0, "qerr": [2, 2, 2],
         "werr": [1, 1, 1]}))
    assert block["cost_params"]["perr"] == [20, 20, 40]
    assert block["cost_params"]["qerr"] == [1, 1, 1]


def test_yaml_block_roundtrip():
    r = TuneResult(sigma=0.02, temperature=0.1, noise_beta=0.7,
                   mean_pos_err=0.1, final_pos_err=0.05)
    import yaml

    block = yaml.safe_load(r.yaml_block(samples=64, iters=8))
    assert block["mppi"] == {"samples": 64, "sigma": 0.02,
                             "temperature": 0.1, "iters": 8,
                             "noise_beta": 0.7}
