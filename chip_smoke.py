#!/usr/bin/env python
"""GPU smoke run of the MPC engine's main path, through its normal entry
points, at the shipped configs' full size.

    python chip_smoke.py          # phases 0-6 on one GPU
    python chip_smoke.py --four   # only the four-GPU path and the
                                  # one-GPU run it is compared with

Phases (each prints one ``PHASE <n> <name> {json}`` line; any failure
exits non-zero before the result line):

0. device      — a GPU must be JAX's default device; card name and power
                 limit (nvidia-smi), device kind, JAX version, cache dir.
1. flagship    — ``CompiledMPC(configs/iris_traj_mpc.yaml)`` bring-up, then
                 60 warm-started receding-horizon solves on the lemniscate.
2. hexa        — the same on ``configs/hexa_traj_mpc.yaml`` (6 motors).
3. goldens     — the 9 committed golden traces replayed on the card.
4. deadline    — the 512-path antithetic config with
                 ``apg_mpc.deadline_ms: 30`` through ``CompiledMPC``.
5. closed_loop — ``examples/closed_loop_sim.py --seconds 5 --deadline-ms 30``
                 in this process: async engine, FCU sim over UDP MAVLink,
                 mailbox, at real-time pace.
6. fleet       — ``FleetEngine`` at B=64 on ``configs/iris_posctrl_mpc.yaml``.

The last line of standard output is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
Everything runs in this one process: a JAX process reserves most of the
card's memory, so a second one on the same card would fail.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

PHASES = ("device", "flagship", "hexa", "goldens", "deadline", "closed_loop",
          "fleet")
FOUR_PHASES = ("device", "four")

# Golden gates: ``engine/goldens.gate_trace`` (commands within 0.03 motor
# units and converged costs within 2 % of the committed CPU float32 traces,
# each widened per tick by the CPU reference's own spread under ulp-scale
# input perturbation; the hexa's commands reported, not gated; pickup
# indices and engagement modes exact).
TRACK_TOL_M = 0.15


class SmokeFailure(RuntimeError):
    """A phase's gate failed."""


class NoAccelerator(SmokeFailure):
    """JAX's default device is not a GPU."""


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def _report(n: int, name: str, fields: dict) -> None:
    print(f"PHASE {n} {name} {json.dumps(fields, default=float)}",
          flush=True)


def _cfg(name: str) -> str:
    return os.path.join(HERE, "configs", name)


def _cache_entries(cache_dir: str) -> int:
    if not os.path.isdir(cache_dir):
        return 0
    return sum(1 for f in os.listdir(cache_dir) if f.endswith("-cache"))


def _pct(a, q) -> float:
    import numpy as np

    return float(np.percentile(np.asarray(a), q))


# ------------------------------------------------------------------ phase 0


def phase_device(cache_dir: str) -> dict:
    """The default device must be a GPU (no CPU fallback)."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise NoAccelerator(f"JAX found no GPU: default device platform is "
                            f"{devs[0].platform!r}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    _check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    for line in smi.stdout.strip().splitlines():
        print(f"nvidia-smi: {line.strip()}", flush=True)
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "jax": jax.__version__,
            "cache_dir": cache_dir, "cache_entries": _cache_entries(cache_dir)}


# --------------------------------------------------------------- phases 1-2


def phase_tracking(cfg_path: str, n_solves: int, cache_dir: str,
                   t0: float = 3.0) -> dict:
    """Bring up ``CompiledMPC`` on a trajectory config and run ``n_solves``
    warm-started receding-horizon solves, each from the state the previous
    plan predicts (bench.py's blocking loop)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from sde4mbrl_px4_tpu.core.frames import enu2ned
    from sde4mbrl_px4_tpu.engine.controller import CompiledMPC

    before = _cache_entries(cache_dir)
    t_start = time.perf_counter()
    cm = CompiledMPC(cfg_path)
    ready_s = time.perf_counter() - t_start
    cache = "warm" if before and _cache_entries(cache_dir) == before \
        else "cold"

    dt = float(cm.cfg["_time_steps"][0])
    ref = lambda t: np.asarray(enu2ned(cm.state_from_traj(np.float32(t))))
    x = jnp.asarray(ref(t0))
    rng = jax.random.PRNGKey(0)
    sol = cm.mpc(x, rng, cm.reset(x, rng, x), jnp.float32(t0), x)
    jax.block_until_ready(sol.u_opt)
    lb, ub = np.asarray(cm.bundle.lb), np.asarray(cm.bundle.ub)

    lat, steps, errs = [], [], []
    t = t0 + dt
    for _ in range(n_solves):
        t1 = time.perf_counter()
        sol = cm.mpc(sol.x_evol[1], sol.rng, sol.opt_state, jnp.float32(t),
                     x)
        u = np.asarray(sol.u_opt)              # blocks on the solve
        lat.append(time.perf_counter() - t1)
        steps.append(float(sol.opt_state.num_steps))
        _check(np.isfinite(u).all(), f"non-finite u at t={t:.2f}")
        _check((u >= lb - 1e-6).all() and (u <= ub + 1e-6).all(),
               f"u outside [lb, ub] at t={t:.2f}")
        x_next = np.asarray(sol.x_evol[1])
        errs.append(float(np.linalg.norm(x_next[:3] - ref(t + dt)[:3])))
        t += dt
    err = float(np.mean(errs))
    _check(err < TRACK_TOL_M,
           f"mean position error {err:.3f} m >= {TRACK_TOL_M} m")
    return {"config": os.path.basename(cfg_path), "n_u": cm.n_u,
            "ready_s": ready_s, "cache": cache, "solves": n_solves,
            "p50_ms": _pct(lat, 50) * 1e3, "p99_ms": _pct(lat, 99) * 1e3,
            "steps_mean": float(np.mean(steps)),
            "steps_max": float(np.max(steps)),
            "ms_per_iter": 1e3 * float(np.sum(lat)) / max(np.sum(steps), 1),
            "pos_err_mean_m": err, "precision": str(cm.bundle.precision)}


# ------------------------------------------------------------------ phase 3


def _replay_capped(c, replay):
    """Run ``replay(c)`` and mark the ticks whose solve hit its solver's
    iteration cap (idle ticks report the trajectory pre-warm's stats)."""
    import numpy as np

    recs = []
    solve_once = c.solve_once

    def recording(*a, **k):
        rec = solve_once(*a, **k)
        recs.append(rec)
        return rec

    c.solve_once = recording
    try:
        out = replay(c)
    finally:
        del c.solve_once
    cap = {"traj": c.traj.max_iter, "idle": c.traj.max_iter,
           "pos": c.pos.max_iter, "none": c.pos.max_iter}
    capped = np.asarray([r.num_steps >= cap[r.ctrl_state] for r in recs])
    return out, capped


def phase_goldens(vehicles=("iris", "hexa"), families=None) -> dict:
    """Replay the committed golden traces: per vehicle the pos and traj
    flagship traces and the engagement sequence, then the solver-family
    traces (MPPI K=64, policy, 512-path antithetic).

    Each tick's gates are widened by the committed spread of the CPU
    reference under ulp-scale input perturbation. The over-actuated hexa
    (6 motors, 4 wrench axes) has ticks where a 1-ulp input change alone
    moves a converged command by 0.1-0.2 motor units at unchanged cost (a
    jump between two branches with three motors on the upper bound), so
    its commands are reported and its costs and pickup indices gated."""
    import numpy as np

    from sde4mbrl_px4_tpu.engine import goldens as G
    from sde4mbrl_px4_tpu.engine.controller import RecedingHorizonController
    from sde4mbrl_px4_tpu.engine.mpc_loader import make_mpc_from_config

    if families is None:
        families = tuple(sorted(G.SOLVER_FAMILIES))
    gold = G.golden_dir(HERE)
    rows = []
    for v in vehicles:
        spread = G.load_spread(HERE, v)
        c = RecedingHorizonController(_cfg(f"{v}_traj_mpc.yaml"),
                                      _cfg(f"{v}_posctrl_mpc.yaml"),
                                      seed=0, now_fn=lambda: 0.0)
        try:
            for name, replay in G.CONTROLLER_REPLAYS.items():
                if name == "engagement":
                    (modes, tr, costs), capped = _replay_capped(
                        c, G.replay_engagement)
                else:
                    (tr, costs), capped = replay(c), None
                ref = np.load(os.path.join(gold, f"{v}_{name}_trace.npz"))
                row = {"trace": f"{v}_{name}", **G.gate_trace(
                    tr, costs, ref, spread[f"{name}_u"],
                    spread[f"{name}_cost"], capped,
                    gate_u=c.traj.n_u <= 4)}
                if name == "engagement":
                    row["modes_exact"] = bool(np.array_equal(
                        modes, ref["modes"].astype(np.int32)))
                    row["pass"] = row["pass"] and row["modes_exact"]
                cm = c.pos if name == "pos_flagship" else c.traj
                row["precision"] = str(cm.bundle.precision)
                rows.append(row)
        finally:
            c.close()
    for fam in families:
        tr = G.replay_solver_family(HERE, fam)
        ref = np.load(os.path.join(gold, f"family_{fam}_trace.npz"))["trace"]
        du = float(np.abs(tr[:, :-1] - ref[:, :-1]).max())
        _, _, _, b = make_mpc_from_config(G.family_config(HERE, fam))
        rows.append({"trace": f"family_{fam}", "max_du": du,
                     "steps": tr[:, -1].tolist(),
                     "steps_golden": ref[:, -1].tolist(),
                     "precision": str(b.precision), "pass": du <= G.U_TOL})
    for r in rows:
        print(f"golden {json.dumps(r)}", flush=True)
    bad = [r["trace"] for r in rows if not r["pass"]]
    _check(not bad, f"golden traces outside the gates: {bad}")
    return {"traces": len(rows),
            "max_du": max(r["max_du"] for r in rows),
            "max_cost_rel_converged": max(
                (r.get("cost_rel_converged", 0.0) for r in rows)),
            "gates": {"u": G.U_TOL, "cost_rel": G.C_TOL, "idx": "exact",
                      "u_max_with_spread": max(
                          r.get("gate_u_max") or G.U_TOL for r in rows),
                      "u_reported_only": [r["trace"] for r in rows
                                          if r.get("gate_u_max", 0) is None]}}


# ------------------------------------------------------------------ phase 4


def phase_deadline(n_solves: int = 20, particles: int = 512,
                   deadline_ms: float = 30.0, t0: float = 3.0) -> dict:
    """Deadline-aware particle solve: the engine's ms/iteration EWMA turns
    the deadline into a per-solve iteration budget."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from sde4mbrl_px4_tpu.core.frames import enu2ned
    from sde4mbrl_px4_tpu.engine.controller import CompiledMPC
    from sde4mbrl_px4_tpu.io.config import load_yaml_config

    cfg = load_yaml_config(_cfg("iris_traj_mpc.yaml"))
    cfg["num_particles"] = particles
    cfg["antithetic"] = True
    cfg["apg_mpc"]["deadline_ms"] = deadline_ms
    t_start = time.perf_counter()
    cm = CompiledMPC(cfg)
    ready_s = time.perf_counter() - t_start
    dt = float(cm.cfg["_time_steps"][0])
    x = jnp.asarray(enu2ned(cm.state_from_traj(np.float32(t0))))
    rng = jax.random.PRNGKey(0)
    st = cm.reset(x, rng, x)
    lat, steps, budgets = [], [], []
    t = t0
    for _ in range(n_solves):
        budget = cm.iter_budget()
        t1 = time.perf_counter()
        sol = cm.mpc(x, rng, st, jnp.float32(t), x, jnp.int32(budget))
        u = np.asarray(sol.u_opt)
        wall = time.perf_counter() - t1
        n = float(sol.opt_state.num_steps)
        cm.observe_solve(wall, n)
        _check(np.isfinite(u).all(), f"non-finite u at t={t:.2f}")
        _check(n <= budget, f"{n} steps > budget {budget}")
        lat.append(wall)
        steps.append(n)
        budgets.append(budget)
        x, rng, st = sol.x_evol[1], sol.rng, sol.opt_state
        t += dt
    return {"particles": particles, "deadline_ms": deadline_ms,
            "ready_s": ready_s, "p50_ms": _pct(lat, 50) * 1e3,
            "p99_ms": _pct(lat, 99) * 1e3,
            "steps_mean": float(np.mean(steps)),
            "budget_first": budgets[0], "budget_last": budgets[-1],
            "precision": str(cm.bundle.precision)}


# ------------------------------------------------------------------ phase 5


def _load_example(name: str):
    path = os.path.join(HERE, "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_native() -> None:
    """Build ``csrc/libmpc_native.so`` from the tracked sources if absent
    (the mailbox and MAVLink codec of the async engine live there)."""
    if os.path.exists(os.path.join(HERE, "csrc", "libmpc_native.so")):
        return
    r = subprocess.run(["make", "-C", os.path.join(HERE, "csrc")],
                       capture_output=True, text=True, timeout=300)
    _check(r.returncode == 0, f"make -C csrc failed:\n{r.stderr[-2000:]}")


def phase_closed_loop(seconds: float = 5.0, time_scale: float = 1.0,
                      port: int = 24998, deadline_ms: float = 30.0) -> dict:
    """``examples/closed_loop_sim.py --seconds 5 --deadline-ms 30`` in this
    process, at real-time pace; its own PASS rule is the gate. The
    deadline arms the engine's iteration budget: the unbounded XLA solve's
    tail (~240 ms at 200 iterations on the H100) is longer than the 50 ms
    period, and a plan picked up four indices stale does not track."""
    build_native()
    ex = _load_example("closed_loop_sim")
    res = ex.fly(ex.parse_args(["--seconds", str(seconds), "--time-scale",
                                str(time_scale), "--port", str(port),
                                "--deadline-ms", str(deadline_ms)]))
    _check(res["ok"], f"closed loop FAILED its PASS rule: {res}")
    return res


# ------------------------------------------------------------------ phase 6


def phase_fleet(batch: int = 64, ticks: int = 20, devices=None,
                max_iter=None) -> dict:
    """``FleetEngine`` serving ``batch`` vehicles on the given devices
    (default: the first device), each tick's states taken from the
    collected plans' predictions."""
    import jax
    import numpy as np

    from sde4mbrl_px4_tpu.core.types import hover_state
    from sde4mbrl_px4_tpu.io.config import load_yaml_config
    from sde4mbrl_px4_tpu.parallel.fleet import FleetEngine
    from sde4mbrl_px4_tpu.parallel.mesh import make_mesh

    devices = list(devices or jax.devices()[:1])
    cfg = load_yaml_config(_cfg("iris_posctrl_mpc.yaml"))
    if max_iter is not None:
        cfg["apg_mpc"]["max_iter"] = max_iter
    mesh = make_mesh((len(devices), 1), devices=devices)
    t_start = time.perf_counter()
    eng = FleetEngine(cfg, mesh, batch=batch, seed=0)
    ang = 2 * np.pi * np.arange(batch) / batch
    targets = np.tile(np.asarray(hover_state()), (batch, 1)).astype(
        np.float32)
    targets[:, 0] = 2.0 * np.cos(ang)
    targets[:, 1] = 2.0 * np.sin(ang)
    targets[:, 2] = 1.0
    states = np.tile(np.asarray(hover_state()), (batch, 1)).astype(np.float32)
    eng.reset(states)
    u, x_evol, _ = eng.step(states, targets)        # compiles
    ready_s = time.perf_counter() - t_start
    busy = []
    for _ in range(ticks):
        t1 = time.perf_counter()
        u, x_evol, _ = eng.step(states, targets)
        busy.append(time.perf_counter() - t1)
        _check(u.shape == (batch, eng.n_u), f"u shape {u.shape}")
        _check(x_evol.shape == (batch, eng.H + 1, 13),
               f"x_evol shape {x_evol.shape}")
        _check(np.isfinite(u).all() and np.isfinite(x_evol).all(),
               "non-finite fleet plan")
        states = np.ascontiguousarray(x_evol[:, 1], np.float32)
    return {"batch": batch, "devices": len(devices), "ticks": ticks,
            "ready_s": ready_s, "tick_p50_ms": _pct(busy, 50) * 1e3,
            "tick_p99_ms": _pct(busy, 99) * 1e3}


# ------------------------------------------------------------ four cards


def _dp_solve(cfg, mesh, batch: int, t0: float = 3.0):
    """One re-targeted scenario-DP solve of ``batch`` flagship scenarios:
    each scenario tracks its own lemniscate window from a perturbed state.
    Returns (u, wall_s of the timed solve, all-reduce count in the HLO)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from sde4mbrl_px4_tpu.core.frames import enu2ned
    from sde4mbrl_px4_tpu.parallel.batched import make_batched_mpc

    reset_b, mpc_b, bundle = make_batched_mpc(cfg, mesh)
    sft = jax.jit(lambda t: enu2ned(bundle.state_from_traj(t)))
    ts_np = (t0 + 0.05 * np.arange(batch)).astype(np.float32)
    xs_np = np.array(sft(jnp.asarray(ts_np)), np.float32)
    rs = np.random.RandomState(0)
    xs_np[:, 0:3] += 0.05 * rs.randn(batch, 3).astype(np.float32)
    sh2 = NamedSharding(mesh, P("dp", None))
    xs = jax.device_put(xs_np, sh2)
    ts = jax.device_put(ts_np, NamedSharding(mesh, P("dp")))
    rngs = jax.device_put(
        jax.random.split(jax.random.PRNGKey(0), batch), sh2)
    st = reset_b(xs, rngs, xs)
    compiled = mpc_b.lower(xs, rngs, st, ts, xs).compile()
    # GPU HLO lowers an all-reduce to an async all-reduce-start/-done pair.
    n_allreduce = len(re.findall(r"all-reduce(?:-start)?\(",
                                 compiled.as_text()))
    sol = compiled(xs, rngs, st, ts, xs)             # warm-up (donates st)
    jax.block_until_ready(sol.u_opt)
    st = reset_b(xs, rngs, xs)
    jax.block_until_ready(st.yk)
    t1 = time.perf_counter()
    sol = compiled(xs, rngs, st, ts, xs)
    u = np.asarray(sol.u_opt)
    return u, time.perf_counter() - t1, n_allreduce


def phase_four(n_dev: int = 4, batch: int = 256, particles: int = 512,
               fleet_batch: int = 64, ticks: int = 20,
               max_iter=None) -> dict:
    """Scenario-DP over a (n_dev, 1) mesh, particle-MC over a (1, n_dev)
    mesh and FleetEngine over n_dev cards, each beside the same work on
    one card (the fleet at phase 6's B, so its one-card run is phase 6's
    program)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from sde4mbrl_px4_tpu.core.frames import enu2ned
    from sde4mbrl_px4_tpu.engine.goldens import C_TOL, U_TOL
    from sde4mbrl_px4_tpu.engine.mpc_loader import make_mpc_from_config
    from sde4mbrl_px4_tpu.io.config import load_yaml_config
    from sde4mbrl_px4_tpu.parallel.batched import make_particle_sharded_mpc
    from sde4mbrl_px4_tpu.parallel.mesh import make_mesh

    devs = jax.devices()
    _check(len(devs) >= n_dev, f"need {n_dev} devices, have {len(devs)}")
    devs = devs[:n_dev]
    cfg = load_yaml_config(_cfg("iris_traj_mpc.yaml"))
    if max_iter is not None:
        cfg["apg_mpc"]["max_iter"] = max_iter
    out = {}

    # Scenario DP: same scenarios on n_dev cards and on one card.
    u_n, wall_n, ar_n = _dp_solve(cfg, make_mesh((n_dev, 1), devices=devs),
                                  batch)
    u_1, wall_1, _ = _dp_solve(cfg, make_mesh((1, 1), devices=devs[:1]),
                               batch)
    du = float(np.abs(u_n - u_1).max())
    print(f"four dp {json.dumps(dict(batch=batch, max_du=du, allreduce=ar_n, wall_ms=wall_n * 1e3, wall_ms_1card=wall_1 * 1e3))}",
          flush=True)
    _check(np.isfinite(u_n).all(), "non-finite DP plans")
    _check(du <= U_TOL, f"DP plans differ from one card by {du}")
    _check(ar_n == 0, f"scenario-DP program holds {ar_n} all-reduce ops")
    out["dp"] = {"max_du": du, "allreduce": ar_n, "wall_ms": wall_n * 1e3,
                 "wall_ms_1card": wall_1 * 1e3}

    # Particle MC: one solve, particles sharded over 'mc' vs unsharded.
    cfg_p = dict(cfg, num_particles=particles, antithetic=True)
    reset_p, mpc_p, bundle = make_particle_sharded_mpc(
        cfg_p, make_mesh((1, n_dev), devices=devs))
    _, (reset_u, mpc_u), _, _ = make_mpc_from_config(dict(cfg_p))
    mpc_u = jax.jit(mpc_u)
    x0 = jnp.asarray(enu2ned(bundle.state_from_traj(jnp.float32(3.0))))
    rng = jax.random.PRNGKey(0)
    res = {}
    for tag, reset, mpc in (("mc", reset_p, mpc_p),
                            ("one", jax.jit(reset_u), mpc_u)):
        st = reset(x0, rng, x0)
        sol = mpc(x0, rng, st, jnp.float32(3.0), x0)
        jax.block_until_ready(sol.u_opt)             # compile + warm
        t1 = time.perf_counter()
        sol = mpc(x0, rng, st, jnp.float32(3.0), x0)
        u = np.asarray(sol.u_opt)
        res[tag] = (u, float(sol.opt_state.opt_cost),
                    time.perf_counter() - t1)
    du = float(np.abs(res["mc"][0] - res["one"][0]).max())
    dc = abs(res["mc"][1] - res["one"][1]) / max(abs(res["one"][1]), 1e-6)
    print(f"four mc {json.dumps(dict(particles=particles, max_du=du, cost_rel=dc, wall_ms=res['mc'][2] * 1e3, wall_ms_1card=res['one'][2] * 1e3))}",
          flush=True)
    _check(np.isfinite(res["mc"][0]).all(), "non-finite MC plan")
    _check(du <= U_TOL and dc <= C_TOL,
           f"MC-sharded plan differs: du={du} cost_rel={dc}")
    out["mc"] = {"max_du": du, "cost_rel": dc,
                 "wall_ms": res["mc"][2] * 1e3,
                 "wall_ms_1card": res["one"][2] * 1e3}

    # Fleet over n_dev cards vs one.
    f_n = phase_fleet(fleet_batch, ticks, devices=devs, max_iter=max_iter)
    f_1 = phase_fleet(fleet_batch, ticks, devices=devs[:1],
                      max_iter=max_iter)
    out["fleet"] = {"batch": fleet_batch,
                    "tick_p50_ms": f_n["tick_p50_ms"],
                    "tick_p50_ms_1card": f_1["tick_p50_ms"]}
    return out


# -------------------------------------------------------------------- main


def select_phases(four: bool) -> tuple:
    """Phase names a run executes: the one-card smoke, or (``--four``) only
    the multi-card path and its one-card comparison."""
    return FOUR_PHASES if four else PHASES


def result_line(platform: str, kind: str, count: int) -> str:
    return json.dumps({"ok": True, "device": {"platform": platform,
                                              "kind": kind, "count": count}})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU path (scenario-DP, "
                         "particle-MC, fleet) beside its one-GPU run")
    args = ap.parse_args(argv)

    from sde4mbrl_px4_tpu.compile_cache import ensure_compile_cache

    cache_dir = ensure_compile_cache()
    t_all = time.perf_counter()
    try:
        info = phase_device(cache_dir)
    except NoAccelerator as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    _report(0, "device", info)
    runs = {
        "flagship": lambda: phase_tracking(_cfg("iris_traj_mpc.yaml"), 60,
                                           cache_dir),
        "hexa": lambda: phase_tracking(_cfg("hexa_traj_mpc.yaml"), 20,
                                       cache_dir),
        "goldens": phase_goldens,
        "deadline": phase_deadline,
        "closed_loop": phase_closed_loop,
        "fleet": phase_fleet,
        "four": phase_four,
    }
    for n, name in enumerate(select_phases(args.four)):
        if name == "device":
            continue
        t1 = time.perf_counter()
        res = runs[name]()
        res["phase_s"] = time.perf_counter() - t1
        _report(n, name, res)
    import jax

    devs = jax.devices()
    print(f"total_s {time.perf_counter() - t_all:.1f}", flush=True)
    print(result_line(devs[0].platform, devs[0].device_kind, len(devs)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
