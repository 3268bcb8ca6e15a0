#!/usr/bin/env python
"""Benchmark: receding-horizon MPC solve rate on the flagship iris config.

Prints ONE JSON line:
    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

Baseline: the reference controller must sustain the 20 Hz control indexing
period (plan step 0 dt = 50 ms, ``launch/iris_sitl_traj_mpc.yaml:46``,
``sde_control.py:167,292``) — i.e. 20 solves/s — on CPU (the reference pins
JAX to CPU, ``sde_control.py:6``). ``vs_baseline`` is therefore
``solves_per_sec / 20``.

Workload: the real flight loop — sequential warm-started trajectory-tracking
solves along the lemniscate, state advanced by the model, one solve per
control period — exactly the solver-process hot loop
(``sde_control.py:365-450``). Detailed stats (p50/p99 latency, batched
throughput) go to stderr.
"""
import json
import os
import sys
import time

# Shared persistent compilation cache (sde4mbrl_px4_tpu/compile_cache.py):
# a program compiled by ANY entry point is a cache hit for every other.
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from sde4mbrl_px4_tpu.compile_cache import ensure_compile_cache

ensure_compile_cache()

import numpy as np


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    import jax
    import jax.numpy as jnp

    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from sde4mbrl_px4_tpu.engine.mpc_loader import load_mpc_from_cfgfile
    from sde4mbrl_px4_tpu.core.frames import enu2ned

    _log(f"devices: {jax.devices()}")

    t0 = time.time()
    cfg, (reset_fn, mpc_fn), state_from_traj, bundle = load_mpc_from_cfgfile(
        os.path.join(here, "configs", "iris_traj_mpc.yaml")
    )
    dt = float(cfg["_time_steps"][0])

    rng = jax.random.PRNGKey(0)
    # Start past the trajectory's from-rest ramp (trajs ship with a 1.5 s
    # spin-up): the benchmark workload is the STEADY receding-horizon loop.
    T0 = 3.0
    jx = jax.jit(lambda t: enu2ned(state_from_traj(t))).lower(
        jnp.float32(T0)).compile()
    x = jx(jnp.float32(T0))
    jr = jax.jit(reset_fn).lower(x, rng, x).compile()
    st = jr(x, rng, x)
    jm = jax.jit(mpc_fn).lower(x, rng, st, jnp.float32(T0), x).compile()
    startup_s = time.time() - t0
    sol = jm(x, rng, st, jnp.float32(T0), x)
    jax.block_until_ready(sol.u_opt)
    _log(f"load+compile: {startup_s:.1f}s (persistent cache at "
         f"{os.environ.get('JAX_COMPILATION_CACHE_DIR')}); "
         f"warm+first-exec: {time.time()-t0-startup_s:.1f}s")

    # Warm-started closed-loop sequence (plant = predicted next state).
    n_warm, n_meas = 10, 60
    t = T0
    lat = []
    for k in range(n_warm + n_meas):
        t1 = time.perf_counter()
        sol = jm(sol.x_evol[1], sol.rng, sol.opt_state, jnp.float32(t), x)
        jax.block_until_ready(sol.u_opt)
        if k >= n_warm:
            lat.append(time.perf_counter() - t1)
        t += dt

    lat = np.asarray(lat)
    # Median-based rate: robust to host-side dispatch jitter (p99 outliers
    # otherwise skew the mean).
    solves_per_sec = 1.0 / np.percentile(lat, 50)
    _log(
        f"seq solve latency (blocking): mean={lat.mean()*1e3:.2f}ms p50={np.percentile(lat,50)*1e3:.2f}ms "
        f"p99={np.percentile(lat,99)*1e3:.2f}ms  steps/solve={float(sol.opt_state.num_steps):.0f}"
    )

    # Pipelined per-call path (the engine's production dispatch mode,
    # engine/controller.py): dispatch solve k asynchronously, collect the
    # already-finished solve k-1 — per-call wall time is dispatch+transfer,
    # plan staleness <= 1 control period (absorbed by time-indexed pickup).
    pipe_stats = _bench_pipelined(jm, reset_fn, state_from_traj, dt, _log,
                                  t_start=T0)

    # -- on-device chip rate (the BASELINE.json metric: solves/s/chip). The
    # per-call rate above includes host dispatch; chaining K solves in one
    # program measures the chip itself.
    chip_rate = steps_per_solve = None
    try:
        chip_rate, steps_per_solve = _bench_chained(
            here, _log, cfg, mpc_fn, reset_fn, state_from_traj, t_start=T0)
    except Exception as e:  # noqa: BLE001
        _log(f"chained bench skipped: {e!r}")

    # -- on-device golden gate (VERDICT r4 item 1) --------------------------
    golden_stats = None
    try:
        golden_stats = _bench_golden_parity(here, _log)
    except Exception as e:  # noqa: BLE001
        _log(f"golden-parity leg skipped: {e!r}")

    # -- secondary benchmarks (stderr): BASELINE configs 4-5 ----------------
    p1024_stats = None
    try:
        p1024_stats = _bench_particles(here, _log)
    except Exception as e:  # noqa: BLE001 — secondary metric must not kill bench
        _log(f"particle bench skipped: {e!r}")
    batched_stats = None
    try:
        batched_stats = _bench_batched_throughput(here, _log)
    except Exception as e:  # noqa: BLE001
        _log(f"batched bench skipped: {e!r}")
    try:
        _bench_mppi(here, _log)
    except Exception as e:  # noqa: BLE001
        _log(f"mppi bench skipped: {e!r}")
    policy_rate = None
    try:
        policy_rate = _bench_policy(here, _log)
    except Exception as e:  # noqa: BLE001
        _log(f"policy bench skipped: {e!r}")
    hexa_rate = None
    try:
        hexa_rate = _bench_hexa_chained(here, _log)
    except Exception as e:  # noqa: BLE001
        _log(f"hexa bench skipped: {e!r}")

    headline = chip_rate if chip_rate is not None else solves_per_sec
    # Config fingerprint: docs (README/PARITY) quote this hash next to the
    # headline numbers, so a config touch after doc-write is mechanically
    # detectable (VERDICT r3 item 2).
    import hashlib

    with open(os.path.join(here, "configs", "iris_traj_mpc.yaml"), "rb") as f:
        config_sha = hashlib.sha256(f.read()).hexdigest()[:12]
    out = {
        "metric": "mpc_solves_per_sec_per_chip_iris_traj",
        "value": round(float(headline), 3),
        "unit": "solves/s",
        "vs_baseline": round(float(headline) / 20.0, 3),
        "config_sha": config_sha,
    }
    # Latency-vs-budget accounting (BASELINE.md: 50 ms control period /
    # 20 ms staleness watchdog) + achieved-FLOP roofline context.
    if pipe_stats is not None:
        out["percall_p50_ms"] = round(pipe_stats["p50"] * 1e3, 2)
        out["percall_p99_ms"] = round(pipe_stats["p99"] * 1e3, 2)
        out["dispatch_p99_ms"] = round(pipe_stats["dispatch_p99"] * 1e3, 2)
        out["control_budget_ms"] = 50.0
        out["p99_vs_budget"] = round(pipe_stats["p99"] * 1e3 / 50.0, 3)
    if policy_rate is not None:
        out["policy_solves_per_sec"] = round(float(policy_rate), 1)
    if hexa_rate is not None:
        out["hexa_solves_per_sec"] = round(float(hexa_rate), 1)
    if steps_per_solve is not None:
        out["apg_steps_per_solve"] = round(float(steps_per_solve), 1)
    if p1024_stats is not None:
        out.update(p1024_stats)
    if golden_stats is not None:
        out.update(golden_stats)
    if batched_stats is not None:
        out.update(batched_stats)
    out["startup_s"] = round(float(startup_s), 1)
    if chip_rate is not None:
        # steps_per_solve from the SAME pinned chained workload as
        # chip_rate (the blocking loop above measures a different window)
        gf = _achieved_gflops(cfg, float(steps_per_solve), chip_rate)
        out["achieved_gflops"] = round(gf, 1)
        _log(f"achieved compute: {gf:.1f} GFLOP/s on-device "
             "(launch-latency bound: the model is 3 tiny matmuls/step "
             "with 16..64-wide feature dims)")
    print(json.dumps(out))


def _bench_golden_parity(here, _log):
    """On-device golden gate: replay the four flagship command-sequence
    goldens (iris+hexa × pos/traj) through the REAL controller on this
    backend — the program that actually flies — and gate against the
    committed CPU traces (``tests/goldens``, generated by
    tests/test_goldens_flagship.py).

    Gates: ``engine/goldens.gate_trace``, the ones ``chip_smoke.py``'s
    golden phase uses (commands and costs within the chaos scale, widened
    per tick by the CPU reference's own spread, the hexa's commands
    reported only; pickup indices exact).
    The fallback channel's max |dw| is reported.
    """
    from sde4mbrl_px4_tpu.engine import goldens as G
    from sde4mbrl_px4_tpu.engine.controller import RecedingHorizonController

    gold = G.golden_dir(here)
    worst_u = worst_w = worst_c = 0.0
    ok = True
    for v in ("iris", "hexa"):
        spread = G.load_spread(here, v)
        c = RecedingHorizonController(
            os.path.join(here, f"configs/{v}_traj_mpc.yaml"),
            os.path.join(here, f"configs/{v}_posctrl_mpc.yaml"),
            seed=0, now_fn=lambda: 0.0)
        try:
            for mode, fn in (("pos", G.replay_pos), ("traj", G.replay_traj)):
                tr, costs = fn(c)
                name = f"{mode}_flagship"
                ref = np.load(os.path.join(gold, f"{v}_{name}_trace.npz"))
                g = G.gate_trace(tr, costs, ref, spread[f"{name}_u"],
                                 spread[f"{name}_cost"],
                                 gate_u=c.traj.n_u <= 4)
                du, dc = g["max_du"], g["cost_rel_converged"]
                dw = float(np.abs(tr[:, 6:10] - ref["trace"][:, 6:10]).max())
                idx_ok, leg_ok = g["idx_exact"], g["pass"]
                ok = ok and leg_ok
                worst_u, worst_w = max(worst_u, du), max(worst_w, dw)
                worst_c = max(worst_c, dc)
                _log(f"golden parity {v}/{mode}: max|du|={du:.1e} "
                     f"max|dw|={dw:.1e} cost_rel={dc:.1e} "
                     f"idx {'exact' if idx_ok else 'MISMATCH'} -> "
                     f"{'PASS' if leg_ok else 'FAIL'}")
        finally:
            c.close()
    return {"golden_parity_max_u_diff": round(worst_u, 5),
            "golden_parity_max_w_diff": round(worst_w, 5),
            "golden_parity_max_cost_rel": round(worst_c, 5),
            "golden_parity_pass": bool(ok)}


def _bench_pipelined(jm, reset_fn, state_from_traj, dt, _log,
                     n_warm=10, n_meas=60, t_start=0.0):
    """Per-call latency of the pipelined dispatch pattern (dispatch k,
    collect k-1). State feedback is host-side like the real engine (the
    plant state arrives over MAVLink); opt_state/rng stay device-resident."""
    import jax
    import jax.numpy as jnp
    from sde4mbrl_px4_tpu.core.frames import enu2ned

    try:
        x_host = np.asarray(enu2ned(state_from_traj(t_start)))
        rng = jax.random.PRNGKey(1)
        st = reset_fn(jnp.asarray(x_host), rng, jnp.asarray(x_host))
        prev = None
        t = t_start
        lat, dlat = [], []
        for k in range(n_warm + n_meas):
            t1 = time.perf_counter()
            # Fetch the PREVIOUS solve first (it ran during the last control
            # period), then dispatch the next.
            if prev is not None:
                _, x_evol = jax.device_get((prev.u_opt, prev.x_evol))
                x_host = np.asarray(x_evol[1])
            t2 = time.perf_counter()
            cur = jm(jnp.asarray(x_host), rng, st, jnp.float32(t), jnp.asarray(x_host))
            rng, st = cur.rng, cur.opt_state        # device handles, no transfer
            # Stream the results host-ward in the background so next tick's
            # fetch is a local copy (engine/controller.py does the same).
            cur.u_opt.copy_to_host_async()
            cur.x_evol.copy_to_host_async()
            prev = cur
            busy = time.perf_counter() - t1
            if k >= n_warm:
                lat.append(busy)
                dlat.append(time.perf_counter() - t2)  # dispatch-only slice
            t += dt
            # Pace at the 20 Hz control period like the real engine loop;
            # the measured quantity is the per-tick BUSY time (fetch +
            # dispatch), i.e. what the host must fit into each period.
            time.sleep(max(0.0, dt - busy))
        lat, dlat = np.asarray(lat), np.asarray(dlat)
        stats = {"p50": float(np.percentile(lat, 50)),
                 "p99": float(np.percentile(lat, 99)),
                 "mean": float(lat.mean()),
                 "dispatch_p50": float(np.percentile(dlat, 50)),
                 "dispatch_p99": float(np.percentile(dlat, 99))}
        _log(f"per-call pipelined busy time @20Hz: mean={stats['mean']*1e3:.2f}ms "
             f"p50={stats['p50']*1e3:.2f}ms p99={stats['p99']*1e3:.2f}ms "
             f"(vs 50 ms control budget); dispatch-only "
             f"p50={stats['dispatch_p50']*1e3:.2f}ms "
             f"p99={stats['dispatch_p99']*1e3:.2f}ms")
        return stats
    except Exception as e:  # noqa: BLE001 — secondary metric must not kill bench
        _log(f"pipelined bench skipped: {e!r}")
        return None


def _achieved_gflops(cfg, steps_per_solve, solves_per_sec):
    """FLOPs actually retired per second on the chained on-device path.

    Per APG iteration: grad sweep (forward + ~2x backward) + maxls
    candidate rollouts, each H steps x (16x64 + 64x64 + 64x12) MAC
    matmuls (models/sde_model.py trunk) per particle.
    """
    H = int(cfg["horizon"])
    P = max(int(cfg.get("num_particles", 1)), 1)
    maxls = int(cfg["apg_mpc"]["linesearch"]["maxls"])
    macs_step = 16 * 64 + 64 * 64 + 64 * 12
    per_iter = (3.0 + maxls) * H * P * macs_step * 2  # fwd + 2x bwd + K cand
    return per_iter * steps_per_solve * solves_per_sec / 1e9


def _bench_chained(here, _log, cfg, mpc_fn, reset_fn, state_from_traj, K=10,
                   t_start=0.0):
    """On-device sequential solve rate: K receding-horizon solves chained in
    ONE jitted program (lax.scan with state feedback), amortizing the
    host-dispatch cost. This is the chip's intrinsic rate.

    PINNED workload (round-3 reproducibility fix): one warm-up chain from
    ``t_start`` produces a steady warm-started operating point; every timed
    repetition then re-solves the SAME fixed trajectory window from that
    same (state, warm start, rng) — the APG iteration count per solve is
    bit-identical across reps AND across bench runs, so run-to-run deltas
    are latency, not trajectory-position-dependent convergence. steps/solve
    is reported alongside ms/solve for exactly that reason.
    """
    import jax
    import jax.numpy as jnp
    from sde4mbrl_px4_tpu.core.frames import enu2ned

    dt = float(cfg["_time_steps"][0])
    x0 = enu2ned(state_from_traj(t_start))
    rng = jax.random.PRNGKey(0)
    st0 = reset_fn(x0, rng, x0)

    def chain(x, rng, st, t_start):
        def body(carry, k):
            x, rng, st = carry
            u, st1, rng1, x_evol = mpc_fn(x, rng, st, t_start + k * dt, x)
            return (x_evol[1], rng1, st1), (u[0], st1.num_steps)

        (xf, rngf, stf), (us, steps) = jax.lax.scan(
            body, (x, rng, st), jnp.arange(K, dtype=jnp.float32)
        )
        return xf, rngf, stf, us, steps

    jc = jax.jit(chain)
    # warm-up chain: compile + reach the steady warm-started regime
    x1, rng1, st1, us, _ = jc(x0, rng, st0, jnp.float32(t_start))
    jax.block_until_ready(us)
    t1 = jnp.float32(t_start + K * dt)

    # R in-program repetitions of the pinned window: one program call
    # carries a fixed host dispatch cost, so at R=1 a K=10 chain still
    # hides dispatch inside the "on-device" number. The outer scan re-solves the SAME
    # pinned window from the same (state, warm start, rng), so the
    # workload and its steps/solve stay bit-identical; only the dispatch
    # amortization changes (steps parity across reps is asserted below).
    # If a future XLA release learns to hoist the loop-invariant rep body,
    # the ms/solve would drop ~R×, which the hoisting guard below catches.
    R = 10

    def rep_chain(x, rng, st, t_start):
        def outer(carry, _):
            _, _, _, us, steps = chain(x, rng, st, t_start)
            return carry, (us, steps)
        _, (uss, stepss) = jax.lax.scan(
            outer, jnp.float32(0.0), jnp.arange(R))
        return uss, stepss

    jr = jax.jit(rep_chain)
    uss, stepss = jr(x1, rng1, st1, t1)
    jax.block_until_ready(uss)
    steps_np = np.asarray(stepss)                       # (R, K)
    assert (steps_np == steps_np[0]).all(), \
        "rep windows diverged — pinned-window invariant broken"
    steps_per_solve = float(steps_np.mean())
    t0 = time.perf_counter()
    n = 5
    for _ in range(n):
        out = jr(x1, rng1, st1, t1)
    jax.block_until_ready(out[0])
    per_solve = (time.perf_counter() - t0) / (n * K * R)
    # Hoisting guard (ADVICE r4): the R reps re-run a loop-invariant body,
    # and the steps-parity assert above cannot detect XLA hoisting/CSE of
    # it — a future compiler that hoists would silently inflate the
    # headline ~R×. Time the R=1 chain and require t(R)/t(R=1) to scale
    # ~linearly with R before reporting.
    t0 = time.perf_counter()
    for _ in range(n):
        o1 = jc(x1, rng1, st1, t1)
    jax.block_until_ready(o1[3])
    per_solve_r1 = (time.perf_counter() - t0) / (n * K)
    ratio = (per_solve * R) / per_solve_r1
    if not (0.5 * R <= ratio <= 1.2 * R):
        # Out-of-range means either XLA hoisted/CSE'd the loop-invariant
        # rep body (ratio ~1) or the R=1 calls are dispatch-dominated
        # this session — either way the amortized number is not
        # trustworthy: FALL BACK to the conservative R=1 measurement
        # loudly instead of corrupting (or dropping) the bench record.
        _log(f"HOISTING GUARD: R-rep chain cost {ratio:.1f}x the R=1 "
             f"chain (expected ~{R}x) — reporting the unamortized R=1 "
             f"rate {1.0/per_solve_r1:.1f} solves/s instead")
        per_solve = per_solve_r1
    _log(f"on-device chained rate (pinned window t=[{float(t1):.2f},"
         f"{float(t1) + K * dt:.2f}), seed 0, {R}x{K} solves/program): "
         f"{per_solve*1e3:.2f} ms/solve "
         f"({1.0/per_solve:.1f} solves/s excl. host dispatch), "
         f"{steps_per_solve:.1f} APG steps/solve")
    return 1.0 / per_solve, steps_per_solve


def _bench_particles(here, _log, P=1024, n_steps=110):
    """Uncertainty-aware MPC: 1024 Monte-Carlo sample paths per solve
    (BASELINE config 4) — warm receding-horizon solves across ``n_steps``
    steps of the LEMNISCATE (where convergence varies with trajectory
    position), reporting p50/p99 per-solve latency against the 50 ms
    control budget. Two latency views:

    - on-device mean via a chained scan over the same window (the chip's
      intrinsic per-solve cost, incl. the hard steps), and
    - per-call busy time with the engine's pipelined dispatch pattern
      (fetch previous plan, dispatch next) — the number that must fit the
      control period on the host.
    """
    import jax
    import jax.numpy as jnp
    from sde4mbrl_px4_tpu.engine.mpc_loader import make_mpc_from_config
    from sde4mbrl_px4_tpu.io.config import load_yaml_config
    from sde4mbrl_px4_tpu.core.frames import enu2ned

    base = load_yaml_config(os.path.join(here, "configs", "iris_traj_mpc.yaml"))
    # Full reference iteration budget (max_iter 200 with atol/rtol early
    # exit, reference iris_sitl_traj_mpc.yaml:60); steps actually executed
    # are reported — warm-started receding-horizon solves converge early,
    # which IS the flight workload.
    base["apg_mpc"]["max_iter"] = 200
    out = {}
    # Two operating points: P iid paths (the literal BASELINE config-4
    # workload) and P/2 ANTITHETIC paths (256 mirrored pairs = 512 paths
    # total — draw_brownian returns exactly num_particles paths) with
    # LOWER estimator variance than the 1024 iid set (tests/test_rollout.py
    # pins the variance reduction) at half the rollout compute — the
    # recommended flight operating point.
    for tag, mut, dl in (
        (f"p{P}", {"num_particles": P}, None),
        (f"p{P // 2}anti", {"num_particles": P // 2, "antithetic": True},
         None),
        # Deadline-aware operating point (VERDICT r3 item 3): the same
        # antithetic workload with the solve tail BOUNDED by a 30 ms
        # iteration budget (engine semantics: apg_mpc.deadline_ms).
        (f"p{P // 2}anti_dl30",
         {"num_particles": P // 2, "antithetic": True}, 30.0),
    ):
        cfg = dict(base)
        cfg.update(mut)
        out.update(_particles_percentiles(here, _log, cfg, tag, n_steps,
                                          deadline_ms=dl))
    return out


def _particles_percentiles(here, _log, cfg, tag, n_steps, deadline_ms=None):
    """One particle operating point. With ``deadline_ms``, solves carry a
    fixed iteration budget = deadline / measured-ms-per-iteration (the
    engine's apg_mpc.deadline_ms semantics, calibrated here from a few
    blocking solves), and the tracking deviation vs the reference is
    reported so budget-induced regressions are visible."""
    import jax
    import jax.numpy as jnp
    from sde4mbrl_px4_tpu.engine.mpc_loader import make_mpc_from_config
    from sde4mbrl_px4_tpu.core.frames import enu2ned

    cfg, (reset_fn, mpc_fn), sft, _ = make_mpc_from_config(dict(cfg))
    dt = float(cfg["_time_steps"][0])
    T0 = 3.0
    x = enu2ned(sft(T0))
    rng = jax.random.PRNGKey(0)
    st = reset_fn(x, rng, x)
    jm = jax.jit(mpc_fn)
    budget = None
    if deadline_ms is not None:
        # calibrate ms/iteration from blocking solves (conservative: wall
        # time incl. dispatch), then fix the budget for the whole window
        max_iter = int(cfg["apg_mpc"]["max_iter"])
        solc = jm(x, rng, st, jnp.float32(T0), x, jnp.int32(max_iter))
        jax.block_until_ready(solc.u_opt)
        per = []
        for j in range(3):
            t1 = time.perf_counter()
            solc = jm(enu2ned(sft(T0 + 0.05 * j)), solc.rng, solc.opt_state,
                      jnp.float32(T0 + 0.05 * j), x, jnp.int32(max_iter))
            jax.block_until_ready(solc.u_opt)
            per.append((time.perf_counter() - t1)
                       / max(float(solc.opt_state.num_steps), 1.0))
        budget = max(5, min(int(deadline_ms / (np.mean(per) * 1e3)),
                            max_iter))
        st = reset_fn(x, rng, x)
    args_tail = () if budget is None else (jnp.int32(budget),)
    sol = jm(x, rng, st, jnp.float32(T0), x, *args_tail)
    jax.block_until_ready(sol.u_opt)

    # Reference positions precomputed OUTSIDE the timed loop (they are
    # known for all t): computing them per tick would add a harness-only
    # device round trip inside the measured window.
    ref_pos = np.stack([
        np.asarray(enu2ned(sft(jnp.float32(T0 + k * dt))))[:3]
        for k in range(8 + n_steps + 1)
    ])

    # per-call pipelined busy time across the lemniscate window
    lat, fetches, steps_seen, errs = [], [], [], []
    prev = None
    t = T0
    n_warm = 8
    for k in range(n_warm + n_steps):
        t1 = time.perf_counter()
        if prev is not None:
            x_evol, n_st = jax.device_get((prev.x_evol, prev.opt_state.num_steps))
            x_host = jnp.asarray(x_evol[1])
            if k >= n_warm:           # steady workload only, like lat
                steps_seen.append(float(n_st))
                errs.append(float(np.linalg.norm(
                    np.asarray(x_evol[1][:3]) - ref_pos[k])))
        else:
            x_host = x
        t_f = time.perf_counter() - t1
        cur = jm(x_host, sol.rng, sol.opt_state, jnp.float32(t), x_host,
                 *args_tail)
        sol = prev = cur
        cur.x_evol.copy_to_host_async()
        cur.opt_state.num_steps.copy_to_host_async()
        busy = time.perf_counter() - t1
        if k >= n_warm:
            lat.append(busy)
            fetches.append(t_f)
        t += dt
        time.sleep(max(0.0, dt - busy))
    lat, fetches = np.asarray(lat), np.asarray(fetches)
    ex = lat - fetches                 # dispatch leg excl. prev-plan fetch
    p50, p99 = np.percentile(lat, 50), np.percentile(lat, 99)
    p99x = np.percentile(ex, 99)
    P_eff = int(cfg.get("num_particles", 1))   # paths actually rolled
    bud_txt = (f"{cfg['apg_mpc']['max_iter']}-iter budget" if budget is None
               else f"deadline {deadline_ms:.0f} ms -> {budget}-iter budget")
    _log(f"{tag} ({P_eff} sampled paths/solve"
         f"{', antithetic pairs' if cfg.get('antithetic') else ''}) "
         f"uncertainty solves over "
         f"{n_steps} lemniscate steps ({bud_txt}, steps/solve mean "
         f"{np.mean(steps_seen):.1f} max {np.max(steps_seen):.0f}, mean "
         f"tracking dev {np.mean(errs):.3f} m): "
         f"per-call busy p50={p50*1e3:.1f}ms p99={p99*1e3:.1f}ms vs 50 ms "
         f"budget ({'PASS' if p99 < 0.050 else 'OVER'}); excl. the "
         f"harness's prev-plan fetch leg p99={p99x*1e3:.1f}ms "
         f"(fetch p50={np.percentile(fetches,50)*1e3:.1f}ms — ~0.1 ms on "
         f"a locally-attached host)")
    res = {f"{tag}_percall_p50_ms": round(float(p50) * 1e3, 1),
           f"{tag}_percall_p99_ms": round(float(p99) * 1e3, 1),
           f"{tag}_exclfetch_p99_ms": round(float(p99x) * 1e3, 1),
           f"{tag}_steps_mean": round(float(np.mean(steps_seen)), 1),
           f"{tag}_track_dev_m": round(float(np.mean(errs)), 4)}
    if budget is not None:
        res[f"{tag}_iter_budget"] = budget
    return res


def _bench_mppi(here, _log, K=20):
    """Sampling-solver operating point (solver/mppi.py): K=64 samples x 8
    re-centered rounds per solve, candidates batched through one vmapped
    rollout."""
    import jax
    import jax.numpy as jnp
    from sde4mbrl_px4_tpu.core.types import hover_state
    from sde4mbrl_px4_tpu.engine.mpc_loader import make_mpc_from_config
    from sde4mbrl_px4_tpu.io.config import load_yaml_config

    cfg = load_yaml_config(os.path.join(here, "configs", "iris_posctrl_mpc.yaml"))
    cfg["solver"] = "mppi"
    cfg, (reset_fn, mpc_fn), _, _ = make_mpc_from_config(cfg)
    x0 = jnp.asarray(hover_state()).at[0].set(1.0)
    tgt = jnp.asarray(hover_state())
    rng = jax.random.PRNGKey(0)
    st0 = reset_fn(x0, rng, x0)

    def chain(x, rng, st):
        def body(c, _):
            x, rng, st = c
            u, st1, rng1, xe = mpc_fn(x, rng, st, jnp.float32(0.0), tgt)
            return (xe[1], rng1, st1), 0.0
        (xf, rngf, stf), _ = jax.lax.scan(body, (x, rng, st), None, length=K)
        return xf, rngf, stf

    jc = jax.jit(chain)
    xf, rngf, stf = jc(x0, rng, st0)
    jax.block_until_ready(xf)
    t0 = time.perf_counter()
    n = 5
    for _ in range(n):
        xf, rngf, stf = jc(xf, rngf, stf)
    jax.block_until_ready(xf)
    per = (time.perf_counter() - t0) / (n * K)
    _log(f"MPPI sampling solver (K=64): {per*1e3:.2f} ms/solve "
         f"({1/per:.0f} solves/s/chip)")


def _bench_policy(here, _log, K=50):
    """Amortized-policy solver (``solver: policy``, models/policy.py): one
    forward pass per solve. Latency is checkpoint-independent (same matmuls
    trained or not); tracking quality of a TRAINED policy is validated in
    examples/policy_distill.py and tests/test_distill.py."""
    import jax
    import jax.numpy as jnp
    from sde4mbrl_px4_tpu.core.types import hover_state
    from sde4mbrl_px4_tpu.engine.mpc_loader import make_mpc_from_config
    from sde4mbrl_px4_tpu.io.config import load_yaml_config

    cfg = load_yaml_config(os.path.join(here, "configs", "iris_traj_mpc.yaml"))
    cfg["solver"] = "policy"
    cfg, (reset_fn, mpc_fn), sft, _ = make_mpc_from_config(cfg)
    from sde4mbrl_px4_tpu.core.frames import enu2ned

    x0 = enu2ned(sft(0.0))
    rng = jax.random.PRNGKey(0)
    st0 = reset_fn(x0, rng, x0)
    dt = jnp.float32(cfg["_time_steps"][0])

    def chain(x, rng, st):
        def body(c, k):
            x, rng, st = c
            u, st1, rng1, xe = mpc_fn(x, rng, st, k * dt, x)
            return (xe[1], rng1, st1), 0.0
        (xf, rngf, stf), _ = jax.lax.scan(
            body, (x, rng, st), jnp.arange(K, dtype=jnp.float32))
        return xf, rngf, stf

    jc = jax.jit(chain)
    xf, rngf, stf = jc(x0, rng, st0)
    jax.block_until_ready(xf)
    t0 = time.perf_counter()
    n = 5
    for _ in range(n):
        xf, rngf, stf = jc(xf, rngf, stf)
    jax.block_until_ready(xf)
    per = (time.perf_counter() - t0) / (n * K)
    _log(f"amortized policy solver (one-shot plan net incl. telemetry "
         f"rollout): {per*1e3:.3f} ms/solve ({1/per:.0f} solves/s/chip)")
    return 1.0 / per


def _bench_hexa_chained(here, _log, K=10):
    """BASELINE config 3 as a standing chip number: the 6-motor hexa
    trajectory solve, chained on a pinned window like the iris headline
    (same steady warm-started regime; larger decision width n_u=6)."""
    import jax
    import jax.numpy as jnp
    from sde4mbrl_px4_tpu.core.frames import enu2ned
    from sde4mbrl_px4_tpu.engine.mpc_loader import load_mpc_from_cfgfile

    cfg, (reset_fn, mpc_fn), sft, _ = load_mpc_from_cfgfile(
        os.path.join(here, "configs", "hexa_traj_mpc.yaml"))
    dt = float(cfg["_time_steps"][0])
    T0 = 3.0
    x0 = jax.jit(lambda t: enu2ned(sft(t)))(jnp.float32(T0))
    rng = jax.random.PRNGKey(0)
    st0 = reset_fn(x0, rng, x0)

    def chain(x, rng, st, t_start):
        def body(carry, k):
            x, rng, st = carry
            u, st1, rng1, x_evol = mpc_fn(x, rng, st, t_start + k * dt, x)
            return (x_evol[1], rng1, st1), (u[0], st1.num_steps)

        (xf, rngf, stf), (us, steps) = jax.lax.scan(
            body, (x, rng, st), jnp.arange(K, dtype=jnp.float32))
        return xf, rngf, stf, us, steps

    jc = jax.jit(chain)
    x1, rng1, st1, us, _ = jc(x0, rng, st0, jnp.float32(T0))
    jax.block_until_ready(us)
    t1 = jnp.float32(T0 + K * dt)
    # R in-program repetitions of the pinned window: amortize the fixed
    # program-call dispatch below 0.1 ms/solve (see _bench_chained).
    R = 10

    def rep_chain(x, rng, st, t_start):
        def outer(carry, _):
            _, _, _, us, steps = chain(x, rng, st, t_start)
            return carry, (us, steps)
        _, (uss, stepss) = jax.lax.scan(
            outer, jnp.float32(0.0), jnp.arange(R))
        return uss, stepss

    jr = jax.jit(rep_chain)
    uss, stepss = jr(x1, rng1, st1, t1)
    jax.block_until_ready(uss)
    steps_np = np.asarray(stepss)
    assert (steps_np == steps_np[0]).all(), \
        "rep windows diverged — pinned-window invariant broken"
    steps_per_solve = float(steps_np.mean())
    t0 = time.perf_counter()
    n = 5
    for _ in range(n):
        out = jr(x1, rng1, st1, t1)
    jax.block_until_ready(out[0])
    per = (time.perf_counter() - t0) / (n * K * R)
    # Hoisting guard — see _bench_chained.
    t0 = time.perf_counter()
    for _ in range(n):
        o1 = jc(x1, rng1, st1, t1)
    jax.block_until_ready(o1[3])
    per_r1 = (time.perf_counter() - t0) / (n * K)
    ratio = (per * R) / per_r1
    if not (0.5 * R <= ratio <= 1.2 * R):
        _log(f"HOISTING GUARD (hexa): R-rep chain cost {ratio:.1f}x the "
             f"R=1 chain (expected ~{R}x) — reporting the unamortized "
             f"R=1 rate instead")
        per = per_r1
    _log(f"hexa (6-motor) chained rate (pinned window, seed 0, "
         f"{R}x{K} solves/program): "
         f"{per*1e3:.2f} ms/solve ({1.0/per:.1f} solves/s/chip), "
         f"{steps_per_solve:.1f} APG steps/solve")
    return 1.0 / per


def _bench_batched_throughput(here, _log, B=256):
    """Scenario-DP throughput: B independent warm-started solves per step
    (BASELINE config 5, single-chip datapoint).

    Each timed step RE-TARGETS every scenario (rotating precomputed target
    sets) so the warm-started solves do real work — round 3 re-solved an
    already-converged state, and its "1.47 M solves/s" was the early-exit
    while_loop running ~1 iteration. The
    observed steps/solve is reported so the figure is interpretable.

    Also reports the batched path's achieved GFLOP/s and arithmetic
    intensity: unlike the single-stream solve, the B-wide path issues
    real (B, feat) matmuls."""
    import jax
    import jax.numpy as jnp
    from sde4mbrl_px4_tpu.io.config import load_yaml_config
    from sde4mbrl_px4_tpu.parallel.mesh import make_mesh
    from sde4mbrl_px4_tpu.parallel.batched import make_batched_mpc, make_batch_inputs
    from jax.sharding import NamedSharding, PartitionSpec as Pspec

    cfg = load_yaml_config(os.path.join(here, "configs", "iris_posctrl_mpc.yaml"))
    cfg["apg_mpc"]["max_iter"] = 50
    mesh = make_mesh((len(jax.devices()), 1))
    reset_b, mpc_b, _ = make_batched_mpc(cfg, mesh)
    xs, rngs = make_batch_inputs(mesh, B, spread=0.5)
    ts = jax.device_put(jnp.zeros((B,)), NamedSharding(mesh, Pspec("dp")))
    # Rotating target sets: 0.5 m offsets in distinct directions, so every
    # step every scenario must replan toward a moved setpoint.
    offs = [jnp.asarray(o, jnp.float32)
            for o in ([0.5] + [0.0] * 12, [0.0, 0.5] + [0.0] * 11,
                      [0.0, 0.0, -0.5] + [0.0] * 10)]
    tgts = [xs + o[None, :] for o in offs]
    st = reset_b(xs, rngs, xs)
    sol = mpc_b(xs, rngs, st, ts, tgts[0])
    jax.block_until_ready(sol.u_opt)
    t0 = time.perf_counter()
    n = 6
    steps = []
    for k in range(n):
        sol = mpc_b(xs, sol.rng, sol.opt_state, ts, tgts[k % len(tgts)])
        steps.append(sol.opt_state.num_steps)
    jax.block_until_ready(sol.u_opt)
    dt_s = (time.perf_counter() - t0) / n
    steps_mean = float(jnp.mean(jnp.stack(steps)))
    rate = B / dt_s
    # Achieved FLOP/s of the batched path: same per-iteration model as
    # _achieved_gflops (grad sweep fwd+2x bwd + maxls candidate rollouts,
    # 3 trunk matmuls per EM step), x B scenarios.
    H = int(cfg["horizon"])
    maxls = int(cfg["apg_mpc"]["linesearch"]["maxls"])
    macs_step = 16 * 64 + 64 * 64 + 64 * 12
    flops_solve = (3.0 + maxls) * H * macs_step * 2 * steps_mean
    gflops = flops_solve * rate / 1e9
    # Arithmetic intensity of the dominant ops: (B,16)x(16,64) etc. with
    # f32 weights resident — unique activation floats per EM step are
    # 16 (in) + 64 + 64 + 12 (each tensor counted once; intermediate
    # tensors are both an output and the next input).
    act_bytes = B * (16 + 64 + 64 + 12) * 4 * (3.0 + maxls) * H
    ai = flops_solve * B / max(act_bytes * steps_mean, 1.0)
    _log(f"batched {B}-scenario re-targeted solve step (50-iter budget, "
         f"{steps_mean:.1f} steps/solve observed): {dt_s*1e3:.1f} ms "
         f"= {rate:.0f} solves/s/chip throughput; achieved "
         f"{gflops:.0f} GFLOP/s at arithmetic intensity ~{ai:.0f} "
         f"FLOP/byte (activation traffic)")
    return {"batched_solves_per_sec": round(rate, 0),
            "batched_steps_per_solve": round(steps_mean, 1),
            "batched_gflops": round(gflops, 1)}


if __name__ == "__main__":
    main()
