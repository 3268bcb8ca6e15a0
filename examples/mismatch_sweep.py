#!/usr/bin/env python
"""Model-mismatch robustness sweep — the Gazebo-role validation artifact.

The reference's closed-loop claims rest on PX4 SITL + Gazebo: a physics
simulator the controller's model does NOT share
(``/root/reference/README.md:27-32``). This sweep is that validation for
the framework: the flagship MPC and the C++ geometric baseline each fly
the INDEPENDENT rigid-body plant (``sim/rigid_body.py`` — Newton–Euler +
motor lag + drag, written separately from the model code) across
physically-perturbed cells:

    mass x0.8 / x1.2, drag x0.5 / x1.5, motor lag 5/10/20 ms,
    thrust coefficient x0.9 (battery sag), a ~4 m/s lateral wind (the
    Gazebo wind plugin's role), and a combined worst case.

Both controllers run through the same FCU behavioral shim (``FCUSim``:
watchdog, engagement, command blending) — MPC at ``weight_motors=100``
(raw motors), geometric at 0 (thrust+rates through the FCU rate loop,
its native output). The workload is a 0.5 m offset recovery + hold;
steady-state window tracking error is the metric.

Writes ``artifacts/MISMATCH.json`` (the committed robustness artifact;
table also in docs/PERFORMANCE.md) and exits nonzero if the MPC loses a
cell it must not (nominal < 0.05 m, every cell stable and bounded).

Usage: python examples/mismatch_sweep.py [--cpu] [--seconds 4]
"""
import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

CELLS = [
    ("nominal", {}),
    ("mass_x0.8", dict(mass_scale=0.8)),
    ("mass_x1.2", dict(mass_scale=1.2)),
    ("drag_x0.5", dict(drag_scale=0.5)),
    ("drag_x1.5", dict(drag_scale=1.5)),
    ("lag_5ms", dict(motor_tau=0.005)),
    ("lag_10ms", dict(motor_tau=0.010)),
    ("lag_20ms", dict(motor_tau=0.020)),
    ("ct_x0.9", dict(ct_scale=0.9)),
    ("wind_4ms", dict(wind=[3.0, 2.5, 0.0])),   # ~4 m/s lateral wind
    ("worst_combo", dict(mass_scale=1.2, drag_scale=1.5, motor_tau=0.020)),
]


def fly_mpc(cfg_tuple, plant, seconds, adapt=False, settle=None):
    """MPC closed loop through FCUSim at weight_motors=100. ``adapt``
    arms the opt-in integral reference shaping (engine/offset.py);
    ``settle`` is the measurement-window start (default seconds/2)."""
    import jax
    import jax.numpy as jnp

    from sde4mbrl_px4_tpu.core.frames import ned2enu
    from sde4mbrl_px4_tpu.core.types import CONTROL_STATES, hover_state
    from sde4mbrl_px4_tpu.sim.plant import FCUSim

    cfg, reset_fn, jm = cfg_tuple
    dt = float(cfg["_time_steps"][0])
    x0 = np.zeros(13)
    x0[6] = 1.0
    x0[0], x0[2] = 0.5, -0.3
    plant.reset(x0)
    fcu = FCUSim(plant)
    tgt_ned = np.asarray(hover_state())
    tgt_enu = np.asarray(ned2enu(jnp.asarray(tgt_ned)), np.float32)
    tgt = jnp.asarray(tgt_enu, jnp.float32)
    est = None
    if adapt:
        from sde4mbrl_px4_tpu.engine.offset import DisturbanceEstimator

        est = DisturbanceEstimator(gain=0.6, limit=1.0, dt=dt)
    rng = jax.random.PRNGKey(0)
    st = reset_fn(jnp.asarray(plant.x, jnp.float32), rng, tgt)
    errs = []
    for k in range(int(seconds / dt)):
        x, _ = fcu.full_state_msg()
        if est is not None:
            tgt = jnp.asarray(est.update(x, tgt_enu), jnp.float32)
        u, st, rng, xe = jm(jnp.asarray(x, jnp.float32), rng, st,
                            jnp.float32(0.0), tgt)
        u_host, xe1 = np.asarray(u[0]), np.asarray(xe[1])
        u6 = np.zeros(6, np.float32)
        u6[: u_host.shape[0]] = u_host
        w4 = np.array([float(u_host.mean()), *xe1[10:13]], np.float32)
        fcu.push_cmd(u6, w4, CONTROL_STATES["pos"], 100)
        fcu.run_control_period(dt)
        if k * dt >= (seconds / 2 if settle is None else settle):
            errs.append(np.linalg.norm(plant.x[:3] - tgt_ned[:3]))
    return float(np.mean(errs)), float(np.max(errs))


def fly_geometric(ctl, plant, seconds, dt=0.02):
    """Geometric baseline through FCUSim at weight_motors=0 (thrust+rates
    executed by the FCU rate loop — the controller's native channel)."""
    from sde4mbrl_px4_tpu.core.frames import ned2enu
    from sde4mbrl_px4_tpu.core.types import CONTROL_STATES, hover_state
    from sde4mbrl_px4_tpu.sim.plant import FCUSim

    x0 = np.zeros(13)
    x0[6] = 1.0
    x0[0], x0[2] = 0.5, -0.3
    plant.reset(x0)
    fcu = FCUSim(plant)
    tgt_ned = np.asarray(hover_state())
    errs = []
    import jax.numpy as jnp

    # The controller works in ENU/FLU: the hover target's NED-identity
    # attitude is ENU yaw = pi/2 (frame swap), so that is the yaw to hold.
    qe = np.asarray(ned2enu(jnp.asarray(tgt_ned)))[6:10]
    tgt_yaw = float(np.arctan2(2 * (qe[0] * qe[3] + qe[1] * qe[2]),
                               1 - 2 * (qe[2] ** 2 + qe[3] ** 2)))
    for k in range(int(seconds / dt)):
        x, _ = fcu.full_state_msg()
        x_enu = np.asarray(ned2enu(jnp.asarray(x)), np.float64)
        cmd, _q = ctl.update(x_enu, np.zeros(3), np.zeros(3), np.zeros(3),
                             tgt_yaw)
        # controller output is ENU/FLU [wx,wy,wz,thrust]; FCU wants
        # NED/FRD [thrust, wx, wy, wz] (examples/geometric_baseline_sim.py)
        tr = np.array([cmd[3], cmd[0], -cmd[1], -cmd[2]], np.float32)
        fcu.push_cmd(np.zeros(6, np.float32), tr, CONTROL_STATES["pos"], 0)
        fcu.run_control_period(dt)
        if k * dt >= seconds / 2:
            errs.append(np.linalg.norm(plant.x[:3] - tgt_ned[:3]))
    return float(np.mean(errs)), float(np.max(errs))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--vehicle", choices=("iris", "hexa"), default="iris")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--iters", type=int, default=60,
                    help="APG iteration budget (full 200 changes nothing "
                         "at hover; 60 keeps the CPU sweep fast)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from sde4mbrl_px4_tpu.baselines.geometric import (GeoParams,
                                                      NativeGeometricController)
    from sde4mbrl_px4_tpu.engine.mpc_loader import make_mpc_from_config
    from sde4mbrl_px4_tpu.io.config import load_yaml_config
    from sde4mbrl_px4_tpu.sim.rigid_body import (RigidBodyParams,
                                                 RigidBodyPlant)

    here = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    cfg = load_yaml_config(os.path.join(
        here, f"configs/{args.vehicle}_posctrl_mpc.yaml"))
    cfg["apg_mpc"]["max_iter"] = args.iters
    cfg, (reset_fn, mpc_fn), _, _ = make_mpc_from_config(cfg)
    mpc = (cfg, reset_fn, jax.jit(mpc_fn))

    nominal = RigidBodyParams.nominal(args.vehicle)
    try:
        # thrust constant from the SAME nominal calibration the plant
        # uses (one source of truth for the hover command)
        geo = NativeGeometricController(GeoParams(
            norm_thrust_const=nominal.hover_u / 9.81, norm_thrust_offset=0.0,
            kp=(2.0, 2.0, 4.0), kv=(2.0, 2.0, 3.0)))
    except Exception as e:  # noqa: BLE001 — csrc not built
        print(f"geometric baseline unavailable ({e!r}); MPC-only sweep",
              file=sys.stderr)
        geo = None

    rows = []
    print(f"{'cell':14s} {'MPC mean/max [m]':>20s} "
          f"{'MPC+adapt mean [m]':>19s} {'geometric mean/max [m]':>24s}")
    for name, pert in CELLS:
        p = nominal.perturbed(**pert) if pert else nominal
        m_mean, m_max = fly_mpc(mpc, RigidBodyPlant(p), args.seconds)
        # The integrator needs its convergence time: run the adaptive
        # cell longer and measure its STEADY window (the estimator fully
        # removes the bias by ~10 s).
        a_mean, a_max = fly_mpc(mpc, RigidBodyPlant(p), 2.5 * args.seconds,
                                adapt=True, settle=2.0 * args.seconds)
        row = {"cell": name, "perturbation": pert,
               "mpc_mean_m": round(m_mean, 4), "mpc_max_m": round(m_max, 4),
               "mpc_adapt_mean_m": round(a_mean, 4),
               "mpc_adapt_max_m": round(a_max, 4)}
        if geo is not None:
            g_mean, g_max = fly_geometric(geo, RigidBodyPlant(p),
                                          args.seconds)
            row["geo_mean_m"] = round(g_mean, 4)
            row["geo_max_m"] = round(g_max, 4)
            print(f"{name:14s} {m_mean:9.3f}/{m_max:6.3f} "
                  f"{a_mean:18.3f} {g_mean:14.3f}/{g_max:6.3f}")
        else:
            print(f"{name:14s} {m_mean:9.3f}/{m_max:6.3f} {a_mean:18.3f}")
        rows.append(row)

    by = {r["cell"]: r for r in rows}
    ok = (by["nominal"]["mpc_mean_m"] < 0.05
          and all(np.isfinite(r["mpc_max_m"]) and r["mpc_max_m"] < 1.5
                  for r in rows))
    out = args.out or os.path.join(
        here, "artifacts",
        "MISMATCH.json" if args.vehicle == "iris" else
        f"MISMATCH_{args.vehicle}.json")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump({
            "what": ("closed-loop steady-state tracking error vs physical "
                     "perturbation of the INDEPENDENT rigid-body plant "
                     "(sim/rigid_body.py); 0.5 m offset recovery + hold, "
                     f"{args.vehicle} posctrl MPC (weight_motors=100) vs C++ "
                     "geometric baseline (thrust+rates via FCU rate loop)"),
            "plant": "Newton-Euler + first-order motor lag + lin/quad drag"
                     ", RK4, parameters independent of the SDE checkpoint",
            "workload_seconds": args.seconds,
            "apg_iters": args.iters,
            "cells": rows,
            "gate": {"nominal_mpc_mean_lt_m": 0.05,
                     "all_cells_bounded_lt_m": 1.5, "pass": bool(ok)},
        }, f, indent=1)
    print(f"wrote {out}")
    print("RESULT:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
