#!/usr/bin/env python
"""Full SITL stack: every layer of the reference topology, end to end.

The reference brings up its system as: PX4 SITL + Gazebo (`make px4_sitl
gazebo`), mavlink-routerd fanning the FCU stream out with message-id
filters (``scripts/sitl_route_mavlink.sh`` + ``router_sitl.conf``), the MPC
controller node on the filtered side-channel (``iris_sdectrl.launch``), and
the mission CLI driving arming/offboard/takeoff and the controller
lifecycle (``basic_control.py``). This demo is that exact topology with the
framework's own components:

    this process                              subprocess (launch tier)
    ------------                              ----------------------
    FCUSim + SimVehicle (plant + PX4          SDEControlNode
      position-loop stand-in)                   (GPU solves)
        | MPC_FULL_STATE (367)                      ^  367 only
        v                                           |
    Router (io/router.py, router_sitl.conf) -------+
        |        \\ full stream                     |  368 back in
        v         v                                 v
    liveview   telemetry                    MPC_MOTORS_CMD -> router -> FCU
    (14996)    (14999)

    MissionControl drives: arm -> offboard -> takeoff -> controller_init ->
    ctrl_pos (MPC engaged, PX4 loop hands over) -> station keeping check.

While it runs, ``python tools/analyze.py --live 127.0.0.1:14996`` attaches
the live commanded-vs-achieved view to the router's tap endpoint (verified:
~300 states+cmds per 1 s window during engaged flight). On a small host the
viewer's render load costs tracking margin (~0.9 m vs ~0.05 m measured) —
attach it from another machine for flight-quality numbers.

NOTE: run on an otherwise-idle host. The engaged loop's stability margin
is real-time slack: under heavy CPU contention (e.g. the test suite
running concurrently) the sim process's rx/step threads starve, command
staleness blows past the watchdog bound, and the vehicle diverges — the
same failure a real companion computer would show under CPU overload.

Usage: python examples/full_sitl_stack.py [--seconds 8] [--ready-timeout 900]
"""
import argparse
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=8.0,
                    help="station-keeping window after MPC engagement")
    ap.add_argument("--ready-timeout", type=float, default=900.0)
    ap.add_argument("--svc-port", type=int, default=14997)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")  # this process: host CPU only

    from sde4mbrl_px4_tpu.cli.mission import MissionControl, SimVehicle
    from sde4mbrl_px4_tpu.io.engine_runtime import EngineServiceClient
    from sde4mbrl_px4_tpu.io.mavlink import load_native
    from sde4mbrl_px4_tpu.io.router import NativeRouter, Router, parse_conf
    from sde4mbrl_px4_tpu.models.params_io import load_params
    from sde4mbrl_px4_tpu.models.sde_model import NeuralSDE
    from sde4mbrl_px4_tpu.models.vehicles import iris_config
    from sde4mbrl_px4_tpu.sim.plant import FCUSim, SDEPlant
    from sde4mbrl_px4_tpu.sim.sitl import FCUSimNode

    here = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")

    # ---- L1: the MAVLink fan-out (reference sitl_route_mavlink.sh) --------
    with open(os.path.join(here, "configs", "router_sitl.conf")) as f:
        endpoints = parse_conf(f.read())
    _lib = load_native()
    native = (_lib is not None and hasattr(_lib, "router_new")
              and os.environ.get("SDE4MBRL_PY_ROUTER") != "1")
    router = (NativeRouter if native else Router)(endpoints)
    router.start()
    print(f"== router ({'native C++' if native else 'python'}) up: "
          f"{', '.join(e.name for e in endpoints)} ==", flush=True)

    # ---- L4/L5: the engine node in its own process (launch tier) ----------
    launch_cfg = f"""
node: sde_control
addr_mavlink_state_msg: 127.0.0.1:14998
addr_services: 127.0.0.1:{args.svc_port}
config_dir: {os.path.join(here, 'configs')}
traj_ctrl: iris_traj_mpc.yaml
sp_ctrl: iris_posctrl_mpc.yaml
seed: 0
mpc_report_dt: 1.0
"""
    with tempfile.NamedTemporaryFile("w", suffix=".yaml", delete=False) as f:
        f.write(launch_cfg)
        launch_path = f.name
    env = dict(os.environ)
    proc = subprocess.Popen(
        [sys.executable, "-m", "sde4mbrl_px4_tpu.launch", launch_path],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=here,
    )
    ready = False

    def _reader():
        nonlocal ready
        for line in proc.stdout:
            if "[launch]" in line:
                print(" ", line.strip(), flush=True)
            if "READY" in line:
                ready = True

    threading.Thread(target=_reader, daemon=True).start()
    print("== waiting for engine READY (compiling on first run) ==", flush=True)
    t0 = time.time()
    while not ready and time.time() - t0 < args.ready_timeout:
        if proc.poll() is not None:
            print("engine subprocess exited early"); return 1
        time.sleep(0.5)
    if not ready:
        proc.terminate(); print("engine never became ready"); return 1
    print(f"== engine ready in {time.time()-t0:.0f}s ==", flush=True)

    try:
        # ---- L0: the plant, streaming INTO the router's FCU endpoint ------
        params, _ = load_params(os.path.join(here, "configs/models/iris_sde.pkl"))
        # 50 Hz states: commands come back per state message, so the
        # stream rides exactly on the 20 ms staleness bound and the
        # watchdog FLAPS — which is fine: on each dropout the FCU falls
        # back to a position hold AT THE CURRENT POSITION (PX4 failsafe
        # semantics, SimVehicle.step), so brief alternation is benign.
        # Measured 60 s soak: 0.046 m mean here vs 0.178 m at 100 Hz
        # (doubling the ingress rate slows the engine's solves on this
        # host, costing more plan staleness than the watchdog margin buys).
        plant = SDEPlant(NeuralSDE(vehicle=iris_config()), params, sim_dt=0.005)
        fcu = FCUSim(plant, state_rate_hz=50.0)
        veh = SimVehicle(fcu)
        node = FCUSimNode(fcu, addr="127.0.0.1:14550", step_fn=veh.step)
        node.start()

        # ---- L6: the mission layer ----------------------------------------
        svc = EngineServiceClient(f"127.0.0.1:{args.svc_port}", timeout=5.0)
        logs = []
        ctl = MissionControl(veh, engine=svc, auto_spin=True,
                             log=lambda m: (logs.append(m), print("  [ctl]", m,
                                                                  flush=True)))
        ctl.arm(); ctl.wait_for_command()
        ctl.offboard(); ctl.wait_for_command()
        ctl.takeoff(z=1.0)
        ok_to = ctl.wait_for_action(timeout=30.0)
        print(f"takeoff complete={ok_to} pos={np.round(veh.position(), 2)}",
              flush=True)

        ctl.controller_init()
        time.sleep(0.3)
        # GRADUATED ENGAGEMENT, the reference's protocol (README.md:91,
        # SURVEY §4.2): CTRL_TEST first — the solver runs on real states
        # and commands are transmitted but IGNORED by the FCU — so the
        # pos solver's warm start converges on the actual problem before
        # authority transfers (no reset transient at handover).
        ctl.controller_test()
        time.sleep(1.0)
        # Motor passthrough (weight_motors=100), the same engagement level
        # the other closed-loop demos fly. At weight 0 the FCU executes
        # thrust+rates through the sim's P-only rate-loop STAND-IN, which
        # phase-lags 1-2 periods of plan staleness into an occasional
        # divergent oscillation (sim artifact — PX4's real cascaded rate
        # controller is the missing piece; see SimVehicle docstring).
        ctl.weight_motors(100)
        ctl.ctrl_pos_current()      # CTRL_POSE_ACTIVE at the current setpoint

        # MPC engagement + station keeping.
        t_engaged = None
        errs = []
        target = ctl._setpoint.copy()
        t_end = time.time() + args.seconds + 10.0
        while time.time() < t_end:
            time.sleep(0.1)
            if fcu.status == FCUSim.MPC_ON and t_engaged is None:
                t_engaged = time.time()
                print(f"== MPC engaged (authority handed over) ==", flush=True)
            if t_engaged is not None and time.time() - t_engaged > 1.0:
                errs.append((time.time() - t_engaged,
                             float(np.linalg.norm(veh.position() - target))))
            if t_engaged is not None and time.time() - t_engaged > args.seconds:
                break

        st = svc.status()
        ctl.controller_off(); ctl.stop()
        node.stop(); svc.close()
        errs = np.asarray(errs) if errs else np.asarray([[0.0, np.inf]])
        print(f"router frames: {router.stats}", flush=True)
        print(f"engine telemetry: steps={st.get('num_steps')} "
              f"solve={1e3*st.get('solve_time', 0):.1f}ms "
              f"state={st.get('ctrl_state')} idx={st.get('mpc_indx')}")
        print(f"station keeping over {len(errs)} ticks: "
              f"mean={errs[:, 1].mean():.3f}m max={errs[:, 1].max():.3f}m "
              f"engaged={t_engaged is not None}")
        ok = t_engaged is not None and errs[:, 1].mean() < 0.25
        if not ok:
            # Self-diagnosis: when did it diverge? (t-since-engage, err)
            for i in range(0, len(errs), max(1, len(errs) // 12)):
                print(f"  t+{errs[i, 0]:5.1f}s err={errs[i, 1]:9.3f} m",
                      flush=True)
        print("RESULT:", "PASS" if ok else "FAIL")
        return 0 if ok else 1
    finally:
        proc.terminate()
        router.stop()


if __name__ == "__main__":
    sys.exit(main())
