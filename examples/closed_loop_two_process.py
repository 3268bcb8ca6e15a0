#!/usr/bin/env python
"""Two-process closed loop: the engine node in ITS OWN process (launch tier)
driving the GPU, the FCU simulator in this process on the host CPU —
the reference's actual deployment topology (controller node <-> FCU as
separate OS processes over MAVLink; SURVEY.md §1 L0-L4).

The engine process owns the accelerator; this process is forced onto the
host CPU and never opens the card (a JAX process reserves most of a
card's memory at start, so two processes on one card do not fit), and
plant stepping is never serialized behind solve round-trips.

    this process                         subprocess (launch.py)
    FCUSim (CPU plant)  --MPC_FULL_STATE-->  SDEControlNode (GPU solves)
         ^------------- MPC_MOTORS_CMD ------------/
         service client --JSON/UDP--> services (init/set_mode/status)

Default mission: position hold (1 m offset recovery + station keeping) —
deterministic across runs. ``--mission traj`` flies the lemniscate instead;
note the reference's idle semantics target the trajectory's START STATE
INCLUDING its velocity (``sde_control.py:206``), so the vehicle orbits the
entry point during idle and the engagement transient varies run to run.

Usage: python examples/closed_loop_two_process.py [--seconds 8] [--mission pos|traj]
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
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--mav-port", type=int, default=24998)
    ap.add_argument("--svc-port", type=int, default=24997)
    ap.add_argument("--state-rate", type=float, default=50.0)
    ap.add_argument("--ready-timeout", type=float, default=900.0)
    ap.add_argument("--mission", choices=("pos", "traj"), default="pos")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")  # this process: host CPU only

    from sde4mbrl_px4_tpu.core.frames import enu2ned
    from sde4mbrl_px4_tpu.core.types import (
        CTRL_POSE_ACTIVE, CTRL_TRAJ_ACTIVE, CTRL_TRAJ_IDLE, hover_state,
    )
    from sde4mbrl_px4_tpu.io.engine_runtime import EngineServiceClient
    from sde4mbrl_px4_tpu.io.mavlink import MavlinkUDP
    from sde4mbrl_px4_tpu.models.params_io import load_params
    from sde4mbrl_px4_tpu.models.sde_model import NeuralSDE
    from sde4mbrl_px4_tpu.models.trajectory import (
        load_trajectory_csv, make_state_from_traj,
    )
    from sde4mbrl_px4_tpu.models.vehicles import iris_config
    from sde4mbrl_px4_tpu.sim.plant import FCUSim, SDEPlant

    here = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")

    # ---- engine subprocess via the launch tier ---------------------------
    launch_cfg = f"""
node: sde_control
addr_mavlink_state_msg: 127.0.0.1:{args.mav_port}
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
    print("== waiting for engine READY (compiling on first run) ==", flush=True)
    ready = False
    t0 = time.time()

    def _reader():
        nonlocal ready
        for line in proc.stdout:
            if "[launch]" in line:
                print(" ", line.strip(), flush=True)
            if "READY" in line:
                ready = True

    rd = threading.Thread(target=_reader, daemon=True)
    rd.start()
    while not ready and time.time() - t0 < args.ready_timeout:
        if proc.poll() is not None:
            print("engine subprocess exited early"); return 1
        time.sleep(0.5)
    if not ready:
        proc.terminate(); print("engine never became ready"); return 1
    print(f"== engine ready in {time.time()-t0:.0f}s ==", flush=True)

    try:
        # ---- FCU sim side (CPU) ------------------------------------------
        params, _ = load_params(os.path.join(here, "configs/models/iris_sde.pkl"))
        model = NeuralSDE(vehicle=iris_config())
        plant = SDEPlant(model, params, sim_dt=0.005)
        table = load_trajectory_csv(
            os.path.join(here, "configs/trajs/lemniscate.csv"), convert_to_ned=False)
        sft = make_state_from_traj(table)
        if args.mission == "traj":
            plant.reset(np.asarray(enu2ned(sft(0.0))))
        else:
            x_start = np.array(hover_state()).copy()
            x_start[0] = 1.0          # 1 m offset to recover (NED)
            x_start[2] = -1.0
            plant.reset(x_start)
        fcu = FCUSim(plant, state_rate_hz=args.state_rate)

        link = MavlinkUDP(f"127.0.0.1:{args.mav_port}", mode="udpout")
        svc = EngineServiceClient(f"127.0.0.1:{args.svc_port}", timeout=5.0)
        stop = threading.Event()

        def rx_loop():
            while not stop.is_set():
                m = link.recv_match(type="MPC_MOTORS_CMD", timeout=0.05)
                if m is not None:
                    fcu.push_cmd(m.motor_val_des, m.thrust_and_angrate_des,
                                 m.mpc_on, m.weight_motors)

        rx = threading.Thread(target=rx_loop, daemon=True)
        rx.start()

        assert svc.initialize_mpc(), "controller_init failed"
        if args.mission == "traj":
            ok, msg = svc.set_mode(CTRL_TRAJ_IDLE); print("idle:", ok, msg)
        else:
            tgt = np.array(hover_state()).copy()
            tgt[2] = 1.0              # hold at ENU (0, 0, 1)
            ok, msg = svc.set_mode(CTRL_POSE_ACTIVE, target_pose=tgt)
            print("pose mode:", ok, msg)
        svc.set_mode(0, weight_motors=100)

        # The engine's trajectory clock is wall time: run the sim paced to
        # real time so both clocks agree (as a real FCU would).
        state_dt = 1.0 / args.state_rate
        errs = []
        started = None
        wall0 = time.time()
        for k in range(int(args.seconds / state_dt)):
            x, _ = fcu.full_state_msg()
            # stamp with WALL time so plan indexing matches the engine clock
            link.send_full_state(int(time.time() * 1e6), x)
            # real-time pacing
            target_wall = wall0 + (k + 1) * state_dt
            sleep = target_wall - time.time()
            if sleep > 0:
                time.sleep(sleep)
            fcu.run_control_period(state_dt)
            if args.mission == "traj" and k == int(1.0 / state_dt):
                ok, msg = svc.set_mode(CTRL_TRAJ_ACTIVE)
                print("activate:", ok, msg, flush=True)
                started = time.time()
            if args.mission == "traj" and started is not None:
                t_traj = time.time() - started
                if t_traj > 2.0:
                    ref = np.asarray(enu2ned(sft(t_traj)))
                    errs.append(float(np.linalg.norm(plant.x[:3] - ref[:3])))
            elif args.mission == "pos" and k * state_dt > 3.0:
                errs.append(float(np.linalg.norm(
                    plant.x[:3] - np.array([0.0, 0.0, -1.0]))))

        st = svc.status()
        wall_elapsed = time.time() - wall0
        print(f"pacing: sim={plant.t:.2f}s wall={wall_elapsed:.2f}s "
              f"slip={wall_elapsed - plant.t:+.2f}s", flush=True)
        stop.set(); rx.join(timeout=1.0)
        link.close(); svc.close()
        errs = np.asarray(errs) if errs else np.asarray([np.inf])
        print(f"engine telemetry: steps={st.get('num_steps')} "
              f"solve={1e3*st.get('solve_time', 0):.1f}ms state={st.get('ctrl_state')} "
              f"idx={st.get('mpc_indx')}")
        print(f"tracking error over {len(errs)} ticks: "
              f"mean={errs.mean():.3f}m max={errs.max():.3f}m fcu={fcu.status}")
        bar = 0.5 if args.mission == "traj" else 0.2
        ok = errs.mean() < bar and fcu.status == FCUSim.MPC_ON
        print("RESULT:", "PASS" if ok else "FAIL")
        return 0 if ok else 1
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=5)
        except subprocess.TimeoutExpired:
            proc.kill()
        os.unlink(launch_path)


if __name__ == "__main__":
    raise SystemExit(main())
