"""Node launcher (L7) — the roslaunch tier, ROS-free.

The reference wires nodes with per-node ``<param>`` blocks in launch files
(``launch/iris_sdectrl.launch:4-9`` -> ``sde_control.py:95-111``). Here a
launch YAML names the node type and its parameters; ``python -m
sde4mbrl_px4_tpu.launch configs/launch/iris_sdectrl.yaml`` brings it up:

- ``node: sde_control`` — the async MPC engine serving the MAVLink UDP
  side-channel (plus the mission REPL on stdin when ``--repl``);
- ``node: geometric_controller`` — the native baseline controller bound to
  the same transport;
- ``node: router`` — the MAVLink fan-out (``sitl_route_mavlink.sh``);
- ``node: fcu_sim`` — the SITL plant (the ``px4_sitl.launch`` /
  ``hexa_px4.launch`` Gazebo analogue, ``sim/sitl.py``).
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Any, Dict

from sde4mbrl_px4_tpu.io.config import load_yaml

__all__ = ["launch_from_file", "main"]


def _load(path: str) -> Dict[str, Any]:
    cfg = load_yaml(path)
    cfg["_dir"] = os.path.dirname(os.path.abspath(path))
    return cfg


def launch_sde_control(cfg: Dict[str, Any], repl: bool = False):
    """Start the MPC engine node (reference sde_control main,
    ``sde_control.py:750-769``)."""
    from sde4mbrl_px4_tpu.io.engine_runtime import SDEControlNode

    base = cfg.get("config_dir", "configs")
    if not os.path.isabs(base):
        # Resolve relative config_dir against CWD first, then against the
        # launch file's grandparent (launch files live in <root>/configs/launch).
        cand = [os.path.abspath(base),
                os.path.join(os.path.dirname(os.path.dirname(cfg["_dir"])), base)]
        base = next((c for c in cand if os.path.isdir(c)), cand[0])
    traj = os.path.join(base, cfg["traj_ctrl"])
    sp = os.path.join(base, cfg["sp_ctrl"])
    print(f"[launch] compiling engine: traj={traj} sp={sp}", flush=True)
    node = SDEControlNode(traj, sp, seed=int(cfg.get("seed", 0)))
    node.start()
    addr = cfg.get("addr_mavlink_state_msg", "127.0.0.1:14998")
    node.serve_mavlink(addr)
    svc_addr = cfg.get("addr_services", "127.0.0.1:14997")
    node.serve_services(svc_addr)
    print(f"[launch] engine serving MPC_FULL_STATE on udp:{addr}, "
          f"services on udp:{svc_addr}", flush=True)
    print("[launch] READY", flush=True)

    report_dt = float(cfg.get("mpc_report_dt", 0.2))
    log_file = cfg.get("log_file")
    logf = open(log_file, "a") if log_file else None

    if repl:
        from sde4mbrl_px4_tpu.cli.mission import repl as run_repl, MissionControl

        # REPL without a vehicle adapter: engine-only verbs.
        class _NullVehicle:
            armed = False
            flight_mode = "OFFBOARD"
            def arm(self, v): pass
            def set_flight_mode(self, m): pass
            def push_setpoint(self, p, y): pass
            def position(self):
                import numpy as np
                return np.zeros(3)
            def yaw(self): return 0.0
            def mpc_status(self): return 0

        ctl = MissionControl(_NullVehicle(), engine=node, auto_spin=True)
        run_repl(ctl)
        node.stop()
        return node

    try:
        while True:
            time.sleep(report_dt)
            rec = node.last_record
            line = rec.to_json()
            print(f"[telemetry] {line}", flush=True)
            if logf:
                logf.write(line + "\n")
                logf.flush()
    except KeyboardInterrupt:
        pass
    finally:
        node.stop()
        if logf:
            logf.close()
    return node


def launch_geometric(cfg: Dict[str, Any]):
    """Start the native geometric controller on the MAVLink side-channel."""
    import numpy as np

    from sde4mbrl_px4_tpu.baselines.geometric import (
        GeoParams, NativeGeometricController,
    )
    from sde4mbrl_px4_tpu.core.frames import ned2enu
    from sde4mbrl_px4_tpu.io.mavlink import MavlinkUDP

    ctl = NativeGeometricController(GeoParams())
    # flat param file IS the launch cfg (reference loadParameters schema)
    tmp = dict(cfg)
    import tempfile

    with tempfile.NamedTemporaryFile("w", suffix=".yaml", delete=False) as f:
        for k, v in cfg.items():
            if not k.startswith("_") and k not in ("node", "trajectory_path"):
                f.write(f"{k}: {v}\n")
        pth = f.name
    ctl.load_params_file(pth)
    os.unlink(pth)
    traj = cfg.get("trajectory_path")
    if traj:
        if not os.path.isabs(traj):
            traj = os.path.join(os.path.dirname(cfg["_dir"]), traj)
        ctl.load_trajectory(traj)

    addr = cfg.get("addr_mavlink_state_msg", "127.0.0.1:14998")
    link = MavlinkUDP(addr, mode="udpin")
    print(f"[launch] geometric controller on udp:{addr}", flush=True)
    t0 = time.time()
    try:
        while True:
            msg = link.recv_match(type="MPC_FULL_STATE", timeout=0.1)
            if msg is None:
                continue
            x_enu = np.asarray(ned2enu(msg.state))
            sp = ctl.sample_trajectory(time.time() - t0)
            if sp is None:
                continue
            pos, vel, acc, yaw = sp
            cmd, _ = ctl.update(x_enu.astype(np.float64), pos, vel, acc, yaw)
            # thrust + FRD body rates out (FLU->FRD flips y,z)
            tr = np.array([cmd[3], cmd[0], -cmd[1], -cmd[2]], np.float32)
            link.send_motors_cmd(int(time.time() * 1e6), np.zeros(6, np.float32),
                                 tr, 3, 0)
    except KeyboardInterrupt:
        pass


def launch_router(cfg: Dict[str, Any]):
    """Start the MAVLink fan-out router (the reference's ``px4_sitl.launch``
    + ``sitl_route_mavlink.sh`` transport bring-up, SURVEY.md §2.8): a conf
    file in the mavlink-router dialect defines the endpoints/filters."""
    from sde4mbrl_px4_tpu.io.mavlink import load_native
    from sde4mbrl_px4_tpu.io.router import (
        NativeRouter, Router, SerialEndpoint, parse_conf, parse_general,
    )

    conf = cfg["conf"]
    if not os.path.isabs(conf):
        cand = [os.path.abspath(conf), os.path.join(cfg["_dir"], conf)]
        conf = next((c for c in cand if os.path.isfile(c)), cand[0])
    with open(conf) as f:
        text = f.read()
    endpoints = parse_conf(text)
    general = parse_general(text)          # [General] Log / LogMode
    # Prefer the C++ core (the actual mavlink-routerd replacement: poll(2)
    # loop, no GIL on the forwarding path); the Python twin is the fallback
    # when the native library isn't built. Both are parity-tested.
    lib = load_native()
    # A stale native build (predates router_set_log) still serves the
    # non-logging topology at full speed; only demote to the Python twin
    # when the conf actually ASKS for flight logging the .so lacks.
    need_log = general.log_dir is not None
    need_uart = any(isinstance(e, SerialEndpoint) for e in endpoints)
    native = (lib is not None and hasattr(lib, "router_new")
              and (not need_log or hasattr(lib, "router_set_log"))
              and (not need_uart or hasattr(lib, "router_add_uart"))
              and cfg.get("native", True))
    router = (NativeRouter if native else Router)(
        endpoints, log_dir=general.log_dir, log_mode=general.log_mode)
    router.start()
    print(f"[launch] router ({'native' if native else 'python'}) fanning "
          f"out {len(endpoints)} endpoints "
          f"({', '.join(e.name for e in endpoints)})"
          + (f"; flight log -> {general.log_dir} ({general.log_mode})"
             if general.log_dir else ""), flush=True)
    print("[launch] READY", flush=True)
    try:
        while True:
            time.sleep(1.0)
    except KeyboardInterrupt:
        router.stop()


def launch_fcu_sim(cfg: Dict[str, Any]):
    """Start the SITL plant node (the reference's ``px4_sitl.launch``
    bring-up: a simulated FCU streaming MPC_FULL_STATE and consuming
    MPC_MOTORS_CMD, SURVEY.md §4). The plant runs on the host CPU — the
    accelerator belongs to the engine process (sim/plant.py:56-60)."""
    import jax
    import numpy as np

    jax.config.update("jax_platforms", "cpu")
    from sde4mbrl_px4_tpu.sim.sitl import fcu_sim_from_config

    node = fcu_sim_from_config(cfg)
    node.start()
    print(f"[launch] fcu_sim ({cfg.get('vehicle', 'iris')}) streaming "
          f"MPC_FULL_STATE to udp:{node.addr} at "
          f"{1.0 / node.fcu.state_dt:.0f} Hz", flush=True)
    print("[launch] READY", flush=True)
    try:
        while True:
            time.sleep(1.0)
            print(f"[fcu_sim] t={node.fcu.plant.t:7.2f}s "
                  f"pos_ned={np.round(node.fcu.plant.x[:3], 3).tolist()} "
                  f"status={node.fcu.status}", flush=True)
    except KeyboardInterrupt:
        node.stop()
    return node


def launch_from_file(path: str, repl: bool = False):
    cfg = _load(path)
    node_type = cfg.get("node", "sde_control")
    if node_type == "sde_control":
        return launch_sde_control(cfg, repl=repl)
    if node_type == "geometric_controller":
        return launch_geometric(cfg)
    if node_type == "router":
        return launch_router(cfg)
    if node_type == "fcu_sim":
        return launch_fcu_sim(cfg)
    raise ValueError(f"unknown node type {node_type!r}")


def main(argv=None):
    from sde4mbrl_px4_tpu.compile_cache import ensure_compile_cache

    ensure_compile_cache()
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("launch_file")
    ap.add_argument("--repl", action="store_true", help="attach the mission REPL")
    ap.add_argument("--coordinator", default=None,
                    help="multi-host: coordinator address host:port "
                         "(or env SDE4MBRL_COORDINATOR)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    args = ap.parse_args(argv)
    # Multi-host bring-up must precede any JAX op (parallel/distributed.py).
    from sde4mbrl_px4_tpu.parallel.distributed import initialize_distributed

    initialize_distributed(args.coordinator, args.num_processes, args.process_id)
    launch_from_file(args.launch_file, repl=args.repl)


if __name__ == "__main__":
    main()
