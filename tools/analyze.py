#!/usr/bin/env python
"""Flight-log analysis plots (L7) — the PlotJuggler-layout analogue.

Renders from an ``.npz`` flight log (``io/flight_log.py``) the comparisons
the reference's committed PlotJuggler layouts show
(``launch/new_analyze_mpc_v3.xml``: ``mpc_motors_cmd/*`` vs
``vehicle_rates_setpoint``/``actuator_motors``; ``pj_setpoint_layout.xml``:
setpoint tracking):

  1. commanded motor values per rotor over time
  2. commanded vs achieved body rates
  3. position tracking vs reference + error norm
  4. solver health: solve time, iterations, optimal cost

Usage:
  python tools/analyze.py flight.npz [-o out.png]        # post-hoc
  python tools/analyze.py --live 127.0.0.1:14996 [-o f]  # live stream view

Live mode is the PlotJuggler-attached-to-the-router analogue
(``launch/new_analyze_mpc_v3.xml`` overlays, SURVEY.md §2.14): it binds a
UDP MAVLink endpoint on the router fan-out, ingests ``MPC_FULL_STATE``
(achieved state + m1..m4) and ``MPC_MOTORS_CMD`` (commanded motors +
thrust/rates), and re-renders the commanded-vs-achieved overlay once per
second (PNG; terminal one-liner with the rolling tracking/rate errors).
"""
import argparse
import os
import sys
import time
from collections import deque

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


class LiveMonitor:
    """Rolling commanded-vs-achieved buffers + overlay rendering.

    Decoupled from the UDP loop so tests can feed messages directly
    (``tests/test_aux.py``).
    """

    def __init__(self, window_s: float = 10.0, max_len: int = 4096):
        self.window_s = window_s
        self.ach = deque(maxlen=max_len)   # (t, state13, m1..m4)
        self.cmd = deque(maxlen=max_len)   # (t, motors6, thrust_rates4)

    def ingest_state(self, t_usec: float, state13, motors4=None):
        self.ach.append((t_usec / 1e6, np.asarray(state13, np.float32),
                         None if motors4 is None else np.asarray(motors4, np.float32)))
        self._trim()

    def ingest_cmd(self, t_usec: float, motors6, thrust_rates4):
        self.cmd.append((t_usec / 1e6, np.asarray(motors6, np.float32),
                         np.asarray(thrust_rates4, np.float32)))
        self._trim()

    def _trim(self):
        for buf in (self.ach, self.cmd):
            if buf:
                t_now = buf[-1][0]
                while buf and t_now - buf[0][0] > self.window_s:
                    buf.popleft()

    def summary(self) -> str:
        if not self.ach or not self.cmd:
            return "live: waiting for stream..."
        t, x, _ = self.ach[-1]
        _, _, wr = self.cmd[-1]
        rate_err = np.abs(x[10:13] - wr[1:4]).max()
        return (f"t={t:8.2f}s  pos=({x[0]:+.2f},{x[1]:+.2f},{x[2]:+.2f})  "
                f"|rate err|max={rate_err:5.3f} rad/s  "
                f"({len(self.ach)} states / {len(self.cmd)} cmds in window)")

    def render(self, out_png: str) -> bool:
        """Overlay plot: commanded vs achieved motors and body rates."""
        if not self.ach or not self.cmd:
            return False
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        ta = np.array([r[0] for r in self.ach])
        xs = np.stack([r[1] for r in self.ach])
        tc = np.array([r[0] for r in self.cmd])
        mo = np.stack([r[1] for r in self.cmd])
        wr = np.stack([r[2] for r in self.cmd])
        # Motor readings are optional per-row (a stream may start without
        # them or interleave sources): plot only the rows that carry them.
        m_rows = [(r[0], r[2]) for r in self.ach if r[2] is not None]
        tm = np.array([r[0] for r in m_rows]) if m_rows else None
        mach = np.stack([r[1] for r in m_rows]) if m_rows else None

        fig, axes = plt.subplots(2, 1, figsize=(11, 7), sharex=True)
        ax = axes[0]
        for i in range(mo.shape[1]):
            if np.any(mo[:, i] != 0):
                ax.plot(tc, mo[:, i], lw=0.9, label=f"m{i+1} cmd")
        if mach is not None:
            for i in range(mach.shape[1]):
                ax.plot(tm, mach[:, i], lw=0.8, ls="--", label=f"m{i+1} achieved")
        ax.set_ylabel("motor [0..1]")
        ax.legend(ncol=6, fontsize=7)
        ax.set_title("mpc_motors_cmd vs actuator readings (live)")

        ax = axes[1]
        for i, nm in enumerate(("wx", "wy", "wz")):
            ax.plot(tc, wr[:, 1 + i], lw=0.9, label=f"{nm} cmd")
            ax.plot(ta, xs[:, 10 + i], lw=0.8, ls="--", label=f"{nm} achieved")
        ax.set_ylabel("body rate [rad/s]")
        ax.set_xlabel("t [s]")
        ax.legend(ncol=3, fontsize=7)
        ax.set_title("commanded vs achieved body rates (live)")

        fig.tight_layout()
        fig.savefig(out_png, dpi=100)
        plt.close(fig)
        return True

    def render_scene(self, out_png: str, ref_xyz=None) -> bool:
        """LIVE 3-D scene: rolling flown path + current attitude axes
        (+ optional reference trajectory) re-rendered per refresh — the
        live half of the rviz analogue (the reference's rviz scene shows
        vehicle pose + path live, ``launch/rviz_config.rviz``)."""
        if not self.ach:
            return False
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        xs = np.stack([r[1] for r in self.ach])
        fig = plt.figure(figsize=(7, 6))
        ax = fig.add_subplot(111, projection="3d")
        ax.plot(xs[:, 1], xs[:, 0], -xs[:, 2], lw=1.2, label="flown")
        if ref_xyz is not None and len(ref_xyz):
            r = np.asarray(ref_xyz)
            ax.plot(r[:, 1], r[:, 0], -r[:, 2], lw=1.0, ls="--",
                    label="reference")
        R = _q_to_rotmat(xs[-1, 6:10])
        origin = np.array([xs[-1, 1], xs[-1, 0], -xs[-1, 2]])
        scale = max(0.2, 0.05 * float(np.ptp(xs[:, :3])))
        for k, (axis_color, nm) in enumerate(zip("rgb", ("xb", "yb", "zb"))):
            v = R[:, k]
            vv = np.array([v[1], v[0], -v[2]]) * scale
            ax.plot([origin[0], origin[0] + vv[0]],
                    [origin[1], origin[1] + vv[1]],
                    [origin[2], origin[2] + vv[2]], color=axis_color, lw=2,
                    label=nm)
        ax.set_xlabel("E [m]"); ax.set_ylabel("N [m]"); ax.set_zlabel("U [m]")
        ax.legend(fontsize=7)
        ax.set_title(f"live flight scene (t={self.ach[-1][0]:.1f}s)")
        fig.tight_layout()
        fig.savefig(out_png, dpi=100)
        plt.close(fig)
        return True


def live_main(addr: str, out_png: str, refresh_s: float = 1.0,
              duration_s: float = 0.0, scene: bool = False,
              traj_csv: str = None):
    from sde4mbrl_px4_tpu.io.mavlink import MavlinkUDP

    link = MavlinkUDP(addr, mode="udpin")
    mon = LiveMonitor()
    ref_xyz = None
    if traj_csv:
        # NED reference polyline for the scene overlay (numpy CSV parse —
        # no jax in the plotting process).
        import csv

        with open(traj_csv) as f:
            rows = list(csv.DictReader(f))
        enu = np.array([[float(r["x"]), float(r["y"]), float(r["z"])]
                        for r in rows])
        ref_xyz = np.stack([enu[:, 1], enu[:, 0], -enu[:, 2]], axis=-1)
    scene_png = (os.path.splitext(out_png)[0] + "_scene.png") if scene else None
    t_start = time.time()
    t_render = 0.0
    print(f"live view on {addr}; rendering to {out_png}"
          f"{' + ' + scene_png if scene_png else ''} every {refresh_s}s",
          flush=True)
    while not duration_s or time.time() - t_start < duration_s:
        msg = link.recv_match(timeout=0.1)
        if msg is not None:
            if msg.get_type() == "MPC_FULL_STATE":
                mon.ingest_state(msg.time_usec, msg.state, msg.motors)
            elif msg.get_type() == "MPC_MOTORS_CMD":
                mon.ingest_cmd(msg.time_usec, msg.motor_val_des,
                               msg.thrust_and_angrate_des)
        if time.time() - t_render >= refresh_s:
            t_render = time.time()
            if mon.render(out_png):
                if scene_png:
                    mon.render_scene(scene_png, ref_xyz)
                print(mon.summary(), flush=True)


# numpy quaternion->rotation (keeps this tool jax-free: importing jax
# here would initialize the accelerator backend in a plotting subprocess)
def _q_to_rotmat(q):
    w, x, y, z = np.asarray(q, np.float64) / max(np.linalg.norm(q), 1e-9)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def render_scene(d: dict, out_png: str) -> None:
    """3-D flight scene: flown path vs reference trajectory with the start
    marker and current-attitude body axes — the ``rviz_config.rviz``
    analogue (the reference's rviz scene shows the vehicle pose and path;
    ``/root/reference/launch/rviz_config.rviz``, SURVEY.md §2.14)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    xs = d["state"]
    fig = plt.figure(figsize=(8, 7))
    ax = fig.add_subplot(111, projection="3d")
    # NED state -> plot in ENU-ish display axes (x east, y north, z up).
    ax.plot(xs[:, 1], xs[:, 0], -xs[:, 2], lw=1.2, label="flown")
    have_ref = ~np.isnan(d["ref"][:, 0])
    if have_ref.any():
        r = d["ref"][have_ref]
        ax.plot(r[:, 1], r[:, 0], -r[:, 2], lw=1.0, ls="--", label="reference")
    ax.scatter([xs[0, 1]], [xs[0, 0]], [-xs[0, 2]], marker="o", s=40,
               label="start")
    # Final-pose body axes (visual attitude cue like the rviz vehicle model).
    R = _q_to_rotmat(xs[-1, 6:10])
    origin = np.array([xs[-1, 1], xs[-1, 0], -xs[-1, 2]])
    scale = max(1e-6, 0.05 * float(np.ptp(xs[:, :3])))
    for k, (axis_color, nm) in enumerate(zip("rgb", ("xb", "yb", "zb"))):
        v = R[:, k]  # body axis in NED
        vv = np.array([v[1], v[0], -v[2]]) * scale
        ax.plot([origin[0], origin[0] + vv[0]],
                [origin[1], origin[1] + vv[1]],
                [origin[2], origin[2] + vv[2]], color=axis_color, lw=2,
                label=nm)
    ax.set_xlabel("E [m]"); ax.set_ylabel("N [m]"); ax.set_zlabel("U [m]")
    ax.legend(fontsize=8)
    ax.set_title("flight scene: flown vs reference path")
    fig.tight_layout()
    fig.savefig(out_png, dpi=110)
    plt.close(fig)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("log", nargs="?", default=None,
                    help="flight log: .npz (framework), .ulg (PX4), or .tlog (router Log=) — post-hoc mode")
    ap.add_argument("--live", default=None, metavar="HOST:PORT",
                    help="bind a UDP MAVLink endpoint and stream the "
                         "commanded-vs-achieved overlay live")
    ap.add_argument("--scene", action="store_true",
                    help="also render the 3-D path+pose view — post-hoc "
                         "(<log>_scene.png) or live (<out>_scene.png, "
                         "refreshed per tick); the rviz-scene analogue")
    ap.add_argument("--traj", default=None, metavar="CSV",
                    help="live --scene: reference trajectory CSV to "
                         "overlay (t,x,y,z,... ENU columns)")
    ap.add_argument("--refresh", type=float, default=1.0)
    ap.add_argument("--duration", type=float, default=0.0,
                    help="live mode: stop after N seconds (0 = forever)")
    ap.add_argument("-o", "--out", default=None)
    args = ap.parse_args()

    if args.live:
        live_main(args.live, args.out or "live_view.png",
                  refresh_s=args.refresh, duration_s=args.duration,
                  scene=args.scene, traj_csv=args.traj)
        return
    if not args.log:
        ap.error("need a flight log path (or --live HOST:PORT)")
    out = args.out or os.path.splitext(args.log)[0] + ".png"
    analyze(args.log, out, scene=args.scene)


def analyze(log_path: str, out: str, scene: bool = False):
    """Render the post-hoc overlays from a flight log — the framework's
    ``.npz`` schema OR a PX4 ``.ulg`` (real flights; mapped through
    io/ulog.py onto the same schema)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if log_path.endswith(".ulg"):
        from sde4mbrl_px4_tpu.io.ulog import ulog_to_flight_log

        d = ulog_to_flight_log(log_path)
    elif log_path.endswith(".tlog"):
        # router flight logs ([General] Log/LogMode, io/router.py)
        from sde4mbrl_px4_tpu.io.flight_log import tlog_to_flight_log

        d = tlog_to_flight_log(log_path)
    else:
        from sde4mbrl_px4_tpu.io.flight_log import load_flight_log

        d = load_flight_log(log_path)
    t = d["t"]

    fig, axes = plt.subplots(4, 1, figsize=(11, 13), sharex=True)

    ax = axes[0]
    for i in range(d["cmd_motors"].shape[1]):
        col = d["cmd_motors"][:, i]
        if np.any(col != 0):
            ax.plot(t, col, label=f"m{i+1}", lw=0.9)
    ax.set_ylabel("motor cmd [0..1]")
    ax.legend(ncol=6, fontsize=8)
    ax.set_title("commanded motors (mpc_motors_cmd)")

    ax = axes[1]
    names = ("wx", "wy", "wz")
    for i, nm in enumerate(names):
        ax.plot(t, d["cmd_thrust_rates"][:, 1 + i], lw=0.9,
                label=f"{nm} cmd")
        ax.plot(t, d["state"][:, 10 + i], lw=0.9, ls="--",
                label=f"{nm} achieved")
    ax.set_ylabel("body rate [rad/s]")
    ax.legend(ncol=3, fontsize=8)
    ax.set_title("commanded vs achieved body rates")

    ax = axes[2]
    have_ref = ~np.isnan(d["ref"][:, 0])
    for i, nm in enumerate(("x", "y", "z")):
        ax.plot(t, d["state"][:, i], lw=0.9, label=f"{nm}")
        ax.plot(t[have_ref], d["ref"][have_ref, i], lw=0.9, ls="--",
                label=f"{nm} ref")
    err = np.linalg.norm(d["state"][:, :3] - d["ref"][:, :3], axis=1)
    ax2 = ax.twinx()
    ax2.plot(t[have_ref], err[have_ref], color="k", lw=0.8, alpha=0.5)
    ax2.set_ylabel("|pos err| [m]")
    ax.set_ylabel("position [m]")
    ax.legend(ncol=6, fontsize=8)
    ax.set_title("position tracking")

    ax = axes[3]
    ax.plot(t, 1e3 * d["solve_time"], lw=0.9, label="solve time [ms]")
    ax.plot(t, d["num_steps"], lw=0.9, label="APG iterations")
    ax.set_ylabel("solver")
    ax.set_xlabel("t [s]")
    ax.legend(fontsize=8)
    ax.set_title("solver health (OptMPCState)")

    fig.tight_layout()
    fig.savefig(out, dpi=110)
    print(f"wrote {out}")

    if scene:
        scene_out = os.path.splitext(out)[0] + "_scene.png"
        render_scene(d, scene_out)
        print(f"wrote {scene_out}")


if __name__ == "__main__":
    main()
